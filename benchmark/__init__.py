"""The benchmark of sage_icp_tpu_torch, the PyTorch and CUDA port: its
harness, the configurations, traffic mixes and per-layer metrics it finds
by name, and the plain reference that decides whether a run is correct.
BENCHMARK.json at the repository's root lists the cells; run.py runs one."""
