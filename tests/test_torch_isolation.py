"""The PyTorch port stands alone: it never imports JAX or the JAX package
(its CLI and bench_torch.py included) and it never falls back to the CPU
on its own. Its
settings are the JAX package's; the dense-grid bounds are held against
JAX's in tests/test_torch_dense_grid.py."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "sage_icp_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PACKAGE.rglob("*.py") if p.name != "__init__.py"
)


def test_port_modules_and_chip_smoke_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES + ['chip_smoke', 'bench_torch']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'sage_icp_tpu.'))"
        " or m == 'sage_icp_tpu')\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 25
    assert {"sage_icp_tpu_torch.ops.dynamic_filter", "sage_icp_tpu_torch.ops.sort_kernel",
            "sage_icp_tpu_torch.datasets.kitti", "sage_icp_tpu_torch.datasets.kitti360",
            "sage_icp_tpu_torch.datasets.kitti_raw", "sage_icp_tpu_torch.datasets.labels",
            "sage_icp_tpu_torch.metrics.kitti", "sage_icp_tpu_torch.runtime.cli",
            "sage_icp_tpu_torch.runtime.runner", "sage_icp_tpu_torch.runtime.checkpoint",
            "sage_icp_tpu_torch.runtime.keyframes", "sage_icp_tpu_torch.runtime.overlay",
            "sage_icp_tpu_torch.utils.labels", "sage_icp_tpu_torch.utils.visualization"} <= set(MODULES)


def test_cli_help_runs_without_jax():
    """`python -m sage_icp_tpu_torch.runtime.cli --help` with jax and the
    JAX package made unimportable."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sage_icp_tpu'] = None\n"
        "sys.argv = ['cli', '--help']\n"
        "runpy.run_module('sage_icp_tpu_torch.runtime.cli', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--deskew" in out.stdout and "--platform" not in out.stdout


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
                         + ["chip_smoke.py", "bench_torch.py"])
def test_source_has_no_jax_import(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+sage_icp_tpu(\.|\s)", src, re.M)


def test_bench_without_a_card_stops_with_an_error():
    """`python3 bench_torch.py` with no card and no BENCH_DEVICE=cpu exits
    non-zero and prints no result, with jax and the JAX package made
    unimportable."""
    code = (
        "import os, runpy, sys, torch\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sage_icp_tpu'] = None\n"
        "torch.cuda.is_available = lambda: False\n"
        "os.environ.pop('BENCH_DEVICE', None)\n"
        "runpy.run_path('bench_torch.py', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and out.stdout == ""


def test_sage_icp_without_device_needs_a_card(monkeypatch):
    from sage_icp_tpu_torch.models.pipeline import SageICP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SageICP("city")
    assert SageICP("city", device="cpu").device.type == "cpu"


def test_kitti_preset_runs_its_dynamic_filter():
    """SageICP() is the kitti preset, dynamic filter on; its prepare step
    removes a moving car and keeps a parked one, without overflow."""
    from sage_icp_tpu_torch.models import pipeline as tpl
    from tests.test_torch_cuda import parked_moving_scan

    odom = tpl.SageICP("kitti", device="cpu")
    assert odom.config == tpl.SageICP(device="cpu").config == tpl.PRESETS["kitti"]
    assert odom.config.dynamic_vehicle_filter
    buf, valid = parked_moving_scan(odom.config.scan_capacity)
    pts, ok = torch.from_numpy(buf), torch.from_numpy(valid)
    prep = tpl.prepare_icp_inputs(odom.state, pts, ok, torch.zeros(len(pts)), odom.config)
    assert int(prep["dyn_overflow"]) == 0
    frame = prep["frame_ds"][prep["frame_valid"]]
    car = frame[frame[:, 3] == 10.0]
    assert len(car) > 0 and bool((car[:, 0] < 20.0).all())
