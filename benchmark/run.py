"""Runs one cell of the benchmark of sage_icp_tpu_torch on the card this
process sees, and prints its result as the last line of standard output.

    python3 benchmark/run.py --workload kitti.stream --seed 7 --seconds 10 --trace 0

From the root of a checkout. In order:
 1. the cell's entry in BENCHMARK.json, its configuration file and its
    traffic file, by name (cells.py);
 2. the scenes: the configuration's city world (its seed is the
    configuration's) and trajectory, and the labelled scans of the
    configuration's number of drives along it, rendered on the card with
    the sensor's draws from --seed, swept with each point's time where
    the scene says "sweep" (scenes.py); one drive, drawn from --seed, is
    the one the reference checks;
 3. set-up: one SageICP of the configuration, and one whole drive of the
    cell's traffic through it, which builds the kernels (nvcc, into
    build/torch_kernels/ of the checkout, on the checkout's first run)
    and captures the step's CUDA graphs; setup_s runs from the start of
    this script to here. Then an idle wait until SETTLE_S after the
    start;
 4. the window: whole drives of the cell's traffic for --seconds, the
    checked drive first and then the others in turn (traffic.py); after
    the first drive the program's map is copied to the host. With
    --trace 1 the first drive runs under torch.profiler (devtrace.py)
    and the per-layer metrics are read from it, with --trace 0 the
    end-to-end metrics from the host clock;
 5. the peak of the card's memory, then the program freed;
 6. the plain reference (benchmark/reference/, no kernel and nothing of
    the program) over the checked drive's scans, and their point times
    when the configuration deskews, on the card, in full float32,
    following the program's poses of it one step at a time,
    and the comparison that decides `correct` (verdict.py): every run of
    the checked drive in the window, and the map after its first run,
    each number printed beside its limit as the last lines of standard
    error and in the result's "checks";
 7. the result: {"correct", "attempted", "failed", "metrics", "device"
    (, "breakdown"), "checks"}.

It stops with an error, and prints no result, without a CUDA card (or
with fewer cards than the cell asks for), and when jax, jaxlib, flax or
the JAX package sage_icp_tpu has been loaded by the end of the run. Build
and kernel caches go under build/ of the checkout; nothing else is
written.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "sage_icp_tpu")
# On the card's host, a process's host-side work runs ~8 % slower for its
# first 13-20 s, whatever it does meanwhile (an idle wait settles it as
# well as work does; NVIDIA H100 80GB HBM3, 700 W: PERF.md). The window
# starts no earlier than this many seconds after the process did; the wait
# is no set-up work and is not counted in setup_s.
SETTLE_S = 30.0


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a metric's reader (metrics/<name>.py) reads."""

    cell: object  # cells.Cell
    setup_s: float
    window: object  # traffic.Window
    traced: object | None  # the traced drive (traffic.Drive), --trace 1
    trace: object | None  # its devtrace.Trace
    reference: object  # reference.odometry.Reference over the drive
    peaks: dict | None  # arith.peaks of the card


def sage_config(fields: dict):
    from sage_icp_tpu_torch.models.pipeline import SageConfig

    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v  # noqa: E731
    return SageConfig(**{k: tup(v) for k, v in fields.items()})


def card_line(device) -> str:
    import torch

    if device.type != "cuda":
        return f"device {device}"
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        smi = subprocess.run(query, capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e!r}"
    return f"{torch.cuda.get_device_name(device)} | nvidia-smi: {smi.splitlines()[0] if smi else ''}"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float = T_START,
             settle_s: float = SETTLE_S) -> dict:
    """One run of `cell` on `device` (the card; the CPU only in
    rehearsals). On the card the window waits until settle_s after
    t_start. Returns the result line's object."""
    import numpy as np
    import torch

    from benchmark import arith, cells, devtrace, guards, scenes, traffic, verdict
    from benchmark.reference import odometry as reference
    from sage_icp_tpu_torch.models import pipeline as pl

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, scene = cell.sage, cell.config["scene"]
    config = sage_config(cfg)

    gt, drives, times = scenes.cell_scenes(cell.config, seed, scene["drives"], device)
    # the drive whose answers the reference checks: the window's first
    sample = int(np.random.default_rng(seed).integers(len(drives)))
    order = [(sample + i) % len(drives) for i in range(len(drives))]
    if cuda:
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    odom = pl.SageICP(config, device=device)
    driver = traffic.Driver(odom, drives, cell.traffic, devtrace.span if trace else None, times)
    driver.drive(sample)  # builds the kernels, captures the graphs
    sync()
    setup_s = time.perf_counter() - t_start
    settle = max(0.0, t_start + settle_s - time.perf_counter()) if cuda else 0.0
    time.sleep(settle)

    traced, kept = {}, {}

    def first(drive_fn):
        traced["drive"], traced["trace"] = devtrace.profile_drive(drive_fn, device)
        return traced["drive"]

    def keep_map():
        kept["map"] = [t.cpu() for t in odom.state.map[:3]]

    window = driver.window(seconds, order, first if trace else None, keep_map)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del driver, odom
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checked = [d for d in window.drives if d.index == sample]
    with reference.precision(tf32=False):
        ref = reference.Reference(cfg, device)
        stamps = times[sample] if times is not None else [None] * len(drives[sample])
        for scan, ts, pose in zip(drives[sample], stamps, checked[0].poses):
            ref.register(scan, ts, follow=pose)
        values = verdict.numbers(cell, checked, [t.to(device) for t in kept["map"]], ref)
    ref_s = time.perf_counter() - t_ref
    correct, checks = verdict.judge(values, cell.limits)
    longest = max(len(s) for drive in drives for s in drive)
    failed, reasons = guards.failed_frames(window.drives, cfg, gt, longest)

    run = Run(cell, setup_s, window, traced.get("drive"), traced.get("trace"), ref,
              arith.peaks(torch.cuda.get_device_name(device)) if cuda else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cells.reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window.frames, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        tr = run.trace
        dev["busy_s"], dev["window_s"] = tr.busy_ns() / 1e9, tr.window_s
        result["breakdown"] = devtrace.breakdown(tr)
    result["checks"] = checks

    log(card_line(device))
    log(f"[{cell.name}] seed {seed}: {len(window.drives)} drives, {window.frames} frames in {window.seconds} s; "
        f"{len(window.frame_ms())} frames handed over alone; {len(drives)} drives of "
        f"{min(len(s) for drive in drives for s in drive)}-{longest} points a scan, drive {sample} checked "
        f"({len(checked)} runs of it); setup {setup_s} s, then {settle} s of waiting; peak memory "
        f"{memory_peak} B; reference {ref_s} s")
    above, early = window.slow_starts()
    if above:
        log(f"[{cell.name}] {above} frames above the 95th percentile of latency, {early} of them among the "
            "first 10 frames of their drive")
    for r in reasons:
        log(f"[{cell.name}] failed: {r}")
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return result


def result_line(result: dict) -> str:
    """The last line of standard output: the result as one JSON object."""
    return json.dumps(result)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    sys.path[0] = str(ROOT)

    import torch

    from benchmark import cells

    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this process sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process, which the port must not load: {', '.join(bad)}: no result")
        return 3
    print(result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
