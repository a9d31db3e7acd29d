"""Throughput of the PyTorch port (sage_icp_tpu_torch) on one CUDA card:
bench.py's two phases, knobs, guards and JSON line.

    python3 bench_torch.py                         # on the card
    BENCH_DEVICE=cpu BENCH_WARMUP=1 BENCH_CHUNK=1 BENCH_FRAMES=1 \\
        BENCH_POINTS=5000 BENCH_KITTI=0 python3 bench_torch.py

Prints a line per phase, the card's name and power limit, and as its last
line ONE JSON object with exactly bench.py's keys:
  {"metric": "scans_per_sec", "value": N, "unit": "scans/s",
   "vs_baseline": N / 200, "map_voxels": V, "ate_m": A,
   "kitti_scale_scans_per_sec": M, "kitti_scale_vs_baseline": M / 200,
   "kitti_scale_map_voxels": W, "kitti_scale_ate_m": B}
(the kitti_scale_* keys only with the kitti phase on).

Each phase is one continuous trajectory through the city world:
BENCH_WARMUP frames through register_frame, one warm chunk of BENCH_CHUNK
frames through register_chunk, then BENCH_FRAMES (rounded down to whole
chunks) timed in chunks, padded before the clock starts; the clock stops
when trajectory() has fetched every pose.
  * value: PRESETS[BENCH_PRESET] (default "city") on
    build_city_world(seed=0, size=420, density=BENCH_DENSITY=0.7);
  * kitti_scale_*: PRESETS["kitti"], the production preset with its
    dynamic-vehicle filter, at BENCH_KITTI_DENSITY=1.3 over
    BENCH_KITTI_FRAMES; BENCH_KITTI=0 skips it.
Scans: render_scan(n_target=BENCH_POINTS=120000, max_range=min(100,
config.max_range)) along make_trajectory(step=1.0), default_rng(0), as
bench.py renders them. BENCH_QUPLOAD=1 (default) uploads int16 scans;
BENCH_DENSE_GRID sets dense_grid on the first phase's preset.

BENCH_OVERLAP=1 (default, on the card): every padded chunk is staged in
pinned host memory before the clock starts, and chunk i+1's copy is issued
on a side stream before chunk i is registered (register_chunk returns only
after its per-frame and per-iteration syncs, so a copy issued after it
would overlap nothing); the compute stream waits on the copy's event.
BENCH_OVERLAP=0 hands register_chunk the pageable host buffer, which it
copies on the compute stream. The two give the same trajectory.

BENCH_DEVICE chooses the device: the card by default; without one the run
stops with an error and never falls back to the CPU; "cpu" runs there.

Guards (GuardError, raised, never asserted): the frame and source
downsample maxima over EVERY frame below 0.95 of their capacities and
every scan within scan_capacity; ATE < 1.0 m over every registered frame;
the silent-drop counters summed over every frame (aux_totals(); bench.py
reads only the last chunk's); the dynamic filter's landmark cells dropped
beyond its capacity, over every frame.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from sage_icp_tpu_torch.models import pipeline as pl
from sage_icp_tpu_torch.utils import synthetic

BASELINE_SCANS_PER_S = 200.0  # BASELINE.md's north star, as in bench.py
MAX_ATE_M = 1.0
CAPACITY_SHARE = 0.95


class GuardError(RuntimeError):
    """A guard of the bench failed: its throughput would mean nothing."""


@dataclasses.dataclass
class PhaseResult:
    scans_per_sec: float
    map_voxels: int  # live map voxels at the end
    ate_m: float  # over every registered frame
    totals: pl.StepAux  # aux_totals() over every frame
    landmark_cells_dropped: int
    trajectory: np.ndarray  # (N, 4, 4)
    iterations: np.ndarray  # (N,) ICP iterations per frame
    frames: int  # every registered frame: warm-up, warm chunk, timed
    staging_s: float  # padding (and, with the overlap, pinning) the timed chunks, before the clock


def settings() -> dict:
    """The BENCH_* knobs, bench.py's defaults, and BENCH_DEVICE."""
    get = os.environ.get
    return dict(
        warmup=int(get("BENCH_WARMUP", "10")), frames=int(get("BENCH_FRAMES", "60")),
        points=int(get("BENCH_POINTS", "120000")), chunk=int(get("BENCH_CHUNK", "30")),
        qupload=get("BENCH_QUPLOAD", "1") == "1", overlap=get("BENCH_OVERLAP", "1") == "1",
        preset=get("BENCH_PRESET", "city"), density=float(get("BENCH_DENSITY", "0.7")),
        dense_grid=None if "BENCH_DENSE_GRID" not in os.environ else get("BENCH_DENSE_GRID") == "1",
        kitti=get("BENCH_KITTI", "1") == "1", kitti_density=float(get("BENCH_KITTI_DENSITY", "1.3")),
        kitti_frames=int(get("BENCH_KITTI_FRAMES", get("BENCH_FRAMES", "60"))),
        device=get("BENCH_DEVICE"),
    )


def phase_length(n_warmup: int, n_frames: int, chunk: int) -> int:
    """Frames a phase registers: warm-up, the warm chunk, the timed frames
    rounded down to whole chunks."""
    return n_warmup + chunk + n_frames - n_frames % chunk


def render_scans(world, config, gt, n_points: int, rng, scans=()) -> list:
    """bench.py's scans along gt: `scans` (already rendered with `rng`
    from default_rng(0)) followed by the rest, rendered with `rng`."""
    pts, labs = world
    return list(scans) + [
        synthetic.render_scan(pts, labs, gt[i], rng, n_target=n_points, max_range=min(100.0, config.max_range))
        for i in range(len(scans), len(gt))
    ]


def card_line(device: torch.device) -> str:
    """The device's name and, on the card, the name and power limit that
    nvidia-smi gives for the first card."""
    if device.type != "cuda":
        return f"device {device}"
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        smi = subprocess.run(query, capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError) as e:
        smi = f"nvidia-smi failed: {e!r}"
    return f"{torch.cuda.get_device_name(device)} | nvidia-smi: {smi}"


def staged_uploads(pinned: list, device: torch.device):
    """Yields each pinned chunk on the device. Chunk i+1's non_blocking
    copy goes out on a side stream before chunk i is yielded, so it runs
    while chunk i is registered; the compute stream waits on each copy's
    event before it reads the chunk, and record_stream keeps the chunk's
    memory from being reused before the compute stream is done with it."""
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)

    def issue(host):
        with torch.cuda.stream(side):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    ahead = issue(pinned[0])
    for i in range(len(pinned)):
        dev, done = ahead
        compute.wait_event(done)
        dev.record_stream(compute)
        if i + 1 < len(pinned):
            ahead = issue(pinned[i + 1])
        yield dev


def check_guards(label: str, config, scans, totals: pl.StepAux, landmark_cells_dropped: int, est, gt) -> float:
    """Raises GuardError naming the phase and the counter when a capacity
    ran full, the run did not track, or work was dropped in any frame.
    Returns the ATE over every registered frame."""
    if int(totals.num_frame_ds) >= CAPACITY_SHARE * config.frame_capacity:
        raise GuardError(f"[{label}] num_frame_ds {int(totals.num_frame_ds)} reached {CAPACITY_SHARE} of "
                         f"frame_capacity {config.frame_capacity} in some frame: preset undersized")
    if int(totals.num_source) >= CAPACITY_SHARE * config.source_capacity:
        raise GuardError(f"[{label}] num_source {int(totals.num_source)} reached {CAPACITY_SHARE} of "
                         f"source_capacity {config.source_capacity} in some frame: preset undersized")
    longest = max(len(s) for s in scans)
    if longest > config.scan_capacity:
        raise GuardError(f"[{label}] a scan of {longest} points exceeds scan_capacity {config.scan_capacity}: "
                         "preset undersized")
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(est, gt)]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    if not ate < MAX_ATE_M:
        raise GuardError(f"[{label}] ATE {ate:.3f} m over {len(est)} frames (max frame error {max(errs):.3f} m): "
                         "the run did not track, and a throughput number for a lost run is meaningless")
    if int(totals.overflow_total()) != 0:
        counters = ", ".join(f"{f}={int(getattr(totals, f))}" for f in (
            "corr_dropped", "ds_truncated", "insert_unique_overflow", "insert_claim_failures",
            "insert_incoming_truncated", "dynfilter_overflow", "nonfinite_pose", "icp_rejected", "icp_forced"))
        raise GuardError(f"[{label}] silent-drop counters nonzero, summed over all {len(est)} frames: {counters}")
    if landmark_cells_dropped != 0:
        raise GuardError(f"[{label}] landmark_cells_dropped={landmark_cells_dropped}: the dynamic filter dropped "
                         "landmark cells beyond its capacity, summed over all frames")
    return ate


def run_phase(config, world, n_warmup: int, n_frames: int, n_points: int, chunk: int, label: str, device,
              overlap: bool = True, scans=None) -> PhaseResult:
    """One phase of the bench on `device` (see the module's docstring).
    scans: the phase's rendered scans (phase_length of them), or None to
    render them from `world`. overlap applies on a CUDA device only."""
    device = pl.resolve_device(device)
    n_total = phase_length(n_warmup, n_frames, chunk)
    n_frames -= n_frames % chunk
    gt = synthetic.make_trajectory(n_total, step=1.0)
    if scans is None:
        scans = render_scans(world, config, gt, n_points, np.random.default_rng(0))
    if len(scans) != n_total:
        raise ValueError(f"[{label}] {len(scans)} scans given for a phase of {n_total} frames")

    odom = pl.SageICP(config, device=device)
    for i in range(n_warmup):
        odom.register_frame(scans[i])
    odom.register_chunk(scans[n_warmup:n_warmup + chunk])
    odom.trajectory()

    t_stage = time.perf_counter()
    first = n_warmup + chunk
    padded = [odom.pad_chunk(scans[i:i + chunk]) for i in range(first, n_total, chunk)]
    staged = overlap and device.type == "cuda" and bool(padded)
    if staged:
        padded = [torch.from_numpy(p).pin_memory() for p in padded]
    t0 = time.perf_counter()
    for p in staged_uploads(padded, device) if staged else padded:
        odom.register_chunk(p)
    est = odom.trajectory()  # fetches every pose: the clock covers every frame end to end
    elapsed = time.perf_counter() - t0

    totals = odom.aux_totals()
    lmk = odom.landmark_cells_dropped()
    ate = check_guards(label, config, scans, totals, lmk, est, gt)
    return PhaseResult(
        scans_per_sec=n_frames / elapsed, map_voxels=int((odom.state.map.counts > 0).sum()), ate_m=ate,
        totals=totals, landmark_cells_dropped=lmk, trajectory=est, iterations=odom.iteration_counts(),
        frames=n_total, staging_s=t0 - t_stage)


def main(scans: dict | None = None) -> tuple[dict, dict]:
    """Both phases at the BENCH_* settings; prints each phase's line, the
    card's and the JSON line. scans: {"city": [...], "kitti": [...]},
    either phase's rendered scans, to skip its rendering. Returns (the
    JSON object, {phase: PhaseResult})."""
    s = settings()
    device = pl.resolve_device(s["device"])
    scans = scans or {}
    phases = {}

    def phase(name, config, density, n_frames, label):
        world = None
        if name not in scans:
            world = synthetic.build_city_world(seed=0, size=420.0, density=density)
        res = run_phase(config, world, s["warmup"], n_frames, s["points"], s["chunk"], label, device,
                        s["overlap"], scans.get(name))
        print(f"[{label}] {res.frames} frames, {n_frames - n_frames % s['chunk']} timed in chunks of {s['chunk']}: "
              f"{res.scans_per_sec} scans/s; ATE {res.ate_m} m; live voxels {res.map_voxels}; ICP iterations "
              f"{int(res.iterations.sum())}; upload {'int16' if config.quantized_scan_upload else 'float32'}, "
              f"overlap {'on' if s['overlap'] and device.type == 'cuda' else 'off'}; timed chunks staged in "
              f"{res.staging_s} s before the clock", flush=True)
        phases[name] = res

    config = dataclasses.replace(pl.PRESETS[s["preset"]], quantized_scan_upload=s["qupload"])
    if s["dense_grid"] is not None:
        config = dataclasses.replace(config, dense_grid=s["dense_grid"])
    phase("city", config, s["density"], s["frames"], "city")
    if s["kitti"]:
        kcfg = dataclasses.replace(pl.PRESETS["kitti"], quantized_scan_upload=s["qupload"])
        phase("kitti", kcfg, s["kitti_density"], s["kitti_frames"], "kitti-scale")

    city = phases["city"]
    out = {
        "metric": "scans_per_sec",
        "value": round(city.scans_per_sec, 2),
        "unit": "scans/s",
        "vs_baseline": round(city.scans_per_sec / BASELINE_SCANS_PER_S, 3),
        "map_voxels": city.map_voxels,
        "ate_m": round(city.ate_m, 4),
    }
    if "kitti" in phases:
        kitti = phases["kitti"]
        out["kitti_scale_scans_per_sec"] = round(kitti.scans_per_sec, 2)
        out["kitti_scale_vs_baseline"] = round(kitti.scans_per_sec / BASELINE_SCANS_PER_S, 3)
        out["kitti_scale_map_voxels"] = kitti.map_voxels
        out["kitti_scale_ate_m"] = round(kitti.ate_m, 4)
    print(card_line(device), flush=True)
    print(json.dumps(out), flush=True)
    return out, phases


if __name__ == "__main__":
    main()
