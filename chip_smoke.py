"""End-to-end check of sage_icp_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--kernels-only] [--profile]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from sage_icp_tpu_torch/csrc;
  3. every kernel against its plain PyTorch version on the card, at the
     city preset's shapes, on seeded inputs: the retention policy bit for
     bit, the semantic NN outputs equal, the GN sums within 1e-4 of the
     sum of their terms' magnitudes (only the summation order differs);
     kernel and plain times are CUDA-event medians of 20 calls;
  4. the main path: SageICP("city") over the Manhattan city world at
     density 0.7, 10 warm-up and 30 timed frames; no silent drop over all
     frames, ATE < 0.05 m, and launch counts showing that every ICP
     iteration ran the GN kernel and every insert the policy kernel;
  5. the single-pass search (get_correspondences_fast) on the final map,
     through the semantic NN kernel, against the reference-shaped search;
  6. with --profile only: a frame's host phases and the device's busy
     share and kernels (torch.profiler) on five further frames.
The line before the device line is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
CITY = dict(R=10_240 + 1_024, P=2, K=40, U=16_896, R_max=48, voxel=0.8)
GN_SUM_RTOL = 1e-4
WARMUP, FRAMES = 10, 30  # main path: warm-up and timed frames


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_inputs(rng, dev):
    """Seeded correspondence rows at city shapes: invalid lanes, label-0
    candidates and queries, a dead tail of whole tiles."""
    from sage_icp_tpu_torch.ops import correspondence_fast as cf
    from sage_icp_tpu_torch.ops import geometry as geo

    R, P, K, v = CITY["R"], CITY["P"], CITY["K"], CITY["voxel"]
    M = 27 * K
    planes = [torch.from_numpy(rng.integers(-32767, 32768, (R, M), dtype=np.int16)).to(dev) for _ in range(3)]
    labels = rng.choice(np.array([-1, 0, 40, 50, 10, 80], np.int16), (R, M), p=[0.35, 0.15, 0.2, 0.1, 0.1, 0.1])
    cl = torch.from_numpy(labels).to(dev)
    offs = cf.lane_offsets(K, v, dev)
    row_abs = rng.integers(-120, 120, (R, 3)).astype(np.int32)
    origin = row_abs.astype(np.float32) * np.float32(v)
    local = rng.uniform(-0.3 * v, 1.3 * v, (R, P, 3)).astype(np.float32)
    qlab = rng.choice(np.array([0, 40, 50, 10], np.float32), (R, P, 1))
    q_local = np.concatenate([local, qlab], axis=-1).reshape(R, 4 * P)
    q_world = np.concatenate([local + origin[:, None, :], qlab], axis=-1).reshape(R, 4 * P)
    used = (rng.random((R, P)) < 0.8).astype(np.int32)
    used[9_000:] = 0  # rows past the demand: whole dead tiles
    T = geo.se3_exp(torch.tensor([0.02, -0.01, 0.005, 0.001, -0.002, 0.003]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(planes=planes + [cl], offs=offs, q_local=t(q_local), q0=t(q_world), origin=t(origin),
                row_abs=t(row_abs), used=t(used), T=T.to(dev))


def policy_inputs(rng, dev):
    from sage_icp_tpu_torch.ops.policy_kernel import CLS_SHIFT

    U, K, Rm = CITY["U"], CITY["K"], CITY["R_max"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    blocks = [rng.integers(-32767, 32768, (U, K), dtype=np.int16) for _ in range(3)]
    blocks.append(rng.choice(np.array([0, 40, 50, 10, 80], np.int16), (U, K)))
    counts = rng.integers(0, K + 1, (U, 1)).astype(np.int32)
    seglen = rng.integers(0, Rm + 1, (U, 1)).astype(np.int32)
    seglen[rng.random(U) < 0.2] = 0  # rows without a slot
    inc = [rng.integers(-32767, 32768, (U, Rm), dtype=np.int16) for _ in range(3)]
    lab = rng.choice(np.array([0, 40, 44, 50, 10, 80, 81]), (U, Rm))
    cls = np.where(lab == 0, 0, np.where(np.isin(lab, (40, 44, 48, 49, 50, 70, 72)), 1, 2))
    enc = (lab | (cls << CLS_SHIFT)).astype(np.int16)
    return [t(b) for b in blocks] + [t(counts), t(seglen)] + [t(i) for i in inc] + [t(enc)], int(seglen.sum())


def check_kernels(dev):
    """Phase 3. Returns {name: row of the kernel table without launches}."""
    from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel

    rng = np.random.default_rng(0)
    R, P, K, v = CITY["R"], CITY["P"], CITY["K"], CITY["voxel"]
    M = 27 * K
    sem_th, scale, max_corr, kth = 0.4, v / 32767.0, 1.5, 0.5
    rows = {}

    d = row_inputs(rng, dev)
    cx, cy, cz, cl = d["planes"]
    offx, offy, offz = d["offs"]
    nn_args = (cx, cy, cz, cl, offx, offy, offz, d["q_local"], sem_th, scale)
    got = nn_kernels.fused_semantic_nn(*nn_args)
    want = nn_kernels.fused_semantic_nn_plain(*nn_args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if err != 0.0:
        fail(f"fused_semantic_nn disagrees with its plain version: max |diff| {err}")
    nn_bytes = 4 * R * M * 2 + 3 * M * 4 + R * 4 * P * 4 + 5 * R * P * 4
    b_ms, b_by = bound(nn_bytes, R * M * (6 + 10 * P))
    rows["fused_semantic_nn"] = dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/semantic_nn.cu",
        replaces="sage_icp_tpu/ops/pallas_nn.py:99", max_abs_err=err,
        ms=time_ms(lambda: nn_kernels.fused_semantic_nn(*nn_args)),
        plain_ms=time_ms(lambda: nn_kernels.fused_semantic_nn_plain(*nn_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    tile_map = nn_kernels.default_tile_map(d["used"])
    gn_args = (cx, cy, cz, cl, offx, offy, offz, d["q0"], d["origin"], d["row_abs"], d["used"], d["T"],
               sem_th, scale, v, max_corr, kth)
    got = nn_kernels.fused_gn_iteration(*gn_args, tile_map=tile_map)
    terms = nn_kernels.gn_terms(*gn_args, tile_map)
    want = terms.sum(dim=1)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = GN_SUM_RTOL * terms.abs().sum(dim=1)
    if not bool(torch.all(diff <= tol)):
        fail(f"fused_gn_iteration disagrees with its plain version: {diff.tolist()} vs {tol.tolist()}")
    if float(want[16]) <= 0 or float(got[17]) != float(want[17]):
        fail("fused_gn_iteration: degenerate comparison (no accepted slot) or used-count mismatch")
    live_rows = int((tile_map == torch.arange(len(tile_map), device=dev)).sum()) * nn_kernels.TILE_ROWS
    live_rows = min(live_rows, R)
    gn_bytes = live_rows * (4 * M * 2 + 4 * P * 4 + 3 * 4 + 3 * 4 + P * 4) + 3 * M * 4 + len(tile_map) * 4 + 18 * 4
    b_ms, b_by = bound(gn_bytes, live_rows * M * (6 + 10 * P))
    rows["fused_gn_iteration"] = dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/gn_iteration.cu",
        replaces="sage_icp_tpu/ops/pallas_nn.py:286", max_abs_err=float(diff.max()),
        ms=time_ms(lambda: nn_kernels.fused_gn_iteration(*gn_args, tile_map=tile_map)),
        plain_ms=time_ms(lambda: nn_kernels.gn_terms(*gn_args, tile_map).sum(dim=1)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    U, Rm = CITY["U"], CITY["R_max"]
    pargs, total_seg = policy_inputs(rng, dev)
    got = policy_kernel.apply_policy(*pargs, basic=20)
    want = policy_kernel.apply_policy_plain(*pargs, basic=20)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("apply_policy is not bit-exact against its plain version")
    pol_bytes = 2 * (4 * U * K * 2) + 2 * U * 4 + 4 * total_seg * 2 + U * 4
    b_ms, b_by = bound(pol_bytes, total_seg * 10)
    rows["apply_policy"] = dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/retention_policy.cu",
        replaces="sage_icp_tpu/ops/pallas_insert.py:223", max_abs_err=0.0,
        ms=time_ms(lambda: policy_kernel.apply_policy(*pargs, basic=20)),
        plain_ms=time_ms(lambda: policy_kernel.apply_policy_plain(*pargs, basic=20)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for name, r in rows.items():
        print(f"kernel {name}: max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return rows


def main_path(warmup: int, frames: int, extra: int):
    """Phase 4. Returns (odom, scans, launches); `extra` more scans along
    the trajectory follow the main path's."""
    from sage_icp_tpu_torch.models.pipeline import SageICP
    from sage_icp_tpu_torch.ops import cuda_lib
    from sage_icp_tpu_torch.utils import synthetic

    pts, labs = synthetic.build_city_world(seed=0, size=420.0, density=0.7)
    n = warmup + frames
    gt = synthetic.make_trajectory(n + extra, step=1.0)
    rng = np.random.default_rng(0)
    odom = SageICP("city")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: pose math must run in full float32")
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=120_000,
                                   max_range=min(100.0, odom.config.max_range)) for i in range(n + extra)]
    if max(len(s) for s in scans) > odom.config.scan_capacity:
        fail("scan capacity overflow")
    cuda_lib.reset_launches()
    for i in range(warmup):
        odom.register_frame(scans[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, n):
        odom.register_frame(scans[i])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)

    totals = odom.aux_totals()
    if int(totals.overflow_total()) != 0:
        fail(f"silent-drop counters over all frames: {totals}")
    est = odom.trajectory()
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(est, gt[:n])]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    if not np.isfinite(ate) or ate >= 0.05:
        fail(f"ATE {ate} m over {n} frames")
    iters = sum(odom.icp_iters)
    if launches["fused_gn_iteration"] != iters:
        fail(f"GN launches {launches['fused_gn_iteration']} != ICP iterations {iters}")
    if launches["apply_policy"] != n:
        fail(f"policy launches {launches['apply_policy']} != frames with an insert {n}")
    if launches["fused_semantic_nn"] != 0:
        fail("the semantic NN kernel ran on the odometry step")
    print(f"main path: {frames} timed frames in {elapsed:.4f} s = {frames / elapsed:.3f} scans/s, "
          f"{1e3 * elapsed / frames:.3f} ms/frame; ICP iterations {odom.icp_iters}; "
          f"ATE {ate:.5f} m; live voxels {int((odom.state.map.counts > 0).sum())}; "
          f"launches {launches}", flush=True)
    return odom, scans, launches


def single_pass(odom, scan):
    """Phase 5: the single-pass search on the final map through the NN
    kernel, against the reference-shaped search."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import correspondence_fast as cf
    from sage_icp_tpu_torch.ops import cuda_lib
    from sage_icp_tpu_torch.ops import hashmap as hm
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.ops.scan import trunc_div

    cfg = odom.config
    dev = odom.device
    buf = torch.full((cfg.scan_capacity, 4), 1.0e7, device=dev)
    buf[: len(scan)] = torch.from_numpy(scan).to(dev)
    prep = pl.prepare_icp_inputs(odom.state, buf, buf[:, 0] < 1.0e6, cfg)
    query = geo.transform_points(odom.state.last_pose, prep["source"])
    valid = prep["source_valid"]
    tables = cf.build_probe_tables(odom.state.map, trunc_div(odom.state.last_pose[:3, 3], cfg.voxel_size_map),
                                   cfg.probe_depth)
    cuda_lib.reset_launches()
    tgt, acc = cf.get_correspondences_fast(
        odom.state.map, tables, query, valid, cfg.voxel_size_map, 1.5, cfg.sem_th, cfg.probe_depth,
        cfg.corr_unique_voxel_rows, cfg.corr_queries_per_voxel, cfg.corr_overflow_rows)
    torch.cuda.synchronize()
    launches = cuda_lib.LAUNCHES["fused_semantic_nn"]
    tgt_ref, acc_ref = hm.get_correspondences(odom.state.map, query, valid, cfg.voxel_size_map, 1.5,
                                              cfg.sem_th, cfg.probe_depth)
    n_acc = int(acc_ref.sum())
    mismatch = int((acc != acc_ref).sum())
    both = acc & acc_ref
    far = int(((tgt - tgt_ref).abs().amax(dim=1) > 1e-4)[both].sum())
    print(f"single-pass search: {n_acc} accepted by the reference search, {mismatch} accept mismatches, "
          f"{far} differing targets, NN launches {launches}", flush=True)
    if launches != 1 or n_acc == 0 or (mismatch + far) > 1e-3 * n_acc:
        fail("single-pass search disagrees with the reference-shaped search")
    return launches


def profile(odom, scans) -> None:
    """Optional phase 6 (--profile): where the time of a city frame goes,
    on the frames that follow the main path's. First the host phases of
    the next frame, timed with a synchronise after each (the state held
    fixed, repeated); then the device's busy share and its kernels by
    total time from torch.profiler while the frames are registered."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.ops import hashmap as hm

    cfg, dev = odom.config, odom.device
    phases = {"upload+prepare": 0.0, "icp": 0.0, "insert+cull": 0.0}
    iters = 0
    state = odom.state
    n = len(scans)
    buf = np.full((cfg.scan_capacity, 4), 1.0e7, np.float32)
    buf[: len(scans[0])] = scans[0]
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = torch.from_numpy(buf).to(dev)
        prep = pl.prepare_icp_inputs(state, pts, pts[:, 0] < 1.0e6, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        icp = pl.run_icp(state.map, prep, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        world = geo.transform_points(icp.pose, prep["frame_ds"])
        new_map, _ = hm.insert(state.map, world, prep["frame_valid"], cfg.voxel_size_map,
                               cfg.basic_points_per_voxel, pl.basic_label_mask(cfg, dev),
                               cfg.max_incoming_per_voxel, cfg.probe_depth,
                               min(cfg.insert_unique_capacity, cfg.frame_capacity), prep["tables"])
        hm.remove_far(new_map, icp.pose[:3, 3], cfg.local_map_range)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2)):
            phases[k] += dt
        iters += icp.iterations
    print("profile host phases (ms/frame, state held fixed): "
          + ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in phases.items())
          + f"; ICP iterations/frame {iters / n:.2f}", flush=True)

    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for scan in scans:
            odom.register_frame(scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"profile: {n} frames, wall {1e3 * wall / n:.3f} ms/frame, device busy "
          f"{busy_us / 1e3 / n:.3f} ms/frame, idle share {1 - busy_us / 1e6 / wall:.4f}, "
          f"{launches / n:.1f} device ops/frame", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/frame {e.count / n:7.1f}x  {e.key[:90]}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 3")
    ap.add_argument("--profile", action="store_true", help="also break a frame's time down")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from sage_icp_tpu_torch.ops import cuda_lib

    build_s = cuda_lib.build_all()
    print(f"build: {build_s:.2f} s", flush=True)
    for src, log in cuda_lib.BUILD_LOG.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"nvcc {src}: " + " | ".join(used), flush=True)

    rows = check_kernels(dev)
    if args.kernels_only:
        print(smi)
        return 0
    n = WARMUP + FRAMES
    odom, scans, launches = main_path(WARMUP, FRAMES, 5 if args.profile else 0)
    nn_launches = single_pass(odom, scans[n - 1])
    launches["fused_semantic_nn"] = nn_launches
    if args.profile:
        profile(odom, scans[n:])
    table = [dict(name=name, launches=launches[name], **row) for name, row in rows.items()]
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
