"""End-to-end check of sage_icp_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--kernels-only] [--profile]
    python3 chip_smoke.py --root DIR

With --root, only the kernel times of the port checked out at DIR (the
parent commit unpacked with `git archive`, say) are taken, at phase 3's
shapes on phase 3's inputs and, when build/drive_rows.pt exists (phase 7
writes it), on the kitti drive's own policy and radius-count rows, and
printed as one JSON line; nothing is checked. Run it on both trees in one
call to compare them.

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from sage_icp_tpu_torch/csrc;
  3. every kernel against its plain PyTorch version on the card, on
     seeded inputs: at the city preset's shapes the semantic NN outputs
     equal; at the city and the kitti preset's shapes the retention
     policy bit for bit and the GN sums within 1e-4 of the sum of their
     terms' magnitudes (only the summation order differs), deterministic
     and in one launch; at the kitti filter's shapes the radius count bit
     for bit; the bitonic sort bit for bit at N = 2^16 and 2^18 (two
     uint32 keys, an iota key, a float32 payload) against the stable sort
     and the network run stage by stage, and at 2^18 on tied keys (no iota
     key) against the network, with its launches per call; the GN and
     policy kernels on the two row halves of the kitti shapes that phase
     10's ranks take, against the call on all rows. Kernel, plain
     and library times are device times (time_ms: calls queued back to
     back behind a spacer kernel, CUDA events, the median of 5 batches of
     20);
  4. the city path: SageICP("city") over the Manhattan city world at
     density 0.7, 10 warm-up and 30 timed frames; no silent drop over all
     frames, ATE < 0.05 m, and launch counts showing that every ICP
     iteration ran the GN kernel and every insert the policy kernel;
  5. the single-pass search (get_correspondences_fast) on the final city
     map, through the semantic NN kernel, against the reference-shaped
     search;
  6. the kitti path: SageICP(), the production kitti preset with its
     dynamic-vehicle filter, over the city world at density 1.3, 10
     warm-up and 30 timed frames, with the same gates, and the radius
     count launched once per frame;
  7. on the kitti drive's last frame: vehicle points in, kept and
     removed; the filter on the card against the filter on the CPU; the
     bitonic sort of the filter's sort keys against torch.sort; the
     drive's own rows of the policy kernel (one map insert of the frame)
     and of the radius count (the filter of the frame), captured from
     their wrappers, each kernel against its plain version bit for bit,
     the rows' shape and the kernel's time, saved to build/drive_rows.pt;
  8. with --profile only: each path's host phases, device busy share and
     kernels (torch.profiler) on five further frames, the port's own
     kernels listed apart; the deskew path's too (after phase 9), and
     the deskew's share of its device busy time; and phase 10a's NCCL
     path's (its ICP and insert through the mesh);
  9. the runtime (run after phase 7): the CLI in process, `--synthetic
     --preset kitti --deskew --frames 40 --chunk 8`, chunked and with
     --timed-icp (per-frame), each with ATE < 0.05 m, 40 lines in
     path.txt, gt_path.txt and time.txt, no drop, GN launched once per
     ICP iteration of the step and of the timer's replays, the policy
     once a frame, the radius count once per prepare (a frame's step,
     and each timer replay), and a finite positive t_icp on every timed
     line; the two trajectories within 1e-5 m. Then the kitti
     drive's 40 scans skewed by their frames' motion (skew_scan over the
     azimuth phase), driven with deskew off and on: no drop, ATE on
     < 0.05 m and no larger than off; the deskewed drive chunked (W = 8)
     within 1e-5 of per-frame, both timed; one frame's deskew on the card
     against the CPU within 1e-5 m, and its time at 135,168 points; a
     checkpoint resume after 20 frames equal to the uninterrupted run
     (trajectory within 1e-5 m, the map slot for slot);
 10. multi-rank (parallel/): (a) NCCL at world size 1 in process,
     init_distributed through a file:// rendezvous under build/, then
     ShardedSageICP() (the kitti preset) on phase 6's 40 scans with phase
     6's calls: its trajectory equal to phase 6's bit for bit, no drop, GN
     launched once per ICP iteration, the policy and the radius count once
     a frame; (b) two parallel.worker processes sharing the card over gloo
     (NCCL refuses two ranks on one device), each at the full kitti preset
     on the same 40 scans: the two trajectories equal bit for bit and the
     final maps slot for slot, each within 5e-3 m of phase 6's trajectory
     (test_sharded_maneuver_equivalence's bound), ATE < 0.05 m, no drop,
     and per rank GN once per ICP iteration on 9,216 of the 18,432 rows,
     the policy once a frame on 16,512 of the 33,024 rows, the radius count
     once a frame (replicated). Each rank's ms/frame is printed: two ranks
     share one card, so it is not a scaling figure. 10a also prints the
     host time of one GN-sum exchange and of one insert gather over NCCL.
The line before the device line is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# correspondence rows (R x P slots x 27 * K lanes, rows from `live` on dead)
# and insert rows (U x R_max) of the two paths
CITY = dict(name="city", R=10_240 + 1_024, P=2, K=40, U=16_896, R_max=48, voxel=0.8, live=9_000)
KITTI = dict(name="kitti", R=16_384 + 2_048, P=2, K=40, U=33_024, R_max=48, voxel=0.8, live=14_000)
# the dynamic filter's radius-count rows: vehicle cell rows x query slots x
# 27 neighbour cells of 32 landmark lanes
KITTI_FILTER = dict(VR=4_096, P=48, M=27 * 32, r2=0.25)
SORT_NS = (2**16, 2**18)  # bitonic checks; the kitti scan's keys pad to 2^18
GN_SUM_RTOL = 1e-4
# the __global__ functions of sage_icp_tpu_torch/csrc, as the profiler names them
PORT_KERNELS = ("semantic_nn_kernel", "gn_iteration_kernel", "retention_policy_kernel", "radius_count_kernel",
                "bitonic_tile_kernel", "bitonic_global_kernel")
ROOT = os.path.dirname(os.path.abspath(__file__))
DRIVE_ROWS = os.path.join(ROOT, "build", "drive_rows.pt")
MULTI_RANK_DIR = os.path.join(ROOT, "build", "multi_rank")
TWO_RANKS_TIMEOUT_S = 600
CLI_OUT = os.path.join(ROOT, "build", "cli_smoke")
CLI_FRAMES = 40
WARMUP, FRAMES = 10, 30  # each path: warm-up and timed frames


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


SPACER_CYCLES = 20_000_000  # ~10 ms of torch.cuda._sleep: the host queues a batch meanwhile


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Device time of one call in ms: after two warm-up calls, `batches`
    batches of `reps` calls, each batch queued behind a spacer kernel so
    that the host's enqueue time is hidden (the calls run back to back on
    the card); the median of the batch means. A call that synchronises
    inside shows the host time after its sync too."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPACER_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def kernel_ms(fn, reps: int = 20) -> float:
    """Device time of one call in ms from torch.profiler: the summed
    durations of the kernels that `reps` calls launch (copies and memsets
    not counted), over reps. A call's host work and synchronisations do
    not count, so a wrapper that synchronises inside is timed as fairly as
    one that does not."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")  # opens the window: the profiler may miss its first kernel
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if events and "FillFunctor" in events[0].name:
        events = events[1:]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_inputs(rng, dev, shape):
    """Seeded correspondence rows at a path's shapes: invalid lanes,
    label-0 candidates and queries, a dead tail of whole tiles."""
    from sage_icp_tpu_torch.ops import correspondence_fast as cf
    from sage_icp_tpu_torch.ops import geometry as geo

    R, P, K, v = shape["R"], shape["P"], shape["K"], shape["voxel"]
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
    used[shape["live"]:] = 0  # rows past the demand: whole dead tiles
    # the increment on the host, as the ICP loop passes it
    T = geo.se3_exp(torch.tensor([0.02, -0.01, 0.005, 0.001, -0.002, 0.003]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(planes=planes + [cl], offs=offs, q_local=t(q_local), q0=t(q_world), origin=t(origin),
                row_abs=t(row_abs), used=t(used), T=T)


def policy_inputs(rng, dev, shape):
    from sage_icp_tpu_torch.ops.policy_kernel import CLS_SHIFT

    U, K, Rm = shape["U"], shape["K"], shape["R_max"]
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


def radius_inputs(rng, dev):
    """Seeded radius-count rows at the kitti filter's shapes: queries on a
    2^-10 m grid, candidates around them, lanes exactly 0.5 m from a query
    along an axis (d2 == r2 without rounding), 1e9 sentinel lanes, unused
    slots and rows without a used slot."""
    R, P, M = KITTI_FILTER["VR"], KITTI_FILTER["P"], KITTI_FILTER["M"]
    grid = lambda a: np.round(a * 1024.0) / 1024.0
    center = grid(rng.uniform(-50.0, 50.0, (R, 1, 3)))
    q = (center + grid(rng.uniform(-0.25, 0.25, (R, P, 3)))).astype(np.float32)
    cand = (center + rng.uniform(-0.75, 0.75, (R, M, 3))).astype(np.float32)
    for lane in range(24):
        cand[:, lane] = q[:, lane % P]
        cand[:, lane, lane % 3] += np.float32(0.5 if lane % 2 else -0.5)
    cand[rng.random((R, M)) < 0.3] = 1.0e9
    used = (rng.random((R, P)) < 0.7).astype(np.int32)
    used[rng.random(R) < 0.5] = 0  # about half the rows are dead, as on the drive
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return [t(cand[..., 0]), t(cand[..., 1]), t(cand[..., 2]), t(q.reshape(R, 3 * P)), t(used)]


def sort_inputs(rng, n, dev):
    """Two heavily duplicated uint32 keys (as int32 views, high bits set),
    an iota key and a float32 payload."""
    k1 = rng.choice(np.array([0, 7, 2**31 - 1, 2**31, 2**32 - 1], np.uint64), n).astype(np.uint32)
    k2 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) & np.uint32(0xF000000F)
    planes = [k1.view(np.int32), k2.view(np.int32), np.arange(n, dtype=np.int32),
              rng.normal(size=n).astype(np.float32)]
    return [torch.from_numpy(p).to(dev) for p in planes]


def sort_library(planes):
    """The same sort in PyTorch calls: the two uint32 keys packed into one
    int64 key (the first shifted into the signed range), one stable
    torch.sort (equal keys keep their iota order), then the gathers."""
    u32 = lambda p: p.to(torch.int64) & 0xFFFFFFFF
    key = (u32(planes[0]) - 2**31) * 2**32 + u32(planes[1])
    order = torch.sort(key, stable=True).indices
    return tuple(p[order] for p in planes)


GN_CONST = dict(sem_th=0.4, max_corr=1.5, kth=0.5)


def check_gn(d, shape, dev):
    """The GN kernel against its plain version on rows `d` of `shape`: the
    sums within GN_SUM_RTOL of the sum of their terms' magnitudes (only
    the summation order differs), the used count equal, one launch per
    call, the same sums on a second call. Returns its row."""
    from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels

    R, P, M, v = shape["R"], shape["P"], 27 * shape["K"], shape["voxel"]
    tile_map = nn_kernels.default_tile_map(d["used"])
    gn_args = (*d["planes"], *d["offs"], d["q0"], d["origin"], d["row_abs"], d["used"], d["T"],
               GN_CONST["sem_th"], v / 32767.0, v, GN_CONST["max_corr"], GN_CONST["kth"])
    cuda_lib.reset_launches()
    got = nn_kernels.fused_gn_iteration(*gn_args, tile_map=tile_map)
    again = nn_kernels.fused_gn_iteration(*gn_args, tile_map=tile_map)
    if cuda_lib.LAUNCHES["fused_gn_iteration"] != 2 or not torch.equal(got, again):
        fail(f"fused_gn_iteration at {shape['name']} shapes: not one launch per call, or not deterministic")
    terms = nn_kernels.gn_terms(*gn_args, tile_map)
    want = terms.sum(dim=1)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = GN_SUM_RTOL * terms.abs().sum(dim=1)
    if not bool(torch.all(diff <= tol)):
        fail(f"fused_gn_iteration at {shape['name']} shapes disagrees with its plain version: "
             f"{diff.tolist()} vs {tol.tolist()}")
    if float(want[16]) <= 0 or float(got[17]) != float(want[17]):
        fail(f"fused_gn_iteration at {shape['name']} shapes: degenerate comparison (no accepted slot) "
             "or used-count mismatch")
    live_rows = int((tile_map == torch.arange(len(tile_map), device=dev)).sum()) * nn_kernels.TILE_ROWS
    live_rows = min(live_rows, R)
    print(f"fused_gn_iteration at {shape['name']} shapes: {nn_kernels.gn_load_bytes(M)}-byte loads, "
          f"{min(nn_kernels.GN_MAX_BLOCKS, -(-R // 8))} blocks of 8 warps, {live_rows} live rows of {R}",
          flush=True)
    gn_bytes = live_rows * (4 * M * 2 + 4 * P * 4 + 3 * 4 + 3 * 4 + P * 4) + 3 * M * 4 + len(tile_map) * 4 + 18 * 4
    b_ms, b_by = bound(gn_bytes, live_rows * M * (6 + 10 * P))
    return dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/gn_iteration.cu",
        replaces="sage_icp_tpu/ops/pallas_nn.py:286", max_abs_err=float(diff.max()),
        ms=time_ms(lambda: nn_kernels.fused_gn_iteration(*gn_args, tile_map=tile_map)),
        plain_ms=time_ms(lambda: nn_kernels.gn_terms(*gn_args, tile_map).sum(dim=1)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_policy(rng, dev, shape):
    """The policy kernel against its plain version, bit for bit, on seeded
    insert rows of `shape`. Returns its row."""
    from sage_icp_tpu_torch.ops import policy_kernel

    U, K = shape["U"], shape["K"]
    pargs, total_seg = policy_inputs(rng, dev, shape)
    got = policy_kernel.apply_policy(*pargs, basic=20)
    want = policy_kernel.apply_policy_plain(*pargs, basic=20)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"apply_policy at {shape['name']} shapes is not bit-exact against its plain version")
    pol_bytes = 2 * (4 * U * K * 2) + 2 * U * 4 + 4 * total_seg * 2 + U * 4
    b_ms, b_by = bound(pol_bytes, total_seg * 10)
    return dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/retention_policy.cu",
        replaces="sage_icp_tpu/ops/pallas_insert.py:223", max_abs_err=0.0,
        ms=time_ms(lambda: policy_kernel.apply_policy(*pargs, basic=20)),
        plain_ms=time_ms(lambda: policy_kernel.apply_policy_plain(*pargs, basic=20)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_shards(dev) -> None:
    """Phase 3, the two row-sharded kernels at kitti shapes split in two
    as phase 10's ranks run them (seeded rows of their own): GN on each
    half's rows (views, the tile map recomputed per half), the two sums
    added in rank order, against the call on all rows within GN_SUM_RTOL
    of the terms' magnitudes, the used count equal; the policy on each
    half, concatenated, against the call on all rows bit for bit. Prints
    each half's kernel time (time_ms)."""
    from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel

    rng = np.random.default_rng(2)
    d = row_inputs(rng, dev, KITTI)
    v = KITTI["voxel"]
    consts = (GN_CONST["sem_th"], v / 32767.0, v, GN_CONST["max_corr"], GN_CONST["kth"])

    def gn_call(lo, hi):
        used = d["used"][lo:hi]
        args = (*[p[lo:hi] for p in d["planes"]], *d["offs"], d["q0"][lo:hi], d["origin"][lo:hi],
                d["row_abs"][lo:hi], used, d["T"], *consts)
        tile_map = nn_kernels.default_tile_map(used)
        return args, tile_map, lambda: nn_kernels.fused_gn_iteration(*args, tile_map=tile_map)

    R = KITTI["R"]
    args, tile_map, full = gn_call(0, R)
    halves = [gn_call(0, R // 2), gn_call(R // 2, R)]
    parts = [h[2]() for h in halves]
    total = parts[0] + parts[1]  # rank order, as ops/registration.py adds them
    want = full()
    tol = GN_SUM_RTOL * nn_kernels.gn_terms(*args, tile_map).abs().sum(dim=1)
    diff = (total - want).abs()
    if not bool(torch.all(diff <= tol)) or float(total[17]) != float(want[17]):
        fail(f"fused_gn_iteration on two row halves disagrees with all rows: {diff.tolist()} vs {tol.tolist()}")
    gn_ms = [time_ms(h[2]) for h in halves]

    pargs, _ = policy_inputs(rng, dev, KITTI)
    U = pargs[0].shape[0]
    want = policy_kernel.apply_policy(*pargs, basic=20)
    shards = [[a[lo:hi] for a in pargs] for lo, hi in ((0, U // 2), (U // 2, U))]
    got = [policy_kernel.apply_policy(*a, basic=20) for a in shards]
    if not all(torch.equal(torch.cat([g0, g1]), w) for g0, g1, w in zip(*got, want)):
        fail("apply_policy on two row halves differs from the call on all rows")
    pol_ms = [time_ms(lambda a=a: policy_kernel.apply_policy(*a, basic=20)) for a in shards]
    print(f"row halves at kitti shapes (phase 10's two ranks): fused_gn_iteration on {R // 2} + {R - R // 2} rows "
          f"{gn_ms[0]:.4f} + {gn_ms[1]:.4f} ms, their sums in rank order against all rows max |diff| "
          f"{float(diff.max())} (within tolerance); apply_policy on {U // 2} + {U - U // 2} rows {pol_ms[0]:.4f} + "
          f"{pol_ms[1]:.4f} ms, equal to all rows bit for bit", flush=True)


def print_row(name, r) -> None:
    lib = "" if r["library_ms"] is None else f" library {r['library_ms']:.4f} ms"
    print(f"kernel {name}: max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms "
          f"plain {r['plain_ms']:.4f} ms{lib} bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)


def check_kernels(dev):
    """Phase 3. Returns {name: row of the kernel table without launches}:
    the NN, GN and policy rows at city shapes; the GN and policy kernels
    are checked and timed at kitti shapes too, and printed."""
    from sage_icp_tpu_torch.ops import nn_kernels, sort_kernel

    rng = np.random.default_rng(0)
    R, P, K, v = CITY["R"], CITY["P"], CITY["K"], CITY["voxel"]
    M = 27 * K
    rows = {}

    d = row_inputs(rng, dev, CITY)
    nn_args = (*d["planes"], *d["offs"], d["q_local"], GN_CONST["sem_th"], v / 32767.0)
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
    rows["fused_gn_iteration"] = check_gn(d, CITY, dev)
    rows["apply_policy"] = check_policy(rng, dev, CITY)
    del d
    # the kitti path's sizes, from their own seed
    krng = np.random.default_rng(1)
    print_row("fused_gn_iteration at kitti shapes", check_gn(row_inputs(krng, dev, KITTI), KITTI, dev))
    print_row("apply_policy at kitti shapes", check_policy(krng, dev, KITTI))
    check_shards(dev)

    R, P, M, r2 = (KITTI_FILTER[k] for k in ("VR", "P", "M", "r2"))
    rargs = radius_inputs(rng, dev) + [r2]
    got = nn_kernels.radius_count(*rargs)
    want = nn_kernels.radius_count_plain(*rargs)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or float(want.max()) <= 0:
        fail("radius_count is not bit-exact against its plain version (or counted nothing)")
    used = rargs[4]
    live_rows = int((used != 0).any(dim=1).sum())
    used_slots = int((used != 0).sum())
    # what this data needs: candidates of the rows with a used slot, all
    # queries, flags and counts; 9 operations per lane of a used slot
    rc_bytes = live_rows * 3 * M * 4 + R * 3 * P * 4 + R * P * 4 + R * P * 4
    b_ms, b_by = bound(rc_bytes, used_slots * M * 9)
    rows["radius_count"] = dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/radius_count.cu",
        replaces="sage_icp_tpu/ops/pallas_nn.py:426", max_abs_err=0.0,
        ms=time_ms(lambda: nn_kernels.radius_count(*rargs)),
        plain_ms=time_ms(lambda: nn_kernels.radius_count_plain(*rargs)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    flags = (True, True, False)
    for n in SORT_NS:
        planes = sort_inputs(rng, n, dev)
        got = sort_kernel.bitonic_sort_planes(planes, 3, flags)
        want = sort_kernel.bitonic_sort_planes_plain(planes, 3, flags)
        net = sort_kernel.bitonic_network_plain(planes, 3, flags)
        lib = sort_library(planes)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
                   for a, b, c, d in zip(got, want, lib, net)):
            fail(f"bitonic_sort_planes is not bit-exact against its plain versions at N = {n}")
        if torch.equal(got[2], planes[2]):
            fail(f"bitonic_sort_planes: degenerate check at N = {n} (input already sorted)")
        print(f"kernel bitonic_sort_planes at N = {n}, 4 planes: {sort_kernel.bitonic_launches(n, 3)} "
              f"launches per call, {time_ms(lambda: sort_kernel.bitonic_sort_planes(planes, 3, flags)):.4f} ms",
              flush=True)
    # tied composite keys (no iota key): the network's copy-over, bit for bit
    tied = [planes[0], planes[1], planes[2], planes[3]]
    got = sort_kernel.bitonic_sort_planes(tied, 2, flags[:2])
    net = sort_kernel.bitonic_network_plain(tied, 2, flags[:2])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, net)):
        fail(f"bitonic_sort_planes on tied keys differs from the network at N = {n}")
    print(f"bitonic_sort_planes on tied keys at N = {n}: equal to the network; "
          f"{int((got[2] == torch.arange(n, device=dev, dtype=torch.int32)).sum())} positions hold their "
          f"own index, {n - int(torch.unique(got[2]).numel())} payloads lost to copy-over", flush=True)
    b_ms, b_by = bound(len(planes) * n * 8, 0)
    rows["bitonic_sort_planes"] = dict(
        route="cuda", source="sage_icp_tpu_torch/csrc/bitonic_sort.cu",
        replaces="sage_icp_tpu/ops/pallas_sort.py:133", max_abs_err=0.0,
        ms=time_ms(lambda: sort_kernel.bitonic_sort_planes(planes, 3, flags)),
        plain_ms=time_ms(lambda: sort_kernel.bitonic_sort_planes_plain(planes, 3, flags)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: sort_library(planes)))
    for name, r in rows.items():
        print_row(name, r)
    return rows


def time_tree(dev) -> dict:
    """--root: the kernels of the port at --root on phase 3's inputs (the
    same seeds and shapes), each timed with time_ms and kernel_ms. Only
    the wrapper interfaces that every slice of the port shares are called;
    nothing is checked. T goes to the GN wrapper on the host, as the ICP
    loop passes it."""
    from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel, sort_kernel

    times = {}

    def record(name, fn):
        times[name] = dict(ms=time_ms(fn), kernel_ms=kernel_ms(fn))
        print(f"{name}: time_ms {times[name]['ms']:.4f}, kernel_ms {times[name]['kernel_ms']:.4f}", flush=True)

    rng = np.random.default_rng(0)
    for shape, seeded in ((CITY, rng), (KITTI, np.random.default_rng(1))):
        d = row_inputs(seeded, dev, shape)
        v = shape["voxel"]
        tile_map = nn_kernels.default_tile_map(d["used"])
        gn_args = (*d["planes"], *d["offs"], d["q0"], d["origin"], d["row_abs"], d["used"], d["T"],
                   GN_CONST["sem_th"], v / 32767.0, v, GN_CONST["max_corr"], GN_CONST["kth"])
        if shape is CITY:
            nn_args = (*d["planes"], *d["offs"], d["q_local"], GN_CONST["sem_th"], v / 32767.0)
            record("fused_semantic_nn city", lambda: nn_kernels.fused_semantic_nn(*nn_args))
        record(f"fused_gn_iteration {shape['name']}", lambda: nn_kernels.fused_gn_iteration(*gn_args, tile_map=tile_map))
        del d
        pargs, _ = policy_inputs(seeded, dev, shape)
        record(f"apply_policy {shape['name']}", lambda: policy_kernel.apply_policy(*pargs, basic=20))
    rargs = radius_inputs(rng, dev) + [KITTI_FILTER["r2"]]
    record("radius_count kitti filter", lambda: nn_kernels.radius_count(*rargs))
    flags = (True, True, False)
    for n in SORT_NS:
        planes = sort_inputs(rng, n, dev)
        record(f"bitonic_sort_planes 2^{n.bit_length() - 1} x 4",
               lambda: sort_kernel.bitonic_sort_planes(planes, 3, flags))
    record("library 2^18 x 4 (packed torch.sort + gathers)", lambda: sort_library(planes))
    if os.path.exists(DRIVE_ROWS):
        rows = torch.load(DRIVE_ROWS)
        to = lambda args: [a.to(dev) if torch.is_tensor(a) else a for a in args]
        pargs, rargs = to(rows["apply_policy"]), to(rows["radius_count"])
        basic = rows["basic"]
        record("apply_policy kitti drive rows", lambda: policy_kernel.apply_policy(*pargs, basic=basic))
        record("radius_count kitti drive rows", lambda: nn_kernels.radius_count(*rargs))
    return times


def ate_of(est, gt) -> float:
    """Translation RMSE of est against gt, both rebased to their first pose."""
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(est, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


def expect_launches(name, launches, gn, frames, prepares) -> None:
    """GN once per ICP iteration (`gn`), the policy once a frame (the
    insert), the radius count once per prepare (the filter: once a frame,
    and once more in each of IcpTimer's replays), the NN and sort kernels
    not at all."""
    expect = dict(fused_gn_iteration=gn, apply_policy=frames, radius_count=prepares, fused_semantic_nn=0,
                  bitonic_sort_planes=0)
    for kernel, count in expect.items():
        if launches[kernel] != count:
            fail(f"{name}: {kernel} launched {launches[kernel]} times, expected {count}")


def register(odom, scans, warmup: int, n: int):
    """The drives' calls: register_frame on scans[:warmup], then timed on
    scans[warmup:n]. Returns (seconds of the timed frames, the launches
    counted from the first frame on)."""
    from sage_icp_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    for i in range(warmup):
        odom.register_frame(scans[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, n):
        odom.register_frame(scans[i])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(cuda_lib.LAUNCHES)


def drive(name: str, odom, density: float, warmup: int, frames: int, extra: int):
    """Phases 4 and 6: `odom` over the city world at `density` along
    make_trajectory, scans from render_scan at n_target 120000. Returns
    (scans, launches, gt); `extra` more scans along the trajectory follow
    the path's."""
    from sage_icp_tpu_torch.utils import synthetic

    pts, labs = synthetic.build_city_world(seed=0, size=420.0, density=density)
    n = warmup + frames
    gt = synthetic.make_trajectory(n + extra, step=1.0)
    rng = np.random.default_rng(0)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: pose math must run in full float32")
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=120_000,
                                   max_range=min(100.0, odom.config.max_range)) for i in range(n + extra)]
    if max(len(s) for s in scans) > odom.config.scan_capacity:
        fail("scan capacity overflow")
    elapsed, launches = register(odom, scans, warmup, n)

    totals = odom.aux_totals()
    if int(totals.overflow_total()) != 0:
        fail(f"silent-drop counters over all frames: {totals}")
    ate = ate_of(odom.trajectory(), gt[:n])
    if not np.isfinite(ate) or ate >= 0.05:
        fail(f"ATE {ate} m over {n} frames")
    # the NN kernel has its own path (phase 5), the sort kernel its own
    # check (phase 7)
    expect_launches(f"{name} path", launches, sum(odom.icp_iters), n,
                    n if odom.config.dynamic_vehicle_filter else 0)
    print(f"{name} path: {frames} timed frames in {elapsed:.4f} s = {frames / elapsed:.3f} scans/s, "
          f"{1e3 * elapsed / frames:.3f} ms/frame; ICP iterations {odom.icp_iters}; "
          f"ATE {ate:.5f} m; live voxels {int((odom.state.map.counts > 0).sum())}; "
          f"launches {launches}", flush=True)
    return scans, launches, gt[:n]


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
    prep = pl.prepare_icp_inputs(odom.state, buf, buf[:, 0] < 1.0e6, torch.zeros(len(buf), device=dev), cfg)
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


def capture(module, name: str, fn):
    """Run fn() with module.<name> wrapped to keep the arguments of its
    first call; the wrapper is restored afterwards. Returns (fn's result,
    (args, kwargs))."""
    orig = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, spy)
    try:
        result = fn()
    finally:
        setattr(module, name, orig)
    if not seen:
        fail(f"{module.__name__}.{name} was not called")
    return result, seen[0]


def drive_rows(odom, buf, rargs) -> None:
    """Phase 7's drive rows: the policy kernel's arguments from one map
    insert of the scan in `buf` (as profile runs it, the state held
    fixed) and the radius count's `rargs` from the frame's filter. Each
    kernel against its plain version bit for bit, the rows' shape, the
    kernel's time; the arguments go to DRIVE_ROWS for --root."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.ops import hashmap as hm
    from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel

    cfg, dev, state = odom.config, odom.device, odom.state
    prep = pl.prepare_icp_inputs(state, buf, buf[:, 0] < 1.0e6, torch.zeros(len(buf), device=dev), cfg)
    icp = pl.run_icp(state.map, prep, cfg)
    world = geo.transform_points(icp.pose, prep["frame_ds"])
    _, (pargs, pkw) = capture(policy_kernel, "apply_policy", lambda: hm.insert(
        state.map, world, prep["frame_valid"], cfg.voxel_size_map, cfg.basic_points_per_voxel,
        pl.basic_label_mask(cfg, dev), cfg.max_incoming_per_voxel, cfg.probe_depth,
        min(cfg.insert_unique_capacity, cfg.frame_capacity), prep["tables"]))
    basic = pkw["basic"]
    got = policy_kernel.apply_policy(*pargs, basic=basic)
    want = policy_kernel.apply_policy_plain(*pargs, basic=basic)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("apply_policy on the kitti drive's rows is not bit-exact against its plain version")
    seg = pargs[5][:, 0]
    U, K = pargs[0].shape
    total_seg = int(seg.sum())
    b_ms, b_by = bound(2 * (4 * U * K * 2) + 2 * U * 4 + 4 * total_seg * 2 + U * 4, total_seg * 10)
    ms = time_ms(lambda: policy_kernel.apply_policy(*pargs, basic=basic))
    print(f"apply_policy on the kitti drive's rows: bit-exact; U {U}, K {K}, R_max {pargs[6].shape[1]}, "
          f"live rows {int((seg > 0).sum())}, sum of seglen {total_seg}, rows with seglen > 24 "
          f"{int((seg > 24).sum())}; kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)

    got = nn_kernels.radius_count(*rargs)
    want = nn_kernels.radius_count_plain(*rargs)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("radius_count on the kitti drive's rows is not bit-exact against its plain version")
    cx, used = rargs[0], rargs[4]
    VR, M = cx.shape
    live = (used != 0).any(dim=1)
    n_live, n_used = int(live.sum()), int((used != 0).sum())
    lanes = int(((cx < 1.0e9) & live[:, None]).sum())
    # as phase 3 counts it: candidates of the live rows, all queries, flags
    # and counts; 9 operations per lane of a used slot
    b_ms, b_by = bound(n_live * 3 * M * 4 + VR * 3 * used.shape[1] * 4 + 2 * used.numel() * 4, n_used * M * 9)
    ms = time_ms(lambda: nn_kernels.radius_count(*rargs))
    print(f"radius_count on the kitti drive's rows: bit-exact; VR {VR}, M {M}, P {used.shape[1]}, live rows "
          f"{n_live}, used slots {n_used}, lanes under 1e9 in live rows {lanes} of {n_live * M}; kernel "
          f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    os.makedirs(os.path.dirname(DRIVE_ROWS), exist_ok=True)
    cpu = lambda args: [a.cpu() if torch.is_tensor(a) else a for a in args]
    torch.save({"apply_policy": cpu(pargs), "basic": basic, "radius_count": cpu(rargs)}, DRIVE_ROWS)


def kitti_checks(odom, scan):
    """Phase 7, after the kitti path, on its last frame preprocessed as the
    step does: the filter's vehicle points in, kept and removed, and its
    time; the filter on the card against the filter on the CPU (keep mask,
    points and overflow bit for bit); the sort kernel on the filter's
    vehicle sort keys (cell id, or 2^30 for other points, then the
    position as an iota key, padded to 2^18 with sentinel keys) against
    torch.sort(stable=True); the drive's own kernel rows (drive_rows).
    Returns the sort kernel's launches there."""
    from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn
    from sage_icp_tpu_torch.ops import scan as scan_ops
    from sage_icp_tpu_torch.ops import sort_kernel

    cfg, dev = odom.config, odom.device
    buf = torch.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD)
    buf[: len(scan)] = torch.from_numpy(scan)
    buf = buf.to(dev)
    pts, ok = scan_ops.preprocess(buf, buf[:, 0] < 1.0e6, cfg.max_range, cfg.min_range, cfg.label_max_range)

    card, (rargs, _) = capture(nn_kernels, "radius_count", lambda: dyn.filter_dynamic_vehicles(pts, ok, cfg))
    cpu = dyn.filter_dynamic_vehicles(pts.cpu(), ok.cpu(), cfg)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    veh_key, _, vehicle = dyn.class_sort_keys(pts, ok, cfg)
    v_in, v_kept = int(vehicle.sum()), int((vehicle & card[1]).sum())
    filter_ms = time_ms(lambda: dyn.filter_dynamic_vehicles(pts, ok, cfg), reps=10)
    print(f"kitti filter, last frame: vehicle points in {v_in}, kept {v_kept}, removed {v_in - v_kept}, "
          f"overflow {int(card[2])}; of {int(ok.sum())} points {int(ok.sum()) - int(card[1].sum())} removed; "
          f"card against CPU: {'equal' if same else 'DIFFERENT'}; filter {filter_ms:.4f} ms", flush=True)
    if not same:
        fail("the dynamic filter on the card disagrees with the filter on the CPU")
    if v_in == 0 or int(card[2]) != 0:
        fail("the kitti frame gave the filter no vehicle point, or overflowed it")

    n = SORT_NS[-1]
    pad = torch.full((n - len(veh_key),), torch.iinfo(torch.int32).max, dtype=torch.int32, device=dev)
    key = torch.cat([veh_key, pad])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    cuda_lib.reset_launches()
    s_key, s_pos = sort_kernel.bitonic_sort_planes((key, pos), 2)
    torch.cuda.synchronize()
    launches = cuda_lib.LAUNCHES["bitonic_sort_planes"]
    ref = torch.sort(key, stable=True)
    if launches != 1 or not torch.equal(s_pos.long(), ref.indices) or not torch.equal(s_key, ref.values):
        fail("bitonic_sort_planes on the filter's sort keys differs from torch.sort(stable=True)")
    print(f"bitonic sort of the last frame's vehicle keys ({int((key < 2**30).sum())} members of {n}): "
          f"permutation equals torch.sort(stable=True); kernel "
          f"{time_ms(lambda: sort_kernel.bitonic_sort_planes((key, pos), 2)):.4f} ms in "
          f"{sort_kernel.bitonic_launches(n, 2)} launches, torch.sort "
          f"{time_ms(lambda: torch.sort(key, stable=True)):.4f} ms", flush=True)
    drive_rows(odom, buf, rargs)
    return launches


def profile(name, odom, scans, tss=None) -> float:
    """Optional phase 8 (--profile): where the time of a frame goes, on
    the frames that follow the path's (with their per-point timestamps
    `tss` on the deskew path). First the host phases of the next frame,
    timed with a synchronise after each (the state held fixed, repeated);
    then the device's busy share and its kernels by total time from
    torch.profiler while the frames are registered. Returns the device
    busy ms a frame."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.ops import hashmap as hm

    cfg, dev = odom.config, odom.device
    phases = {"upload+prepare": 0.0, "icp": 0.0, "insert+cull": 0.0}
    iters = 0
    state = odom.state
    n = len(scans)
    tss = tss or [None] * n
    buf = odom.pad_chunk(scans[:1], tss[:1])[0]
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts, valid, ts = pl._split_packed(torch.from_numpy(buf).to(dev))
        prep = pl.prepare_icp_inputs(state, pts, valid, ts, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        icp = pl.run_icp(state.map, prep, cfg, odom.mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        world = geo.transform_points(icp.pose, prep["frame_ds"])
        new_map, _ = hm.insert(state.map, world, prep["frame_valid"], cfg.voxel_size_map,
                               cfg.basic_points_per_voxel, pl.basic_label_mask(cfg, dev),
                               cfg.max_incoming_per_voxel, cfg.probe_depth,
                               min(cfg.insert_unique_capacity, cfg.frame_capacity), prep["tables"],
                               mesh=odom.mesh)
        hm.remove_far(new_map, icp.pose[:3, 3], cfg.local_map_range)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2)):
            phases[k] += dt
        iters += icp.iterations
    print(f"{name} profile host phases (ms/frame, state held fixed): "
          + ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in phases.items())
          + f"; ICP iterations/frame {iters / n:.2f}", flush=True)

    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for scan, ts in zip(scans, tss):
            odom.register_frame(scan, ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"{name} profile: {n} frames, wall {1e3 * wall / n:.3f} ms/frame, device busy "
          f"{busy_us / 1e3 / n:.3f} ms/frame, idle share {1 - busy_us / 1e6 / wall:.4f}, "
          f"{launches / n:.1f} device ops/frame", flush=True)
    line = lambda e: f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/frame {e.count / n:7.1f}x  {e.key[:90]}"
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(line(e), flush=True)
    print(f"{name} profile, the port's kernels:", flush=True)
    for e in events:
        if any(k in e.key for k in PORT_KERNELS):
            print(line(e), flush=True)
    return busy_us / 1e3 / n


def run_cli(mode: str, extra: list) -> dict:
    """Phase 9.1-9.2: the CLI in process, kitti preset with deskew, over
    CLI_FRAMES synthetic frames into build/cli_smoke/<mode>; the gates on
    its outputs, drops and launches. Returns the mode's numbers and path."""
    from sage_icp_tpu_torch.ops import cuda_lib
    from sage_icp_tpu_torch.runtime import cli

    out = os.path.join(CLI_OUT, mode)
    argv = ["--synthetic", "--preset", "kitti", "--deskew", "--frames", str(CLI_FRAMES), "--chunk", "8",
            "--out", out, *extra]
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    res = cli.main(argv)["synthetic"]
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    with open(os.path.join(out, "metrics.json")) as f:
        ate = json.load(f)["synthetic"]["ate_trans_m"]
    files = {}
    for name in ("path.txt", "gt_path.txt", "time.txt"):
        with open(os.path.join(out, "synthetic", name)) as f:
            files[name] = [ln.split() for ln in f.read().splitlines()]
        if len(files[name]) != CLI_FRAMES:
            fail(f"CLI {mode}: {name} has {len(files[name])} lines, expected {CLI_FRAMES}")
    if not ate < 0.05:
        fail(f"CLI {mode}: ATE {ate} m")
    if int(res.totals.overflow_total()) != 0:
        fail(f"CLI {mode}: silent-drop counters over all frames: {res.totals}")
    if mode == "timed":
        t_icp = [float(ln[1]) if ln[1] != "n/a" else float("nan") for ln in files["time.txt"]]
        if not all(np.isfinite(t) and t > 0 for t in t_icp):
            fail(f"CLI timed: t_icp not finite and positive on every line: {t_icp}")
    replays = CLI_FRAMES if mode == "timed" else 0  # IcpTimer replays prepare and the solve each frame
    expect_launches(f"CLI {mode}", launches, sum(res.iterations) + sum(res.replay_iterations), CLI_FRAMES,
                    CLI_FRAMES + replays)
    ms = 1e3 * res.mean_total_time
    print(f"CLI {mode} ({' '.join(argv)}): ATE {ate:.5f} m, {ms:.3f} ms/frame (runner's mean_frame_time_s), "
          f"wall {wall:.2f} s, ICP iterations {sum(res.iterations)} + {sum(res.replay_iterations)} in the "
          f"timer's replays, launches {launches}", flush=True)
    path = np.array([[float(v) for v in ln[1:4]] for ln in files["path.txt"]])
    return dict(ate=ate, ms=ms, path=path)


def skew(scans, frames):
    """The kitti drive's first `frames` scans, each skewed by its own
    frame's motion over the azimuth sweep phase, and the phases."""
    from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.utils import synthetic

    gt = synthetic.make_trajectory(frames + 1, step=1.0)
    skewed, tss = [], []
    for i in range(frames):
        delta = geo.se3_log(torch.as_tensor(np.linalg.inv(gt[i]) @ gt[i + 1], dtype=torch.float32)).numpy()
        ts = azimuth_timestamps(scans[i][:, :3]).astype(np.float32)
        skewed.append(synthetic.skew_scan(scans[i], delta, ts))
        tss.append(ts)
    return skewed, tss, gt[:frames]


def deskew_drive(deskew: bool, scans, tss, gt):
    """Phase 9.3: the kitti preset, deskew on or off, over the skewed
    scans; no drop, the launches. Returns (odom, ATE, ms/frame)."""
    import dataclasses

    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP
    from sage_icp_tpu_torch.ops import cuda_lib

    odom = SageICP(dataclasses.replace(PRESETS["kitti"], deskew=deskew))
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan, ts in zip(scans, tss):
        odom.register_frame(scan, ts)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(scans)
    totals = odom.aux_totals()
    name = f"skewed kitti drive, deskew {'on' if deskew else 'off'}"
    if int(totals.overflow_total()) != 0:
        fail(f"{name}: silent-drop counters over all frames: {totals}")
    expect_launches(name, dict(cuda_lib.LAUNCHES), sum(odom.icp_iters), len(scans), len(scans))
    ate = ate_of(odom.trajectory(), gt)
    print(f"{name}: ATE {ate:.5f} m, {ms:.3f} ms/frame, ICP iterations {sum(odom.icp_iters)}", flush=True)
    return odom, ate, ms


def runtime_phase(kitti_scans, dev):
    """Phase 9: the CLI chunked and timed, deskew at full width on the
    skewed kitti drive (per-frame and chunked), the deskew on the card
    against the CPU and its time, and a checkpoint resume. Returns (the
    deskew-on odometry, the skewed scans and their timestamps, the
    deskew's kernel time in ms)."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.models.state_io import state_to_numpy
    from sage_icp_tpu_torch.ops import scan as scan_ops
    from sage_icp_tpu_torch.runtime.checkpoint import load_state, save_state

    chunked = run_cli("chunk", [])
    timed = run_cli("timed", ["--timed-icp"])
    gap = float(np.abs(chunked["path"] - timed["path"]).max())
    print(f"CLI chunked against per-frame: max |path difference| {gap} m; ms/frame chunked "
          f"{chunked['ms']:.3f} (render included), per-frame timed {timed['ms']:.3f} (register_frame only)",
          flush=True)
    if gap > 1e-5:
        fail(f"CLI: the chunked and per-frame trajectories differ by {gap} m")

    n = WARMUP + FRAMES
    scans, tss, gt = skew(kitti_scans, len(kitti_scans))
    _, ate_off, _ = deskew_drive(False, scans[:n], tss[:n], gt[:n])
    odom, ate_on, frame_ms = deskew_drive(True, scans[:n], tss[:n], gt[:n])
    print(f"deskew on the skewed kitti drive: ATE on {ate_on:.5f} m, off {ate_off:.5f} m", flush=True)
    if not (ate_on < 0.05 and ate_on <= ate_off):
        fail(f"deskew: ATE on {ate_on} m against off {ate_off} m")

    # the same drive chunked (register_chunk, W = 8) against per-frame
    chunked = pl.SageICP(odom.config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n, 8):
        chunked.register_chunk(scans[i:i + 8], tss[i:i + 8])
    gap = float(np.abs(chunked.trajectory() - odom.trajectory()).max())  # the fetch waits for the card
    chunk_ms = 1e3 * (time.perf_counter() - t0) / n
    print(f"the deskewed kitti drive chunked (W = 8): {chunk_ms:.3f} ms/frame against {frame_ms:.3f} per-frame; "
          f"max |pose difference| {gap}", flush=True)
    if gap > 1e-5 or int(chunked.aux_totals().overflow_total()) != 0:
        fail("the chunked deskewed kitti drive differs from per-frame, or dropped work")

    # one frame's deskew on the card against the CPU, between the poses the
    # step of frame k deskews it with, and its device time
    k = n // 2
    traj = torch.from_numpy(odom.trajectory()).to(torch.float32)
    buf = torch.from_numpy(odom.pad_chunk([scans[k]], [tss[k]])[0])
    args = pl._split_packed(buf)
    pts, ts, start, finish = (a.to(dev) for a in (args[0], args[2], traj[k - 2], traj[k - 1]))
    cpu = scan_ops.deskew(args[0], args[2], traj[k - 2], traj[k - 1])
    card = scan_ops.deskew(pts, ts, start, finish)
    valid = args[1]
    err = float((card.cpu()[valid] - cpu[valid]).abs().max())
    deskew_ms = time_ms(lambda: scan_ops.deskew(pts, ts, start, finish))
    deskew_kernel_ms = kernel_ms(lambda: scan_ops.deskew(pts, ts, start, finish))
    print(f"deskew of frame {k} ({int(valid.sum())} points of {len(buf)}): card against CPU max |diff| {err} m; "
          f"time_ms {deskew_ms:.4f}, kernel_ms {deskew_kernel_ms:.4f} at {len(buf)} points", flush=True)
    if err > 1e-5:
        fail(f"deskew on the card differs from the CPU by {err} m")

    # checkpoint resume: half the drive, save, load into a fresh SageICP,
    # the other half; against the uninterrupted deskew-on run
    half = n // 2
    first = pl.SageICP(odom.config)
    for scan, ts in zip(scans[:half], tss[:half]):
        first.register_frame(scan, ts)
    path = os.path.join(CLI_OUT, "resume.npz")
    save_state(path, first)
    resumed = load_state(path, pl.SageICP(odom.config))
    for scan, ts in zip(scans[half:n], tss[half:n]):
        resumed.register_frame(scan, ts)
    gap = float(np.abs(resumed.trajectory()[:, :3, 3] - odom.trajectory()[:, :3, 3]).max())
    a, b = state_to_numpy(resumed.state), state_to_numpy(odom.state)
    same_map = all(np.array_equal(a[f], b[f]) for f in a if f.startswith("map."))
    print(f"checkpoint resume after frame {half}: trajectory max |diff| {gap} m against the uninterrupted run, "
          f"map {'equal slot for slot' if same_map else 'DIFFERENT'}", flush=True)
    if gap > 1e-5 or not same_map:
        fail("checkpoint resume differs from the uninterrupted run")
    return odom, scans, tss, deskew_kernel_ms


def host_ms(fn, reps: int = 50) -> float:
    """Host time of one call in ms, the mean of `reps` after 5 warm-up
    calls, the card synchronised before and after."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def collective_ms(mesh, dev, policy_rows: int, kmax: int) -> dict:
    """The sharded step's two exchanges on `mesh`, host ms a call: the GN
    sums' (the (1, 18) gather and its fetch, against the single-device
    fetch of the (18,) sums) and the insert's (the gather of `policy_rows`
    packed rows of 8 K + 4 bytes)."""
    sums = torch.zeros(18, device=dev)
    packed = torch.zeros((policy_rows, 8 * kmax + 4), dtype=torch.uint8, device=dev)
    return dict(gn_exchange=host_ms(lambda: mesh.all_gather(sums[None]).cpu()), gn_fetch=host_ms(lambda: sums.cpu()),
                insert_gather=host_ms(lambda: mesh.all_gather(packed)))


def nccl_world_of_one(scans, traj, dev, profile_scans=None) -> None:
    """Phase 10a: NCCL at world size 1, in process; ShardedSageICP() on
    the kitti drive's scans with phase 6's calls, equal to phase 6 bit for
    bit. With profile_scans (--profile), phase 8's breakdown of this path
    on them."""
    import torch.distributed as dist

    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.parallel.distributed import init_distributed
    from sage_icp_tpu_torch.parallel.sharding import ShardedSageICP

    rendezvous = os.path.join(MULTI_RANK_DIR, "rendezvous_nccl")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    mesh = init_distributed(f"file://{rendezvous}", 1, 0, backend="nccl", device=dev)
    try:
        if dist.get_backend() != "nccl":
            fail(f"phase 10a: the process group's backend is {dist.get_backend()}, not nccl")
        odom = ShardedSageICP()  # the kitti preset on make_mesh(): the group just joined
        if odom.mesh.group is None or odom.mesh.size != 1 or odom.config != PRESETS["kitti"]:
            fail(f"ShardedSageICP() at world size 1: mesh {odom.mesh}, config padded away from the kitti preset")
        elapsed, launches = register(odom, scans, WARMUP, len(scans))
        cfg = odom.config
        coll = collective_ms(odom.mesh, odom.device, min(cfg.insert_unique_capacity, cfg.frame_capacity),
                             cfg.points_per_voxel)
        got, iters, totals = odom.trajectory(), list(odom.icp_iters), odom.aux_totals()
        if profile_scans:
            profile("kitti NCCL world of one", odom, profile_scans)
    finally:
        dist.destroy_process_group()
    if not np.array_equal(got, traj):
        fail(f"NCCL world of one differs from phase 6's trajectory: max |diff| {np.abs(got - traj).max()}")
    if int(totals.overflow_total()) != 0:
        fail(f"NCCL world of one: silent-drop counters over all frames: {totals}")
    expect_launches("NCCL world of one", launches, sum(iters), len(scans), len(scans))
    frames = len(scans) - WARMUP
    print(f"NCCL world of one (ShardedSageICP(), kitti preset): trajectory equal to phase 6's bit for bit; "
          f"{1e3 * elapsed / frames:.3f} ms/frame over {frames} timed frames; ICP iterations "
          f"{sum(iters)}; launches {launches}", flush=True)
    print(f"NCCL world of one, host ms a call: GN sums gathered and fetched {coll['gn_exchange']:.4f} "
          f"(fetched alone {coll['gn_fetch']:.4f}); the insert's gather {coll['insert_gather']:.4f}", flush=True)


def two_ranks_one_card(scans, traj, gt, dev) -> None:
    """Phase 10b: two parallel.worker processes on the card over gloo, at
    the full kitti preset, on the kitti drive's scans."""
    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.parallel.worker import save_scans

    out = os.path.join(MULTI_RANK_DIR, "two_ranks")
    os.makedirs(out, exist_ok=True)
    rendezvous = os.path.join(MULTI_RANK_DIR, "rendezvous_gloo")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    save_scans(os.path.join(out, "scans.npy"), scans)
    cmds = [[sys.executable, "-m", "sage_icp_tpu_torch.parallel.worker", "--rank", str(r), "--world", "2",
             "--init", f"file://{rendezvous}", "--backend", "gloo", "--device", f"cuda:{dev.index or 0}",
             "--preset", "kitti", "--scans", os.path.join(out, "scans.npy"), "--out", out] for r in range(2)]
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        logs = [p.communicate(timeout=TWO_RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"rank {r} of the two-rank run exited {p.returncode}:\n{log[-4000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank_{r}.json")) as f:
            ranks.append(dict(report=json.load(f), poses=np.load(os.path.join(out, f"poses_{r}.npy")),
                              map=dict(np.load(os.path.join(out, f"map_{r}.npz")))))
    r0, r1 = ranks
    if not np.array_equal(r0["poses"], r1["poses"]):
        fail(f"the two ranks' trajectories differ: max |diff| {np.abs(r0['poses'] - r1['poses']).max()}")
    if not all(np.array_equal(r0["map"][k], r1["map"][k]) for k in r0["map"]):
        fail("the two ranks' final maps differ")
    gap = float(np.linalg.norm(r0["poses"][:, :3, 3] - traj[:, :3, 3], axis=-1).max())
    ate = ate_of(r0["poses"], gt)
    if not gap < 5e-3:
        fail(f"two ranks: {gap} m from phase 6's single-device trajectory (bound 5e-3 m)")
    if not ate < 0.05:
        fail(f"two ranks: ATE {ate} m")
    cfg = PRESETS["kitti"]
    gn_rows = (cfg.corr_unique_voxel_rows + cfg.corr_overflow_rows) // 2
    policy_rows = min(cfg.insert_unique_capacity, cfg.frame_capacity) // 2
    n = len(scans)
    for r, rank in enumerate(ranks):
        rep = rank["report"]
        if rep["overflow_total"] != 0:
            fail(f"rank {r}: silent-drop counters over all frames: {rep['aux_totals']}")
        iters = sum(rep["icp_iterations"])
        expect_launches(f"rank {r} of two", rep["launches"], iters, n, n)
        want_rows = {"fused_gn_iteration": {str(gn_rows): iters}, "apply_policy": {str(policy_rows): n}}
        if rep["kernel_rows"] != want_rows:
            fail(f"rank {r}: kernel rows {rep['kernel_rows']}, expected {want_rows}")
        print(f"two ranks sharing one card (gloo), rank {r}: {rep['ms_per_frame']:.3f} ms/frame after the first "
              f"frame -- two ranks sharing one card: not a scaling figure; ICP iterations {iters}, launches "
              f"{rep['launches']}, kernel rows {rep['kernel_rows']}", flush=True)
    print(f"two ranks on one card: trajectories equal bit for bit, final maps equal slot for slot; "
          f"{gap:.3e} m from phase 6's trajectory at most; ATE {ate:.5f} m; GN on {gn_rows} rows and the policy "
          f"on {policy_rows} rows per rank", flush=True)


def multi_rank_phase(scans, traj, gt, dev, profile_scans=None) -> None:
    """Phase 10: the kitti drive's scans through the parallel layer."""
    os.makedirs(MULTI_RANK_DIR, exist_ok=True)
    nccl_world_of_one(scans, traj, dev, profile_scans)
    two_ranks_one_card(scans, traj, gt, dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 3")
    ap.add_argument("--profile", action="store_true", help="also break a frame's time down")
    ap.add_argument("--root", default=None, help="only time the kernels of the port checked out here")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from sage_icp_tpu_torch.ops import cuda_lib

    if args.root:
        print(f"kernels of {os.path.dirname(cuda_lib.__file__)}", flush=True)
    build_s = cuda_lib.build_all()
    print(f"build: {build_s:.2f} s", flush=True)
    for src, log in cuda_lib.BUILD_LOG.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"nvcc {src}: " + " | ".join(used), flush=True)

    if args.root:
        times = time_tree(dev)
        print(smi, flush=True)
        print(json.dumps({"root": args.root, "card": smi, "times": times}), flush=True)
        return 0
    rows = check_kernels(dev)
    if args.kernels_only:
        print(smi)
        return 0
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP

    n = WARMUP + FRAMES
    extra = 5 if args.profile else 0
    city = SageICP("city")
    city_scans, _, _ = drive("city", city, 0.7, WARMUP, FRAMES, extra)
    nn_launches = single_pass(city, city_scans[n - 1])
    kitti = SageICP()  # the default preset
    if kitti.config != PRESETS["kitti"] or not kitti.config.dynamic_vehicle_filter:
        fail("SageICP() is not the kitti preset with its dynamic filter")
    kitti_scans, launches, kitti_gt = drive("kitti", kitti, 1.3, WARMUP, FRAMES, extra)
    kitti_traj = kitti.trajectory()
    sort_launches = kitti_checks(kitti, kitti_scans[n - 1])
    deskew_odom, skewed, tss, deskew_kernel_ms = runtime_phase(kitti_scans, dev)
    multi_rank_phase(kitti_scans[:n], kitti_traj, kitti_gt, dev, kitti_scans[n:] if args.profile else None)
    if args.profile:
        profile("city", city, city_scans[n:])
        profile("kitti", kitti, kitti_scans[n:])
        busy = profile("kitti deskew", deskew_odom, skewed[n:], tss[n:])
        print(f"deskew share of the deskew path's device busy time (kernel_ms / busy): {deskew_kernel_ms:.4f} / "
              f"{busy:.3f} ms = {deskew_kernel_ms / busy:.4f}", flush=True)
    # launches: the kitti path's, the NN kernel's single-pass search and
    # the sort kernel's check on the filter's keys
    launches.update(fused_semantic_nn=nn_launches, bitonic_sort_planes=sort_launches)
    table = [dict(name=name, launches=launches[name], **row) for name, row in rows.items()]
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
