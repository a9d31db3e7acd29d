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
     key) against the network, with its launches per call. Kernel, plain
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
     kernels listed apart.
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
DRIVE_ROWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "drive_rows.pt")
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


def drive(name: str, odom, density: float, warmup: int, frames: int, extra: int):
    """Phases 4 and 6: `odom` over the city world at `density` along
    make_trajectory, scans from render_scan at n_target 120000. Returns
    (scans, launches); `extra` more scans along the trajectory follow the
    path's."""
    from sage_icp_tpu_torch.ops import cuda_lib
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
    # every ICP iteration runs the GN kernel, every insert the policy
    # kernel, every filtered frame the radius count; the NN kernel has its
    # own path (phase 5) and the sort kernel its own check (phase 7)
    expect = dict(fused_gn_iteration=iters, apply_policy=n, fused_semantic_nn=0, bitonic_sort_planes=0,
                  radius_count=n if odom.config.dynamic_vehicle_filter else 0)
    for kernel, count in expect.items():
        if launches[kernel] != count:
            fail(f"{name} path: {kernel} launched {launches[kernel]} times, expected {count}")
    print(f"{name} path: {frames} timed frames in {elapsed:.4f} s = {frames / elapsed:.3f} scans/s, "
          f"{1e3 * elapsed / frames:.3f} ms/frame; ICP iterations {odom.icp_iters}; "
          f"ATE {ate:.5f} m; live voxels {int((odom.state.map.counts > 0).sum())}; "
          f"launches {launches}", flush=True)
    return scans, launches


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
    prep = pl.prepare_icp_inputs(state, buf, buf[:, 0] < 1.0e6, cfg)
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


def profile(name, odom, scans) -> None:
    """Optional phase 8 (--profile): where the time of a frame goes, on
    the frames that follow the path's. First the host phases of the next
    frame, timed with a synchronise after each (the state held fixed,
    repeated); then the device's busy share and its kernels by total time
    from torch.profiler while the frames are registered."""
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
    print(f"{name} profile host phases (ms/frame, state held fixed): "
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
    city_scans, _ = drive("city", city, 0.7, WARMUP, FRAMES, extra)
    nn_launches = single_pass(city, city_scans[n - 1])
    kitti = SageICP()  # the default preset
    if kitti.config != PRESETS["kitti"] or not kitti.config.dynamic_vehicle_filter:
        fail("SageICP() is not the kitti preset with its dynamic filter")
    kitti_scans, launches = drive("kitti", kitti, 1.3, WARMUP, FRAMES, extra)
    sort_launches = kitti_checks(kitti, kitti_scans[n - 1])
    if args.profile:
        profile("city", city, city_scans[n:])
        profile("kitti", kitti, kitti_scans[n:])
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
