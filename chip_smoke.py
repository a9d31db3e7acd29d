"""End-to-end check of sage_icp_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--kernels-only] [--profile]
    python3 chip_smoke.py --multi-rank [--profile]   (phase 10 alone; 10c wants 4 cards)
    python3 chip_smoke.py --root DIR
    python3 chip_smoke.py --stage-clock   (phase 6, then phase 16 alone)
    python3 bench_torch.py        (the bench alone; phase 13 runs it in process)

With --root, only the kernel times of the port checked out at DIR (the
parent commit unpacked with `git archive`, say) are taken, at phase 3's
shapes on phase 3's inputs and, when build/drive_rows.pt exists (phase 7
writes it), on the kitti drive's own policy and radius-count rows, its
last frame's dynamic filter and its row build at the guess (corr_setup),
and printed as one JSON line; nothing is checked. Run it on both trees in one
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
     key) against the network, with its launches per call; the GN,
     policy and radius-count kernels on the two row halves of the kitti
     shapes that phase 10's ranks take, against the call on all rows; the
     min-diffusion bit for bit at its cap of 16,384 cells. Kernel, plain
     and library times are device times (time_ms: calls queued back to
     back behind a spacer kernel, CUDA events, the median of 5 batches of
     20);
  4. the city path: SageICP("city") over the Manhattan city world at
     density 0.7, 10 warm-up and 30 timed frames; no silent drop over all
     frames, ATE < 0.05 m, and launch counts showing that every slot of
     every block of ICP iterations ran the GN and ICP step kernels (a
     block is ops/registration.py's BLOCK_ITERATIONS slots; at least one
     a frame, enough for its iterations), every insert the policy
     kernel, and every row build (a frame's and each re-anchor's, counted
     from the recorder's spans) the candidate planes' kernel. The kernels count their own launches on the card
     (ops/cuda_lib.py), so a launch replayed from a CUDA graph is counted
     in the run that replays it. SageICP on the card is the captured step (CUDA graphs,
     models/pipeline.py::DeviceStep), so are phases 6-13 unless named;
  5. the single-pass search (get_correspondences_fast) on the final city
     map, through the semantic NN kernel, against the reference-shaped
     search;
  6. the kitti path: SageICP(), the production kitti preset with its
     dynamic-vehicle filter, over the city world at density 1.3, 10
     warm-up and 30 timed frames, with the same gates, the radius count
     and the min-diffusion launched once per frame; the recorder's two
     filter counts over its frames (occupied vehicle cells, diffusion
     rounds);
  7. on the kitti drive's last frame: vehicle points in, kept and
     removed; the filter on the card against the filter on the CPU; the
     bitonic sort of the filter's sort keys against torch.sort; the
     drive's own rows of the policy kernel (one map insert of the frame)
     and of the radius count (the filter of the frame), captured from
     their wrappers, each kernel against its plain version bit for bit,
     the rows' shape and the kernel's time, saved to build/drive_rows.pt
     with the frame's filter input; the min-diffusion on the frame's
     vehicle sort keys and at the cap, bit for bit, kernel and plain
     times (its row of the kernel table); the candidate planes of the
     frame's row build at its guess (corr_setup's call, captured), the
     kernel against its plain version bit for bit with the same found
     pairs, in one launch, kernel and plain times beside the bound (its
     row of the kernel table), corr_setup's arguments saved to
     build/drive_rows.pt;
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
 10. multi-rank (parallel/; run after phase 15, whose trajectory 10c
     compares with): (a) NCCL at world size 1 in process,
     init_distributed through a file:// rendezvous under build/, then
     ShardedSageICP() (the kitti preset; captured, its collectives in the
     graphs) and ShardedSageICP(graph=False), alternated (captured, eager,
     eager, captured), on phase 6's 40 scans with phase 6's calls: each
     trajectory equal to phase 6's bit for bit, the two equal in
     iterations, totals and final maps, no drop, GN launched in every
     slot of every ICP block, the policy and the radius count once a
     frame; the host's launch calls and waits a frame of each (fewer than
     10 launch calls captured) and the ms/frame of each run; (b) two
     parallel.worker processes sharing the card over gloo (NCCL refuses
     two ranks on one device; eager), each at the full kitti preset on
     the same 40 scans: the two trajectories equal bit for bit and the
     final maps slot for slot, each within 5e-3 m of phase 6's trajectory
     (test_sharded_maneuver_equivalence's bound), ATE < 0.05 m, no drop,
     and per rank its share of the per-point work: GN in every slot of
     every ICP block on 9,216 of the 18,432 rows, the policy once a frame
     on 16,512 of the 33,024 rows, the radius count once a frame on 2,048
     of the 4,096 query rows. Each rank's ms/frame is printed: two ranks
     share one card, so it is not a scaling figure. (c) With two cards or
     more, captured NCCL worker ranks on cuda:0, cuda:1, ...: one card,
     two and (with four) four on the fast kitti path, and one card and
     two on the reference path (use_fast_correspondences=False), each
     with (b)'s checks against the single card (a world of one equal to
     phase 6's or phase 15's trajectory bit for bit), the rows per rank
     R / n, U / n, VR / n (GN none on the reference path), then each
     rank's ms/frame beside one card's on both paths, and the scan head
     timed on two ranks (head_timing: whole against split and gathered,
     deskew off and on, bit for bit); with --profile, rank 0's device ms
     by kernel over the last 5 frames at one card and two, the diffusion
     and the gathers summed. With one card it prints that 10c did not
     run and why. Every rank process is killed after TWO_RANKS_TIMEOUT_S:
     ranks out of step wait on each other rather than fail. 10a also
     prints the host time of one GN-sum exchange and of one insert
     gather over NCCL.
 11. the dense voxel-grid index: PRESETS["kitti"] and PRESETS["city"] with
     dense_grid on and off, three runs of each, alternated, on phase 6's
     (and phase 4's) scans with that phase's calls: every trajectory
     equal to the phase's bit for bit, the grid runs' final maps equal to
     the phase's slot for slot and their grids consistent with their maps
     (every live slot's cell holds the slot and its checksum, no two live
     slots share a cell, no cell points at a dead slot), no drop, ATE
     < 0.05 m, the kernels launched as on the phase; ms/frame of each run;
     with --profile, each setting's breakdown and the device time the
     grid adds or removes by the profiler's names;
 12. the long horizon: scripts/long_run.py's 150-frame city drive (its
     world, trajectory, seeds, configuration and chunks of 30, this
     script's own copy) with dense_grid off and on: each inside
     test_long_horizon_city_drive's bounds (relative translation < 0.12 %,
     rotation < 0.06 deg/m, ATE < 0.12 m, final error < 0.4 m, no drop),
     the two equal bit for bit, maps slot for slot, the grid consistent;
 13. the bench: bench_torch.main() in process at its defaults (both
     phases, int16 upload), its scans those of phases 4 and 6 followed by
     the rest of bench.py's renders: every key of bench.py's JSON line,
     every guard passed (no drop over all frames, no landmark cell
     dropped), ATE < 0.05 m in both phases, GN and the ICP step launched
     in every slot of every block, the policy once a frame and the radius
     count once a kitti frame; then the same with SageICP's eager device
     step (graph=False), whose trajectories equal the first run's bit for
     bit. Prints the launches and scans/s;
 14. the captured step: on phase 4's, phase 6's, phase 9's (skewed, deskew
     on) and phase 6's scans with dense_grid, SageICP with the graph step
     and with the eager one over 24 frames by register_frame and 16 by
     register_chunk (W = 8): poses, per-frame iterations, every aux read,
     the totals and the final maps (grid included) bit for bit, the graph
     run equal to the phase's own; the ICP step kernel bit for bit
     against its plain version on 64 steps recorded from an eager kitti
     drive, its time a step and a no-op step, and a stopped GN launch's;
     the eager step under torch.cuda.set_sync_debug_mode("error") (kitti,
     kitti + deskew, city; the one status read a block is a non-blocking
     copy and an event, not a synchronising operation); per frame, graph
     on and off, the host's launch and wait calls and the device busy
     share (torch.profiler), the peak device memory of a fresh SageICP,
     and ms/frame in six alternated runs each, at kitti and city;
 15. the reference-shaped ICP loop (registration.RefLoop): PRESETS["kitti"]
     with use_fast_correspondences=False on phase 6's 40 scans, as phase
     14.1 (graph = eager bit for bit: poses, iterations, aux, totals,
     final maps; the reference step kernel in whole blocks, GN and the
     frozen-rows step not at all), ATE < 0.05 m and no drop; the device
     ms of one iteration (torch.profiler's kernel time of a block); the
     reference step kernel bit for bit against its plain version on 64
     steps recorded from an eager drive, and its time a step, a no-op
     step and the plain version's; the eager step under
     set_sync_debug_mode("error"); ms/frame of the captured drive at 1,
     2, 4 and 8 iterations a block (alternated), the host's launch calls,
     waits and the idle share at each, and the eager step's at the
     package's block length.
 16. the recorder's device stage clock (runtime/tracing.py, csrc/
     stage_clock.cu), on captured drives of phase 6's first 16 scans:
     the kitti preset at the package's block length, and kitti_gt (the
     filter off) at blocks of 2 iterations, so that frames run more
     pieces than a row keeps. After every piece the frame's row is read
     back; each stamp's time is taken from it, and the frame's stamps
     replayed through tracing.stamp_row with those times (and the
     min-diffusion's two counts from the row after prepare, and the
     loop's found pairs after each row build in its close stamp) must
     give every row read, and the recorder's record, exactly. The live
     rows equal the loop's count (icp_kernel.I_LIVE_ROWS), the card's frame counter
     the frames begun, and the stamps launched those the pieces make; a
     step that raises (a wrong-shaped input) leaves no frame, and the
     frames after it keep their own rows.
The line before the device line is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
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
                "icp_step_kernel", "bitonic_tile_kernel", "bitonic_global_kernel", "stage_clock_kernel",
                "min_diffusion_kernel")
ROOT = os.path.dirname(os.path.abspath(__file__))
DRIVE_ROWS = os.path.join(ROOT, "build", "drive_rows.pt")
MULTI_RANK_DIR = os.path.join(ROOT, "build", "multi_rank")
TWO_RANKS_TIMEOUT_S = 240
CLI_OUT = os.path.join(ROOT, "build", "cli_smoke")
CLI_FRAMES = 40
WARMUP, FRAMES = 10, 30  # each path: warm-up and timed frames
GRID_REPEATS = 3  # phase 11: runs with the grid on and with it off, alternated
LONG_FRAMES, LONG_CHUNK = 150, 30  # phase 12: scripts/long_run.py's drive


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


SPACER_CYCLES = 20_000_000  # ~10 ms of torch.cuda._sleep: the host queues a batch meanwhile


def max_abs_diff(got, want) -> float:
    """The largest |a - b| over pairs of tensors, in float64: 0.0 when
    every pair is equal (equal infinities and NaN against NaN count as
    equal)."""
    err = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


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
    # the increment on the card, as the ICP loop's state holds it
    T = geo.se3_exp(torch.tensor([0.02, -0.01, 0.005, 0.001, -0.002, 0.003])).to(dev)
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
    if cuda_lib.launches()["fused_gn_iteration"] != 2 or not torch.equal(got, again):
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
        replaces="sage_icp_tpu/ops/pallas_insert.py:223", max_abs_err=max_abs_diff(got, want),
        ms=time_ms(lambda: policy_kernel.apply_policy(*pargs, basic=20)),
        plain_ms=time_ms(lambda: policy_kernel.apply_policy_plain(*pargs, basic=20)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_shards(dev) -> None:
    """Phase 3, the three row-sharded kernels at kitti shapes split in two
    as phase 10's ranks run them (seeded rows of their own): GN on each
    half's rows (views, the tile map recomputed per half), the two sums
    added in rank order, against the call on all rows within GN_SUM_RTOL
    of the terms' magnitudes, the used count equal; the policy and the
    radius count (at the filter's shapes) on each half, concatenated,
    against the call on all rows bit for bit. Prints each half's kernel
    time (time_ms)."""
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

    rargs = radius_inputs(rng, dev)
    VR = rargs[0].shape[0]
    r2 = KITTI_FILTER["r2"]
    want = nn_kernels.radius_count(*rargs, r2)
    rshards = [[a[lo:hi].contiguous() for a in rargs] for lo, hi in ((0, VR // 2), (VR // 2, VR))]
    if not torch.equal(torch.cat([nn_kernels.radius_count(*a, r2) for a in rshards]), want):
        fail("radius_count on two row halves differs from the call on all rows")
    rc_ms = [time_ms(lambda a=a: nn_kernels.radius_count(*a, r2)) for a in rshards]
    print(f"row halves at kitti shapes (phase 10's two ranks): fused_gn_iteration on {R // 2} + {R - R // 2} rows "
          f"{gn_ms[0]:.4f} + {gn_ms[1]:.4f} ms, their sums in rank order against all rows max |diff| "
          f"{float(diff.max())} (within tolerance); apply_policy on {U // 2} + {U - U // 2} rows {pol_ms[0]:.4f} + "
          f"{pol_ms[1]:.4f} ms, equal to all rows bit for bit; radius_count on {VR // 2} + {VR - VR // 2} rows "
          f"{rc_ms[0]:.4f} + {rc_ms[1]:.4f} ms, equal to all rows bit for bit", flush=True)


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
        replaces="sage_icp_tpu/ops/pallas_nn.py:426", max_abs_err=max_abs_diff((got,), (want,)),
        ms=time_ms(lambda: nn_kernels.radius_count(*rargs)),
        plain_ms=time_ms(lambda: nn_kernels.radius_count_plain(*rargs)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    flags = (True, True, False)
    sort_err = 0.0
    for n in SORT_NS:
        planes = sort_inputs(rng, n, dev)
        got = sort_kernel.bitonic_sort_planes(planes, 3, flags)
        want = sort_kernel.bitonic_sort_planes_plain(planes, 3, flags)
        net = sort_kernel.bitonic_network_plain(planes, 3, flags)
        lib = sort_library(planes)
        torch.cuda.synchronize()
        sort_err = max(sort_err, max_abs_diff(got, want))
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
        replaces="sage_icp_tpu/ops/pallas_sort.py:133", max_abs_err=sort_err,
        ms=time_ms(lambda: sort_kernel.bitonic_sort_planes(planes, 3, flags)),
        plain_ms=time_ms(lambda: sort_kernel.bitonic_sort_planes_plain(planes, 3, flags)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: sort_library(planes)))
    for name, r in rows.items():
        print_row(name, r)
    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn

    nx = dyn._grid_nx(PRESETS["kitti"].label_max_range)
    check_diffusion(cap_keys(nx, dev), nx)
    print("kernel min_diffusion at the cap (16,384 cells): bit-exact against its plain version (timed in phase 7)",
          flush=True)
    return rows


def time_tree(dev) -> dict:
    """--root: the kernels of the port at --root on phase 3's inputs (the
    same seeds and shapes), each timed with time_ms and kernel_ms. Only
    the wrapper interfaces that every slice of the port shares are called;
    nothing is checked. T goes to the GN wrapper on the card (a tree whose
    wrapper reads T on the host copies it over there)."""
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
        if "filter" in rows:
            from sage_icp_tpu_torch.models.pipeline import PRESETS
            from sage_icp_tpu_torch.ops import dynamic_filter as dyn

            fpts, fok = to(rows["filter"])
            record("filter_dynamic_vehicles kitti drive frame",
                   lambda: dyn.filter_dynamic_vehicles(fpts, fok, PRESETS["kitti"]))
        if "corr_setup" in rows:
            from sage_icp_tpu_torch.ops import correspondence_fast as cf
            from sage_icp_tpu_torch.ops import hashmap as hm

            c = rows["corr_setup"]
            state, tables = hm.MapState(*to(c["map"])), cf.ProbeTables(*to(c["tables"]))
            query, valid = to([c["query"], c["valid"]])
            record("corr_setup kitti drive rows", lambda: cf.corr_setup(
                state, tables, query, valid, c["voxel_size"], c["probe_depth"], **c["fast"]))
    return times


def ate_of(est, gt) -> float:
    """Translation RMSE of est against gt, both rebased to their first pose."""
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(est, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


_REANCHORS_AT_RESET = [0]


def reanchor_spans() -> int:
    """The step's reanchor pieces the recorder holds (`launch.reanchor`
    spans, runtime/tracing.py): each rebuilds the rows once."""
    from sage_icp_tpu_torch.runtime import tracing

    return sum(s.name == "launch.reanchor" for s in tracing.RECORDER.read().spans)


def reset_counts() -> None:
    """Every kernel's launch count to 0. The counts live on the card and
    each kernel adds its own launches (ops/cuda_lib.py), those replayed
    from a captured graph too. The step's reanchors are counted from here
    too."""
    from sage_icp_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    _REANCHORS_AT_RESET[0] = reanchor_spans()


def counts() -> dict:
    """The kernel launches on the card since reset_counts, and the step's
    reanchors since then ("reanchors")."""
    from sage_icp_tpu_torch.ops import cuda_lib

    return {**cuda_lib.launches(), "reanchors": reanchor_spans() - _REANCHORS_AT_RESET[0]}


def expect_launches(name, launches, iterations, frames, prepares, reference: bool = False,
                    solves: int | None = None) -> None:
    """The ICP step kernel in whole blocks of BLOCK_ITERATIONS (at least
    one block a frame, enough slots for the `iterations` the frames
    took), GN once per ICP step, the policy once a frame (the insert),
    the radius count and the min-diffusion once per prepare (the filter:
    once a frame, and once more in each of IcpTimer's replays), the NN
    and sort kernels not at all. The candidate planes (corr_planes) once
    per row build: a build at each solve's guess (`solves`: the frames'
    and IcpTimer's replays'; the frames by default) and one at each
    re-anchor, exactly that when `launches` holds the step's reanchors
    (counts()), else between the solves and the blocks (a worker rank's
    launches, or a timer's, whose re-anchors are in no span). With
    `reference` (fast correspondences off) the reference step kernel in
    whole blocks of REF_BLOCK_ITERATIONS takes the ICP step's place, and
    neither GN, the ICP step nor the candidate planes runs. Every count
    is the kernels' own, read from the card."""
    from sage_icp_tpu_torch.ops import registration as reg

    step, block = ("icp_ref_step", reg.REF_BLOCK_ITERATIONS) if reference else ("icp_step", reg.BLOCK_ITERATIONS)
    slots = launches[step]
    blocks, rest = divmod(slots, block)
    if rest or blocks < frames or iterations > slots:
        fail(f"{name}: {slots} {step} launches ({blocks} blocks of {block} and {rest}) for {frames} frames and "
             f"{iterations} iterations")
    frozen = 0 if reference else slots
    expect = dict(fused_gn_iteration=frozen, icp_step=frozen, icp_ref_step=slots if reference else 0,
                  apply_policy=frames, radius_count=prepares, min_diffusion=prepares, fused_semantic_nn=0,
                  bitonic_sort_planes=0)
    builds = 0 if reference else (frames if solves is None else solves)
    if "reanchors" in launches:
        expect["corr_planes"] = builds + (0 if reference else launches["reanchors"])
    elif not builds <= launches["corr_planes"] <= (0 if reference else blocks):
        fail(f"{name}: corr_planes launched {launches['corr_planes']} times for {builds} solves in {blocks} blocks")
    for kernel, count in expect.items():
        if launches[kernel] != count:
            fail(f"{name}: {kernel} launched {launches[kernel]} times, expected {count}")


def register(odom, scans, warmup: int, n: int):
    """The drives' calls: register_frame on scans[:warmup], then timed on
    scans[warmup:n]. Returns (seconds of the timed frames, the launches
    counted from the first frame on)."""
    reset_counts()
    for i in range(warmup):
        odom.register_frame(scans[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, n):
        odom.register_frame(scans[i])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, counts()


def drive(name: str, odom, density: float, warmup: int, frames: int, extra: int):
    """Phases 4 and 6: `odom` over the city world at `density` along
    make_trajectory, scans from render_scan at n_target 120000 (bench.py's
    first scans). Returns (scans, launches, gt, the render generator for
    the scans that follow); `extra` more scans along the trajectory follow
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
    return scans, launches, gt[:n], rng


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
    launches = cuda_lib.launches()["fused_semantic_nn"]
    tgt_ref, acc_ref, _ = hm.get_correspondences(odom.state.map, query, valid, cfg.voxel_size_map, 1.5,
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


def planes_row(cargs) -> dict:
    """Phase 7's candidate planes on the kitti drive's rows (cargs:
    candidate_planes' arguments at the frame's guess, as corr_setup passes
    them): the kernel against its plain version bit for bit with the same
    found pairs, in one launch; the kernel's time, and the plain version's
    on the card, which is the PyTorch chain the kernel replaced (probe,
    window and block gathers, permute copy, label mask). Bound: the four
    planes written, the live rows' window rows and the found pairs'
    blocks read once each (the pairs from the kernel's counter), over
    3.35 TB/s. Returns its row of the kernel table."""
    from sage_icp_tpu_torch.ops import correspondence_fast as cf
    from sage_icp_tpu_torch.ops import cuda_lib

    tables, rel, live, K, depth, grid_hits = cargs[:6]
    dev = rel.device
    pairs, plain_pairs = (torch.zeros((), dtype=torch.int32, device=dev) for _ in range(2))
    cuda_lib.reset_launches()
    got = cf.candidate_planes(tables, rel, live, K, depth, grid_hits, pairs)
    torch.cuda.synchronize()
    launches = cuda_lib.launches()["corr_planes"]
    want = cf.candidate_planes_plain(tables, rel, live, K, depth, grid_hits, plain_pairs)
    if launches != 1 or not all(torch.equal(a, b) for a, b in zip(got, want)) or int(pairs) != int(plain_pairs):
        fail(f"corr_planes on the kitti drive's rows: {launches} launches, not bit-exact against its plain version "
             f"or found pairs {int(pairs)} against {int(plain_pairs)}")
    R, M = got[0].shape
    n_live, found = int(live.sum()), int(pairs)
    b_ms, b_by = bound(4 * R * M * 2 + n_live * 27 * depth * 4 + found * 4 * K * 2 + R * 13, 0)
    row = dict(route="cuda", source="sage_icp_tpu_torch/csrc/corr_planes.cu",
               replaces="none (corr_setup's gathers, sage_icp_tpu/ops/correspondence_fast.py:280-316)",
               max_abs_err=max_abs_diff(got, want),
               ms=time_ms(lambda: cf.candidate_planes(tables, rel, live, K, depth, grid_hits)),
               plain_ms=time_ms(lambda: cf.candidate_planes_plain(tables, rel, live, K, depth, grid_hits)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None, rows=R, live_rows=n_live, found_pairs=found,
               store_bytes=cf.plane_store_bytes(K))
    print(f"corr_planes on the kitti drive's rows: bit-exact, found pairs equal; R {R}, M {M}, live rows {n_live}, "
          f"found pairs {found} of {27 * n_live}, {row['store_bytes']}-byte stores; kernel {row['ms']:.4f} ms, plain "
          f"(the PyTorch chain) {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return row


def drive_rows(odom, buf, rargs, filter_args) -> dict:
    """Phase 7's drive rows: the policy kernel's arguments from one map
    insert of the scan in `buf` (as profile runs it, the state held
    fixed), the radius count's `rargs` from the frame's filter and the
    candidate planes' and corr_setup's from the frame's row build at its
    guess. Each kernel against its plain version bit for bit, the rows'
    shape, the kernel's time; the arguments go to DRIVE_ROWS for --root,
    with the frame's filter input (filter_args: points and valid mask).
    Returns the candidate planes' row of the kernel table (planes_row)."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import correspondence_fast as cf
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.ops import hashmap as hm
    from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel

    cfg, dev, state = odom.config, odom.device, odom.state
    prep = pl.prepare_icp_inputs(state, buf, buf[:, 0] < 1.0e6, torch.zeros(len(buf), device=dev), cfg)
    (icp, (cargs, _)), (sargs, skw) = capture(cf, "corr_setup", lambda: capture(
        cf, "candidate_planes", lambda: pl.run_icp(state.map, prep, cfg)))
    planes = planes_row(cargs)
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
    setup = dict(map=cpu(sargs[0][:4]), tables=cpu(sargs[1]), query=sargs[2].cpu(), valid=sargs[3].cpu(),
                 voxel_size=float(sargs[4]), probe_depth=int(sargs[5]),
                 fast={k: skw[k] for k in ("unique_voxel_rows", "queries_per_voxel", "overflow_rows")})
    torch.save({"apply_policy": cpu(pargs), "basic": basic, "radius_count": cpu(rargs),
                "filter": cpu(filter_args), "corr_setup": setup}, DRIVE_ROWS)
    return planes


def kitti_checks(odom, scan):
    """Phase 7, after the kitti path, on its last frame preprocessed as the
    step does: the filter's vehicle points in, kept and removed, and its
    time; the filter on the card against the filter on the CPU (keep mask,
    points and overflow bit for bit); the sort kernel on the filter's
    vehicle sort keys (cell id, or 2^30 for other points, then the
    position as an iota key, padded to 2^18 with sentinel keys) against
    torch.sort(stable=True); the drive's own kernel rows (drive_rows) and
    the min-diffusion's (diffusion_row, on the frame's vehicle sort keys).
    Returns the sort kernel's launches there, and the min-diffusion's and
    the candidate planes' rows of the kernel table."""
    from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn
    from sage_icp_tpu_torch.ops import scan as scan_ops
    from sage_icp_tpu_torch.ops import sort_kernel

    cfg, dev = odom.config, odom.device
    buf = torch.full((cfg.scan_capacity, 4), scan_ops.INVALID_COORD)
    buf[: len(scan)] = torch.from_numpy(scan)
    buf = buf.to(dev)
    pts, ok = scan_ops.preprocess(buf, buf[:, 0] < 1.0e6, cfg.max_range, cfg.min_range, cfg.label_max_range)

    (card, (rargs, _)), ((vk, nx, _), _) = capture(dyn, "cluster_ids", lambda: capture(
        nn_kernels, "radius_count", lambda: dyn.filter_dynamic_vehicles(pts, ok, cfg)))
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
    launches = cuda_lib.launches()["bitonic_sort_planes"]
    ref = torch.sort(key, stable=True)
    if launches != 1 or not torch.equal(s_pos.long(), ref.indices) or not torch.equal(s_key, ref.values):
        fail("bitonic_sort_planes on the filter's sort keys differs from torch.sort(stable=True)")
    print(f"bitonic sort of the last frame's vehicle keys ({int((key < 2**30).sum())} members of {n}): "
          f"permutation equals torch.sort(stable=True); kernel "
          f"{time_ms(lambda: sort_kernel.bitonic_sort_planes((key, pos), 2)):.4f} ms in "
          f"{sort_kernel.bitonic_launches(n, 2)} launches, torch.sort "
          f"{time_ms(lambda: torch.sort(key, stable=True)):.4f} ms", flush=True)
    planes = drive_rows(odom, buf, rargs, (pts, ok))
    return launches, diffusion_row(vk, nx), planes


def filter_counts(odom) -> None:
    """Phase 6's two filter counts from the recorder, over the drive's
    frames: the occupied vehicle cells and the min-diffusion's rounds that
    changed an id (24: the round cut may bind)."""
    from sage_icp_tpu_torch.runtime import tracing as tr

    frames = tr.RECORDER.read().frames_of([odom.drive])
    cells = np.array([f.vehicle_cells for f in frames])
    rounds = np.array([f.diffusion_rounds for f in frames])
    if len(frames) == 0 or cells.max() <= 0:
        fail(f"phase 6: the recorder counted no occupied vehicle cell over {len(frames)} frames")
    print(f"phase 6 filter counts over {len(frames)} frames: occupied vehicle cells min {cells.min()} median "
          f"{int(np.median(cells))} max {cells.max()}; diffusion rounds min {rounds.min()} median "
          f"{int(np.median(rounds))} max {rounds.max()}, {int((rounds == 24).sum())} frames at 24", flush=True)


def cap_keys(nx: int, dev):
    """The vehicle sort keys of 16,384 distinct cells, the filter's cap: a
    solid 32 x 32 x 16 block, one blob wider than the 24 rounds reach."""
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn

    x, y, z = np.meshgrid(np.arange(88, 120), np.arange(88, 120), np.arange(8, 24), indexing="ij")
    return torch.from_numpy(np.sort(((x * nx + y) * dyn._GRID_NZ + z).ravel()).astype(np.int32)).to(dev)


def check_diffusion(vk, nx: int) -> float:
    """The min-diffusion kernel against its plain version on the card, bit
    for bit; returns the largest |difference| (0)."""
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn

    got, want = dyn.cluster_ids(vk, nx), dyn.cluster_ids_plain(vk, nx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"min_diffusion is not bit-exact against its plain version on {int((vk != dyn._BIG).sum())} rows")
    return max_abs_diff((got,), (want,))


def diffusion_row(vk, nx: int) -> dict:
    """The min-diffusion's row of the kernel table: bit for bit against the
    plain version and timed on the kitti drive's last frame (vk, its
    vehicle sort keys) and at the cap (cap_keys). Bound: the keys read and
    the ids written once (the cells' data, a few hundred KB), over
    3.35 TB/s; the launch and the rounds' barriers are the floor."""
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn

    err, cells = check_diffusion(vk, nx), int(torch.unique(vk[vk != dyn._BIG]).numel())
    cap = cap_keys(nx, vk.device)
    err = max(err, check_diffusion(cap, nx))
    b_ms, b_by = bound(vk.numel() * (4 + 8), 0)
    row = dict(route="cuda", source="sage_icp_tpu_torch/csrc/min_diffusion.cu",
               replaces="none (the pooling of sage_icp_tpu/ops/dynamic_filter.py:211-219)", max_abs_err=err,
               ms=time_ms(lambda: dyn.cluster_ids(vk, nx)), plain_ms=time_ms(lambda: dyn.cluster_ids_plain(vk, nx)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None, cells=cells,
               cap_ms=time_ms(lambda: dyn.cluster_ids(cap, nx)),
               cap_plain_ms=time_ms(lambda: dyn.cluster_ids_plain(cap, nx)))
    print(f"min_diffusion on the kitti drive's last frame ({cells} occupied cells) and at the cap (16,384): "
          f"bit-exact; kernel {row['ms']:.4f} / {row['cap_ms']:.4f} ms, plain {row['plain_ms']:.4f} / "
          f"{row['cap_plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return row


def profile(name, odom, scans, tss=None) -> tuple[float, dict]:
    """Optional phase 8 (--profile): where the time of a frame goes, on
    the frames that follow the path's (with their per-point timestamps
    `tss` on the deskew path). First the host phases of the next frame,
    timed with a synchronise after each (the state held fixed, repeated);
    then the device's busy share and its kernels by total time from
    torch.profiler while the frames are registered. Returns the device
    busy ms a frame and {profiler name: (ms a frame, calls a frame)}."""
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
        iters += int(icp.iterations)
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
    avg = prof.key_averages()
    events = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    host = lambda names: sum(e.count for e in avg if e.key in names) / n
    print(f"{name} profile: {n} frames, wall {1e3 * wall / n:.3f} ms/frame, device busy "
          f"{busy_us / 1e3 / n:.3f} ms/frame, idle share {1 - busy_us / 1e6 / wall:.4f}, "
          f"{launches / n:.1f} device ops/frame, {host(HOST_LAUNCH):.1f} host launch calls and "
          f"{host(HOST_WAIT):.1f} host waits a frame", flush=True)
    line = lambda e: f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/frame {e.count / n:7.1f}x  {e.key[:90]}"
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(line(e), flush=True)
    print(f"{name} profile, the port's kernels:", flush=True)
    for e in events:
        if any(k in e.key for k in PORT_KERNELS):
            print(line(e), flush=True)
    return busy_us / 1e3 / n, {e.key: (e.self_device_time_total / 1e3 / n, e.count / n) for e in events}


def run_cli(mode: str, extra: list) -> dict:
    """Phase 9.1-9.2: the CLI in process, kitti preset with deskew, over
    CLI_FRAMES synthetic frames into build/cli_smoke/<mode>; the gates on
    its outputs, drops and launches. Returns the mode's numbers and path."""
    from sage_icp_tpu_torch.runtime import cli

    out = os.path.join(CLI_OUT, mode)
    argv = ["--synthetic", "--preset", "kitti", "--deskew", "--frames", str(CLI_FRAMES), "--chunk", "8",
            "--out", out, *extra]
    reset_counts()
    t0 = time.perf_counter()
    res = cli.main(argv)["synthetic"]
    wall = time.perf_counter() - t0
    launches = counts()
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
    if replays:
        del launches["reanchors"]  # the timer's solves re-anchor in no span
    expect_launches(f"CLI {mode}", launches, sum(res.iterations) + sum(res.replay_iterations), CLI_FRAMES,
                    CLI_FRAMES + replays, solves=CLI_FRAMES + len(res.replay_iterations))
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
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP

    odom = SageICP(dataclasses.replace(PRESETS["kitti"], deskew=deskew))
    reset_counts()
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
    expect_launches(name, counts(), sum(odom.icp_iters), len(scans), len(scans))
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
    sums' (the (1, 18) gather and the add on the device, against a fetch
    of the (18,) sums to the host) and the insert's (the gather of
    `policy_rows` packed rows of 8 K + 4 bytes)."""
    sums = torch.zeros(18, device=dev)
    packed = torch.zeros((policy_rows, 8 * kmax + 4), dtype=torch.uint8, device=dev)
    return dict(gn_exchange=host_ms(lambda: mesh.all_gather(sums[None])[0] + 0.0),
                gn_fetch=host_ms(lambda: sums.cpu()), insert_gather=host_ms(lambda: mesh.all_gather(packed)))


def nccl_world_of_one(scans, traj, dev, profile_scans=None) -> None:
    """Phase 10a: NCCL at world size 1, in process; ShardedSageICP() on
    the kitti drive's scans with phase 6's calls, captured (its default
    over NCCL) and eager (graph=False), alternated: each equal to phase 6
    bit for bit, the two equal in iterations, totals and final maps; the
    host's launch calls and waits a frame of each. With profile_scans
    (--profile), phase 8's breakdown of the captured path on them."""
    import torch.distributed as dist

    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.parallel.distributed import init_distributed
    from sage_icp_tpu_torch.parallel.sharding import ShardedSageICP

    rendezvous = os.path.join(MULTI_RANK_DIR, "rendezvous_nccl")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    mesh = init_distributed(f"file://{rendezvous}", 1, 0, backend="nccl", device=dev)
    runs = {True: [], False: []}
    made = []  # released before the group is destroyed: NCCL waits for the graphs holding its kernels
    try:
        if dist.get_backend() != "nccl" or mesh.backend != "nccl":
            fail(f"phase 10a: the process group's backend is {dist.get_backend()}, not nccl")
        for graph in (True, False, False, True):
            # ShardedSageICP(): the kitti preset on make_mesh(), the group just joined
            odom = ShardedSageICP() if graph else ShardedSageICP(graph=False)
            made.append(odom)
            if odom.mesh.group is None or odom.mesh.size != 1 or odom.config != PRESETS["kitti"]:
                fail(f"ShardedSageICP() at world size 1: mesh {odom.mesh}, config padded away from the kitti preset")
            if odom.graph != graph:
                fail(f"ShardedSageICP(graph={graph if not graph else None}) over NCCL runs graph={odom.graph}")
            elapsed, launches = register(odom, scans, WARMUP, len(scans))
            runs[graph].append(dict(odom=odom, ms=1e3 * elapsed / (len(scans) - WARMUP), launches=launches))
        cfg = PRESETS["kitti"]
        coll = collective_ms(mesh, dev, min(cfg.insert_unique_capacity, cfg.frame_capacity), cfg.points_per_voxel)
        host = {}
        for graph in (True, False):
            odom = ShardedSageICP(graph=graph)
            made.append(odom)
            for scan in scans[:WARMUP]:
                odom.register_frame(scan)
            host[graph] = host_profile(f"NCCL world of one, graph={graph}", odom, scans[WARMUP:WARMUP + 5])
            if graph and profile_scans:  # a step of its own, driven on to the drive's end: the checked runs
                for scan in scans[WARMUP + 5:]:  # keep their frames
                    odom.register_frame(scan)
                profile("kitti NCCL world of one (captured)", odom, profile_scans)
    finally:
        for odom in made:
            odom.release()
        dist.destroy_process_group()
    for graph, rs in runs.items():
        for r in rs:
            odom = r["odom"]
            got = odom.trajectory()
            if not np.array_equal(got, traj):
                fail(f"NCCL world of one, graph={graph}: differs from phase 6's trajectory: max |diff| "
                     f"{np.abs(got - traj).max()}")
            if int(odom.aux_totals().overflow_total()) != 0:
                fail(f"NCCL world of one, graph={graph}: silent-drop counters over all frames: {odom.aux_totals()}")
            expect_launches(f"NCCL world of one, graph={graph}", r["launches"], sum(odom.icp_iters), len(scans),
                            len(scans))
    on, off = runs[True][0]["odom"], runs[False][0]["odom"]
    if on.icp_iters != off.icp_iters or not aux_equal(on.aux_totals(), off.aux_totals()):
        fail("NCCL world of one: the captured and eager runs' iterations or totals differ")
    if map_differs(on.state.map, off.state.map):
        fail("NCCL world of one: the captured and eager runs' final maps differ")
    if not host[True]["launches"] < 10:
        fail(f"NCCL world of one, captured: {host[True]['launches']} host launch calls a frame (bound 10)")
    frames = len(scans) - WARMUP
    ms = {g: [round(r["ms"], 3) for r in rs] for g, rs in runs.items()}
    print(f"NCCL world of one (ShardedSageICP(), kitti preset): captured and eager each equal to phase 6's "
          f"trajectory bit for bit, to each other in iterations ({sum(on.icp_iters)}), totals and final maps; "
          f"ms/frame over {frames} timed frames, captured {ms[True]}, eager {ms[False]} (alternated: captured, "
          f"eager, eager, captured); host launch calls a frame captured {host[True]['launches']:.1f}, eager "
          f"{host[False]['launches']:.1f}; launches captured {runs[True][0]['launches']}", flush=True)
    print(f"NCCL world of one, host ms a call: GN sums gathered and added on the card {coll['gn_exchange']:.4f} "
          f"(a fetch to the host alone {coll['gn_fetch']:.4f}); the insert's gather {coll['insert_gather']:.4f}",
          flush=True)


def spawn_ranks(label: str, cmds) -> list:
    """Start the rank processes together and wait for them, killing every
    one at TWO_RANKS_TIMEOUT_S (ranks out of step wait on each other
    rather than fail); fatal unless each exits 0. Returns their logs."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    deadline, logs, late = time.monotonic() + TWO_RANKS_TIMEOUT_S, [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            late = True
            p.kill()
            logs.append(p.communicate()[0])
    if late:
        fail(f"{label}: the ranks did not finish within {TWO_RANKS_TIMEOUT_S} s and were killed:\n"
             + "\n".join(f"rank {r}: {log[-2000:]}" for r, log in enumerate(logs)))
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"{label}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return logs


def worker_ranks(label: str, backend: str, devices, scans, ref_traj, gt, overrides: dict | None = None,
                 profile: int = 0) -> list:
    """Phases 10b and 10c: len(devices) parallel.worker processes over
    `backend`, rank r on devices[r], at the full kitti preset (SageConfig
    fields `overrides` over it), on the kitti drive's scans (the last
    `profile` of them under torch.profiler). Their step is ShardedSageICP's
    default: eager over gloo, captured over NCCL. The ranks' trajectories
    equal bit for bit and their final maps slot for slot; a world of one
    equal to `ref_traj` bit for bit, more ranks within 5e-3 m of it
    (test_sharded_maneuver_equivalence's bound); ATE < 0.05 m, no drop;
    every rank's kernels launched as the path launches them, and its
    wrappers called on its share of the rows: GN on R / n (none on the
    reference path), the policy on U / n, the radius count on VR / n.
    Returns the ranks' reports."""
    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.ops import dynamic_filter as dyn
    from sage_icp_tpu_torch.parallel.worker import save_scans

    world = len(devices)
    tag = f"{backend}_{world}_{'_'.join(sorted(overrides or {})) or 'kitti'}"
    out = os.path.join(MULTI_RANK_DIR, f"ranks_{tag}")
    os.makedirs(out, exist_ok=True)
    rendezvous = os.path.join(MULTI_RANK_DIR, f"rendezvous_{tag}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    save_scans(os.path.join(out, "scans.npy"), scans)
    extra = ["--profile", str(profile)] if profile else []
    if overrides:
        with open(os.path.join(out, "config.json"), "w") as f:
            json.dump(overrides, f)
        extra += ["--config", os.path.join(out, "config.json")]
    cmds = [[sys.executable, "-m", "sage_icp_tpu_torch.parallel.worker", "--rank", str(r), "--world", str(world),
             "--init", f"file://{rendezvous}", "--backend", backend, "--device", devices[r],
             "--preset", "kitti", "--scans", os.path.join(out, "scans.npy"), "--out", out,
             "--timeout", str(TWO_RANKS_TIMEOUT_S), *extra] for r in range(world)]
    spawn_ranks(label, cmds)
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank_{r}.json")) as f:
            ranks.append(dict(report=json.load(f), poses=np.load(os.path.join(out, f"poses_{r}.npy")),
                              map=dict(np.load(os.path.join(out, f"map_{r}.npz")))))
    r0 = ranks[0]
    for r, rank in enumerate(ranks[1:], 1):
        if not np.array_equal(r0["poses"], rank["poses"]):
            fail(f"{label}: ranks 0 and {r}'s trajectories differ: max |diff| "
                 f"{np.abs(r0['poses'] - rank['poses']).max()}")
        if r0["map"].keys() != rank["map"].keys() or not all(np.array_equal(r0["map"][k], rank["map"][k])
                                                            for k in r0["map"]):
            fail(f"{label}: ranks 0 and {r}'s final maps differ")
    gap = float(np.linalg.norm(r0["poses"][:, :3, 3] - ref_traj[:, :3, 3], axis=-1).max())
    if world == 1 and not np.array_equal(r0["poses"], ref_traj):
        fail(f"{label}: a world of one differs from the single card's trajectory by {gap} m")
    if not gap < 5e-3:
        fail(f"{label}: {gap} m from the single card's trajectory (bound 5e-3 m)")
    ate = ate_of(r0["poses"], gt)
    if not ate < 0.05:
        fail(f"{label}: ATE {ate} m")
    # the ranks ran the preset padded for the mesh (pad_config_for_mesh)
    padded = {k: r0["report"]["config"][k] for k in ("scan_capacity", "frame_capacity", "source_capacity",
                                                      "insert_unique_capacity")}
    cfg = dataclasses.replace(PRESETS["kitti"], **{**(overrides or {}), **padded})
    reference = not cfg.use_fast_correspondences
    share = lambda rows: -(-rows // world)  # noqa: E731 (the padded share; every split here tiles)
    rows = {"fused_gn_iteration": None if reference else share(cfg.corr_unique_voxel_rows + cfg.corr_overflow_rows),
            "apply_policy": share(min(cfg.insert_unique_capacity, cfg.frame_capacity)),
            "radius_count": share(dyn._VEH_ROW_CAP)}
    captured = backend == "nccl"
    n = len(scans)
    for r, rank in enumerate(ranks):
        rep = rank["report"]
        if rep["graph"] != captured or rep["backend"] != backend or rep["world"] != world:
            fail(f"{label}: rank {r} ran graph={rep['graph']} over {rep['backend']} in a world of {rep['world']}")
        if rep["overflow_total"] != 0:
            fail(f"{label}: rank {r}: silent-drop counters over all frames: {rep['aux_totals']}")
        iters = sum(rep["icp_iterations"])
        expect_launches(f"{label}, rank {r}", rep["launches"], iters, n, n, reference=reference)
        step = rep["launches"]["icp_ref_step" if reference else "icp_step"]
        # the wrappers' Python calls: every launch of the eager step; the
        # first frame's and the captures' of a captured one
        calls = {"fused_gn_iteration": step, "apply_policy": n, "radius_count": n}
        if captured:
            want = {k: set() if v is None else {str(v)} for k, v in rows.items()}
            got = {k: set(v) for k, v in rep["kernel_rows"].items()}
        else:
            want = {k: {} if v is None else {str(v): calls[k]} for k, v in rows.items()}
            got = rep["kernel_rows"]
        if got != want:
            fail(f"{label}: rank {r}: kernel rows {rep['kernel_rows']}, expected {want}")
        print(f"{label}, rank {r} on {rep['device']} (graph={rep['graph']}): {rep['ms_per_frame']:.3f} ms/frame "
              f"after the first frame; ICP iterations {iters}, launches {rep['launches']}, kernel rows "
              f"{rep['kernel_rows']}", flush=True)
    print(f"{label}: trajectories equal bit for bit, final maps equal slot for slot; {gap:.3e} m from the single "
          f"card's trajectory at most; ATE {ate:.5f} m; per rank GN on {rows['fused_gn_iteration']} rows, the policy "
          f"on {rows['apply_policy']}, the radius count on {rows['radius_count']}", flush=True)
    return [rank["report"] for rank in ranks]


HEAD_REPS = 50


def head_timing(rank: int, world: int, init: str) -> None:
    """Phase 10c's timing of the scan head, one of `world` NCCL ranks
    (this process rank `rank` on cuda:rank; `python3 chip_smoke.py
    --head-rank r --head-world n --head-init file://...`), on a seeded
    135,168-point kitti scan from the third pose on: the head whole on
    every rank against each rank's share and the gather of the cropped
    rows, with deskew off and on; each variant bit for bit the whole
    head, captured as a CUDA graph and timed over HEAD_REPS replays
    between CUDA events (device time of the step's own capture, the
    gather included), the median of 5 batches. Rank 0 prints one line
    `HEAD {json}`."""
    import torch.distributed as dist

    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import geometry as geo
    from sage_icp_tpu_torch.ops import scan as scan_ops
    from sage_icp_tpu_torch.parallel.distributed import init_distributed

    mesh = init_distributed(init, world, rank, backend="nccl", device=f"cuda:{rank}", timeout_s=TWO_RANKS_TIMEOUT_S)
    dev = mesh.device
    geo.pin_full_fp32()
    cfg = pl.PRESETS["kitti"]
    rng = np.random.default_rng(0)
    cap = cfg.scan_capacity
    xyz = rng.uniform(-100.0, 100.0, (cap, 3)) * np.array([1.0, 1.0, 0.05])
    pts = torch.tensor(np.concatenate([xyz, rng.choice([0, 10, 40, 44, 50], (cap, 1))], 1), dtype=torch.float32,
                       device=dev)
    valid = torch.tensor(rng.random(cap) < 0.65, device=dev)
    ts = torch.tensor(rng.random(cap), dtype=torch.float32, device=dev)
    state = pl.init_state(dataclasses.replace(cfg, map_capacity=1024), dev)
    state = state._replace(prev_pose=geo.se3_exp(torch.tensor([0.9, 0.1, 0.0, 0.0, 0.0, 0.01], device=dev)),
                           last_pose=geo.se3_exp(torch.tensor([2.0, 0.2, 0.01, 0.001, 0.002, 0.03], device=dev)),
                           num_poses=torch.tensor(3, dtype=torch.int32, device=dev))
    off, on = cfg, dataclasses.replace(cfg, deskew=True)

    def split_crop():  # the split without deskew: scan_head's split path, the crop alone
        p, v = mesh.local_rows(pts), mesh.local_rows(valid)
        c, cv = scan_ops.preprocess(p, v, cfg.max_range, cfg.min_range, cfg.label_max_range)
        rows = mesh.gather_rows(torch.cat([c, cv[:, None].to(c.dtype)], dim=1), cap)
        return rows[:, :4], rows[:, 4] != 0

    variants = {
        "whole, deskew off": lambda: pl.scan_head(state, pts, valid, ts, off),
        "split, deskew off": split_crop,
        "whole, deskew on": lambda: pl.scan_head(state, pts, valid, ts, on),
        "split, deskew on": lambda: pl.scan_head(state, pts, valid, ts, on, mesh),
    }
    graphs, out = {}, {}
    try:
        stream = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            for name, fn in variants.items():
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    fn()  # eager first: NCCL's communicator, the constants
                torch.cuda.current_stream(dev).wait_stream(stream)
                torch.cuda.synchronize(dev)
                holder = {}
                graphs[name] = pl._capture_graph(lambda: holder.update(out=fn()), stream)
                out[name] = holder["out"]
            ms = {name: replay_ms(graphs[name], dev) for name in variants}
            same = {d: all(torch.equal(x, y) for x, y in zip(out[f"split, deskew {d}"], out[f"whole, deskew {d}"]))
                    for d in ("off", "on")}
        if rank == 0:
            kept = int(out["whole, deskew on"][1].sum())
            print("HEAD " + json.dumps(dict(world=world, points=cap, kept=kept, ms=ms, bit_for_bit=same)), flush=True)
    finally:
        # NCCL's communicator waits for the graphs that hold its kernels:
        # no reference to one may outlive this
        graphs.clear()
        dist.destroy_process_group()


def replay_ms(graph, dev) -> float:
    """Device ms of one replay of `graph`: HEAD_REPS replays between CUDA
    events, the median of 5 batches."""
    times = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(HEAD_REPS):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / HEAD_REPS)
    return float(np.median(times))


def head_phase(cards: int) -> dict:
    """Phase 10c's scan-head timing on two NCCL ranks (head_timing)."""
    rendezvous = os.path.join(MULTI_RANK_DIR, "rendezvous_head")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    cmds = [[sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--head-rank", str(r), "--head-world", "2",
             "--head-init", f"file://{rendezvous}"] for r in range(2)]
    logs = spawn_ranks("scan head timing on two NCCL ranks", cmds)
    line = [ln for ln in logs[0].splitlines() if ln.startswith("HEAD ")]
    if not line:
        fail(f"scan head timing: rank 0 printed no result:\n{logs[0][-2000:]}")
    head = json.loads(line[-1][5:])
    if not all(head["bit_for_bit"].values()):
        fail(f"scan head on two ranks: the split head differs from the whole one: {head['bit_for_bit']}")
    ms = head["ms"]
    print(f"scan head on two NCCL ranks (kitti scan of {head['points']} points, {head['kept']} kept; device ms a "
          f"call, captured): deskew off whole {ms['whole, deskew off']:.4f}, split + gather "
          f"{ms['split, deskew off']:.4f}; deskew on whole {ms['whole, deskew on']:.4f}, split + gather "
          f"{ms['split, deskew on']:.4f}; the split equal to the whole head bit for bit", flush=True)
    return head


def stage_ms(kernels: dict) -> dict:
    """Device ms a frame by stage, from a profile's kernel names: the
    filter's min-diffusion (min_diffusion_kernel), PyTorch's gathers
    (index and gather kernels: the row setup's, the filter's and the
    insert's) and NCCL's collectives (whose kernels spin while a peer is
    late)."""
    nccl = {k: v for k, v in kernels.items() if "nccl" in k.lower()}
    pick = lambda *keys: sum(v for k, v in kernels.items() if k not in nccl and any(x in k for x in keys))  # noqa
    return dict(diffusion=pick("min_diffusion_kernel"), gathers=pick("index", "gather"), nccl=sum(nccl.values()))


def multi_rank_phase(scans, traj, gt, dev, ref_traj, profile_scans=None) -> None:
    """Phase 10: the kitti drive's scans through the parallel layer.
    ref_traj: phase 15's captured single-card trajectory of the reference
    path."""
    os.makedirs(MULTI_RANK_DIR, exist_ok=True)
    nccl_world_of_one(scans, traj, dev, profile_scans)
    # two ranks sharing one card: not a scaling figure
    worker_ranks("two ranks sharing one card (gloo)", "gloo", (f"cuda:{dev.index or 0}",) * 2, scans, traj, gt)
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"phase 10c did not run: two NCCL ranks need two cards (NCCL refuses two ranks on one device), and "
              f"this machine has {cards}", flush=True)
        return
    # 10c: one card, two and (with four) four, each a captured NCCL world
    # of worker processes, on the fast and the reference path
    profile = 5 if profile_scans else 0
    ms, prof = {}, {}
    for path, overrides, ref in (("fast", None, traj), ("reference", dict(use_fast_correspondences=False), ref_traj)):
        for world in (1, 2, 4) if path == "fast" else (1, 2):
            if world > cards:
                continue
            label = f"{world} NCCL rank{'s' if world > 1 else ''} on {world} card{'s' if world > 1 else ''}, " \
                    f"{path} path (captured)"
            reps = worker_ranks(label, "nccl", [f"cuda:{r}" for r in range(world)], scans, ref, gt, overrides,
                                profile if path == "fast" and world <= 2 else 0)
            ms[path, world] = [round(r["ms_per_frame"], 3) for r in reps]
            if reps[0]["profile"]:
                prof[world] = reps[0]["profile"]
    print("phase 10c scaling, ms/frame after the first frame, each rank (one call): "
          + "; ".join(f"{path} path, {world} card{'s' if world > 1 else ''} {v}" for (path, world), v in ms.items()),
          flush=True)
    head_phase(cards)
    if prof:
        one, two = prof[1], prof[2]
        a, b = stage_ms(one["kernels_ms"]), stage_ms(two["kernels_ms"])
        print(f"phase 10c profile, rank 0's device ms a frame over the last {two['frames']} frames, one card (the "
              f"phase-6 step through the worker) against two: busy {one['busy_ms']:.3f} / {two['busy_ms']:.3f}; "
              + "; ".join(f"{k} {a[k]:.4f} / {b[k]:.4f}" for k in a), flush=True)
        for name in sorted(set(one["kernels_ms"]) | set(two["kernels_ms"]),
                           key=lambda k: -max(one["kernels_ms"].get(k, 0.0), two["kernels_ms"].get(k, 0.0)))[:25]:
            print(f"  {one['kernels_ms'].get(name, 0.0):9.4f} / {two['kernels_ms'].get(name, 0.0):9.4f} ms/frame  "
                  f"{name[:90]}", flush=True)


def map_differs(a, b) -> list:
    """The fields of two maps (keys, counts, points, first points) that are
    not equal slot for slot."""
    return [f for f in ("keys", "counts", "points", "first_pts") if not torch.equal(getattr(a, f), getattr(b, f))]


def check_grid(name: str, m) -> int:
    """The dense index agrees with the table: every live slot's cell holds
    that slot and its checksum, no two live slots share a cell, and no
    other cell holds a slot (none points at a dead one). Returns the live
    slots."""
    from sage_icp_tpu_torch.ops import hashmap as hm

    live = torch.nonzero(m.counts > 0)[:, 0]
    cells = hm.grid_index(m.keys[live]).long()
    if torch.unique(cells).numel() != live.numel():
        fail(f"{name}: two live slots share a grid cell")
    want = torch.stack([live.to(torch.int32), hm.grid_hi_code(m.keys[live])], dim=-1)
    if not torch.equal(m.grid[cells], want):
        fail(f"{name}: a live slot's grid cell does not hold its slot and checksum")
    used = int((m.grid[:, 0] >= 0).sum())
    if used != live.numel():
        fail(f"{name}: {used} grid cells hold a slot for {live.numel()} live slots")
    return live.numel()


def grid_diff(name: str, on: dict, off: dict, top: int = 12) -> None:
    """--profile: the device time a frame that the grid adds (+) or
    removes (-), by the profiler's names, largest first."""
    rows = []
    for key in set(on) | set(off):
        (t_on, c_on), (t_off, c_off) = on.get(key, (0.0, 0.0)), off.get(key, (0.0, 0.0))
        rows.append((t_on - t_off, c_on - c_off, t_on, t_off, key))
    rows.sort(key=lambda r: -abs(r[0]))
    print(f"{name} grid on minus off, device ms/frame (calls/frame), by the profiler's names:", flush=True)
    for dt, dc, t_on, t_off, key in rows[:top]:
        print(f"  {dt:+9.4f} ms ({dc:+7.1f}x)  on {t_on:8.4f} off {t_off:8.4f}  {key[:90]}", flush=True)


def dense_grid_phase(name: str, scans, ref_traj, ref_map, gt, profile_scans=None) -> None:
    """Phase 11 on one path: PRESETS[name] with dense_grid on and off,
    GRID_REPEATS runs of each, alternated, on the path's scans with its
    calls. Every run's trajectory equals the path's bit for bit; the grid
    run's final map equals the path's slot for slot and its grid is
    consistent; no drop; ATE < 0.05 m; the kernels launched as on the
    path."""
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP

    n = WARMUP + FRAMES
    filt = PRESETS[name].dynamic_vehicle_filter
    ms = {True: [], False: []}
    last = {}
    for rep in range(GRID_REPEATS):
        for grid in ((True, False) if rep % 2 == 0 else (False, True)):
            odom = SageICP(dataclasses.replace(PRESETS[name], dense_grid=grid))
            elapsed, launches = register(odom, scans, WARMUP, n)
            ms[grid].append(1e3 * elapsed / FRAMES)
            label = f"{name} dense_grid={grid} run {rep + 1}"
            traj = odom.trajectory()
            if not np.array_equal(traj, ref_traj):
                fail(f"{label}: trajectory differs from the {name} path's: max |diff| {np.abs(traj - ref_traj).max()}")
            totals = odom.aux_totals()
            if int(totals.overflow_total()) != 0:
                fail(f"{label}: silent-drop counters over all frames: {totals}")
            ate = ate_of(traj, gt)
            if not ate < 0.05:
                fail(f"{label}: ATE {ate} m")
            expect_launches(label, launches, sum(odom.icp_iters), n, n if filt else 0)
            if grid != (odom.state.map.grid is not None):
                fail(f"{label}: the map's grid is {odom.state.map.grid}")
            if grid:
                bad = map_differs(odom.state.map, ref_map)
                if bad:
                    fail(f"{label}: final map differs from the {name} path's in {bad}")
                live = check_grid(label, odom.state.map)
            last[grid] = odom
    print(f"{name} dense grid: trajectories equal to the {name} path's bit for bit in all {2 * GRID_REPEATS} runs, "
          f"the grid runs' final maps slot for slot, grid consistent over {live} live slots; ATE {ate:.5f} m; "
          f"launches {launches}; ms/frame grid on {[round(x, 3) for x in ms[True]]} (median "
          f"{np.median(ms[True]):.3f}), off {[round(x, 3) for x in ms[False]]} (median {np.median(ms[False]):.3f})",
          flush=True)
    if profile_scans:
        _, on = profile(f"{name} dense grid on", last[True], profile_scans)
        _, off = profile(f"{name} dense grid off", last[False], profile_scans)
        grid_diff(name, on, off)


def long_city_config():
    """This package's copy of scripts/long_run.py's configuration: the
    robustness suite's small config with the map sized for the 260 m
    world (~52k live voxels under the 100 m cull)."""
    from sage_icp_tpu_torch.models.pipeline import SageConfig

    return SageConfig(scan_capacity=16384, frame_capacity=16384, source_capacity=8192, map_capacity=131072,
                      max_icp_iterations=500, dynamic_vehicle_filter=False, min_range=1.0,
                      corr_unique_voxel_rows=8192, corr_overflow_rows=512, insert_unique_capacity=9216)


def long_horizon_phase() -> None:
    """Phase 12: scripts/long_run.py's 150-frame city drive (its world,
    trajectory, render seed and chunk of 30), with dense_grid off and on.
    Gates: test_long_horizon_city_drive's bounds on each, the two
    trajectories equal bit for bit and the final maps slot for slot, the
    grid consistent, the kernels launched in every slot of every ICP block (GN) and
    once a frame (policy)."""
    from sage_icp_tpu_torch.metrics import kitti as metrics
    from sage_icp_tpu_torch.models.pipeline import SageICP
    from sage_icp_tpu_torch.utils import synthetic

    pts, labs = synthetic.build_city_world(seed=2, size=260.0, block=50.0, density=1.6)
    gt = synthetic.make_trajectory(LONG_FRAMES, step=1.0, curve=0.0, jitter=0.1, seed=11)
    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000) for i in range(LONG_FRAMES)]
    print(f"long horizon: rendered {LONG_FRAMES} scans in {time.perf_counter() - t0:.1f} s", flush=True)
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    runs = {}
    for grid in (False, True):
        odom = SageICP(dataclasses.replace(long_city_config(), dense_grid=grid))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, LONG_FRAMES, LONG_CHUNK):
            odom.register_chunk(scans[i : i + LONG_CHUNK])
        est = odom.trajectory()
        elapsed = time.perf_counter() - t0
        launches = counts()
        t_err, r_err = metrics.seq_error(gt_rel, est)
        _, ate = metrics.absolute_trajectory_error(gt_rel, est)
        out = dict(rel_trans_err_pct=float(t_err), rel_rot_err_deg_per_m=float(r_err), ate_trans_m=float(ate),
                   final_err_m=float(np.linalg.norm(est[-1][:3, 3] - gt_rel[-1][:3, 3])),
                   overflow_total=int(odom.aux_totals().overflow_total()))
        label = f"long horizon dense_grid={grid}"
        if not (out["overflow_total"] == 0 and out["rel_trans_err_pct"] < 0.12 and out["rel_rot_err_deg_per_m"] < 0.06
                and out["ate_trans_m"] < 0.12 and out["final_err_m"] < 0.4):
            fail(f"{label}: outside test_long_horizon_city_drive's bounds: {out}")
        expect_launches(label, launches, sum(odom.icp_iters), LONG_FRAMES, 0)
        if grid:
            out["live_slots"] = check_grid(label, odom.state.map)
        print(f"{label}: {json.dumps(out)}; {1e3 * elapsed / LONG_FRAMES:.3f} ms/frame over {LONG_FRAMES} frames in "
              f"chunks of {LONG_CHUNK} (first chunk included); ICP iterations {sum(odom.icp_iters)}; "
              f"launches {launches}", flush=True)
        runs[grid] = (est, odom.state.map)
    if not np.array_equal(runs[True][0], runs[False][0]):
        fail(f"long horizon: the grid's trajectory differs: max |diff| {np.abs(runs[True][0] - runs[False][0]).max()}")
    bad = map_differs(runs[True][1], runs[False][1])
    if bad:
        fail(f"long horizon: the grid's final map differs in {bad}")
    print("long horizon: dense_grid on and off equal bit for bit, final maps slot for slot; JAX on the CPU "
          "(LONGRUN_r05.json): rel_trans_err_pct 0.02177, rel_rot_err_deg_per_m 0.01064, ate_trans_m 0.02194, "
          "final_err_m 0.0797, overflow_total 0", flush=True)


def bench_py_keys() -> list:
    """The keys of bench.py's JSON line with its kitti phase, in order,
    read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    literal = re.search(r"^    out = \{(.*?)^    \}", src, re.S | re.M).group(1)
    return re.findall(r'^\s*"(\w+)":', literal, re.M) + re.findall(r'out\["(\w+)"\] =', src)


def bench_phase(rendered: dict) -> None:
    """Phase 13: bench_torch.main() at its defaults, then with the eager
    device step, on the same scans. rendered: {phase: (the scans phases 4
    and 6 rendered, their render generator)}; the rest of each phase's
    scans are rendered on."""
    import bench_torch
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.utils import synthetic

    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("BENCH_")}
    try:
        s = bench_torch.settings()
        t0 = time.perf_counter()
        scans = {}
        for name, cfg, density, frames in (("city", PRESETS[s["preset"]], s["density"], s["frames"]),
                                           ("kitti", PRESETS["kitti"], s["kitti_density"], s["kitti_frames"])):
            done, rng = rendered[name]
            gt = synthetic.make_trajectory(bench_torch.phase_length(s["warmup"], frames, s["chunk"]), step=1.0)
            world = synthetic.build_city_world(seed=0, size=420.0, density=density)
            scans[name] = bench_torch.render_scans(world, cfg, gt, s["points"], rng, done)
        print(f"bench: {sum(len(v) for v in scans.values())} scans, {sum(len(d) for d, _ in rendered.values())} "
              f"of them from phases 4 and 6, the rest rendered in {time.perf_counter() - t0:.1f} s", flush=True)
        label = "bench_torch.py"
        reset_counts()
        try:
            out, captured_run = bench_torch.main(scans)
        except bench_torch.GuardError as e:
            fail(f"{label}: {e}")
        launches = counts()
        if list(out) != bench_py_keys():
            fail(f"{label}: JSON keys {list(out)}, bench.py's {bench_py_keys()}")
        for name, res in captured_run.items():
            if not res.ate_m < 0.05:
                fail(f"{label}: {name} phase ATE {res.ate_m} m")
        city, kitti = captured_run["city"], captured_run["kitti"]
        expect_launches(label, launches, int(city.iterations.sum() + kitti.iterations.sum()),
                        city.frames + kitti.frames, kitti.frames)
        print(f"{label}: launches {launches} over {city.frames} city and {kitti.frames} kitti frames; "
              f"city {city.scans_per_sec} scans/s, kitti {kitti.scans_per_sec} scans/s", flush=True)
        # the same bench with the eager device step (SageICP built with
        # graph=False: no knob of the bench), against the captured one
        captured = pl.SageICP
        pl.SageICP = functools.partial(captured, graph=False)
        try:
            _, eager_run = bench_torch.main(scans)
        except bench_torch.GuardError as e:
            fail(f"{label} with the eager step: {e}")
        finally:
            pl.SageICP = captured
        print(f"{label}, graph off (eager device step): city {eager_run['city'].scans_per_sec} scans/s, kitti "
              f"{eager_run['kitti'].scans_per_sec} scans/s (graph on: {city.scans_per_sec}, "
              f"{kitti.scans_per_sec})", flush=True)
        for name in ("city", "kitti"):
            a, b = captured_run[name].trajectory, eager_run[name].trajectory
            if not np.array_equal(a, b):
                fail(f"bench {name} phase: the eager step differs from the captured run: max |diff| "
                     f"{np.abs(a - b).max()}")
        print(f"bench: the eager step gives the captured run's trajectories bit for bit in both phases; phase 13 "
              f"took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


def aux_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def graph_pair(label: str, config, scans, tss=None, ref_traj=None, per_frame: int = 24, chunk: int = 8):
    """Phase 14.1 on one path: the same drive through SageICP with the
    captured step and with the eager one: register_frame on the first
    `per_frame` scans (the last aux read after each), then register_chunk
    in chunks of `chunk` (the chunk's aux after each). Equal bit for bit:
    trajectories, per-frame iterations, every aux read, the running
    totals, the final maps slot for slot (the dense grid too); the
    launches as on any path; the graph run equal to the path's own
    trajectory (ref_traj). Returns {graph: (odom, ms/frame, launches)}."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.models.pipeline import SageICP

    tss = tss or [None] * len(scans)
    runs = {}
    for graph in (True, False):
        odom = SageICP(config, graph=graph)
        auxes = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for scan, ts in zip(scans[:per_frame], tss[:per_frame]):
            odom.register_frame(scan, ts)
            auxes.append(odom.last_aux)
        for i in range(per_frame, len(scans), chunk):
            odom.register_chunk(scans[i:i + chunk], tss[i:i + chunk] if tss[0] is not None else None)
            auxes.append(odom.last_aux)
        traj = odom.trajectory()
        ms = 1e3 * (time.perf_counter() - t0) / len(scans)
        launches = counts()
        name = f"{label}, graph={graph}"
        if int(odom.aux_totals().overflow_total()) != 0:
            fail(f"{name}: silent-drop counters over all frames: {odom.aux_totals()}")
        expect_launches(name, launches, sum(odom.icp_iters), len(scans),
                        len(scans) if config.dynamic_vehicle_filter else 0, reference=not pl._fast_ok(config))
        runs[graph] = dict(odom=odom, auxes=auxes, traj=traj, ms=ms, launches=launches)
    on, off = runs[True], runs[False]
    if not np.array_equal(on["traj"], off["traj"]):
        fail(f"{label}: graph and eager trajectories differ: max |diff| {np.abs(on['traj'] - off['traj']).max()}")
    if on["odom"].icp_iters != off["odom"].icp_iters:
        fail(f"{label}: graph and eager per-frame iterations differ")
    if not all(aux_equal(a, b) for a, b in zip(on["auxes"], off["auxes"])) or not aux_equal(
            on["odom"].aux_totals(), off["odom"].aux_totals()):
        fail(f"{label}: graph and eager aux differ")
    a, b = on["odom"].state.map, off["odom"].state.map
    if (a.grid is None) != (b.grid is None) or map_differs(a, b) or (a.grid is not None and not torch.equal(a.grid, b.grid)):
        fail(f"{label}: graph and eager final maps differ")
    if ref_traj is not None and not np.array_equal(on["traj"], ref_traj[:len(on["traj"])]):
        fail(f"{label}: the graph run differs from the path's own run: max |diff| "
             f"{np.abs(on['traj'] - ref_traj[:len(on['traj'])]).max()}")
    print(f"{label}: graph = eager bit for bit over {len(scans)} frames ({per_frame} per frame, then chunks of "
          f"{chunk}): poses, iterations {sum(on['odom'].icp_iters)}, {len(on['auxes'])} aux reads, totals, final "
          f"map{' and grid' if a.grid is not None else ''}; ms/frame graph {on['ms']:.3f}, eager {off['ms']:.3f} "
          f"(first frame and captures included); launches graph {on['launches']}", flush=True)
    return {g: (r["odom"], r["ms"], r["launches"]) for g, r in runs.items()}


def recorded_steps(config, scans, n: int = 64) -> list:
    """The first `n` ICP steps of an eager drive over `scans` that ran
    (status RUNNING): (sums, loop_f, loop_i) before each, cloned."""
    from sage_icp_tpu_torch.models.pipeline import SageICP
    from sage_icp_tpu_torch.ops import icp_kernel as ik

    seen = []
    orig = ik.icp_step

    def spy(sums, f, i, max_iterations, drift_lim):
        if len(seen) < n and int(i[ik.I_STATUS]) == ik.RUNNING:
            seen.append((sums.clone(), f.clone(), i.clone(), max_iterations, drift_lim))
        return orig(sums, f, i, max_iterations, drift_lim)

    odom = SageICP(config, graph=False)
    ik.icp_step = spy
    try:
        for scan in scans:
            odom.register_frame(scan)
            if len(seen) >= n:
                break
    finally:
        ik.icp_step = orig
    return seen


def icp_step_row(config, scans) -> dict:
    """Phase 14.2: the ICP step kernel against its plain version bit for
    bit from the states and GN sums an eager kitti drive recorded, and its
    times: a step, a no-op step (a stopped loop's slot), the plain
    version; a no-op GN launch beside them. Returns its kernel-table row."""
    from sage_icp_tpu_torch.ops import icp_kernel as ik

    rec = recorded_steps(config, scans)
    statuses, err = [], 0.0
    for sums, f, i, max_it, lim in rec:
        fk, ik_, fp, ip = f.clone(), i.clone(), f.clone(), i.clone()
        ik.icp_step(sums, fk, ik_, max_it, lim)
        ik.icp_step_plain(sums, fp, ip, max_it, lim)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff((fk, ik_), (fp, ip)))
        if not (torch.equal(fk, fp) and torch.equal(ik_, ip)):
            fail(f"icp_step differs from its plain version on a recorded step: {max_abs_diff((fk,), (fp,))}, "
                 f"{ik_.tolist()} vs {ip.tolist()}")
        statuses.append(int(ik_[ik.I_STATUS]))
    sums, f, i, max_it, lim = rec[0]
    copies = [(f.clone(), i.clone()) for _ in range(160)]
    it = iter(copies)
    step_ms = time_ms(lambda: ik.icp_step(sums, *next(it), max_it, lim))
    plain = iter([(f.clone(), i.clone()) for _ in range(160)])
    plain_ms = time_ms(lambda: ik.icp_step_plain(sums, *next(plain), max_it, lim))
    done = i.clone()
    done[ik.I_STATUS] = ik.DONE
    noop_ms = time_ms(lambda: ik.icp_step(sums, f, done, max_it, lim))  # a no-op writes nothing
    print(f"icp_step: bit for bit against its plain version on {len(rec)} recorded kitti steps (statuses after: "
          f"{statuses.count(ik.RUNNING)} running, {statuses.count(ik.DONE)} done, {statuses.count(ik.REANCHOR)} "
          f"re-anchor); kernel {step_ms:.4f} ms a step, {noop_ms:.4f} ms a no-op step; plain {plain_ms:.4f} ms",
          flush=True)
    # the bound: the bytes a running step touches, once: it reads the 18
    # sums, T_icp (16 floats), the anchor's position and r_scan (4) and
    # two status words, and writes T_icp, |x|, the drift and three status
    # words (160 B read, 84 B written); ~700 float32 operations. Launch
    # latency, not this, is the floor
    b_ms, b_by = bound((18 + 16 + 4 + 2) * 4 + (16 + 2 + 3) * 4, 700)
    return dict(route="cuda", source="sage_icp_tpu_torch/csrc/icp_step.cu",
                replaces="sage_icp_tpu/ops/registration.py:270 (no TPU kernel: the lax.while_loop body)",
                max_abs_err=err, ms=step_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def gn_noop_ms(dev) -> float:
    """A GN launch with a stopped status at kitti shapes (a block's
    trailing slot)."""
    from sage_icp_tpu_torch.ops import nn_kernels

    d = row_inputs(np.random.default_rng(1), dev, KITTI)
    v = KITTI["voxel"]
    stop = torch.ones((), dtype=torch.int32, device=dev)
    args = (*d["planes"], *d["offs"], d["q0"], d["origin"], d["row_abs"], d["used"], d["T"],
            GN_CONST["sem_th"], v / 32767.0, v, GN_CONST["max_corr"], GN_CONST["kth"])
    tile_map = nn_kernels.default_tile_map(d["used"])
    return time_ms(lambda: nn_kernels.fused_gn_iteration(*args, tile_map=tile_map, status=stop))


def sync_free_check(label: str, config, scans) -> None:
    """Phase 14.3: the eager device step under
    torch.cuda.set_sync_debug_mode("error") on frames already on the card,
    after a first frame (which builds the constants): any synchronising
    operation inside the step raises. The status read per block (a
    non-blocking copy to pinned memory and an event) is not one."""
    from sage_icp_tpu_torch.models import pipeline as pl

    odom = pl.SageICP(config, graph=False)
    step = odom._step
    bufs = torch.from_numpy(odom.pad_chunk(scans)).to("cuda")
    state, *_ = step(odom.state, bufs[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in bufs[1:]:
            state, *_ = step(state, b)
    except RuntimeError as e:
        fail(f"the eager device step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{label}: the eager device step ran {len(scans) - 1} frames under set_sync_debug_mode('error') "
          "without a synchronising operation", flush=True)


HOST_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
               "cuLaunchKernel", "cuLaunchKernelEx")
HOST_WAIT = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


def host_profile(label: str, odom, scans) -> dict:
    """Phase 14.4: what the host issues and waits for in a frame, and the
    device's busy share, from torch.profiler over `scans` registered
    through `odom` (already warm): the CUDA runtime calls that launch
    work (kernels, graphs, copies, memsets) and that wait for the card,
    per frame; device busy ms a frame (kernel records; inside a graph too,
    where the profiler records them)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for scan in scans:
            odom.register_frame(scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    n = len(scans)
    calls = lambda names: sum(e.count for e in avg if e.key in names) / n
    by = {e.key: e.count / n for e in avg if e.key in HOST_LAUNCH + HOST_WAIT}
    busy_us = sum(e.self_device_time_total for e in avg if e.device_type == torch.autograd.DeviceType.CUDA)
    out = dict(launches=calls(HOST_LAUNCH), waits=calls(HOST_WAIT), busy_ms=busy_us / 1e3 / n,
               wall_ms=1e3 * wall / n, idle=1 - busy_us / 1e6 / wall if busy_us else float("nan"), by=by)
    print(f"{label}: host launches {out['launches']:.1f} a frame, host waits {out['waits']:.1f} a frame "
          f"({', '.join(f'{k} {v:.1f}' for k, v in sorted(by.items()))}); device busy "
          f"{out['busy_ms']:.3f} ms/frame of {out['wall_ms']:.3f} (profiled), idle share {out['idle']:.4f}",
          flush=True)
    return out


def peak_memory(config, scans, graph: bool) -> float:
    """Phase 14.5: the device memory a fresh SageICP takes at its peak
    over `scans`, above what was allocated before it, in MiB."""
    import gc

    from sage_icp_tpu_torch.models.pipeline import SageICP

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    odom = SageICP(config, graph=graph)
    for scan in scans:
        odom.register_frame(scan)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    del odom
    gc.collect()
    return peak


def graph_phase(city_scans, kitti_scans, skewed, tss, refs: dict) -> dict:
    """Phase 14: the captured step. Returns icp_step's kernel-table row."""
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP

    n = WARMUP + FRAMES
    kitti = PRESETS["kitti"]
    graph_pair("city path", PRESETS["city"], city_scans[:n], ref_traj=refs["city"])
    graph_pair("kitti path", kitti, kitti_scans[:n], ref_traj=refs["kitti"])
    graph_pair("kitti + deskew path", dataclasses.replace(kitti, deskew=True), skewed[:n], tss[:n],
               ref_traj=refs["deskew"])
    graph_pair("kitti dense_grid path", dataclasses.replace(kitti, dense_grid=True), kitti_scans[:n],
               ref_traj=refs["kitti"])
    row = icp_step_row(kitti, kitti_scans[:n])
    print(f"fused_gn_iteration with a stopped status at kitti shapes (a block's trailing slot): "
          f"{gn_noop_ms(torch.device('cuda')):.4f} ms", flush=True)
    sync_free_check("kitti path", kitti, kitti_scans[:6])
    sync_free_check("kitti + deskew path", dataclasses.replace(kitti, deskew=True), skewed[:6])
    sync_free_check("city path", PRESETS["city"], city_scans[:6])
    for name, cfg, scans in (("kitti", kitti, kitti_scans), ("city", PRESETS["city"], city_scans)):
        for graph in (True, False):
            odom = SageICP(cfg, graph=graph)
            for scan in scans[:WARMUP]:
                odom.register_frame(scan)
            host_profile(f"{name} host profile, graph={graph}", odom, scans[WARMUP:WARMUP + 5])
        mem = {g: peak_memory(cfg, scans[:12], g) for g in (True, False)}
        print(f"{name}: peak device memory of a fresh SageICP over 12 frames, above the baseline: graph on "
              f"{mem[True]:.1f} MiB, off {mem[False]:.1f} MiB", flush=True)
        ms = {True: [], False: []}
        for graph in (True, False, False, True, True, False):
            odom = SageICP(cfg, graph=graph)
            elapsed, _ = register(odom, scans, WARMUP, n)
            ms[graph].append(1e3 * elapsed / FRAMES)
        print(f"{name}: ms/frame over {FRAMES} timed frames after {WARMUP}, graph on {[round(x, 3) for x in ms[True]]}"
              f" (median {np.median(ms[True]):.3f}), off {[round(x, 3) for x in ms[False]]} (median "
              f"{np.median(ms[False]):.3f}); alternated on, off, off, on, on, off", flush=True)
    return row


def recorded_ref_steps(config, scans, n: int = 64) -> list:
    """The first `n` reference steps of an eager drive over `scans` that
    ran (status RUNNING): (JTJ, JTr, ncorr, loop_f, loop_i) before each,
    cloned."""
    from sage_icp_tpu_torch.models.pipeline import SageICP
    from sage_icp_tpu_torch.ops import icp_kernel as ik

    seen = []
    orig = ik.icp_ref_step

    def spy(JTJ, JTr, ncorr, f, i, max_iterations):
        if len(seen) < n and int(i[ik.I_STATUS]) == ik.RUNNING:
            seen.append((JTJ.clone(), JTr.clone(), ncorr.clone(), f.clone(), i.clone(), max_iterations))
        return orig(JTJ, JTr, ncorr, f, i, max_iterations)

    odom = SageICP(config, graph=False)
    ik.icp_ref_step = spy
    try:
        for scan in scans:
            odom.register_frame(scan)
            if len(seen) >= n:
                break
    finally:
        ik.icp_ref_step = orig
    return seen


def icp_ref_step_row(config, scans) -> dict:
    """Phase 15.2: the reference step kernel against its plain version bit
    for bit on the steps an eager drive recorded, and its times: a step,
    a no-op step (a stopped loop's slot), the plain version. Returns its
    kernel-table row."""
    from sage_icp_tpu_torch.ops import icp_kernel as ik

    rec = recorded_ref_steps(config, scans)
    statuses, err = [], 0.0
    for JTJ, JTr, nc, f, i, max_it in rec:
        fk, ik_, fp, ip = f.clone(), i.clone(), f.clone(), i.clone()
        ik.icp_ref_step(JTJ, JTr, nc, fk, ik_, max_it)
        ik.icp_ref_step_plain(JTJ, JTr, nc, fp, ip, max_it)
        torch.cuda.synchronize()
        err = max(err, max_abs_diff((fk, ik_), (fp, ip)))
        if not (torch.equal(fk, fp) and torch.equal(ik_, ip)):
            fail(f"icp_ref_step differs from its plain version on a recorded step: {max_abs_diff((fk,), (fp,))}, "
                 f"{ik_.tolist()} vs {ip.tolist()}")
        statuses.append(int(ik_[ik.I_STATUS]))
    JTJ, JTr, nc, f, i, max_it = rec[0]
    copies = iter([(f.clone(), i.clone()) for _ in range(160)])
    step_ms = time_ms(lambda: ik.icp_ref_step(JTJ, JTr, nc, *next(copies), max_it))
    plain = iter([(f.clone(), i.clone()) for _ in range(160)])
    plain_ms = time_ms(lambda: ik.icp_ref_step_plain(JTJ, JTr, nc, *next(plain), max_it))
    done = i.clone()
    done[ik.I_STATUS] = ik.DONE
    stopped = f.clone()
    noop_ms = time_ms(lambda: ik.icp_ref_step(JTJ, JTr, nc, stopped, done, max_it))  # writes est = I only
    print(f"icp_ref_step: bit for bit against its plain version on {len(rec)} recorded kitti reference steps "
          f"(statuses after: {statuses.count(ik.RUNNING)} running, {statuses.count(ik.DONE)} done); kernel "
          f"{step_ms:.4f} ms a step, {noop_ms:.4f} ms a no-op step; plain {plain_ms:.4f} ms", flush=True)
    # the bound: the bytes a running step touches, once: it reads JTJ,
    # JTr and the count (172 B), T_icp and two status words (72 B), and
    # writes T_icp, est, |x| and three status words (144 B): 388 B; the
    # anchor, max_corr, kernel, drift and r_scan stay untouched. ~700
    # float32 operations
    b_ms, b_by = bound((36 + 6 + 1) * 4 + (16 + 2) * 4 + (16 + 16 + 1 + 3) * 4, 700)
    return dict(route="cuda", source="sage_icp_tpu_torch/csrc/icp_step.cu",
                replaces="sage_icp_tpu/ops/registration.py:315 (no TPU kernel: the reference lax.while_loop body)",
                max_abs_err=err, ms=step_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def reference_phase(kitti_scans, gt) -> tuple:
    """Phase 15: PRESETS["kitti"] with use_fast_correspondences=False (the
    reference-shaped ICP loop, registration.RefLoop) on phase 6's scans.
    Returns icp_ref_step's kernel-table row with its launches on the
    captured drive, and that drive's trajectory."""
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP
    from sage_icp_tpu_torch.ops import registration as reg

    n = WARMUP + FRAMES
    cfg = dataclasses.replace(PRESETS["kitti"], use_fast_correspondences=False)
    chosen = reg.REF_BLOCK_ITERATIONS
    runs = graph_pair("kitti reference path", cfg, kitti_scans[:n])
    odom, _, launches = runs[True]
    traj = odom.trajectory()
    ate = ate_of(traj, gt[:n])
    if not np.isfinite(ate) or ate >= 0.05:
        fail(f"kitti reference path: ATE {ate} m over {n} frames")
    per_frame = odom.iteration_counts()
    print(f"kitti reference path: ATE {ate:.5f} m; ICP iterations a frame {per_frame.tolist()} (mean "
          f"{per_frame.mean():.2f}); launches of the captured run {launches}", flush=True)
    eager_loop = runs[False][0]._step._loop  # the last frame's loop: its searches cost what any block's do
    iter_ms = kernel_ms(eager_loop.block) / reg.REF_BLOCK_ITERATIONS
    print(f"kitti reference path: device ms per iteration (search, normal equations, step, source update; "
          f"torch.profiler's kernel time of a block over its {reg.REF_BLOCK_ITERATIONS}): {iter_ms:.4f}", flush=True)
    del runs, odom, eager_loop
    row = icp_ref_step_row(cfg, kitti_scans[:n])
    sync_free_check("kitti reference path", cfg, kitti_scans[:6])

    # the block length: the captured drive at 1, 2, 4 and 8 iterations a block
    # (alternated), its host profile at each, and the eager step's at the
    # package's
    lengths = (1, 2, 4, 8)
    ms = {b: [] for b in lengths}
    try:
        for b in lengths + lengths[::-1]:
            reg.REF_BLOCK_ITERATIONS = b
            o = SageICP(cfg)
            elapsed, got = register(o, kitti_scans, WARMUP, n)
            expect_launches(f"kitti reference path, blocks of {b}", got, sum(o.icp_iters), n, n, reference=True)
            ms[b].append(1e3 * elapsed / FRAMES)
        for b, graph in [(b, True) for b in lengths] + [(chosen, False)]:
            reg.REF_BLOCK_ITERATIONS = b
            o = SageICP(cfg, graph=graph)
            for scan in kitti_scans[:WARMUP]:
                o.register_frame(scan)
            host_profile(f"kitti reference path, blocks of {b}, graph={graph}", o, kitti_scans[WARMUP:WARMUP + 5])
        reg.REF_BLOCK_ITERATIONS = chosen
        eager = []
        for _ in range(2):
            o = SageICP(cfg, graph=False)
            elapsed, _ = register(o, kitti_scans, WARMUP, n)
            eager.append(round(1e3 * elapsed / FRAMES, 3))
    finally:
        reg.REF_BLOCK_ITERATIONS = chosen
    med = {b: float(np.median(v)) for b, v in ms.items()}
    print(f"kitti reference path: ms/frame over {FRAMES} timed frames after {WARMUP}, captured, by block length "
          f"{ {b: [round(x, 3) for x in v] for b, v in ms.items()} } (alternated 1, 2, 4, 8, 8, 4, 2, 1; medians "
          f"{ {b: round(m, 3) for b, m in med.items()} }, least at {min(med, key=med.get)}); eager at "
          f"{chosen}: {eager}; the package's block length {chosen}", flush=True)
    row["launches"] = launches["icp_ref_step"]
    return row, traj


def piece_stamps(name: str, filtered: bool) -> list:
    """(op, slot) of each stamp a piece of the step launches, in order
    (models/pipeline.py::DeviceStep)."""
    from sage_icp_tpu_torch.runtime import tracing as tr

    if name == "prepare":
        heads = [tr.HEAD, tr.FILTER, tr.DOWNSAMPLE] if filtered else [tr.HEAD, tr.DOWNSAMPLE]
        return [(tr.BEGIN, 0)] + [(tr.SPLIT, k) for k in heads] + [(tr.CLOSE, tr.ICP)]
    return [(tr.START, 0), (tr.END_FRAME, tr.UPDATE) if name == "finish" else (tr.CLOSE, tr.ICP)]


def stamp_times(stamps, before, after) -> list:
    """The time of each stamp of a piece, read from the frame's row after
    it (`after`; `before`, the row before it)."""
    from sage_icp_tpu_torch.runtime import tracing as tr

    times, t = [], None
    for op, slot in stamps:
        if op == tr.BEGIN:
            t = int(after[tr.FIRST])
        elif op == tr.START:
            t = int(after[tr.PIECE0 + 2 * min(int(before[tr.PIECES]), tr.MAX_PIECES - 1)])
        elif op == tr.SPLIT:
            t = t + int(after[slot])
        else:
            t = int(after[tr.LAST])
        times.append(t)
    return times


def clock_drive(label: str, config, scans, block: int, fail_at: int | None = None) -> dict:
    """Phase 16 on one captured drive of `scans` at blocks of `block`
    iterations; with fail_at, a wrong-shaped step after that many frames.
    Returns its frames, pieces, stamps and largest row difference."""
    from sage_icp_tpu_torch.models import pipeline as pl
    from sage_icp_tpu_torch.ops import icp_kernel as ik
    from sage_icp_tpu_torch.ops import registration as reg
    from sage_icp_tpu_torch.runtime import tracing as tr

    rec = tr.RECORDER
    reads = []  # (frame id, seq, piece, row after it, live rows after finish, found pairs after a row build)

    def piece(self, name):
        real_piece(self, name)
        frame = rec._local.stack.current
        torch.cuda.synchronize()
        row = frame.ring.rows[frame.seq % rec.capacity].cpu().numpy().copy()
        live = int(self._loop.loop_i[ik.I_LIVE_ROWS]) if name == "finish" else None
        found = int(self._loop.found_pairs) if name in ("prepare", "reanchor") else None
        reads.append((frame.id, frame.seq, name, row, live, found))

    real_piece, real_block = pl.DeviceStep._piece, reg.BLOCK_ITERATIONS
    pl.DeviceStep._piece, reg.BLOCK_ITERATIONS = piece, block
    try:
        odom = pl.SageICP(config)
        ring = odom._step.clock._ring
        reset_counts()
        for i, scan in enumerate(scans):
            if i == fail_at:
                begun = ring.begun
                try:
                    odom._step(odom.state, torch.zeros((3, 4)))
                except ValueError:
                    pass
                else:
                    fail(f"phase 16, {label}: a wrong-shaped step did not raise")
                if ring.begun != begun:
                    fail(f"phase 16, {label}: a step that raised left the host's frame count at {ring.begun}, "
                         f"not {begun}")
            odom.register_frame(scan)
        torch.cuda.synchronize()
        stamps_launched = counts()["stage_clock"]
        odom.release()
    finally:
        pl.DeviceStep._piece, reg.BLOCK_ITERATIONS = real_piece, real_block
    snap = rec.read()
    frames = {f.frame: f for f in snap.frames_of([odom.drive])}
    if len(frames) != len(scans):
        fail(f"phase 16, {label}: {len(frames)} frame records for {len(scans)} frames")
    if int(ring.counter) != ring.begun:
        fail(f"phase 16, {label}: the card's frame counter {int(ring.counter)}, the frames begun {ring.begun}")
    filtered = config.dynamic_vehicle_filter
    err, stamps, most, replay, last, cells, pairs = 0, 0, 0, {}, {}, 0, 0
    for fid, seq, name, row, live, found in reads:
        ops = piece_stamps(name, filtered)
        stamps += len(ops)
        before = last.get(fid)
        want = replay.setdefault(fid, np.zeros(tr.SLOTS, dtype=np.int64))
        for (op, slot), t in zip(ops, stamp_times(ops, before, row)):
            if op == tr.CLOSE and found is not None:  # a row build's close: the found pairs so far
                tr.stamp_row(want, op, slot, t, seq, found, tr.CORR_FOUND_PAIRS)
            else:
                tr.stamp_row(want, op, slot, t, seq, live)
        pairs = max(pairs, found or 0)
        if name == "prepare" and filtered:  # the min-diffusion's counts, written between the stamps
            want[tr.VEHICLE_CELLS], want[tr.DIFFUSION_ROUNDS] = row[tr.VEHICLE_CELLS], row[tr.DIFFUSION_ROUNDS]
            cells = max(cells, int(row[tr.VEHICLE_CELLS]))
        err = max(err, int(np.abs(want - row).max()))
        if not np.array_equal(want, row):
            fail(f"phase 16, {label}: frame {fid}'s row after {name} differs from its replay: card {row.tolist()}, "
                 f"replay {want.tolist()}")
        last[fid] = row
        if name == "finish":
            f = frames.get(fid)
            if f is None or live != f.live_rows or f.live_rows != int(row[tr.LIVE_ROWS]):
                fail(f"phase 16, {label}: frame {fid}'s live rows {None if f is None else f.live_rows}, the loop's "
                     f"count {live}")
            got = (f.stages_ns, f.first_ns, f.last_ns, f.pieces_run, f.pieces, f.vehicle_cells, f.diffusion_rounds,
                   f.corr_found_pairs)
            n = int(want[tr.PIECES])
            exp = ({k: int(want[v]) for k, v in tr.STAGES.items()}, int(want[tr.FIRST]), int(want[tr.LAST]), n,
                   [(int(want[tr.PIECE0 + 2 * i]), int(want[tr.PIECE0 + 2 * i + 1]))
                    for i in range(min(n, tr.MAX_PIECES))], int(want[tr.VEHICLE_CELLS]),
                   int(want[tr.DIFFUSION_ROUNDS]), int(want[tr.CORR_FOUND_PAIRS]))
            if got != exp:
                fail(f"phase 16, {label}: frame {fid}'s record {got} differs from its replay {exp}")
            if n <= tr.MAX_PIECES and f.device_ns != sum(b - a for a, b in f.pieces):
                fail(f"phase 16, {label}: frame {fid}'s stages sum to {f.device_ns} ns, its pieces to "
                     f"{sum(b - a for a, b in f.pieces)}")
            most = max(most, n)
    if stamps_launched != stamps:
        fail(f"phase 16, {label}: {stamps_launched} stage_clock launches, the pieces make {stamps}")
    if filtered and cells == 0:
        fail(f"phase 16, {label}: no frame's row counted an occupied vehicle cell")
    if pairs == 0:
        fail(f"phase 16, {label}: no row build found a neighbour in the map")
    pieces = [f.pieces_run for f in frames.values()]
    print(f"phase 16, {label}: {len(frames)} captured frames at blocks of {block}, pieces a frame {pieces}, "
          f"{stamps} stamps; every row read back equal to its replay, records and live rows equal"
          f"{'; a step that raised after frame ' + str(fail_at) + ' left no frame' if fail_at else ''}", flush=True)
    return dict(frames=len(frames), most=most, stamps=stamps, err=err)


def stage_clock_phase(kitti_scans, dev) -> dict:
    """Phase 16 (docstring). Returns the stage clock's row of the kernel
    table."""
    from sage_icp_tpu_torch.models.pipeline import PRESETS
    from sage_icp_tpu_torch.ops import registration as reg
    from sage_icp_tpu_torch.runtime import tracing as tr

    scans = kitti_scans[:16]
    a = clock_drive("kitti", PRESETS["kitti"], scans, reg.BLOCK_ITERATIONS, fail_at=5)
    b = clock_drive("kitti_gt", PRESETS["kitti_gt"], scans, 2)
    if max(a["most"], b["most"]) <= tr.MAX_PIECES:
        fail(f"phase 16: no frame ran more than {tr.MAX_PIECES} pieces")
    rec = tr.Recorder(frames=4)
    clock = tr.StageClock(rec, dev)
    rec.begin_frame(clock)
    clock.begin()
    ms = time_ms(lambda: clock.split(tr.ICP), reps=100)
    row = np.zeros(tr.SLOTS, dtype=np.int64)
    t0 = time.perf_counter()
    for k in range(10_000):
        tr.stamp_row(row, tr.SPLIT, tr.ICP, k)
    plain_ms = (time.perf_counter() - t0) / 10_000 * 1e3
    rec.end_frame()
    return dict(route="cuda", source="sage_icp_tpu_torch/csrc/stage_clock.cu", replaces="none (the recorder's)",
                max_abs_err=float(max(a["err"], b["err"])), ms=ms, plain_ms=plain_ms, bound_ms=0.0,
                bound_by="launch latency", library_ms=None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 3")
    ap.add_argument("--profile", action="store_true", help="also break a frame's time down")
    ap.add_argument("--root", default=None, help="only time the kernels of the port checked out here")
    ap.add_argument("--multi-rank", action="store_true",
                    help="only phase 10, after the drives it compares with (phase 6's, phase 15's captured one)")
    ap.add_argument("--stage-clock", action="store_true", help="only phase 6, then phase 16")
    ap.add_argument("--head-rank", type=int, default=None, help=argparse.SUPPRESS)  # phase 10c's head_timing
    ap.add_argument("--head-world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--head-init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    if args.head_rank is not None:
        head_timing(args.head_rank, args.head_world, args.head_init)
        return 0
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
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP

    n = WARMUP + FRAMES
    extra = 5 if args.profile else 0
    if args.multi_rank:
        kitti = SageICP()
        kitti_scans, _, kitti_gt, _ = drive("kitti", kitti, 1.3, WARMUP, FRAMES, extra)
        reference = SageICP(dataclasses.replace(PRESETS["kitti"], use_fast_correspondences=False))
        register(reference, kitti_scans, WARMUP, n)
        multi_rank_phase(kitti_scans[:n], kitti.trajectory(), kitti_gt, dev, reference.trajectory(),
                         kitti_scans[n:] if args.profile else None)
        print(smi)
        return 0
    if args.stage_clock:
        kitti_scans, launches, _, _ = drive("kitti", SageICP(), 1.3, WARMUP, FRAMES, 0)
        row = stage_clock_phase(kitti_scans, dev)
        print_row("stage_clock", row)
        print(json.dumps({"kernels": [dict(name="stage_clock", launches=launches["stage_clock"], **row)]}), flush=True)
        print(smi)
        return 0
    rows = check_kernels(dev)
    if args.kernels_only:
        print(smi)
        return 0
    city = SageICP("city")
    city_scans, _, city_gt, city_rng = drive("city", city, 0.7, WARMUP, FRAMES, extra)
    city_traj, city_map = city.trajectory(), city.state.map
    nn_launches = single_pass(city, city_scans[n - 1])
    kitti = SageICP()  # the default preset
    if kitti.config != PRESETS["kitti"] or not kitti.config.dynamic_vehicle_filter:
        fail("SageICP() is not the kitti preset with its dynamic filter")
    kitti_scans, launches, kitti_gt, kitti_rng = drive("kitti", kitti, 1.3, WARMUP, FRAMES, extra)
    kitti_traj, kitti_map = kitti.trajectory(), kitti.state.map
    filter_counts(kitti)
    sort_launches, rows["min_diffusion"], rows["corr_planes"] = kitti_checks(kitti, kitti_scans[n - 1])
    print_row("min_diffusion", rows["min_diffusion"])
    print_row("corr_planes", rows["corr_planes"])
    rows["stage_clock"] = stage_clock_phase(kitti_scans, dev)
    print_row("stage_clock", rows["stage_clock"])
    deskew_odom, skewed, tss, deskew_kernel_ms = runtime_phase(kitti_scans, dev)
    ref_row, ref_traj = reference_phase(kitti_scans, kitti_gt)  # phase 15, before 10c compares with it
    print_row("icp_ref_step", ref_row)
    multi_rank_phase(kitti_scans[:n], kitti_traj, kitti_gt, dev, ref_traj, kitti_scans[n:] if args.profile else None)
    dense_grid_phase("kitti", kitti_scans, kitti_traj, kitti_map, kitti_gt, kitti_scans[n:] if args.profile else None)
    dense_grid_phase("city", city_scans, city_traj, city_map, city_gt, city_scans[n:] if args.profile else None)
    long_horizon_phase()
    bench_phase({"city": (city_scans, city_rng), "kitti": (kitti_scans, kitti_rng)})
    rows["icp_step"] = graph_phase(city_scans, kitti_scans, skewed, tss,
                                   {"city": city_traj, "kitti": kitti_traj, "deskew": deskew_odom.trajectory()})
    print_row("icp_step", rows["icp_step"])
    if args.profile:
        profile("city", city, city_scans[n:])
        profile("kitti", kitti, kitti_scans[n:])
        busy, _ = profile("kitti deskew", deskew_odom, skewed[n:], tss[n:])
        print(f"deskew share of the deskew path's device busy time (kernel_ms / busy): {deskew_kernel_ms:.4f} / "
              f"{busy:.3f} ms = {deskew_kernel_ms / busy:.4f}", flush=True)
    # launches: the kitti path's, the NN kernel's single-pass search and
    # the sort kernel's check on the filter's keys
    launches.update(fused_semantic_nn=nn_launches, bitonic_sort_planes=sort_launches)
    table = [dict(name=name, launches=launches[name], **row) for name, row in rows.items()]
    table.append(dict(name="icp_ref_step", **ref_row))  # its launches: phase 15's captured drive
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
