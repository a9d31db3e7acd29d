"""The port on the card: each CUDA kernel against its plain PyTorch
version, the ICP solve and the dynamic-vehicle filter against the port on
the CPU, the odometry step on the reference suite's trajectories
(golden fixture, turn-stop-reverse maneuver, undersized capacities, a
garbage scan, motion-skewed scans with deskew on and off) and on the
default `kitti` preset, the kitti prepare graph's node count, the deskew
gate, the chunked step against single frames and a checkpoint resume. This file imports no
JAX, so it runs where only PyTorch is installed (tests/conftest.py
imports jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Without a CUDA device every test skips. Tolerances: the retention policy,
the semantic NN, the radius count and the bitonic sort (against the
network run stage by stage, and under its contract against the stable
sort) bit for bit; the GN kernel in one launch and deterministic, its
inputs read from device memory, a no-op on a stopped status; the ICP step
kernel bit for bit; the captured step equal to the eager one bit for bit;
the
filter's keep mask and overflow bit for bit; the min-diffusion kernel
bit for bit, with its two recorder counts equal to a numpy replay's; the
candidate planes' kernel bit for bit, with its found pairs equal; the GN sums within 1e-5 of
the sum of their terms' magnitudes (only the summation order differs);
poses within 1e-4 of the CPU run; the golden trajectory within
0.02 m / 0.02; the maneuver ATE below 0.30 m and re-lock after a garbage
scan within 0.25 m, deskew on below 0.7x off and 0.10 m, as in
tests/test_robustness.py; chunked against single frames within 1e-5
(tests/test_pipeline.py); a resumed run within 1e-5 m of the
uninterrupted one, its map equal slot for slot; the sharded step at
world size 1 over NCCL, captured and eager, equal to SageICP bit for bit,
two ranks sharing the card over gloo equal to each other bit for bit and
within 5e-4 of SageICP (tests/test_parallel.py's bound), two NCCL ranks
on two cards, captured, equal to each other bit for bit and within 5e-3 m
of SageICP; the reference step kernel bit for bit, and the reference
loop's captured step equal to its eager one bit for bit; the poses
stepped from the pinned staging buffer by register_frame without
blocking and by register_chunk equal to those of register_frame with
blocking bit for bit.

The seeded input builders here are shared with tests/test_torch_kernels.py
and tests/test_torch_dynfilter.py.
"""

import dataclasses
import itertools
import pathlib

import numpy as np
import pytest
import torch

from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import correspondence_fast as tcf
from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels, policy_kernel, sort_kernel
from sage_icp_tpu_torch.ops import dynamic_filter as tdyn
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import registration as treg
from sage_icp_tpu_torch.ops import scan as tscan
from sage_icp_tpu_torch.runtime import tracing
from sage_icp_tpu_torch.utils import synthetic

VOXEL = 1.0
SEM_TH, MAX_CORR, KTH = 0.4, 1.5, 0.5
BASIC_LABELS = (40, 44, 48, 49, 50, 70, 72)
GOLDEN_PATH = pathlib.Path(__file__).parent / "data" / "golden_traj.npz"
# the golden fixture's configuration (tests/test_robustness.small_config)
GOLDEN_CONFIG = dict(
    scan_capacity=16384, frame_capacity=16384, source_capacity=8192, map_capacity=65536,
    max_icp_iterations=500, dynamic_vehicle_filter=False, min_range=1.0,
    corr_unique_voxel_rows=8192, corr_overflow_rows=512, insert_unique_capacity=9216,
)
# tests/test_parallel.py's tiny_config (this file imports no JAX)
TINY_CONFIG = dict(
    scan_capacity=4096, frame_capacity=4096, source_capacity=1024, map_capacity=8192, max_icp_iterations=30,
    dynamic_vehicle_filter=False, min_range=1.0, corr_unique_voxel_rows=512, corr_overflow_rows=128,
    insert_unique_capacity=2048, max_incoming_per_voxel=16, probe_depth=8,
)


def t(a):
    return torch.from_numpy(np.array(a))


def nn_rows(seed, R=256, P=2, K=8, dead_from=None):
    """Seeded correspondence rows: invalid lanes, label-0 lanes and
    queries, optional dead trailing rows (no used slot)."""
    rng = np.random.default_rng(seed)
    M = 27 * K
    planes = [rng.integers(-32767, 32768, (R, M), dtype=np.int16) for _ in range(3)]
    planes.append(rng.choice(np.array([-1, 0, 40, 50, 10], np.int16), (R, M)))
    offs = tcf.lane_offsets(K, VOXEL)
    row_abs = rng.integers(-30, 30, (R, 3)).astype(np.int32)
    origin = row_abs.astype(np.float32) * np.float32(VOXEL)
    local = rng.uniform(-0.3, 1.3, (R, P, 3)).astype(np.float32)
    lab = rng.choice(np.array([0, 40, 50, 10], np.float32), (R, P, 1))
    used = (rng.random((R, P)) < 0.8).astype(np.int32)
    if dead_from is not None:
        used[dead_from:] = 0
    return dict(
        planes=planes, offs=[o.numpy() for o in offs], used=used, row_abs=row_abs, origin=origin,
        q_local=np.concatenate([local, lab], -1).reshape(R, 4 * P),
        q_world=np.concatenate([local + origin[:, None, :], lab], -1).reshape(R, 4 * P),
    )


def policy_rows(seed, U=256, K=8, Rm=8):
    """Seeded retention-policy rows: label-0 slots, rows without a slot
    (seglen 0), every class among the incoming points."""
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(-32767, 32768, (U, K), dtype=np.int16) for _ in range(3)]
    blocks.append(rng.choice(np.array([0, 40, 50, 10, 80], np.int16), (U, K)))
    counts = rng.integers(0, K + 1, (U, 1)).astype(np.int32)
    seglen = rng.integers(0, Rm + 1, (U, 1)).astype(np.int32)
    seglen[::5] = 0
    inc = [rng.integers(-32767, 32768, (U, Rm), dtype=np.int16) for _ in range(3)]
    lab = rng.choice(np.array([0, 40, 44, 50, 10, 80, 81]), (U, Rm))
    cls = np.where(lab == 0, 0, np.where(np.isin(lab, BASIC_LABELS), 1, 2))
    enc = (lab | (cls << policy_kernel.CLS_SHIFT)).astype(np.int16)
    return blocks + [counts, seglen] + inc + [enc]


def policy_edge_rows(seed, U=209, K=40, Rm=48):
    """policy_rows with rows at every branch's edge, in turn: count K and
    no label-0 slot; every slot label 0; seglen R_max; count K, every slot
    label 0 and seglen R_max; count 0 and seglen R_max; only critical
    points, seglen R_max (appends up to K, then overwrites)."""
    rows = policy_rows(seed, U=U, K=K, Rm=Rm)
    bl, counts, seglen, ie = rows[3], rows[4], rows[5], rows[9]
    kind = np.arange(U) % 7
    bl[kind == 0] = np.where(bl[kind == 0] == 0, 40, bl[kind == 0])
    counts[(kind == 0) | (kind == 3)] = K
    bl[(kind == 1) | (kind == 3)] = 0
    counts[kind == 4] = 0
    seglen[(kind >= 2) & (kind <= 5)] = Rm
    ie[kind == 5] = np.int16(81 | (2 << policy_kernel.CLS_SHIFT))
    return rows


def gn_fixture(n=2000, seed=0):
    """Two walls and a floor (a well-conditioned 6-DoF problem) as the
    world, and the frame seen from a known offset."""
    rng = np.random.default_rng(seed)
    floor = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), rng.normal(0, 0.01, n)], 1)
    wall1 = np.stack([rng.uniform(-10, 10, n // 2), 8.0 + rng.normal(0, 0.01, n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    wall2 = np.stack([-9.0 + rng.normal(0, 0.01, n // 2), rng.uniform(-10, 10, n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    world = np.concatenate([floor, wall1, wall2]).astype(np.float32)
    world = np.concatenate([world, np.zeros((len(world), 1), np.float32)], axis=1)
    xi = torch.tensor([0.12, -0.08, 0.04, 0.015, -0.01, 0.02])
    Tinv = tgeo.se3_inverse(tgeo.se3_exp(xi)).numpy()
    frame = world.copy()
    frame[:, :3] = frame[:, :3] @ Tinv[:3, :3].T + Tinv[:3, 3]
    return world, frame


def radius_rows(seed, R=512, P=48, M=27 * 32):
    """Seeded radius-count rows: queries on a 2^-10 m grid, candidates
    around them, lanes exactly 0.5 m from a query along an axis (d2 == r2
    without rounding), 1e9 sentinel lanes, unused slots and dead rows."""
    rng = np.random.default_rng(seed)
    dy = lambda a: np.round(a * 1024.0) / 1024.0
    center = dy(rng.uniform(-40.0, 40.0, (R, 1, 3)))
    q = (center + dy(rng.uniform(-0.25, 0.25, (R, P, 3)))).astype(np.float32)
    cand = (center + rng.uniform(-0.75, 0.75, (R, M, 3))).astype(np.float32)
    for lane in range(12):
        axis, sign = lane % 3, 1.0 if lane % 2 else -1.0
        cand[:, lane] = q[:, lane % P]
        cand[:, lane, axis] += np.float32(0.5 * sign)
    cand[rng.random((R, M)) < 0.3] = 1.0e9
    used = (rng.random((R, P)) < 0.7).astype(np.int32)
    used[1::2] = 0  # dead rows
    c = np.ascontiguousarray
    return [c(cand[..., 0]), c(cand[..., 1]), c(cand[..., 2]), q.reshape(R, 3 * P), used]


def radius_edge_rows(seed, R=256, P=48, M=27 * 32, r2=0.25):
    """radius_rows at the edges of the kernel's lane skip: row 0 has every
    slot used, rows 2 mod 4 one used slot, odd rows none; in each live row
    lanes 12-29 lie one ulp inside, on and one ulp outside the skip margin
    beyond the used queries' bounds on each axis and side, lanes 30-34
    are NaN or infinite on one axis (as many as M holds), and in rows 0
    and 4 a used query has a NaN or an infinite coordinate. M need not be
    a multiple of 4 or 32 (at least 30)."""
    cx, cy, cz, q, used = radius_rows(seed, R=R, P=P, M=M)
    c = [cx, cy, cz]
    q = q.reshape(R, P, 3).copy()
    used[0] = 1
    used[2::4] = 0
    used[2::4, seed % P] = 1
    q[0, P - 1, 0] = np.nan
    q[4, 0, 2] = -np.inf
    m = nn_kernels.skip_margin(r2)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    for r in np.nonzero(used.any(axis=1))[0]:
        fin = q[r][(used[r] != 0) & np.isfinite(q[r]).all(axis=1)]
        if len(fin) == 0:
            continue
        lo, hi, near = fin.min(axis=0), fin.max(axis=0), fin[0]
        lane = 12
        for a in range(3):
            for edge in (hi[a] + m, lo[a] - m):
                e = np.float32(edge)
                for v in (np.nextafter(e, down), e, np.nextafter(e, up)):
                    for b in range(3):
                        c[b][r, lane] = v if b == a else near[b]
                    lane += 1
        for lane, (a, v) in zip(range(30, M), ((0, np.nan), (0, np.inf), (1, -np.inf), (2, np.inf), (2, np.nan))):
            c[a][r, lane] = v
    return [cx, cy, cz, q.reshape(R, 3 * P), used]


def sort_planes(seed, n, unsigned):
    """Two heavily duplicated keys (uint32 with the high bit set, or int32
    of both signs), an iota key and a float32 payload, as numpy arrays;
    uint32 keys as their int32 view."""
    rng = np.random.default_rng(seed)
    if unsigned:
        k1 = rng.choice(np.array([0, 1, 5, 2**31 - 1, 2**31, 2**32 - 1], np.uint64), n).astype(np.uint32)
        k2 = rng.integers(0, 5, n).astype(np.uint32) << np.uint32(29)
        k1, k2 = k1.view(np.int32), k2.view(np.int32)
    else:
        k1 = rng.choice(np.array([-(2**31), -7, 0, 3, 2**31 - 1], np.int32), n)
        k2 = rng.integers(-2, 3, n).astype(np.int32)
    return [k1, k2, np.arange(n, dtype=np.int32), rng.normal(size=n).astype(np.float32)]


def pad_scan(pts, cap):
    """(cap, 4) buffer with INVALID_COORD padding, and its valid mask."""
    buf = np.full((cap, 4), tscan.INVALID_COORD, np.float32)
    buf[: len(pts)] = pts
    valid = np.zeros(cap, dtype=bool)
    valid[: len(pts)] = True
    return buf, valid


def parked_moving_scan(cap=16384):
    """tests/test_metrics_runtime.py's fixture: a parked car on a dense
    parking-labelled patch and a moving car on the road, label 10."""
    rng = np.random.default_rng(0)
    n_car, n_park = 80, 800
    col = lambda lo, hi, n: rng.uniform(lo, hi, n)
    parked = np.stack([col(10, 13, n_car), col(4.2, 5.8, n_car), col(0.1, 0.4, n_car), np.full(n_car, 10.0)], 1)
    lot = np.stack([col(9, 14, n_park), col(3.8, 6.2, n_park), col(-0.05, 0.25, n_park), np.full(n_park, 44.0)], 1)
    moving = np.stack([col(30, 33, n_car), col(-1, 1, n_car), col(0.3, 1.4, n_car), np.full(n_car, 10.0)], 1)
    road = np.stack([col(25, 40, n_park), col(-4, 4, n_park), col(-0.05, 0.05, n_park), np.full(n_park, 40.0)], 1)
    return pad_scan(np.concatenate([parked, lot, moving, road]).astype(np.float32), cap)


def crowded_cell_scan(cap=16384):
    """A parked car with 60 points in one 0.5 m cell (more than the 48
    query slots of a cell row) and five car points 20 m up (outside the
    grid's z span): both kinds count in the filter's overflow."""
    rng = np.random.default_rng(7)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)
    crowd = np.stack([u(10.05, 10.45, 60), u(4.05, 4.45, 60), u(0.55, 0.95, 60), np.full(60, 10.0)], 1)
    car = np.stack([u(9, 12, 120), u(3.6, 5.2, 120), u(0.1, 1.4, 120), np.full(120, 13.0)], 1)
    lot = np.stack([u(8, 13, 700), u(3, 6, 700), u(-0.05, 0.2, 700), np.full(700, 48.0)], 1)
    up = np.stack([u(5, 6, 5), u(1, 2, 5), np.full(5, 20.2), np.full(5, 10.0)], 1)
    return pad_scan(np.concatenate([crowd, car, lot, up]).astype(np.float32), cap)


def kitti_world():
    """The kitti-scale drive of chip_smoke.py: the city world at density
    1.3 along make_trajectory."""
    return synthetic.build_city_world(seed=0, size=420.0, density=1.3)


def city_frame(world, frame=11, crop=None):
    """Scan `frame` of the drive (render_scan at n_target 120000, seeded
    by the frame index); with crop=(hx, hy) only |x| < hx, |y| < hy."""
    pts, labs = world
    gt = synthetic.make_trajectory(frame + 1, step=1.0)
    scan = synthetic.render_scan(pts, labs, gt[frame], np.random.default_rng(frame), n_target=120_000)
    if crop is not None:
        scan = scan[(np.abs(scan[:, 0]) < crop[0]) & (np.abs(scan[:, 1]) < crop[1])]
    return scan


def car_row_scan(cap=16384, cells=45):
    """Parked cars bumper to bumper over a parking lot: one label-10 point
    at the centre of each 0.5 m cell of a row `cells` long in x and two
    wide, at z 0.3 m, the lot (44) below. The row is one 27-connected blob
    longer than the filter's 24 diffusion rounds reach: a cell 25 or more
    cells from the row's start keeps the id of the cell 24 back, so the
    cut leaves cells - 24 ids, and each id past the first holds two points,
    too few for a cluster: the filter keeps the first 25 cells' points
    and removes the rest."""
    rng = np.random.default_rng(11)
    i, j = np.meshgrid(np.arange(cells), np.arange(2), indexing="ij")
    car = np.stack([5.25 + 0.5 * i.ravel(), 4.25 + 0.5 * j.ravel(), np.full(i.size, 0.3), np.full(i.size, 10.0)], 1)
    n = 60 * cells
    lot = np.stack([rng.uniform(5.0, 5.0 + 0.5 * cells, n), rng.uniform(3.8, 5.2, n), rng.uniform(-0.05, 0.2, n),
                    np.full(n, 44.0)], 1)
    return pad_scan(np.concatenate([car, lot]).astype(np.float32), cap)


def vehicle_keys(buf, valid, cfg):
    """The filter's vehicle sort keys (its `vk`) of a scan buffer,
    preprocessed as the step does, on the buffer's device."""
    pts, ok = tscan.preprocess(buf, valid, cfg.max_range, cfg.min_range, cfg.label_max_range)
    veh_key, _, _ = tdyn.class_sort_keys(pts, ok, cfg)
    return tdyn._sort_class(pts, veh_key, tdyn._VEH_PTS_CAP)[0]


def diffusion_replay(vk, nx, rounds=tdyn._CC_ITERS, nz=tdyn._GRID_NZ):
    """The filter's min-diffusion written out in numpy on the occupied
    cells alone: each cell (a distinct member key of vk) takes the minimum
    of its own id and its occupied 26 neighbours' ids of the round before,
    for `rounds` rounds or to the first round that changes nothing.
    Returns (each row's cluster id, nx * nx * nz past the members; the
    occupied cells; the rounds that changed an id)."""
    vk = np.asarray(vk, np.int64)
    live = vk != tdyn._BIG
    cells = np.unique(vk[live])
    val = cells.copy()
    xyz = np.stack([cells // (nz * nx), cells // nz % nx, cells % nz], 1)
    nbrs = []
    for off in itertools.product((-1, 0, 1), repeat=3):
        q = xyz + off
        lin = (q[:, 0] * nx + q[:, 1]) * nz + q[:, 2]
        at = np.minimum(np.searchsorted(cells, lin), len(cells) - 1)
        ok = ((q >= 0) & (q < (nx, nx, nz))).all(1) & (cells[at] == lin) & any(off)
        nbrs.append((np.nonzero(ok)[0], at[ok]))
    done = 0
    for r in range(rounds):
        new = val.copy()
        for dst, src in nbrs:
            new[dst] = np.minimum(new[dst], val[src])
        if np.array_equal(new, val):
            break
        val, done = new, r + 1
    out = np.full(len(vk), nx * nx * nz, np.int64)
    out[live] = val[np.searchsorted(cells, vk[live])]
    return out, len(cells), done


def recorded(device, fn):
    """fn() as the one frame of a fresh recorder on `device` (standing in
    for tracing.RECORDER meanwhile), between the stage clock's first and
    last stamp. Returns (fn's result, the frame's record)."""
    rec, process_wide = tracing.Recorder(frames=4), tracing.RECORDER
    tracing.RECORDER = rec
    try:
        clock = tracing.StageClock(rec, torch.device(device))
        rec.begin_frame(clock)
        try:
            clock.begin()
            out = fn()
            clock.end_frame(tracing.UPDATE)
            rec.close_frame()
        finally:
            rec.end_frame()
    finally:
        tracing.RECORDER = process_wide
    (frame,) = rec.read().frames
    return out, frame


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_semantic_nn_kernel_matches_plain(card, P):
    d = nn_rows(4, R=300, P=P)
    args = [t(a).to(card) for a in d["planes"] + d["offs"] + [d["q_local"]]] + [SEM_TH, VOXEL / 32767.0]
    got = nn_kernels.fused_semantic_nn(*args)
    want = nn_kernels.fused_semantic_nn_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def gn_args(card, K, P, R=389, dead_from=None, seed=5):
    """The GN wrapper's arguments on the card for seeded rows; T on the
    card, as the ICP loop's state holds it."""
    d = nn_rows(seed, R=R, P=P, K=K, dead_from=dead_from)
    T = tgeo.se3_exp(torch.tensor([0.05, -0.02, 0.01, 0.004, -0.003, 0.006])).to(card)
    args = [t(a).to(card) for a in d["planes"] + d["offs"] + [d["q_world"], d["origin"], d["row_abs"], d["used"]]]
    return args + [T, SEM_TH, VOXEL / 32767.0, VOXEL, MAX_CORR, KTH]


def device_kernels(fn):
    """Names of the device kernels that fn() runs (torch.profiler), the
    longest list of three profiled calls. The profiler can drop a
    kernel's record (on the H100: a window's first kernel, and now and
    then another), never add one, so the longest list is the count.
    Fill kernels open each window; they fill with ones, which is always a
    kernel (a zero fill may be a memset, and then fn()'s first kernel is
    the one dropped)."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append([n for n in names if "FillFunctor" not in n])
    return max(seen, key=len)


@pytest.mark.cuda
@pytest.mark.parametrize("dead_from", [None, 256])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [40, 20, 8, 7])
def test_gn_kernel_matches_plain(card, K, P, dead_from):
    """Every load width (K 40 and 8: 16 B; K 20: 8 B; K 7: 2 B), every P,
    dead tiles, and R = 389 rows (a multiple of neither the 8 rows of a
    block's step nor the 128 of a tile)."""
    assert nn_kernels.gn_load_bytes(27 * K) == {40: 16, 20: 8, 8: 16, 7: 2}[K]
    args = gn_args(card, K, P, dead_from=dead_from)
    tile_map = nn_kernels.default_tile_map(args[10])
    if dead_from is not None:
        assert int((tile_map != torch.arange(len(tile_map), device=card)).sum()) == 2
    cuda_lib.reset_launches()
    got = nn_kernels.fused_gn_iteration(*args, tile_map=tile_map)
    assert cuda_lib.launches()["fused_gn_iteration"] == 1
    terms = nn_kernels.gn_terms(*args, tile_map)
    want = terms.sum(dim=1)
    assert torch.all((got - want).abs() <= 1e-5 * terms.abs().sum(dim=1) + 1e-6)
    assert float(got[16]) > 0 and float(got[17]) == float(want[17])
    # the reduction is deterministic, and the ticket counter is reset
    assert torch.equal(got, nn_kernels.fused_gn_iteration(*args, tile_map=tile_map))


@pytest.mark.cuda
def test_gn_kernel_reads_its_inputs_from_device_memory(card):
    """T, max_corr and kernel_th as device tensors (views of a loop
    state, as the ICP loop passes them) give the sums of the same values
    as numbers; a stopped status makes the launch a no-op that leaves the
    output unwritten and the ticket counter at zero (the next call is
    right)."""
    args = gn_args(card, 40, 2, dead_from=256)
    tile_map = nn_kernels.default_tile_map(args[10])
    want = nn_kernels.fused_gn_iteration(*args, tile_map=tile_map)
    state = torch.zeros(40, device=card)
    state[16:32] = args[11].reshape(-1)
    state[32], state[33] = MAX_CORR, KTH
    dev_args = args[:11] + [state[16:32].view(4, 4), SEM_TH, VOXEL / 32767.0, VOXEL, state[32], state[33]]
    assert torch.equal(nn_kernels.fused_gn_iteration(*dev_args, tile_map=tile_map), want)
    status = torch.ones((), dtype=torch.int32, device=card)
    cuda_lib.reset_launches()
    out = nn_kernels.fused_gn_iteration(*dev_args, tile_map=tile_map, status=status)
    torch.cuda.synchronize()
    assert cuda_lib.launches()["fused_gn_iteration"] == 1
    assert int(nn_kernels._gn_scratch_on(card)[0]) == 0
    del out  # unwritten: its contents are whatever the allocator held
    status.zero_()
    assert torch.equal(nn_kernels.fused_gn_iteration(*dev_args, tile_map=tile_map, status=status), want)


@pytest.mark.cuda
def test_icp_step_kernel_matches_plain(card):
    """The step kernel against its plain version bit for bit, from the
    same loop state, over seeded GN sums: a solve, a non-finite solve, a
    clamped one, a stop at max_iterations, a re-anchor request and a
    launch on a stopped loop; a running step adds the live rows of the
    current rows to the frame's (icp_kernel.I_LIVE_ROWS)."""
    from sage_icp_tpu_torch.ops import icp_kernel as ik

    args = gn_args(card, 40, 2, dead_from=256)
    sums = nn_kernels.fused_gn_iteration(*args)
    cases = [sums, sums * torch.tensor([float("nan")] * 16 + [1.0, 1.0], device=card),
             sums * torch.tensor([1.0] * 10 + [1e6] * 6 + [1.0, 1.0], device=card)]
    for k, s in enumerate(cases):
        for max_it, drift_lim, status in ((500, 0.36, 0), (1, 0.36, 0), (500, 1e-6, 0), (500, 0.36, 1)):
            f = torch.zeros(ik.LOOP_F, device=card)
            f[ik.F_ANCHOR] = tgeo.se3_exp(torch.tensor([3.0, -1.0, 0.2, 0.01, 0.02, 0.3])).reshape(-1).to(card)
            f[ik.F_T] = args[11].reshape(-1)
            f[ik.F_R_SCAN] = 40.0
            i = torch.tensor([k, 0, status, 7 + k, 100], dtype=torch.int32, device=card)
            fp, ip = f.clone(), i.clone()
            ik.icp_step(s, f, i, max_it, drift_lim)
            ik.icp_step_plain(s, fp, ip, max_it, drift_lim)
            assert torch.equal(f, fp) and torch.equal(i, ip), (k, max_it, drift_lim, status)


@pytest.mark.cuda
def test_icp_ref_step_kernel_matches_plain(card):
    """The reference step kernel against its plain version bit for bit,
    from the same loop state, on the normal equations of the reference
    search on the card (the GN fixture's map and frame): a solve, a
    non-finite solve, a clamped one, a stop at max_iterations and a
    launch on a stopped loop (est the identity)."""
    from sage_icp_tpu_torch.ops import icp_kernel as ik

    world, frame = gn_fixture()
    n = len(world)
    m, _ = thm.insert(thm.create(8192, 8, card), t(world).to(card), torch.ones(n, dtype=torch.bool, device=card),
                      VOXEL, 8, torch.zeros(260, dtype=torch.bool, device=card))
    loop = treg.RefLoop(m, t(frame).to(card), torch.ones(len(frame), dtype=torch.bool, device=card),
                        torch.eye(4, device=card), VOXEL, MAX_CORR, KTH, SEM_TH, 500, 16)
    tgt, accept = thm.get_correspondences(m, loop.source, loop.valid, VOXEL, loop.max_corr, SEM_TH, 16)
    JTJ, JTr = treg.build_normal_equations(loop.source, tgt, accept, loop.kernel)
    ncorr = accept.sum(dtype=torch.int32)
    cases = [(JTJ, JTr), (JTJ * float("nan"), JTr), (JTJ, JTr * 1e6)]
    for k, (A, b) in enumerate(cases):
        for max_it, status in ((500, 0), (1, 0), (500, 1)):
            f = loop.loop_f.clone()
            f[ik.F_T] = tgeo.se3_exp(torch.tensor([0.05, -0.02, 0.01, 0.004, -0.003, 0.006])).reshape(-1).to(card)
            i = torch.tensor([k, 0, status, 7 + k, 100], dtype=torch.int32, device=card)
            fp, ip = f.clone(), i.clone()
            ik.icp_ref_step(A.contiguous(), b.contiguous(), ncorr, f, i, max_it)
            ik.icp_ref_step_plain(A, b, ncorr, fp, ip, max_it)
            assert torch.equal(f, fp) and torch.equal(i, ip), (k, max_it, status)


@pytest.mark.cuda
def test_graph_step_equals_eager_on_card(card):
    """SageICP with the captured step and with the eager one on the
    golden fixture's scans: poses, per-frame iterations, aux totals and
    final maps bit for bit."""
    pts, labs = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(8, step=1.0)
    rng = np.random.default_rng(3)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000) for i in range(8)]
    runs = []
    for graph in (True, False):
        odom = tpl.SageICP(tpl.SageConfig(**GOLDEN_CONFIG), graph=graph)
        for s in scans[:3]:
            odom.register_frame(s)
        odom.register_chunk(scans[3:])
        runs.append(odom)
    on, off = runs
    np.testing.assert_array_equal(on.trajectory(), off.trajectory())
    assert on.icp_iters == off.icp_iters
    for a, b in zip(on.aux_totals(), off.aux_totals()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(on.state.map, off.state.map):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_reference_graph_step_equals_eager_on_card(card):
    """The same with use_fast_correspondences=False (the reference-shaped
    loop, registration.RefLoop): graph = eager bit for bit, and the
    reference step kernel launched in whole blocks, GN and the
    frozen-rows step not at all."""
    pts, labs = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(8, step=1.0)
    rng = np.random.default_rng(3)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000) for i in range(8)]
    cfg = tpl.SageConfig(**dict(GOLDEN_CONFIG, use_fast_correspondences=False))
    runs = []
    for graph in (True, False):
        odom = tpl.SageICP(cfg, graph=graph)
        cuda_lib.reset_launches()
        for s in scans[:3]:
            odom.register_frame(s)
        odom.register_chunk(scans[3:])
        launches = cuda_lib.launches()
        steps = launches["icp_ref_step"]
        assert steps % treg.REF_BLOCK_ITERATIONS == 0 and sum(odom.icp_iters) <= steps
        assert launches["fused_gn_iteration"] == launches["icp_step"] == 0 and launches["apply_policy"] == 8
        runs.append(odom)
    on, off = runs
    assert on._step._graphs is not None and "reanchor" not in on._step._graphs
    np.testing.assert_array_equal(on.trajectory(), off.trajectory())
    assert on.icp_iters == off.icp_iters
    for a, b in zip(on.aux_totals(), off.aux_totals()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(on.state.map, off.state.map):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_gn_kernel_is_one_launch(card):
    args = gn_args(card, 40, 2, R=11_264 // 8, dead_from=1_000)
    tile_map = nn_kernels.default_tile_map(args[10])
    nn_kernels.fused_gn_iteration(*args, tile_map=tile_map)  # the scratch is made on the first call
    names = device_kernels(lambda: nn_kernels.fused_gn_iteration(*args, tile_map=tile_map))
    assert len(names) == 1 and "gn_iteration_kernel" in names[0], names


@pytest.mark.cuda
def test_gn_kernel_refuses_misaligned_planes(card):
    args = gn_args(card, 40, 2, R=64)
    R, M = args[0].shape
    shifted = torch.empty(R * M + 1, dtype=torch.int16, device=card)[1:].view(R, M)
    shifted.copy_(args[0])
    with pytest.raises(ValueError, match="aligned"):
        nn_kernels.fused_gn_iteration(shifted, *args[1:])


def one_launch(wrapper: str, kernel: str, fn):
    """fn() through `wrapper`: one counted launch, and one device kernel,
    `kernel`, when it runs again. Returns the first call's result."""
    cuda_lib.reset_launches()
    out = fn()
    assert cuda_lib.launches()[wrapper] == 1
    names = device_kernels(fn)
    assert len(names) == 1 and kernel in names[0], names
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("Rm", [8, 48])
@pytest.mark.parametrize("K", [8, 20, 40, 64])
def test_policy_kernel_matches_plain(card, K, Rm):
    """U = 1000 rows: not a multiple of the kernel's tile."""
    args = [t(a).to(card) for a in policy_rows(3, U=1000, K=K, Rm=Rm)]
    got = one_launch("apply_policy", "retention_policy_kernel",
                     lambda: policy_kernel.apply_policy(*args, basic=K // 2))
    want = policy_kernel.apply_policy_plain(*args, basic=K // 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("basic", ["zero", "half", "K"])
@pytest.mark.parametrize("K,Rm", [(20, 64), (40, 48), (64, 64), (64, 8)])
def test_policy_kernel_edge_rows(card, K, Rm, basic):
    """Every branch at its edge (policy_edge_rows), basic 0, K / 2 and K,
    U = 209 rows."""
    n_basic = {"zero": 0, "half": K // 2, "K": K}[basic]
    args = [t(a).to(card) for a in policy_edge_rows(4, U=209, K=K, Rm=Rm)]
    got = one_launch("apply_policy", "retention_policy_kernel",
                     lambda: policy_kernel.apply_policy(*args, basic=n_basic))
    want = policy_kernel.apply_policy_plain(*args, basic=n_basic)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[0], args[0])  # some slot was written


@pytest.mark.cuda
def test_policy_kernel_takes_misaligned_planes(card):
    """Planes that are views one element past a 16-byte boundary take the
    kernel's 2-byte copies; the result is the same."""
    args = [t(a).to(card) for a in policy_edge_rows(5, U=209, K=40, Rm=48)]

    def shifted(a):
        if a.dtype != torch.int16:
            return a
        out = torch.empty(a.numel() + 1, dtype=a.dtype, device=card)[1:].view(a.shape)
        return out.copy_(a)

    moved = [shifted(a) for a in args]
    assert all(a.data_ptr() % 16 for a in moved if a.dtype == torch.int16)
    got = one_launch("apply_policy", "retention_policy_kernel",
                     lambda: policy_kernel.apply_policy(*moved, basic=20))
    want = policy_kernel.apply_policy_plain(*args, basic=20)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("K,Rm", [(65, 8), (8, 65)])
def test_policy_kernel_refuses_beyond_its_limits(card, K, Rm):
    args = [t(a).to(card) for a in policy_rows(3, U=64, K=K, Rm=Rm)]
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="the kernel takes"):
        policy_kernel.apply_policy(*args, basic=4)
    assert cuda_lib.launches()["apply_policy"] == 0


@pytest.mark.cuda
def test_register_frame_on_card_matches_cpu(card):
    world, frame = gn_fixture()
    n = len(world)
    fast = dict(unique_voxel_rows=896, queries_per_voxel=8, overflow_rows=128)
    kw = dict(max_correspondence_distance=1.5, kernel=0.5, sem_th=0.5, max_iterations=60, fast_params=fast)
    out = []
    for dev in ("cpu", card):
        m, _ = thm.insert(thm.create(8192, 8, dev), t(world).to(dev), torch.ones(n, dtype=torch.bool, device=dev),
                          1.0, 8, torch.zeros(260, dtype=torch.bool, device=dev))
        out.append(treg.register_frame(m, t(frame).to(dev), torch.ones(n, dtype=torch.bool, device=dev),
                                       torch.eye(4), 1.0, **kw))
    np.testing.assert_allclose(out[1].pose.cpu().numpy(), out[0].pose.numpy(), atol=1e-4)
    assert abs(int(out[1].iterations) - int(out[0].iterations)) <= 1


@pytest.mark.cuda
def test_golden_trajectory_on_card(card):
    pts, labs = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(12, step=1.0)
    rng = np.random.default_rng(3)
    odom = tpl.SageICP(tpl.SageConfig(**GOLDEN_CONFIG))
    cuda_lib.reset_launches()
    for i in range(12):
        odom.register_frame(synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000))
    est = odom.trajectory()
    golden = np.load(GOLDEN_PATH)["poses"]
    assert np.linalg.norm(golden[:, :3, 3] - est[:, :3, 3], axis=-1).max() < 0.02
    assert np.linalg.norm(golden[:, :3, :3] - est[:, :3, :3], axis=(-2, -1)).max() < 0.02
    assert int(odom.aux_totals().overflow_total()) == 0
    # counted on the card by the kernels, the captured step's replays too
    launches = cuda_lib.launches()
    slots = launches["icp_step"]
    assert slots % treg.BLOCK_ITERATIONS == 0 and slots >= 12 * treg.BLOCK_ITERATIONS
    assert launches["fused_gn_iteration"] == slots and sum(odom.icp_iters) <= slots
    assert launches["apply_policy"] == 12


def drive_on_card(config, world, gt, seed=3, corrupt=None):
    """Register rendered scans of `world` along gt on the card; `corrupt`
    maps a frame index to a function applied to that frame's scan.
    Returns (poses, per-frame last_aux list, odom)."""
    pts, labs = world
    rng = np.random.default_rng(seed)
    odom = tpl.SageICP(config)
    auxes = []
    for i in range(len(gt)):
        scan = synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000)
        if corrupt is not None and i in corrupt:
            scan = corrupt[i](scan)
        odom.register_frame(scan)
        auxes.append(odom.last_aux)
    return odom.trajectory(), auxes, odom


def ate(est, gt):
    g0, e0 = np.linalg.inv(gt[0]), np.linalg.inv(est[0])
    err = [np.linalg.norm((e0 @ e)[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(est, gt)]
    return float(np.sqrt(np.mean(np.square(err))))


@pytest.fixture(scope="module")
def small_city():
    return synthetic.build_city_world(seed=2, size=160.0, block=50.0, density=1.6)


def golden_config(**kw):
    return tpl.SageConfig(**{**GOLDEN_CONFIG, **kw})


@pytest.mark.cuda
def test_turn_stop_reverse_on_card(card, small_city):
    """A 90-degree turn over 15 frames, a stop and a reversal (the
    reference suite's maneuver test): ATE < 0.30 m, no motion while
    stopped."""
    gt = synthetic.make_maneuver_trajectory(straight=8, turn=15, stop=3, reverse=6, step=0.75)
    est, _, _ = drive_on_card(golden_config(), small_city, gt)
    assert ate(est, gt) < 0.30
    assert np.linalg.norm(est[25][:3, 3] - est[24][:3, 3]) < 0.10


@pytest.mark.cuda
def test_dense_grid_maneuver_equals_grid_off_on_card(card, small_city):
    """The turn-stop-reverse maneuver with dense_grid on and off: the same
    trajectory bit for bit and the same map slot for slot, and every live
    slot's grid cell holds that slot and its checksum, no other cell a
    slot."""
    gt = synthetic.make_maneuver_trajectory(straight=8, turn=15, stop=3, reverse=6, step=0.75)
    est_on, _, on = drive_on_card(golden_config(dense_grid=True), small_city, gt)
    est_off, _, off = drive_on_card(golden_config(), small_city, gt)
    np.testing.assert_array_equal(est_on, est_off)
    for name in ("keys", "counts", "points", "first_pts"):
        assert torch.equal(getattr(on.state.map, name), getattr(off.state.map, name)), name
    m = on.state.map
    live = torch.nonzero(m.counts > 0)[:, 0]
    cells = thm.grid_index(m.keys[live]).long()
    assert torch.unique(cells).numel() == live.numel()
    assert torch.equal(m.grid[cells], torch.stack([live.to(torch.int32), thm.grid_hi_code(m.keys[live])], -1))
    assert int((m.grid[:, 0] >= 0).sum()) == live.numel()


@pytest.mark.cuda
def test_overflow_counters_fire_when_undersized_on_card(card, small_city):
    gt = synthetic.make_maneuver_trajectory(straight=4, turn=0, stop=0, reverse=0)
    _, auxes, _ = drive_on_card(golden_config(corr_unique_voxel_rows=64, corr_overflow_rows=32), small_city, gt)
    assert int(auxes[-1].corr_dropped) > 0 and int(auxes[-1].overflow_total()) > 0
    _, _, odom = drive_on_card(golden_config(insert_unique_capacity=256, max_incoming_per_voxel=2),
                               small_city, gt)
    assert int(odom.aux_totals().insert_unique_overflow) > 0
    _, _, odom = drive_on_card(golden_config(), small_city, gt)
    assert int(odom.aux_totals().overflow_total()) == 0


@pytest.mark.cuda
def test_recovers_from_garbage_scan_on_card(card, small_city):
    """One scan lifted 25 m costs one frame: the health guard rejects it,
    coasts on the motion model, skips its insert, and the next scans
    re-lock."""
    gt = synthetic.make_trajectory(12, step=1.0)
    bad = 7

    def lift(scan):
        scan = scan.copy()
        scan[:, 2] += 25.0
        return scan

    est, auxes, _ = drive_on_card(golden_config(), small_city, gt, corrupt={bad: lift})
    assert np.isfinite(est).all()
    assert [i for i, a in enumerate(auxes) if int(a.icp_rejected) or int(a.nonfinite_pose)] == [bad]
    for i in range(bad + 1, len(gt)):
        assert np.linalg.norm(est[i][:3, 3] - (gt[i][:3, 3] - gt[0][:3, 3])) < 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 8, 48])
def test_radius_count_kernel_matches_plain(card, P):
    """At the kitti filter's shapes: 4,096 rows of 864 lanes."""
    args = [t(a).to(card) for a in radius_rows(6, R=4096, P=P)] + [0.25]
    cuda_lib.reset_launches()
    got = nn_kernels.radius_count(*args)
    assert cuda_lib.launches()["radius_count"] == 1
    want = nn_kernels.radius_count_plain(*args)
    assert torch.equal(got, want)
    assert float(want.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 48])
@pytest.mark.parametrize("M", [27 * 32, 27 * 32 - 3, 37])
def test_radius_count_kernel_edge_lanes(card, M, P):
    """radius_edge_rows: every slot used, one used slot, lanes at the skip
    margin and at d2 == r2, NaN and infinite lanes and queries, M a
    multiple of 4 and 32, or of neither."""
    args = [t(a).to(card) for a in radius_edge_rows(9, R=512, P=P, M=M)] + [0.25]
    got = one_launch("radius_count", "radius_count_kernel", lambda: nn_kernels.radius_count(*args))
    want = nn_kernels.radius_count_plain(*args)
    assert torch.equal(got, want)
    assert float(want.max()) > 0


def sort_case(seed, n, n_planes, unsigned, tied):
    """Planes (numpy), num_keys and flags for a sort of n_planes planes.
    Untied: the composite key is distinct (an iota key, or for one plane
    distinct values). Tied: duplicated keys and no iota key, so the
    network's copy-over shows in the payload."""
    k1, k2, iota, pay = sort_planes(seed, n, unsigned)
    rng = np.random.default_rng(seed + 1)
    if n_planes == 1:
        distinct = (np.arange(n, dtype=np.uint64) * 2654435761 % 2**32).astype(np.uint32).view(np.int32)
        keys = [k1 if tied else rng.permutation(distinct)]
    elif n_planes == 2:
        keys = [k1] if tied else [k1, iota]
    else:
        keys = [k1, k2] if tied else [k1, k2, iota]
    planes = keys + ([iota] if tied and n_planes > 1 else []) + [pay]
    while len(planes) < n_planes:
        planes.append(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    planes = planes[:n_planes]
    return planes, len(keys), tuple(unsigned for _ in keys)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("n", [256, 512, 2**17, 2**18])
@pytest.mark.parametrize("n_planes", [1, 2, 4, 16])
def test_bitonic_kernel_matches_plain(card, n_planes, n, unsigned, tied):
    """Bit for bit against the network itself (bitonic_network_plain),
    and under the contract (untied) against the stable sort; inputs
    untouched. The kernel's tile T is the largest up to 2^11 that leaves
    64 tiles, at least 256: N 256 is one launch (N = T), N 512 one merge
    past its tile (2T), N 2^17 the first with the full tile, and 2^18."""
    planes, num_keys, flags = sort_case(8, n, n_planes, unsigned, tied)
    planes = [t(a).to(card) for a in planes]
    before = [p.clone() for p in planes]
    got = sort_kernel.bitonic_sort_planes(planes, num_keys, flags)
    want = sort_kernel.bitonic_network_plain(planes, num_keys, flags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not tied:
        plain = sort_kernel.bitonic_sort_planes_plain(planes, num_keys, flags)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert all(torch.equal(a, b) for a, b in zip(planes, before))
    assert not torch.equal(got[0], planes[0])


@pytest.mark.cuda
@pytest.mark.parametrize("num_keys", [4, 5, 16])
def test_bitonic_kernel_many_keys(card, num_keys):
    """Key counts past the three of the main path (the kernel's 4-, 8- and
    16-key instances): low-cardinality keys, an iota last key, at N 2^14
    (global passes included); bit for bit against both plain versions."""
    rng = np.random.default_rng(num_keys)
    n = 2**14
    keys = [rng.integers(0, 3, n).astype(np.int32) for _ in range(num_keys - 1)] + [np.arange(n, dtype=np.int32)]
    planes = [t(a).to(card) for a in keys + [rng.normal(size=n).astype(np.float32)]][:16]
    flags = tuple(bool(i % 2) for i in range(num_keys))
    got = sort_kernel.bitonic_sort_planes(planes, num_keys, flags)
    for want in (sort_kernel.bitonic_network_plain(planes, num_keys, flags),
                 sort_kernel.bitonic_sort_planes_plain(planes, num_keys, flags)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sort_kernel.bitonic_launches(n, num_keys) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2**16, 2**18])
def test_bitonic_kernel_launches(card, n):
    """The launches a call makes are the ones bitonic_launches counts:
    one at N 256 (one tile), 15 at 2^16 (tile 2^10) and 18 at 2^18 (tile
    2^11), well below the 171 stages at 2^18."""
    planes, num_keys, flags = sort_case(9, n, 4, True, False)
    planes = [t(a).to(card) for a in planes]
    n_launch = sort_kernel.bitonic_launches(n, num_keys)
    assert n_launch == {256: 1, 2**16: 15, 2**18: 18}[n]
    names = device_kernels(lambda: sort_kernel.bitonic_sort_planes(planes, num_keys, flags))
    assert len([name for name in names if "bitonic" in name]) == n_launch
    got = sort_kernel.bitonic_sort_planes(planes, num_keys, flags)
    want = sort_kernel.bitonic_sort_planes_plain(planes, num_keys, flags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_dynamic_filter_on_card_matches_cpu(card):
    """One kitti-capacity frame, preprocessed as the step does."""
    cfg = tpl.PRESETS["kitti"]
    buf, valid = pad_scan(city_frame(kitti_world()), cfg.scan_capacity)
    out = []
    for dev in ("cpu", card):
        pts, ok = tscan.preprocess(t(buf).to(dev), t(valid).to(dev), cfg.max_range, cfg.min_range,
                                   cfg.label_max_range)
        out.append([a.cpu() for a in tdyn.filter_dynamic_vehicles(pts, ok, cfg)])
    assert torch.equal(out[1][1], out[0][1])
    assert torch.equal(out[1][0], out[0][0])
    assert int(out[1][2]) == int(out[0][2])


def diffusion_case(name):
    """(vk on the CPU, nx) of a case of the min-diffusion test: the
    filter's vehicle sort keys of a scan, or keys written out."""
    cfg = tpl.PRESETS[name] if name in tpl.PRESETS else tpl.PRESETS["kitti"]
    nx = tdyn._grid_nx(cfg.label_max_range)
    vk = torch.full((tdyn._VEH_PTS_CAP,), tdyn._BIG, dtype=torch.int32)
    if name == "one":  # three points in one cell
        vk[:3] = (100 * nx + 100) * tdyn._GRID_NZ + 16
    elif name == "cap":  # a solid 32 x 32 x 16 block: 16,384 distinct cells
        x, y, z = np.meshgrid(np.arange(88, 120), np.arange(88, 120), np.arange(8, 24), indexing="ij")
        vk = torch.from_numpy(np.sort(((x * nx + y) * tdyn._GRID_NZ + z).ravel()).astype(np.int32))
    elif name != "empty":
        scan = {"parked_moving": parked_moving_scan, "car_row": car_row_scan}.get(name)
        buf, valid = scan() if scan else pad_scan(city_frame(kitti_world()), cfg.scan_capacity)
        vk = vehicle_keys(t(buf), t(valid), cfg)
    return vk, nx


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "one", "parked_moving", "car_row", "cap", "kitti360", "kitti_raw",
                                  "kitti_drive"])
def test_min_diffusion_kernel_matches_plain(card, case):
    """The min-diffusion kernel (csrc/min_diffusion.cu) against the dense
    plain version bit for bit in one launch, and its two counts in the
    recorder's frame row against diffusion_replay: no vehicle cell, one
    cell, the parked and moving cars, a row longer than the round cut,
    16,384 distinct cells, the city frame at the kitti360 and kitti_raw
    presets. On the kitti drive (SageICP()) it runs once a frame, no
    max_pool3d kernel runs, and every frame's counts are the replay's."""
    if case == "kitti_drive":
        world = kitti_world()
        gt = synthetic.make_trajectory(4, step=1.0)
        rng = np.random.default_rng(0)
        scans = [synthetic.render_scan(*world, gt[i], rng, n_target=120_000) for i in range(4)]
        odom = tpl.SageICP()
        cuda_lib.reset_launches()
        for s in scans[:3]:
            odom.register_frame(s)
        assert cuda_lib.launches()["min_diffusion"] == 3
        names = device_kernels(lambda: odom.register_frame(scans[3]))  # three more frames of the last scan
        assert any("min_diffusion_kernel" in n for n in names) and not any("max_pool3d" in n for n in names)
        frames = tracing.RECORDER.read().frames_of([odom.drive])
        nx = tdyn._grid_nx(odom.config.label_max_range)
        assert len(frames) == 6
        for f, s in zip(frames, scans[:3] + [scans[3]] * 3):
            pts, valid, _ = tpl._split_packed(torch.from_numpy(odom.pad_chunk([s])[0]))
            _, cells, rounds = diffusion_replay(vehicle_keys(pts, valid, odom.config).numpy(), nx)
            assert (f.vehicle_cells, f.diffusion_rounds) == (cells, rounds) and cells > 0
        return
    vk, nx = diffusion_case(case)
    want = tdyn.cluster_ids_plain(vk, nx)
    replay, cells, rounds = diffusion_replay(vk.numpy(), nx)
    assert np.array_equal(want.numpy(), replay)
    cuda_lib.reset_launches()
    got, record = recorded(card, lambda: tdyn.cluster_ids(vk.to(card), nx))
    assert torch.equal(got.cpu(), want) and cuda_lib.launches()["min_diffusion"] == 1
    assert (record.vehicle_cells, record.diffusion_rounds) == (cells, rounds)
    ids = np.unique(replay[replay < nx * nx * tdyn._GRID_NZ])
    expect = dict(empty=(0, 0, 0), one=(1, 0, 1), car_row=(90, 24, 21), cap=(16384, 24, None))
    if case in expect:
        assert (cells, rounds, None if case == "cap" else len(ids)) == expect[case]
    else:
        assert cells > 1 and rounds > 0


@pytest.fixture(scope="module")
def drive_planes():
    """candidate_planes' arguments at a kitti frame's rows: SageICP() over
    three scans of the kitti-scale drive, then the fourth scan's row build
    at the guess (the call corr_setup makes in run_icp, kept by a spy),
    its counter left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = kitti_world()
    gt = synthetic.make_trajectory(4, step=1.0)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(*world, gt[i], rng, n_target=120_000) for i in range(4)]
    odom = tpl.SageICP()
    for s in scans[:3]:
        odom.register_frame(s)
    cfg, dev = odom.config, odom.device
    pts, valid, ts = tpl._split_packed(torch.from_numpy(odom.pad_chunk([scans[3]])[0]).to(dev))
    prep = tpl.prepare_icp_inputs(odom.state, pts, valid, ts, cfg)
    seen, real = [], tcf.candidate_planes
    tcf.candidate_planes = lambda *a: seen.append(a) or real(*a)
    try:
        tpl.run_icp(odom.state.map, prep, cfg)
    finally:
        tcf.candidate_planes = real
    return seen[0][:5], cfg.corr_unique_voxel_rows


def crowded_map(K, cap=512, depth=12, seed=0):
    """A cap-slot map filled by probing, as the insert places voxels: the
    keys of a 16 x 16 x 2 voxel patch round `center`, each at the first
    free slot of its probe sequence (dropped when all `depth` are taken),
    random blocks. Returns (the map, center, the keys' rel voxels, each
    key's depth; -1 where dropped)."""
    rng = np.random.default_rng(seed)
    center = np.array([100, -50, 7], dtype=np.int32)
    ii, jj, kk = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), np.arange(-1, 1), indexing="ij")
    rel = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], 1).astype(np.int32)
    rel = rel[rng.permutation(len(rel))]
    state = thm.create(cap, K)
    state.points.copy_(torch.from_numpy(rng.integers(-32767, 32768, (cap, 4, K)).astype(np.int16)))
    h = thm.hash_keys(torch.from_numpy(rel + center), cap).numpy()
    taken, depths = np.zeros(cap, bool), []
    for key, hk in zip(rel + center, h):
        free = [d for d in range(depth) if not taken[(hk + d * (d + 1) // 2) % cap]]
        depths.append(free[0] if free else -1)
        if free:
            slot = (hk + free[0] * (free[0] + 1) // 2) % cap
            taken[slot] = True
            state.keys[slot] = torch.from_numpy(key)
            state.counts[slot] = K
    return state, center, rel, np.array(depths), h


def planes_case(case, K, drive):
    """(candidate_planes' arguments on the card, grid_hits or None) of a
    case of test_corr_planes_kernel_matches_plain."""
    if case in ("kitti_drive", "overflow_rows", "three_ranks"):
        (tables, rel, live, k, depth), Q = drive
        assert k == K
        if case == "overflow_rows":
            rel, live = rel[Q:], live[Q:]
        return (tables, rel, live, K, depth), None
    depth = 12
    rng = np.random.default_rng(K)
    state, center, keys_rel, depths, h = crowded_map(K, depth=depth)
    if case == "last_depth_wrap":
        slots = (h + np.maximum(depths, 0) * (np.maximum(depths, 0) + 1) // 2) % 512
        assert (depths == depth - 1).any() and ((depths >= 0) & (slots < h)).any()
    if case == "empty_map":
        state = thm.create(512, K)
    rows = np.concatenate([keys_rel + rng.integers(-1, 2, keys_rel.shape), rng.integers(-12, 12, (300, 3)),
                           [[255, 0, 0], [-255, 3, 1], [0, 254, -255]]]).astype(np.int32)
    live = rng.random(len(rows)) < 0.85
    if case == "dead_rows":
        live[:] = False
    rows[~live] = 0
    dev = torch.device("cuda")
    tables = tcf.build_probe_tables(thm.MapState(*(x.to(dev) for x in state[:4])), torch.from_numpy(center).to(dev),
                                    depth)
    rel_t, live_t = torch.from_numpy(rows).to(dev), torch.from_numpy(live).to(dev)
    grid_hits = None
    if case == "dense_grid":
        found = torch.from_numpy(rng.random((len(rows), 27)) < 0.5).to(dev) & live_t[:, None]
        grid_hits = (found, torch.from_numpy(rng.integers(0, 512, (len(rows), 27)).astype(np.int32)).to(dev))
    return (tables, rel_t, live_t, K, depth), grid_hits


@pytest.mark.cuda
@pytest.mark.parametrize("case,K", [("kitti_drive", 40), ("overflow_rows", 40), ("three_ranks", 40),
                                    ("empty_map", 20), ("empty_map", 40), ("dead_rows", 20), ("dead_rows", 40),
                                    ("last_depth_wrap", 20), ("last_depth_wrap", 40), ("last_depth_wrap", 10),
                                    ("last_depth_wrap", 7), ("dense_grid", 20), ("dense_grid", 40)])
def test_corr_planes_kernel_matches_plain(card, drive_planes, case, K):
    """The candidate planes' kernel (csrc/corr_planes.cu) against
    candidate_planes_plain on the card, all four planes bit for bit (slot
    0's block in lanes not found, -1 in their labels), in one launch, with
    the same found pairs: the kitti drive's rows, its overflow rows and a
    three-rank split of them (each share as corr_setup's `rows` takes it,
    the shares together the whole); a probed map with matches at the last
    probe depth and windows that wrap at the capacity, an empty map, rows
    all dead, and the dense grid's given hits, at K = 7, 10, 20 and 40
    (store widths 2, 4, 8 and 16 B)."""
    args, grid_hits = planes_case(case, K, drive_planes)
    pieces = [(0, args[1].shape[0])]
    if case == "three_ranks":
        R = args[1].shape[0]
        pieces = [(r * R // 3, (r + 1) * R // 3) for r in range(3)]
    whole = tcf.candidate_planes_plain(*args, grid_hits)
    for lo, hi in pieces:
        share = (args[0], args[1][lo:hi], args[2][lo:hi], *args[3:])
        hits = None if grid_hits is None else tuple(x[lo:hi] for x in grid_hits)
        got_pairs, want_pairs = (torch.zeros((), dtype=torch.int32, device=card) for _ in range(2))
        cuda_lib.reset_launches()
        got = tcf.candidate_planes(*share, hits, got_pairs)
        assert cuda_lib.launches()["corr_planes"] == 1
        want = tcf.candidate_planes_plain(*share, hits, want_pairs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b[lo:hi]) for a, b in zip(got, whole))
        assert int(got_pairs) == int(want_pairs)
    found = int((whole[3] >= 0).sum())
    if case in ("empty_map", "dead_rows"):
        assert int(want_pairs) == 0 and found == 0
    else:
        assert int(want_pairs) > 0
    if case == "kitti_drive":
        names = device_kernels(lambda: tcf.candidate_planes(*args))
        assert len(names) == 1 and "corr_planes_kernel" in names[0], names


@pytest.mark.cuda
def test_corr_planes_kernel_refuses_misaligned_or_mistyped_inputs(card, drive_planes):
    (tables, rel, live, K, depth), _ = drive_planes
    p2 = tables.points2
    shifted = torch.empty(p2.numel() + 1, dtype=torch.int16, device=card)[1:].view(p2.shape)
    shifted.copy_(p2)
    with pytest.raises(ValueError, match="aligned"):
        tcf.candidate_planes(tables._replace(points2=shifted), rel, live, K, depth)
    with pytest.raises(ValueError, match="int32"):
        tcf.candidate_planes(tables, rel.long(), live, K, depth)
    with pytest.raises(ValueError, match="bool"):
        tcf.candidate_planes(tables, rel, live.to(torch.uint8), K, depth)
    with pytest.raises(ValueError, match="shape"):
        tcf.candidate_planes(tables, rel, live, K, depth + 1)


@pytest.mark.cuda
def test_staged_uploads_step_the_same_poses_on_card(card):
    """SageICP stages its scans in pinned buffers and uploads them without
    waiting. A kitti-shaped 40-frame drive (SageICP()) steps the same poses
    and iterations, bit for bit, through register_frame with block=True,
    register_frame with block=False call after call (each pad waits on the
    last upload's event), and register_chunk on lists of 8 scans; the
    staging buffers are pinned, and each is made at its first call only."""
    world = kitti_world()
    gt = synthetic.make_trajectory(40, step=1.0)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(*world, gt[i], rng, n_target=120_000) for i in range(40)]
    chunks = [scans[i:i + 8] for i in range(0, 40, 8)]
    runs = {}
    for way in ("block", "no_block", "chunk"):
        odom = tpl.SageICP()
        if way in ("block", "no_block"):
            held = [odom.register_frame(s, block=way == "block") for s in scans]
            assert all(torch.is_tensor(p) != (way == "block") for p in held)
        for c in chunks if way == "chunk" else ():
            odom.register_chunk(c)
        runs[way] = odom.trajectory(), odom.iteration_counts()
        frames = tracing.RECORDER.read().frames_of([odom.drive])
        made = {"block": [1] + [0] * 39, "no_block": [1] + [0] * 39, "chunk": [2] + [0] * 39}[way]
        assert [f.staging_buffers for f in frames] == made, (way, [f.staging_buffers for f in frames])
        if way == "chunk":  # a host buffer and its device twin
            st = odom._staging[(8, 4, torch.float32)]
            assert st.host.is_pinned() and st.device.device.type == "cuda"
    for way in ("no_block", "chunk"):
        np.testing.assert_array_equal(runs[way][0], runs["block"][0])
        np.testing.assert_array_equal(runs[way][1], runs["block"][1])
    assert torch.from_numpy(odom.pad_chunk(scans[:1])).is_pinned()


@pytest.mark.cuda
def test_kitti_default_preset_on_card(card):
    """SageICP() is the production kitti preset: five frames of the
    kitti-scale drive, the filter's kernel once per frame, no drop."""
    world = kitti_world()
    odom = tpl.SageICP()
    assert odom.config == tpl.PRESETS["kitti"] and odom.device.type == "cuda"
    cuda_lib.reset_launches()
    gt = synthetic.make_trajectory(5, step=1.0)
    rng = np.random.default_rng(0)
    for i in range(5):
        odom.register_frame(synthetic.render_scan(*world, gt[i], rng, n_target=120_000))
    assert int(odom.aux_totals().overflow_total()) == 0
    launches = cuda_lib.launches()
    assert launches["radius_count"] == 5 and launches["apply_policy"] == 5
    g0 = np.linalg.inv(gt[0])
    err = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(odom.trajectory(), gt)]
    assert max(err) < 0.05


# The kitti preset's prepare graph (deskew off): its nodes since the row
# build's probe, gathers, permute and mask became one launch of
# csrc/corr_planes.cu, 986 before (torch 2.11.0+cu128 on an H100).
KITTI_PREPARE_NODES = 920


def graph_nodes(graph) -> int:
    """The nodes of a CUDA graph captured with keep_graph=True: libcuda's
    cuGraphGetNodes on its cudaGraph_t."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n)) == 0
    return n.value


@pytest.mark.cuda
def test_kitti_prepare_graph_keeps_its_nodes(card, small_city, monkeypatch):
    """The kitti preset's captured prepare graph holds KITTI_PREPARE_NODES
    nodes; with deskew on it holds more (the deskew, its count and the
    deskew stage's stamp)."""
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: real(keep_graph=True))
    scan = synthetic.render_scan(*small_city, synthetic.make_trajectory(1, step=1.0)[0], np.random.default_rng(0),
                                 n_target=20_000)
    nodes = {}
    for deskew in (False, True):
        odom = tpl.SageICP(dataclasses.replace(tpl.PRESETS["kitti"], deskew=deskew))
        odom.register_frame(scan)
        nodes[deskew] = graph_nodes(odom._step._graphs["prepare"])
    assert nodes[False] == KITTI_PREPARE_NODES and nodes[True] > nodes[False]


def skewed_city_drive(world, frames=12, step=2.0):
    """tests/test_robustness.py's deskew drive: scans skewed by their
    frame's motion over the azimuth sweep phase."""
    gt = synthetic.make_trajectory(frames, step=step, accel_frames=4)
    rng = np.random.default_rng(5)
    scans, tss = [], []
    for i in range(frames):
        scan = synthetic.render_scan(*world, gt[i], rng, n_target=14000)
        nxt = gt[min(i + 1, frames - 1)]
        delta = tgeo.se3_log(torch.as_tensor(np.linalg.inv(gt[i]) @ nxt, dtype=torch.float32)).numpy()
        ts = azimuth_timestamps(scan[:, :3])
        scans.append(synthetic.skew_scan(scan, delta, ts))
        tss.append(ts)
    return scans, tss, gt


@pytest.mark.cuda
def test_deskew_reduces_ate_on_card(card, small_city):
    """test_deskew_reduces_ate_on_distorted_scans on the card: on < 0.7 x
    off, on < 0.10 m, no drop."""
    scans, tss, gt = skewed_city_drive(small_city)
    ates = {}
    for deskew in (False, True):
        odom = tpl.SageICP(golden_config(deskew=deskew))
        for s, ts in zip(scans, tss):
            odom.register_frame(s, ts)
        assert int(odom.aux_totals().overflow_total()) == 0
        ates[deskew] = ate(odom.trajectory(), gt)
    assert ates[True] < 0.7 * ates[False] and ates[True] < 0.10, ates


@pytest.mark.cuda
def test_deskew_gate_on_card(card, small_city):
    """SageICP(device=None) with deskew on: frames 0-2 run undeskewed (the
    poses equal a deskew-off run's bit for bit), frame 3 deskews
    (num_poses > 2)."""
    scans, tss, _ = skewed_city_drive(small_city, frames=4)
    on, off = tpl.SageICP(golden_config(deskew=True)), tpl.SageICP(golden_config())
    assert on.device.type == "cuda"
    poses = [(on.register_frame(s, ts), off.register_frame(s, ts)) for s, ts in zip(scans, tss)]
    for a, b in poses[:3]:
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(*poses[3])


@pytest.mark.cuda
def test_chunked_equals_per_frame_on_card(card):
    pts, labs = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(6, step=0.8)
    rng = np.random.default_rng(7)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=6000) for i in range(6)]
    a, b = tpl.SageICP(golden_config()), tpl.SageICP(golden_config())
    for s in scans:
        a.register_frame(s)
    b.register_chunk(scans[:3])
    b.register_chunk(scans[3:])
    np.testing.assert_allclose(a.trajectory(), b.trajectory(), atol=1e-5)
    np.testing.assert_array_equal(a.iteration_counts(), b.iteration_counts())
    assert int(b.aux_totals().overflow_total()) == 0


@pytest.mark.cuda
def test_checkpoint_resume_on_card(card, small_city, tmp_path):
    """Save after 6 of 12 deskewed frames, load into a fresh SageICP, run
    the rest: the trajectory and the map of the uninterrupted run."""
    from sage_icp_tpu_torch.models.state_io import state_to_numpy
    from sage_icp_tpu_torch.runtime.checkpoint import load_state, save_state

    scans, tss, _ = skewed_city_drive(small_city)
    cfg = golden_config(deskew=True)
    whole, first = tpl.SageICP(cfg), tpl.SageICP(cfg)
    for s, ts in zip(scans, tss):
        whole.register_frame(s, ts)
    for s, ts in zip(scans[:6], tss[:6]):
        first.register_frame(s, ts)
    save_state(str(tmp_path / "state.npz"), first)
    resumed = load_state(str(tmp_path / "state.npz"), tpl.SageICP(cfg))
    for s, ts in zip(scans[6:], tss[6:]):
        resumed.register_frame(s, ts)
    np.testing.assert_allclose(resumed.trajectory(), whole.trajectory(), atol=1e-5)
    a, b = state_to_numpy(resumed.state), state_to_numpy(whole.state)
    for k in a:
        if k.startswith("map."):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def tiny_scans():
    """tests/test_parallel.py's world, trajectory and seed: 3 frames."""
    pts, labs = synthetic.build_world(seed=1, length=60.0)
    gt = synthetic.make_trajectory(3, step=0.5)
    rng = np.random.default_rng(0)
    return [synthetic.render_scan(pts, labs, gt[i], rng, n_target=3000) for i in range(3)]


@pytest.mark.cuda
def test_nccl_world_of_one_equals_sage_icp_on_card(card, tmp_path):
    """ShardedSageICP() over NCCL at world size 1: captured by default
    (its collectives in the graphs), and eager with graph=False, each
    equal to the captured SageICP bit for bit (trajectory, iterations,
    totals, map); the kernels' launches counted on the card."""
    import torch.distributed as dist

    from sage_icp_tpu_torch.parallel.distributed import init_distributed
    from sage_icp_tpu_torch.parallel.sharding import ShardedSageICP

    cfg = tpl.SageConfig(**TINY_CONFIG)
    single = tpl.SageICP(cfg)
    mesh = init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cuda:0", timeout_s=120)
    sharded = ShardedSageICP(cfg, mesh)
    eager = ShardedSageICP(cfg, mesh, graph=False)
    try:
        assert dist.get_backend() == "nccl" and mesh.backend == "nccl" and mesh.captures
        assert sharded.graph and not eager.graph
        cuda_lib.reset_launches()
        for s in tiny_scans():
            single.register_frame(s)
            sharded.register_frame(s)
            eager.register_frame(s)
        assert sharded._step._graphs is not None
    finally:
        sharded.release()  # NCCL waits for the graphs that hold its kernels
        dist.destroy_process_group()
    for odom in (sharded, eager):
        np.testing.assert_array_equal(odom.trajectory(), single.trajectory())
        assert odom.icp_iters == single.icp_iters
        for a, b in zip(odom.aux_totals(), single.aux_totals()):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(odom.state.map, single.state.map):
            assert (a is None and b is None) or torch.equal(a, b)
    launches = cuda_lib.launches()
    slots = launches["icp_step"]
    assert slots % treg.BLOCK_ITERATIONS == 0 and 3 * sum(single.icp_iters) <= slots
    assert launches["fused_gn_iteration"] == slots and launches["apply_policy"] == 9


@pytest.mark.cuda
def test_sage_icp_on_a_card_that_is_not_current(card):
    """SageICP on cuda:1 while cuda:0 is current: the step makes its own
    device current (launches, captures and the status read on cuda:1's
    stream), so it equals the same drive on cuda:0 bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    runs = []
    for dev in ("cuda:0", "cuda:1"):
        torch.cuda.set_device(0)
        odom = tpl.SageICP(tpl.SageConfig(**TINY_CONFIG), device=dev)
        for s in tiny_scans():
            odom.register_frame(s)
        runs.append(odom)
    assert torch.cuda.current_device() == 0
    np.testing.assert_array_equal(runs[1].trajectory(), runs[0].trajectory())
    assert runs[1].icp_iters == runs[0].icp_iters
    for a, b in zip(runs[1].state.map, runs[0].state.map):
        assert (a is None and b is None) or torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_two_ranks_sharing_the_card(card, tmp_path):
    """Two parallel.worker processes on cuda:0 over gloo (NCCL refuses two
    ranks on one device), on the tiny config: equal to each other bit for
    bit, maps slot for slot, within 5e-4 of SageICP on the card
    (test_sharded_step_matches_single_device's bound), healthy; each rank
    ran GN on 320 of the 640 rows in every slot of every block of ICP
    iterations and the policy on 1,024 of the 2,048 rows every frame, on
    the card."""
    scans = tiny_scans()
    poses, maps, reports = two_worker_ranks(tmp_path, scans, "gloo", ("cuda:0", "cuda:0"))
    single = tpl.SageICP(tpl.SageConfig(**TINY_CONFIG))
    for s in scans:
        single.register_frame(s)
    np.testing.assert_array_equal(poses[0], poses[1])
    for k in maps[0]:
        np.testing.assert_array_equal(maps[0][k], maps[1][k])
    np.testing.assert_allclose(poses[0], single.trajectory(), atol=5e-4)
    n = len(scans)
    for rep in reports:
        assert rep["graph"] is False and rep["backend"] == "gloo"
        slots = rep["launches"]["icp_step"]
        assert slots % treg.BLOCK_ITERATIONS == 0 and slots >= n * treg.BLOCK_ITERATIONS
        assert rep["aux_totals"]["nonfinite_pose"] == 0 and sum(rep["icp_iterations"]) <= slots
        assert rep["kernel_rows"] == {"fused_gn_iteration": {"320": slots}, "apply_policy": {"1024": n},
                                      "radius_count": {}}  # the tiny config has no filter
        assert rep["launches"]["fused_gn_iteration"] == slots and rep["launches"]["apply_policy"] == n


def two_worker_ranks(tmp_path, scans, backend: str, devices):
    """Two parallel.worker processes over `backend`, rank r on devices[r],
    on the tiny config; both must exit 0 within 180 s (ranks out of step
    wait on each other: they are killed then, not left hanging). Returns
    their trajectories, final maps and reports."""
    import json
    import subprocess
    import sys
    import time

    from sage_icp_tpu_torch.parallel.worker import save_scans

    root = pathlib.Path(__file__).resolve().parents[1]
    save_scans(str(tmp_path / "scans.npy"), scans)
    (tmp_path / "config.json").write_text(json.dumps(TINY_CONFIG))
    cmds = [[sys.executable, "-m", "sage_icp_tpu_torch.parallel.worker", "--rank", str(r), "--world", "2",
             "--init", f"file://{tmp_path / 'rendezvous'}", "--backend", backend, "--device", devices[r],
             "--preset", "kitti", "--config", str(tmp_path / "config.json"), "--scans", str(tmp_path / "scans.npy"),
             "--out", str(tmp_path), "--timeout", "120"] for r in range(2)]
    procs = [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    deadline, logs = time.monotonic() + 180, []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n(killed after 180 s)")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return ([np.load(tmp_path / f"poses_{r}.npy") for r in range(2)],
            [dict(np.load(tmp_path / f"map_{r}.npz")) for r in range(2)],
            [json.loads((tmp_path / f"rank_{r}.json").read_text()) for r in range(2)])


@pytest.mark.cuda
def test_two_nccl_ranks_on_two_cards_captured(card, tmp_path):
    """Two parallel.worker processes over NCCL, one card each, their steps
    captured (the GN-sum and insert gathers inside the graphs), on the
    tiny config: equal to each other bit for bit, maps slot for slot,
    within 5e-3 m of SageICP on one card (chip_smoke.py phase 10's bound:
    only the order in which the two halves' GN sums are added differs);
    the kernels' launches counted on each card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL refuses two ranks on one card")
    scans = tiny_scans()
    poses, maps, reports = two_worker_ranks(tmp_path, scans, "nccl", ("cuda:0", "cuda:1"))
    single = tpl.SageICP(tpl.SageConfig(**TINY_CONFIG))
    for s in scans:
        single.register_frame(s)
    np.testing.assert_array_equal(poses[0], poses[1])
    for k in maps[0]:
        np.testing.assert_array_equal(maps[0][k], maps[1][k])
    assert np.isfinite(poses[0]).all()
    np.testing.assert_allclose(poses[0][:, :3, 3], single.trajectory()[:, :3, 3], atol=5e-3)
    n = len(scans)
    for rep in reports:
        assert rep["graph"] is True and rep["backend"] == "nccl"
        slots = rep["launches"]["icp_step"]
        assert slots % treg.BLOCK_ITERATIONS == 0 and slots >= n * treg.BLOCK_ITERATIONS
        assert sum(rep["icp_iterations"]) <= slots and rep["aux_totals"]["nonfinite_pose"] == 0
        assert rep["launches"]["fused_gn_iteration"] == slots and rep["launches"]["apply_policy"] == n
        assert set(rep["kernel_rows"]["fused_gn_iteration"]) == {"320"}
        assert set(rep["kernel_rows"]["apply_policy"]) == {"1024"}
