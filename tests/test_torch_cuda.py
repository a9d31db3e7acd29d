"""The port on the card: each CUDA kernel against its plain PyTorch
version, the ICP solve and the dynamic-vehicle filter against the port on
the CPU, the odometry step on the reference suite's trajectories
(golden fixture, turn-stop-reverse maneuver, undersized capacities, a
garbage scan, motion-skewed scans with deskew on and off) and on the
default `kitti` preset, the deskew gate, the chunked step against single
frames and a checkpoint resume. This file imports no
JAX, so it runs where only PyTorch is installed (tests/conftest.py
imports jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Without a CUDA device every test skips. Tolerances: the retention policy,
the semantic NN, the radius count and the bitonic sort (against the
network run stage by stage, and under its contract against the stable
sort) bit for bit; the GN kernel in one launch and deterministic; the
filter's keep mask and overflow bit for bit; the GN sums within 1e-5 of
the sum of their terms' magnitudes (only the summation order differs);
poses within 1e-4 of the CPU run; the golden trajectory within
0.02 m / 0.02; the maneuver ATE below 0.30 m and re-lock after a garbage
scan within 0.25 m, deskew on below 0.7x off and 0.10 m, as in
tests/test_robustness.py; chunked against single frames within 1e-5
(tests/test_pipeline.py); a resumed run within 1e-5 m of the
uninterrupted one, its map equal slot for slot; the sharded step at
world size 1 over NCCL equal to SageICP bit for bit, two ranks sharing
the card over gloo equal to each other bit for bit and within 5e-4 of
SageICP (tests/test_parallel.py's bound).

The seeded input builders here are shared with tests/test_torch_kernels.py
and tests/test_torch_dynfilter.py.
"""

import pathlib

import numpy as np
import pytest
import torch

from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import correspondence_fast as tcf
from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels, policy_kernel, sort_kernel
from sage_icp_tpu_torch.ops import dynamic_filter as tdyn
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import registration as treg
from sage_icp_tpu_torch.ops import scan as tscan
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
    host, as the ICP loop passes it."""
    d = nn_rows(seed, R=R, P=P, K=K, dead_from=dead_from)
    T = tgeo.se3_exp(torch.tensor([0.05, -0.02, 0.01, 0.004, -0.003, 0.006]))
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
    assert cuda_lib.LAUNCHES["fused_gn_iteration"] == 1
    terms = nn_kernels.gn_terms(*args, tile_map)
    want = terms.sum(dim=1)
    assert torch.all((got - want).abs() <= 1e-5 * terms.abs().sum(dim=1) + 1e-6)
    assert float(got[16]) > 0 and float(got[17]) == float(want[17])
    # the reduction is deterministic, and the ticket counter is reset
    assert torch.equal(got, nn_kernels.fused_gn_iteration(*args, tile_map=tile_map))


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
    assert cuda_lib.LAUNCHES[wrapper] == 1
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
    assert cuda_lib.LAUNCHES["apply_policy"] == 0


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
    assert abs(out[1].iterations - out[0].iterations) <= 1


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
    assert cuda_lib.LAUNCHES["fused_gn_iteration"] == sum(odom.icp_iters)
    assert cuda_lib.LAUNCHES["apply_policy"] == 12


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
    assert cuda_lib.LAUNCHES["radius_count"] == 1
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
    assert cuda_lib.LAUNCHES["radius_count"] == 5
    assert cuda_lib.LAUNCHES["apply_policy"] == 5
    g0 = np.linalg.inv(gt[0])
    err = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(odom.trajectory(), gt)]
    assert max(err) < 0.05


def skewed_city_drive(world, frames=12, step=2.0):
    """tests/test_robustness.py's deskew drive: scans skewed by their
    frame's motion over the azimuth sweep phase."""
    from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps

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
    import torch.distributed as dist

    from sage_icp_tpu_torch.parallel.distributed import init_distributed
    from sage_icp_tpu_torch.parallel.sharding import ShardedSageICP

    cfg = tpl.SageConfig(**TINY_CONFIG)
    single = tpl.SageICP(cfg)
    mesh = init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cuda:0", timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        sharded = ShardedSageICP(cfg, mesh)
        cuda_lib.reset_launches()
        for s in tiny_scans():
            single.register_frame(s)
            sharded.register_frame(s)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(sharded.trajectory(), single.trajectory())
    for a, b in zip(sharded.state.map, single.state.map):
        assert (a is None and b is None) or torch.equal(a, b)
    iters = sum(single.icp_iters) + sum(sharded.icp_iters)
    assert cuda_lib.LAUNCHES["fused_gn_iteration"] == iters and cuda_lib.LAUNCHES["apply_policy"] == 6


@pytest.mark.cuda
def test_two_ranks_sharing_the_card(card, tmp_path):
    """Two parallel.worker processes on cuda:0 over gloo (NCCL refuses two
    ranks on one device), on the tiny config: equal to each other bit for
    bit, maps slot for slot, within 5e-4 of SageICP on the card
    (test_sharded_step_matches_single_device's bound), healthy; each rank
    ran GN on 320 of the 640 rows every ICP iteration and the policy on
    1,024 of the 2,048 rows every frame, on the card."""
    import json
    import subprocess
    import sys

    from sage_icp_tpu_torch.parallel.worker import save_scans

    root = pathlib.Path(__file__).resolve().parents[1]
    scans = tiny_scans()
    save_scans(str(tmp_path / "scans.npy"), scans)
    (tmp_path / "config.json").write_text(json.dumps(TINY_CONFIG))
    cmds = [[sys.executable, "-m", "sage_icp_tpu_torch.parallel.worker", "--rank", str(r), "--world", "2",
             "--init", f"file://{tmp_path / 'rendezvous'}", "--backend", "gloo", "--device", "cuda:0",
             "--preset", "kitti", "--config", str(tmp_path / "config.json"), "--scans", str(tmp_path / "scans.npy"),
             "--out", str(tmp_path)] for r in range(2)]
    procs = [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    single = tpl.SageICP(tpl.SageConfig(**TINY_CONFIG))
    for s in scans:
        single.register_frame(s)
    poses = [np.load(tmp_path / f"poses_{r}.npy") for r in range(2)]
    maps = [dict(np.load(tmp_path / f"map_{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(poses[0], poses[1])
    for k in maps[0]:
        np.testing.assert_array_equal(maps[0][k], maps[1][k])
    np.testing.assert_allclose(poses[0], single.trajectory(), atol=5e-4)
    n = len(scans)
    for r in range(2):
        rep = json.loads((tmp_path / f"rank_{r}.json").read_text())
        iters = sum(rep["icp_iterations"])
        assert rep["aux_totals"]["nonfinite_pose"] == 0
        assert rep["kernel_rows"] == {"fused_gn_iteration": {"320": iters}, "apply_policy": {"1024": n}}
        assert rep["launches"]["fused_gn_iteration"] == iters and rep["launches"]["apply_policy"] == n
