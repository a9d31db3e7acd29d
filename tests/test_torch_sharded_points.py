"""The sharded step's rank-local pieces on the CPU (parallel/sharding.py):
each rank r of n in {2, 3} is computed in one process, its shares
concatenated in rank order, and held against the unsharded piece. n = 3
splits rows that do not tile (R = 640, VR = 4,096, the filter grid's 208
x planes, 1,000 scan points, N = 1,000 sources), so the padding of a
share to ceil(rows / n) rows and its removal after the gather are
exercised too.

The ranks run as threads of one process, each with a ThreadMesh: a test
double of Mesh whose all_gather is an in-process collective (every rank
posts its share and reads all of them in rank order), so the real
gather_rows and its padding run as they do over NCCL or gloo.

Tolerances: the correspondence rows, the filter's component grid and
radius counts, its outputs, and the scan head (deskew on) bit for bit;
RefLoop's summed normal equations within float32 reduction-order noise
(1e-5 of their largest magnitude), its correspondence count exactly."""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import correspondence_fast as tcf
from sage_icp_tpu_torch.ops import dynamic_filter as tdyn
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import icp_kernel as ik
from sage_icp_tpu_torch.ops import nn_kernels
from sage_icp_tpu_torch.ops import registration as treg
from sage_icp_tpu_torch.ops import scan as tscan
from sage_icp_tpu_torch.parallel import sharding as tsh
from sage_icp_tpu_torch.runtime import tracing
from sage_icp_tpu_torch.utils import synthetic
from tests.test_torch_bench import TINY
from tests.test_torch_cuda import gn_fixture, parked_moving_scan, t
from tests.test_torch_device_step import HostTraffic

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module (see tests/test_torch_runtime.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Hub:
    """An in-process collective for n rank threads: every rank posts its
    share, waits for the others, and reads all of them in rank order.
    Also keeps what each rank's gather_rows returned, by rank and call."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=120)
        self.posted = [None] * n
        self.calls = [0] * n
        self.gathered = {}

    def all_gather(self, rank: int, x):
        self.posted[rank] = x.clone()
        self.barrier.wait()
        out = torch.cat(self.posted)
        self.barrier.wait()  # all have read before the next gather posts
        return out


@dataclasses.dataclass(frozen=True)
class ThreadMesh(tsh.Mesh):
    hub: Hub = None

    def all_gather(self, x):
        return self.hub.all_gather(self.rank, x)

    def gather_rows(self, x, n_rows):
        out = super().gather_rows(x, n_rows)
        k = self.hub.calls[self.rank]
        self.hub.calls[self.rank] += 1
        self.hub.gathered[self.rank, k] = out
        return out


def run_ranks(n, fn, hub=None):
    """fn(mesh) on n rank threads, rank r's mesh a ThreadMesh of rank r
    on `hub` (default: a new one). Returns ([fn's value on each rank],
    the hub)."""
    hub = Hub(n) if hub is None else hub
    out, errors = [None] * n, []

    def body(r):
        try:
            out[r] = fn(ThreadMesh(n, r, None, CPU, hub=hub))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out, hub


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_local_rows_gather_back_to_the_whole(n):
    """Mesh.local_rows pads each rank's row_range share to ceil(rows / n)
    rows; Mesh.gather_rows of the shares gives back the rows in order,
    bit for bit, for splits that tile and splits that do not."""
    for rows in (7, 208, 640, 4096):
        x = torch.arange(rows * 3, dtype=torch.int32).reshape(rows, 3)
        got, hub = run_ranks(n, lambda mesh: mesh.gather_rows(mesh.local_rows(x), rows))
        assert all(torch.equal(g, x) for g in got), rows
        assert [p.shape[0] for p in hub.posted] == [-(-rows // n)] * n


def kitti_block_map(seed=3, n=6000, dense_grid=False):
    """A map of 40-point blocks (K of every preset) with one voxel column
    in three left empty around the queries."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-14.0, 14.0, (n, 3)), rng.choice([0, 40, 50, 10], (n, 1))], 1)
    pts = pts[(np.floor(pts[:, 0]) + np.floor(pts[:, 1])) % 3 != 0].astype(np.float32)
    valid = torch.ones(len(pts), dtype=torch.bool)
    return thm.insert(thm.create(4096, 40, dense_grid=dense_grid), t(pts), valid, 1.0, 20,
                      torch.zeros(260, dtype=torch.bool), max_incoming_per_voxel=48, probe_depth=12,
                      unique_voxel_capacity=4096)[0], rng


@pytest.mark.parametrize("n", [2, 3])
def test_corr_setup_rows_concatenate_to_the_whole_setup(n):
    """Each rank's corr_setup(rows=row_range(R)) holds exactly those rows of
    the whole setup (planes, q0, grid_used, origins) and the whole query
    sort, seats and row_rel; frozen_rows of a rank's setup equals the
    whole setup's rows, each plane's base aligned for the GN kernel's
    loads."""
    state, rng = kitti_block_map()
    tables = tcf.build_probe_tables(state, torch.tensor([1, -1, 0], dtype=torch.int32), 12)
    q = np.concatenate([rng.uniform(-5, 5, (1500, 3)), rng.choice([0, 40, 50, 10], (1500, 1))], 1)
    q[700:760, :3] = q[700, :3] + rng.uniform(-0.2, 0.2, (60, 3))  # a crowded voxel: overflow rows
    valid = torch.from_numpy(rng.random(1500) < 0.95)
    kw = dict(unique_voxel_rows=512, queries_per_voxel=2, overflow_rows=128)
    R = 640
    whole = tcf.corr_setup(state, tables, t(q.astype(np.float32)), valid, 1.0, 12, **kw)
    rows_whole = treg.frozen_rows(whole)
    assert int(whole.grid_used.sum()) > 800 and int(whole.grid_used[512:].sum()) > 100
    M = 27 * 40
    parts = []
    for r in range(n):
        lo, hi = tsh.Mesh(n, r, None, CPU).row_range(R)
        part = tcf.corr_setup(state, tables, t(q.astype(np.float32)), valid, 1.0, 12, **kw, rows=(lo, hi))
        assert part.cxp.shape == (hi - lo, M) and part.row_rel.shape == (R, 3)
        for name in ("row_rel", "center", "order", "row", "col", "n_dropped"):
            assert torch.equal(getattr(part, name), getattr(whole, name)), name
        parts.append(part)
        fr = treg.frozen_rows(part, (lo, hi))
        for name in ("q0", "origin", "row_abs", "used"):
            assert torch.equal(getattr(fr, name), getattr(rows_whole, name)[lo:hi]), name
        assert all(torch.equal(a, b[lo:hi]) for a, b in zip(fr.planes, rows_whole.planes))
        assert torch.equal(fr.tile_map, nn_kernels.default_tile_map(rows_whole.used[lo:hi]))
        assert all(p.data_ptr() % nn_kernels.gn_load_bytes(M) == 0 for p in fr.planes)
    for name in ("cxp", "cyp", "czp", "clp", "q0", "grid_used", "row_origin_abs"):
        assert torch.equal(torch.cat([getattr(p, name) for p in parts]), getattr(whole, name)), name


def test_corr_setup_rows_on_the_dense_grid():
    """The dense index's branch of corr_setup at n = 3: the same rows."""
    grid_state, rng = kitti_block_map(seed=4, dense_grid=True)
    assert grid_state.grid is not None
    tables = tcf.build_probe_tables(grid_state, torch.zeros(3, dtype=torch.int32), 12)
    q = np.concatenate([rng.uniform(-12, 12, (1200, 3)), rng.choice([0, 40, 50], (1200, 1))], 1).astype(np.float32)
    valid = torch.ones(1200, dtype=torch.bool)
    kw = dict(unique_voxel_rows=512, queries_per_voxel=2, overflow_rows=128)
    whole = tcf.corr_setup(grid_state, tables, t(q), valid, 1.0, 12, **kw)
    parts = [tcf.corr_setup(grid_state, tables, t(q), valid, 1.0, 12, **kw,
                            rows=tsh.Mesh(3, r, None, CPU).row_range(640)) for r in range(3)]
    assert int((whole.clp >= 0).sum()) > 0
    for name in ("cxp", "cyp", "czp", "clp", "q0", "grid_used", "row_origin_abs"):
        assert torch.equal(torch.cat([getattr(p, name) for p in parts]), getattr(whole, name)), name


@pytest.fixture(scope="module")
def parked_moving():
    """tests/test_torch_dynfilter.py's parked and moving cars, cropped at
    the kitti preset; the unsharded filter's outputs on them, with its
    component grid and radius counts."""
    buf, valid = parked_moving_scan(16384)
    cfg = tpl.PRESETS["kitti"]
    pts, ok = tscan.preprocess(t(buf), t(valid), cfg.max_range, cfg.min_range, cfg.label_max_range)
    seen = {}
    pool, count = tdyn._min_diffusion, nn_kernels.radius_count
    tdyn._min_diffusion = lambda *a: seen.setdefault("comp", pool(*a))
    nn_kernels.radius_count = lambda *a: seen.setdefault("counts", count(*a))
    try:
        want = tdyn.filter_dynamic_vehicles(pts, ok, cfg)
    finally:
        tdyn._min_diffusion, nn_kernels.radius_count = pool, count
    return pts, ok, want, seen


@pytest.mark.parametrize("n", [2, 3])
def test_filter_shards_equal_the_whole_filter(n, monkeypatch, parked_moving):
    """tests/test_torch_dynfilter.py's parked and moving cars at the kitti
    preset's capacities: each rank's radius count on its ceil(VR / n) rows
    and its pooled x-slab; the gathered component grid and counts, and
    the filter's outputs, equal the unsharded filter's bit for bit."""
    pts, ok, want, seen = parked_moving
    cfg = tpl.PRESETS["kitti"]
    count = nn_kernels.radius_count
    rows = []
    monkeypatch.setattr(nn_kernels, "radius_count", lambda *a: (rows.append(a[0].shape[0]), count(*a))[1])
    slabs = []
    max_pool = torch.nn.functional.max_pool3d
    monkeypatch.setattr(torch.nn.functional, "max_pool3d", lambda x, *a, **k: (slabs.append(x.shape[2]),
                                                                               max_pool(x, *a, **k))[1])
    got, hub = run_ranks(n, lambda mesh: tdyn.filter_dynamic_vehicles(pts, ok, cfg, mesh))
    nx = tdyn._grid_nx(cfg.label_max_range)
    share = -(-tdyn._VEH_ROW_CAP // n)
    assert nx == 208 and rows == [share] * n
    halo = tdyn._CC_ITERS
    own = [tsh.Mesh(n, r, None, CPU).row_range(nx) for r in range(n)]
    assert Counter(slabs) == sum((Counter({min(nx, hi + halo) - max(0, lo - halo): halo}) for lo, hi in own),
                                 Counter())
    for r in range(n):
        assert torch.equal(hub.gathered[r, 0].reshape(-1), seen["comp"]) and torch.equal(hub.gathered[r, 1], seen["counts"])
    counts = seen["counts"]
    assert int(counts.sum()) > 0
    for r in range(n):
        assert all(torch.equal(a, b) for a, b in zip(got[r], want))


def test_deskew_of_a_share_is_the_whole_scans_rows():
    """scan.deskew has no batched product: any contiguous share of the
    points gives the whole scan's rows bit for bit."""
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(-60, 60, (1000, 3)), rng.choice([0, 40], (1000, 1))], 1).astype(np.float32)
    ts = t(rng.uniform(0, 1, 1000).astype(np.float32))
    start = tgeo.se3_exp(torch.tensor([0.3, -0.1, 0.05, 0.02, -0.01, 0.2]))
    finish = start @ tgeo.se3_exp(torch.tensor([1.1, 0.05, 0.01, 0.002, 0.001, 0.004]))
    whole = tscan.deskew(t(pts), ts, start, finish)
    for lo, hi in ((0, 334), (334, 667), (667, 1000), (1, 999), (500, 501)):
        assert torch.equal(tscan.deskew(t(pts)[lo:hi], ts[lo:hi], start, finish), whole[lo:hi])


@pytest.mark.parametrize("n", [2, 3])
def test_scan_head_shards_equal_the_whole_head(n):
    """Deskew on, from the third pose: each rank deskews and crops its
    share of 1,000 points; the gathered cropped scan and mask equal the
    unsharded head's bit for bit."""
    rng = np.random.default_rng(8)
    pts = np.concatenate([rng.uniform(-70, 70, (1000, 3)), rng.choice([0, 10, 40], (1000, 1))], 1).astype(np.float32)
    valid = torch.from_numpy(rng.random(1000) < 0.9)
    ts = t(rng.uniform(0, 1, 1000).astype(np.float32))
    cfg = dataclasses.replace(tpl.PRESETS["kitti"], deskew=True)
    state = tpl.init_state(dataclasses.replace(cfg, map_capacity=64), "cpu")
    state = state._replace(prev_pose=tgeo.se3_exp(torch.tensor([0.5, 0.1, 0.0, 0.0, 0.0, 0.01])),
                           last_pose=tgeo.se3_exp(torch.tensor([1.6, 0.2, 0.01, 0.001, 0.002, 0.03])),
                           num_poses=torch.tensor(3, dtype=torch.int32))
    want = tpl.scan_head(state, t(pts), valid, ts, cfg)
    got, hub = run_ranks(n, lambda mesh: tpl.scan_head(state, t(pts), valid, ts, cfg, mesh))
    assert [x.shape for x in hub.posted] == [(-(-1000 // n), 5)] * n and hub.calls == [1] * n
    assert not torch.equal(want[0], tscan.preprocess(t(pts), valid, cfg.max_range, cfg.min_range,
                                                     cfg.label_max_range)[0])  # deskew moved the points
    for r in range(n):
        assert torch.equal(got[r][0], want[0]) and torch.equal(got[r][1], want[1])


@pytest.mark.parametrize("n", [2, 3])
def test_ref_loop_terms_sum_across_ranks(n, monkeypatch):
    """RefLoop on a mesh: each rank keeps its N / n sources (bit for bit
    the whole loop's rows; the ranks' (1, 43) terms are all-gathered); the step kernel gets the normal equations of
    all the sources, summed in rank order, within float32 reduction-order
    noise of the whole loop's, and the whole loop's correspondence count."""
    world, frame = gn_fixture(n=500)
    frame = frame[:1000]
    mt, _ = thm.insert(thm.create(8192, 8), t(world), torch.ones(len(world), dtype=torch.bool), 1.0, 8,
                       torch.zeros(260, dtype=torch.bool))
    steps = []
    step = ik.icp_ref_step
    monkeypatch.setattr(ik, "icp_ref_step", lambda JTJ, JTr, nc, *a: (steps.append((JTJ.clone(), JTr.clone(),
                                                                                     int(nc))), step(JTJ, JTr, nc, *a)))
    args = (mt, t(frame), torch.ones(len(frame), dtype=torch.bool), torch.eye(4), 1.0, 1.5, 0.5, 0.5, 500, 16)
    whole = treg.RefLoop(*args)
    whole.block()
    (JTJ, JTr, nc), = steps
    assert nc > 500
    loops = {}

    def rank(mesh):
        loops[mesh.rank] = loop = treg.RefLoop(*args, mesh=mesh)
        source = loop.source.clone()
        loop.block()
        return steps[-1], source

    got, _ = run_ranks(n, rank)
    assert torch.equal(torch.cat([got[r][1] for r in range(n)]), treg.RefLoop(*args).source)
    for r in range(n):
        (gJTJ, gJTr, gnc), _ = got[r]
        assert gnc == nc
        np.testing.assert_allclose(gJTJ.numpy(), JTJ.numpy(), rtol=0, atol=1e-5 * float(JTJ.abs().max()))
        np.testing.assert_allclose(gJTr.numpy(), JTr.numpy(), rtol=0, atol=1e-5 * float(JTr.abs().max()))
        assert torch.equal(gJTJ, got[0][0][0]) and torch.equal(loops[r].loop_f, loops[0].loop_f)


@pytest.fixture(scope="module")
def tiny_city_scans():
    """tests/test_torch_device_step.py's packed fixture's first three
    scans (its TINY config's city world)."""
    world = synthetic.build_city_world(seed=0, size=420.0, density=0.7)
    gt = synthetic.make_trajectory(3, step=1.0)
    rng = np.random.default_rng(0)
    return [synthetic.render_scan(*world, gt[i], rng, n_target=5000, max_range=100.0) for i in range(3)]


@pytest.mark.parametrize("fast", [True, False])
def test_captured_sharded_pieces_read_nothing_on_the_host(fast, monkeypatch, tiny_city_scans):
    """test_captured_pieces_read_nothing_on_the_host for three ranks (rank
    threads): tests/test_torch_bench.py's TINY config padded for the mesh,
    with deskew and the filter on (VR = 4,096 rows split 1,366 / 1,365 /
    1,365, padded and gathered), on the fast and the reference path. After
    two frames, each rank runs the pieces a captured step records with
    Tensor.item, .cpu, .numpy, .tolist, __bool__, __int__, __float__ and
    __index__ patched to raise and HostTraffic watching: no tensor made
    from a host value, none read on the host."""
    scans = tiny_city_scans
    cfg = dataclasses.replace(tpl.SageConfig(**TINY), deskew=True, dynamic_vehicle_filter=True,
                              label_max_range=10.0, use_fast_correspondences=fast)
    cfg = tsh.pad_config_for_mesh(cfg, tsh.Mesh(3, 0, None, CPU))
    hub = Hub(3)
    steps = {}

    def warm(mesh):  # two frames: the constants built, a pose to deskew from
        odom = tpl.SageICP(cfg, device="cpu", mesh=mesh)
        buf = torch.from_numpy(odom.pad_chunk(scans))
        state = odom.state
        for f in buf[:2]:
            state, *_ = odom._step(state, f)
        odom._step._load((buf[2],))
        steps[mesh.rank] = odom._step

    run_ranks(3, warm, hub)
    assert all(steps[r].mesh.rank == r for r in range(3))
    pieces = ("_prepare", "block", "reanchor", "block", "_finish") if fast else ("_prepare", "block", "_finish")

    def refuse(name):
        def fail(*a, **kw):
            raise AssertionError(f"host read inside a captured piece: Tensor.{name}")
        return fail

    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))

    def run_pieces(mesh):
        step = steps[mesh.rank]
        tracing.RECORDER.begin_frame(step.clock)  # the pieces stamp a frame's row, as in DeviceStep.__call__
        try:
            with HostTraffic() as traffic:
                for piece in pieces:
                    getattr(step if piece in ("_prepare", "_finish") else step._loop, piece)()
        finally:
            tracing.RECORDER.end_frame()
        return traffic.seen

    seen, _ = run_ranks(3, run_pieces, hub)
    monkeypatch.undo()
    assert seen == [[], [], []]
