"""The device-resident step on the CPU: the ICP loop's step
(ops/icp_kernel.py), the blocked loop (ops/registration.py::IcpLoop) and
the step factories (models/pipeline.py: make_step, make_step_packed,
make_chunk_step) against the JAX package and against the port's own
functional step.

Tolerances: the plain step against the JAX loop body (XLA's matmuls and
reductions round in their own order) within 1e-6 on the pose and the
step norm, the drift within 1e-2 m (arccos near 1 turns an ulp of the
trace into ~1e-4 rad at a ~15 m scan radius), the correspondence count
and the status equal; the blocked loop
against JAX's register_frame, the pose within 1e-6, iterations and
correspondences equal; blocks of one iteration against the default
blocks bit for bit; the eager device step (in place) against
odometry_step and chunk_step (functional) bit for bit; the chunk step
against JAX's make_chunk_step: per-frame iterations and every counter
equal, poses within 1e-4 and sigma within 1e-5 relative (the carried-step
tolerance of tests/test_torch_pipeline.py). The CUDA kernels and the
captured step are held against these on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 14)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import geometry as jgeo
from sage_icp_tpu.ops import hashmap as jhm
from sage_icp_tpu.ops import pallas_nn as jpn
from sage_icp_tpu.ops import registration as jreg
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import cuda_lib
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import icp_kernel as ik
from sage_icp_tpu_torch.ops import registration as treg
from sage_icp_tpu_torch.runtime import tracing
from sage_icp_tpu_torch.utils import synthetic
from tests.test_torch_bench import TINY
from tests.test_torch_cuda import gn_fixture, t

FAST = dict(unique_voxel_rows=896, queries_per_voxel=8, overflow_rows=128)
ICP_KW = dict(max_correspondence_distance=1.5, kernel=0.5, sem_th=0.5, fast_params=FAST)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module (see tests/test_torch_runtime.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def maps():
    world, frame = gn_fixture()
    n = len(world)
    mj = jhm.insert(jhm.create(8192, 8), jnp.asarray(world), jnp.ones(n, bool), 1.0, 8, jnp.zeros(260, bool))
    mt, _ = thm.insert(thm.create(8192, 8), t(world), torch.ones(n, dtype=torch.bool), 1.0, 8,
                       torch.zeros(260, dtype=torch.bool))
    return mj, mt, frame


def jax_step(sums, T, anchor, r_scan, it, max_it, drift_lim):
    """The JAX while_loop body after the sums (registration.py:270-289)
    and its loop tests: (T', |x|, ncorr, drift, status)."""
    JTJ, JTr, ncorr, _ = jpn.assemble_normal_equations(jnp.asarray(sums))
    x = jreg.solve_increment(JTJ, JTr)
    T = jnp.matmul(jgeo.se3_exp(x), jnp.asarray(T), precision="highest")
    a = jnp.asarray(anchor)[:3, 3]
    moved = T[:3, :3] @ a + T[:3, 3] - a
    cos_t = jnp.clip((jnp.trace(T[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    drift = jnp.linalg.norm(moved) + jnp.arccos(cos_t) * r_scan
    norm = jnp.linalg.norm(x)
    more = (it + 1 < max_it) and float(norm) >= 1e-4
    status = ik.RUNNING if more and float(drift) < drift_lim else ik.REANCHOR if more else ik.DONE
    return np.asarray(T), float(norm), int(ncorr), float(drift), status


def test_plain_icp_step_matches_jax_loop_body(maps):
    """Four steps of the loop from the GN fixture's sums (a re-anchor
    request on the way), then a non-finite solve (a zero step: done) and
    a clamped one, each against the JAX body on the same sums and state."""
    _, mt, frame = maps
    n = len(frame)
    loop = treg.IcpLoop(mt, t(frame), torch.ones(n, dtype=torch.bool), torch.eye(4), 1.0, 1.5, 0.5, 0.5, 500,
                        16, FAST)
    f, i = loop.loop_f, loop.loop_i
    r_scan = float(f[ik.F_R_SCAN])
    statuses = []
    for k in range(6):
        i[ik.I_STATUS] = ik.RUNNING  # a stopped loop's GN adds nothing
        sums = loop._sums()
        if k == 4:  # the normal equations non-finite, the counts as they are
            sums = sums * torch.tensor([float("nan")] * 16 + [1.0, 1.0])
        if k == 5:
            sums = sums * torch.tensor([1.0] * 10 + [1e6] * 6 + [1.0, 1.0])
        T0, A0 = f[ik.F_T].reshape(4, 4).numpy().copy(), f[ik.F_ANCHOR].reshape(4, 4).numpy().copy()
        want = jax_step(sums.numpy(), T0, A0, r_scan, int(i[ik.I_ITERATIONS]), 500, loop.drift_lim)
        ik.icp_step(sums, f, i, 500, loop.drift_lim)
        np.testing.assert_allclose(f[ik.F_T].reshape(4, 4).numpy(), want[0], atol=1e-6)
        np.testing.assert_allclose(float(f[ik.F_NORM]), want[1], rtol=1e-6, atol=1e-7)
        assert int(i[ik.I_NCORR]) == want[2]
        # arccos near 1 turns an ulp of the trace into ~1e-4 rad at the scan radius
        np.testing.assert_allclose(float(f[ik.F_DRIFT]), want[3], atol=1e-2)
        assert int(i[ik.I_STATUS]) == want[4]
        statuses.append(want[4])
    assert ik.REANCHOR in statuses[:4] and statuses[4] == ik.DONE and float(f[ik.F_NORM]) > 9.99


def test_plain_icp_step_is_a_no_op_once_stopped(maps):
    _, mt, frame = maps
    n = len(frame)
    loop = treg.IcpLoop(mt, t(frame), torch.ones(n, dtype=torch.bool), torch.eye(4), 1.0, 1.5, 0.5, 0.5, 500,
                        16, FAST)
    sums = loop._sums()
    for status in (ik.DONE, ik.REANCHOR):
        loop.loop_i[ik.I_STATUS] = status
        f, i = loop.loop_f.clone(), loop.loop_i.clone()
        ik.icp_step(sums, loop.loop_f, loop.loop_i, 500, loop.drift_lim)
        assert torch.equal(f, loop.loop_f) and torch.equal(i, loop.loop_i)
        assert not torch.any(loop._sums() != 0)  # the plain GN adds nothing for a stopped loop


def fixture_case(name):
    """(initial guess, max_iterations, map empty) of each blocked-loop case."""
    xi_true = np.array([0.12, -0.08, 0.04, 0.015, -0.01, 0.02], np.float32)
    near = np.asarray(jgeo.se3_exp(jnp.asarray(xi_true + np.float32(0.002))))
    eye = np.eye(4, dtype=np.float32)
    return {"converges_in_block": (near, 60, False), "reanchor": (eye, 60, False), "max3": (eye, 3, False),
            "empty_map": (eye, 60, True)}[name]


@pytest.mark.parametrize("case", ["converges_in_block", "reanchor", "max3", "empty_map"])
def test_blocked_loop_matches_jax(maps, case, monkeypatch):
    """The loop in blocks of BLOCK_ITERATIONS (8): convergence inside the
    first block, a re-anchor between blocks, max_iterations 3 inside a
    block, and an empty map; against JAX's register_frame."""
    mj, mt, frame = maps
    n = len(frame)
    guess, max_it, empty = fixture_case(case)
    if empty:
        mj, mt = jhm.create(8192, 8), thm.create(8192, 8)
    reanchors = []
    original = treg.IcpLoop.reanchor
    monkeypatch.setattr(treg.IcpLoop, "reanchor", lambda self: (reanchors.append(1), original(self))[1])
    steps = []  # the ICP step's calls: BLOCK_ITERATIONS a block
    step = ik.icp_step
    monkeypatch.setattr(ik, "icp_step", lambda *a: (steps.append(1), step(*a))[1])
    rj = jreg.register_frame(mj, jnp.asarray(frame), jnp.ones(n, bool), jnp.asarray(guess), 1.0,
                             max_iterations=max_it, **ICP_KW)
    rt = treg.register_frame(mt, t(frame), torch.ones(n, dtype=torch.bool), t(guess), 1.0,
                             max_iterations=max_it, **ICP_KW)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-6)
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.num_correspondences) == int(rj.num_correspondences)
    assert int(rt.dropped_queries) == int(rj.dropped_queries)
    iters = int(rt.iterations)
    assert treg.BLOCK_ITERATIONS == 8 and len(steps) % 8 == 0
    blocks = len(steps) // 8
    if case == "converges_in_block":
        assert 1 < iters < 8 and not reanchors and blocks == 1
    if case == "reanchor":
        assert reanchors and blocks == 1 + len(reanchors)
    if case == "max3":
        assert iters == 3 and blocks == 1
    if case == "empty_map":
        assert iters == 1 and int(rt.num_correspondences) == 0


@pytest.mark.parametrize("case", ["converges_in_block", "reanchor", "max3"])
def test_blocks_of_one_iteration_equal_the_default(maps, case, monkeypatch):
    """K = 1 reads the status after every iteration, as a host loop would:
    the same pose, counts and loop state bit for bit."""
    _, mt, frame = maps
    n = len(frame)
    guess, max_it, _ = fixture_case(case)

    def run():
        loop = treg.IcpLoop(mt, t(frame), torch.ones(n, dtype=torch.bool), t(guess), 1.0, 1.5, 0.5, 0.5, max_it,
                            16, FAST)
        return loop.run(), loop

    (a, la) = run()
    monkeypatch.setattr(treg, "BLOCK_ITERATIONS", 1)
    (b, lb) = run()
    assert torch.equal(a.pose, b.pose) and torch.equal(la.loop_f, lb.loop_f) and torch.equal(la.loop_i, lb.loop_i)
    assert int(a.iterations) == int(b.iterations) and int(a.num_correspondences) == int(b.num_correspondences)


@pytest.fixture(scope="module")
def packed():
    """Four frames of tests/test_torch_bench.py's scans (its TINY config,
    int16 upload), packed as SageICP packs them."""
    world = synthetic.build_city_world(seed=0, size=420.0, density=0.7)
    gt = synthetic.make_trajectory(4, step=1.0)
    cfg = tpl.SageConfig(**TINY)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(*world, gt[i], rng, n_target=5000, max_range=100.0) for i in range(4)]
    return cfg, scans, torch.from_numpy(tpl.SageICP(cfg, device="cpu").pad_chunk(scans))


@pytest.fixture(scope="module")
def reference(packed):
    """odometry_step (functional) over the four frames: the states' maps
    and small fields, the poses, aux and landmark counts."""
    cfg, _, buf = packed
    state = tpl.init_state(cfg, "cpu")
    outs = []
    for f in buf:
        state, pose, aux, lmk = tpl.odometry_step(state, *tpl._split_packed(f), cfg)
        outs.append((pose, aux, lmk, state))
    return outs


def assert_states_equal(a, b):
    for x, y in zip(a.map, b.map):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(tpl._small_fields(a), tpl._small_fields(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("packed_input,dense_grid", [(False, False), (True, False), (True, True)])
def test_eager_device_step_equals_odometry_step(packed, reference, packed_input, dense_grid):
    """make_step(graph=False) and make_step_packed(graph=False) on the CPU,
    the latter also with the dense grid: the state (the map and its grid
    in place), poses, aux, landmark counts and states bit for bit those
    of odometry_step; the same state object every frame."""
    cfg, _, buf = packed
    if dense_grid:
        cfg = dataclasses.replace(cfg, dense_grid=True)
        state = tpl.init_state(cfg, "cpu")
        reference = []
        for f in buf:
            state, pose, aux, lmk = tpl.odometry_step(state, *tpl._split_packed(f), cfg)
            reference.append((pose, aux, lmk, state))
    make = tpl.make_step_packed if packed_input else tpl.make_step
    step = make(cfg, graph=False, device="cpu")
    state = tpl.init_state(cfg, "cpu")
    for k, (f, (pose_r, aux_r, lmk_r, state_r)) in enumerate(zip(buf, reference)):
        inputs = (f,) if packed_input else tpl._split_packed(f)
        out_state, pose, aux, lmk = step(state, *inputs)
        assert k == 0 or out_state is state
        state = out_state
        assert torch.equal(pose, pose_r) and torch.equal(lmk, lmk_r)
        for a, b in zip(aux, aux_r):
            assert torch.equal(a, b)
        assert_states_equal(state, state_r)


def test_chunk_step_equals_chunk_step_and_jax(packed):
    """make_chunk_step(config, 2, graph=False) over two chunks: poses,
    (2,) iterations, the chunk's aggregated aux and landmark count bit for
    bit those of chunk_step; against JAX's make_chunk_step on the same
    packed frames: the iterations and every counter equal, poses within
    1e-4, sigma within 1e-5 relative."""
    cfg, _, buf = packed
    step = tpl.make_chunk_step(cfg, 2, graph=False, device="cpu")
    with pytest.raises(ValueError, match="chunk step of 2 frames"):
        step(tpl.init_state(cfg, "cpu"), buf[:3])
    jcfg = jpl.SageConfig(**TINY)
    jstep = jpl.make_chunk_step(jcfg, 2)
    # two states: the step takes its state as donated and updates it in place
    state, ref_state = tpl.init_state(cfg, "cpu"), tpl.init_state(cfg, "cpu")
    jstate = jpl.init_state(jcfg)
    for w in (0, 2):
        state, poses, iters, agg, lmk = step(state, buf[w:w + 2])
        ref_state, rposes, riters, ragg, rlmk = tpl.chunk_step(ref_state, buf[w:w + 2], cfg)
        assert torch.equal(poses, rposes) and torch.equal(iters, riters) and torch.equal(lmk, rlmk)
        assert iters.shape == (2,) and iters.dtype == torch.int32
        for a, b in zip(agg, ragg):
            assert torch.equal(a, b)
        assert_states_equal(state, ref_state)
        jstate, jposes, (jiters, jagg) = jstep(jstate, jnp.asarray(buf[w:w + 2].numpy()))
        np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
        np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-4)
        for name, a, b in zip(tpl.StepAux._fields, agg, jagg):
            if name == "sigma":
                np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
            else:
                assert int(a) == int(b), name


class HostTraffic(TorchDispatchMode):
    """Counts what would move data between host and device inside its
    region on a card: tensors made from host values (lift_fresh: a
    torch.tensor of a list, or a Python scalar assigned through an index)
    and reads of a tensor's value on the host (_local_scalar_dense:
    item, int, float, bool)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def captured_pieces_traffic(cfg, scans, monkeypatch, pieces) -> list:
    """What the pieces of a captured step (`pieces` names DeviceStep's and
    its loop's methods, in order) read from the host on a third frame,
    run on the CPU after two: with Tensor.item, .cpu, .numpy, .tolist,
    __bool__, __int__, __float__ and __index__ patched to raise, and
    HostTraffic's list."""
    odom = tpl.SageICP(cfg, device="cpu")
    buf = torch.from_numpy(odom.pad_chunk(scans[:3]))
    step = odom._step
    state = odom.state
    for f in buf[:2]:  # the first frame builds the constants; the second has a pose to deskew from
        state, *_ = step(state, f)
    step._load((buf[2],))

    def refuse(name):
        def fail(*a, **kw):
            raise AssertionError(f"host read inside a captured piece: Tensor.{name}")
        return fail

    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    tracing.RECORDER.begin_frame(step.clock)  # the pieces stamp a frame's row, as in DeviceStep.__call__
    try:
        with HostTraffic() as traffic:
            for piece in pieces:
                getattr(step if piece in ("_prepare", "_finish") else step._loop, piece)()
    finally:
        tracing.RECORDER.end_frame()
    monkeypatch.undo()
    return traffic.seen


def test_captured_pieces_read_nothing_on_the_host(packed, monkeypatch):
    """The four pieces a captured step records (prepare with its first
    block, block, reanchor + block, finish), run on the CPU after a first
    frame: with Tensor.item, .cpu, .numpy, .tolist, __bool__, __int__,
    __float__ and __index__ patched to raise, and no tensor made from a
    host value or read on the host (HostTraffic). The deskew and the
    dynamic filter are on, so their pieces run too."""
    cfg, scans, _ = packed
    cfg = dataclasses.replace(cfg, deskew=True, dynamic_vehicle_filter=True, label_max_range=10.0)
    pieces = ("_prepare", "block", "reanchor", "block", "_finish")
    assert captured_pieces_traffic(cfg, scans, monkeypatch, pieces) == []


def test_captured_reference_pieces_read_nothing_on_the_host(packed, monkeypatch):
    """The same with fast correspondences off: prepare (with its first
    block of the reference loop: searches, normal equations, reference
    steps, source updates), block and finish."""
    cfg, scans, _ = packed
    cfg = dataclasses.replace(cfg, deskew=True, dynamic_vehicle_filter=True, label_max_range=10.0,
                              use_fast_correspondences=False)
    assert captured_pieces_traffic(cfg, scans, monkeypatch, ("_prepare", "block", "_finish")) == []
    assert tpl.SageICP(cfg, device="cpu")._step.fast_params is None


@pytest.mark.parametrize("factory", ["make_step", "make_step_packed", "make_sharded_step"])
def test_donate_updates_the_state_in_place_or_leaves_it(packed, factory):
    """Two frames through each factory with donate=True and donate=False
    (make_sharded_step on a world of one without a group): the same poses
    and final state bit for bit; donated, the caller's first state is the
    step's state, updated in place; not donated, it is bit for bit as it
    was and the step's state is its own."""
    from sage_icp_tpu_torch.parallel import sharding as tsh

    cfg, _, buf = packed
    runs = {}
    for donate in (True, False):
        if factory == "make_sharded_step":
            step = tsh.make_sharded_step(cfg, tsh.make_mesh("cpu"), donate=donate)
        else:
            step = getattr(tpl, factory)(cfg, graph=False, device="cpu", donate=donate)
        given = tpl.init_state(cfg, "cpu")
        before = [t.clone() for t in (*given.map[:4], *tpl._small_fields(given))]
        state, poses = given, []
        for f in buf[:2]:
            state, pose, _, _ = step(state, *((f,) if factory == "make_step_packed" else tpl._split_packed(f)))
            poses.append(pose.clone())
        fields = [*given.map[:4], *tpl._small_fields(given)]
        mine = [*state.map[:4], *tpl._small_fields(state)]
        if donate:
            assert all(a is b for a, b in zip(fields, mine))
            assert int((given.map.counts > 0).sum()) > 0 and int(given.num_poses) == 2
        else:
            assert all(torch.equal(a, b) for a, b in zip(fields, before))
            assert all(a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr() for a, b in zip(fields, mine))
        runs[donate] = (poses, state)
    assert all(torch.equal(a, b) for a, b in zip(runs[True][0], runs[False][0]))
    assert_states_equal(runs[True][1], runs[False][1])


def test_a_launch_on_another_current_device_raises(monkeypatch):
    """A wrapper launches on the current device; tensors on another card
    make the call raise before anything is launched (DeviceStep runs under
    pipeline.on_device, which makes its device current; on the CPU that
    is nothing)."""
    called = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="current device is cuda:1"):
        cuda_lib.call("icp_step", lambda *a: called.append(a) or 0, torch.device("cuda", 0))
    assert not called
    with tpl.on_device(torch.device("cpu")):
        pass


def test_graph_step_needs_a_card():
    cfg = tpl.SageConfig(**TINY)
    with pytest.raises(ValueError, match="CUDA device"):
        tpl.make_step(cfg, graph=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tpl.make_chunk_step(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tpl.SageICP(cfg, device="cpu", graph=True)
    assert tpl.SageICP(cfg, device="cpu").graph is False
