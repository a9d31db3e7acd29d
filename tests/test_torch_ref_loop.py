"""The reference-shaped ICP loop on the device, on the CPU: the step
kernel's reference mode (ops/icp_kernel.py::icp_ref_step, its plain
version here), the blocked loop (ops/registration.py::RefLoop) and the
device step with fast correspondences off, against the JAX package.

Tolerances: the plain reference step against the JAX loop body
(registration.py:315-333; XLA's matmuls and reductions round in their own
order) within 1e-6 on the pose and the increment and 1e-6 relative on the
step norm, the correspondence count and the loop's exit equal; the
blocked loop against JAX's register_frame(fast_params=None): the pose
within 1e-6, iterations and correspondences equal; blocks of one
iteration against blocks of four bit for bit; make_step(graph=False)
without fast correspondences against JAX's SageICP: poses within 1e-4
and per-frame iterations equal (the carried-step tolerance of
tests/test_torch_pipeline.py). The kernel and the captured step are held
against these on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 15)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import geometry as jgeo
from sage_icp_tpu.ops import hashmap as jhm
from sage_icp_tpu.ops import registration as jreg
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import icp_kernel as ik
from sage_icp_tpu_torch.ops import registration as treg
from sage_icp_tpu_torch.ops.scan import INVALID_COORD
from sage_icp_tpu_torch.utils import synthetic
from tests.test_torch_bench import TINY
from tests.test_torch_cuda import gn_fixture, t

ICP_KW = dict(max_correspondence_distance=1.5, kernel=0.5, sem_th=0.5)
PROBE_DEPTH = 16


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


def ref_loop(mt, frame, guess, max_it):
    n = len(frame)
    return treg.RefLoop(mt, t(frame), torch.ones(n, dtype=torch.bool), t(guess), 1.0, *ICP_KW.values(), max_it,
                        PROBE_DEPTH)


def test_plain_ref_step_matches_jax_loop_body(maps):
    """Four steps of the reference loop from the GN fixture's searches,
    then a non-finite solve (a zero step: done) and a clamped one, each
    against the JAX body on the same JTJ, JTr and state; then a launch on
    a stopped loop (the state as it was, est the identity, under which
    the source, INVALID_COORD rows included, stays bit for bit)."""
    _, mt, frame = maps
    loop = ref_loop(mt, frame, np.eye(4, dtype=np.float32), 500)
    f, i = loop.loop_f, loop.loop_i
    exits = []
    for k in range(6):
        i[ik.I_STATUS] = ik.RUNNING
        tgt, accept, _ = thm.get_correspondences(mt, loop.source, loop.valid, 1.0, loop.max_corr, loop.sem_th,
                                              PROBE_DEPTH)
        JTJ, JTr = treg.build_normal_equations(loop.source, tgt, accept, loop.kernel)
        if k == 4:
            JTJ = JTJ * float("nan")
        if k == 5:
            JTr = JTr * 1e6
        T0 = f[ik.F_T].reshape(4, 4).numpy().copy()
        x = jreg.solve_increment(jnp.asarray(JTJ.numpy()), jnp.asarray(JTr.numpy()))
        est = jgeo.se3_exp(x)
        T = np.asarray(jnp.matmul(est, jnp.asarray(T0), precision="highest"))
        norm = float(jnp.linalg.norm(x))
        more = k + 1 < 500 and norm >= 1e-4
        ik.icp_ref_step(JTJ, JTr, accept.sum(dtype=torch.int32), f, i, 500)
        np.testing.assert_allclose(f[ik.F_T].reshape(4, 4).numpy(), T, atol=1e-6)
        np.testing.assert_allclose(f[ik.F_EST].reshape(4, 4).numpy(), np.asarray(est), atol=1e-6)
        np.testing.assert_allclose(float(f[ik.F_NORM]), norm, rtol=1e-6, atol=1e-7)
        assert int(i[ik.I_NCORR]) == int(accept.sum()) > 0 and int(i[ik.I_ITERATIONS]) == k + 1
        assert int(i[ik.I_STATUS]) == (ik.RUNNING if more else ik.DONE)
        exits.append(more)
        loop.source.copy_(tgeo.transform_points(f[ik.F_EST].view(4, 4), loop.source))
    assert exits[:4] == [True] * 4 and not exits[4] and float(f[ik.F_NORM]) > 9.99

    f0, i0 = f.clone(), i.clone()
    i[ik.I_STATUS] = i0[ik.I_STATUS] = ik.DONE
    ik.icp_ref_step(JTJ, JTr, i[ik.I_NCORR], f, i, 500)
    assert torch.equal(f[:ik.F_EST.start], f0[:ik.F_EST.start]) and torch.equal(i, i0)
    assert torch.equal(f[ik.F_EST].view(4, 4), torch.eye(4))
    rows = torch.cat([loop.source, torch.tensor([[INVALID_COORD, INVALID_COORD, INVALID_COORD, 0.0]])])
    assert math.isfinite(INVALID_COORD)
    assert torch.equal(tgeo.transform_points(f[ik.F_EST].view(4, 4), rows), rows)


def fixture_case(name):
    """(initial guess, max_iterations, map empty) of each case."""
    xi_true = np.array([0.12, -0.08, 0.04, 0.015, -0.01, 0.02], np.float32)
    near = np.asarray(jgeo.se3_exp(jnp.asarray(xi_true + np.float32(0.002))))
    eye = np.eye(4, dtype=np.float32)
    return {"converges_in_block": (near, 60, False), "max3": (eye, 3, False), "empty_map": (near, 60, True)}[name]


CASES = ["converges_in_block", "max3", "empty_map"]


@pytest.fixture(scope="module")
def jax_ref(maps):
    """JAX's register_frame(fast_params=None) on each case, run once."""
    mj, _, frame = maps
    n = len(frame)
    out = {}
    for case in CASES:
        guess, max_it, empty = fixture_case(case)
        m = jhm.create(8192, 8) if empty else mj
        out[case] = jreg.register_frame(m, jnp.asarray(frame), jnp.ones(n, bool), jnp.asarray(guess), 1.0,
                                        max_iterations=max_it, probe_depth=PROBE_DEPTH, **ICP_KW)
    return out


def run_blocked(mt, frame, case, block, monkeypatch):
    """RefLoop in blocks of `block` -> (result, loop, the step's calls)."""
    guess, max_it, empty = fixture_case(case)
    if empty:
        mt = thm.create(8192, 8)
    monkeypatch.setattr(treg, "REF_BLOCK_ITERATIONS", block)
    calls = []
    step = ik.icp_ref_step
    monkeypatch.setattr(ik, "icp_ref_step", lambda *a: (calls.append(1), step(*a))[1])
    loop = ref_loop(mt, frame, guess, max_it)
    res = loop.run()
    monkeypatch.undo()
    return res, loop, len(calls)


@pytest.fixture(scope="module")
def blocked(maps):
    """run_blocked's (result, loop, the step's calls) for (case, block),
    each run once for the module and shared by the tests below."""
    _, mt, frame = maps
    runs = {}

    def get(case, block):
        if (case, block) not in runs:
            with pytest.MonkeyPatch.context() as mp:
                runs[case, block] = run_blocked(mt, frame, case, block, mp)
        return runs[case, block]

    return get


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_ref_loop_matches_jax(jax_ref, blocked, case, block):
    """The loop in blocks of 1 and of 4: convergence inside a block, a
    stop at max_iterations 3 inside a block of 4, and an empty map (one
    zero step; the guess comes back); against JAX's register_frame. Every
    block is whole: the step launches are the blocks times their length."""
    rj = jax_ref[case]
    rt, _, calls = blocked(case, block)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-6)
    iters = int(rt.iterations)
    assert iters == int(rj.iterations) and int(rt.num_correspondences) == int(rj.num_correspondences)
    assert int(rt.dropped_queries) == 0
    assert calls == block * math.ceil(iters / block)
    if case == "converges_in_block":
        assert 1 < iters < 60 and iters % 4 != 0
    if case == "max3":
        assert iters == 3
    if case == "empty_map":
        assert iters == 1 and int(rt.num_correspondences) == 0
        np.testing.assert_allclose(rt.pose.numpy(), fixture_case(case)[0], atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_ref_blocks_of_one_equal_blocks_of_four(blocked, case):
    """Blocks of one read the status after every iteration, as the host
    loop did: the pose, the counts, the loop's state (the last increment
    aside: blocks of four end on a stopped launch's identity) and the
    source bit for bit."""
    (a, la, _), (b, lb, _) = blocked(case, 1), blocked(case, 4)
    assert torch.equal(a.pose, b.pose) and torch.equal(la.loop_i, lb.loop_i)
    assert torch.equal(la.loop_f[:ik.F_EST.start], lb.loop_f[:ik.F_EST.start])
    assert torch.equal(la.source, lb.source)


def test_reference_step_matches_jax_sage_icp():
    """make_step(graph=False) with use_fast_correspondences=False over
    three frames of tests/test_torch_bench.py's scans (its TINY config):
    poses within 1e-4 of JAX's SageICP, per-frame iterations equal."""
    cfg = tpl.SageConfig(**dict(TINY, use_fast_correspondences=False))
    world = synthetic.build_city_world(seed=0, size=420.0, density=0.7)
    gt = synthetic.make_trajectory(3, step=1.0)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(*world, gt[i], rng, n_target=5000, max_range=100.0) for i in range(3)]
    jodom = jpl.SageICP(jpl.SageConfig(**dataclasses.asdict(cfg)))
    for s in scans:
        jodom.register_frame(s)
    step = tpl.make_step(cfg, graph=False, device="cpu")
    state = tpl.init_state(cfg, "cpu")
    poses, iters = [], []
    for f in torch.from_numpy(tpl.SageICP(cfg, device="cpu").pad_chunk(scans)):
        state, pose, aux, _ = step(state, *tpl._split_packed(f))
        poses.append(pose.clone())
        iters.append(int(aux.icp_iterations))
    np.testing.assert_allclose(torch.stack(poses).numpy(), jodom.trajectory(), atol=1e-4)
    assert iters == list(jodom.iteration_counts()) and max(iters) > 1
