"""The port's odometry pipeline against the JAX package, on the CPU, on
the golden-trajectory fixture (corridor world seed 1, render seed 3).

Tolerances: maps after the first frame equal slot for slot (first
points within 2 ulp); after a carried-over state and one more step,
keys and counts equal, int16 planes within 1 LSB, pose within 1e-4,
drop counters equal; the 12-frame trajectory within
test_golden_trajectory_regression's 0.02 m / 0.02."""

import dataclasses

import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.utils import synthetic
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.models.state_io import state_from_numpy, state_to_numpy
from tests.test_robustness import GOLDEN_PATH, small_config
from tests.test_torch_cuda import GOLDEN_CONFIG

COUNTERS = ("num_source", "num_frame_ds", "corr_dropped", "ds_truncated", "insert_unique_overflow",
            "insert_claim_failures", "insert_incoming_truncated", "dynfilter_overflow",
            "nonfinite_pose", "icp_rejected", "icp_forced")


def port_config():
    return tpl.SageConfig(**dataclasses.asdict(small_config()))


def test_card_tests_use_the_golden_config():
    assert tpl.SageConfig(**GOLDEN_CONFIG) == port_config()


@pytest.fixture(scope="module")
def fixture_scans():
    pts, labs = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(12, step=1.0)
    rng = np.random.default_rng(3)
    return [synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000) for i in range(12)], gt


@pytest.fixture(scope="module")
def jax_run(fixture_scans):
    """Three JAX frames: the state (as numpy) after each, and the third
    frame's pose and counters."""
    scans, _ = fixture_scans
    odom = jpl.SageICP(small_config())
    states = []
    for scan in scans[:3]:
        odom.register_frame(scan)
        states.append(state_to_numpy(odom.state))
    return states, np.asarray(odom.poses[-1]), odom.last_aux


def step_port(state_np, scan, cfg):
    state = state_from_numpy(state_np, "cpu")
    buf = np.full((cfg.scan_capacity, 4), 1.0e7, np.float32)
    buf[: len(scan)] = scan
    pts = torch.from_numpy(buf)
    return tpl.odometry_step(state, pts, pts[:, 0] < 1.0e6, torch.zeros(len(pts)), cfg)[:3]


def test_state_numpy_round_trip(jax_run):
    d = jax_run[0][1]
    back = state_to_numpy(state_from_numpy(d, "cpu"))
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
        assert back[k].dtype == d[k].dtype, k


def test_first_frame_map_equals_jax(fixture_scans, jax_run):
    scans, _ = fixture_scans
    cfg = port_config()
    state, pose, _ = step_port(state_to_numpy(tpl.init_state(cfg, "cpu")), scans[0], cfg)
    np.testing.assert_array_equal(pose.numpy(), np.eye(4, dtype=np.float32))
    want = jax_run[0][0]
    got = state_to_numpy(state)
    for k in ("map.keys", "map.counts", "map.points"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the jitted JAX step fuses the first point's dequantization into an FMA
    np.testing.assert_allclose(got["map.first_pts"], want["map.first_pts"], rtol=2.5e-7)


def test_carried_state_step_matches_jax(fixture_scans, jax_run):
    scans, _ = fixture_scans
    states, pose_j, aux_j = jax_run
    state, pose, aux = step_port(states[1], scans[2], port_config())
    np.testing.assert_allclose(pose.numpy(), pose_j, atol=1e-4)
    got, want = state_to_numpy(state), states[2]
    np.testing.assert_array_equal(got["map.keys"], want["map.keys"])
    np.testing.assert_array_equal(got["map.counts"], want["map.counts"])
    lsb = np.abs(got["map.points"].astype(np.int32) - want["map.points"].astype(np.int32))
    assert lsb.max() <= 1
    for name in COUNTERS:
        assert int(getattr(aux, name)) == int(getattr(aux_j, name)), name
    assert abs(int(aux.icp_iterations) - int(aux_j.icp_iterations)) <= 1


@pytest.fixture(scope="module")
def port_run(fixture_scans):
    """The port's SageICP over the 12 frames; its state (as numpy) after
    the third."""
    scans, _ = fixture_scans
    odom = tpl.SageICP(port_config(), device="cpu")
    third = None
    for i, scan in enumerate(scans):
        odom.register_frame(scan)
        if i == 2:
            third = state_to_numpy(odom.state)
    return odom, third


def test_golden_trajectory(port_run):
    odom, _ = port_run
    est = odom.trajectory()
    golden = np.load(GOLDEN_PATH)["poses"]
    assert golden.shape == est.shape
    assert np.linalg.norm(golden[:, :3, 3] - est[:, :3, 3], axis=-1).max() < 0.02
    assert np.linalg.norm(golden[:, :3, :3] - est[:, :3, :3], axis=(-2, -1)).max() < 0.02
    assert int(odom.aux_totals().overflow_total()) == 0


def test_first_frame_pose_is_identity(port_run, jax_run):
    """The analog of tests/test_pipeline.py's test: the first pose is the
    identity, in the port's SageICP and in the JAX package's."""
    odom, _ = port_run
    np.testing.assert_allclose(odom.trajectory()[0], np.eye(4), atol=1e-5)
    np.testing.assert_array_equal(odom.trajectory()[0], jax_run[0][0]["last_pose"])


def test_adaptive_threshold_engages(port_run, jax_run):
    """After 12 frames of 1 m steps the threshold has adapted (the JAX
    test's bar); after three frames its state equals the JAX package's
    (sample count equal, SSE within 1e-4 relative)."""
    odom, third = port_run
    assert int(odom.state.threshold.num_samples) >= 1
    assert float(odom.last_aux.sigma) != pytest.approx(2.0)
    want = jax_run[0][2]
    assert int(third["threshold.num_samples"]) == int(want["threshold.num_samples"])
    np.testing.assert_allclose(third["threshold.sse"], want["threshold.sse"], rtol=1e-4)
    np.testing.assert_allclose(third["threshold.model_deviation"], want["threshold.model_deviation"], atol=1e-4)


def test_reinitialize_resets(fixture_scans, jax_run):
    """Two frames, then reinitialize: no poses, no counters, an empty
    map; the next frame is a first frame again, its map equal to the JAX
    package's first-frame map."""
    scans, _ = fixture_scans
    odom = tpl.SageICP(port_config(), device="cpu")
    for scan in scans[:2]:
        odom.register_frame(scan)
    odom.reinitialize()
    assert odom.poses == [] and odom.icp_iters == [] and odom.trajectory().shape == (0, 4, 4)
    assert int(odom.state.num_poses) == 0
    assert not bool(torch.any(odom.state.map.counts > 0))
    np.testing.assert_array_equal(odom.register_frame(scans[0]), np.eye(4, dtype=np.float32))
    got, want = state_to_numpy(odom.state), jax_run[0][0]
    for name in ("map.keys", "map.counts", "map.points"):
        np.testing.assert_array_equal(got[name], want[name])
