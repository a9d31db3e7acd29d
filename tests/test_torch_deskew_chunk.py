"""Deskew, the chunked step and the int16 scan upload of the port against
the JAX package, on the CPU, and a JAX checkpoint of a deskewed run
loaded into the port.

Tolerances: deskew and skew_scan within 1e-5 m of JAX's on seeded points
within 80 m (float32 resolution there is 7.6e-6 m); the int16 packing
and unpacking bit for bit; a deskewed step from JAX's carried state:
pose within 1e-4, keys and counts equal, int16 planes within 1 LSB, drop
counters equal; the JAX checkpoint's state equal field for field; the analogs of the JAX suite's tests at their bounds:
deskew on distorted scans (on < 0.7 x off, on < 0.10 m), chunked equal to
single frames (1e-5), a mid-chunk overflow caught by the chunk's
aggregate, the quantized upload within 0.02 m of float32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.datasets.kitti import azimuth_timestamps as jax_azimuth
from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import geometry as jgeo
from sage_icp_tpu.ops import scan as jscan
from sage_icp_tpu.runtime import checkpoint as j_ckpt
from sage_icp_tpu.utils import synthetic as jsyn
from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.models.state_io import state_from_numpy, state_to_numpy
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import scan as tscan
from sage_icp_tpu_torch.runtime import checkpoint as t_ckpt
from sage_icp_tpu_torch.utils import synthetic
from tests.test_pipeline import small_config as pipeline_config
from tests.test_robustness import ate_trans, small_config
from tests.test_torch_pipeline import COUNTERS


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module: the suite runs six workers on
    the host's cores, and PyTorch's default of one thread a core makes
    them spin against each other (small tensors slowed down 30x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port(jcfg, **kw):
    return tpl.SageConfig(**{**dataclasses.asdict(jcfg), **kw})


def seeded_points(seed, n=20_000, extent=80.0):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-extent, extent, (n, 3)), rng.choice([0, 40, 50], (n, 1))], 1)
    return pts.astype(np.float32), rng.uniform(0.0, 1.0, n).astype(np.float32), rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deskew_matches_jax(seed):
    """Start and finish poses with a random attitude and a frame's motion
    (1 m, a few mrad: the small-angle regime of the exponential)."""
    pts, ts, rng = seeded_points(seed)
    start = jgeo.se3_exp(jnp.asarray(rng.normal(0.0, 0.3, 6), jnp.float32))
    finish = start @ jgeo.se3_exp(jnp.asarray([1.0, 0.05, 0.01, 0.002, 0.001, 0.0005 * (seed + 1)], jnp.float32))
    want = np.asarray(jscan.deskew(jnp.asarray(pts), jnp.asarray(ts), start, finish))
    got = tscan.deskew(torch.from_numpy(pts), torch.from_numpy(ts), torch.from_numpy(np.array(start)),
                       torch.from_numpy(np.array(finish))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, 3], pts[:, 3])


def test_skew_scan_matches_jax():
    pts, ts, _ = seeded_points(3)
    delta = np.array([1.0, 0.02, 0.0, 0.0, 0.0, 0.01], np.float32)
    np.testing.assert_allclose(synthetic.skew_scan(pts, delta, ts), jsyn.skew_scan(pts, delta, ts), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(azimuth_timestamps(pts[:, :3]), jax_azimuth(pts[:, :3]))


def test_deskew_undoes_skew_scan():
    """deskew with the frame's own motion inverts skew_scan (reference
    core/Deskew.cpp:36-50)."""
    pts, ts, _ = seeded_points(4, extent=40.0)
    motion = tgeo.se3_exp(torch.tensor([1.5, 0.1, 0.0, 0.0, 0.0, 0.02]))
    delta = tgeo.se3_log(motion).numpy()
    skewed = synthetic.skew_scan(pts, delta, ts)
    back = tscan.deskew(torch.from_numpy(skewed), torch.from_numpy(ts), torch.eye(4), motion).numpy()
    np.testing.assert_allclose(back, pts, atol=2e-4)


def test_quantized_packing_matches_jax():
    """_quantize_scan_host and the int16 _split_packed bit for bit,
    timestamp lane included, with padding rows and clipped coordinates."""
    pts, ts, _ = seeded_points(5, n=3000, extent=140.0)
    rows = np.concatenate([pts, ts[:, None]], axis=1)
    cap = 4096
    want = np.full((cap, 5), jpl.QSCAN_INVALID, np.int16)
    got = np.full((cap, 5), tpl.QSCAN_INVALID, np.int16)
    jpl._quantize_scan_host(rows, want)
    tpl._quantize_scan_host(rows, got)
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[:3000, :3]) == 32700).any()
    for lanes in (5, 4):
        j = jpl._split_packed(jnp.asarray(want[:, :lanes]))
        t = tpl._split_packed(torch.from_numpy(got[:, :lanes]))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the float32 buffer: validity from the sentinel, timestamps zeroed on padding
    buf = np.full((cap, 5), tscan.INVALID_COORD, np.float32)
    buf[:3000] = rows
    for a, b in zip(tpl._split_packed(torch.from_numpy(buf)), jpl._split_packed(jnp.asarray(buf))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def city():
    return synthetic.build_city_world(seed=2, size=160.0, block=50.0, density=1.6)


@pytest.fixture(scope="module")
def skewed_drive(city):
    """test_deskew_reduces_ate_on_distorted_scans's drive: 12 frames at
    2 m/frame, each scan skewed by its frame's motion over the azimuth
    sweep phase; 8,000-point scans (the JAX test renders 14,000), which
    halves the plain GN's time on the CPU."""
    gt = synthetic.make_trajectory(12, step=2.0, accel_frames=4)
    rng = np.random.default_rng(5)
    scans, tss = [], []
    for i in range(len(gt)):
        scan = synthetic.render_scan(*city, gt[i], rng, n_target=8000)
        nxt = gt[min(i + 1, len(gt) - 1)]
        delta = tgeo.se3_log(torch.as_tensor(np.linalg.inv(gt[i]) @ nxt, dtype=torch.float32)).numpy()
        ts = azimuth_timestamps(scan[:, :3])
        scans.append(synthetic.skew_scan(scan, delta, ts))
        tss.append(ts)
    return scans, tss, gt


def test_deskew_reduces_ate_on_distorted_scans(skewed_drive):
    scans, tss, gt = skewed_drive

    def run(deskew):
        odom = tpl.SageICP(port(small_config(), deskew=deskew), device="cpu")
        for s, t in zip(scans, tss):
            odom.register_frame(s, t)
        assert int(odom.aux_totals().overflow_total()) == 0
        return odom.trajectory()

    ate_off, _ = ate_trans(run(False), gt)
    ate_on, _ = ate_trans(run(True), gt)
    assert ate_on < ate_off * 0.7, f"deskew did not help: on={ate_on:.3f} off={ate_off:.3f}"
    assert ate_on < 0.10, f"deskewed ATE too large: {ate_on:.3f}"


@pytest.fixture(scope="module")
def jax_deskew_run(skewed_drive):
    """Frames 0-3 of the skewed drive in JAX with deskew on: the odometry
    and its state (as numpy) after each frame."""
    scans, tss, _ = skewed_drive
    odom = jpl.SageICP(small_config(deskew=True))
    states = []
    for s, t in zip(scans[:4], tss[:4]):
        odom.register_frame(s, t)
        states.append(state_to_numpy(odom.state))
    return odom, states


def test_carried_state_deskew_step_matches_jax(skewed_drive, jax_deskew_run):
    """The port steps frame 3 (the first deskewed one: num_poses 3) from
    JAX's state after frame 2."""
    scans, tss, _ = skewed_drive
    odom, states = jax_deskew_run
    cfg = port(small_config(deskew=True))
    buf = tpl.SageICP(cfg, device="cpu").pad_chunk([scans[3]], [tss[3]])[0]
    pts, valid, ts = tpl._split_packed(torch.from_numpy(buf))
    state, pose, aux, _ = tpl.odometry_step(state_from_numpy(states[2], "cpu"), pts, valid, ts, cfg)
    assert int(states[2]["num_poses"]) == 3
    np.testing.assert_allclose(pose.numpy(), np.asarray(odom.poses[-1]), atol=1e-4)
    got, want = state_to_numpy(state), states[3]
    np.testing.assert_array_equal(got["map.keys"], want["map.keys"])
    np.testing.assert_array_equal(got["map.counts"], want["map.counts"])
    assert np.abs(got["map.points"].astype(np.int32) - want["map.points"].astype(np.int32)).max() <= 1
    aux_j = odom.last_aux
    for name in COUNTERS:
        assert int(getattr(aux, name)) == int(getattr(aux_j, name)), name


def test_jax_checkpoint_loads_into_port(tmp_path, jax_deskew_run):
    """JAX's save_state after four deskewed frames -> the port's
    load_state: the state equal to JAX's field for field, dtypes
    included, and the trajectory."""
    odom, states = jax_deskew_run
    path = str(tmp_path / "jax.npz")
    j_ckpt.save_state(path, odom)
    loaded = t_ckpt.load_state(path, tpl.SageICP(port(small_config(deskew=True)), device="cpu"))
    got = state_to_numpy(loaded.state)
    assert set(got) == set(states[3])
    for k, want in states[3].items():
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    np.testing.assert_array_equal(loaded.trajectory(), np.stack([np.asarray(p) for p in odom.poses]))


@pytest.fixture(scope="module")
def corridor():
    return synthetic.build_world(seed=1, length=80.0)


def test_chunked_step_matches_single_frames(corridor):
    """register_chunk runs the single-frame steps on one upload: the same
    trajectory, iteration counts and totals."""
    rng = np.random.default_rng(7)
    gt = synthetic.make_trajectory(6, step=0.8)
    scans = [synthetic.render_scan(*corridor, gt[i], rng, n_target=6000) for i in range(6)]
    cfg = port(pipeline_config())
    a = tpl.SageICP(cfg, device="cpu")
    for s in scans:
        a.register_frame(s)
    b = tpl.SageICP(cfg, device="cpu")
    poses = b.register_chunk(scans[:3])
    assert torch.is_tensor(poses) and poses.shape == (3, 4, 4)
    b.register_chunk(b.pad_chunk(scans[3:]))
    np.testing.assert_allclose(a.trajectory(), b.trajectory(), atol=1e-5)
    np.testing.assert_array_equal(a.iteration_counts(), b.iteration_counts())
    for x, y in zip(a.aux_totals(), b.aux_totals()):
        np.testing.assert_array_equal(x, y)


def test_block_false_keeps_poses_on_the_device(corridor):
    rng = np.random.default_rng(7)
    gt = synthetic.make_trajectory(2, step=0.8)
    odom = tpl.SageICP(port(pipeline_config()), device="cpu")
    held = [odom.register_frame(synthetic.render_scan(*corridor, gt[i], rng, n_target=6000), block=False)
            for i in range(2)]
    assert all(torch.is_tensor(p) for p in held)
    np.testing.assert_array_equal(odom.trajectory(), torch.stack(held).numpy())


def test_chunked_aux_catches_mid_chunk_overflow():
    """The chunk's aux sums the drop counters over its frames: an overflow
    on the middle frame shows though the last frame is clean."""

    def patch_scan(seed):
        rng = np.random.default_rng(seed)
        xyz = np.stack([rng.uniform(4.0, 7.0, 500), rng.uniform(-1.5, 1.5, 500), rng.uniform(0.0, 1.0, 500)], 1)
        return np.concatenate([xyz, np.full((500, 1), 40.0)], 1).astype(np.float32)

    rng = np.random.default_rng(2)
    wide = np.concatenate([rng.uniform(-50.0, 50.0, (3000, 3)), np.full((3000, 1), 40.0)], 1).astype(np.float32)
    cfg = port(pipeline_config(corr_unique_voxel_rows=64, corr_overflow_rows=32))
    scans = [patch_scan(0), wide, patch_scan(1)]

    chunked = tpl.SageICP(cfg, device="cpu")
    chunked.register_chunk(scans)
    assert int(chunked.last_aux.corr_dropped) > 0
    assert int(chunked.last_aux.overflow_total()) > 0

    per_frame = tpl.SageICP(cfg, device="cpu")
    for s in scans:
        per_frame.register_frame(s)
    assert int(per_frame.last_aux.corr_dropped) == 0
    assert int(per_frame.aux_totals().corr_dropped) == int(chunked.aux_totals().corr_dropped)


def test_quantized_upload_matches_f32(corridor):
    rng = np.random.default_rng(11)
    gt = synthetic.make_trajectory(5, step=0.8)
    scans = [synthetic.render_scan(*corridor, gt[i], rng, n_target=6000) for i in range(5)]
    a = tpl.SageICP(port(pipeline_config()), device="cpu")
    b = tpl.SageICP(port(pipeline_config(), quantized_scan_upload=True), device="cpu")
    assert b.pad_chunk(scans[:1]).dtype == np.int16
    for s in scans:
        a.register_frame(s)
        b.register_frame(s)
    d = np.linalg.norm(a.trajectory()[:, :3, 3] - b.trajectory()[:, :3, 3], axis=-1)
    assert d.max() < 0.02, f"quantized upload drifted {d.max():.4f} m"
