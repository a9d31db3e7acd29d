"""The port's runtime (dataset readers, metrics, runner, checkpoint, CLI)
against the JAX package, on the CPU.

Tolerances: the dataset readers and LabelDirectory bit for bit against
JAX's numpy read path (within 1e-5 m where JAX reads through its built
native loader); seq_error, ATE and estimate_icp_times equal to JAX's on
the same arrays (rtol 1e-12), umeyama_alignment within 1e-5; TUM lines
within 1e-6 once parsed; SequenceResult.save the same files, line and
column counts and "n/a" sentinels; checkpoints cross-loaded both ways
equal field for field, and every mismatched layout refused; the CLI
writes its outputs on --device cpu and refuses one --labels-dir for
several sequences (the reference's CLI re-applies it from frame 0)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.datasets import kitti as j_kitti
from sage_icp_tpu.datasets import kitti360 as j_kitti360
from sage_icp_tpu.datasets import kitti_raw as j_kitti_raw
from sage_icp_tpu.datasets.labels import LabelDirectory as JLabelDirectory
from sage_icp_tpu.metrics import kitti as j_metrics
from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import geometry as jgeo
from sage_icp_tpu.runtime import checkpoint as j_ckpt
from sage_icp_tpu.runtime import keyframes as j_kf
from sage_icp_tpu.runtime import runner as j_runner
from sage_icp_tpu.utils import visualization as j_viz
from sage_icp_tpu_torch.datasets import kitti as t_kitti
from sage_icp_tpu_torch.datasets import kitti360 as t_kitti360
from sage_icp_tpu_torch.datasets import kitti_raw as t_kitti_raw
from sage_icp_tpu_torch.datasets.labels import LabelDirectory
from sage_icp_tpu_torch.metrics import kitti as t_metrics
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.models.state_io import state_to_numpy
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.runtime import checkpoint as t_ckpt
from sage_icp_tpu_torch.runtime import cli
from sage_icp_tpu_torch.runtime import keyframes as t_kf
from sage_icp_tpu_torch.runtime import runner as t_runner
from sage_icp_tpu_torch.utils import synthetic
from sage_icp_tpu_torch.utils import visualization as t_viz
from tests.test_checkpoint_viz import tiny_cfg
from tests.test_metrics_runtime import make_traj

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module: the suite runs six workers on
    the host's cores, and PyTorch's default of one thread a core makes
    them spin against each other (small tensors slowed down 30x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the JAX reader goes through its native loader when the extension is built
READ_ATOL = 0.0 if j_kitti._native is None else 1e-5


def assert_scans_equal(got, want, atol=0.0):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=atol)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


# ---------------- dataset readers ----------------


def write_kitti_sequence(root, rng, n=50):
    """tests/test_metrics_runtime.py's mini KITTI odometry sequence."""
    seq_dir = root / "sequences" / "00"
    (seq_dir / "velodyne").mkdir(parents=True)
    (seq_dir / "labels").mkdir()
    for i in range(2):
        (rng.normal(size=(n, 4)) * 20).astype(np.float32).tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
        (rng.choice([10, 40, 50], size=n).astype(np.int32) | (7 << 16)).tofile(seq_dir / "labels" / f"{i:06d}.label")
    (seq_dir / "times.txt").write_text("0.0\n0.1\n")
    (seq_dir / "calib.txt").write_text("P2: 7 0 6 4 0 7 1 0 0 0 1 0\nTr: 1 0 0 0.1 0 1 0 0 0 0 1 0\n")
    (seq_dir / "00.txt").write_text("1 0 0 0 0 1 0 0 0 0 1 0\n1 0 0 1 0 1 0 0 0 0 1 0\n")


def write_raw_drive(root, rng, drive="0001", n=40, labels=False):
    """tests/test_metrics_runtime.py's mini raw drive, with .label files
    beside it when asked."""
    drive_dir = root / "2011_09_26" / f"2011_09_26_drive_{drive}_sync"
    (drive_dir / "velodyne_points" / "data").mkdir(parents=True)
    (drive_dir / "oxts" / "data").mkdir(parents=True)
    for i in range(3):
        (rng.normal(size=(n, 4)) * 20).astype(np.float32).tofile(drive_dir / "velodyne_points" / "data" / f"{i:010d}.bin")
        rec = f"49.0 {8.43 + i * 1e-5} 112.8 0.0 0.0 0.1" + " 0.0" * 24
        (drive_dir / "oxts" / "data" / f"{i:010d}.txt").write_text(rec)
    if labels:
        (root / "raw_labels").mkdir()
        for i in range(3):
            rng.choice([40, 50], size=n).astype(np.int32).tofile(root / "raw_labels" / f"{i:010d}.label")


@pytest.mark.parametrize("correct", [False, True])
def test_kitti_reader_matches_jax(tmp_path, correct):
    write_kitti_sequence(tmp_path, np.random.default_rng(0))
    want = j_kitti.KittiOdometrySequence(str(tmp_path), 0, apply_scan_correction=correct)
    got = t_kitti.KittiOdometrySequence(str(tmp_path), 0, apply_scan_correction=correct)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert_scans_equal(a, b, READ_ATOL if correct else 0.0)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_array_equal(got.gt_poses, want.gt_poses)
    assert got.calib.keys() == want.calib.keys()
    for k in want.calib:
        np.testing.assert_array_equal(got.calib[k], want.calib[k])
    unlabelled = t_kitti.KittiOdometrySequence(str(tmp_path), 0, with_labels=False, apply_scan_correction=correct)
    assert_scans_equal(unlabelled.read_scan(1),
                       j_kitti.KittiOdometrySequence(str(tmp_path), 0, with_labels=False,
                                                     apply_scan_correction=correct).read_scan(1),
                       READ_ATOL if correct else 0.0)


def test_kitti_helpers_match_jax():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(500, 3)) * 30
    np.testing.assert_array_equal(t_kitti.correct_kitti_scan(xyz), j_kitti.correct_kitti_scan(xyz))
    np.testing.assert_array_equal(t_kitti.azimuth_timestamps(xyz.astype(np.float32)),
                                  j_kitti.azimuth_timestamps(xyz.astype(np.float32)))


def test_kitti360_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    drive = "2013_05_28_drive_0000_sync"
    vdir = tmp_path / "data" / drive / "velodyne_points" / "data"
    vdir.mkdir(parents=True)
    for i in (3, 4, 7):
        rng.normal(size=(30, 4)).astype(np.float32).tofile(vdir / f"{i:010d}.bin")
    (tmp_path / "poses" / drive).mkdir(parents=True)
    rows = [f"{i} " + " ".join(f"{v:.6f}" for v in rng.normal(size=12)) for i in (3, 7)]
    (tmp_path / "poses" / drive / "poses.txt").write_text("\n".join(rows) + "\n")
    args = (str(tmp_path / "data"), drive, str(tmp_path / "poses"))
    got, want = t_kitti360.Kitti360Sequence(*args), j_kitti360.Kitti360Sequence(*args)
    assert len(got) == len(want) == 3 and got.frame_ids == want.frame_ids
    for i in range(3):
        assert_scans_equal(got.read_scan(i), want.read_scan(i))
        g, w = got.gt_pose(i), want.gt_pose(i)
        assert (g is None) == (w is None) and (g is None or np.array_equal(g, w))
    assert got.gt_pose(1) is None
    rec = (49.01, 8.43, 112.8, 0.01, -0.02, 0.3)
    np.testing.assert_array_equal(t_kitti360.oxts_to_pose(*rec), j_kitti360.oxts_to_pose(*rec))


def test_kitti_raw_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    write_raw_drive(tmp_path, rng, labels=True)
    write_raw_drive(tmp_path, rng, drive="0005")
    for labels_dir in (None, str(tmp_path / "raw_labels")):
        got = t_kitti_raw.KittiRawSequence(str(tmp_path), "2011_09_26", "0001", labels_dir=labels_dir)
        want = j_kitti_raw.KittiRawSequence(str(tmp_path), "2011_09_26", "0001", labels_dir=labels_dir)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert_scans_equal(a, b)
        np.testing.assert_array_equal(got.gt_poses, want.gt_poses)
    assert t_kitti_raw.discover_drives(str(tmp_path)) == j_kitti_raw.discover_drives(str(tmp_path))
    assert len(t_kitti_raw.discover_drives(str(tmp_path))) == 2


def test_label_directory_matches_jax(tmp_path):
    """tests/test_metrics_runtime.py's .label/.npy directory, a short
    frame and a frame past the end included."""
    d = tmp_path / "labs"
    d.mkdir()
    ((np.arange(5, dtype=np.int32) + 40) | (7 << 16)).tofile(d / "000000.label")
    np.save(d / "000001.npy", np.full(3, 50, dtype=np.int64))
    scan = np.concatenate([np.random.default_rng(0).normal(size=(5, 3)), np.full((5, 1), 99.0)], 1).astype(np.float32)
    got, want = LabelDirectory(str(d)), JLabelDirectory(str(d))
    for i in range(3):
        np.testing.assert_array_equal(got.apply(i, scan), want.apply(i, scan))
    assert got.mismatched_frames == want.mismatched_frames == 2
    for a, b in zip(LabelDirectory(str(d)).wrap([scan, scan]), JLabelDirectory(str(d)).wrap([scan, scan])):
        np.testing.assert_array_equal(a, b)


# ---------------- metrics and runner helpers ----------------


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    gt = make_traj(400)
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0, 0.01, (400, 3)), axis=0)
    np.testing.assert_allclose(t_metrics.seq_error(gt, est), j_metrics.seq_error(gt, est), rtol=1e-12)
    np.testing.assert_allclose(t_metrics.absolute_trajectory_error(gt, est),
                               j_metrics.absolute_trajectory_error(gt, est), rtol=1e-12)
    src, dst = est[:, :3, 3].T, gt[:, :3, 3].T
    np.testing.assert_allclose(t_metrics.umeyama(src, dst), j_metrics.umeyama(src, dst), rtol=1e-12, atol=1e-12)
    assert all(np.isnan(t_metrics.seq_error(gt[:20], est[:20])))


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_alignment_matches_jax(with_scale):
    rng = np.random.default_rng(5)
    src = rng.normal(size=(60, 3)) * 10
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    dst = 1.3 * src @ R.T + np.array([4.0, -2.0, 0.5]) + rng.normal(0, 0.01, (60, 3))
    f32 = lambda a: a.astype(np.float32)
    want = np.asarray(jgeo.umeyama_alignment(jnp.asarray(f32(src)), jnp.asarray(f32(dst)), with_scale))
    got = tgeo.umeyama_alignment(torch.from_numpy(f32(src)), torch.from_numpy(f32(dst)), with_scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_estimate_icp_times_matches_jax():
    rng = np.random.default_rng(0)
    iters = list(rng.integers(3, 40, size=30))
    tt = list(0.012 + 0.0007 * np.asarray(iters) + rng.normal(0, 1e-5, size=30))
    np.testing.assert_allclose(t_runner.estimate_icp_times(iters, tt), j_runner.estimate_icp_times(iters, tt),
                               rtol=1e-12)
    for it, tt in (([7] * 10, [0.02] * 10), ([5, 9, 3], [0.1, 0.2, 0.05])):
        assert t_runner.estimate_icp_times(it, tt) == j_runner.estimate_icp_times(it, tt) == [None] * len(tt)


def test_pose_to_tum_matches_jax():
    rng = np.random.default_rng(6)
    for k in range(20):
        pose = np.eye(4)
        twist = rng.normal(0, 1.0 if k % 2 else 1e-3, 6)
        pose[:3, :3] = np.asarray(jgeo.so3_exp(jnp.asarray(twist[3:], jnp.float32)))
        pose[:3, 3] = twist[:3] * 50
        got = [float(v) for v in t_runner.pose_to_tum(0.1 * k, pose).split()]
        want = [float(v) for v in j_runner.pose_to_tum(0.1 * k, pose).split()]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sequence_result_save_matches_jax(tmp_path):
    """The same files, line and column counts, "n/a" where t_icp is
    unknown, and numbers within 1e-6."""
    rng = np.random.default_rng(7)
    gt = make_traj(12)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (12, 3))
    icp = [None, None] + list(rng.uniform(0.01, 0.02, 10))
    tot = list(rng.uniform(0.02, 0.03, 12))
    args = ("seq", est, gt, icp, tot)
    t_runner.SequenceResult(*args).save(str(tmp_path / "port"))
    j_runner.SequenceResult(*args).save(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in ("path.txt", "gt_path.txt", "time.txt"):
        got = (tmp_path / "port" / name).read_text().splitlines()
        want = (tmp_path / "jax" / name).read_text().splitlines()
        assert len(got) == len(want) == 12
        for a, b in zip(got, want):
            a, b = a.split(), b.split()
            assert len(a) == len(b) == (3 if name == "time.txt" else 8)
            assert [v == "n/a" for v in a] == [v == "n/a" for v in b]
            np.testing.assert_allclose([float(v) for v in a if v != "n/a"],
                                       [float(v) for v in b if v != "n/a"], rtol=0, atol=1e-6)
    assert (tmp_path / "port" / "time.txt").read_text().splitlines()[0].split()[1] == "n/a"
    assert t_runner.SequenceResult(*args).metrics() == pytest.approx(j_runner.SequenceResult(*args).metrics(),
                                                                     rel=1e-12, nan_ok=True)


def test_keyframes_and_ply_match_jax(tmp_path):
    pts, labs = synthetic.build_world(seed=2, length=150.0)
    gt = synthetic.make_trajectory(4, step=5.0, accel_frames=1)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=4000) for i in range(4)]
    turn = gt[3].copy()
    turn[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]) @ turn[:3, :3]
    got, want = t_kf.KeyframeExtractor(), j_kf.KeyframeExtractor()
    for s, p in zip(scans, [*gt[:3], turn]):
        assert got.update(s, p) == want.update(s, p)
    assert got.keyframe_indices == want.keyframe_indices and len(got.keyframe_indices) >= 2
    t_viz.write_ply(str(tmp_path / "a.ply"), scans[0])
    j_viz.write_ply(str(tmp_path / "b.ply"), scans[0])
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


# ---------------- checkpoints ----------------


def port_tiny():
    return tpl.SageConfig(**dataclasses.asdict(tiny_cfg()))


@pytest.fixture(scope="module")
def port_run():
    """Three frames of the port on the CPU at tests/test_checkpoint_viz.py's
    tiny config, and the fourth scan."""
    pts, labs = synthetic.build_world(seed=4, length=50.0)
    gt = synthetic.make_trajectory(4, step=0.5)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=2500) for i in range(4)]
    odom = tpl.SageICP(port_tiny(), device="cpu")
    for s in scans[:3]:
        odom.register_frame(s)
    return odom, scans


def test_port_checkpoint_loads_into_jax(tmp_path, port_run):
    odom, _ = port_run
    path = str(tmp_path / "port.npz")
    t_ckpt.save_state(path, odom)
    jodom = j_ckpt.load_state(path, jpl.SageICP(tiny_cfg()))
    want, got = state_to_numpy(odom.state), state_to_numpy(jodom.state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.stack(jodom.poses), odom.trajectory())


def test_checkpoint_resume_equals_uninterrupted(tmp_path, port_run):
    """Save after frame 3, load into a fresh SageICP, register frame 4:
    the same pose and map as the run that was never interrupted."""
    odom, scans = port_run
    path = str(tmp_path / "state.npz")
    t_ckpt.save_state(path, odom)
    resumed = t_ckpt.load_state(path, tpl.SageICP(port_tiny(), device="cpu"))
    assert len(resumed.poses) == 3
    cont = tpl.SageICP(port_tiny(), device="cpu")
    cont.state = odom.state
    np.testing.assert_array_equal(resumed.register_frame(scans[3]), cont.register_frame(scans[3]))
    a, b = state_to_numpy(resumed.state), state_to_numpy(cont.state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert resumed.trajectory().shape == (4, 4, 4)


def rewrite(path, out, **changes):
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d.update(changes)
    for k in [k for k, v in d.items() if v is None]:
        del d[k]
    np.savez(out, **d)
    return out


@pytest.mark.parametrize("mismatch", ["capacity", "probe_depth", "hash_layout", "dense_grid", "map_grid",
                                      "no_metadata", "float_blocks", "map_grid_shape", "map_grid_missing"])
def test_checkpoint_refuses_mismatched_layouts(tmp_path, port_run, mismatch):
    """Every layout the loading config cannot read is refused, nothing
    loaded. The grid cases: a dense_grid flag or a map_grid array under a
    config without the grid; under a grid config, a map_grid of the wrong
    shape, or none."""
    odom, _ = port_run
    path = str(tmp_path / "state.npz")
    t_ckpt.save_state(path, odom)
    out = str(tmp_path / "bad.npz")
    changes = dict(
        capacity=dict(map_counts=np.zeros(4096, np.int32)),
        probe_depth=dict(probe_depth=np.asarray(odom.config.probe_depth + 4)),
        hash_layout=dict(hash_layout=np.asarray(2)),
        dense_grid=dict(dense_grid=np.asarray(True)),
        map_grid=dict(map_grid=np.zeros((8, 8, 8), np.int32)),
        no_metadata=dict(probe_depth=None, dense_grid=None),
        float_blocks=dict(map_points=np.zeros((8192, 4, 40), np.float32)),
        map_grid_shape=dict(dense_grid=np.asarray(True), map_grid=np.full((8, 2), -1, np.int32)),
        map_grid_missing=dict(dense_grid=np.asarray(True)),
    )[mismatch]
    grid_config = mismatch in ("map_grid_shape", "map_grid_missing")
    fresh = tpl.SageICP(dataclasses.replace(port_tiny(), dense_grid=grid_config), device="cpu")
    before = state_to_numpy(fresh.state)
    with pytest.raises(ValueError):
        t_ckpt.load_state(rewrite(path, out, **changes), fresh)
    for k, v in state_to_numpy(fresh.state).items():
        np.testing.assert_array_equal(v, before[k])


def test_icp_timer_clocks_the_solve_without_perturbing(port_run):
    """IcpTimer on the CPU: a positive time per frame, one replay per frame
    plus the first call's untimed one, and the trajectory of an untimed
    run."""
    _, scans = port_run
    timed, plain = tpl.SageICP(port_tiny(), device="cpu"), tpl.SageICP(port_tiny(), device="cpu")
    timer = t_runner.IcpTimer(timed)
    times = []
    for s in scans:
        times.append(timer.measure(timed.state, s))
        timed.register_frame(s)
        plain.register_frame(s)
    assert all(t > 0 for t in times) and len(timer.iterations) == len(scans) + 1
    assert timer.iterations[1:] == list(timed.icp_iters)
    np.testing.assert_array_equal(timed.trajectory(), plain.trajectory())


# ---------------- the CLI ----------------


def test_cli_on_cpu(tmp_path):
    """--synthetic --preset city --frames 3 --device cpu: metrics.json and
    the three per-sequence files, three lines each, t_icp "n/a" (three
    frames do not identify it)."""
    out = tmp_path / "out"
    results = cli.main(["--synthetic", "--preset", "city", "--frames", "3", "--device", "cpu", "--out", str(out)])
    metrics = json.loads((out / "metrics.json").read_text())
    assert set(metrics) == {"synthetic"} and metrics["synthetic"]["ate_trans_m"] < 0.05
    for name in ("path.txt", "gt_path.txt", "time.txt"):
        lines = (out / "synthetic" / name).read_text().splitlines()
        assert len(lines) == 3
    assert all(line.split()[1] == "n/a" for line in (out / "synthetic" / "time.txt").read_text().splitlines())
    res = results["synthetic"]
    assert int(res.totals.overflow_total()) == 0 and len(res.iterations) == 3


def test_cli_refuses_one_labels_dir_for_many_sequences(tmp_path):
    for argv in (["--dataset", "kitti", "--sequences", "0", "1"], ["--dataset", "kitti_raw"]):
        with pytest.raises(SystemExit):
            cli.parse_args(argv + ["--root", str(tmp_path), "--labels-dir", str(tmp_path)])
    args = cli.parse_args(["--dataset", "kitti", "--sequences", "4", "--labels-dir", str(tmp_path)])
    assert args.labels_dir == str(tmp_path)


def test_cli_device_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic", "--frames", "1", "--out", str(tmp_path)])
