"""bench_torch.py, the port's counterpart of bench.py, on the CPU at tiny
sizes: the bench world and its scans at 5,000 points, a small config in
the style of test_robustness.small_config, phases of one warm-up frame,
one warm chunk and two timed chunks of one frame.

Checked: the JSON line's keys are exactly bench.py's (read from its
source), with the kitti phase on and off; every guard raises, one of them
on a drop that only the first timed chunk has (bench.py reads the last
chunk's counters and misses it); the bench's calls through the JAX
package's SageICP on the same scans give the same live voxels and
per-frame ICP iterations, ATE within 1e-5 m and poses within 1e-4
(test_torch_pipeline.py's carried-step tolerance); the timed chunks go
through SageICP's own staging (register_chunk on lists of scans), which
refuses a padded array or a tensor."""

import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import bench_torch
from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.runtime import tracing
from sage_icp_tpu_torch.utils import synthetic

ROOT = pathlib.Path(__file__).resolve().parents[1]
POINTS, WARMUP, CHUNK, FRAMES = 5000, 1, 1, 2
TINY = dict(scan_capacity=8192, frame_capacity=8192, source_capacity=8192, map_capacity=65536,
            dynamic_vehicle_filter=False, min_range=2.0, corr_unique_voxel_rows=4096, corr_overflow_rows=512,
            insert_unique_capacity=6144, basic_points_per_voxel=5, critical_points_per_voxel=5,
            quantized_scan_upload=True)
# the kitti phase's stand-in: the filter on over a 48 x 48 x 32 grid
TINY_KITTI = dict(TINY, dynamic_vehicle_filter=True, label_max_range=10.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module: the suite runs six workers on
    the host's cores (see tests/test_torch_runtime.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bench_py_keys(kitti: bool) -> list:
    """The keys of bench.py's `out`, in order: the dict literal's, then,
    with the kitti phase, those it adds."""
    src = (ROOT / "bench.py").read_text()
    literal = re.search(r"^    out = \{(.*?)^    \}", src, re.S | re.M).group(1)
    keys = re.findall(r'^\s*"(\w+)":', literal, re.M)
    return keys + (re.findall(r'out\["(\w+)"\] =', src) if kitti else [])


@pytest.fixture(scope="module")
def world():
    return synthetic.build_city_world(seed=0, size=420.0, density=0.7)


@pytest.fixture(scope="module")
def scans(world):
    gt = synthetic.make_trajectory(bench_torch.phase_length(WARMUP, FRAMES, CHUNK), step=1.0)
    return bench_torch.render_scans(world, tpl.SageConfig(**TINY), gt, POINTS, np.random.default_rng(0))


@pytest.fixture(scope="module")
def phase(scans):
    return bench_torch.run_phase(tpl.SageConfig(**TINY), None, WARMUP, FRAMES, POINTS, CHUNK, "city", "cpu",
                                 scans=scans)


@pytest.mark.parametrize("kitti", [True, False])
def test_json_line_has_bench_py_keys(kitti, monkeypatch, capsys):
    for k, v in dict(BENCH_DEVICE="cpu", BENCH_WARMUP=0, BENCH_CHUNK=1, BENCH_FRAMES=1, BENCH_POINTS=POINTS,
                     BENCH_KITTI=int(kitti)).items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setitem(tpl.PRESETS, "city", tpl.SageConfig(**TINY))
    monkeypatch.setitem(tpl.PRESETS, "kitti", tpl.SageConfig(**TINY_KITTI))
    out, phases = bench_torch.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    assert list(out) == bench_py_keys(kitti)
    assert len(bench_py_keys(True)) == 10 and len(bench_py_keys(False)) == 6
    assert set(phases) == ({"city", "kitti"} if kitti else {"city"})
    assert out["value"] > 0 and out["ate_m"] < bench_torch.MAX_ATE_M and out["map_voxels"] > 0
    assert all(r.frames == 2 and len(r.trajectory) == 2 for r in phases.values())


def guard_args(phase, scans, **change):
    """check_guards' arguments from the clean phase, with `change` applied
    (config fields, or totals / landmark_cells_dropped / gt)."""
    cfg = tpl.SageConfig(**TINY)
    args = dict(label="city", config=cfg, scans=scans, totals=phase.totals,
                landmark_cells_dropped=phase.landmark_cells_dropped, est=phase.trajectory,
                gt=synthetic.make_trajectory(len(scans), step=1.0))
    fields = {k: v for k, v in change.items() if k in TINY}
    args.update({k: v for k, v in change.items() if k not in TINY}, config=dataclasses.replace(cfg, **fields))
    return args


def test_clean_phase_passes_its_guards(phase, scans):
    assert int(phase.totals.overflow_total()) == 0 and phase.landmark_cells_dropped == 0
    assert bench_torch.check_guards(**guard_args(phase, scans)) == phase.ate_m
    assert phase.ate_m < 0.2


@pytest.mark.parametrize("field,counter", [("frame_capacity", "num_frame_ds"),
                                           ("source_capacity", "num_source"),
                                           ("scan_capacity", "scan_capacity")])
def test_capacity_guards_fire(phase, scans, field, counter):
    """A capacity just at the phase's maximum (over every frame) is
    undersized: the guard names the phase and the counter."""
    used = {"frame_capacity": int(phase.totals.num_frame_ds), "source_capacity": int(phase.totals.num_source),
            "scan_capacity": max(len(s) for s in scans) - 1}[field]
    with pytest.raises(bench_torch.GuardError, match=rf"\[city\] .*{counter}"):
        bench_torch.check_guards(**guard_args(phase, scans, **{field: used}))


def test_ate_guard_fires_on_shifted_ground_truth(phase, scans):
    gt = synthetic.make_trajectory(len(scans), step=1.0)
    gt[1:, 0, 3] += 2.0
    with pytest.raises(bench_torch.GuardError, match=r"\[city\] ATE"):
        bench_torch.check_guards(**guard_args(phase, scans, gt=gt))


def test_landmark_guard_fires(phase, scans):
    with pytest.raises(bench_torch.GuardError, match=r"\[city\] landmark_cells_dropped=3"):
        bench_torch.check_guards(**guard_args(phase, scans, landmark_cells_dropped=3))


def test_drop_in_first_timed_chunk_only_is_caught(world, scans, monkeypatch):
    """The first timed frame rendered at 7,000 points: its sources need
    more correspondence rows than the config has (corr_dropped > 0 in that
    frame only). bench.py's guard reads the last chunk's counters, which
    are clean here; the port's reads every frame's and raises."""
    gt = synthetic.make_trajectory(len(scans), step=1.0)
    dense = synthetic.render_scan(*world, gt[WARMUP + CHUNK], np.random.default_rng(1), n_target=7000,
                                  max_range=100.0)
    crowded = list(scans)
    crowded[WARMUP + CHUNK] = dense
    made = []

    class Recorded(tpl.SageICP):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tpl, "SageICP", Recorded)
    with pytest.raises(bench_torch.GuardError, match=r"\[city\] silent-drop counters .*corr_dropped=[1-9]"):
        bench_torch.run_phase(tpl.SageConfig(**TINY), None, WARMUP, FRAMES, POINTS, CHUNK, "city", "cpu",
                              scans=crowded)
    (odom,) = made
    assert int(odom.last_aux.overflow_total()) == 0  # what bench.py:113 reads
    assert int(odom.aux_totals().corr_dropped) > 0


def test_bench_calls_match_jax(phase, scans):
    """bench.py's calls, in order, through the JAX package's SageICP on
    the same scans: register_frame for the warm-up, register_chunk and
    trajectory() for the warm chunk, register_chunk for each timed chunk,
    trajectory()."""
    jodom = jpl.SageICP(jpl.SageConfig(**TINY))
    for i in range(WARMUP):
        jodom.register_frame(scans[i])
    jodom.register_chunk(scans[WARMUP:WARMUP + CHUNK])
    jodom.trajectory()
    for i in range(WARMUP + CHUNK, len(scans), CHUNK):
        jodom.register_chunk(scans[i:i + CHUNK])
    est = jodom.trajectory()
    np.testing.assert_array_equal(phase.iterations, jodom.iteration_counts())
    assert phase.map_voxels == int(np.asarray(jodom.state.map.counts > 0).sum())
    np.testing.assert_allclose(phase.trajectory, est, atol=1e-4)
    gt = synthetic.make_trajectory(len(scans), step=1.0)
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(est, gt)]
    assert abs(phase.ate_m - float(np.sqrt(np.mean(np.square(errs))))) < 1e-5
    assert int(jodom.aux_totals().overflow_total()) == 0


@pytest.mark.parametrize("form", ["array", "tensor"])
def test_register_chunk_refuses_a_padded_buffer(scans, form):
    """register_chunk takes the list of scans only: a padded buffer handed
    to it would be padded again, row by row."""
    odom = tpl.SageICP(tpl.SageConfig(**TINY), device="cpu")
    buf = odom.pad_chunk(scans[:1]).copy()
    with pytest.raises(TypeError, match="list of"):
        odom.register_chunk(buf if form == "array" else torch.from_numpy(buf))
    assert len(odom.trajectory()) == 0


def test_timed_chunks_are_staged_by_the_sage_icp(world, scans, monkeypatch):
    """run_phase hands each timed chunk to register_chunk as its list of
    scans: the recorder counts the chunk's rows on its first frame (a
    warm-up frame, the warm chunk and two timed chunks, of two frames
    each)."""
    chunk, frames = 2, 4
    gt = synthetic.make_trajectory(bench_torch.phase_length(WARMUP, frames, chunk), step=1.0)
    longer = bench_torch.render_scans(world, tpl.SageConfig(**TINY), gt, POINTS, np.random.default_rng(0),
                                      scans)
    made = []

    class Recorded(tpl.SageICP):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tpl, "SageICP", Recorded)
    bench_torch.run_phase(tpl.SageConfig(**TINY), None, WARMUP, frames, POINTS, chunk, "city", "cpu",
                          scans=longer)
    (odom,) = made
    rows = [len(s) for s in longer]
    firsts = range(WARMUP, len(longer), chunk)  # the warm chunk's and the timed chunks' first frames
    want = rows[:WARMUP] + [sum(rows[i:i + chunk]) if i in firsts else 0 for i in range(WARMUP, len(longer))]
    assert [f.staged_rows for f in tracing.RECORDER.read().frames_of([odom.drive])] == want
