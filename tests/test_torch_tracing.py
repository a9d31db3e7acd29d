"""The recorder (sage_icp_tpu_torch/runtime/tracing.py): host spans and
their nesting, the frames' records through SageICP, the stage clock's
rows on the CPU, the profiler's view of the spans, the rings' bounds,
the GN live-row and found-pair counters and the deskew stage with its
count; on the card, the captured step's stamps. This file imports no JAX, so the
card's test runs where only PyTorch is:

    python -m pytest tests/test_torch_tracing.py -m cuda -q --noconftest
"""

import time

import numpy as np
import pytest
import torch

from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import correspondence_fast as tcf
from sage_icp_tpu_torch.ops import cuda_lib
from sage_icp_tpu_torch.ops import dynamic_filter as tdyn
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import icp_kernel as ik
from sage_icp_tpu_torch.ops import registration as treg
from sage_icp_tpu_torch.runtime import tracing
from sage_icp_tpu_torch.utils import synthetic

# tests/test_torch_bench.py's TINY_KITTI (the filter on), float32 upload
TINY = dict(scan_capacity=8192, frame_capacity=8192, source_capacity=8192, map_capacity=65536,
            dynamic_vehicle_filter=True, min_range=2.0, corr_unique_voxel_rows=4096, corr_overflow_rows=512,
            insert_unique_capacity=6144, basic_points_per_voxel=5, critical_points_per_voxel=5,
            label_max_range=10.0)
# tests/test_torch_cuda.py's golden-fixture configuration (the filter off)
GOLDEN = dict(scan_capacity=16384, frame_capacity=16384, source_capacity=8192, map_capacity=65536,
              dynamic_vehicle_filter=False, min_range=1.0, corr_unique_voxel_rows=8192, corr_overflow_rows=512,
              insert_unique_capacity=9216)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module (see tests/test_torch_runtime.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def scans_of(n, size=160.0, n_target=5000):
    world = synthetic.build_city_world(seed=0, size=size, density=0.5)
    gt = synthetic.make_trajectory(n, step=1.0)
    rng = np.random.default_rng(0)
    return [synthetic.render_scan(*world, gt[i], rng, n_target=n_target, max_range=60.0) for i in range(n)]


@pytest.fixture(scope="module")
def drive():
    """Two frames by register_frame, then a chunk of three, on the CPU:
    (SageICP, the recorder's snapshot)."""
    scans = scans_of(5)
    odom = tpl.SageICP(tpl.SageConfig(**TINY), device="cpu")
    for s in scans[:2]:
        odom.register_frame(s)
    odom.register_chunk(scans[2:])
    odom.trajectory()
    return odom, tracing.RECORDER.read()


def test_spans_nest_with_parents_and_self_time():
    rec = tracing.Recorder(frames=8)
    with rec.span("outer"):
        time.sleep(0.002)
        with rec.span("inner"):
            time.sleep(0.003)
            with rec.span("leaf"):
                pass
        with rec.span("inner"):
            pass
    snap = rec.read()
    names = [(s.name, s.parent) for s in snap.spans]
    outer, inner, leaf, inner2 = snap.spans
    assert names == [("outer", -1), ("inner", outer.seq), ("leaf", inner.seq), ("inner", outer.seq)]
    assert all(s.frame == -1 and s.drive == rec.drive for s in snap.spans)
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns <= inner.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns
    own = snap.self_ns()
    assert own[outer.seq] == outer.ns - inner.ns - inner2.ns >= 2_000_000
    assert own[inner.seq] == inner.ns - leaf.ns >= 3_000_000
    assert own[leaf.seq] == leaf.ns >= 0


def test_one_record_a_frame_and_w_a_chunk(drive):
    odom, snap = drive
    frames = snap.frames_of([odom.drive])
    assert len(frames) == 5 == len(odom.iteration_counts())
    assert [f.frame for f in frames] == list(range(frames[0].frame, frames[0].frame + 5))
    names = [[s.name for s in f.spans] for f in frames]
    for n in names[:2]:
        assert n[:3] == ["frame", "pad", "upload"] and n[-2:] == ["launch.finish", "wait.pose"]
        assert "launch.prepare" in n and "wait.status" in n
    assert names[2][:4] == ["chunk", "pad", "upload", "upload"]
    for n in names[3:]:
        assert n[0] == "upload" and n[1] == "launch.prepare" and n[-1] == "launch.finish"
    top = [s.name for s in snap.spans_of([odom.drive]) if s.parent == -1]
    assert top == ["reinitialize", "frame", "frame", "chunk", "trajectory"]
    for f, iters in zip(frames, odom.iteration_counts()):
        assert f.live_rows is not None and f.live_rows >= iters > 0
    assert frames[0].corr_found_pairs == 0 and all(f.corr_found_pairs > 0 for f in frames[1:])


def test_every_stage_slot_is_present_and_in_order(drive):
    odom, snap = drive
    frames = snap.frames_of([odom.drive])
    for f in frames:
        assert set(f.stages_ns) == set(tracing.STAGES) and all(v >= 0 for v in f.stages_ns.values())
        assert f.stages_ns["filter"] > 0 and f.stages_ns["icp"] > 0 and f.stages_ns["update"] > 0
        assert f.pieces_run == len(f.pieces) >= 2
        edges = [x for p in f.pieces for x in p]
        assert edges == sorted(edges) and f.first_ns == edges[0] and f.last_ns == edges[-1]
        assert f.device_ns <= sum(b - a for a, b in f.pieces) <= f.last_ns - f.first_ns
    for a, b in zip(frames, frames[1:]):
        assert a.last_ns <= b.first_ns
    assert snap.offsets()[odom.drive] == 0  # the CPU's rows hold host times


def test_spans_enter_the_profiler_only_while_it_records(drive, monkeypatch):
    odom, _ = drive
    scan = scans_of(1)[0]
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: (entered.append(name), real(name))[1])
    odom.register_frame(scan)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        odom.register_frame(scan)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    want = {tracing.PREFIX + n for n in ("frame", "pad", "upload", "launch.prepare", "wait.status",
                                         "launch.finish", "wait.pose")}
    assert want <= names and want <= set(entered)


def test_the_rings_wrap_at_their_capacity():
    rec = tracing.Recorder(frames=4)
    cap = 4 * tracing.SPANS_PER_FRAME
    for _ in range(cap + 10):
        with rec.span("s"):
            pass
    assert [s.seq for s in rec.read().spans] == list(range(10, cap + 10))
    clock = tracing.StageClock(rec, torch.device("cpu"))
    for _ in range(10):
        rec.begin_frame(clock)
        clock.begin()
        clock.end_frame(tracing.UPDATE)
        rec.close_frame()
        rec.end_frame()
    assert [f.frame for f in rec.read().frames] == [6, 7, 8, 9]


@pytest.mark.parametrize("scene", ["parked_moving", "car_row", "drive"])
def test_filter_counts_equal_a_host_replay(scene, request):
    """The min-diffusion's two counts in a frame's row, the occupied
    vehicle cells and the rounds that changed an id, against
    diffusion_replay of the frame's vehicle sort keys: the filter alone in
    a frame at the kitti preset (the car row's rounds reach the cut), and
    the CPU drive's frames (the filter at a 10 m label range)."""
    # imported here: the card's run of this file (--noconftest) imports
    # no other test module
    from tests.test_torch_cuda import car_row_scan, diffusion_replay, parked_moving_scan, recorded, vehicle_keys

    if scene == "drive":
        odom, snap = request.getfixturevalue("drive")
        cfg = odom.config
        frames = snap.frames_of([odom.drive])
        scans = scans_of(5)
        assert len(frames) == len(scans)
        seen = []
        for f, s in zip(frames, scans):
            pts, valid, _ = tpl._split_packed(torch.from_numpy(odom.pad_chunk([s])[0]))
            _, cells, rounds = diffusion_replay(vehicle_keys(pts, valid, cfg).numpy(),
                                                tdyn._grid_nx(cfg.label_max_range))
            assert (f.vehicle_cells, f.diffusion_rounds) == (cells, rounds)
            seen.append(cells)
        assert max(seen) > 0
        return
    cfg = tpl.PRESETS["kitti"]
    buf, valid = parked_moving_scan() if scene == "parked_moving" else car_row_scan()
    _, record = recorded("cpu", lambda: tdyn.filter_dynamic_vehicles(torch.from_numpy(buf), torch.from_numpy(valid),
                                                                      cfg))
    pts, ok = torch.from_numpy(buf), torch.from_numpy(valid)
    _, cells, rounds = diffusion_replay(vehicle_keys(pts, ok, cfg).numpy(), tdyn._grid_nx(cfg.label_max_range))
    assert (record.vehicle_cells, record.diffusion_rounds) == (cells, rounds)
    assert cells > 0 and (rounds == tdyn._CC_ITERS) == (scene == "car_row")


def stamped(odom, scans) -> list:
    """Each frame's stamps, (op, slot) in order, as odom steps scans."""
    clock, frames = odom._step.clock, []
    real = clock._stamp

    def stamp(op, slot, value=None, into=tracing.LIVE_ROWS):
        if op == tracing.BEGIN:
            frames.append([])
        frames[-1].append((op, slot))
        real(op, slot, value, into)

    clock._stamp = stamp
    try:
        for s in scans:
            odom.register_frame(s)
    finally:
        del clock._stamp
    return frames


def test_deskew_has_its_stage_and_counts_the_moved_rows():
    """With deskew on, the head's clock splits after the deskew into the
    deskew stage (one more stamp than without, before the head's), and the
    frame's row counts the scan's valid rows from the third pose on, 0
    before; without deskew the stamps are the same less that one, and the
    stage and the count read 0."""
    scans = scans_of(4)
    runs = {}
    for deskew in (False, True):
        odom = tpl.SageICP(tpl.SageConfig(**TINY, deskew=deskew), device="cpu")
        runs[deskew] = odom, stamped(odom, scans)
    (off, off_stamps), (on, on_stamps) = runs[False], runs[True]
    split = (tracing.SPLIT, tracing.DESKEW)
    for a, b in zip(off_stamps, on_stamps):
        assert split not in a and b.count(split) == 1
        k = b.index(split)
        assert b[k + 1] == (tracing.SPLIT, tracing.HEAD) and b[:k] + b[k + 1:] == a
    snap = tracing.RECORDER.read()
    for f in snap.frames_of([off.drive]):
        assert f.stages_ns["deskew"] == 0 and f.deskewed_points == 0 and f.stages_ns["head"] > 0
    frames = snap.frames_of([on.drive])
    assert len(frames) == len(scans)
    for k, (f, s) in enumerate(zip(frames, scans)):
        _, valid, _ = tpl._split_packed(torch.from_numpy(on.pad_chunk([s])[0]))
        assert f.stages_ns["deskew"] > 0 and f.stages_ns["head"] > 0
        assert f.deskewed_points == (int(valid.sum()) if k >= 3 else 0)
    assert frames[3].deskewed_points > 0


def test_a_step_that_raises_leaves_the_next_frame_its_own_row(monkeypatch):
    """The card's numbering on the CPU: a ring whose rows the stamps write
    as csrc/stage_clock.cu does, chosen by the ring's own frame counter.
    A step that raises before its last stamp (a wrong-shaped input) leaves
    no frame, and the frames after it read their own rows; a stamp outside
    a frame raises."""
    scans = scans_of(4)
    odom = tpl.SageICP(tpl.SageConfig(**TINY), device="cpu")
    clock = odom._step.clock
    class Ring:  # tracing._DeviceRing's fields, on the CPU
        device = torch.device("cpu")
        rows = torch.zeros((tracing.RECORDER.capacity, tracing.SLOTS), dtype=torch.int64)
        counter = torch.zeros((1,), dtype=torch.int64)
        begun = 0

    ring = clock._ring = Ring()
    monkeypatch.setitem(tracing.RECORDER._rings, "emulated", ring)

    def stamp(op, slot, value=None, into=tracing.LIVE_ROWS):
        if tracing.RECORDER._local.stack.current is None:
            raise RuntimeError("outside a frame")
        seq = int(ring.counter)
        row = ring.rows[seq % ring.rows.shape[0]].numpy()
        tracing.stamp_row(row, op, slot, time.perf_counter_ns(), seq, None if value is None else int(value), into)
        if op == tracing.END_FRAME:
            ring.counter += 1

    monkeypatch.setattr(clock, "_stamp", stamp)
    for s in scans[:2]:
        odom.register_frame(s)
    with pytest.raises(ValueError):
        odom._step(odom.state, torch.zeros((3, 4)))
    for s in scans[2:]:
        odom.register_frame(s)
    odom.trajectory()
    assert int(ring.counter) == ring.begun == 4
    frames = tracing.RECORDER.read().frames_of([odom.drive])
    assert len(frames) == 4
    for k, f in enumerate(frames):
        assert f.device == "cpu" and f.stages_ns is not None and f.stages_ns["update"] > 0
        assert f.live_rows == int(ring.rows[k, tracing.LIVE_ROWS]) > 0 and f.pieces_run >= 2
    with pytest.raises(RuntimeError, match="outside a frame"):
        tracing.StageClock(tracing.Recorder(frames=4), torch.device("cpu")).begin()


def test_counted_live_rows_equal_a_plain_count():
    """The loop's counter against the rows of each build times the
    iterations run on them, and its found pairs against each build's
    rows probed anew, through a re-anchor (tests/test_torch_cuda.py's
    two walls and a floor seen from an offset, the guess at identity:
    tests/test_torch_device_step.py's "reanchor" case)."""
    rng = np.random.default_rng(0)
    floor = np.stack([rng.uniform(-10, 10, 2000), rng.uniform(-10, 10, 2000), rng.normal(0, 0.01, 2000)], 1)
    wall1 = np.stack([rng.uniform(-10, 10, 1000), 8.0 + rng.normal(0, 0.01, 1000), rng.uniform(0, 5, 1000)], 1)
    wall2 = np.stack([-9.0 + rng.normal(0, 0.01, 1000), rng.uniform(-10, 10, 1000), rng.uniform(0, 5, 1000)], 1)
    world = torch.from_numpy(np.concatenate([floor, wall1, wall2]).astype(np.float32))
    world = torch.cat([world, torch.zeros((len(world), 1))], dim=1)
    n = len(world)
    mt, _ = thm.insert(thm.create(8192, 8), world, torch.ones(n, dtype=torch.bool), 1.0, 8,
                       torch.zeros(260, dtype=torch.bool))
    frame = tgeo.transform_points(tgeo.se3_inverse(tgeo.se3_exp(torch.tensor([0.12, -0.08, 0.04, 0.015, -0.01,
                                                                                0.02]))), world)
    fast = dict(unique_voxel_rows=896, queries_per_voxel=8, overflow_rows=128)
    loop = treg.IcpLoop(mt, frame, torch.ones(n, dtype=torch.bool), torch.eye(4), 1.0, 1.5, 0.5, 0.5, 60, 8, fast)

    def live():
        return int((loop.rows.used != 0).any(dim=1).sum())

    def found():
        center = loop.tables.center
        nb = (loop.rows.row_abs - center)[:, None, :] + thm.neighbor_offsets()[None]
        codes = torch.where((loop.rows.used != 0).any(dim=1)[:, None], tcf.pack_rel(nb), -1)
        return int(tcf.probe(loop.tables, nb + center, codes, 8)[0].sum())

    rows, done, want, builds, pairs = live(), 0, 0, 1, found()
    loop.block()
    while True:
        it = int(loop.loop_i[ik.I_ITERATIONS])
        want, done = want + (it - done) * rows, it
        s = loop.status()
        if s == ik.DONE:
            break
        if s == ik.REANCHOR:
            loop.reanchor()
            rows, builds, pairs = live(), builds + 1, pairs + found()
        loop.block()
    assert builds > 1 and 0 < rows < loop.rows.used.shape[0]
    assert int(loop.found_pairs) == pairs > 0
    assert int(loop.loop_i[ik.I_LIVE_ROWS]) == want
    assert int(loop.loop_i[ik.I_ROWS]) == rows


@pytest.mark.cuda
def test_captured_drive_stamps_every_frame_in_order_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pts, labs = synthetic.build_world(seed=1, length=80.0)
    gt = synthetic.make_trajectory(8, step=1.0)
    rng = np.random.default_rng(3)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000) for i in range(8)]
    odom = tpl.SageICP(tpl.SageConfig(**GOLDEN))
    assert odom.graph
    cuda_lib.reset_launches()
    for s in scans[:3]:
        odom.register_frame(s)
    with pytest.raises(ValueError):  # a step that raises leaves no frame
        odom._step(odom.state, torch.zeros((3, 4)))
    odom.register_chunk(scans[3:])
    odom.trajectory()
    snap = tracing.RECORDER.read()
    ring = odom._step.clock._ring
    assert int(ring.counter) == ring.begun
    frames = snap.frames_of([odom.drive])
    assert len(frames) == 8 and all(f.stages_ns is not None for f in frames)
    assert cuda_lib.launches()["stage_clock"] >= 8 * 6
    for f, iters in zip(frames, odom.iteration_counts()):
        assert f.stages_ns["filter"] == 0 and f.stages_ns["head"] > 0 and f.stages_ns["icp"] > 0
        assert f.live_rows >= iters > 0
        edges = [x for p in f.pieces for x in p]
        assert edges == sorted(edges) and f.first_ns == edges[0] and f.last_ns == edges[-1]
        assert 0 < f.device_ns <= sum(b - a for a, b in f.pieces) <= f.last_ns - f.first_ns
    for a, b in zip(frames, frames[1:]):
        assert a.last_ns <= b.first_ns
    assert odom.drive in snap.offsets()
