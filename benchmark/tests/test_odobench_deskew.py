"""The kitti_deskew.stream cell: its files found by name, and its two
readers, which read the deskew stage and the deskewed-point count of the
program's recorder and give nothing where a program records neither."""

from __future__ import annotations

import dataclasses
import time
import types

import pytest
import torch

from benchmark import arith, cells, recorded
from benchmark.tests.conftest import ROOT
from sage_icp_tpu_torch.runtime import tracing

CELL = "kitti_deskew.stream"
READERS = ("deskew_ms_per_frame", "deskew_roofline")
POINTS = 80_000


def test_the_cell_loads_with_its_configuration_limits_and_metrics():
    cell = cells.load(ROOT, CELL)
    kitti = cells.load(ROOT, "kitti.stream")
    assert cell.chips == 1 and cell.traffic_name == "stream" and cell.traffic == kitti.traffic
    assert cell.sage == dict(kitti.sage, deskew=True)
    assert cell.config["scene"] == dict(kitti.config["scene"], sweep=True)
    assert cell.config["reduced"] == ["drive_frames"] and cell.config["drive_frames"] == kitti.config["drive_frames"]
    assert [m["name"] for m in cell.end_to_end] == ["scans_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert set(cell.limits) == set(kitti.limits)
    for name in READERS:
        assert callable(cells.reader(name))


def deskew_drives(drives: int = 3, frames: int = 4) -> tracing.Snapshot:
    """A recorder's snapshot of drives of single-frame calls stamped on
    the CPU as a deskewing step stamps them: the deskew stage (1 ms) with
    its count, POINTS from the drive's fourth frame on, then the head."""
    rec = tracing.Recorder(frames=64)
    clock = tracing.StageClock(rec, torch.device("cpu"))
    for _ in range(drives):
        rec.new_drive()
        with rec.span("reinitialize"):
            pass
        for k in range(frames):
            with rec.span("frame", opens_frame=True):
                rec.begin_frame(clock)
                clock.begin()
                time.sleep(0.001)
                clock.split(tracing.DESKEW, torch.tensor(POINTS if k >= 3 else 0, dtype=torch.int32),
                            tracing.DESKEWED_POINTS)
                clock.split(tracing.HEAD)
                clock.close(tracing.ICP)
                clock.start()
                clock.end_frame(tracing.UPDATE)
                rec.close_frame()
                rec.end_frame()
    return rec.read()


def without_deskew(snap: tracing.Snapshot) -> tracing.Snapshot:
    """The same records as a program with no deskew stage and no count
    holds them."""
    frames = []
    for f in snap.frames:
        fields = {k: v for k, v in dataclasses.asdict(f).items() if k != "deskewed_points"}
        fields["stages_ns"] = {k: v for k, v in f.stages_ns.items() if k != "deskew"}
        frames.append(types.SimpleNamespace(**fields))
    return tracing.Snapshot(frames, snap.spans)


@pytest.mark.parametrize("stage", [True, False], ids=["recorded", "not_recorded"])
def test_the_readers_read_the_stage_and_count_or_nothing(stage, monkeypatch):
    snap = deskew_drives()
    monkeypatch.setattr(recorded, "snapshot", lambda run: snap if stage else without_deskew(snap))
    run = types.SimpleNamespace(window=types.SimpleNamespace(drives=[None] * 2),
                                peaks=arith.peaks("NVIDIA H100 80GB HBM3"))
    ms, share = (cells.reader(name)(run) for name in READERS)
    if not stage:
        assert ms is None and share is None
        return
    frames = snap.frames_of([snap.drives()[-1]])
    assert [f.deskewed_points for f in frames] == [0, 0, 0, POINTS]
    assert ms == sum(f.stages_ns["deskew"] for f in frames) / 1e6 / len(frames) and ms >= 1.0
    need, bound = arith.least_seconds(POINTS * 28, POINTS * 119, run.peaks)
    assert bound == "bytes"
    assert share == pytest.approx(100.0 * need / (ms * len(frames) / 1e3))
    run.peaks = None
    assert cells.reader("deskew_roofline")(run) is None
