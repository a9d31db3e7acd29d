"""The kitti_refloop.stream cell: its files found by name, and its two
readers, which read the search stage and the search counts of the
program's recorder and give nothing where a program records neither."""

from __future__ import annotations

import dataclasses
import importlib.util
import time
import types

import pytest
import torch

from benchmark import arith, cells, recorded
from benchmark.tests.conftest import ROOT
from sage_icp_tpu_torch.runtime import tracing

CELL = "kitti_refloop.stream"
READERS = ("search_ms_per_frame", "search_roofline")
COUNTS = ("search_sources", "search_pairs", "search_candidates")
SEARCH = (20_000, 90_000, 2_500_000)  # one search's sources, found pairs and candidates


def test_the_cell_loads_with_its_configuration_limits_and_metrics():
    cell = cells.load(ROOT, CELL)
    kitti = cells.load(ROOT, "kitti.stream")
    assert cell.chips == 1 and cell.traffic_name == "stream" and cell.traffic == kitti.traffic
    assert cell.sage == dict(kitti.sage, use_fast_correspondences=False)
    assert cell.config["scene"] == kitti.config["scene"]
    assert cell.config["reduced"] == kitti.config["reduced"] == ["drive_frames"]
    assert cell.config["drive_frames"] == kitti.config["drive_frames"]
    assert cell.config["assumed"] == kitti.config["assumed"]
    assert [m["name"] for m in cell.end_to_end] == ["scans_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert set(cell.limits) == set(kitti.limits)
    for name in READERS:
        assert callable(cells.reader(name))


def search_drives(drives: int = 3, frames: int = 4) -> tracing.Snapshot:
    """A recorder's snapshot of drives of single-frame calls stamped on
    the CPU as the reference-shaped loop stamps them: k + 1 searches in
    a drive's frame k, each the search stage (1 ms) between two stamps,
    with the frame's counts so far."""
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
                clock.split(tracing.HEAD)
                clock.split(tracing.DOWNSAMPLE)
                for n in range(1, k + 2):
                    clock.split(tracing.ICP)
                    time.sleep(0.001)
                    clock.split(tracing.SEARCH, torch.tensor([n * c for c in SEARCH], dtype=torch.int64),
                                tracing.SEARCH_SOURCES)
                clock.close(tracing.ICP)
                clock.start()
                clock.end_frame(tracing.UPDATE)
                rec.close_frame()
                rec.end_frame()
    return rec.read()


def without_search(snap: tracing.Snapshot) -> tracing.Snapshot:
    """The same records as a program with no search stage and no search
    counts holds them."""
    frames = []
    for f in snap.frames:
        fields = {k: v for k, v in dataclasses.asdict(f).items() if k not in COUNTS}
        fields["stages_ns"] = {k: v for k, v in f.stages_ns.items() if k != "search"}
        frames.append(types.SimpleNamespace(**fields))
    return tracing.Snapshot(frames, snap.spans)


def roofline_module():
    spec = importlib.util.spec_from_file_location("odobench_search_roofline",
                                                  cells.HERE / "metrics" / "search_roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_search_work_is_counted_from_the_three_counts():
    m = roofline_module()
    assert m.search_bytes(1, 0, 0) == 33 and m.search_bytes(0, 1, 0) == 12 and m.search_bytes(0, 0, 1) == 8
    assert m.search_flops(1) == 10 and m.search_bytes(*SEARCH) == 21_740_000
    # a kitti search's work is memory-bound, about 6 us at the card's peaks
    need, bound = arith.least_seconds(m.search_bytes(*SEARCH), m.search_flops(SEARCH[2]),
                                      arith.peaks("NVIDIA H100 80GB HBM3"))
    assert bound == "bytes" and need == pytest.approx(21_740_000 / 3.35e12)


@pytest.mark.parametrize("stage", [True, False], ids=["recorded", "not_recorded"])
def test_the_readers_read_the_stage_and_counts_or_nothing(stage, monkeypatch):
    snap = search_drives()
    monkeypatch.setattr(recorded, "snapshot", lambda run: snap if stage else without_search(snap))
    run = types.SimpleNamespace(window=types.SimpleNamespace(drives=[None] * 2),
                                peaks=arith.peaks("NVIDIA H100 80GB HBM3"))
    ms, share = (cells.reader(name)(run) for name in READERS)
    if not stage:
        assert ms is None and share is None
        return
    frames = snap.frames_of([snap.drives()[-1]])
    assert [f.search_sources for f in frames] == [SEARCH[0] * n for n in (1, 2, 3, 4)]
    assert [f.search_candidates for f in frames] == [SEARCH[2] * n for n in (1, 2, 3, 4)]
    assert ms == sum(f.stages_ns["search"] for f in frames) / 1e6 / len(frames) and ms >= 2.5
    sources, pairs, candidates = (sum(getattr(f, c) for f in frames) for c in COUNTS)
    assert (sources, pairs, candidates) == tuple(10 * c for c in SEARCH)
    m = roofline_module()
    need, bound = arith.least_seconds(m.search_bytes(sources, pairs, candidates), m.search_flops(candidates),
                                      run.peaks)
    assert bound == "bytes"
    assert share == pytest.approx(100.0 * need / (ms * len(frames) / 1e3))
    run.peaks = None
    assert cells.reader("search_roofline")(run) is None
