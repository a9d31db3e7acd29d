"""The readers of the program's recorder (benchmark/recorded.py): which
drives the untraced metrics read."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import recorded
from sage_icp_tpu_torch.runtime import tracing


def recorder_with_drives(calls_per_drive: list) -> tracing.Recorder:
    """A recorder whose drives 1, 2, ... ran these many calls of two
    frames each, stamped on the CPU, as SageICP's drives record them."""
    rec = tracing.Recorder(frames=64)
    cpu = torch.device("cpu")
    clock = tracing.StageClock(rec, cpu)
    for calls in calls_per_drive:
        rec.new_drive()
        with rec.span("reinitialize"):
            pass
        for _ in range(calls):
            with rec.span("chunk", opens_frame=True):
                for _ in range(2):
                    rec.begin_frame(clock)
                    with rec.span("launch.prepare"):
                        clock.begin()
                        clock.close(tracing.ICP)
                    clock.start()
                    clock.end_frame(tracing.UPDATE)
                    rec.close_frame()
                    rec.end_frame()
        with rec.span("trajectory"):
            pass
    return rec


@pytest.mark.parametrize("window", [1, 2, 4])
def test_the_readers_take_exactly_the_windows_untraced_drives(window, monkeypatch):
    """The recorder's drives: SageICP's own at its construction (no call),
    the set-up drive, then the window's. The untraced metrics read the
    window's drives after the traced one, and the set-up drive less its
    first call when the traced drive fills the window."""
    rec = recorder_with_drives([0, 3] + [3] * window)
    snap = rec.read()
    monkeypatch.setattr(recorded, "snapshot", lambda run: snap)
    run = types.SimpleNamespace(window=types.SimpleNamespace(drives=[None] * window))
    u = recorded.untraced(run)
    setup, traced = 2, 3
    assert recorded.window_drives(run, snap) == list(range(traced, traced + window))
    if window > 1:
        assert not u.setup
        assert u.drives == list(range(traced + 1, traced + window))
        assert {f.drive for f in u.frames} == set(u.drives) and len(u.frames) == 6 * (window - 1)
        assert {s.drive for s in u.spans} == set(u.drives)
        assert len([s for s in u.spans if s.name == "chunk"]) == 3 * (window - 1)
    else:
        assert u.setup and u.drives == [setup]
        first = min(s.seq for s in snap.spans_of([setup]) if s.name == "chunk")
        assert len(u.frames) == 4 and all(f.drive == setup for f in u.frames)
        assert min(f.frame for f in u.frames) == min(f.frame for f in snap.frames_of([setup])) + 2
        assert len([s for s in u.spans if s.name == "chunk"]) == 2
        assert not [s for s in u.spans if s.seq == first or s.parent == first]
        assert [s.name for s in u.spans if s.parent == -1 and s.name not in ("chunk",)] == ["reinitialize",
                                                                                             "trajectory"]
    assert recorded.stage_ms_per_frame(run, "icp", "update") is not None
    assert recorded.span_ms_per_frame(run, "chunk") is not None


def test_a_set_up_drive_of_one_call_reads_nothing(monkeypatch):
    """A set-up drive with no call after its first (which builds the
    kernels and captures the graphs) gives the untraced metrics nothing."""
    snap = recorder_with_drives([0, 1, 3]).read()
    monkeypatch.setattr(recorded, "snapshot", lambda run: snap)
    run = types.SimpleNamespace(window=types.SimpleNamespace(drives=[None]))
    assert recorded.untraced(run) is None
    assert recorded.stage_ms_per_frame(run, "icp") is None
    assert recorded.span_ms_per_frame(run, "pad") is None


def test_a_program_without_a_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(recorded, "snapshot", lambda run: None)
    run = types.SimpleNamespace(window=types.SimpleNamespace(drives=[None] * 3))
    assert recorded.untraced(run) is None
    assert recorded.stage_ms_per_frame(run, "icp") is None
    assert recorded.span_ms_per_frame(run, "pad") is None
