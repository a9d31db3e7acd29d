"""The benchmark's arithmetic: device busy time as a union, percentiles
and rates over the whole window, the GN kernel's byte count, and a
roofline share that cannot pass 105 % unnoticed."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest

from benchmark import arith, cells, devtrace, traffic


def test_busy_time_counts_overlapping_device_intervals_once():
    ops = [("a", 0, 10), ("b", 5, 15), ("c", 12, 14), ("d", 20, 30), ("e", 28, 40)]
    trace = devtrace.Trace(0, 35, ops, [])
    assert trace.busy_ns() == 15 + 10 + 5  # [0, 15], [20, 35] clipped to the window
    assert devtrace.idle_gaps(trace) == [(15, 20)]
    assert sum(e - s for _, s, e in ops) == 44  # a plain sum counts the overlaps twice
    assert trace.device_seconds(lambda n: n in "ab") == 20e-9
    assert trace.device_seconds(lambda n: n == "z") is None


def test_idle_gaps_are_labelled_by_what_the_host_was_doing():
    host = [("odobench.drive", 0, 100), ("odobench.call", 10, 50), ("cudaStreamSynchronize", 20, 30),
            ("odobench.drive_end", 60, 90)]
    trace = devtrace.Trace(0, 100, [("k", 0, 10), ("k", 40, 60), ("k", 95, 100)], host)
    assert devtrace.host_labels(trace, [25, 35, 70]) == ["call: cudaStreamSynchronize", "call", "drive_end"]
    out = devtrace.breakdown(trace)
    assert out["device_ops"] == [["k", 35e-9]]
    assert sorted(out["idle_gaps"]) == sorted([["call: cudaStreamSynchronize", 30e-9], ["drive_end", 35e-9]])


def window(frame_ms_by_drive, seconds, per_call=1):
    calls = [ms / 1e3 for drive in frame_ms_by_drive for ms in drive]
    drives = [traffic.Drive(i, len(d), np.zeros((len(d), 4, 4)), {}, 0, np.ones(len(d)))
              for i, d in enumerate(frame_ms_by_drive)]
    return traffic.Window(seconds, drives, calls, [per_call] * len(calls),
                          [i for d in frame_ms_by_drive for i in range(len(d))])


def read(metric, w):
    return cells.reader(metric)(types.SimpleNamespace(window=w, setup_s=1.0))


def test_latency_percentiles_are_taken_over_every_frame_not_over_drives():
    slow_start = [20.0] + [8.0] * 19
    w = window([slow_start, [8.0] * 20, [9.0] * 20], 1.0)
    every = [ms for d in ([slow_start, [8.0] * 20, [9.0] * 20]) for ms in d]
    assert read("frame_ms_p95", w) == pytest.approx(float(np.percentile(every, 95)))
    assert read("frame_ms_p50", w) == pytest.approx(float(np.percentile(every, 50)))
    per_drive = np.median([np.percentile(d, 95) for d in ([slow_start, [8.0] * 20, [9.0] * 20])])
    assert read("frame_ms_p95", w) != pytest.approx(per_drive)
    # chunks of frames have no per-frame latency
    assert read("frame_ms_p95", window([[240.0] * 4], 1.0, per_call=30)) is None


def test_scans_per_s_is_every_frame_over_the_whole_window():
    w = window([[8.0] * 120, [8.0] * 120], 2.5)  # calls add up to 1.92 s; resets and fetches fill the rest
    assert read("scans_per_s", w) == 240 / 2.5
    assert read("setup_s", w) == 1.0


def test_gn_bytes_match_chip_smoke_at_phase_3_kitti_shapes():
    # chip_smoke.py's KITTI shapes (R = 16,384 + 2,048, P = 2, K = 40, rows
    # live up to 14,000, whole tiles of 128) and its byte count, check_gn
    R, P, M = 16_384 + 2_048, 2, 27 * 40
    live_rows = math.ceil(14_000 / 128) * 128
    n_tiles = -(-R // 128)
    chip_smoke = live_rows * (4 * M * 2 + 4 * P * 4 + 3 * 4 + 3 * 4 + P * 4) + 3 * M * 4 + n_tiles * 4 + 18 * 4
    assert arith.gn_launch_bytes(live_rows, R, P, M) == chip_smoke
    assert arith.gn_launch_flops(live_rows, P, M) == live_rows * M * (6 + 10 * P)
    least, bound = arith.least_seconds(chip_smoke, arith.gn_launch_flops(live_rows, P, M), arith.PEAKS["H100"])
    assert bound == "bytes" and least * 1e3 == pytest.approx(0.0366, abs=5e-5)  # PERF.md's kitti bound


def test_a_roofline_share_above_105_percent_is_a_fault_and_not_clamped():
    assert arith.roofline_percent(1.04, 1.0) == pytest.approx(104.0)
    with pytest.raises(ValueError, match="above 105"):
        arith.roofline_percent(1.06, 1.0)
    assert arith.peaks("NVIDIA H100 80GB HBM3") == arith.PEAKS["H100"]
    assert arith.peaks("cpu") is None
