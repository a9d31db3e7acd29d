"""frame_ms_p95 (ms, host clock): the 95th percentile of the frame
latencies frame_ms_p50 reads, over every frame of the window (run.py
prints their count)."""

from benchmark import arith


def read(run):
    ms = run.window.frame_ms()
    return arith.percentile(ms, 95) if len(ms) else None
