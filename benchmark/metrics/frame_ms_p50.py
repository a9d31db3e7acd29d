"""frame_ms_p50 (ms, host clock): the median latency over every frame
of the window handed over alone, each timed from the scan handed to
SageICP.register_frame to its pose on the host."""

from benchmark import arith


def read(run):
    ms = run.window.frame_ms()
    return arith.percentile(ms, 50) if len(ms) else None
