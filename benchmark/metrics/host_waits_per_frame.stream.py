"""host_waits_per_frame.stream (waits/frame, device trace): the CUDA
runtime calls of the traced drive that make the host wait for the card
(stream, event and device synchronisations, synchronous copies:
devtrace.HOST_WAIT) on the drive's thread, over its frames. Layer: the
SageICP host wrapper (models/pipeline.py)."""

from benchmark import devtrace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return run.trace.host_calls(devtrace.HOST_WAIT) / run.traced.frames
