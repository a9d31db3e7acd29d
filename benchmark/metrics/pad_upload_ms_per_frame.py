"""pad_upload_ms_per_frame (ms, program span): the host's time in the
program's pad spans (SageICP.pad_chunk) and upload spans (the step's
input copy and register_chunk's copy to the device) a frame, over the
window's untraced drives (benchmark/recorded.py)."""

from benchmark import recorded


def read(run):
    return recorded.span_ms_per_frame(run, "pad", "upload")
