"""deskew_ms_per_frame (ms, program span): the device time of the scan
head's deskew (scan.deskew in pipeline.scan_head) a frame, its stage of
the device's stage clock over the window's untraced drives
(benchmark/recorded.py). None when no frame's record holds a deskew
stage, as with a program whose clock has none."""

from benchmark import recorded

STAGE = "deskew"


def read(run):
    u = recorded.untraced(run)
    if u is None or any(STAGE not in f.stages_ns for f in u.frames):
        return None
    return recorded.stage_ms_per_frame(run, STAGE)
