"""downsample_ms_per_frame (ms, program span): the device time of the
scan head (deskew and preprocess, pipeline.scan_head) and the double
voxel downsample (pipeline.voxelize, ops/scan.py) a frame, their stages of
the device's stage clock over the window's untraced drives
(benchmark/recorded.py)."""

from benchmark import recorded


def read(run):
    return recorded.stage_ms_per_frame(run, "head", "downsample")
