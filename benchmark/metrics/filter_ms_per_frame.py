"""filter_ms_per_frame (ms, program span): the device time of the
dynamic filter (filter_dynamic_vehicles, ops/dynamic_filter.py) a frame,
its stage of the device's stage clock over the window's untraced drives
(benchmark/recorded.py); 0 with the filter off."""

from benchmark import recorded


def read(run):
    return recorded.stage_ms_per_frame(run, "filter")
