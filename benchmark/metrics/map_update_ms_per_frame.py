"""map_update_ms_per_frame (ms, program span): the device time of the
step's finish a frame: the solve's guard, the map insert and cull
(ops/hashmap.py), the new state and the running totals, its stage of the
device's stage clock over the window's untraced drives
(benchmark/recorded.py)."""

from benchmark import recorded


def read(run):
    return recorded.stage_ms_per_frame(run, "update")
