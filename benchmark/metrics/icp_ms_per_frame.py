"""icp_ms_per_frame (ms, program span): the device time of the ICP solve
a frame: the rest of prepare (sigma, prediction, probe tables, the
correspondence rows at the guess, the first block of iterations) and every
block and reanchor piece (ops/correspondence_fast.py,
ops/registration.py), its stage of the device's stage clock over the
window's untraced drives (benchmark/recorded.py)."""

from benchmark import recorded


def read(run):
    return recorded.stage_ms_per_frame(run, "icp")
