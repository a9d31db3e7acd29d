"""search_ms_per_frame (ms, program span): the device time of the
reference-shaped ICP loop's correspondence searches
(hashmap.get_correspondences in registration.RefLoop, every iteration) a
frame, their stage of the device's stage clock over the window's
untraced drives (benchmark/recorded.py). None when no frame's record
holds a search stage, as with a program whose clock has none."""

from benchmark import recorded

STAGE = "search"


def read(run):
    u = recorded.untraced(run)
    if u is None or any(STAGE not in f.stages_ns for f in u.frames):
        return None
    return recorded.stage_ms_per_frame(run, STAGE)
