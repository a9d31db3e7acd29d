"""device_idle_share.untraced (%, program spans): the share of the host's
time inside the program (its frame, chunk, trajectory and reinitialize
spans) in which the device ran none of the step's pieces, over the
untraced drives (benchmark/recorded.py): 1 - the frames' stage times
(the device's stage clock) / those spans. Standard error gets the
untraced breakdown: device ms a frame by stage, idle ms a frame by the
innermost host span, and the share from the calls' frames per second."""

import sys

from benchmark import recorded


def read(run):
    u = recorded.untraced(run)
    if u is None:
        return None
    spans = [s for s in u.spans if s.parent == -1 and s.name in recorded.TOP]
    inside = sum(s.ns for s in spans)
    if inside <= 0:
        return None
    frames, n = u.frames, len(u.frames)
    device = sum(f.device_ns for f in frames)
    stages = {k: sum(f.stages_ns[k] for f in frames) / 1e6 / n for k in frames[0].stages_ns}
    idle, unplaced, placed = recorded.idle_by_span(recorded.snapshot(run), u)
    calls = [s for s in spans if s.name in ("frame", "chunk")]
    wall = max(s.end_ns for s in calls) - min(s.start_ns for s in calls)
    print(f"device_idle_share.untraced: {n} frames of drives {u.drives}; device ms a frame "
          f"by stage {stages}; idle ms a frame by the innermost host span "
          f"{ {k: v / 1e6 / max(placed, 1) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])} } "
          f"({placed} frames placed, {unplaced / 1e6} ms unplaced); 1 - stage ms x frames per second of the calls "
          f"{100.0 * (1.0 - device / wall)} % ({1e9 * n / wall} frames/s)", file=sys.stderr)
    return 100.0 * (1.0 - device / inside)
