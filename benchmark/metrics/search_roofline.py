"""search_roofline (%, program counter): the reference-shaped loop's
correspondence searches against their roofline. The least time the
window's untraced frames need, over the device time of their search
stage (search_ms_per_frame's).

A frame's need is its searches' work, from the recorder's three counts
of the searches of a running loop: the valid sources searched, the
(source, neighbour voxel) pairs whose voxel is in the map, and the live
points of those pairs' blocks (the candidates). Each is defined by the
sources, the map and the 27 offsets, not by what the program reads, so
a search that prunes or reuses blocks is judged on the same work. At the
card's peaks (arith.least_seconds) that is search_bytes and
search_flops; which bound holds goes to standard error.

The bound counts each found pair's key and block once a pair. Sources
in one voxel share their 27 blocks, so reuse between neighbouring
sources, through L2 or shared memory, could in principle beat it; at the
kitti cell's sizes the bound is about 11 us a search, against 3.75 ms
measured before the search had a kernel of its own. None without a
card's peaks, or when a frame's record holds no search stage or no
search counts."""

import sys

from benchmark import arith, recorded

STAGE = "search"
COUNTS = ("search_sources", "search_pairs", "search_candidates")


def search_bytes(sources: int, pairs: int, candidates: int) -> int:
    """Each searched source's row read (4 float32) and its target (4
    float32) and verdict (1 byte) written; each found pair's voxel key
    (3 int32) read; each candidate's point (4 int16) read."""
    return sources * (16 + 16 + 1) + pairs * 12 + candidates * 8


def search_flops(candidates: int) -> int:
    """A candidate's squared distance (3 differences, 3 products, 2 sums),
    its semantic scale (1) and the compare with the best so far (1)."""
    return candidates * 10


def read(run):
    if run.peaks is None:
        return None
    u = recorded.untraced(run)
    if u is None or any(STAGE not in f.stages_ns or getattr(f, c, None) is None for f in u.frames for c in COUNTS):
        return None
    sources, pairs, candidates = (sum(getattr(f, c) for f in u.frames) for c in COUNTS)
    measured = sum(f.stages_ns[STAGE] for f in u.frames) / 1e9
    if measured <= 0:
        return None
    need, bound = arith.least_seconds(search_bytes(sources, pairs, candidates), search_flops(candidates), run.peaks)
    print(f"search_roofline: {sources} sources, {pairs} found pairs, {candidates} candidates searched over "
          f"{len(u.frames)} frames; {need} s needed ({bound} bound), {measured} s measured", file=sys.stderr)
    return arith.roofline_percent(need, measured)
