"""gn_roofline_counted (%, program counter): gn_roofline with the
program's own rows. The least time the traced drive's running GN launches
need, over the time the profiler gives gn_iteration_kernel
(csrc/gn_iteration.cu), the launches that find the loop stopped included.

A running launch needs arith.gn_launch_bytes and gn_launch_flops of its
live rows at the card's peaks. The program counts a frame's live rows
over its running launches on the device (the recorder's live_rows,
benchmark/recorded.py), and a frame runs as many launches as its ICP
iterations; both counts are linear in the rows, so a frame's launches
need its iterations times what a launch of its mean rows needs. Which
bound holds goes to standard error."""

import sys

from benchmark import arith, recorded

KERNEL = "gn_iteration_kernel"


def read(run):
    if run.trace is None or run.peaks is None or run.traced is None:
        return None
    snap = recorded.snapshot(run)
    if snap is None:
        return None
    drives = recorded.window_drives(run, snap)
    frames = [] if drives is None else snap.frames_of(drives[:1])
    iterations = run.traced.iterations
    measured = run.trace.device_seconds(lambda n: KERNEL in n)
    if measured is None or len(frames) != len(iterations) or any(f.live_rows is None for f in frames):
        return None
    cfg = run.cell.sage
    P = cfg["corr_queries_per_voxel"]
    R = cfg["corr_unique_voxel_rows"] + cfg["corr_overflow_rows"]
    M = 27 * (cfg["basic_points_per_voxel"] + cfg["critical_points_per_voxel"])
    need, bounds, rows = 0.0, set(), 0
    for f, iters in zip(frames, iterations):
        if iters <= 0:
            continue
        live = f.live_rows / int(iters)
        t, bound = arith.least_seconds(arith.gn_launch_bytes(live, R, P, M), arith.gn_launch_flops(live, P, M),
                                       run.peaks)
        need += int(iters) * t
        bounds.add(bound)
        rows += f.live_rows
    print(f"gn_roofline_counted: {rows} live rows over {int(iterations.sum())} running launches; {need} s needed "
          f"({' and '.join(sorted(bounds))} bound), {measured} s measured", file=sys.stderr)
    return arith.roofline_percent(need, measured)
