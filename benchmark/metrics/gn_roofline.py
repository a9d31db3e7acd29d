"""gn_roofline (%, device trace): the least time the traced drive's
running GN launches need, over the time the profiler gives
gn_iteration_kernel (csrc/gn_iteration.cu), the launches that find the
loop stopped included.

A running launch needs arith.gn_launch_bytes and gn_launch_flops of its
live correspondence rows (rows with a used query slot), at the card's
peaks; a frame runs as many as its ICP iterations (the program's count).
The step reports no row count, so the rows of each iteration are the
reference's, which builds the same rows from the same scans (a frame
whose iteration count differs takes the reference's rows in order, its
last anchor's repeated). Which bound holds goes to standard error."""

import sys

from benchmark import arith

KERNEL = "gn_iteration_kernel"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    measured = run.trace.device_seconds(lambda n: KERNEL in n)
    if measured is None:
        return None
    cfg = run.cell.sage
    P = cfg["corr_queries_per_voxel"]
    R = cfg["corr_unique_voxel_rows"] + cfg["corr_overflow_rows"]
    M = 27 * (cfg["basic_points_per_voxel"] + cfg["critical_points_per_voxel"])
    need, bounds = 0.0, set()
    for frame, iters in enumerate(run.traced.iterations):
        rows = run.reference.live_rows[frame]
        for it in range(int(iters)):
            live = rows[min(it, len(rows) - 1)]
            t, bound = arith.least_seconds(arith.gn_launch_bytes(live, R, P, M), arith.gn_launch_flops(live, P, M),
                                           run.peaks)
            need += t
            bounds.add(bound)
    print(f"gn_roofline: {need} s needed ({' and '.join(sorted(bounds))} bound), {measured} s measured",
          file=sys.stderr)
    return arith.roofline_percent(need, measured)
