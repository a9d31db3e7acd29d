"""The readings that the limits of limits/<cell>.json are set from, on the
card at the cell's own size, in one process:

    python3 benchmark/control.py --workload kitti.stream --seeds 11,12,13 \\
        --control-seeds 21,22,23 --seconds 3 [--out chiprun_out/readings.jsonl]

For each of --seeds, a run of the cell (run.run_cell, a window of
--seconds) and its numbers against the reference: the lower readings,
from sound runs of the program. For each of --control-seeds, the control:
the reference itself in the program's place, its float32 matrix products
in TF32 (the nearest precision below the configuration's float32 with
TF32 off), over one whole drive, against the reference in full float32:
the upper readings. Each reading is printed as a JSON line (and appended
to --out). The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on one seed's drive: the reference in TF32
    runs the drive in the program's place, and the reference in float32
    follows it as it follows the program."""
    import numpy as np

    from benchmark import scenes, traffic, verdict
    from benchmark.reference import odometry as reference

    _, drives, times = scenes.cell_scenes(cell.config, seed, 1, device)
    scans = drives[0]
    stamps = times[0] if times is not None else [None] * len(scans)
    with reference.precision(tf32=True):
        ctl = reference.Reference(cell.sage, device)
        for s, ts in zip(scans, stamps):
            ctl.register(s, ts)
    with reference.precision(tf32=False):
        ref = reference.Reference(cell.sage, device)
        for s, ts, pose in zip(scans, stamps, ctl.poses):
            ref.register(s, ts, follow=pose)
    totals = {f: sum(c[f] for c in ctl.counters) for f in reference.DROP_COUNTERS}
    drive = traffic.Drive(0, len(scans), np.stack(ctl.poses), totals,
                          sum(c["landmark_cells_dropped"] for c in ctl.counters),
                          np.array([c["icp_iterations"] for c in ctl.counters]))
    return verdict.numbers(cell, [drive], ctl.state.map, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    from benchmark import run

    run.set_cache_dirs()
    import torch

    from benchmark import cells

    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        result = run.run_cell(cell, seed, args.seconds, False, device, t0, settle_s=0.0)
        emit({"cell": cell.name, "seed": seed, "kind": "program", "numbers": {k: v["value"] for k, v in
              result["checks"].items()}, "correct": result["correct"], "seconds": time.perf_counter() - t0})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        emit({"cell": cell.name, "seed": seed, "kind": "control_tf32", "numbers": control_numbers(cell, seed, device),
              "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
