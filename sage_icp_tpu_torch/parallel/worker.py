"""One rank of a sharded odometry run: join the process group, drive
ShardedSageICP over a file of scans, write what the rank computed.

    python -m sage_icp_tpu_torch.parallel.worker --rank 0 --world 2 \\
        --init file:///tmp/rdv --backend gloo --device cpu \\
        --preset kitti --scans scans.npy --out out/
    torchrun --nproc-per-node 4 -m sage_icp_tpu_torch.parallel.worker \\
        --scans scans.npy --out out/          # NCCL, one card a rank

Every rank reads the whole scan file (write it with save_scans: (F, N,
4) float32, rows past a scan's end INVALID_COORD), as every process of
the JAX package's multi-host run is handed the same host values. --config
names a JSON object of SageConfig fields applied over --preset. Without
--rank / --world / --init the torchrun environment is read. The step is
ShardedSageICP's default: captured as CUDA graphs over NCCL, eager over
gloo or on the CPU. The rank writes to --out:

  poses_<rank>.npy   (F, 4, 4) trajectory
  map_<rank>.npz     the final map (keys, counts, points, first_pts; grid with dense_grid)
  rank_<rank>.json   which step ran (graph), the aux totals, the ICP
                     iterations of each frame, cuda_lib.launches() (the
                     kernels' own counts, graph replays included), the
                     row counts the GN, policy and radius-count wrappers
                     were called with (a Python call each: every launch
                     of an eager step, but only the first frame's and the
                     captures' of a captured one), ms per frame after
                     the first (frames under --profile left out: the
                     recorder's `frame` spans, runtime/tracing.py, each
                     the scan's pad, the step and the pose fetch), and
                     with --profile N the device time of the last N frames
                     by kernel
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import Counter

import numpy as np
import torch

from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels, policy_kernel
from sage_icp_tpu_torch.ops.scan import INVALID_COORD
from sage_icp_tpu_torch.runtime import tracing

# the wrappers of the row-sharded kernels; a call's rows are its first argument's
SHARDED_WRAPPERS = ((nn_kernels, "fused_gn_iteration"), (policy_kernel, "apply_policy"),
                    (nn_kernels, "radius_count"))


def save_scans(path: str, scans) -> None:
    """The scans as one (F, max n, 4) float32 array padded with
    INVALID_COORD, the layout the worker reads."""
    n = max(len(s) for s in scans)
    buf = np.full((len(scans), n, 4), INVALID_COORD, dtype=np.float32)
    for i, s in enumerate(scans):
        buf[i, : len(s)] = np.asarray(s, np.float32)[:, :4]
    np.save(path, buf)


def load_config(preset: str, config_path: str | None):
    from sage_icp_tpu_torch.models.pipeline import PRESETS

    config = PRESETS[preset]
    if config_path:
        with open(config_path) as f:
            fields = json.load(f)
        tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
        config = dataclasses.replace(config, **{k: tup(v) for k, v in fields.items()})
    return config


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one rank of a sharded sage_icp_tpu_torch run")
    ap.add_argument("--rank", type=int, default=None, help="default: $RANK")
    ap.add_argument("--world", type=int, default=None, help="default: $WORLD_SIZE")
    ap.add_argument("--init", type=str, default=None, help="rendezvous, e.g. file:///tmp/rdv (default: env://)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None, help="default: nccl")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the card cuda:$LOCAL_RANK; ranks sharing one card pass cuda:0")
    ap.add_argument("--preset", type=str, default="kitti")
    ap.add_argument("--config", type=str, default=None, help="JSON file of SageConfig fields over --preset")
    ap.add_argument("--scans", type=str, required=True, help="(F, N, 4) float32 .npy from save_scans")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--timeout", type=float, default=300.0, help="process-group timeout in seconds")
    ap.add_argument("--profile", type=int, default=0,
                    help="drive the last N scans under torch.profiler and report their device time by kernel")
    return ap.parse_args(argv)


def device_profile(odom, scans) -> dict:
    """The device time of registering `scans` under torch.profiler: busy
    ms a frame and {kernel name: ms a frame}, the 40 longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for scan in scans:
            odom.register_frame(scan[scan[:, 0] < 1.0e6])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = {e.key: e.self_device_time_total / 1e3 / len(scans) for e in events}
    top = dict(sorted(ms.items(), key=lambda kv: -kv[1])[:40])
    return dict(frames=len(scans), busy_ms=sum(ms.values()), kernels_ms=top)


def main(argv=None) -> dict:
    import torch.distributed as dist

    from sage_icp_tpu_torch.parallel.distributed import init_distributed
    from sage_icp_tpu_torch.parallel.sharding import ShardedSageICP

    args = parse_args(argv)
    # two intra-op threads: ranks that share a host would otherwise each
    # start a thread per core and spin against each other
    torch.set_num_threads(2)
    mesh = init_distributed(args.init, args.world, args.rank, args.backend, args.device, args.timeout)
    rows = {name: Counter() for _, name in SHARDED_WRAPPERS}
    originals = [(module, name, getattr(module, name)) for module, name in SHARDED_WRAPPERS]

    def counting(name, fn):
        def wrapper(*a, **kw):
            rows[name][int(a[0].shape[0])] += 1
            return fn(*a, **kw)
        return wrapper

    try:
        for module, name, fn in originals:
            setattr(module, name, counting(name, fn))
        odom = ShardedSageICP(load_config(args.preset, args.config), mesh)
        scans = np.load(args.scans)
        timed = len(scans) - args.profile
        cuda_lib.reset_launches()
        for scan in scans[:timed]:
            odom.register_frame(scan[scan[:, 0] < 1.0e6])
        profiled = device_profile(odom, scans[timed:]) if args.profile else None
        launches = cuda_lib.launches()
        odom.release()  # NCCL's communicator waits for the graphs that hold its kernels
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
        dist.destroy_process_group()

    frame_ms = [s.ns / 1e6 for s in tracing.RECORDER.read().spans_of([odom.drive]) if s.name == "frame"]
    os.makedirs(args.out, exist_ok=True)
    r = mesh.rank
    np.save(os.path.join(args.out, f"poses_{r}.npy"), odom.trajectory())
    np.savez(os.path.join(args.out, f"map_{r}.npz"),
             **{k: v.cpu().numpy() for k, v in odom.state.map._asdict().items() if v is not None})
    totals = odom.aux_totals()
    report = dict(
        rank=r, world=mesh.size, backend=mesh.backend, device=str(mesh.device), graph=odom.graph,
        frames=len(scans), config=dataclasses.asdict(odom.config),
        aux_totals={f: float(v) for f, v in zip(totals._fields, totals)},
        overflow_total=int(totals.overflow_total()), icp_iterations=[int(i) for i in odom.icp_iters],
        launches=launches, kernel_rows={name: {str(k): v for k, v in c.items()} for name, c in rows.items()},
        ms_per_frame=float(np.mean(frame_ms[1:timed] or frame_ms[:timed])), profile=profiled,
    )
    with open(os.path.join(args.out, f"rank_{r}.json"), "w") as f:
        json.dump(report, f)
    print(f"rank {r} of {mesh.size} ({report['backend']}, {mesh.device}, graph={odom.graph}): {len(scans)} frames, "
          f"{report['ms_per_frame']:.3f} ms/frame after the first, ICP iterations {sum(report['icp_iterations'])}, "
          f"drops {report['overflow_total']}, launches {launches}, kernel rows {report['kernel_rows']}", flush=True)
    return report


if __name__ == "__main__":
    main()
