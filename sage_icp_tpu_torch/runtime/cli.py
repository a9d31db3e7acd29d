"""Command-line entry point, in place of the reference's ROS stack
(launch files, odometry node, eval publishers). It runs on the card
unless --device names another device; without a card it stops.

    python -m sage_icp_tpu_torch.runtime.cli --synthetic --frames 100
    python -m sage_icp_tpu_torch.runtime.cli --dataset kitti --root /data/KITTI \\
        --sequences 0 1 2 --preset kitti --out results/
    python -m sage_icp_tpu_torch.runtime.cli --dataset kitti360 --root ... \\
        --drive 2013_05_28_drive_0000_sync --poses-root ...
    python -m sage_icp_tpu_torch.runtime.cli --synthetic --frames 3 --preset city --device cpu

Writes metrics.json in --out and, per sequence, path.txt, gt_path.txt,
time.txt (see runtime/runner.py) and a plot when matplotlib is present.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="sage_icp_tpu_torch odometry runner")
    ap.add_argument("--dataset", choices=["kitti", "kitti360", "kitti_raw", "synthetic"], default="synthetic")
    ap.add_argument("--synthetic", action="store_true", help="shorthand for --dataset synthetic")
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--poses-root", type=str, default=None)
    ap.add_argument("--sequences", type=int, nargs="*", default=[0])
    ap.add_argument("--drive", type=str, default=None)
    ap.add_argument("--date", type=str, default=None, help="raw-KITTI date dir, e.g. 2011_09_26")
    ap.add_argument("--preset", type=str, default="kitti")
    ap.add_argument("--world", choices=["city", "corridor"], default="city",
                    help="synthetic world: 'city' (Manhattan grid) or 'corridor' (a single road, "
                    "forward-degenerate for ICP on longer runs)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", type=str, default="results")
    ap.add_argument("--keyframes", action="store_true")
    ap.add_argument("--chunk", type=int, default=0,
                    help="offline-throughput mode: register frames in chunks of this size, one upload each")
    ap.add_argument("--no-labels", action="store_true")
    ap.add_argument("--labels-dir", type=str, default=None,
                    help="directory of per-scan .label/.npy semantic labels from any segmentation model, "
                    "paired with scans by sorted order (the offline analog of the reference's /sem_points "
                    "topic). Overrides dataset labels; one sequence or drive per run")
    ap.add_argument("--deskew", action="store_true",
                    help="constant-velocity motion compensation; per-point timestamps from the azimuth "
                    "phase (reference pipeline/sageICP.cpp:38-51)")
    ap.add_argument("--image-dir", type=str, default=None,
                    help="camera image directory: write scan-overlay PNGs every --image-every frames "
                    "(reference eval/kittiraw_image_pub.py)")
    ap.add_argument("--image-every", type=int, default=50)
    ap.add_argument("--timed-icp", action="store_true",
                    help="clock the ICP solve on its own every frame, so time.txt's t_icp is measured "
                    "(the reference's std::chrono span, sageICP.cpp:79-88); one more solve a frame, "
                    "and per-frame mode")
    ap.add_argument("--jitter", type=float, default=0.1,
                    help="synthetic-trajectory motion jitter (m/frame surge scale; 0 = constant velocity, "
                    "which starves the adaptive threshold)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device, e.g. cuda:1 or cpu (default: the card; no fallback)")
    args = ap.parse_args(argv)
    if args.synthetic:
        args.dataset = "synthetic"
    many = (args.dataset == "kitti" and len(args.sequences) > 1) or (
        args.dataset == "kitti_raw" and not (args.date and args.drive))
    if args.labels_dir and many:
        # one labels directory pairs with one sequence's scans
        ap.error("--labels-dir takes one sequence or drive (--sequences N, or --date and --drive)")
    return args


def main(argv=None) -> dict:
    """Run the CLI; returns {sequence name: runner.SequenceResult}."""
    args = parse_args(argv)

    from sage_icp_tpu_torch.runtime.keyframes import KeyframeExtractor
    from sage_icp_tpu_torch.runtime.runner import make_odometry, run_sequence

    odom = make_odometry(args.preset, deskew=args.deskew, device=args.device)
    results = {}
    label_dir = None
    if args.labels_dir:
        from sage_icp_tpu_torch.datasets.labels import LabelDirectory

        label_dir = LabelDirectory(args.labels_dir)

    def with_labels(scans):
        return label_dir.wrap(scans) if label_dir is not None else scans

    overlay = None
    if args.image_dir:
        from sage_icp_tpu_torch.runtime.overlay import OverlayWriter

        overlay = OverlayWriter(args.image_dir, os.path.join(args.out, "overlays"), every=args.image_every)

    def run(name, scans, out_name, times=None, **kw):
        res = run_sequence(odom, scans, max_frames=args.frames, progress=True, seq_name=name,
                           chunk=args.chunk, timed_icp=args.timed_icp, **kw)
        res.save(os.path.join(args.out, out_name), times)
        results[name] = res

    if args.dataset == "synthetic":
        from sage_icp_tpu_torch.utils import synthetic

        n = args.frames or 100
        if args.world == "city":
            pts, labs = synthetic.build_city_world(seed=1, size=max(420.0, n * 1.2 + 220.0))
        else:
            pts, labs = synthetic.build_world(seed=1, length=max(120.0, n * 1.2))
        gt = synthetic.make_trajectory(n, step=1.0, jitter=args.jitter)
        rng = np.random.default_rng(0)
        scans = (synthetic.render_scan(pts, labs, gt[i], rng, n_target=30000) for i in range(n))
        run("synthetic", scans, "synthetic", gt_poses=gt,
            keyframes=KeyframeExtractor() if args.keyframes else None)

    elif args.dataset == "kitti":
        from sage_icp_tpu_torch.datasets.kitti import KittiOdometrySequence

        for seq in args.sequences:
            ds = KittiOdometrySequence(args.root, seq, with_labels=not args.no_labels)
            if overlay is not None:
                overlay.set_calib(ds.calib)
            run(ds.seq, with_labels(iter(ds)), f"seq{ds.seq}", ds.timestamps, gt_poses=ds.gt_poses,
                keyframes=KeyframeExtractor() if args.keyframes else None, overlay=overlay)

    elif args.dataset == "kitti360":
        from sage_icp_tpu_torch.datasets.kitti360 import Kitti360Sequence

        ds = Kitti360Sequence(args.root, args.drive, args.poses_root)
        gt = None
        if ds.poses is not None:
            gt = [g for g in (ds.gt_pose(i) for i in range(len(ds))) if g is not None]
        run(args.drive, with_labels(ds.read_scan(i) for i in range(len(ds))), args.drive,
            gt_poses=np.stack(gt) if gt else None, overlay=overlay)

    elif args.dataset == "kitti_raw":
        from sage_icp_tpu_torch.datasets.kitti_raw import KittiRawSequence, discover_drives

        drives = [(args.date, args.drive)] if args.date and args.drive else discover_drives(args.root)
        for date, drive in drives:
            ds = KittiRawSequence(args.root, date, drive)
            run(f"{date}_{drive}", with_labels(iter(ds)), f"{date}_{drive}", gt_poses=ds.gt_poses,
                overlay=overlay)

    if label_dir is not None and label_dir.mismatched_frames:
        print(f"WARNING: {label_dir.mismatched_frames} frames had label-length mismatches (padded with "
              "label 0); is the labels directory from this sequence?")
    all_metrics = {name: res.metrics() for name, res in results.items()}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(json.dumps(all_metrics, indent=2))
    return results


if __name__ == "__main__":
    main()
