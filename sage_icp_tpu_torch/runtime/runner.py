"""Offline sequence runner: the reference's ROS2 plumbing (odometry node,
eval publisher, reinit service, SIGINT dumps) as a plain loop over scans.
The output formats match the reference, so its tooling reads them:

  * path.txt / gt_path.txt: TUM format "t x y z qx qy qz qw"
    (reference ros/ros2/OdometryServer.cpp:326-338)
  * time.txt: "frame t_icp t_all" per line, seconds
    (reference OdometryServer.cpp:279-285,340-346). t_icp is "n/a" where
    it was neither clocked nor identifiable: chunked runs (every frame
    gets the chunk's mean time) and runs whose ICP iteration count never
    varies. --timed-icp clocks it on every frame.
  * a per-sequence reset is the reinit service (OdometryServer.cpp:259-296)
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from sage_icp_tpu_torch.metrics import kitti as metrics
from sage_icp_tpu_torch.models import pipeline as pl
from sage_icp_tpu_torch.models.pipeline import PRESETS, SageConfig, SageICP
from sage_icp_tpu_torch.ops import geometry as geo
from sage_icp_tpu_torch.runtime.keyframes import KeyframeExtractor


class IcpTimer:
    """Measures t_icp of a frame by replaying prepare and the ICP solve on
    the pre-step state and clocking the solve alone, the span the
    reference clocks with std::chrono (pipeline/sageICP.cpp:79-88): CUDA
    events on the card, perf_counter on the CPU, behind a synchronize. It
    costs one more solve a frame, so it is an instrumentation mode. The
    first call replays the solve once more, untimed (the kernels load
    then). `iterations` lists the ICP iterations of every replay."""

    def __init__(self, odom: SageICP):
        self.odom = odom
        self.iterations: list[int] = []

    def _solve(self, state, prep):
        icp = pl.run_icp(state.map, prep, self.odom.config)
        self.iterations.append(icp.iterations)
        return icp

    def measure(self, state, scan, timestamps=None) -> float:
        odom, dev = self.odom, self.odom.device
        # the step's own packing: int16 with quantized_scan_upload, the
        # azimuth phase when deskew has no timestamps
        buf = odom.pad_chunk([scan], None if timestamps is None else [timestamps])[0]
        pts, valid, ts = pl._split_packed(torch.from_numpy(buf).to(dev))
        prep = pl.prepare_icp_inputs(state, pts, valid, ts, odom.config)
        if not self.iterations:
            self._solve(state, prep)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            self._solve(state, prep)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        self._solve(state, prep)
        return time.perf_counter() - t0


def estimate_icp_times(iteration_counts, total_times):
    """t_icp when the solve is not clocked on its own: a least-squares fit
    t_all ~= a + b * iters over this run's frames, then t_icp_i = b *
    iters_i, the marginal ICP cost of this run. Runs where b cannot be
    identified (constant iteration counts, or chunked mode's uniform
    per-frame means) give None, written "n/a" in time.txt."""
    m = min(len(iteration_counts), len(total_times))
    it = np.asarray(iteration_counts[:m], dtype=float)
    tt = np.asarray(total_times[:m], dtype=float)
    if m >= 4:
        sk = min(2, m - 3)  # the first frames load the kernels
        itf, ttf = it[sk:], tt[sk:]
        var = float(np.var(itf))
        if var > 1e-9:
            b = float(np.cov(itf, ttf, bias=True)[0, 1]) / var
            if b > 0.0:
                return list(np.clip(b * it, 0.0, tt))
    return [None] * len(tt)


def pose_to_tum(t: float, pose: np.ndarray) -> str:
    """One TUM line "t x y z qx qy qz qw"; the quaternion in float32."""
    q = geo.rotmat_to_quat(torch.as_tensor(np.asarray(pose)[:3, :3], dtype=torch.float32)).numpy()  # (w,x,y,z)
    x, y, z = pose[:3, 3]
    return f"{t} {x} {y} {z} {q[1]} {q[2]} {q[3]} {q[0]}"


class SequenceResult:
    """One sequence's poses and times, and what the run counted: the
    odometry's aux_totals() (`totals`), the per-frame ICP iterations of
    the step (`iterations`) and of IcpTimer's replays
    (`replay_iterations`, empty when untimed)."""

    def __init__(self, seq_name, est_poses, gt_poses, icp_times, total_times, totals=None,
                 iterations=(), replay_iterations=()):
        self.seq_name = seq_name
        self.est_poses = est_poses
        self.gt_poses = gt_poses
        self.icp_times = icp_times
        self.total_times = total_times
        self.totals = totals
        self.iterations = list(iterations)
        self.replay_iterations = list(replay_iterations)

    @property
    def mean_total_time(self):
        # the first frames load the kernels
        ts = self.total_times[2:] if len(self.total_times) > 4 else self.total_times
        return float(np.mean(ts))

    def metrics(self):
        out = {}
        if self.gt_poses is not None and len(self.gt_poses) == len(self.est_poses):
            gt = np.asarray(self.gt_poses)
            est = np.asarray(self.est_poses)
            gt = np.linalg.inv(gt[0])[None] @ gt  # odometry starts at I
            t_err, r_err = metrics.seq_error(gt, est)
            ate_rot, ate_trans = metrics.absolute_trajectory_error(gt, est)
            out.update(rel_trans_err_pct=t_err, rel_rot_err_deg_per_m=r_err, ate_rot_rad=ate_rot,
                       ate_trans_m=ate_trans)
        out["mean_frame_time_s"] = self.mean_total_time
        out["fps"] = 1.0 / max(self.mean_total_time, 1e-9)
        return out

    def save(self, out_dir: str, timestamps=None):
        """path.txt, gt_path.txt (with ground truth), time.txt ("n/a" for
        an unknown t_icp) and <seq>.png (with matplotlib) in out_dir."""
        os.makedirs(out_dir, exist_ok=True)
        n = len(self.est_poses)
        ts = timestamps if timestamps is not None else np.arange(n, dtype=float)
        with open(os.path.join(out_dir, "path.txt"), "w") as f:
            for t, p in zip(ts, self.est_poses):
                f.write(pose_to_tum(t, p) + "\n")
        if self.gt_poses is not None:
            with open(os.path.join(out_dir, "gt_path.txt"), "w") as f:
                gt = np.asarray(self.gt_poses)
                gt = np.linalg.inv(gt[0])[None] @ gt
                for t, p in zip(ts, gt):
                    f.write(pose_to_tum(t, p) + "\n")
        with open(os.path.join(out_dir, "time.txt"), "w") as f:
            for i, (ti, ta) in enumerate(zip(self.icp_times, self.total_times)):
                f.write(f"{i} {'n/a' if ti is None else ti} {ta}\n")
        self.save_plot(os.path.join(out_dir, f"{self.seq_name}.png"))

    def save_plot(self, path: str) -> None:
        """Bird's-eye trajectory, estimate against ground truth (the
        reference eval publisher's .png dump, eval/kitti_pub.py:442-447);
        skipped without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(6, 6))
        est = np.asarray(self.est_poses)
        ax.plot(est[:, 0, 3], est[:, 1, 3], "b-", lw=1.2, label="estimate")
        if self.gt_poses is not None and len(self.gt_poses):
            gt = np.asarray(self.gt_poses)
            gt = np.linalg.inv(gt[0])[None] @ gt
            ax.plot(gt[:, 0, 3], gt[:, 1, 3], "r--", lw=1.0, label="ground truth")
        ax.set_aspect("equal")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.legend()
        ax.set_title(self.seq_name)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)


def run_sequence(
    odom: SageICP,
    scans,
    gt_poses=None,
    timestamps_per_point=None,
    max_frames: int | None = None,
    keyframes: KeyframeExtractor | None = None,
    progress: bool = False,
    seq_name: str = "seq",
    chunk: int = 0,
    overlay=None,  # runtime.overlay.OverlayWriter: per-frame camera PNGs
    timed_icp: bool = False,  # clock the ICP solve per frame (IcpTimer)
) -> SequenceResult:
    """Drive scans, an iterable of (n, 4) arrays, through the odometry.

    chunk > 0 is the offline-throughput mode: frames go to the device in
    chunks of that many (register_chunk), unless keyframes, an overlay or
    timed_icp ask for per-frame host poses. Ctrl-C mid-sequence returns
    the partial result (the reference node's SIGINT trajectory dump,
    ros/ros2/OdometryServer.cpp:301-349)."""
    odom.reinitialize()
    est, icp_t, tot_t = [], [], []
    timer = None
    if chunk > 0 and keyframes is None and overlay is None and not timed_icp:
        buf, buf_ts = [], []
        t0 = time.perf_counter()
        n_done = 0
        try:
            for i, scan in enumerate(scans):
                if max_frames is not None and i >= max_frames:
                    break
                buf.append(scan)
                buf_ts.append(timestamps_per_point[i] if timestamps_per_point is not None else None)
                if len(buf) == chunk:
                    odom.register_chunk(buf, buf_ts)
                    n_done += len(buf)
                    buf, buf_ts = [], []
                    if progress:
                        print(f"[{seq_name}] {n_done} frames")
            for scan, ts in zip(buf, buf_ts):  # the ragged tail frame by frame
                odom.register_frame(scan, ts, block=False)
                n_done += 1
        except KeyboardInterrupt:
            print(f"[{seq_name}] interrupted after ~{n_done} frames; dumping partial trajectory")
        est = list(odom.trajectory())
        per = (time.perf_counter() - t0) / max(len(est), 1)
        tot_t = [per] * len(est)
        icp_t = estimate_icp_times(odom.iteration_counts(), tot_t)
    else:
        timer = IcpTimer(odom) if timed_icp else None
        try:
            for i, scan in enumerate(scans):
                if max_frames is not None and i >= max_frames:
                    break
                ts = timestamps_per_point[i] if timestamps_per_point is not None else None
                if timer is not None:
                    icp_t.append(timer.measure(odom.state, scan, ts))  # on the pre-step state
                t0 = time.perf_counter()
                pose = odom.register_frame(scan, ts)
                tot_t.append(time.perf_counter() - t0)
                est.append(pose)
                if keyframes is not None:
                    keyframes.update(scan, pose)
                if overlay is not None:
                    overlay.maybe_write(i, scan)
                if progress and i % 50 == 0:
                    print(f"[{seq_name}] frame {i} t={pose[:3, 3].round(2)}")
        except KeyboardInterrupt:
            print(f"[{seq_name}] interrupted after {len(est)} frames; dumping partial trajectory")
        if timer is None:
            icp_t = estimate_icp_times(odom.iteration_counts(), tot_t)
        else:
            icp_t = icp_t[: len(tot_t)]
    totals = odom.aux_totals() if est else None
    if not est:
        est = [np.eye(4)]
    gt = None if gt_poses is None else np.asarray(gt_poses)[: len(est)]
    return SequenceResult(seq_name, np.stack(est), gt, icp_t, tot_t, totals=totals,
                          iterations=odom.iteration_counts(),
                          replay_iterations=timer.iterations if timer is not None else ())


def make_odometry(preset_or_config, deskew: bool | None = None, device=None) -> SageICP:
    """SageICP for a preset name or a config, with deskew overridden when
    given; device None means the card."""
    cfg = preset_or_config if isinstance(preset_or_config, SageConfig) else PRESETS[preset_or_config]
    if deskew is not None and deskew != cfg.deskew:
        cfg = dataclasses.replace(cfg, deskew=deskew)
    return SageICP(cfg, device=device)
