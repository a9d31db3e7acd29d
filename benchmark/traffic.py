"""The one traffic driver: hands a drive's scans to the program's public
entry points as a traffic file's parameters say, and keeps what the
metrics and the check read.

    frames_per_call  1: SageICP.register_frame(scan), one scan a call;
                     W > 1: SageICP.register_chunk(list of W scans);
                     drives that carry point times (a swept scene) hand
                     them over beside the scans, as timestamps=
    pose_fetch       "per_call": each call waits for its poses on the
                     host (register_frame(block=True); a chunk's poses
                     copied over); "per_drive": the poses stay on the
                     device until SageICP.trajectory() at the drive's end

Every drive starts from an empty map (SageICP.reinitialize, as the
upstream evaluation resets at each sequence end) and ends with one read
of its poses, its running counters (aux_totals, landmark_cells_dropped)
and its per-frame ICP iterations (iteration_counts). The loop is closed:
a call is made when the previous one has returned.

A window runs whole drives, in a given order over the run's distinct
drives and round again, until its deadline; the drive in progress at the
deadline runs to its end. Its length runs from its first drive's start
to the last drive's end read, when every pose of every frame handed in
is on the host."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Drive:
    index: int  # which of the run's drives
    frames: int
    poses: np.ndarray  # (frames, 4, 4)
    totals: dict  # aux_totals() over the drive: counters summed, occupancy maxed
    landmark_cells_dropped: int
    iterations: np.ndarray  # (frames,) ICP iterations


@dataclasses.dataclass
class Window:
    seconds: float  # its length
    drives: list
    call_seconds: list  # each call's time from hand-over to return
    call_frames: list  # the frames of each call
    call_first: list  # the index within its drive of each call's first frame

    @property
    def frames(self) -> int:
        return sum(d.frames for d in self.drives)

    def frame_ms(self) -> np.ndarray:
        """The latency of every frame handed over alone, in ms."""
        return np.array([1e3 * s for s, n in zip(self.call_seconds, self.call_frames) if n == 1])

    def slow_starts(self, q: float = 95.0, head: int = 10) -> tuple[int, int]:
        """(frames handed over alone above the q-th percentile, those of
        them among the first `head` frames of their drive)."""
        ms = self.frame_ms()
        if not len(ms):
            return 0, 0
        first = np.array([i for i, n in zip(self.call_first, self.call_frames) if n == 1])
        above = ms > np.percentile(ms, q)
        return int(above.sum()), int((above & (first < head)).sum())


class Driver:
    def __init__(self, odom, drives: list, params: dict, span=None, times: list | None = None):
        """drives: [drive][frame] -> (n, 4) float32 scan rows; times: None,
        or [drive][frame] -> (n,) each point's sweep phase."""
        self.odom, self.drives, self.times = odom, drives, times
        self.per_call = int(params["frames_per_call"])
        self.fetch = params["pose_fetch"]
        if self.per_call < 1 or self.fetch not in ("per_call", "per_drive"):
            raise ValueError(f"traffic parameters {params}: frames_per_call >= 1, pose_fetch per_call or per_drive")
        self.span = span or (lambda name: contextlib.nullcontext())

    def drive(self, index: int, calls: list | None = None) -> Drive:
        """Drive `index` from an empty map; (seconds, frames, index of the
        first frame) of each call are appended to `calls`."""
        odom, scans = self.odom, self.drives[index]
        stamps = None if self.times is None else self.times[index]
        with self.span("reinitialize"):
            odom.reinitialize()
        for lo in range(0, len(scans), self.per_call):
            batch = scans[lo:lo + self.per_call]
            t0 = time.perf_counter()
            with self.span("call"):
                if len(batch) == 1 and self.per_call == 1:
                    odom.register_frame(batch[0], timestamps=None if stamps is None else stamps[lo],
                                        block=self.fetch == "per_call")
                else:
                    poses = odom.register_chunk(batch, timestamps=None if stamps is None else
                                                stamps[lo:lo + self.per_call])
                    if self.fetch == "per_call":
                        poses.cpu()
            if calls is not None:
                calls.append((time.perf_counter() - t0, len(batch), lo))
        with self.span("drive_end"):
            poses = odom.trajectory()
            totals = odom.aux_totals()._asdict()
            lmk = odom.landmark_cells_dropped()
            iters = odom.iteration_counts()
        return Drive(index, len(scans), poses, {k: v.item() for k, v in totals.items()}, lmk, iters)

    def window(self, seconds: float, order: list, first=None, after_first=None) -> Window:
        """Drives in `order`, round again, until `seconds` have passed.
        first(drive_fn) runs the window's first drive (the traced run
        profiles it); after_first() runs after it."""
        calls, drives = [], []
        start = time.perf_counter()
        deadline = start + seconds
        run = first or (lambda drive_fn: drive_fn())
        drives.append(run(lambda: self.drive(order[0], calls)))
        if after_first is not None:
            after_first()
        while time.perf_counter() < deadline:
            drives.append(self.drive(order[len(drives) % len(order)], calls))
        return Window(time.perf_counter() - start, drives, *[[c[i] for c in calls] for i in range(3)])
