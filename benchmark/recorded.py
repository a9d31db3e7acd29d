"""What the program's own recorder holds (sage_icp_tpu_torch/runtime/
tracing.py: host spans, the device's stage clock, the GN live rows), for
the per-layer metrics read from it.

The recorder numbers drives, one per SageICP.reinitialize. A window's
drives are the recorder's last ones: the traced drive first, then the
untraced drives; the set-up drive comes just before them. The untraced
metrics read the recorder's last len(window.drives) - 1 drives, so
nothing the profiler slowed is read. When the traced drive fills the
window (the profiler's own work after the drive can take most of it),
they read the set-up drive less its first call, which builds the kernels
and captures the graphs, and say so on standard error (untraced).
gn_roofline_counted reads the traced drive. With a program that has no
recorder every function here gives None and raises nothing."""

from __future__ import annotations

import collections
import dataclasses
import sys

from benchmark import devtrace

_last: list = [None, None, None]  # (run, its snapshot, the run told of the set-up drive): read once a run


def snapshot(run):
    """The recorder's Snapshot after the run, or None without a recorder."""
    if _last[0] is not run:
        try:
            from sage_icp_tpu_torch.runtime import tracing
        except ImportError:
            snap = None
        else:
            snap = tracing.RECORDER.read()
        _last[:2] = [run, snap]
    return _last[1]


def window_drives(run, snap) -> list | None:
    """The recorder's drives of the run's window, in order (the traced
    drive first), or None when it holds fewer."""
    n = len(run.window.drives)
    drives = snap.drives()
    return drives[len(drives) - n:] if 0 < n <= len(drives) else None


@dataclasses.dataclass
class Untraced:
    drives: list  # the recorder's drives read
    frames: list  # their frame records that hold stage times
    spans: list  # their spans
    setup: bool = False  # the set-up drive, less its first call


def setup_drive(run, snap) -> Untraced | None:
    """The set-up drive less its first call: its spans from that call's
    start to the next call's are left out, and the frames stepped before
    the next call. None when the recorder holds no such drive or the
    drive made one call."""
    drives = snap.drives()
    i = len(drives) - len(run.window.drives) - 1
    if i < 0:
        return None
    d = drives[i]
    spans = snap.spans_of([d])
    calls = sorted((s for s in spans if s.parent == -1 and s.name in ("frame", "chunk")), key=lambda s: s.seq)
    if len(calls) < 2 or calls[1].frame < 0:
        return None
    lo, hi = calls[0].seq, calls[1].seq
    return Untraced([d], [f for f in snap.frames_of([d]) if f.frame >= calls[1].frame],
                    [s for s in spans if not lo <= s.seq < hi], setup=True)


def untraced(run) -> Untraced | None:
    """What the untraced metrics read: the window's drives after the
    traced one; the set-up drive less its first call when the traced
    drive fills the window."""
    snap = snapshot(run)
    if snap is None:
        return None
    drives = window_drives(run, snap)
    if not drives:
        return None
    if len(drives) > 1:
        read = drives[1:]
        u = Untraced(read, snap.frames_of(read), snap.spans_of(read))
    else:
        u = setup_drive(run, snap)
        if u is None:
            return None
        if _last[2] is not run:
            _last[2] = run
            print(f"recorded: the traced drive fills the window; the untraced metrics read the set-up drive "
                  f"{u.drives[0]} less its first call ({len(u.frames)} frames)", file=sys.stderr)
    u.frames = [f for f in u.frames if f.stages_ns is not None]
    return u if u.frames else None


def stage_ms_per_frame(run, *stages) -> float | None:
    u = untraced(run)
    if u is None:
        return None
    return sum(f.stages_ns[s] for f in u.frames for s in stages) / 1e6 / len(u.frames)


def span_ms_per_frame(run, *names) -> float | None:
    """The untraced spans of these names, ms over the untraced frames."""
    u = untraced(run)
    if u is None:
        return None
    return sum(s.ns for s in u.spans if s.name in names) / 1e6 / len(u.frames)


# the program's own top-level calls: the time the host spent inside it
TOP = ("frame", "chunk", "trajectory", "reinitialize")


def innermost(spans) -> list:
    """(start, end, name) stretches of time, each under its innermost span
    (the spans of one thread nest); time outside every span is left out."""
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, s.start_ns, stack[-1][1]))
        stack.append((s.end_ns, s.name))
        t = s.start_ns
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [x for x in out if x[1] > x[0]]


def idle_by_span(snap, u: Untraced) -> tuple[dict, float, int]:
    """The device's idle ns inside the program's spans, by the innermost
    host span, over the untraced drives whose clocks are placed
    (Snapshot.offsets): (name -> ns, ns that could not be placed, frames).
    The device is busy in each frame's pieces; a frame that ran more than
    the ring keeps is busy from its first to its last kept piece, less what
    its stages did not fill there (`unplaced`)."""
    offsets = snap.offsets()
    idle, unplaced, n = collections.Counter(), 0.0, 0
    for d in u.drives:
        if d not in offsets:
            continue
        busy = []
        for f in u.frames:
            if f.drive != d:
                continue
            n += 1
            pieces = [(a + offsets[d], b + offsets[d]) for a, b in f.pieces]
            if f.pieces_run > len(f.pieces):
                stretch = (pieces[-2][1], pieces[-1][0])
                unplaced += stretch[1] - stretch[0] - (f.device_ns - sum(b - a for a, b in f.pieces))
                pieces.append(stretch)
            busy += [("", a, b) for a, b in pieces]
        busy = devtrace.merged(busy, min((b[1] for b in busy), default=0), max((b[2] for b in busy), default=0))
        i = 0
        for a, b, name in innermost([s for s in u.spans if s.drive == d]):
            covered = 0
            while i < len(busy) and busy[i][1] <= a:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < b:
                covered += min(b, busy[j][1]) - max(a, busy[j][0])
                j += 1
            idle[name] += b - a - covered
    return dict(idle), unplaced, n
