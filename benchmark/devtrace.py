"""The traced run: torch.profiler over one drive, reduced to what the
per-layer metrics and the breakdown read.

The harness marks its own calls into the program with spans
(record_function, names starting "odobench."): the drive, each call, the
reinitialize and the drive's end read. The traced window is the drive's
span. Device activity is every operation that ran on the card (kernels,
copies, fills, those replayed from CUDA graphs included); busy time is
the union of their intervals within the window, so work that overlaps on
two streams counts once. Host events are the window's events on the
thread that ran the drive: aten operations, CUDA runtime calls and the
harness's spans."""

from __future__ import annotations

import collections
import dataclasses

import torch

SPAN_PREFIX = "odobench."
# CUDA runtime calls that make the host wait for the card (chip_smoke.py's
# HOST_WAIT), and the synchronous copy
HOST_WAIT = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
TOP = 10
NAME_CHARS = 120  # a device operation's name in the breakdown, cut to this


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    device: list  # (name, start_ns, end_ns) of each device operation in the window
    host: list  # (name, start_ns, end_ns) of the drive's thread, by start

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_ns(self) -> int:
        return sum(e - s for s, e in merged(self.device, self.start_ns, self.end_ns))

    def device_seconds(self, match) -> float | None:
        """Summed device time of the operations whose name `match` accepts,
        or None when none ran."""
        times = [e - s for n, s, e in self.device if match(n)]
        return sum(times) / 1e9 if times else None

    def host_calls(self, names) -> int:
        return sum(1 for n, _, _ in self.host if n in names)


def span(name: str):
    return torch.profiler.record_function(SPAN_PREFIX + name)


def merged(events, lo: int, hi: int) -> list:
    """The union of the events' intervals within [lo, hi], as disjoint
    (start, end) pairs in order."""
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def idle_gaps(trace: Trace) -> list:
    """(start, end) of each stretch of the window with nothing on the card."""
    busy = merged(trace.device, trace.start_ns, trace.end_ns)
    edges = [trace.start_ns] + [x for b in busy for x in b] + [trace.end_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def host_labels(trace: Trace, points: list) -> list:
    """What the host was doing at each of the sorted time points: the
    innermost harness span and the innermost event around it, as
    "span: event" ("span" alone between events)."""
    events = trace.host
    labels, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][1] <= t:
            while stack and stack[-1][2] <= events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        spans = [n[len(SPAN_PREFIX):] for n, _, _ in stack if n.startswith(SPAN_PREFIX)]
        inner = stack[-1][0] if stack and not stack[-1][0].startswith(SPAN_PREFIX) else None
        where = spans[-1] if spans else "outside the drive's spans"
        labels.append(f"{where}: {inner}" if inner else where)
    return labels


def breakdown(trace: Trace) -> dict:
    """The device operations that took the most time, and the idle time by
    what the host was doing, each as [name, seconds] (at most TOP)."""
    ops = collections.Counter()
    for n, s, e in trace.device:
        ops[n] += e - s
    gaps = idle_gaps(trace)
    idle = collections.Counter()
    for label, (s, e) in zip(host_labels(trace, [(s + e) // 2 for s, e in gaps]), gaps):
        idle[label] += e - s
    return {"device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in ops.most_common(TOP)],
            "idle_gaps": [[n, v / 1e9] for n, v in idle.most_common(TOP)]}


def _is_device(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation and annotation()) and not e.name().startswith(SPAN_PREFIX)


def profile_drive(run_drive, device) -> tuple:
    """Runs run_drive() under torch.profiler inside the "drive" span;
    returns (its result, the Trace of the span)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with span("drive"):
            out = run_drive()
            sync()
    events = prof.profiler.kineto_results.events()
    drive = next(e for e in events
                 if e.name() == SPAN_PREFIX + "drive" and e.device_type() != torch.autograd.DeviceType.CUDA)
    lo, hi = drive.start_ns(), drive.start_ns() + drive.duration_ns()
    thread = drive.start_thread_id()
    dev, host = [], []
    for e in events:
        s = e.start_ns()
        t = (e.name(), s, s + e.duration_ns())
        if _is_device(e):
            if t[2] > lo and s < hi:
                dev.append(t)
        elif e.start_thread_id() == thread and lo <= s <= hi:
            host.append(t)
    host.sort(key=lambda x: (x[1], -x[2]))
    return out, Trace(lo, hi, dev, host)

