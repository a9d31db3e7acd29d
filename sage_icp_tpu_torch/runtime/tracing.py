"""The tracing system of sage_icp_tpu_torch: host spans, the device's
stage clock and the GN live-row counter, held in memory by one
process-wide recorder (RECORDER) in bounded rings.

Host spans. `with span(name):` records the name, the start and end
(time.perf_counter_ns), the enclosing span, the frame and the drive: two
clock reads and a slot write, always on. While a torch.profiler records,
the span is also entered as torch.profiler.record_function under the
name "sage_icp.<name>", so a trace shows it beside the device's
activity; when none records, no record_function is made. The program's
spans:

    reinitialize        SageICP.reinitialize (a drive starts)
    frame, chunk        SageICP.register_frame, register_chunk
    pad                 SageICP.pad_chunk: the scans written into its staging buffer
    upload              the step's input copy (DeviceStep), register_chunk's copy to the device,
                        both enqueued without waiting, and pad_chunk's wait for the staging
                        buffer's last copy (the copies' device time is in no span)
    launch.prepare, launch.block, launch.reanchor, launch.finish
                        the step's graph replays, or its eager pieces (DeviceStep)
    wait.status         the ICP loop's status read, one a block (registration.read_status)
    wait.pose           register_frame's pose fetch
    trajectory          SageICP.trajectory

Frames and drives. A drive runs from one SageICP.reinitialize to the
next. Every frame a DeviceStep steps is a frame of the recorder
(begin_frame, close_frame once its last stamp is launched, end_frame),
numbered in order over the process; a step that raises before its last
stamp leaves no frame. A span opened while a frame is stepped belongs to
it; a `frame` or `chunk` span to the first frame stepped inside it; any
other span to its parent's frame, or to none (-1).

The stage clock. The step stamps each frame (StageClock, csrc/
stage_clock.cu): a one-thread kernel reads the card's %globaltimer and
writes a row of a device ring, chosen by a frame counter on the device
(a captured launch's arguments are frozen). The stamps are captured into
the step's graphs and run eagerly without them; on the CPU the row is
written from the host clock. A frame's row holds the summed device time
of its stages,

    head        scan_head: preprocess (the crop), and on a mesh the gather
                of the cropped rows
    filter      filter_dynamic_vehicles (0 with the filter off)
    downsample  voxelize
    icp         the rest of prepare (sigma, prediction, probe tables, the
                rows at the guess, the first block) and every block and
                reanchor piece, less their searches
    update      finish: guard, insert, cull, state and totals
    deskew      scan_head's deskew (0 without config.deskew)
    search      the reference-shaped loop's searches (registration.RefLoop:
                hashmap.get_correspondences, each between two stamps); 0
                on the frozen-rows path

its first and last stamp, and the (start, end) of each piece (a graph
replay or an eager piece). The time between pieces is in no stage: it is
the device's idle time. The frame's last stamp also copies the GN
live-row count of the frame: a live row has a used query slot, each row
build (prepare, reanchor) counts its live rows on the device, and each
running ICP step (after its GN launch) adds that count
(ops/registration.py, csrc/icp_step.cu). The dynamic filter's
min-diffusion writes two counts into the row itself (on the card the
kernel csrc/min_diffusion.cu, on the CPU dynamic_filter._min_diffusion):
the frame's occupied vehicle cells and the rounds that changed a cluster
id (at most 24: 24 says the round cut may bind); both 0 with the filter
off. With config.deskew the stamp that ends the deskew stage writes the
frame's deskewed points into the row: the scan's valid rows from the
third pose on, 0 before (pipeline.scan_head); 0 without deskew. The
stamp that closes prepare and each reanchor piece writes the frame's
found pairs so far: the (row, neighbour) pairs whose neighbour voxel
the row builds found in the map (correspondence_fast.candidate_planes,
on the card csrc/corr_planes.cu, counts them on the device); 0 on the
reference path. The stamp that ends each search of the reference path
writes the frame's three search counts so far, running totals over the
searches of a running loop (gated on the loop's status on the device,
so blocks of 1 and of 4 iterations count alike): the valid sources
searched, the (source, neighbour voxel) pairs of them whose voxel is in
the map, and the live points of those pairs' blocks (the map's counts
summed over the found pairs). Each is defined by the sources, the map
and the 27 offsets, whatever an implementation reads. They are int64:
the candidates of a frame can pass 2^31. On a mesh each rank counts its
own share of the sources. All three are 0 on the frozen-rows path. A
stamp writes a count given to it (`value`: one int32, or a vector of
int64s into the slots from `into` on) into its slot (`into`) as it
stamps, so no count is read back while frames are stepped.

Staging counts. SageICP.pad_chunk counts, on the host, the scan rows
it stages and the staging buffers it makes (register_chunk's device
buffer too); they go to the frame of the span open around the count (a
chunk's to its first frame), kept beside the frame's spans. Once the
process is warm no buffer is made: the count of buffers is 0.

Reading. RECORDER.read() copies each device's ring to the host in one
transfer (it waits for the device) and returns a Snapshot: the frames'
records and the spans, by drive. Nothing is read back while frames are
stepped. The device clock is placed on the host's, per drive, from the
reads that already wait: a `wait.pose` span ends after its frame's last
stamp, a `trajectory` span after its drive's last frame's
(Snapshot.offsets).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

PREFIX = "sage_icp."
FRAMES = 16_384  # frames the rings hold
SPANS_PER_FRAME = 16  # span slots a frame, in the spans' ring

# the row of a frame (csrc/stage_clock.cu)
SEQ, FIRST, LAST, MARK = 0, 1, 2, 3
HEAD, FILTER, DOWNSAMPLE, ICP, UPDATE = 4, 5, 6, 7, 8
LIVE_ROWS, PIECES, PIECE0 = 9, 10, 11
MAX_PIECES = 8
VEHICLE_CELLS = PIECE0 + 2 * MAX_PIECES
DIFFUSION_ROUNDS = VEHICLE_CELLS + 1
DESKEW = DIFFUSION_ROUNDS + 1
DESKEWED_POINTS = DESKEW + 1
CORR_FOUND_PAIRS = DESKEWED_POINTS + 1
SEARCH = CORR_FOUND_PAIRS + 1
SEARCH_SOURCES, SEARCH_PAIRS, SEARCH_CANDIDATES = SEARCH + 1, SEARCH + 2, SEARCH + 3
SLOTS = SEARCH_CANDIDATES + 1
STAGES = {"head": HEAD, "filter": FILTER, "downsample": DOWNSAMPLE, "icp": ICP, "update": UPDATE, "deskew": DESKEW,
          "search": SEARCH}
BEGIN, START, SPLIT, CLOSE, END_FRAME = range(5)

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
_profiling = torch._C._autograd._profiler_enabled


def stamp_row(row: np.ndarray, op: int, slot: int, t: int, seq: int = 0, value=None,
              into: int = LIVE_ROWS) -> None:
    """One stamp at time t on the row of frame `seq`: the kernel's
    arithmetic (value: a count, or a sequence of counts, that SPLIT, CLOSE
    or END_FRAME writes into the slots from `into` on, END_FRAME's live
    rows by default)."""
    if op == BEGIN:
        row[:] = 0
        row[SEQ] = seq
        row[FIRST] = row[LAST] = row[MARK] = row[PIECE0] = t
        row[PIECES] = 1
        return
    n = int(row[PIECES])
    if op == START:
        row[PIECE0 + 2 * min(n, MAX_PIECES - 1)] = t
        row[PIECES] = n + 1
        row[MARK] = t
        return
    row[slot] += t - row[MARK]
    row[MARK] = row[LAST] = t
    if op != SPLIT:
        row[PIECE0 + 2 * min(n, MAX_PIECES) - 1] = t
    if value is not None:
        values = np.atleast_1d(value)
        row[into:into + len(values)] = values


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    seq: int  # the order the spans were opened in
    parent: int  # the enclosing span's seq, -1 at the top
    frame: int  # -1 outside every frame
    drive: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class FrameRecord:
    frame: int
    drive: int
    device: str
    stages_ns: dict | None  # stage -> device ns; None when the row was not read
    first_ns: int | None  # the first and last stamp, device clock (host clock on the CPU)
    last_ns: int | None
    pieces: list  # (start_ns, end_ns) of each piece kept
    pieces_run: int  # pieces the frame ran (more than MAX_PIECES: the middle ones were not kept)
    live_rows: int | None
    vehicle_cells: int | None  # the filter's occupied vehicle cells (0 with the filter off)
    diffusion_rounds: int | None  # its min-diffusion's rounds that changed an id
    deskewed_points: int | None  # the scan's rows deskew moved (0 without deskew, and before the third pose)
    corr_found_pairs: int | None  # found (row, neighbour) pairs of the frame's row builds (0 on the reference path)
    search_sources: int | None  # valid sources of the reference path's searches (0 on the frozen-rows path)
    search_pairs: int | None  # their (source, neighbour voxel) pairs found in the map
    search_candidates: int | None  # the live points of those pairs' blocks
    spans: list  # the frame's host spans
    staged_rows: int = 0  # scan rows SageICP.pad_chunk staged (a chunk's on its first frame)
    staging_buffers: int = 0  # staging buffers made for it (0 once the process is warm)

    @property
    def stages_ms(self) -> dict | None:
        return None if self.stages_ns is None else {k: v / 1e6 for k, v in self.stages_ns.items()}

    @property
    def device_ns(self) -> int | None:
        """The stages' sum: the frame's device time in its pieces."""
        return None if self.stages_ns is None else sum(self.stages_ns.values())


@dataclasses.dataclass
class Snapshot:
    frames: list  # FrameRecord, by frame
    spans: list  # Span, by seq

    def drives(self) -> list:
        return sorted({s.drive for s in self.spans} | {f.drive for f in self.frames})

    def frames_of(self, drives) -> list:
        drives = set(drives)
        return [f for f in self.frames if f.drive in drives]

    def spans_of(self, drives) -> list:
        drives = set(drives)
        return [s for s in self.spans if s.drive in drives]

    def self_ns(self) -> dict:
        """seq -> the span's time less its children's."""
        out = {s.seq: s.ns for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.ns
        return out

    def offsets(self) -> dict:
        """drive -> host ns less device ns: the smallest gap between a
        wait's end on the host and the last stamp it waited for (0 for
        the CPU's rows, which hold host times)."""
        by_frame = {f.frame: f for f in self.frames if f.last_ns is not None}
        last = {}
        for f in by_frame.values():
            last[f.drive] = f
        out = {}
        for s in self.spans:
            f = by_frame.get(s.frame) if s.name == "wait.pose" else last.get(s.drive) if s.name == "trajectory" \
                else None
            if f is None or f.drive != s.drive:
                continue
            gap = 0 if f.device == "cpu" else s.end_ns - f.last_ns
            out[s.drive] = min(out.get(s.drive, gap), gap)
        return out


class _Frame:
    __slots__ = ("id", "drive", "ring", "seq", "row", "counts", "closed", "ended")

    def __init__(self, fid, drive, ring, seq, row):
        self.id, self.drive, self.ring, self.seq, self.row = fid, drive, ring, seq, row
        # the counts of a frame stepped on the CPU, slot -> 0-dim tensor,
        # written into its row when it is read
        self.counts, self.closed, self.ended = {}, False, False


class _DeviceRing:
    """A card's rows and its frame counter, made once (not in a capture)."""

    def __init__(self, device, frames: int):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the stage clock's ring is made at a device's first step, not during a capture")
        self.device = device
        self.rows = torch.zeros((frames, SLOTS), dtype=torch.int64, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.begun = 0  # frames begun on it, as the host counts them


class _Stack(list):
    """A thread's open spans, (seq, frame, drive, record_function,
    start) each, and the _Frame it steps (`current`)."""

    __slots__ = ("current",)

    def __init__(self):
        super().__init__()
        self.current = None


class _Thread(threading.local):
    def __init__(self):
        self.stack = _Stack()


class _Span:
    __slots__ = ("_rec", "name", "_full", "_opens")

    def __init__(self, rec, name: str, opens: bool):
        self._rec, self.name, self._full, self._opens = rec, name, PREFIX + name, opens

    def __enter__(self):
        rec = self._rec
        stack = rec._local.stack
        if stack.current is not None:
            frame = stack.current.id
        elif stack:
            frame = stack[-1][1]
        else:
            frame = rec._next_frame if self._opens else -1
        rf = None
        if _profiling():
            rf = torch.profiler.record_function(self._full)
            rf.__enter__()
        stack.append((next(rec._seq), frame, rec.drive, rf, time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self._rec
        stack = rec._local.stack
        seq, frame, drive, rf, start = stack.pop()
        rec._spans[seq % rec._span_slots] = (self.name, start, end, seq, stack[-1][0] if stack else -1, frame, drive)
        if rf is not None:
            rf.__exit__(None, None, None)
        return False


class Recorder:
    """Spans, frames and the devices' stage rings (module docstring)."""

    def __init__(self, frames: int = FRAMES):
        self.capacity = frames
        self._span_slots = frames * SPANS_PER_FRAME
        self._spans: list = [None] * self._span_slots
        self._frames: list = [None] * frames
        self._seq = itertools.count()
        self._next_frame = 0
        self._lock = threading.Lock()
        self._local = _Thread()
        self._named: dict = {}
        self._rings: dict = {}
        self._staging: list = [None] * frames  # (frame, rows, buffers), by frame
        self.drive = 0

    def span(self, name: str, opens_frame: bool = False) -> _Span:
        """The span `name` (a context manager, reusable and reentrant);
        opens_frame: it belongs to the first frame stepped inside it."""
        key = (name, opens_frame)
        s = self._named.get(key)
        if s is None:
            s = self._named[key] = _Span(self, name, opens_frame)
        return s

    def new_drive(self) -> int:
        with self._lock:
            self.drive += 1
            return self.drive

    def _ring(self, device) -> _DeviceRing:
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        ring = self._rings.get(device)
        if ring is None:
            ring = self._rings[device] = _DeviceRing(device, self.capacity)
        return ring

    def begin_frame(self, clock: StageClock) -> int:
        """A frame of the clock's device starts on this thread; returns its
        id."""
        with self._lock:
            fid = self._next_frame
            self._next_frame += 1
        ring = clock._ring
        if ring is not None:
            frame = _Frame(fid, self.drive, ring, ring.begun, None)
            ring.begun += 1
        else:
            frame = _Frame(fid, self.drive, None, fid, np.zeros(SLOTS, dtype=np.int64))
        self._frames[fid % self.capacity] = frame
        self._local.stack.current = frame
        return fid

    def frame_ring(self, device) -> _DeviceRing | None:
        """The ring of the frame this thread steps, when the frame is on
        `device`'s ring; None outside a frame or for a frame elsewhere. A
        kernel writes into the row its frame counter chooses."""
        frame = self._local.stack.current
        if frame is None or frame.ring is None or frame.ring.device != device:
            return None
        return frame.ring

    def count_diffusion(self, cells: torch.Tensor, rounds: torch.Tensor) -> None:
        """The filter's two counts (module docstring, 0-dim CPU tensors)
        for the frame this thread steps on the CPU, kept beside its row
        until it is read. A frame on a card takes them from the card's
        kernel: nothing is kept for it, nor outside a frame."""
        frame = self._local.stack.current
        if frame is not None and (frame.ring is None or frame.ring.rows.device.type == "cpu"):
            frame.counts.update({VEHICLE_CELLS: cells, DIFFUSION_ROUNDS: rounds})

    def count_staging(self, rows: int, buffers: int) -> None:
        """Scan rows staged and staging buffers made (module docstring),
        added to the frame of the span open on this thread; outside every
        frame nothing is kept."""
        stack = self._local.stack
        frame = stack.current.id if stack.current is not None else stack[-1][1] if stack else -1
        if frame < 0:
            return
        k = frame % self.capacity
        have = self._staging[k]
        if have is not None and have[0] == frame:
            rows, buffers = rows + have[1], buffers + have[2]
        self._staging[k] = (frame, rows, buffers)

    def close_frame(self) -> None:
        """The frame's last stamp (END_FRAME) is launched: the device's
        frame counter moves on past it."""
        self._local.stack.current.closed = True

    def end_frame(self) -> None:
        """The thread's frame ends. A frame that was never closed (its step
        raised first) is no frame of the recorder: its device's counter did
        not move, so the host's count steps back with it, and the next
        frame takes its row."""
        stack = self._local.stack
        frame, stack.current = stack.current, None
        if frame is None:
            return
        frame.ended = frame.closed
        if not frame.closed and frame.ring is not None:
            frame.ring.begun -= 1

    def read(self) -> Snapshot:
        """The spans and frames the rings hold (module docstring)."""
        rows = {ring: ring.rows.cpu().numpy() for ring in list(self._rings.values())}
        frames = sorted((f for f in self._frames if f is not None and f.ended), key=lambda f: f.id)
        spans = sorted((Span(*t) for t in self._spans if t is not None), key=lambda s: s.seq)
        by_frame: dict = {}
        for s in spans:
            by_frame.setdefault(s.frame, []).append(s)
        records = []
        for f in frames:
            row = f.row if f.ring is None else rows[f.ring][f.seq % self.capacity]
            if f.counts:
                row = row.copy()
                for slot, c in f.counts.items():
                    row[slot] = int(c)
            live = int(row[LIVE_ROWS]) if f.ring is not None or LIVE_ROWS in f.counts else None
            staged = self._staging[f.id % self.capacity]
            staged = staged if staged is not None and staged[0] == f.id else (f.id, 0, 0)
            n = int(row[PIECES]) if int(row[SEQ]) == f.seq else 0
            kept = min(n, MAX_PIECES)
            records.append(FrameRecord(
                frame=f.id, drive=f.drive, device="cpu" if f.ring is None else str(f.ring.device),
                stages_ns={k: int(row[v]) for k, v in STAGES.items()} if n else None,
                first_ns=int(row[FIRST]) if n else None, last_ns=int(row[LAST]) if n else None,
                pieces=[(int(row[PIECE0 + 2 * i]), int(row[PIECE0 + 2 * i + 1])) for i in range(kept)],
                pieces_run=n, live_rows=live if n else None,
                vehicle_cells=int(row[VEHICLE_CELLS]) if n else None,
                diffusion_rounds=int(row[DIFFUSION_ROUNDS]) if n else None,
                deskewed_points=int(row[DESKEWED_POINTS]) if n else None,
                corr_found_pairs=int(row[CORR_FOUND_PAIRS]) if n else None,
                search_sources=int(row[SEARCH_SOURCES]) if n else None,
                search_pairs=int(row[SEARCH_PAIRS]) if n else None,
                search_candidates=int(row[SEARCH_CANDIDATES]) if n else None,
                spans=[s for s in by_frame.get(f.id, []) if s.drive == f.drive],
                staged_rows=staged[1], staging_buffers=staged[2]))
        return Snapshot(records, spans)


class StageClock:
    """The stamps of one device's step (module docstring): begin opens a
    frame's row and its first piece, start opens a piece, split ends a
    stage inside a piece, close ends a stage and the piece, end_frame
    closes the frame's last piece and copies its GN live-row count
    (`value`, a 0-dim int32 tensor). split and close also copy a count
    into the slot `into` when they are given one (the deskewed points, the
    found pairs: a 0-dim int32), or a vector of counts into the slots from
    `into` on (the search counts: a 1-dim int64). Nothing is read back. A stamp belongs to the frame this thread steps
    (Recorder.begin_frame); outside one it raises."""

    def __init__(self, rec: Recorder, device: torch.device):
        self._rec = rec
        self._ring = rec._ring(device) if device.type == "cuda" else None

    def begin(self) -> None:
        self._stamp(BEGIN, 0)

    def start(self) -> None:
        self._stamp(START, 0)

    def split(self, slot: int, value: torch.Tensor | None = None, into: int = LIVE_ROWS) -> None:
        self._stamp(SPLIT, slot, value, into)

    def close(self, slot: int, value: torch.Tensor | None = None, into: int = LIVE_ROWS) -> None:
        self._stamp(CLOSE, slot, value, into)

    def end_frame(self, slot: int, value: torch.Tensor | None = None) -> None:
        self._stamp(END_FRAME, slot, value)

    def _stamp(self, op: int, slot: int, value=None, into: int = LIVE_ROWS) -> None:
        frame = self._rec._local.stack.current
        if frame is None:
            raise RuntimeError("a stage-clock stamp outside a frame (Recorder.begin_frame)")
        ring = self._ring
        if ring is None:
            stamp_row(frame.row, op, slot, time.perf_counter_ns(), frame.seq)
            if value is not None:
                for k, c in enumerate(value.clone().reshape(-1)):
                    frame.counts[into + k] = c
            return
        from sage_icp_tpu_torch.ops import cuda_lib

        wide = 0  # the int64 counts at value; 0: one int32
        if value is not None:
            if value.dtype == torch.int64:
                wide = value.numel()
                cuda_lib.check_cuda("value", value, torch.int64, (wide,))
            else:
                cuda_lib.check_cuda("value", value, torch.int32, ())
        fn = cuda_lib.function("stage_clock.cu", "sage_stage_clock", _ARGTYPES)
        cuda_lib.call("stage_clock", fn, ring.device, cuda_lib.ptr(ring.rows), cuda_lib.ptr(ring.counter),
                      ring.rows.shape[0], op, slot, None if value is None else cuda_lib.ptr(value), into, wide)


RECORDER = Recorder()


def span(name: str) -> _Span:
    return RECORDER.span(name)
