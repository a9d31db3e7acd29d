// The device's stage clock (runtime/tracing.py): one thread reads the
// card's %globaltimer (ns) and writes it into a ring of per-frame rows,
// so a frame's stage times are measured where they run, also inside the
// step's CUDA graphs, and read back only when the recorder is read.
//
// A captured launch's arguments are frozen, so the row is not an
// argument: it is chosen by a frame counter in device memory, which the
// frame's last stamp advances. Every stamp of a frame writes the row
// ring[frame % capacity].
//
// Row (int64, runtime/tracing.py holds the same layout):
//   0 seq      the frame counter at the frame's first stamp
//   1 first    the first stamp's time      2 last   the last stamp's time
//   3 mark     the time the current stage started
//   4 head .. 8 update   the stages' summed device time, ns
//   9 live_rows          the GN live-row count of the frame (END_FRAME's value)
//   10 runs              pieces the frame ran (a graph replay, or an eager piece)
//   11 .. 26             (start, end) of each piece; past kMaxRuns pieces the
//                        last pair holds the latest piece
//   27 vehicle_cells, 28 diffusion_rounds
//                        the dynamic filter's counts, written by its
//                        min-diffusion (csrc/min_diffusion.cu); 0 without it
//   29 deskew            the deskew stage's summed device time, ns
//   30 deskewed_points   the scan's rows deskew moved, written by the stamp
//                        that ends the deskew stage; 0 without deskew
//   31 corr_found_pairs  the found (row, neighbour) pairs of the frame's row
//                        builds so far, written by the stamps that close the
//                        prepare and reanchor pieces; 0 on the reference path
//
// Ops: BEGIN opens the frame and its first piece (the row zeroed); START
// opens a piece; SPLIT ends a stage (slot) and starts the next inside a
// piece; CLOSE ends a stage and the piece; END_FRAME does CLOSE and
// advances the frame counter. SPLIT, CLOSE and END_FRAME copy *value, when
// given, into the slot `into` (END_FRAME's: live_rows). The time between
// pieces is in no slot: it is the device's idle time.
//
// What bounds it: one thread, a handful of 8-byte loads and stores; the
// launch latency is the floor (a few microseconds a stamp).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kSeq = 0, kFirst = 1, kLast = 2, kMark = 3, kRuns = 10, kRun0 = 11;
constexpr int kMaxRuns = 8;
constexpr int kSlots = kRun0 + 2 * kMaxRuns + 5;
constexpr int kBegin = 0, kStart = 1, kSplit = 2, kClose = 3, kEndFrame = 4;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void stage_clock_kernel(long long* __restrict__ ring, long long* __restrict__ frame, int capacity,
                                   int op, int slot, const int32_t* __restrict__ value, int into,
                                   unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  const long long t = global_ns();
  const long long seq = *frame;
  long long* row = ring + (seq % capacity) * kSlots;
  if (op == kBegin) {
    for (int k = 0; k < kSlots; ++k) row[k] = 0;
    row[kSeq] = seq;
    row[kFirst] = row[kLast] = row[kMark] = t;
    row[kRun0] = t;
    row[kRuns] = 1;
    return;
  }
  const long long n = row[kRuns];
  if (op == kStart) {
    row[kRun0 + 2 * (n < kMaxRuns ? n : kMaxRuns - 1)] = t;
    row[kRuns] = n + 1;
    row[kMark] = t;
    return;
  }
  row[slot] += t - row[kMark];
  row[kMark] = t;
  row[kLast] = t;
  if (value != nullptr) row[into] = *value;
  if (op == kSplit) return;
  row[kRun0 + 2 * (n < kMaxRuns ? n : kMaxRuns) - 1] = t;
  if (op == kEndFrame) *frame = seq + 1;
}

}  // namespace

// ring: (capacity, 32) int64 rows; frame: one int64, the frame counter;
// slot: the stage of SPLIT / CLOSE / END_FRAME; value: one int32 or null,
// copied into the slot `into`. All device pointers. One launch of one
// thread.
extern "C" int sage_stage_clock(void* ring, void* frame, int capacity, int op, int slot, const void* value,
                                int into, void* launches, void* stream) {
  stage_clock_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)ring, (long long*)frame, capacity, op, slot,
                                                        (const int32_t*)value, into, (unsigned long long*)launches);
  return (int)cudaGetLastError();
}
