// The dynamic filter's min-diffusion over the occupied vehicle cells
// (ops/dynamic_filter.py cluster_ids): the 27-connected cluster id of every
// row of the vehicle sort.
//
// Replaces no TPU kernel. The JAX package diffuses with 24 rounds of
// lax.reduce_window over the dense (nx, nx, 32) grid
// (sage_icp_tpu/ops/dynamic_filter.py:211-219), as the port's plain version
// does with max_pool3d (_min_diffusion): 1,384,448 cells a round at the
// presets' nx of 208, for the ~2k cells a kitti scan occupies (at most
// 16,384, the rows of the vehicle sort).
//
// What it computes. The occupied cells are the distinct keys of the
// vehicle sort (vk: ascending cell ids, `big` past the members). Each
// starts with its own id. A round gives every cell the minimum of its own
// value and its occupied 26 neighbours' values of the previous round
// (synchronous, double-buffered; cells outside the grid do not exist).
// max_rounds rounds run (_CC_ITERS, 24), or fewer when a round changes no
// value: every later round is then the identity. Each sorted row gets its
// cell's final id, G = nx * nx * nz past the members: exactly what
// where(occ, min(c, minpool3(c)), big) iterated max_rounds times gives.
//
// What bounds it on an H100: latency. Its data is at most 16,384 cells
// (64 KB of keys in, 128 KB of ids out: ~0.06 us at 3.35 TB/s); the floor
// is the launch and the rounds' barriers.
//
// Design: one cluster of kCluster (4) blocks of 1024 threads on four SMs;
// the cells' values never leave shared memory.
//  1. Ranks, in every block. Lane l of warp w holds rows 512 w + 32 j + l
//     (j < 16) of the sort in registers, read with 16 independent loads; a
//     shuffle gives each row the key before it, a ballot the warp's
//     segment heads, a scan of the 32 warp counts every head's rank, and
//     the heads' ids go to shared memory in rank order, ascending. From
//     here on a value is a rank (16 bits): the smaller rank is the smaller
//     id, so every minimum is the same.
//  2. The neighbour table, once: block k takes the cells k * 1024 + t +
//     4096 i. A cell's neighbours lie in 9 z-columns, and in each the
//     occupied cells at z-1..z+1 have consecutive ranks. Own column: two
//     bits (the ranks just below and above are its z-1 and z+1). Each of
//     the 8 other columns: one binary search of the ids, bounded by the id
//     distance to the column, gives a 16-bit entry, the first rank and the
//     count (at most 3). 16 bytes a cell, in the block's shared memory.
//  3. Rounds without branches: a cell loads its table entry and then all
//     27 candidate values at once (a column's 3 ranks from its first,
//     clamped; its count selects which count), and its block writes the
//     new value into every block's copy of the values (distributed shared
//     memory). One cluster barrier a round; a warp with a changed value
//     marks the round in every block first, so the rounds end together at
//     the fixed point.
//  4. Every sorted row's id, ids[value[rank]], as int64 (the caller
//     indexes with it), each block a quarter of the rows, reloaded into
//     registers; the two counts into the recorder's frame row
//     (runtime/tracing.py): the occupied cells and the rounds that changed
//     a value.
// The launch geometry is fixed (one cluster), so the launch is captured in
// the step's CUDA graph as it is; the occupied count is read from the data.
// Cluster size, by measurement (H100, CUDA events, kernel ms on two kitti
// frames of 1,922 and 2,496 cells / a solid 32 x 32 x 16 block and 16,384
// scattered cells; each a block barrier and a cluster barrier a round):
// one block 0.049, 0.065 / 0.533, 0.197 (one SM does every cell's work);
// 2: 0.038, 0.055 / 0.297, 0.109; 4: 0.038, 0.042 / 0.166, 0.061; 8: 0.042,
// 0.047 / 0.110, 0.040; 16: 0.054, 0.062 / 0.118, 0.037 (the barriers
// dominate small frames). Four is the fastest on the drives' frames and
// within 0.2 ms at the cap; with the block barrier gone: 0.037, 0.041 /
// 0.163, 0.061.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;  // rows a lane holds: kThreads * kPer = 16,384, the wrapper's cap
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRankBits = 14;
constexpr unsigned kRankMask = (1u << kRankBits) - 1u;
constexpr int kNone = 0xffff;  // above every rank
constexpr int kMaxRounds = 32;  // the wrapper's max_rounds, at most
constexpr int kCluster = 4;     // blocks of the cluster
constexpr int kSlots = kThreads * kPer / kCluster;  // cells a block computes, at most

// The lane's rows of the warp's span in registers (big past mv), and a
// bit j for each that heads a segment: a member whose key differs from
// the row before it.
__device__ __forceinline__ unsigned load_rows(const int32_t* vk, int mv, int big, int warp, int lane,
                                              int (&key)[kPer]) {
  const int p0 = warp * kPer * 32;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = p0 + j * 32 + lane;
    key[j] = i < mv ? vk[i] : big;
  }
  int prev = p0 > 0 && p0 <= mv ? vk[p0 - 1] : -1;  // keys are >= 0
  unsigned heads = 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int before = __shfl_up_sync(kFull, key[j], 1);
    if (lane == 0) before = prev;
    prev = __shfl_sync(kFull, key[j], 31);
    heads |= static_cast<unsigned>(key[j] != big && key[j] != before) << j;
  }
  return heads;
}

// the first position in [lo, hi) whose id is >= target; hi if none
__device__ __forceinline__ int lower_bound(const int32_t* ids, int lo, int hi, int target) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the 16-bit entry of the column (dx, dy) of cell c (id, at gx, gy, gz):
// the first rank of its cells at z-1..z+1 and their count
__device__ __forceinline__ unsigned column_entry(const int32_t* ids, int n, int c, int id, int gx, int gy, int zlo,
                                                 int zhi, int dx, int dy, int nx, int nz) {
  const int x = gx + dx, y = gy + dy;
  if (x < 0 || x >= nx || y < 0 || y >= nx) return 0u;
  const int step = dx * nx * nz + dy * nz;
  const int base = id + step;  // the column's same-z cell
  // the ids are distinct and ascending, so ranks lie no further apart than
  // ids: the column's cells are within d ranks of c, on the side of base
  const int d = (step < 0 ? -step : step) + 1;
  const int lo = step < 0 ? max(0, c - d) : c + 1;
  const int hi = step < 0 ? c : min(n, c + d + 1);
  const int first = lower_bound(ids, lo, hi, base + zlo);
  int count = 0;
  while (count < 3 && first + count < n && ids[first + count] <= base + zhi) ++count;
  return count == 0 ? 0u : (static_cast<unsigned>(count) << kRankBits) | static_cast<unsigned>(first);
}

// m and the values of the column entry e, their minimum: the three ranks
// from its first are loaded whatever its count (clamped to the last)
__device__ __forceinline__ int column_min(int m, unsigned e, const uint16_t* src, int last) {
  const int r = static_cast<int>(e & kRankMask);
  const int count = static_cast<int>(e >> kRankBits);
  const int a = src[min(r, last)], b = src[min(r + 1, last)], c = src[min(r + 2, last)];
  m = min(m, count >= 1 ? a : kNone);
  m = min(m, count >= 2 ? b : kNone);
  return min(m, count >= 3 ? c : kNone);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1) min_diffusion_kernel(
    const int32_t* __restrict__ vk, int mv, int nx, int nz, int big, int max_rounds, int64_t* __restrict__ out, long long* __restrict__ ring, const long long* __restrict__ frame, int capacity,
    int row_slots, int slot_cells, int slot_rounds, unsigned long long* __restrict__ launches) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  sage::count_launch(launches);
  extern __shared__ uint4 tab[];                                 // [kSlots] the block's cells' table entries
  int32_t* ids = reinterpret_cast<int32_t*>(tab + kSlots);      // [mv] occupied ids in rank order
  uint16_t* val = reinterpret_cast<uint16_t*>(ids + mv);        // [2][mv] values (ranks), double-buffered
  uint8_t* own = reinterpret_cast<uint8_t*>(val + 2 * mv);      // [kSlots] bit 0: z-1 occupied, bit 1: z+1
  __shared__ int warp_base[kWarps + 1];
  __shared__ int changed_in[kMaxRounds];  // a round's "a value changed", written by every block

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k = static_cast<int>(cluster.block_rank());
  const unsigned upto_lane = kFull >> (31 - lane);  // lanes 0..lane
  if (tid < kMaxRounds) changed_in[tid] = 0;

  // 1. ranks: heads counted by warp, scanned, the ids written in rank order
  int key[kPer];
  unsigned heads = load_rows(vk, mv, big, warp, lane, key);
  int count = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) count += __popc(__ballot_sync(kFull, (heads >> j) & 1u));
  if (lane == 0) warp_base[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_base[w];
      warp_base[w] = s;
      s += c;
    }
    warp_base[kWarps] = s;
  }
  __syncthreads();
  const int n = warp_base[kWarps];
  int rank = warp_base[warp];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool h = (heads >> j) & 1u;
    const unsigned bal = __ballot_sync(kFull, h);
    if (h) ids[rank + __popc(bal & upto_lane) - 1] = key[j];
    rank += __popc(bal);
  }
  __syncthreads();

  // 2. this block's cells' table entries; every block's values seeded
  for (int c = tid; c < n; c += kThreads) val[c] = static_cast<uint16_t>(c);
  for (int i = 0, c = k * kThreads + tid; c < n; ++i, c += kCluster * kThreads) {
    const int slot = i * kThreads + tid;
    const int id = ids[c];
    const int gz = id % nz, gy = (id / nz) % nx, gx = id / (nz * nx);
    const int zlo = gz > 0 ? -1 : 0, zhi = gz < nz - 1 ? 1 : 0;
    own[slot] = static_cast<uint8_t>((zlo != 0 && c > 0 && ids[c - 1] == id - 1 ? 1 : 0) |
                                                   (zhi != 0 && c + 1 < n && ids[c + 1] == id + 1 ? 2 : 0));
    unsigned e[8];
    int m = 0;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        if (dx != 0 || dy != 0) e[m++] = column_entry(ids, n, c, id, gx, gy, zlo, zhi, dx, dy, nx, nz);
      }
    }
    tab[slot] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
  cluster.sync();  // every block runs, and its flags are zero

  // 3. the rounds, to the fixed point or max_rounds
  int cur = 0, rounds = 0;
  const int last = n - 1;
  for (int r = 0; r < max_rounds; ++r) {
    const uint16_t* src = val + cur * mv;
    uint16_t* dst = val + (cur ^ 1) * mv;
    int changed = 0;
#pragma unroll 2
    for (int i = 0, c = k * kThreads + tid; c < n; ++i, c += kCluster * kThreads) {
      const uint4 t = tab[i * kThreads + tid];
      const int o = own[i * kThreads + tid];
      const int self = src[c], below = src[max(c - 1, 0)], above = src[min(c + 1, last)];
      int m = min(self, (o & 1) ? below : kNone);
      m = min(m, (o & 2) ? above : kNone);
      m = column_min(m, t.x & 0xffffu, src, last);
      m = column_min(m, t.x >> 16, src, last);
      m = column_min(m, t.y & 0xffffu, src, last);
      m = column_min(m, t.y >> 16, src, last);
      m = column_min(m, t.z & 0xffffu, src, last);
      m = column_min(m, t.z >> 16, src, last);
      m = column_min(m, t.w & 0xffffu, src, last);
      m = column_min(m, t.w >> 16, src, last);
#pragma unroll
      for (int q = 0; q < kCluster; ++q) cluster.map_shared_rank(dst, q)[c] = static_cast<uint16_t>(m);
      changed |= m != self;
    }
    cur ^= 1;
    if (__any_sync(kFull, changed) && lane < kCluster) *cluster.map_shared_rank(&changed_in[r], lane) = 1;
    cluster.sync();  // the values and the marks written everywhere
    if (!changed_in[r]) break;
    rounds = r + 1;
  }

  // 4. every sorted row's cluster id (block k writes rows j of its share);
  // the counts into the frame's row
  const uint16_t* fin = val + cur * mv;
  const long long G = static_cast<long long>(nx) * nx * nz;
  heads = load_rows(vk, mv, big, warp, lane, key);
  rank = warp_base[warp];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = warp * kPer * 32 + j * 32 + lane;
    const unsigned bal = __ballot_sync(kFull, (heads >> j) & 1u);
    if (j * kCluster / kPer == k && i < mv) {
      out[i] = key[j] != big ? static_cast<int64_t>(ids[fin[rank + __popc(bal & upto_lane) - 1]]) : G;
    }
    rank += __popc(bal);
  }
  if (k == 0 && tid == 0 && ring != nullptr) {
    long long* row = ring + (*frame % capacity) * row_slots;
    row[slot_cells] = n;
    row[slot_rounds] = rounds;
  }
}

}  // namespace

// vk: (mv,) int32 sorted cell keys, big past the members, mv <= 16,384;
// out: (mv,) int64. ring / frame: the recorder's rows ((capacity,
// row_slots) int64) and frame counter, or both null (no frame is
// recorded). All device pointers; max_rounds <= 32. One launch of one
// cluster.
extern "C" int sage_min_diffusion(const void* vk, int mv, int nx, int nz, int big, int max_rounds, void* out,
                                  void* ring, const void* frame, int capacity, int row_slots, int slot_cells,
                                  int slot_rounds, void* launches, void* stream) {
  if (max_rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  if (mv > 0) {
    // the table (16 B) and own (1 B) a slot; ids (4 B) and two value
    // buffers (2 B each) a row
    const size_t smem = static_cast<size_t>(kSlots) * 17 + static_cast<size_t>(mv) * 8;
    const cudaError_t err = cudaFuncSetAttribute(min_diffusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    min_diffusion_kernel<<<kCluster, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)vk, mv, nx, nz, big, max_rounds, (int64_t*)out, (long long*)ring, (const long long*)frame,
        capacity, row_slots, slot_cells, slot_rounds, (unsigned long long*)launches);
  }
  return (int)cudaGetLastError();
}
