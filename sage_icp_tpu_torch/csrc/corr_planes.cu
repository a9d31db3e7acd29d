// The candidate planes of the correspondence rows (ops/correspondence_fast.py
// candidate_planes, called by corr_setup): for each row of a setup and each
// of its 27 neighbour voxels, the neighbour's slot in the map and the
// slot's (4, K) int16 block, written into the rows' four int16 planes.
//
// Replaces no TPU kernel. The JAX package builds these planes with XLA's
// gathers in corr_setup (sage_icp_tpu/ops/correspondence_fast.py:280-316:
// the probe's window-row gather and first-match reduce, the block gather and
// one transpose into planes). In PyTorch that was two one-warp-a-row
// gathers over R x 27 (row, neighbour) pairs (497,664 at the kitti preset),
// a strided permute copy of the 159 MB gather, and a masked rewrite of the
// label plane, plus the hash chain's elementwise ops.
//
// What it computes, per (row, neighbour n) pair, exactly as the plain
// version (candidate_planes_plain) does:
//   * the neighbour voxel rel = row_rel + offset(n) (NEIGHBOR_OFFSETS order:
//     n = 9 (dx + 1) + 3 (dy + 1) + (dz + 1)), its packed code (10 bits an
//     axis, -1 when an axis leaves +-255 or the row is dead), and its hash
//     hm.hash_keys(rel + center) in uint32 arithmetic;
//   * found: some depth d < D of the window row window[hash] equals the
//     code (code >= 0); the slot is (hash + d (d + 1) / 2) & (cap - 1) for
//     the first such d. With the dense grid the caller gives (found, slot);
//   * lanes [n K, n K + K) of the row in each plane: the slot's block (slot
//     0's when not found), and in the label plane -1 when not found.
// It adds the found pairs (only live rows find) into *found_pairs.
//
// What bounds it on an H100: bytes. At the kitti preset (R = 18,432, K =
// 40) it writes 4 x 18,432 x 1,080 x 2 B = 159.3 MB of planes and reads at
// most 23.9 MB of window rows and 159.3 MB of blocks (neighbouring rows
// share most blocks, so the reads mostly hit L2): 0.048-0.10 ms at 3.35
// TB/s.
//
// Design: a warp per row, kWarps rows a block.
//  1. Lanes 0-26 each probe one neighbour: the packed code, the hash and
//     the window row's D loads (all independent), the first match. The
//     warp's found mask is one ballot; the slots (slot 0 where not found)
//     go to the warp's row of shared memory.
//  2. The warp writes the row's four plane rows, each 27 K int16, as
//     vectors of sizeof(V) bytes: lane l takes chunks l, l + 32, ...
//     (plane, neighbour, chunk within the neighbour's K lanes), so
//     consecutive lanes store consecutive addresses, and each chunk is one
//     load from its slot's block (L2 keeps slot 0's block and the shared
//     neighbours). V is the widest of 16, 8, 4 or 2 bytes that divides 2 K
//     (the wrapper picks it): 80-byte segments at K = 40 go as 16-byte
//     vectors, 40-byte ones at K = 20 as 8-byte vectors.
//  3. The block's found pairs are summed in shared memory; one atomic a
//     block adds them to the caller's counter.
// Nothing is allocated and nothing synchronises with the host, so the
// launch is captured in the step's CUDA graphs as it is; the rows come in
// as arguments.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kNeighbours = 27;
constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackLim = 255;  // correspondence_fast.PACK_LIM
constexpr int kPackBits = 10;  // correspondence_fast.PACK_BITS

template <typename V>
__device__ __forceinline__ V all_ones();
template <>
__device__ __forceinline__ int4 all_ones<int4>() { return make_int4(-1, -1, -1, -1); }
template <>
__device__ __forceinline__ int2 all_ones<int2>() { return make_int2(-1, -1); }
template <>
__device__ __forceinline__ int all_ones<int>() { return -1; }
template <>
__device__ __forceinline__ short all_ones<short>() { return -1; }

// hm.hash_keys of one voxel key: x 73856093 ^ y 19349663 ^ z 83492791 in
// uint32 with wraparound, then the Fibonacci multiply's top cap_bits bits
__device__ __forceinline__ uint32_t hash_key(uint32_t x, uint32_t y, uint32_t z, int cap_bits) {
  const uint32_t h = x * 73856093u ^ y * 19349663u ^ z * 83492791u;
  return cap_bits == 0 ? 0u : (h * 2654435769u) >> (32 - cap_bits);
}

// correspondence_fast.pack_rel of one relative voxel
__device__ __forceinline__ int pack_rel(int x, int y, int z) {
  if (abs(x) > kPackLim || abs(y) > kPackLim || abs(z) > kPackLim) return -1;
  constexpr int b = 1 << kPackBits;
  return (x + 256) * (b * b) + (y + 256) * b + (z + 256);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) corr_planes_kernel(
    const int32_t* __restrict__ row_rel, const uint8_t* __restrict__ row_live, const int32_t* __restrict__ center,
    const int32_t* __restrict__ window, const int16_t* __restrict__ points2, const uint8_t* __restrict__ grid_found,
    const int32_t* __restrict__ grid_slot, int rows, int cap_bits, int depth, int K, int16_t* __restrict__ planes,
    int32_t* __restrict__ found_pairs, unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  __shared__ int s_slot[kWarps][kNeighbours];
  __shared__ int s_found;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (threadIdx.x == 0) s_found = 0;
  __syncthreads();

  if (r < rows) {
    // 1. lane n < 27 probes neighbour n
    bool found = false;
    int slot = 0;
    if (lane < kNeighbours) {
      if (grid_found != nullptr) {
        found = grid_found[r * kNeighbours + lane] != 0;
        slot = found ? grid_slot[r * kNeighbours + lane] : 0;
      } else if (row_live[r] != 0) {
        const int x = row_rel[3 * r] + lane / 9 - 1;
        const int y = row_rel[3 * r + 1] + (lane / 3) % 3 - 1;
        const int z = row_rel[3 * r + 2] + lane % 3 - 1;
        const int code = pack_rel(x, y, z);
        if (code >= 0) {
          const uint32_t h = hash_key(static_cast<uint32_t>(x) + static_cast<uint32_t>(center[0]),
                                      static_cast<uint32_t>(y) + static_cast<uint32_t>(center[1]),
                                      static_cast<uint32_t>(z) + static_cast<uint32_t>(center[2]), cap_bits);
          const int32_t* w = window + static_cast<size_t>(h) * depth;
          int first = depth;
#pragma unroll 4
          for (int d = 0; d < depth; ++d) {
            if (__ldg(w + d) == code && first == depth) first = d;
          }
          found = first < depth;
          const uint32_t mask = cap_bits == 0 ? 0u : (1u << cap_bits) - 1u;
          slot = found ? static_cast<int>((h + static_cast<uint32_t>(first * (first + 1) / 2)) & mask) : 0;
        }
      }
      s_slot[warp][lane] = slot;
    }
    const unsigned fmask = __ballot_sync(kFull, found);
    if (lane == 0 && fmask != 0u) atomicAdd(&s_found, __popc(fmask));
    __syncwarp();

    // 2. the row's four plane rows, chunk by chunk
    constexpr int kVec = sizeof(V) / sizeof(int16_t);
    const int cps = K / kVec;  // chunks a neighbour's segment
    const int per_plane = kNeighbours * cps;
    const int M = kNeighbours * K;
    const size_t plane_stride = static_cast<size_t>(rows) * M;
    int16_t* out = planes + static_cast<size_t>(r) * M;
#pragma unroll 4
    for (int i = lane; i < 4 * per_plane; i += 32) {
      const int a = i / per_plane;
      const int rem = i - a * per_plane;
      const int n = rem / cps;
      const int lanes = n * K + (rem - n * cps) * kVec;  // the chunk's first lane in the plane row
      V v;
      if (a == 3 && ((fmask >> n) & 1u) == 0u) {
        v = all_ones<V>();
      } else {
        const int16_t* src = points2 + static_cast<size_t>(s_slot[warp][n]) * (4 * K) + a * K + (lanes - n * K);
        v = __ldg(reinterpret_cast<const V*>(src));
      }
      *reinterpret_cast<V*>(out + a * plane_stride + lanes) = v;
    }
  }

  // 3. the block's found pairs
  if (found_pairs != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0 && s_found != 0) atomicAdd(found_pairs, s_found);
  }
}

template <typename V>
int launch(const void* row_rel, const void* row_live, const void* center, const void* window, const void* points2,
           const void* grid_found, const void* grid_slot, int rows, int cap_bits, int depth, int K, void* planes,
           void* found_pairs, void* launches, void* stream) {
  const int blocks = rows > 0 ? (rows + kWarps - 1) / kWarps : 1;
  corr_planes_kernel<V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)row_rel, (const uint8_t*)row_live, (const int32_t*)center, (const int32_t*)window,
      (const int16_t*)points2, (const uint8_t*)grid_found, (const int32_t*)grid_slot, rows, cap_bits, depth, K,
      (int16_t*)planes, (int32_t*)found_pairs, (unsigned long long*)launches);
  return (int)cudaGetLastError();
}

}  // namespace

// row_rel: (rows, 3) int32, the rows' voxels relative to center; row_live:
// (rows,) bool; center: (3,) int32; window: (2^cap_bits, depth) int32
// packed keys; points2: (2^cap_bits, 4 K) int16 blocks, `width`-byte
// aligned; grid_found / grid_slot: (rows, 27) bool / int32, or both null
// (probe the window); planes: (4, rows, 27 K) int16 out; found_pairs: one
// int32 the found pairs are added to, or null. width: the bytes of a store,
// 16, 8, 4 or 2, dividing 2 K. All device pointers. One launch.
extern "C" int sage_corr_planes(const void* row_rel, const void* row_live, const void* center, const void* window,
                                const void* points2, const void* grid_found, const void* grid_slot, int rows,
                                int cap_bits, int depth, int K, int width, void* planes, void* found_pairs,
                                void* launches, void* stream) {
  switch (width) {
    case 16:
      return launch<int4>(row_rel, row_live, center, window, points2, grid_found, grid_slot, rows, cap_bits, depth, K,
                          planes, found_pairs, launches, stream);
    case 8:
      return launch<int2>(row_rel, row_live, center, window, points2, grid_found, grid_slot, rows, cap_bits, depth, K,
                          planes, found_pairs, launches, stream);
    case 4:
      return launch<int>(row_rel, row_live, center, window, points2, grid_found, grid_slot, rows, cap_bits, depth, K,
                         planes, found_pairs, launches, stream);
    case 2:
      return launch<short>(row_rel, row_live, center, window, points2, grid_found, grid_slot, rows, cap_bits, depth,
                           K, planes, found_pairs, launches, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
