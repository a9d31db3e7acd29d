// Voxel-block retention policy (VoxelBlock::AddPoint) over the touched
// rows of one frame's map insert.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_insert.py::apply_policy
// (_kernel, and _kernel_packed, whose lane packing only fills the TPU's
// 128-lane vectors and has no counterpart here).
//
// What bounds it on an H100: bytes. At the kitti preset (U 33,024 rows,
// K 40, R_max 48) it reads the 4 x (U, K) int16 block planes (10.6 MB),
// the counts and seglens, and the incoming ranks the rows use, and writes
// 10.6 MB of planes: ~26 MB, 7.9 us at 3.35 TB/s. The work per row is a
// short serial replay of at most seglen <= R_max ranks, a few integer
// operations each.
//
// Design: a block takes a tile of kRows consecutive rows, one thread per
// row. The (U, K) and (U, R_max) planes are row-major, so the tile is one
// contiguous span in every plane:
//  1. Staging. The tile's 4 block planes go to shared memory by cp.async,
//     16 bytes a thread, coalesced; then the 16-byte chunks of the 4
//     incoming planes that hold a rank below its row's seglen (2-byte
//     copies where a span is not 16-byte aligned). Counts and seglens go
//     to registers meanwhile. Every byte is requested before the first
//     wait, so the tile's loads are all in flight at once.
//  2. Replay. Each thread replays its row from shared memory: the state is
//     the count and a 64-bit mask of the live label-0 slots (the first one
//     is __ffsll of the mask), so the chain of decisions touches no device
//     memory. A decision only records, per slot, which rank last wrote it
//     (the rank's offset in the tile's incoming span, -1 for none); a
//     row's loop is bounded by its own seglen.
//  3. Write-out. The tile's 4 output planes are written 16 bytes a thread
//     from shared memory alone: a slot's staged value, or the staged
//     values of the rank that wrote it.
// Shared memory is kRows x (10 K + 8 R_max) bytes, 50 KB at the presets
// (4 blocks an SM); the wrapper raises past K 64 (the mask) or R_max 64.
// The result is integers only and matches the plain PyTorch version bit
// for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kRows = 64;  // rows per tile = threads per block
static_assert(kRows % 32 == 0, "a tile is whole warps");
constexpr int kClsShift = 12;
constexpr int kLabelMask = (1 << kClsShift) - 1;
constexpr int kMaxSpan = 64;  // the largest K and R_max

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// n int16 of `src` to shared `dst` (16-byte aligned): cp.async 16 bytes at
// a time when `src` is 16-byte aligned, the tail and misaligned spans by
// plain copies. Completes at cp_async_wait_all + __syncthreads.
__device__ __forceinline__ void stage(int16_t* dst, const int16_t* __restrict__ src, int n) {
  int done = 0;
  if (aligned16(src)) {
    const int chunks = n >> 3;
    for (int c = threadIdx.x; c < chunks; c += kRows) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + 8 * c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + 8 * c));
    }
    done = chunks << 3;
  }
  for (int e = done + threadIdx.x; e < n; e += kRows) dst[e] = src[e];
}

// The tile's span of the 4 incoming (rows, R) planes to shared memory,
// only where a rank is below its row's seglen (seg_s): 16-byte chunks by
// cp.async when every plane's span is 16-byte aligned, else 2-byte copies.
__device__ __forceinline__ void stage_incoming(int16_t* const* dst, const int16_t* const* src,
                                               const int* seg_s, int rows, int R) {
  const int n = rows * R;
  bool vec = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) vec = vec && aligned16(src[i]);
  int done = 0;
  if (vec) {
    const int chunks = n >> 3;
    for (int c = threadIdx.x; c < chunks; c += kRows) {
      const int e0 = 8 * c;
      const int row0 = e0 / R;
      // needed when a rank of the chunk is below its row's seglen; a row
      // after the first starts at rank 0 (R < 8 puts several rows in one)
      bool need = e0 - row0 * R < seg_s[row0];
      for (int row = row0 + 1; row <= (e0 + 7) / R; ++row) need = need || seg_s[row] > 0;
      if (!need) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst[i] + e0));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src[i] + e0));
      }
    }
    done = chunks << 3;
  }
  for (int e = done + threadIdx.x; e < n; e += kRows) {
    const int row = e / R;
    if (e - row * R >= seg_s[row]) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i][e] = src[i][e];
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Two int16 of a plane packed in `v`, their writers in `w`: a slot that
// a rank wrote takes the rank's value from `inc`.
__device__ __forceinline__ unsigned merge2(unsigned v, unsigned w, const int16_t* inc) {
  const int w0 = static_cast<int16_t>(w & 0xffffu);
  const int w1 = static_cast<int16_t>(w >> 16);
  const unsigned lo = w0 >= 0 ? static_cast<uint16_t>(inc[w0]) : v & 0xffffu;
  const unsigned hi = w1 >= 0 ? static_cast<uint16_t>(inc[w1]) : v >> 16;
  return lo | (hi << 16);
}

// out[e] for the tile's span of one plane, from shared memory: the staged
// block value, or where a rank wrote slot e, that rank's staged value.
__device__ __forceinline__ void write_plane(int16_t* __restrict__ out, const int16_t* blk_s,
                                            const int16_t* writer_s, const int16_t* inc_s, int n) {
  int done = 0;
  if (aligned16(out)) {
    const int chunks = n >> 3;
    for (int c = threadIdx.x; c < chunks; c += kRows) {
      uint4 v = reinterpret_cast<const uint4*>(blk_s)[c];
      const uint4 w = reinterpret_cast<const uint4*>(writer_s)[c];
      v.x = merge2(v.x, w.x, inc_s);
      v.y = merge2(v.y, w.y, inc_s);
      v.z = merge2(v.z, w.z, inc_s);
      v.w = merge2(v.w, w.w, inc_s);
      reinterpret_cast<uint4*>(out)[c] = v;
    }
    done = chunks << 3;
  }
  for (int e = done + threadIdx.x; e < n; e += kRows) {
    const int w = writer_s[e];
    out[e] = w >= 0 ? inc_s[w] : blk_s[e];
  }
}

__global__ void __launch_bounds__(kRows) retention_policy_kernel(
    const int16_t* __restrict__ bx, const int16_t* __restrict__ by,
    const int16_t* __restrict__ bz, const int16_t* __restrict__ bl,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ seglen,
    const int16_t* __restrict__ ix, const int16_t* __restrict__ iy,
    const int16_t* __restrict__ iz, const int16_t* __restrict__ ie,
    int U, int K, int R, int basic,
    int16_t* __restrict__ ox, int16_t* __restrict__ oy,
    int16_t* __restrict__ oz, int16_t* __restrict__ ol,
    int32_t* __restrict__ ocnt, unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  extern __shared__ int4 smem[];
  __shared__ int seg_s[kRows];
  // kRows * K and kRows * R are multiples of 8 int16, so every array
  // starts 16-byte aligned
  const int tk = kRows * K;
  const int tr = kRows * R;
  int16_t* x_s = reinterpret_cast<int16_t*>(smem);
  int16_t* y_s = x_s + tk;
  int16_t* z_s = y_s + tk;
  int16_t* l_s = z_s + tk;
  int16_t* w_s = l_s + tk;  // the rank that last wrote each slot, -1 none
  int16_t* ix_s = w_s + tk;  // the tile's incoming planes, ranks < seglen
  int16_t* iy_s = ix_s + tr;
  int16_t* iz_s = iy_s + tr;
  int16_t* e_s = iz_s + tr;  // incoming classes | labels

  const int u0 = blockIdx.x * kRows;
  const int rows = min(kRows, U - u0);
  const int nk = rows * K;
  const long kbase = (long)u0 * K;
  const long rbase = (long)u0 * R;
  const int t = threadIdx.x;
  const bool live = t < rows;
  int cnt = live ? counts[u0 + t] : 0;
  const int seg = live ? min(seglen[u0 + t], R) : 0;
  seg_s[t] = seg;

  stage(x_s, bx + kbase, nk);
  stage(y_s, by + kbase, nk);
  stage(z_s, bz + kbase, nk);
  stage(l_s, bl + kbase, nk);
  for (int c = t; c < (tk >> 3); c += kRows) reinterpret_cast<int4*>(w_s)[c] = make_int4(-1, -1, -1, -1);
  __syncthreads();  // seg_s
  int16_t* const inc_s[4] = {ix_s, iy_s, iz_s, e_s};
  const int16_t* const inc[4] = {ix + rbase, iy + rbase, iz + rbase, ie + rbase};
  stage_incoming(inc_s, inc, seg_s, rows, R);
  cp_async_wait_all();
  __syncthreads();

  if (live) {
    const int16_t* lrow = l_s + t * K;
    int16_t* wrow = w_s + t * K;
    const int16_t* erow = e_s + t * R;
    unsigned long long zero_live = 0ull;
    for (int k = 0; k < K; ++k) {
      if (lrow[k] == 0 && k < cnt) zero_live |= 1ull << k;
    }
#pragma unroll 4
    for (int r = 0; r < seg; ++r) {
      const int enc = erow[r];
      const int cls = enc >> kClsShift;  // 0 label-0, 1 basic, 2 critical
      const bool append_basic = cnt < basic;
      const bool do_append = append_basic || (cls == 2 && cnt < K);
      const bool do_over =
          !append_basic && (cls == 1 || (cls == 2 && cnt >= K)) && zero_live != 0ull;
      // an append past K (basic > K) writes nothing, as in the plain version
      const int tgt = do_append ? cnt : __ffsll((long long)zero_live) - 1;
      if ((do_append || do_over) && tgt < K) {
        wrow[tgt] = static_cast<int16_t>(t * R + r);
        if ((enc & kLabelMask) == 0) {
          zero_live |= 1ull << tgt;
        } else {
          zero_live &= ~(1ull << tgt);
        }
      }
      cnt += do_append ? 1 : 0;
    }
    ocnt[u0 + t] = cnt;
  }
  __syncthreads();

  write_plane(ox + kbase, x_s, w_s, ix_s, nk);
  write_plane(oy + kbase, y_s, w_s, iy_s, nk);
  write_plane(oz + kbase, z_s, w_s, iz_s, nk);
  // the label plane: the staged classes carry the label in their low bits
  for (int e = t; e < rows * R; e += kRows) e_s[e] = static_cast<int16_t>(e_s[e] & kLabelMask);
  __syncthreads();
  write_plane(ol + kbase, l_s, w_s, e_s, nk);
}

}  // namespace

extern "C" int sage_retention_policy(
    const void* bx, const void* by, const void* bz, const void* bl,
    const void* counts, const void* seglen, const void* ix, const void* iy,
    const void* iz, const void* ie, int U, int K, int R, int basic,
    void* ox, void* oy, void* oz, void* ol, void* ocnt, void* launches, void* stream) {
  if (K < 1 || K > kMaxSpan || R < 1 || R > kMaxSpan) return (int)cudaErrorInvalidValue;
  if (U > 0) {
    const size_t smem = (size_t)kRows * (5 * K + 4 * R) * sizeof(int16_t);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          retention_policy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    retention_policy_kernel<<<(U + kRows - 1) / kRows, kRows, smem, (cudaStream_t)stream>>>(
        (const int16_t*)bx, (const int16_t*)by, (const int16_t*)bz,
        (const int16_t*)bl, (const int32_t*)counts, (const int32_t*)seglen,
        (const int16_t*)ix, (const int16_t*)iy, (const int16_t*)iz,
        (const int16_t*)ie, U, K, R, basic, (int16_t*)ox, (int16_t*)oy,
        (int16_t*)oz, (int16_t*)ol, (int32_t*)ocnt, (unsigned long long*)launches);
  }
  return (int)cudaGetLastError();
}
