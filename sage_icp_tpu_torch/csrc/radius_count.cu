// Radius count for the dynamic-vehicle filter: per query slot, the number
// of candidate lanes of its row with (dx*dx + dy*dy) + dz*dz <= r2, times
// the slot's used flag.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_nn.py::radius_count
// (_count_kernel). Its lane_ok mask only hides the TPU's tile padding; the
// rows here are exactly M lanes wide, so it has no counterpart.
//
// What bounds it on an H100: operations, counted as this data needs them.
// At the kitti filter's shapes (R 4,096 rows, M 864 lanes, P 48 slots;
// chip_smoke.py's phase-3 rows, about half of them without a used slot) it
// reads the candidates of the live rows once (~21 MB, ~6 us at 3.35 TB/s)
// and does 9 operations per lane of a used slot (~0.5 GFLOP, ~8 us at
// the 67 TFLOP/s float32 rate). That rate counts an FMA as two
// operations; the distance here is rounded operation by operation (no
// FMA), so it issues at half that rate and the practical floor is about
// twice the bound.
//
// Design: one block of kThreads per row, many rows in flight on an SM.
//  1. Compacted slots. The block reads the row's used flags and compacts
//     the used slots (a ballot prefix) into a list in shared memory with
//     their queries; unused slots are written 0 there and then. A row
//     without a used slot reads no candidate.
//  2. Lanes that cannot count are skipped exactly. Let lo/hi be the
//     per-axis bounds of the row's finite used queries and m a margin with
//     fl(m * m) > r2 (the wrapper's skip_margin). A lane c is dropped when
//     fl(c - hi) > m or fl(lo - c) > m on some axis. Why no count is lost:
//     for a finite query q on that axis, q <= hi gives c - q >= c - hi
//     exactly, and rounding to nearest is monotone, so fl(c - q) >=
//     fl(c - hi) > m (likewise for lo, as fl(c - q) = -fl(q - c)). Then
//     fl(d * d) >= fl(m * m) > r2 for that axis's difference d, and the
//     rounded sum of non-negative squares is no smaller than any one of
//     them, so d2 > r2. A query with a NaN or infinite coordinate counts
//     no lane at all (its d2 is NaN or +inf, and r2 is finite whenever
//     the skip is on), so it is left out of the bounds. A NaN lane is
//     kept and never counts; infinite and 1e9 sentinel lanes fall out of
//     the test with no special value. With r2 infinite or NaN the wrapper
//     passes m = +inf and nothing is dropped.
//  3. The surviving lanes go to shared memory as one float4 each (x, y,
//     z), read with 16-byte loads from the three (R, M) planes where a row
//     allows it.
//  4. Register blocking. The block takes the used slots 8 at a time (the
//     tail 4 at a time), their queries in registers, and every thread
//     walks a strided share of the surviving lanes: one LDS.128 serves 8
//     slots, and every warp has work however few slots a row has. A hit
//     is one FSET mask added to a per-slot integer; warp sums
//     (__reduce_add_sync) and shared-memory integer atomics add them up,
//     and integer sums have no order, so the counts are exact.
// The distance is formed with round-to-nearest intrinsics in the plain
// version's order (and the build passes --fmad=false), so a candidate at
// d2 == r2 counts exactly as it does there, and the counts agree bit for
// bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 2;  // candidate loads a thread has in flight, per plane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return fabsf(x) < inf() && fabsf(y) < inf() && fabsf(z) < inf();  // false for NaN too
}

struct Box {
  float lx, ly, lz, hx, hy, hz, m;
  // true when the lane may lie within the radius of a used query
  __device__ __forceinline__ bool keeps(float x, float y, float z) const {
    return !(__fsub_rn(x, hx) > m || __fsub_rn(lx, x) > m || __fsub_rn(y, hy) > m ||
             __fsub_rn(ly, y) > m || __fsub_rn(z, hz) > m || __fsub_rn(lz, z) > m);
  }
};

// Append the lanes of this thread with `keep` set to the shared list;
// the order of the list does not matter.
__device__ __forceinline__ void append_lane(float4* cand_s, int* n_lanes, bool keep, float x,
                                            float y, float z) {
  const unsigned b = __ballot_sync(kFull, keep);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && b != 0u) base = atomicAdd(n_lanes, __popc(b));
  base = __shfl_sync(kFull, base, 0);
  if (keep) cand_s[base + __popc(b & ((1u << lane) - 1u))] = make_float4(x, y, z, 0.0f);
}

// 0xffffffff where a <= b, else 0 (NaN compares false): one FSET.
__device__ __forceinline__ unsigned le_mask(float a, float b) {
  unsigned m;
  asm("set.le.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(a), "f"(b));
  return m;
}

// count_s[j0 + s] += the lanes within r2 of used query j0 + s, for the S
// slots from j0 (a slot past nU is a NaN query and counts nothing). Every
// thread of the block takes lanes tid, tid + kThreads, ...
template <int S>
__device__ __forceinline__ void count_group(const float4* cand_s, int nL, const float4* q_s,
                                            int* count_s, int j0, int nU, float r2) {
  const float nan = __int_as_float(0x7fc00000);
  float qx[S], qy[S], qz[S];
  unsigned neg[S];  // minus the hits
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float4 qq = j0 + s < nU ? q_s[j0 + s] : make_float4(nan, nan, nan, 0.0f);
    qx[s] = qq.x, qy[s] = qq.y, qz[s] = qq.z;
    neg[s] = 0u;
  }
#pragma unroll 2
  for (int l = threadIdx.x; l < nL; l += kThreads) {
    const float4 c = cand_s[l];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float dx = __fsub_rn(c.x, qx[s]);
      const float dy = __fsub_rn(c.y, qy[s]);
      const float dz = __fsub_rn(c.z, qz[s]);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      neg[s] += le_mask(d2, r2);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int total = -static_cast<int>(__reduce_add_sync(kFull, neg[s]));
    if ((threadIdx.x & 31) == 0 && j0 + s < nU && total != 0) atomicAdd(&count_s[j0 + s], total);
  }
}

__global__ void __launch_bounds__(kThreads) radius_count_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
    const float* __restrict__ q, const int32_t* __restrict__ used, int M, int P, float r2,
    float margin, float* __restrict__ out, unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  extern __shared__ float4 cand_s[];  // [M] surviving lanes, then [P] queries
  float4* q_s = cand_s + M;
  int* slot_s = reinterpret_cast<int*>(q_s + P);  // [P] slot of each used query
  int* used_s = slot_s + P;                       // [P] its used flag
  int* count_s = used_s + P;                      // [P] its count
  __shared__ int n_used, n_lanes;
  __shared__ float box_s[kWarps][6];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int32_t* urow = used + (long)row * P;
  const float* qrow = q + (long)row * 3 * P;
  float* orow = out + (long)row * P;
  if (tid == 0) {
    n_used = 0;
    n_lanes = 0;
  }
  __syncthreads();

  // 1. compact the used slots; bounds of their finite queries
  float lo[3] = {inf(), inf(), inf()};
  float hi[3] = {-inf(), -inf(), -inf()};
  for (int p0 = 0; p0 < P; p0 += kThreads) {
    const int p = p0 + tid;
    int u = 0;
    float x = 0.f, y = 0.f, z = 0.f;
    if (p < P) u = urow[p], x = qrow[3 * p], y = qrow[3 * p + 1], z = qrow[3 * p + 2];
    if (p < P && u == 0) orow[p] = 0.0f;  // count * 0 is exactly 0
    const unsigned b = __ballot_sync(kFull, u != 0);
    int base = 0;
    if (lane == 0 && b != 0u) base = atomicAdd(&n_used, __popc(b));
    base = __shfl_sync(kFull, base, 0);
    if (u != 0) {
      const int j = base + __popc(b & ((1u << lane) - 1u));
      q_s[j] = make_float4(x, y, z, 0.0f);
      slot_s[j] = p;
      used_s[j] = u;
      count_s[j] = 0;
      if (finite3(x, y, z)) {
        lo[0] = fminf(lo[0], x), lo[1] = fminf(lo[1], y), lo[2] = fminf(lo[2], z);
        hi[0] = fmaxf(hi[0], x), hi[1] = fmaxf(hi[1], y), hi[2] = fmaxf(hi[2], z);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int s = 16; s > 0; s >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], s));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], s));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) box_s[warp][a] = lo[a], box_s[warp][3 + a] = hi[a];
  }
  __syncthreads();
  const int nU = n_used;
  if (nU == 0) return;  // a dead row reads no candidate
  Box box{inf(), inf(), inf(), -inf(), -inf(), -inf(), margin};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    box.lx = fminf(box.lx, box_s[w][0]), box.ly = fminf(box.ly, box_s[w][1]);
    box.lz = fminf(box.lz, box_s[w][2]), box.hx = fmaxf(box.hx, box_s[w][3]);
    box.hy = fmaxf(box.hy, box_s[w][4]), box.hz = fmaxf(box.hz, box_s[w][5]);
  }

  // 2-3. the lanes that may count, as float4 in shared memory
  const long base = (long)row * M;
  const float* xr = cx + base;
  const float* yr = cy + base;
  const float* zr = cz + base;
  if ((M & 3) == 0 && aligned16(xr) && aligned16(yr) && aligned16(zr)) {
    // kBatch float4 of each plane a thread, all loads in flight at once
    const int n4 = M >> 2;
    for (int i0 = 0; i0 < n4; i0 += kBatch * kThreads) {
      float4 c4[kBatch][3];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * kThreads + tid;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        c4[k][0] = i < n4 ? reinterpret_cast<const float4*>(xr)[i] : zero;
        c4[k][1] = i < n4 ? reinterpret_cast<const float4*>(yr)[i] : zero;
        c4[k][2] = i < n4 ? reinterpret_cast<const float4*>(zr)[i] : zero;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = i0 + k * kThreads + tid < n4;
        const float4 x4 = c4[k][0], y4 = c4[k][1], z4 = c4[k][2];
        append_lane(cand_s, &n_lanes, ok && box.keeps(x4.x, y4.x, z4.x), x4.x, y4.x, z4.x);
        append_lane(cand_s, &n_lanes, ok && box.keeps(x4.y, y4.y, z4.y), x4.y, y4.y, z4.y);
        append_lane(cand_s, &n_lanes, ok && box.keeps(x4.z, y4.z, z4.z), x4.z, y4.z, z4.z);
        append_lane(cand_s, &n_lanes, ok && box.keeps(x4.w, y4.w, z4.w), x4.w, y4.w, z4.w);
      }
    }
  } else {
    for (int m0 = 0; m0 < M; m0 += kBatch * kThreads) {
      float c[kBatch][3];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int m = m0 + k * kThreads + tid;
        c[k][0] = m < M ? xr[m] : 0.f;
        c[k][1] = m < M ? yr[m] : 0.f;
        c[k][2] = m < M ? zr[m] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = m0 + k * kThreads + tid < M;
        append_lane(cand_s, &n_lanes, ok && box.keeps(c[k][0], c[k][1], c[k][2]), c[k][0], c[k][1],
                    c[k][2]);
      }
    }
  }
  __syncthreads();
  const int nL = n_lanes;

  // 4. the used slots in groups of 8 (a tail in groups of 4), each group
  // against every surviving lane, the lanes strided over the block
  int j = 0;
  for (; j + 8 <= nU; j += 8) count_group<8>(cand_s, nL, q_s, count_s, j, nU, r2);
  for (; j < nU; j += 4) count_group<4>(cand_s, nL, q_s, count_s, j, nU, r2);
  __syncthreads();
  for (int i = tid; i < nU; i += kThreads) {
    orow[slot_s[i]] = __fmul_rn(static_cast<float>(count_s[i]), static_cast<float>(used_s[i]));
  }
}

}  // namespace

extern "C" int sage_radius_count(const void* cx, const void* cy, const void* cz,
                                 const void* q, const void* used, int R, int M, int P,
                                 float r2, float margin, void* out, void* launches,
                                 void* stream) {
  if (R > 0 && P > 0) {
    // the surviving lanes and the used queries (ops/nn_kernels.py radius_count_smem)
    const size_t smem = (size_t)(M + P) * sizeof(float4) + 3 * (size_t)P * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          radius_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    radius_count_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)cx, (const float*)cy, (const float*)cz, (const float*)q,
        (const int32_t*)used, M, P, r2, margin, (float*)out, (unsigned long long*)launches);
  }
  return (int)cudaGetLastError();
}
