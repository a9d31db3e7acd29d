// Radius count for the dynamic-vehicle filter: per query slot, the number
// of candidate lanes of its row with (dx*dx + dy*dy) + dz*dz <= r2, times
// the slot's used flag.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_nn.py::radius_count
// (_count_kernel). Its lane_ok mask only hides the TPU's tile padding; the
// rows here are exactly M lanes wide, so it has no counterpart.
//
// What bounds it on an H100: operations. At the kitti filter's shapes
// (R 4,096 rows, M 864 lanes, P 48 slots) it reads 3 x R x M float32
// candidates once (42.5 MB, ~13 us at 3.35 TB/s) and does ~9 flops per
// lane and slot, 1.53 GFLOP (~23 us at the 67 TFLOP/s float32 rate).
// About half of the rows hold no used slot, so the work this data needs
// is less.
//
// Design: one block per row. The block first asks whether any slot of the
// row is used; a dead row writes zeros and reads no candidate. A live row
// stages its three candidate planes in shared memory (3 x M floats,
// 10 KB at M 864), then each warp takes slots w, w + 8, ...: the lanes
// stride over M, and __ballot_sync/__popc adds up the hits of 32 lanes at
// a time in an integer. The distance is formed with round-to-nearest
// intrinsics in the plain version's order (and the build passes
// --fmad=false), so a candidate at d2 == r2 counts exactly as it does
// there, and the integer counts agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void radius_count_kernel(const float* __restrict__ cx,
                                    const float* __restrict__ cy,
                                    const float* __restrict__ cz,
                                    const float* __restrict__ q,
                                    const int32_t* __restrict__ used, int M,
                                    int P, float r2, float* __restrict__ out) {
  extern __shared__ float cand[];  // [x: M][y: M][z: M]
  const int row = blockIdx.x;
  const int32_t* urow = used + (long)row * P;
  float* orow = out + (long)row * P;
  int live = 0;
  for (int p = threadIdx.x; p < P; p += kThreads) live |= urow[p] != 0;
  if (!__syncthreads_or(live)) {
    for (int p = threadIdx.x; p < P; p += kThreads) orow[p] = 0.0f;
    return;
  }
  const long base = (long)row * M;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    cand[m] = cx[base + m];
    cand[M + m] = cy[base + m];
    cand[2 * M + m] = cz[base + m];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qrow = q + (long)row * 3 * P;
  for (int p = warp; p < P; p += kWarps) {
    const int u = urow[p];
    if (u == 0) {  // count * 0 is exactly 0
      if (lane == 0) orow[p] = 0.0f;
      continue;
    }
    const float qx = qrow[3 * p + 0];
    const float qy = qrow[3 * p + 1];
    const float qz = qrow[3 * p + 2];
    int count = 0;
    for (int b = 0; b < M; b += 32) {
      const int m = b + lane;
      bool hit = false;
      if (m < M) {
        const float dx = __fsub_rn(cand[m], qx);
        const float dy = __fsub_rn(cand[M + m], qy);
        const float dz = __fsub_rn(cand[2 * M + m], qz);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        hit = d2 <= r2;
      }
      count += __popc(__ballot_sync(0xffffffffu, hit));
    }
    if (lane == 0) orow[p] = __fmul_rn((float)count, (float)u);
  }
}

}  // namespace

extern "C" int sage_radius_count(const void* cx, const void* cy, const void* cz,
                                 const void* q, const void* used, int R, int M,
                                 int P, float r2, void* out, void* stream) {
  if (R > 0 && P > 0) {
    const size_t smem = 3 * (size_t)M * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    radius_count_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)cx, (const float*)cy, (const float*)cz, (const float*)q,
        (const int32_t*)used, M, P, r2, (float*)out);
  }
  return (int)cudaGetLastError();
}
