// Fused semantic nearest-neighbour selection over frozen correspondence
// rows: dequantize the int16 candidate planes, weight, take the first
// minimum, emit the winner's row-local xyz, label and unweighted d2.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_nn.py::fused_semantic_nn
// (_kernel).
//
// What bounds it on an H100: bytes. At the city preset (R 11,264 rows,
// M 1,080 lanes, P 2 slots) one call reads the four int16 candidate
// planes once, 4 x 11,264 x 1,080 x 2 B = 97 MB, ~29 us at 3.35 TB/s;
// the arithmetic is ~20 flops per lane and slot (~0.5 GFLOP, ~7 us at the
// 67 TFLOP/s float32 rate).
//
// Design: one warp per row (selection.cuh). Consecutive lanes read
// consecutive candidates, so each plane streams in 64-byte warp
// transactions; the queries and the offsets are per-row and per-lane
// broadcasts that stay in L1. Only the (R, P) results are written.

#include "launch_count.cuh"
#include "selection.cuh"

namespace {

template <int P>
__global__ void semantic_nn_kernel(
    const int16_t* __restrict__ cx, const int16_t* __restrict__ cy,
    const int16_t* __restrict__ cz, const int16_t* __restrict__ cl,
    const float* __restrict__ offx, const float* __restrict__ offy,
    const float* __restrict__ offz, const float* __restrict__ q, int R,
    int M, float sem_th, float scale, float* __restrict__ tx,
    float* __restrict__ ty, float* __restrict__ tz, float* __restrict__ tl,
    float* __restrict__ d2out, unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= R) return;  // warp-uniform
  const float* qr = q + (long)row * 4 * P;
  float qx[P], qy[P], qz[P], ql[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    qx[p] = qr[4 * p + 0];
    qy[p] = qr[4 * p + 1];
    qz[p] = qr[4 * p + 2];
    ql[p] = qr[4 * p + 3];
  }
  const long base = (long)row * M;
  int best[P];
  sage::select_row<P>(cx + base, cy + base, cz + base, cl + base, offx, offy,
                      offz, M, qx, qy, qz, ql, sem_th, scale, best);
  if ((threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const sage::Cand c = sage::load_cand(cx + base, cy + base, cz + base,
                                         cl + base, offx, offy, offz, best[p],
                                         scale);
    const float d2 = sage::sq3(__fsub_rn(c.x, qx[p]), __fsub_rn(c.y, qy[p]),
                               __fsub_rn(c.z, qz[p]));
    const long o = (long)row * P + p;
    tx[o] = c.x;
    ty[o] = c.y;
    tz[o] = c.z;
    tl[o] = c.l;
    d2out[o] = c.invalid ? sage::kBigD2 : d2;
  }
}

template <int P>
void launch(const void* cx, const void* cy, const void* cz, const void* cl,
            const void* offx, const void* offy, const void* offz,
            const void* q, int R, int M, float sem_th, float scale, void* tx,
            void* ty, void* tz, void* tl, void* d2, void* launches, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 rows per block
  const long threads = (long)R * 32;
  semantic_nn_kernel<P><<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(
      (const int16_t*)cx, (const int16_t*)cy, (const int16_t*)cz,
      (const int16_t*)cl, (const float*)offx, (const float*)offy,
      (const float*)offz, (const float*)q, R, M, sem_th, scale, (float*)tx,
      (float*)ty, (float*)tz, (float*)tl, (float*)d2,
      (unsigned long long*)launches);
}

}  // namespace

extern "C" int sage_semantic_nn(const void* cx, const void* cy,
                                const void* cz, const void* cl,
                                const void* offx, const void* offy,
                                const void* offz, const void* q, int R, int M,
                                int P, float sem_th, float scale, void* tx,
                                void* ty, void* tz, void* tl, void* d2,
                                void* launches, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 1: launch<1>(cx, cy, cz, cl, offx, offy, offz, q, R, M, sem_th, scale, tx, ty, tz, tl, d2, launches, s); break;
    case 2: launch<2>(cx, cy, cz, cl, offx, offy, offz, q, R, M, sem_th, scale, tx, ty, tz, tl, d2, launches, s); break;
    case 4: launch<4>(cx, cy, cz, cl, offx, offy, offz, q, R, M, sem_th, scale, tx, ty, tz, tl, d2, launches, s); break;
    case 8: launch<8>(cx, cy, cz, cl, offx, offy, offz, q, R, M, sem_th, scale, tx, ty, tz, tl, d2, launches, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
