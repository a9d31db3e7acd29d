// One fully fused Gauss-Newton iteration over frozen correspondence rows:
// transform the setup queries by the increment T, drop queries that left
// the row's one-voxel shell, select the semantic nearest neighbour,
// gate, weight (Geman-McClure) and reduce the 18 normal-equation sums.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_nn.py::fused_gn_iteration
// (_gn_kernel), including its tile_map rule: a tile of kTileRows rows that
// the map redirects (tile_map[t] != t) holds no used query, so its
// contribution is exactly zero and it is skipped.
//
// What bounds it on an H100: bytes. At the city preset (R 11,264 rows,
// M 1,080 lanes, P 2 slots) an iteration reads the four int16 candidate
// planes of the live tiles once, at most 97 MB, ~29 us at 3.35 TB/s; the
// selection does ~20 flops per lane and slot (~0.5 GFLOP, ~7 us at the
// 67 TFLOP/s float32 rate), and the output is 18 floats.
//
// Design: one warp per row (selection.cuh), 8 warps per block, 4
// consecutive rows per warp. Lane 0 of each warp keeps the warp's 18 sums
// in registers, visiting rows and slots in a fixed order; the block adds
// its warps' sums in warp order and writes one (18,) partial row; a second
// one-block kernel adds the partial rows in block order. No float atomics:
// the result is the same on every run.

#include "selection.cuh"

namespace {

constexpr int kNSums = 18;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <int P>
__global__ void gn_iteration_kernel(
    const int16_t* __restrict__ cx, const int16_t* __restrict__ cy,
    const int16_t* __restrict__ cz, const int16_t* __restrict__ cl,
    const float* __restrict__ offx, const float* __restrict__ offy,
    const float* __restrict__ offz, const float* __restrict__ q0,
    const float* __restrict__ origin, const int32_t* __restrict__ row_abs,
    const int32_t* __restrict__ used, const int32_t* __restrict__ tile_map,
    int tile_rows, const float* __restrict__ T, int R, int M, float sem_th,
    float scale, float vox, float max_corr, float kth,
    float* __restrict__ partials) {
  __shared__ float red[kWarps][kNSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float t[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) t[i] = T[i];
  const float max_corr2 = mul(max_corr, max_corr);
  const float k2 = mul(kth, kth);
  float acc[kNSums];
#pragma unroll
  for (int j = 0; j < kNSums; ++j) acc[j] = 0.f;

  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int row = row0 + k;
    if (row >= R) break;
    const int tile = row / tile_rows;
    if (tile_map[tile] != tile) continue;  // dead tile: exact zeros
    float sx[P], sy[P], sz[P], qx[P], qy[P], qz[P], ql[P];
    bool use[P];
    const float ox = origin[3 * row + 0];
    const float oy = origin[3 * row + 1];
    const float oz = origin[3 * row + 2];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* qr = q0 + (long)row * 4 * P + 4 * p;
      const float x0 = qr[0], y0 = qr[1], z0 = qr[2];
      ql[p] = qr[3];
      sx[p] = add(add(add(mul(t[0], x0), mul(t[1], y0)), mul(t[2], z0)), t[3]);
      sy[p] = add(add(add(mul(t[4], x0), mul(t[5], y0)), mul(t[6], z0)), t[7]);
      sz[p] = add(add(add(mul(t[8], x0), mul(t[9], y0)), mul(t[10], z0)), t[11]);
      // movers: the query may drift one voxel from its setup row
      const int vx = (int)truncf(__fdiv_rn(sx[p], vox)) - row_abs[3 * row + 0];
      const int vy = (int)truncf(__fdiv_rn(sy[p], vox)) - row_abs[3 * row + 1];
      const int vz = (int)truncf(__fdiv_rn(sz[p], vox)) - row_abs[3 * row + 2];
      use[p] = used[(long)row * P + p] != 0 && abs(vx) <= 1 && abs(vy) <= 1 &&
               abs(vz) <= 1;
      qx[p] = sub(sx[p], ox);
      qy[p] = sub(sy[p], oy);
      qz[p] = sub(sz[p], oz);
    }
    const long base = (long)row * M;
    int best[P];
    sage::select_row<P>(cx + base, cy + base, cz + base, cl + base, offx,
                        offy, offz, M, qx, qy, qz, ql, sem_th, scale, best);
    if (lane != 0) continue;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const sage::Cand c = sage::load_cand(cx + base, cy + base, cz + base,
                                           cl + base, offx, offy, offz,
                                           best[p], scale);
      const float rx = sub(qx[p], c.x);
      const float ry = sub(qy[p], c.y);
      const float rz = sub(qz[p], c.z);
      const float r2 = sage::sq3(rx, ry, rz);
      const bool accept = use[p] && !c.invalid && r2 < max_corr2;
      const float kr = add(kth, r2);
      const float w = accept ? __fdiv_rn(k2, mul(kr, kr)) : 0.f;
      // every slot of a live row adds its products, zero weights included
      const float wsx = mul(w, sx[p]), wsy = mul(w, sy[p]), wsz = mul(w, sz[p]);
      acc[0] = add(acc[0], w);
      acc[1] = add(acc[1], wsx);
      acc[2] = add(acc[2], wsy);
      acc[3] = add(acc[3], wsz);
      acc[4] = add(acc[4], mul(wsx, sx[p]));
      acc[5] = add(acc[5], mul(wsy, sy[p]));
      acc[6] = add(acc[6], mul(wsz, sz[p]));
      acc[7] = add(acc[7], mul(wsx, sy[p]));
      acc[8] = add(acc[8], mul(wsx, sz[p]));
      acc[9] = add(acc[9], mul(wsy, sz[p]));
      acc[10] = add(acc[10], mul(w, rx));
      acc[11] = add(acc[11], mul(w, ry));
      acc[12] = add(acc[12], mul(w, rz));
      acc[13] = add(acc[13], mul(w, sub(mul(sy[p], rz), mul(sz[p], ry))));
      acc[14] = add(acc[14], mul(w, sub(mul(sz[p], rx), mul(sx[p], rz))));
      acc[15] = add(acc[15], mul(w, sub(mul(sx[p], ry), mul(sy[p], rx))));
      acc[16] = add(acc[16], accept ? 1.f : 0.f);
      acc[17] = add(acc[17], use[p] ? 1.f : 0.f);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kNSums; ++j) red[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < kNSums) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s = add(s, red[w][threadIdx.x]);
    partials[(long)blockIdx.x * kNSums + threadIdx.x] = s;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int n_blocks, float* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= kNSums) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s = add(s, partials[(long)b * kNSums + j]);
  out[j] = s;
}

template <int P>
void launch(const void* cx, const void* cy, const void* cz, const void* cl,
            const void* offx, const void* offy, const void* offz,
            const void* q0, const void* origin, const void* row_abs,
            const void* used, const void* tile_map, int tile_rows,
            const void* T, int R, int M, float sem_th, float scale, float vox,
            float max_corr, float kth, void* partials, int n_blocks,
            cudaStream_t stream) {
  gn_iteration_kernel<P><<<n_blocks, kWarps * 32, 0, stream>>>(
      (const int16_t*)cx, (const int16_t*)cy, (const int16_t*)cz,
      (const int16_t*)cl, (const float*)offx, (const float*)offy,
      (const float*)offz, (const float*)q0, (const float*)origin,
      (const int32_t*)row_abs, (const int32_t*)used,
      (const int32_t*)tile_map, tile_rows, (const float*)T, R, M, sem_th,
      scale, vox, max_corr, kth, (float*)partials);
}

}  // namespace

// Rows handled by one block: the partials buffer holds
// ceil(R / sage_gn_rows_per_block()) rows of 18 floats.
extern "C" int sage_gn_rows_per_block() { return kRowsPerBlock; }

extern "C" int sage_gn_iteration(
    const void* cx, const void* cy, const void* cz, const void* cl,
    const void* offx, const void* offy, const void* offz, const void* q0,
    const void* origin, const void* row_abs, const void* used,
    const void* tile_map, int tile_rows, const void* T, int R, int M, int P,
    float sem_th, float scale, float vox, float max_corr, float kth,
    void* partials, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  if (n_blocks > 0) {
    switch (P) {
      case 1: launch<1>(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, tile_map, tile_rows, T, R, M, sem_th, scale, vox, max_corr, kth, partials, n_blocks, s); break;
      case 2: launch<2>(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, tile_map, tile_rows, T, R, M, sem_th, scale, vox, max_corr, kth, partials, n_blocks, s); break;
      case 4: launch<4>(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, tile_map, tile_rows, T, R, M, sem_th, scale, vox, max_corr, kth, partials, n_blocks, s); break;
      case 8: launch<8>(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, tile_map, tile_rows, T, R, M, sem_th, scale, vox, max_corr, kth, partials, n_blocks, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_partials_kernel<<<1, 32, 0, s>>>((const float*)partials, n_blocks,
                                       (float*)out);
  return (int)cudaGetLastError();
}
