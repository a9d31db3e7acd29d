// Shared semantic nearest-neighbour selection over one correspondence row.
//
// A row holds M = 27 * K candidate lanes (the 27 neighbour blocks of the
// row's voxel, K points each) as int16 voxel-local planes cx/cy/cz, an
// int16 label plane cl (-1 = invalid lane) and per-lane neighbour offsets
// in metres. For each of the row's P query slots the selection takes the
// FIRST lane that minimises the sem_th-weighted squared distance
// (weighted where the labels match or either is 0; invalid lanes weigh
// FLT_MAX and never win against a valid one), as jnp.argmin does.
//
// One warp owns one row: lane j visits candidates j, j + 32, ... keeping
// the first minimum it sees for every slot, then a butterfly shuffle
// reduction takes the smallest (metric, index) pair, so equal metrics go
// to the lower candidate index. Every lane ends with the same winners.
//
// All arithmetic is written with round-to-nearest intrinsics and the
// sources compile with --fmad=false: the distances round exactly as in
// the plain PyTorch version, which keeps near-ties on the same winner.

#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace sage {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kBigD2 = 1.0e12f;  // true d2 reported for an invalid winner

__device__ __forceinline__ float dequant(int16_t q, float scale, float off) {
  return __fadd_rn(__fmul_rn((float)q, scale), off);
}

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Row-local candidate `m`: coordinates, label as float, validity.
struct Cand {
  float x, y, z, l;
  bool invalid;
};

__device__ __forceinline__ Cand load_cand(
    const int16_t* __restrict__ cx, const int16_t* __restrict__ cy,
    const int16_t* __restrict__ cz, const int16_t* __restrict__ cl,
    const float* __restrict__ offx, const float* __restrict__ offy,
    const float* __restrict__ offz, int m, float scale) {
  Cand c;
  c.x = dequant(cx[m], scale, offx[m]);
  c.y = dequant(cy[m], scale, offy[m]);
  c.z = dequant(cz[m], scale, offz[m]);
  c.l = (float)cl[m];
  c.invalid = c.l < 0.f;
  return c;
}

// Winners of one row (pointers already offset to the row). q*: row-local
// queries of the P slots. Call with the whole warp.
template <int P>
__device__ __forceinline__ void select_row(
    const int16_t* __restrict__ cx, const int16_t* __restrict__ cy,
    const int16_t* __restrict__ cz, const int16_t* __restrict__ cl,
    const float* __restrict__ offx, const float* __restrict__ offy,
    const float* __restrict__ offz, int M, const float (&qx)[P],
    const float (&qy)[P], const float (&qz)[P], const float (&ql)[P],
    float sem_th, float scale, int (&best)[P]) {
  const int lane = threadIdx.x & 31;
  float bv[P];
  int bi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bv[p] = __int_as_float(0x7f800000);  // +inf: a lane with no candidate
    bi[p] = INT_MAX;                     // loses every comparison
  }
  for (int m = lane; m < M; m += 32) {
    const Cand c = load_cand(cx, cy, cz, cl, offx, offy, offz, m, scale);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float d2 = sq3(__fsub_rn(c.x, qx[p]), __fsub_rn(c.y, qy[p]),
                           __fsub_rn(c.z, qz[p]));
      const bool sem = (c.l == ql[p]) || (__fmul_rn(c.l, ql[p]) == 0.f);
      float d2w = sem ? __fmul_rn(d2, sem_th) : d2;
      if (c.invalid) d2w = FLT_MAX;
      // lanes visit candidates in increasing order: keep the first minimum
      if (bi[p] == INT_MAX || d2w < bv[p]) {
        bv[p] = d2w;
        bi[p] = m;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv[p], off);
      const int oi = __shfl_xor_sync(kFullMask, bi[p], off);
      if (ov < bv[p] || (ov == bv[p] && oi < bi[p])) {
        bv[p] = ov;
        bi[p] = oi;
      }
    }
    best[p] = bi[p];
  }
}

}  // namespace sage
