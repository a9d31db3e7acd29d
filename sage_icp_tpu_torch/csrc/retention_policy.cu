// Voxel-block retention policy (VoxelBlock::AddPoint) over the touched
// rows of one frame's map insert.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_insert.py::apply_policy
// (_kernel, and _kernel_packed, whose lane packing only fills the TPU's
// 128-lane vectors and has no counterpart here).
//
// What bounds it on an H100: bytes. At the city preset (U 16,896 rows,
// K 40, R_max 48) it reads the 4 x (U, K) int16 block planes (5.4 MB),
// the counts and seglens, and the incoming ranks each row actually uses
// (at most 6.5 MB), and writes 5.4 MB of planes: ~17.5 MB, ~5 us at
// 3.35 TB/s. The work per row is a short serial replay of at most
// seglen <= 48 ranks, so there is little arithmetic.
//
// Design: one thread per voxel row. The thread copies its row to the
// outputs, keeps the row's live label-0 slots in a 64-bit mask (the
// first such slot is __ffsll of the mask) and its count in a register,
// and replays ranks r < seglen[row] in order, writing each accepted point
// straight into its output slot. A row's loop is bounded by its own
// seglen, not by its neighbours'. The result is integers only and
// matches the plain PyTorch version bit for bit. The row-per-thread
// access pattern is not coalesced (rows are 80 B apart); the L1/L2 cache
// absorbs it at these sizes, and a warp-per-row layout is the next step
// if the kernel shows up in a profile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClsShift = 12;
constexpr int kLabelMask = (1 << kClsShift) - 1;

__global__ void retention_policy_kernel(
    const int16_t* __restrict__ bx, const int16_t* __restrict__ by,
    const int16_t* __restrict__ bz, const int16_t* __restrict__ bl,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ seglen,
    const int16_t* __restrict__ ix, const int16_t* __restrict__ iy,
    const int16_t* __restrict__ iz, const int16_t* __restrict__ ie,
    int U, int K, int R, int basic,
    int16_t* __restrict__ ox, int16_t* __restrict__ oy,
    int16_t* __restrict__ oz, int16_t* __restrict__ ol,
    int32_t* __restrict__ ocnt) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  const long base = (long)u * K;
  int cnt = counts[u];
  unsigned long long zero_live = 0ull;
  for (int k = 0; k < K; ++k) {
    const int16_t lab = bl[base + k];
    ox[base + k] = bx[base + k];
    oy[base + k] = by[base + k];
    oz[base + k] = bz[base + k];
    ol[base + k] = lab;
    if (lab == 0 && k < cnt) zero_live |= 1ull << k;
  }
  const int seg = seglen[u];
  const long ibase = (long)u * R;
  for (int r = 0; r < seg; ++r) {
    const int enc = ie[ibase + r];
    const int cls = enc >> kClsShift;  // 0 label-0, 1 basic, 2 critical
    const int lab = enc & kLabelMask;
    const bool append_basic = cnt < basic;
    const bool has_zero = zero_live != 0ull;
    const bool do_append = append_basic || (cls == 2 && cnt < K);
    const bool do_over =
        !append_basic && (cls == 1 || (cls == 2 && cnt >= K)) && has_zero;
    if (do_append || do_over) {
      const int t = do_append ? cnt : __ffsll((long long)zero_live) - 1;
      ox[base + t] = ix[ibase + r];
      oy[base + t] = iy[ibase + r];
      oz[base + t] = iz[ibase + r];
      ol[base + t] = (int16_t)lab;
      if (lab == 0) {
        zero_live |= 1ull << t;
      } else {
        zero_live &= ~(1ull << t);
      }
    }
    cnt += do_append ? 1 : 0;
  }
  ocnt[u] = cnt;
}

}  // namespace

extern "C" int sage_retention_policy(
    const void* bx, const void* by, const void* bz, const void* bl,
    const void* counts, const void* seglen, const void* ix, const void* iy,
    const void* iz, const void* ie, int U, int K, int R, int basic,
    void* ox, void* oy, void* oz, void* ol, void* ocnt, void* stream) {
  if (U > 0) {
    constexpr int kThreads = 128;
    retention_policy_kernel<<<(U + kThreads - 1) / kThreads, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const int16_t*)bx, (const int16_t*)by, (const int16_t*)bz,
        (const int16_t*)bl, (const int32_t*)counts, (const int32_t*)seglen,
        (const int16_t*)ix, (const int16_t*)iy, (const int16_t*)iz,
        (const int16_t*)ie, U, K, R, basic, (int16_t*)ox, (int16_t*)oy,
        (int16_t*)oz, (int16_t*)ol, (int32_t*)ocnt);
  }
  return (int)cudaGetLastError();
}
