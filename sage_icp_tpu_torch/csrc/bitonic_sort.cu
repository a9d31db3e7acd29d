// Bitonic sort over key/payload planes of 32-bit words: the first
// num_keys planes are int32 or uint32 keys (a flag per key) compared
// lexicographically, the rest move with them as payload.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_sort.py::
// bitonic_sort_planes (_kernel). The TPU kernel runs the whole network in
// one call with every plane resident in VMEM, exchanging partners with
// lane and sublane rolls; here the same (k, j) stage schedule
// (_stage_table) is one launch per stage, each thread owning one
// compare-exchange pair (i, i ^ j).
//
// What bounds it on an H100: bytes. The least work reads and writes each
// plane once (n_planes x N x 8 B: 4 MB at N 2^18 and four planes, ~1.3 us
// at 3.35 TB/s). This kernel passes over every plane once per stage,
// N log2 N (log2 N + 1) / 2 element visits (171 stages at N 2^18), so it
// runs far above that bound; keeping the j < tile stages of each k in
// shared memory is the first step to close the gap.
//
// Ties: each side of a pair decides on its own, as the TPU network does:
// the element that should keep the minimum takes its partner iff the
// partner is strictly less; the other takes its partner iff the partner
// is not strictly greater. With equal composite keys both slots end up
// with the same payload, exactly as on the TPU. Callers therefore make
// every composite key distinct (an iota plane as the last key); under
// that contract the network yields the stable-sort permutation.
//
// The plane pointers reach the kernel by value in a parameter struct (an
// array of at most kMaxPlanes device pointers, filled from the caller's
// host array), so a call needs no device-side pointer table and no
// host-to-device copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kThreads = 256;

struct Planes {
  uint32_t* p[kMaxPlanes];
};

__device__ __forceinline__ bool less(uint32_t a, uint32_t b, bool is_unsigned) {
  return is_unsigned ? a < b : (int32_t)a < (int32_t)b;
}

// __grid_constant__: the loops index the pointer array at run time; the
// struct stays in parameter memory instead of a per-thread stack copy
__global__ void bitonic_stage_kernel(const __grid_constant__ Planes planes,
                                     int n_planes, int num_keys,
                                     unsigned unsigned_mask, int half, int k,
                                     int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  // the pair's lower index: t with a 0 bit inserted at bit log2(j)
  const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  const int pi = i | j;
  bool p_lt_i = false, i_lt_p = false, eq = true;
  for (int kk = 0; kk < num_keys && eq; ++kk) {
    const uint32_t a = planes.p[kk][i];
    const uint32_t b = planes.p[kk][pi];
    const bool u = (unsigned_mask >> kk) & 1u;
    p_lt_i = less(b, a, u);
    i_lt_p = less(a, b, u);
    eq = a == b;
  }
  const bool ascending = (i & k) == 0;  // i keeps the minimum
  const bool take_i = ascending ? p_lt_i : !p_lt_i;
  const bool take_p = ascending ? !i_lt_p : i_lt_p;
  if (!take_i && !take_p) return;
  for (int q = 0; q < n_planes; ++q) {
    uint32_t* plane = planes.p[q];
    const uint32_t vi = plane[i];
    const uint32_t vp = plane[pi];
    if (take_i) plane[i] = vp;
    if (take_p) plane[pi] = vi;
  }
}

}  // namespace

// Sorts the n-element planes in place. ptrs: n_planes device pointers;
// key_unsigned: num_keys flags (non-zero = compare that key as uint32).
extern "C" int sage_bitonic_sort(void* const* ptrs, const int* key_unsigned,
                                 int n_planes, int num_keys, int n,
                                 void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || num_keys < 1 ||
      num_keys > n_planes || n < 2 || (n & (n - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Planes planes;
  for (int q = 0; q < kMaxPlanes; ++q) {
    planes.p[q] = q < n_planes ? (uint32_t*)ptrs[q] : nullptr;
  }
  unsigned mask = 0;
  for (int kk = 0; kk < num_keys; ++kk) {
    if (key_unsigned[kk]) mask |= 1u << kk;
  }
  const int half = n / 2;
  const int blocks = (half + kThreads - 1) / kThreads;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_stage_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          planes, n_planes, num_keys, mask, half, k, j);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
