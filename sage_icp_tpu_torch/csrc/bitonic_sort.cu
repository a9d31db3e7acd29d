// Bitonic sort over key/payload planes of 32-bit words: the first
// num_keys planes are int32 or uint32 keys (a flag per key) compared
// lexicographically, the rest move with them as payload.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_sort.py::
// bitonic_sort_planes (_kernel). The TPU kernel runs the whole network in
// one call with every plane resident in VMEM, exchanging partners with
// lane and sublane rolls. Here the same (k, j) stage schedule
// (_stage_table), with the same pairs and the same per-side take rule, is
// run on a compact state: each position carries its keys (made
// order-preserving as uint32: a signed key has its sign bit flipped) and
// the index of the input element it holds now (its source). Every plane
// moves with the same take decisions, so after the network output plane
// q at i is input plane q at source[i], a gather the last launch does;
// the inputs are not written, and payload planes cost one read and one
// write whatever the network's depth.
//
// Layout: a thread holds 2^RB positions whose indices differ in RB
// consecutive bits (the register bits); the stages whose j is one of
// those bits are compare-exchanges between registers. To reach other bits
// the state goes through shared memory (tile launches, RB 3) or device
// memory (global passes, RB 4 up to four keys, else 3) and comes back with
// other register bits:
// - one tile launch sorts every tile of T = 8 x threads positions through
//   all the stages with k <= T, three stages per shared-memory round trip
//   (device memory is read and written with consecutive threads on
//   consecutive positions);
// - for each k > T, the stages with j >= T go in global passes of up to
//   RB stages each (a thread loads its positions, runs the stages in
//   registers and stores them back), then one tile launch runs that k's
//   stages with j < T. The last one writes the output planes: the keys
//   from its registers, the payload planes gathered through the sources.
// A call makes 1 + sum over k > T of (ceil(log2(k / T) / RB) + 1)
// launches (sage_bitonic_launches): 18 at N 2^18 with three keys and the
// tile T 2^11, against the 171 of one launch per stage. The tile is the
// largest up to 2^11 that leaves 64 tiles: 2^11 at N 2^18 (128 blocks for
// 132 SMs) and 2^10 at N 2^16, the fastest of 2^10, 2^11 and 2^12 at both
// N on an H100 (PERF.md); a larger tile leaves SMs idle in the tile
// launches.
//
// What bounds it on an H100: latency, not the compulsory bytes (each plane
// read and written once: 8 MB at N 2^18 and four planes, ~2.5 us at 3.35
// TB/s). At N 2^18 a thread per 8 positions is 32K threads, 8 warps an SM,
// too few to hide the dependent compare-exchange chains; each of the 10
// global passes moves (num_keys + 1) x 4 B per position through the 50 MB
// L2 twice, and each launch adds a gap of a few microseconds.
//
// Ties: each side of a pair decides on its own, as the TPU network does:
// the position that should keep the minimum takes its partner iff the
// partner is strictly less; the other takes its partner iff the partner
// is not strictly greater. With equal composite keys both positions end
// up with the same source, so the output equals the TPU kernel's bit for
// bit. Callers therefore make every composite key distinct (an iota plane
// as the last key); under that contract the network yields the
// stable-sort permutation.
//
// The plane pointers reach the kernels by value in a parameter struct, so
// a call needs no device-side pointer table and no host-to-device copy.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kTileBits = 3;  // register bits of a tile launch's thread
constexpr int kGlobalThreads = 256;
constexpr int kMinTile = 256;
constexpr int kDefaultTile = 2048;
constexpr int kMinBlocks = 64;  // the default tile leaves at least this many tiles

struct Args {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  uint32_t* state;  // [num_keys + 1][n]: keys as uint32 order, then the source
  int n, n_planes, num_keys;
  unsigned flip[kMaxPlanes];  // 0x80000000 for a signed key, else 0
  unsigned long long* launches;  // the call's launch counter: the first launch counts
};

// Register bits of a global pass's thread for nk keys: four stages a
// pass while the state of 16 positions fits the registers.
__host__ __device__ constexpr int global_bits(int nk) { return nk <= 4 ? 4 : 3; }

// Index of register slot m of thread t when the RB register bits are
// {r - RB + 1, ..., r}: t's bits fill the other positions in order.
template <int RB>
__device__ __forceinline__ int slot_index(int t, int m, int r) {
  const int lo = r - (RB - 1);
  return ((t >> lo) << (r + 1)) | (m << lo) | (t & ((1 << lo) - 1));
}

// Shared-memory word of position i: one pad word every 32 keeps a warp's
// strided accesses on distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <int NK, int RB>
struct Regs {
  static constexpr int kSlots = 1 << RB;
  uint32_t key[kSlots][NK];  // keys past num_keys stay 0 and compare equal
  uint32_t src[kSlots];
};

// Stage j = 2^(lo + POS) on the thread's registers, lo = r - RB + 1. Slot
// m's position is tb | (m << lo), so it keeps the minimum of its pair (bit
// k of its position is 0) iff tb_up (bit k of tb is 0) and m & mk is 0,
// mk = k >> lo.
template <int NK, int RB, int POS>
__device__ __forceinline__ void reg_stage(Regs<NK, RB>& s, bool tb_up, int mk) {
#pragma unroll
  for (int m = 0; m < Regs<NK, RB>::kSlots; ++m) {
    if (m & (1 << POS)) continue;
    const int b = m + (1 << POS);
    // lexicographic, the most significant differing key decides
    bool a_lt_b = false, b_lt_a = false;
#pragma unroll
    for (int w = NK - 1; w >= 0; --w) {
      const uint32_t x = s.key[m][w], y = s.key[b][w];
      a_lt_b = x < y || (x == y && a_lt_b);
      b_lt_a = y < x || (x == y && b_lt_a);
    }
    const bool ascending = tb_up && (m & mk) == 0;  // position m keeps the minimum
    const bool take_a = ascending ? b_lt_a : !b_lt_a;
    const bool take_b = ascending ? !a_lt_b : a_lt_b;
#pragma unroll
    for (int w = 0; w < NK; ++w) {
      const uint32_t x = s.key[m][w], y = s.key[b][w];
      s.key[m][w] = take_a ? y : x;
      s.key[b][w] = take_b ? x : y;
    }
    const uint32_t x = s.src[m], y = s.src[b];
    s.src[m] = take_a ? y : x;
    s.src[b] = take_b ? x : y;
  }
}

// reg_stage<NK, RB, pos> for a run-time pos < RB.
template <int NK, int RB, int POS>
__device__ __forceinline__ void reg_stage_at(Regs<NK, RB>& s, int pos, bool tb_up, int mk) {
  if (pos == POS) {
    reg_stage<NK, RB, POS>(s, tb_up, mk);
  } else if constexpr (POS > 0) {
    reg_stage_at<NK, RB, POS - 1>(s, pos, tb_up, mk);
  }
}

// The stages with j = 2^b for b = top .. bottom (top - bottom < RB) of
// merge k, on the register bits that end at r; tb: the position of the
// thread's slot 0.
template <int NK, int RB>
__device__ __forceinline__ void reg_stages(Regs<NK, RB>& s, int k, int r, int top, int bottom,
                                           int tb) {
  const int lo = r - (RB - 1);
  const bool tb_up = (tb & k) == 0;
  const int mk = k >> lo;
  for (int b = top; b >= bottom; --b) reg_stage_at<NK, RB, RB - 1>(s, b - lo, tb_up, mk);
}

template <int NK, int RB>
__device__ __forceinline__ void load_state(Regs<NK, RB>& s, const Args& a, bool from_input, int i,
                                           int m) {
#pragma unroll
  for (int w = 0; w < NK; ++w) {
    s.key[m][w] = 0;
    if (w < a.num_keys) {
      s.key[m][w] = from_input ? a.in[w][i] ^ a.flip[w] : a.state[(long)w * a.n + i];
    }
  }
  s.src[m] = from_input ? (uint32_t)i : a.state[(long)a.num_keys * a.n + i];
}

template <int NK, int RB>
__device__ __forceinline__ void store_state(const Regs<NK, RB>& s, const Args& a, int i, int m) {
#pragma unroll
  for (int w = 0; w < NK; ++w) {
    if (w < a.num_keys) a.state[(long)w * a.n + i] = s.key[m][w];
  }
  a.state[(long)a.num_keys * a.n + i] = s.src[m];
}

// The top register bit for the group of stages that starts at bit `top`.
__device__ __forceinline__ int reg_top(int top) {
  return top < kTileBits - 1 ? kTileBits - 1 : top;
}

// Moves the thread's positions to the register bits that end at r_to,
// through shared memory (the whole block takes part).
template <int NK>
__device__ __forceinline__ void relayout(Regs<NK, kTileBits>& s, uint32_t* sh, int stride,
                                         int num_keys, int t, int r_from, int r_to) {
  __syncthreads();  // the previous round trip's reads are done
#pragma unroll
  for (int m = 0; m < (1 << kTileBits); ++m) {
    const int i = padded(slot_index<kTileBits>(t, m, r_from));
#pragma unroll
    for (int w = 0; w < NK; ++w) {
      if (w < num_keys) sh[w * stride + i] = s.key[m][w];
    }
    sh[num_keys * stride + i] = s.src[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < (1 << kTileBits); ++m) {
    const int i = padded(slot_index<kTileBits>(t, m, r_to));
#pragma unroll
    for (int w = 0; w < NK; ++w) {
      if (w < num_keys) s.key[m][w] = sh[w * stride + i];
    }
    s.src[m] = sh[num_keys * stride + i];
  }
}

// Block b: tile [b T, (b + 1) T) through the stages (k, j) for k = k_first
// .. k_last (doubling), j = min(k, T) / 2 .. 1. The first launch reads the
// input planes (k_first 2), the last one writes the output planes. Device
// memory is read and written with the top register bits (consecutive
// threads on consecutive positions); the stages with small j take other
// register bits through shared memory.
template <int NK>
__global__ void __launch_bounds__(NK <= 4 ? 512 : 256)  // max_threads
    bitonic_tile_kernel(const __grid_constant__ Args a, int tile_log2, int k_first, int k_last,
                        int first, int last) {
  if (first) sage::count_launch(a.launches);
  extern __shared__ uint32_t sh[];  // [num_keys + 1][padded(T)]
  const int t = threadIdx.x;
  const int base = blockIdx.x << tile_log2;
  const int stride = padded(1 << tile_log2);
  constexpr int kSlots = 1 << kTileBits;
  const int r_io = tile_log2 - 1;  // coalesced
  Regs<NK, kTileBits> s;
  int r = r_io;
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    load_state(s, a, first, base + slot_index<kTileBits>(t, m, r), m);
  }
  for (int k = k_first; k <= k_last; k <<= 1) {
    const int kb = 31 - __clz(k);
    for (int top = (kb < tile_log2 ? kb : tile_log2) - 1; top >= 0; top -= kTileBits) {
      const int want = reg_top(top);
      if (want != r) {
        relayout<NK>(s, sh, stride, a.num_keys, t, r, want);
        r = want;
      }
      const int bottom = top - (kTileBits - 1) > 0 ? top - (kTileBits - 1) : 0;
      reg_stages(s, k, r, top, bottom, base + slot_index<kTileBits>(t, 0, r));
    }
  }
  if (r != r_io) {
    relayout<NK>(s, sh, stride, a.num_keys, t, r, r_io);
    r = r_io;
  }
  if (!last) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) store_state(s, a, base + slot_index<kTileBits>(t, m, r), m);
    return;
  }
  // the output planes: plane q at i is input plane q at source[i]; the
  // keys are in the registers already
#pragma unroll
  for (int w = 0; w < NK; ++w) {
    if (w < a.num_keys) {
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        a.out[w][base + slot_index<kTileBits>(t, m, r)] = s.key[m][w] ^ a.flip[w];
      }
    }
  }
  for (int q = a.num_keys; q < a.n_planes; ++q) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      a.out[q][base + slot_index<kTileBits>(t, m, r)] = a.in[q][s.src[m]];
    }
  }
}

// One global pass of merge k: the stages with j = 2^b for b = top ..
// bottom (top - bottom < RB, bottom >= log2 T) over the whole array, each
// thread on the 2^RB positions whose register bits end at top.
template <int NK>
__global__ void __launch_bounds__(kGlobalThreads)
    bitonic_global_kernel(const __grid_constant__ Args a, int k, int top, int bottom) {
  constexpr int RB = global_bits(NK);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n >> RB) return;
  Regs<NK, RB> s;
#pragma unroll
  for (int m = 0; m < (1 << RB); ++m) load_state(s, a, false, slot_index<RB>(t, m, top), m);
  reg_stages(s, k, top, top, bottom, slot_index<RB>(t, 0, top));
#pragma unroll
  for (int m = 0; m < (1 << RB); ++m) store_state(s, a, slot_index<RB>(t, m, top), m);
}

// The key-count instance: NK >= num_keys.
int instance(int num_keys) {
  return num_keys <= 1 ? 1 : num_keys <= 2 ? 2 : num_keys <= 3 ? 3 : num_keys <= 4 ? 4
       : num_keys <= 8 ? 8 : 16;
}

int log2i(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

size_t smem_bytes(int num_keys, int tile) {
  return (size_t)(num_keys + 1) * (tile + tile / 32) * sizeof(uint32_t);
}

// Threads a tile block may have: the register state of 8 positions grows
// with the instance's key count.
int max_threads(int num_keys) { return instance(num_keys) <= 4 ? 512 : 256; }

// The tile of a call: the largest power of two up to kDefaultTile that the
// instance's threads and shared memory allow and that leaves kMinBlocks
// tiles, or kMinTile; never above n. 0 if the call is refused (n not a
// power of two >= kMinTile, or a key count outside [1, kMaxPlanes]).
int tile_for(int n, int num_keys) {
  if (n < kMinTile || (n & (n - 1)) != 0 || num_keys < 1 || num_keys > kMaxPlanes) return 0;
  const int most = (1 << kTileBits) * max_threads(num_keys);
  int tile = kDefaultTile < most ? kDefaultTile : most;
  while (tile > kMinTile && (smem_bytes(num_keys, tile) > 232448 || n / tile < kMinBlocks)) tile /= 2;
  return tile < n ? tile : n;
}

int launches_for(int n, int num_keys, int tile) {
  const int rb = global_bits(instance(num_keys));
  int count = 1;
  for (int k = 2 * tile; k <= n; k <<= 1) count += (log2i(k / tile) + rb - 1) / rb + 1;
  return count;
}

template <int NK>
cudaError_t run(const Args& a, int tile, cudaStream_t stream) {
  const int tile_log2 = log2i(tile);
  const size_t smem = smem_bytes(a.num_keys, tile);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bitonic_tile_kernel<NK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n = a.n;
  constexpr int RB = global_bits(NK);
  const int tiles = n / tile, threads = tile >> kTileBits;
  bitonic_tile_kernel<NK><<<tiles, threads, smem, stream>>>(a, tile_log2, 2, tile, 1, n == tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int gblocks = ((n >> RB) + kGlobalThreads - 1) / kGlobalThreads;
  for (int k = 2 * tile; k <= n; k <<= 1) {
    for (int top = log2i(k) - 1; top >= tile_log2; top -= RB) {
      const int bottom = top - (RB - 1) > tile_log2 ? top - (RB - 1) : tile_log2;
      bitonic_global_kernel<NK><<<gblocks, kGlobalThreads, 0, stream>>>(a, k, top, bottom);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bitonic_tile_kernel<NK><<<tiles, threads, smem, stream>>>(a, tile_log2, k, k, 0, k == n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Launches one call on n positions with num_keys keys makes, or 0 if the
// call is refused.
extern "C" int sage_bitonic_launches(int n, int num_keys) {
  const int t = tile_for(n, num_keys);
  return t == 0 ? 0 : launches_for(n, num_keys, t);
}

// Sorts n positions of n_planes planes. in: n_planes device pointers (read
// only); out: n_planes device pointers (written); state: (num_keys + 1) x n
// 32-bit words of scratch; key_unsigned: num_keys flags (non-zero =
// compare that key as uint32); launches: the call's launch counter
// (launch_count.cuh), one a call.
extern "C" int sage_bitonic_sort(void* const* in, void* const* out, void* state,
                                 const int* key_unsigned, int n_planes, int num_keys, int n,
                                 void* launches, void* stream) {
  const int tile = tile_for(n, num_keys);
  if (tile == 0 || n_planes < num_keys || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int q = 0; q < n_planes; ++q) {
    a.in[q] = (const uint32_t*)in[q];
    a.out[q] = (uint32_t*)out[q];
  }
  a.state = (uint32_t*)state;
  a.launches = (unsigned long long*)launches;
  a.n = n;
  a.n_planes = n_planes;
  a.num_keys = num_keys;
  for (int w = 0; w < num_keys; ++w) a.flip[w] = key_unsigned[w] ? 0u : 0x80000000u;
  cudaStream_t s = (cudaStream_t)stream;
  switch (instance(num_keys)) {
    case 1: return (int)run<1>(a, tile, s);
    case 2: return (int)run<2>(a, tile, s);
    case 3: return (int)run<3>(a, tile, s);
    case 4: return (int)run<4>(a, tile, s);
    case 8: return (int)run<8>(a, tile, s);
    default: return (int)run<16>(a, tile, s);
  }
}
