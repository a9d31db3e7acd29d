// One fully fused Gauss-Newton iteration over frozen correspondence rows:
// transform the setup queries by the increment T, drop queries that left
// the row's one-voxel shell, select the semantic nearest neighbour,
// gate, weight (Geman-McClure) and reduce the 18 normal-equation sums.
//
// Replaces the TPU kernel sage_icp_tpu/ops/pallas_nn.py::fused_gn_iteration
// (_gn_kernel), including its tile_map rule: a tile of tile_rows rows that
// the map redirects (tile_map[t] != t) holds no used query, so its
// contribution is exactly zero and it is skipped before anything of it is
// loaded.
//
// What bounds it on an H100: bytes. At the city preset (R 11,264 rows,
// M 1,080 lanes, P 2 slots) an iteration reads the four int16 candidate
// planes of the live tiles once, ~79 MB for 9,000 live rows, ~24 us at
// 3.35 TB/s; the selection does ~26 flops per lane (~0.25 GFLOP, ~4 us at
// the 67 TFLOP/s float32 rate), and the output is 18 floats.
//
// Design, for bytes in flight:
// - One warp owns one row at a time. A lane reads W consecutive int16
//   candidates of each plane with one load: W = 8 (16 B) when the row's
//   byte stride 2M is a multiple of 16 (every preset with K = 40, M 1,080:
//   the main path), W = 4 (8 B) when it is a multiple of 8 (K = 20), else
//   W = 1 (2 B). The wrapper checks the planes' base alignment.
// - The next chunk's four loads are issued before the current chunk is
//   computed (register double buffering), and a row's first chunk before
//   its queries are read.
// - The 3 x M lane offsets are staged once per block in shared memory,
//   element-major inside each chunk, so a warp's offset reads hit 32
//   distinct banks.
// - int16 -> float goes through the exponent trick (exact for |q| < 2^23)
//   instead of the conversion unit, which issues at an eighth of the rate.
// - The grid is persistent and fixed by R alone: min(ceil(R / 8),
//   kMaxBlocks) blocks of 8 warps, each warp striding over rows in a
//   fixed order. kMaxBlocks = 528 is what an H100 holds resident at once
//   (4 blocks on each of 132 SMs: with <= 64 registers a thread, 32 warps
//   an SM at P = 2); on a card with fewer SMs the same grid runs in more
//   than one wave.
//
// Selection: lane j visits chunks j, j + 32, ... in increasing candidate
// order and keeps the FIRST minimum of its lanes; the butterfly reduction
// compares (value, index). The lexicographic (d2w, index) minimum does not
// depend on the visiting order, so the winner is select_row's
// (selection.cuh) and the plain version's.
//
// Reduction, one launch and deterministic: lane p accumulates slot p's
// terms over the warp's rows in row order; the warp adds its slots in slot
// order, the block its warps in warp order and writes one partial row;
// then it fences and takes a ticket. The block with the last ticket adds
// the partial rows in block order (per column: 32 lane-strided sums and a
// fixed butterfly), writes the (18,) output and resets the ticket counter
// for the next call. No float atomics, and the grid does not depend on the
// card: for given inputs the result is the same on every run and every
// card. The per-slot term arithmetic is the plain version's, with
// round-to-nearest intrinsics.
//
// Inputs that change from one iteration or frame to the next come from
// device memory, never as launch arguments, so that a captured CUDA
// graph replays them right and the ICP loop needs no host copy: the
// increment T (rows 0-2 of a row-major 4x4, staged once per block in
// shared memory), the correspondence gate max_corr and the robust kernel
// kth (both from the frame's sigma), and a status word. A status other
// than 0 means the ICP loop has stopped (converged, at its iteration
// cap, or waiting for a re-anchor): every block returns before it reads
// anything else, writes nothing and takes no ticket, so the counter
// stays at zero.

#include "launch_count.cuh"
#include "selection.cuh"

namespace {

constexpr int kNSums = 18;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 528;  // nn_kernels.GN_MAX_BLOCKS

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The low 16 bits of x as an int16, as float: 2^23 + (q + 2^15) has the
// biased value as its mantissa, and the subtraction is exact.
__device__ __forceinline__ float i16_lo(uint32_t x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((x ^ 0x8000u) & 0xFFFFu)), 8421376.0f);
}
__device__ __forceinline__ float i16_hi(uint32_t x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((x >> 16) ^ 0x8000u)), 8421376.0f);
}

// W consecutive int16 candidates of one plane, loaded with one instruction.
template <int W>
struct Chunk {
  uint32_t w[W / 2];
  __device__ __forceinline__ void load(const int16_t* __restrict__ p) {
    if constexpr (W == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return (e & 1) ? i16_hi(w[e >> 1]) : i16_lo(w[e >> 1]);
  }
};

template <>
struct Chunk<1> {
  uint32_t w;
  __device__ __forceinline__ void load(const int16_t* __restrict__ p) {
    w = (uint16_t)__ldg(p);
  }
  __device__ __forceinline__ float get(int) const { return i16_lo(w); }
};

template <int W>
__device__ __forceinline__ void load_chunk(Chunk<W> (&c)[4], const int16_t* __restrict__ cx,
                                           const int16_t* __restrict__ cy,
                                           const int16_t* __restrict__ cz,
                                           const int16_t* __restrict__ cl, int m) {
  c[0].load(cx + m);
  c[1].load(cy + m);
  c[2].load(cz + m);
  c[3].load(cl + m);
}

// The setup query of slot p of `row` moved by T: world (s*) and row-local
// (q*) coordinates, label, and whether the slot is used and stayed within
// one voxel of its setup row.
struct Query {
  float sx, sy, sz, qx, qy, qz, ql;
  bool use;
};

__device__ __forceinline__ Query transform_query(
    const float* t, const float* __restrict__ q0, const int32_t* __restrict__ row_abs,
    const int32_t* __restrict__ used, int row, int p, int P, float ox, float oy,
    float oz, float vox) {
  const float* qr = q0 + (long)row * 4 * P + 4 * p;
  const float x0 = __ldg(qr + 0), y0 = __ldg(qr + 1), z0 = __ldg(qr + 2);
  Query q;
  q.ql = __ldg(qr + 3);
  q.sx = add(add(add(mul(t[0], x0), mul(t[1], y0)), mul(t[2], z0)), t[3]);
  q.sy = add(add(add(mul(t[4], x0), mul(t[5], y0)), mul(t[6], z0)), t[7]);
  q.sz = add(add(add(mul(t[8], x0), mul(t[9], y0)), mul(t[10], z0)), t[11]);
  // movers: the query may drift one voxel from its setup row
  const int vx = (int)truncf(__fdiv_rn(q.sx, vox)) - __ldg(row_abs + 3 * row + 0);
  const int vy = (int)truncf(__fdiv_rn(q.sy, vox)) - __ldg(row_abs + 3 * row + 1);
  const int vz = (int)truncf(__fdiv_rn(q.sz, vox)) - __ldg(row_abs + 3 * row + 2);
  q.use = __ldg(used + (long)row * P + p) != 0 && abs(vx) <= 1 && abs(vy) <= 1 &&
          abs(vz) <= 1;
  q.qx = sub(q.sx, ox);
  q.qy = sub(q.sy, oy);
  q.qz = sub(q.sz, oz);
  return q;
}

// 4 resident blocks (32 warps, <= 64 registers a thread) at P <= 2
template <int P, int W>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 4 : 2) gn_iteration_kernel(
    const int16_t* __restrict__ cx, const int16_t* __restrict__ cy,
    const int16_t* __restrict__ cz, const int16_t* __restrict__ cl,
    const float* __restrict__ offx, const float* __restrict__ offy,
    const float* __restrict__ offz, const float* __restrict__ q0,
    const float* __restrict__ origin, const int32_t* __restrict__ row_abs,
    const int32_t* __restrict__ used, const int32_t* __restrict__ tile_map,
    int tile_rows, const float* __restrict__ T, int R, int M, float sem_th, float scale,
    float vox, const float* __restrict__ max_corr_p, const float* __restrict__ kth_p,
    const int32_t* __restrict__ status, float* __restrict__ partials,
    int* __restrict__ counter, float* __restrict__ out,
    unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  if (__ldg(status) != 0) return;  // the loop has stopped: a no-op launch
  // lane offsets, [axis][e][v] for candidate m = v * W + e
  extern __shared__ float s_off[];
  // lane p of a warp adds slot p's terms to its own row here
  __shared__ float s_acc[kWarps][P][kNSums];
  // T (rows 0-2), then the gate and the kernel's terms: staged once, read
  // from shared memory where they are used (no registers held over the
  // candidate loop)
  __shared__ float s_T[12];
  __shared__ float s_gate[3];  // max_corr^2, kth, kth^2
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nv = M / W;  // chunks per row
  if (threadIdx.x < 12) s_T[threadIdx.x] = __ldg(T + threadIdx.x);
  if (threadIdx.x == 32) {
    const float max_corr = __ldg(max_corr_p), kth = __ldg(kth_p);
    s_gate[0] = mul(max_corr, max_corr);
    s_gate[1] = kth;
    s_gate[2] = mul(kth, kth);
  }
  for (int i = threadIdx.x; i < kWarps * P * kNSums; i += kThreads) (&s_acc[0][0][0])[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * M; i += kThreads) {
    const int axis = i / M, m = i - axis * M;
    const float* src = axis == 0 ? offx : axis == 1 ? offy : offz;
    s_off[axis * M + (m % W) * nv + m / W] = src[m];
  }
  __syncthreads();
  const float* s_ox = s_off;
  const float* s_oy = s_off + M;
  const float* s_oz = s_off + 2 * M;

  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + warp; row < R; row += stride) {
    const int tile = row / tile_rows;
    if (__ldg(tile_map + tile) != tile) continue;  // dead tile: exact zeros
    const long base = (long)row * M;
    const int16_t* rx = cx + base;
    const int16_t* ry = cy + base;
    const int16_t* rz = cz + base;
    const int16_t* rl = cl + base;
    Chunk<W> cur[4];
    if (lane < nv) load_chunk<W>(cur, rx, ry, rz, rl, lane * W);

    const float ox = __ldg(origin + 3 * row + 0);
    const float oy = __ldg(origin + 3 * row + 1);
    const float oz = __ldg(origin + 3 * row + 2);
    float qx[P], qy[P], qz[P], ql[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const Query q = transform_query(s_T, q0, row_abs, used, row, p, P, ox, oy, oz, vox);
      qx[p] = q.qx;
      qy[p] = q.qy;
      qz[p] = q.qz;
      ql[p] = q.ql;
    }

    float bv[P];
    int bi[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      bv[p] = __int_as_float(0x7f800000);  // +inf: a lane with no candidate
      bi[p] = INT_MAX;                     // loses every comparison
    }
    for (int v = lane; v < nv; v += 32) {
      Chunk<W> nxt[4];
      if (v + 32 < nv) load_chunk<W>(nxt, rx, ry, rz, rl, (v + 32) * W);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int m = v * W + e;
        const int s = e * nv + v;
        const float x = __fadd_rn(__fmul_rn(cur[0].get(e), scale), s_ox[s]);
        const float y = __fadd_rn(__fmul_rn(cur[1].get(e), scale), s_oy[s]);
        const float z = __fadd_rn(__fmul_rn(cur[2].get(e), scale), s_oz[s]);
        const float l = cur[3].get(e);
        const bool invalid = l < 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float d2 = sage::sq3(sub(x, qx[p]), sub(y, qy[p]), sub(z, qz[p]));
          const bool sem = (l == ql[p]) || (mul(l, ql[p]) == 0.f);
          float d2w = sem ? mul(d2, sem_th) : d2;
          if (invalid) d2w = FLT_MAX;
          // a lane visits its candidates in increasing order: keep the first minimum
          if (bi[p] == INT_MAX || d2w < bv[p]) {
            bv[p] = d2w;
            bi[p] = m;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
    }
    int mine = 0;  // lane p's slot winner
#pragma unroll
    for (int p = 0; p < P; ++p) {
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(sage::kFullMask, bv[p], off);
        const int oi = __shfl_xor_sync(sage::kFullMask, bi[p], off);
        if (ov < bv[p] || (ov == bv[p] && oi < bi[p])) {
          bv[p] = ov;
          bi[p] = oi;
        }
      }
      if (lane == p) mine = bi[p];
    }
    if (lane < P) {
      // lane p: slot p's terms; the query is recomputed with the same
      // operations, so its values are the selection's
      const Query q = transform_query(s_T, q0, row_abs, used, row, lane, P, ox, oy, oz, vox);
      const int s = (mine % W) * nv + mine / W;
      const float tx = sage::dequant(rx[mine], scale, s_ox[s]);
      const float ty = sage::dequant(ry[mine], scale, s_oy[s]);
      const float tz = sage::dequant(rz[mine], scale, s_oz[s]);
      const bool t_invalid = rl[mine] < 0;
      const float sx = q.sx, sy = q.sy, sz = q.sz;
      const float dx = sub(q.qx, tx);
      const float dy = sub(q.qy, ty);
      const float dz = sub(q.qz, tz);
      const float r2 = sage::sq3(dx, dy, dz);
      const bool accept = q.use && !t_invalid && r2 < s_gate[0];
      const float kr = add(s_gate[1], r2);
      const float w = accept ? __fdiv_rn(s_gate[2], mul(kr, kr)) : 0.f;
      // every slot of a live row adds its products, zero weights included
      const float wsx = mul(w, sx), wsy = mul(w, sy), wsz = mul(w, sz);
      float* acc = s_acc[warp][lane];
      acc[0] = add(acc[0], w);
      acc[1] = add(acc[1], wsx);
      acc[2] = add(acc[2], wsy);
      acc[3] = add(acc[3], wsz);
      acc[4] = add(acc[4], mul(wsx, sx));
      acc[5] = add(acc[5], mul(wsy, sy));
      acc[6] = add(acc[6], mul(wsz, sz));
      acc[7] = add(acc[7], mul(wsx, sy));
      acc[8] = add(acc[8], mul(wsx, sz));
      acc[9] = add(acc[9], mul(wsy, sz));
      acc[10] = add(acc[10], mul(w, dx));
      acc[11] = add(acc[11], mul(w, dy));
      acc[12] = add(acc[12], mul(w, dz));
      acc[13] = add(acc[13], mul(w, sub(mul(sy, dz), mul(sz, dy))));
      acc[14] = add(acc[14], mul(w, sub(mul(sz, dx), mul(sx, dz))));
      acc[15] = add(acc[15], mul(w, sub(mul(sx, dy), mul(sy, dx))));
      acc[16] = add(acc[16], accept ? 1.f : 0.f);
      acc[17] = add(acc[17], q.use ? 1.f : 0.f);
    }
  }
  __syncthreads();
  // the block's sums: warps in warp order, each warp's slots in slot order
  if (threadIdx.x < kNSums) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      for (int p = 0; p < P; ++p) s = add(s, s_acc[w][p][threadIdx.x]);
    }
    partials[(long)blockIdx.x * kNSums + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  // the last block: every partial row is written and fenced
  __threadfence();
  const int nb = gridDim.x;
  for (int j = warp; j < kNSums; j += kWarps) {
    float s = 0.f;
    // lane l adds rows l, l + 32, ... in order; eight loads in flight
    for (int b0 = lane; b0 < nb; b0 += 8 * 32) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + 32 * u;
        v[u] = b < nb ? __ldcg(partials + (long)b * kNSums + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (b0 + 32 * u < nb) s = add(s, v[u]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_xor_sync(sage::kFullMask, s, off));
    if (lane == 0) out[j] = s;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call
}

// Candidates per load for rows of M int16 lanes: 8 (16 B), 4 (8 B) or 1.
int load_width(int M) {
  return (2 * M) % 16 == 0 ? 8 : (2 * M) % 8 == 0 ? 4 : 1;
}

template <int P, int W>
cudaError_t launch(const void* cx, const void* cy, const void* cz, const void* cl,
                   const void* offx, const void* offy, const void* offz,
                   const void* q0, const void* origin, const void* row_abs,
                   const void* used, const void* tile_map, int tile_rows,
                   const void* T, int R, int M, float sem_th, float scale, float vox,
                   const void* max_corr, const void* kth, const void* status, int n_blocks,
                   void* partials, void* counter, void* out, void* launches,
                   cudaStream_t stream) {
  const size_t smem = 3 * (size_t)M * sizeof(float);  // the lane offsets
  if (smem > 48 * 1024) {  // past the default: the instance's limit is raised to it
    const cudaError_t err = cudaFuncSetAttribute(
        gn_iteration_kernel<P, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gn_iteration_kernel<P, W><<<n_blocks, kThreads, smem, stream>>>(
      (const int16_t*)cx, (const int16_t*)cy, (const int16_t*)cz,
      (const int16_t*)cl, (const float*)offx, (const float*)offy,
      (const float*)offz, (const float*)q0, (const float*)origin,
      (const int32_t*)row_abs, (const int32_t*)used,
      (const int32_t*)tile_map, tile_rows, (const float*)T, R, M, sem_th, scale, vox,
      (const float*)max_corr, (const float*)kth, (const int32_t*)status, (float*)partials,
      (int*)counter, (float*)out, (unsigned long long*)launches);
  return cudaGetLastError();
}

// The instance <P, W> as a switch over the runtime P and load_width(M).
#define SAGE_GN_DISPATCH(FN, ...)                                   \
  switch (P * 16 + load_width(M)) {                                 \
    case 1 * 16 + 1: return (int)FN<1, 1>(__VA_ARGS__);             \
    case 1 * 16 + 4: return (int)FN<1, 4>(__VA_ARGS__);             \
    case 1 * 16 + 8: return (int)FN<1, 8>(__VA_ARGS__);             \
    case 2 * 16 + 1: return (int)FN<2, 1>(__VA_ARGS__);             \
    case 2 * 16 + 4: return (int)FN<2, 4>(__VA_ARGS__);             \
    case 2 * 16 + 8: return (int)FN<2, 8>(__VA_ARGS__);             \
    case 4 * 16 + 1: return (int)FN<4, 1>(__VA_ARGS__);             \
    case 4 * 16 + 4: return (int)FN<4, 4>(__VA_ARGS__);             \
    case 4 * 16 + 8: return (int)FN<4, 8>(__VA_ARGS__);             \
    case 8 * 16 + 1: return (int)FN<8, 1>(__VA_ARGS__);             \
    case 8 * 16 + 4: return (int)FN<8, 4>(__VA_ARGS__);             \
    case 8 * 16 + 8: return (int)FN<8, 8>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidValue;                     \
  }

}  // namespace

// Device pointers: T, 12 floats (rows 0-2 of the 4x4 increment); max_corr
// and kth, one float each; status, one int32 (0 = run). partials:
// kMaxBlocks rows of 18 floats; counter: one int32, zero before the first
// call (each call leaves it zero); launches: the kernel's launch counter
// (launch_count.cuh).
extern "C" int sage_gn_iteration(
    const void* cx, const void* cy, const void* cz, const void* cl,
    const void* offx, const void* offy, const void* offz, const void* q0,
    const void* origin, const void* row_abs, const void* used,
    const void* tile_map, int tile_rows, const void* T, int R, int M, int P,
    float sem_th, float scale, float vox, const void* max_corr, const void* kth,
    const void* status, void* partials, void* counter, void* out, void* launches,
    void* stream) {
  if (M < 1 || R < 0) return (int)cudaErrorInvalidValue;
  // at least one block: it writes the zeros of an empty call
  const int want = (R + kWarps - 1) / kWarps;
  const int n_blocks = want < 1 ? 1 : want < kMaxBlocks ? want : kMaxBlocks;
  SAGE_GN_DISPATCH(launch, cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used,
                   tile_map, tile_rows, T, R, M, sem_th, scale, vox, max_corr, kth, status,
                   n_blocks, partials, counter, out, launches, (cudaStream_t)stream)
}
