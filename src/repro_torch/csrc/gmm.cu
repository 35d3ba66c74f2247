// Grouped matrix product (MoE expert compute), hand-written for Hopper
// (sm_90a).
//
//   gmm_tc_kernel  replaces repro/kernels/moe_gmm.py gmm (its Pallas body
//                  _kernel) for bfloat16: tensor cores, a cp.async ring
//   gmm_kernel     the same for float32, on the CUDA cores (the wrapper
//                  picks by dtype: TF32 would not hold float32's parity
//                  checks)
//
// What it computes: x (T, D) holds rows grouped by expert, group e being
// rows [offs[e], offs[e + 1]) with offs = [0, cumsum(sizes)]; w (E, D, F).
//   out[i] = x[i] @ w[e]   for the rows i of group e,
//   out[i] = 0             for the rows past sum(sizes) (no expert's group
//                          covers them: the Pallas kernel writes zeros).
// Groups may be empty, boundaries may fall anywhere, and T, D and F need
// not be multiples of any tile. Products are accumulated in float32 (a
// bf16 x bf16 product is exact in float32: the Pallas kernel's
// x.astype(f32) @ w.astype(f32) up to summation order) and the output is
// rounded once to x's type.
//
// What bounds it on an H100. On the MoE path every expert with a row reads
// its whole weight matrix: 2048 x 1408 bf16 = 5.77 MB, 1.7 us at 3.35
// TB/s. The MoE layer packs its capacity buffer by expert, so an expert
// that no row reaches has an empty group and its weights are never read:
// at decode (8 slots x top-6, capacity 1) about 10 of the 64 experts keep
// a row. A 256-token prefill bucket (30 rows an expert) does 11.1 GFLOP,
// 11 us at the bf16 tensor-core peak, against 110 us for the 369 MB of w.
// So every shape the MoE layer gives is bound by the bytes of w: the
// kernel must keep many bytes of w in flight and spend few instructions on
// each.
//
// What the design does about it:
//   * The Pallas grid (row tile, column tile, expert) revisits every output
//     tile once per expert, in order, which is how a TPU accumulates. Here
//     one block owns one (column tile, row tile inside one group, expert):
//     every tile of w[e] is read by the blocks of its own group only, once
//     per row tile, and every expert's blocks run at once. No block
//     accumulates across experts, so every output element is written once.
//   * A block finds its group itself (a block-wide scan of the sizes: no
//     offsets array, no extra launch, no host sync) and walks its row tiles
//     in a grid-stride loop, so the grid's row dimension, sized for the
//     mean group ceil(T / E) (the capacity on the MoE path, where
//     T = E * cap), never limits what is computed. Grid slice z serves the
//     z-th non-empty group, not expert z: the blocks with work are the
//     first the card schedules, ahead of the slices past the non-empty
//     groups (~54 of 64 at decode), which exit at once. Slice 0 writes the
//     zeros past the last group.
//   * bf16 tiles stay bf16 in shared memory: w's (D, F) row-major tile and
//     x's rows reach it by cp.async, 16 bytes a thread, through a ring of
//     4 stages of 16 KB of w each, so 48 KB of w are in flight behind the
//     stage being multiplied (two blocks an SM). Rows are padded by 16
//     bytes so that ldmatrix reads no bank twice. Ragged edges (a width
//     that is no multiple of 8, or a misaligned pointer) are loaded by
//     plain loads into the same ring.
//   * The products run on the tensor cores: mma.sync m16n8k16, bf16 in,
//     float32 accumulate; x's fragments by ldmatrix, w's by ldmatrix.trans.
//     Four warps split the column tile. mma.sync, not wgmma: the kernel is
//     bound by the bytes of w at 16-30 rows a group, where a 64-row
//     warpgroup product would only multiply more zero rows.
//   * The tile follows the mean group: 16 rows x 64 columns (K-chunks of
//     128) for up to 16 rows, so decode's one row a group is padded with
//     zeros only to the 16-row fragment and an expert's 1408 columns make
//     22 blocks (about 220 for the ~10 experts that decode reaches); else
//     32 rows x 128 columns (K-chunks of 64).
//   * float32 keeps the CUDA-core kernel: K-chunks of 32 converted once
//     into shared memory, one register stage of prefetch, FMA into a
//     (rows / 16) x 4 register tile a thread.
//
// Interface: a plain C function (loaded with ctypes) returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Group {
  int e;             // expert; E for the rows past the last group; -1: none
  int start, stop;   // its rows, clipped to T
};

// The group of grid slice z. Slice 0 is the rows past the last group;
// slice z >= 1 is the z-th non-empty group in expert order (group e being
// rows [sum(sizes[:e]), + sizes[e]), a negative size counting as 0), so
// the blocks with work come first in the grid's order and the slices past
// the non-empty groups (e = -1) have nothing to do. A block-wide scan of
// the sizes, kThreads at a time; every thread of the block must call it.
template <int kThreads>
__device__ Group find_group(const int32_t* sizes, int z, int E, int T) {
  constexpr int W = kThreads / 32;
  __shared__ int warp_n[W], warp_s[W];
  __shared__ Group found;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) found = Group{-1, 0, 0};
  int n_before = 0, s_before = 0;   // non-empty groups, rows before chunk
  for (int c0 = 0; c0 < E; c0 += kThreads) {
    const int e = c0 + tid;
    const int size = e < E ? max(sizes[e], 0) : 0;
    int n = size > 0, s = size;     // inclusive scans within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n_up = __shfl_up_sync(0xffffffffu, n, o);
      const int s_up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) { n += n_up; s += s_up; }
    }
    if (lane == 31) { warp_n[warp] = n; warp_s[warp] = s; }
    __syncthreads();
    int n_tot = 0, s_tot = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < warp) { n += warp_n[i]; s += warp_s[i]; }
      n_tot += warp_n[i];
      s_tot += warp_s[i];
    }
    if (size > 0 && n_before + n == z) {
      const int start = min(s_before + s - size, T);
      found = Group{e, start, min(start + size, T)};
    }
    n_before += n_tot;
    s_before += s_tot;
    __syncthreads();                // warp sums are read before rewritten
  }
  if (z == 0 && tid == 0) found = Group{E, min(s_before, T), T};
  __syncthreads();
  return found;
}

// ------------------------------------------------------------ bf16, tensor cores
constexpr int kTcThreads = 128;   // four warps, side by side over columns
constexpr int kStages = 4;

template <int BM, int BN>
struct TcTile {
  static constexpr int BK = 8192 / BN;   // a stage of w is 16 KB
  static constexpr int LDW = BN + 8;     // padded shared-memory rows
  static constexpr int LDX = BK + 8;
  static constexpr size_t smem =
      kStages * (static_cast<size_t>(BK) * LDW + BM * LDX) * sizeof(bf16);
};

// Eight bf16 at src -> dst (shared), of which the first n are real and the
// rest zeros: cp.async when all eight are there and aligned, plain loads
// otherwise (only at ragged edges or for misaligned widths).
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int n,
                                      bool vec) {
  if (vec && n >= 8) {
    tc::cp_async16(dst, src, 16);
  } else if (n <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : __float2bfloat16(0.f);
  }
}

// grid (ceil(F / BN), row-tile slots, E + 1), 128 threads, slice z of the
// grid serving find_group's group z; a tile is BM rows x BN columns, warp
// w owning columns w * BN / 4 + [0, BN / 4).
template <int BM, int BN>
__global__ void __launch_bounds__(kTcThreads)
    gmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int32_t* __restrict__ sizes, bf16* __restrict__ out,
                  int T, int D, int F, int E, int vec_x, int vec_w) {
  using Tile = TcTile<BM, BN>;
  constexpr int BK = Tile::BK, LDW = Tile::LDW, LDX = Tile::LDX;
  constexpr int WN = BN / 4;               // columns a warp
  constexpr int MF = BM / 16, NF = WN / 8;  // fragments a warp
  static_assert(BM % 16 == 0 && WN % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);   // [kStages][BK][LDW]
  bf16* xs = ws + kStages * BK * LDW;              // [kStages][BM][LDX]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Group g = find_group<kTcThreads>(sizes, blockIdx.z, E, T);
  if (g.e < 0) return;
  const int e = g.e, start = g.start, stop = g.stop;
  const int col0 = blockIdx.x * BN;
  const bf16* wbase = w + static_cast<size_t>(e < E ? e : 0) * D * F;
  const int nk = (D + BK - 1) / BK;

  for (int row0 = start + blockIdx.y * BM; row0 < stop;
       row0 += gridDim.y * BM) {
    if (e == E) {   // rows past the last group: zeros
      for (int i = tid; i < BM * BN; i += kTcThreads) {
        const int r = row0 + i / BN, c = col0 + i % BN;
        if (r < stop && c < F)
          out[static_cast<size_t>(r) * F + c] = __float2bfloat16(0.f);
      }
      continue;
    }
    auto load = [&](int kc, int stage) {
      const int k0 = kc * BK;
      bf16* wd = ws + stage * BK * LDW;
      bf16* xd = xs + stage * BM * LDX;
      for (int i = tid; i < BK * (BN / 8); i += kTcThreads) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int k = k0 + r, col = col0 + c;
        copy8(wd + r * LDW + c, wbase + static_cast<size_t>(k) * F + col,
              k < D ? F - col : 0, vec_w != 0);
      }
      for (int i = tid; i < BM * (BK / 8); i += kTcThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int row = row0 + r, kx = k0 + c;
        copy8(xd + r * LDX + c, x + static_cast<size_t>(row) * D + kx,
              row < stop ? D - kx : 0, vec_x != 0);
      }
    };

    float acc[MF][NF][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      tc::cp_async_commit();          // one group per stage, even if empty
    }
    for (int kc = 0; kc < nk; ++kc) {
      tc::cp_async_wait<kStages - 2>();   // chunk kc has landed
      __syncthreads();                    // ... and chunk kc - 1's stage is free
      const int next = kc + kStages - 1;
      if (next < nk) load(next, next % kStages);
      tc::cp_async_commit();
      const bf16* wt = ws + (kc % kStages) * BK * LDW;
      const bf16* xt = xs + (kc % kStages) * BM * LDX;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
          tc::ldsm_x4(a[mf], xt + (mf * 16 + (lane & 15)) * LDX + ks * 16
                                 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NF / 2; ++np) {
          uint32_t b[4];
          tc::ldsm_x4_t(b, wt + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                                    * LDW
                               + warp * WN + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) {
            tc::mma_bf16(acc[mf][2 * np], a[mf], b[0], b[1]);
            tc::mma_bf16(acc[mf][2 * np + 1], a[mf], b[2], b[3]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();                // the ring is free for the next row tile

    const bool pairs = (F & 1) == 0;   // bf16x2 stores stay 4-byte aligned
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mf * 16 + (lane >> 2) + 8 * h;
        if (r >= stop) continue;
        bf16* orow = out + static_cast<size_t>(r) * F;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int c = col0 + warp * WN + nf * 8 + (lane & 3) * 2;
          const float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
          if (pairs && c + 1 < F) {
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < F) orow[c] = __float2bfloat16(v0);
            if (c + 1 < F) orow[c + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_tc(const void* x, const void* w, const void* sizes,
                      void* out, int T, int D, int F, int E, int rows,
                      bool aligned, cudaStream_t stream) {
  constexpr size_t smem = TcTile<BM, BN>::smem;
  // Above 48 KB a block needs the opt-in; set once per tile, before any
  // capture into a CUDA graph can start.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_tc_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  // 16-byte copies need rows that start 16-byte aligned.
  const int vec_x = aligned && D % 8 == 0;
  const int vec_w = aligned && F % 8 == 0;
  int slots = (rows + BM - 1) / BM;
  if (slots > 65535) slots = 65535;
  const dim3 grid((F + BN - 1) / BN, slots, E + 1);
  gmm_tc_kernel<BM, BN><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int32_t*>(sizes), static_cast<bf16*>(out), T, D, F, E,
      vec_x, vec_w);
  return cudaGetLastError();
}

// ------------------------------------------------------------ float32, CUDA cores
constexpr int kThreads = 256;
constexpr int kBK = 32;   // depth of one K-chunk

// The first n (0..8) of eight consecutive floats at p, zeros after them;
// nothing past the n-th element is read.
__device__ __forceinline__ void load8(const float* p, int n, bool vec,
                                      float (&v)[8]) {
  if (vec && n == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < n ? p[i] : 0.f;
}

__device__ __forceinline__ int clamp8(int n) { return n < 0 ? 0 : n > 8 ? 8 : n; }

// grid (ceil(F / BN), row-tile slots, E + 1), 256 threads, slice z of the
// grid serving find_group's group z; a tile is BM rows x BN columns. Thread (ty, tx) = (tid / CG, tid % CG), CG = BN / 4,
// owns rows ty * TM + [0, TM) and columns tx * 4 + [0, 4) of the tile.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int32_t* __restrict__ sizes, float* __restrict__ out,
               int T, int D, int F, int E, int vec_x, int vec_w) {
  constexpr int CG = BN / 4;                // column groups of 4
  constexpr int TM = BM / (kThreads / CG);  // rows a thread
  constexpr int WP = BN / 64;               // w pieces of 8 a thread
  static_assert(TM >= 1 && BM % (kThreads / CG) == 0, "tile shape");
  static_assert(BM * 4 <= kThreads && WP >= 1, "loader shape");
  __shared__ float xs[kBK][BM + 1];   // x tile, transposed (+1: no
                                      // bank conflicts on the store)
  __shared__ __align__(16) float ws[kBK][BN];     // w tile

  const int tid = threadIdx.x;
  const Group g = find_group<kThreads>(sizes, blockIdx.z, E, T);
  if (g.e < 0) return;
  const int e = g.e, start = g.start, stop = g.stop;

  const int tx = tid % CG;
  const int ty = tid / CG;
  const int col0 = blockIdx.x * BN;
  // Loading: x as BM * 4 pieces of 8 (row p / 4, depth (p % 4) * 8), one a
  // thread for tid < BM * 4; w as 4 * BN pieces of 8, piece p = tid + 256 i
  // at depth p / (BN / 8), columns (p % (BN / 8)) * 8.
  const bool x_loader = tid < BM * 4;
  const int xr = tid >> 2, xk = (tid & 3) * 8;
  const int wk = tid / (BN / 8), wc = (tid % (BN / 8)) * 8;
  constexpr int kWStep = kThreads / (BN / 8);   // depth between pieces
  const float* wbase = w + static_cast<size_t>(e < E ? e : 0) * D * F;

  for (int row0 = start + blockIdx.y * BM; row0 < stop;
       row0 += gridDim.y * BM) {
    if (e == E) {   // rows past the last group: zeros
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + tx * 4 + j;
          if (r < stop && c < F) out[static_cast<size_t>(r) * F + c] = 0.f;
        }
      }
      continue;
    }
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    float xv[8], wv[WP][8];
    auto fetch = [&](int k0) {
      if (x_loader) {
        const int r = row0 + xr, k = k0 + xk;
        load8(x + static_cast<size_t>(r) * D + k, r < stop ? clamp8(D - k) : 0,
              vec_x != 0, xv);
      }
#pragma unroll
      for (int i = 0; i < WP; ++i) {
        const int k = k0 + wk + i * kWStep, c = col0 + wc;
        load8(wbase + static_cast<size_t>(k) * F + c,
              k < D ? clamp8(F - c) : 0, vec_w != 0, wv[i]);
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < D; k0 += kBK) {
      if (x_loader) {
#pragma unroll
        for (int i = 0; i < 8; ++i) xs[xk + i][xr] = xv[i];
      }
#pragma unroll
      for (int i = 0; i < WP; ++i) {
        float* dst = &ws[wk + i * kWStep][wc];
        *reinterpret_cast<float4*>(dst) =
            make_float4(wv[i][0], wv[i][1], wv[i][2], wv[i][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(wv[i][4], wv[i][5], wv[i][6], wv[i][7]);
      }
      __syncthreads();
      if (k0 + kBK < D) fetch(k0 + kBK);    // in flight while we multiply
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = xs[k][ty * TM + i];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty * TM + i;
      if (r >= stop) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx * 4 + j;
        if (c < F) out[static_cast<size_t>(r) * F + c] = acc[i][j];
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_f32(const void* x, const void* w, const void* sizes,
                       void* out, int T, int D, int F, int E, int rows,
                       bool aligned, cudaStream_t stream) {
  // 16-byte vectors of 4 floats need rows that start 16-byte aligned.
  const int vec_x = aligned && D % 4 == 0;
  const int vec_w = aligned && F % 4 == 0;
  int slots = (rows + BM - 1) / BM;
  if (slots > 65535) slots = 65535;
  const dim3 grid((F + BN - 1) / BN, slots, E + 1);
  gmm_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(sizes), static_cast<float*>(out), T, D, F,
      E, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 bfloat16. x (T, D), w (E, D, F), out (T, F) of that
// type, contiguous; sizes (E,) int32. T, D, F, E >= 1 and E < 65535;
// anything else returns cudaErrorInvalidValue unlaunched. The tile follows
// the mean group ceil(T / E).
int repro_gmm(int dtype, const void* x, const void* w, const void* sizes,
              void* out, int T, int D, int F, int E, void* stream) {
  if (T < 1 || D < 1 || F < 1 || E < 1 || E >= 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (T + E - 1) / E;
  cudaError_t err;
  if (dtype == 1) {
    err = rows <= 16
              ? launch_tc<16, 64>(x, w, sizes, out, T, D, F, E, rows,
                                  aligned, s)
              : launch_tc<32, 128>(x, w, sizes, out, T, D, F, E, rows,
                                   aligned, s);
  } else {
    err = rows <= 4
              ? launch_f32<4, 256>(x, w, sizes, out, T, D, F, E, rows,
                                   aligned, s)
          : rows <= 16
              ? launch_f32<16, 128>(x, w, sizes, out, T, D, F, E, rows,
                                    aligned, s)
              : launch_f32<32, 128>(x, w, sizes, out, T, D, F, E, rows,
                                    aligned, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
