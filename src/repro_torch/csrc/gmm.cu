// Grouped matrix product (MoE expert compute), hand-written for Hopper
// (sm_90a).
//
//   gmm_kernel  replaces repro/kernels/moe_gmm.py gmm (its Pallas body
//               _kernel)
//
// What it computes: x (T, D) holds rows grouped by expert, group e being
// rows [offs[e], offs[e + 1]) with offs = [0, cumsum(sizes)]; w (E, D, F).
//   out[i] = x[i] @ w[e]   for the rows i of group e,
//   out[i] = 0             for the rows past sum(sizes) (no expert's group
//                          covers them: the Pallas kernel writes zeros).
// Groups may be empty, boundaries may fall anywhere, and T, D and F need
// not be multiples of any tile. Inputs are float32 or bfloat16; products
// are accumulated in float32 and the output is rounded once to x's type.
//
// What bounds it on an H100. On the MoE path the rows are E groups of
// `cap` rows (cap = 1 at decode with 8 slots, 30 for a 256-token prefill
// bucket) and every call reads one whole expert tensor: 64 x 2048 x 1408
// bf16 = 369 MB, 110 us at 3.35 TB/s. The prefill call's 11.1 GFLOP take
// 11 us at the bf16 tensor-core peak (166 us at the f32 CUDA-core peak
// this kernel computes at). So both shapes are bound by the bytes of w,
// and at decode the kernel must stream w with few instructions per byte.
//
// What the design does about it:
//   * The Pallas grid (row tile, column tile, expert) revisits every output
//     tile once per expert, in order, which is how a TPU accumulates. Here
//     one block owns one (column tile, row tile inside one group, expert):
//     every tile of w[e] is read by the blocks of its own group only, once
//     per row tile, and every expert's blocks run at once (at decode 64 x
//     6 blocks, ~3 on each of the 132 SMs). No block accumulates across
//     experts, so every output element is written once.
//   * A block finds its group's bounds itself (a block-wide sum of the
//     sizes before it: no offsets array, no extra launch) and walks its row
//     tiles in a grid-stride loop, so the grid's row dimension, sized for
//     the mean group ceil(T / E) (the capacity on the MoE path, where
//     T = E * cap), never limits what is computed. Blocks of an empty group
//     exit at once. One extra slice of the grid (e == E) writes the zeros
//     past the last group.
//   * The tile is picked from that mean group: 4 rows x 256 columns for up
//     to 4 rows (decode: one row a group, so each thread multiplies one x
//     row into 4 columns and the block streams 16 KB of w a K-chunk), else
//     16 or 32 rows x 128 columns (each thread 2 or 4 rows x 4 columns).
//   * x and w tiles go through shared memory in K-chunks of 32, loaded as
//     16-byte vectors where alignment allows (scalar at ragged edges and
//     for odd widths), converted to float32 once; the next chunk is loaded
//     into registers while the current one is multiplied. Each thread keeps
//     a (rows/16) x 4 float32 accumulator in registers.
//   * Simple first: no tensor cores (wgmma), TMA or multi-stage pipeline.
//
// Interface: a plain C function (loaded with ctypes) returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;   // depth of one K-chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Eight consecutive elements at a 16-byte aligned address.
__device__ __forceinline__ void load8_vec(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8_vec(const __nv_bfloat16* p,
                                          float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The first n (0..8) of eight consecutive elements at p as float32, zeros
// after them; nothing past the n-th element is read.
template <typename scalar_t>
__device__ __forceinline__ void load8(const scalar_t* p, int n, bool vec,
                                      float (&v)[8]) {
  if (vec && n == 8) {
    load8_vec(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < n ? to_float(p[i]) : 0.f;
}

__device__ __forceinline__ int clamp8(int n) { return n < 0 ? 0 : n > 8 ? 8 : n; }

// grid (ceil(F / BN), row-tile slots, E + 1), 256 threads; a tile is BM
// rows x BN columns. Thread (ty, tx) = (tid / CG, tid % CG), CG = BN / 4,
// owns rows ty * TM + [0, TM) and columns tx * 4 + [0, 4) of the tile.
template <typename scalar_t, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const scalar_t* __restrict__ x, const scalar_t* __restrict__ w,
               const int32_t* __restrict__ sizes, scalar_t* __restrict__ out,
               int T, int D, int F, int E, int vec_x, int vec_w) {
  constexpr int CG = BN / 4;                // column groups of 4
  constexpr int TM = BM / (kThreads / CG);  // rows a thread
  constexpr int WP = BN / 64;               // w pieces of 8 a thread
  static_assert(TM >= 1 && BM % (kThreads / CG) == 0, "tile shape");
  static_assert(BM * 4 <= kThreads && WP >= 1, "loader shape");
  __shared__ float xs[kBK][BM + 1];   // x tile, transposed (+1: no
                                      // bank conflicts on the store)
  __shared__ __align__(16) float ws[kBK][BN];     // w tile
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int bounds[2];

  const int tid = threadIdx.x;
  const int e = blockIdx.z;

  // This block's rows: [sum(sizes[:e]), + sizes[e]) clipped to T; for the
  // slice e == E, the rows past the last group.
  int part = 0;
  for (int i = tid; i < e; i += kThreads) part += sizes[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sum[i];
    const int start = min(max(s, 0), T);
    const int stop = e < E ? min(max(s + sizes[e], start), T) : T;
    bounds[0] = start;
    bounds[1] = stop;
  }
  __syncthreads();
  const int start = bounds[0];
  const int stop = bounds[1];

  const int tx = tid % CG;
  const int ty = tid / CG;
  const int col0 = blockIdx.x * BN;
  // Loading: x as BM * 4 pieces of 8 (row p / 4, depth (p % 4) * 8), one a
  // thread for tid < BM * 4; w as 4 * BN pieces of 8, piece p = tid + 256 i
  // at depth p / (BN / 8), columns (p % (BN / 8)) * 8: a warp reads 512
  // contiguous bytes of a bf16 row (BN = 256) or two rows of 256 (BN = 128).
  const bool x_loader = tid < BM * 4;
  const int xr = tid >> 2, xk = (tid & 3) * 8;
  const int wk = tid / (BN / 8), wc = (tid % (BN / 8)) * 8;
  constexpr int kWStep = kThreads / (BN / 8);   // depth between pieces
  const scalar_t* wbase = w + static_cast<size_t>(e < E ? e : 0) * D * F;

  for (int row0 = start + blockIdx.y * BM; row0 < stop;
       row0 += gridDim.y * BM) {
    if (e == E) {   // rows past the last group: zeros
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + tx * 4 + j;
          if (r < stop && c < F) store(out + static_cast<size_t>(r) * F + c, 0.f);
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
        if (c < F) store(out + static_cast<size_t>(r) * F + c, acc[i][j]);
      }
    }
  }
}

template <typename scalar_t, int BM, int BN>
cudaError_t launch(const void* x, const void* w, const void* sizes, void* out,
                   int T, int D, int F, int E, int rows, bool aligned,
                   cudaStream_t stream) {
  // 16-byte vectors of 8 elements need rows that start 16-byte aligned.
  constexpr int kPerVec = 16 / sizeof(scalar_t);
  const int vec_x = aligned && D % kPerVec == 0;
  const int vec_w = aligned && F % kPerVec == 0;
  int slots = (rows + BM - 1) / BM;
  if (slots > 65535) slots = 65535;
  const dim3 grid((F + BN - 1) / BN, slots, E + 1);
  gmm_kernel<scalar_t, BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const scalar_t*>(x), static_cast<const scalar_t*>(w),
      static_cast<const int32_t*>(sizes), static_cast<scalar_t*>(out), T, D, F,
      E, vec_x, vec_w);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch(const void* x, const void* w, const void* sizes,
                     void* out, int T, int D, int F, int E, bool aligned,
                     cudaStream_t stream) {
  const int rows = (T + E - 1) / E;   // the mean group, rounded up
  if (rows <= 4)
    return launch<scalar_t, 4, 256>(x, w, sizes, out, T, D, F, E, rows,
                                    aligned, stream);
  if (rows <= 16)
    return launch<scalar_t, 16, 128>(x, w, sizes, out, T, D, F, E, rows,
                                     aligned, stream);
  return launch<scalar_t, 32, 128>(x, w, sizes, out, T, D, F, E, rows,
                                   aligned, stream);
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 bfloat16. x (T, D), w (E, D, F), out (T, F) of that
// type, contiguous; sizes (E,) int32. T, D, F, E >= 1 and E < 65535;
// anything else returns cudaErrorInvalidValue unlaunched.
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
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(x, w, sizes, out, T, D, F, E, aligned, s)
          : dispatch<__nv_bfloat16>(x, w, sizes, out, T, D, F, E, aligned, s);
  return static_cast<int>(err);
}

}  // extern "C"
