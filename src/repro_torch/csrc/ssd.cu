// Mamba2 SSD (state-space duality) chunk scan, hand-written for Hopper
// (sm_90a).
//
//   ssd_chunked_kernel  replaces repro/kernels/mamba2_ssd.py ssd_chunked
//                       (its Pallas body _kernel)
//
// What it computes, for one batch row b and head h, over chunks of L tokens
// with the inclusive log-decay prefix s_t = A_h * sum_{tau <= t} dt_tau:
//   y_intra = ((C B^T) o M) (dt x)      M[t, tau] = exp(min(s_t - s_tau, 0))
//                                                   * [tau <= t]
//   y_inter = exp(s_t) (C h_in)
//   h_out   = exp(s_L) h_in + B^T diag(exp(s_L - s_t)) (dt x)
// with the (N, P) float32 state h carried from chunk to chunk (it starts at
// zero), one B/C group shared by every head, and the final h returned.
//
// What bounds it on an H100. At the serving shape (one 256-token bucket,
// 24 heads of P = 64, N = 128, L = 64) the work is ~2.6e8 float32 flops on
// ~2.65 MB of inputs and outputs, ~97 flops a byte: the bound is the f32
// rate of the CUDA cores (3.8 us at 67 TFLOP/s), not memory (0.8 us).
//
// What the design does about it:
//   * The TPU grid walks (batch, head, chunk) with the chunk axis in order
//     and h in VMEM. Here one block owns (b, h, a tile of kPT = 16 columns
//     of P) and loops over the chunks itself, keeping its (N, 16) slice of
//     h in shared memory. Columns of h evolve independently, so splitting P
//     needs no reduction across blocks and gives 4x the blocks (96 at the
//     serving shape, on 132 SMs, instead of 24).
//   * Each block recomputes C B^T and the decay mask of its chunk. With one
//     B/C group that product is the same for every head, and recomputing it
//     costs more flops than the rest of the chunk; in exchange the kernel
//     is one pass with no scratch in device memory.
//   * B, C, dt*x and the masked (L, L) product sit in shared memory with
//     padded row strides, so the inner loops read without bank conflicts
//     (or as broadcasts); each thread keeps a register tile of its outputs.
//   * All math is float32, as the TPU kernel's preferred_element_type; x is
//     float32 or bfloat16 and y takes x's type. exp arguments of the mask
//     are clamped at 0, as in _kernel.
// Tensor cores (TF32 would break the f32 contract), TMA, and sharing C B^T
// across heads are later work.
//
// Interface: a plain C function (loaded with ctypes) returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t. dtype (of x and y): 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 64;     // longest chunk a block tiles
constexpr int kPT = 16;       // columns of P per block
constexpr int kMaxN = 256;    // largest state size the register tiles cover
constexpr int kRows = kMaxL / (kThreads / kMaxL);   // C B^T rows a thread
constexpr int kNTile = kMaxN / (kThreads / 4);      // state rows a thread
constexpr int kMaxDevices = 64;   // devices whose smem attribute is cached

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, in floats. Row strides: C N + 4 (16-byte rows for
// float4 reads), B N + 1 (odd: a warp reading one column of 32 rows hits 32
// banks), C B^T L + 1.
struct Layout {
  int c, b, g, x, h, s, es, e, dt, el, total;
  __host__ __device__ Layout(int L, int N)
      : c(0),
        b(round4(L * (N + 4))),
        g(b + round4(L * (N + 1))),
        x(g + round4(L * (L + 1))),
        h(x + L * kPT),
        s(h + N * kPT),
        es(s + kMaxL),
        e(es + kMaxL),
        dt(e + kMaxL),
        el(dt + kMaxL),
        total(el + 4) {}
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunked_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, T* __restrict__ y,
                   float* __restrict__ hout, int T_len, int H, int P, int N,
                   int L) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(L, N);
  float* sC = smem + lay.c;     // (L, N + 4)  C of the chunk
  float* sB = smem + lay.b;     // (L, N + 1)  B of the chunk
  float* sG = smem + lay.g;     // (L, L + 1)  (C B^T) o M
  float* sX = smem + lay.x;     // (L, kPT)    dt * x, this block's columns
  float* sH = smem + lay.h;     // (N, kPT)    the carried state
  float* ss = smem + lay.s;     // s_t
  float* ses = smem + lay.es;   // exp(s_t)
  float* se = smem + lay.e;     // exp(s_L - s_t)
  float* sdt = smem + lay.dt;   // dt_t
  float* sel = smem + lay.el;   // exp(s_L)
  const int ldc = N + 4, ldb = N + 1, ldg = L + 1;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const float Ah = A[h];

  for (int i = tid; i < N * kPT; i += kThreads) sH[i] = 0.f;

  for (int ck = 0; ck < T_len / L; ++ck) {
    const int64_t row0 = static_cast<int64_t>(b) * T_len
                         + static_cast<int64_t>(ck) * L;
    // (1) dt, B and C of the chunk (B and C as float4 rows).
    if (tid < L) sdt[tid] = dt[(row0 + tid) * H + h];
    const int n4 = N / 4;
    const float4* gB = reinterpret_cast<const float4*>(Bm + row0 * N);
    const float4* gC = reinterpret_cast<const float4*>(Cm + row0 * N);
    for (int i = tid; i < L * n4; i += kThreads) {
      const int r = i / n4, col = (i - r * n4) * 4;
      const float4 bv = gB[i];
      float* pb = sB + r * ldb + col;
      pb[0] = bv.x; pb[1] = bv.y; pb[2] = bv.z; pb[3] = bv.w;
      *reinterpret_cast<float4*>(sC + r * ldc + col) = gC[i];
    }
    __syncthreads();

    // (2) s = A * cumsum(dt): one warp, two steps a lane, a shuffle scan.
    // Meanwhile the other warps form dt * x for this block's columns.
    if (tid < 32) {
      const unsigned full = 0xffffffffu;
      const int t0 = 2 * tid;
      const float a0 = t0 < L ? sdt[t0] : 0.f;
      const float a1 = t0 + 1 < L ? sdt[t0 + 1] : 0.f;
      float incl = a0 + a1;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(full, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(full, incl, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const int last = L - 1;
      const float sl = Ah * __shfl_sync(full, (last & 1) ? c1 : c0,
                                        last >> 1);
      if (t0 < L) {
        const float s = Ah * c0;
        ss[t0] = s; ses[t0] = expf(s); se[t0] = expf(sl - s);
      }
      if (t0 + 1 < L) {
        const float s = Ah * c1;
        ss[t0 + 1] = s; ses[t0 + 1] = expf(s); se[t0 + 1] = expf(sl - s);
      }
      if (tid == 0) sel[0] = expf(sl);
    }
    for (int i = tid; i < L * kPT; i += kThreads) {
      const int t = i / kPT, p = p0 + i % kPT;
      const float xv = p < P ? to_float(x[((row0 + t) * H + h) * P + p])
                             : 0.f;
      sX[i] = sdt[t] * xv;
    }
    __syncthreads();

    // (3) (C B^T) o M: thread (u, row group) owns column u and rows
    // tg, tg + 4, ...; B[u, :] is read down a column (conflict-free), C rows
    // as float4 broadcasts.
    {
      const int u = tid % kMaxL, tg = tid / kMaxL;
      if (u < L) {
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
        const float* brow = sB + u * ldb;
        for (int n = 0; n < N; n += 4) {
          const float b0 = brow[n], b1 = brow[n + 1], b2 = brow[n + 2],
                      b3 = brow[n + 3];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int t = min(tg + 4 * i, L - 1);   // rows >= L: discarded
            const float4 c =
                *reinterpret_cast<const float4*>(sC + t * ldc + n);
            acc[i] = fmaf(c.x, b0, acc[i]);
            acc[i] = fmaf(c.y, b1, acc[i]);
            acc[i] = fmaf(c.z, b2, acc[i]);
            acc[i] = fmaf(c.w, b3, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int t = tg + 4 * i;
          if (t < L) {
            sG[t * ldg + u] =
                u <= t ? acc[i] * expf(fminf(ss[t] - ss[u], 0.f)) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // (4) y[t, p4:p4+4] = sum_{u <= t} G[t, u] dx[u] + exp(s_t) C[t] h_in.
    {
      const int t = tid / 4, p4 = (tid % 4) * 4;
      if (t < L) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int u = 0; u <= t; ++u) {
          const float g = sG[t * ldg + u];
          const float4 xv =
              *reinterpret_cast<const float4*>(sX + u * kPT + p4);
          a[0] = fmaf(g, xv.x, a[0]);
          a[1] = fmaf(g, xv.y, a[1]);
          a[2] = fmaf(g, xv.z, a[2]);
          a[3] = fmaf(g, xv.w, a[3]);
        }
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const float* crow = sC + t * ldc;
        for (int n = 0; n < N; n += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(crow + n);
          const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 hv = *reinterpret_cast<const float4*>(
                sH + (n + k) * kPT + p4);
            c[0] = fmaf(cn[k], hv.x, c[0]);
            c[1] = fmaf(cn[k], hv.y, c[1]);
            c[2] = fmaf(cn[k], hv.z, c[2]);
            c[3] = fmaf(cn[k], hv.w, c[3]);
          }
        }
        const float et = ses[t];
        T* yrow = y + ((row0 + t) * H + h) * P + p0 + p4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (p0 + p4 + k < P) store(yrow + k, a[k] + et * c[k]);
        }
      }
    }
    __syncthreads();

    // (5) h_out[n, p] = exp(s_L) h_in[n, p]
    //                   + sum_u B[u, n] exp(s_L - s_u) dx[u, p]:
    // thread (n-row group, p4) owns rows nq, nq + 64, ... of its 4 columns.
    {
      const int nq = tid / 4, p4 = (tid % 4) * 4;
      const float el = sel[0];
      float acc[kNTile][4];
#pragma unroll
      for (int j = 0; j < kNTile; ++j) {
        const int n = nq + (kThreads / 4) * j;
        if (n < N) {
          const float4 hv =
              *reinterpret_cast<const float4*>(sH + n * kPT + p4);
          acc[j][0] = el * hv.x; acc[j][1] = el * hv.y;
          acc[j][2] = el * hv.z; acc[j][3] = el * hv.w;
        }
      }
      for (int u = 0; u < L; ++u) {
        const float w = se[u];
        const float4 xv =
            *reinterpret_cast<const float4*>(sX + u * kPT + p4);
        const float wv[4] = {w * xv.x, w * xv.y, w * xv.z, w * xv.w};
        const float* brow = sB + u * ldb;
#pragma unroll
        for (int j = 0; j < kNTile; ++j) {
          const int n = nq + (kThreads / 4) * j;
          if (n < N) {
            const float bv = brow[n];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(bv, wv[k], acc[j][k]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNTile; ++j) {
        const int n = nq + (kThreads / 4) * j;
        if (n < N) {
          *reinterpret_cast<float4*>(sH + n * kPT + p4) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * kPT; i += kThreads) {
    const int n = i / kPT, p = p0 + i % kPT;
    if (p < P) {
      hout[((static_cast<int64_t>(b) * H + h) * N + n) * P + p] = sH[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* h, int Bt,
                   int T_len, int H, int P, int N, int L, cudaStream_t st) {
  const size_t bytes = sizeof(float) * Layout(L, N).total;
  // Above 48 KB a block's dynamic shared memory must be allowed first. The
  // attribute belongs to the current device, so it is set once per device
  // and size (not a stream operation, and kept out of graph capture).
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static size_t allowed[kMaxDevices] = {};
  size_t* seen = dev < kMaxDevices ? &allowed[dev] : nullptr;
  if (seen == nullptr || bytes > *seen) {
    err = cudaFuncSetAttribute(
        ssd_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (seen != nullptr) *seen = bytes;
  }
  const dim3 grid((P + kPT - 1) / kPT, H, Bt);
  ssd_chunked_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<T*>(y),
      static_cast<float*>(h), T_len, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (Bt, T, H, P) float32 | bfloat16; dt (Bt, T, H), A (H,), B and C
// (Bt, T, N) float32 -> y (Bt, T, H, P) in x's type, h (Bt, H, N, P)
// float32. L is the chunk length: 1 <= L <= 64, T % L == 0, N % 4 == 0,
// N <= 256; anything else returns cudaErrorInvalidValue unlaunched.
int repro_ssd_chunked(int dtype, const void* x, const void* dt,
                      const void* A, const void* B, const void* C, void* y,
                      void* h, int Bt, int T, int H, int P, int N, int L,
                      void* stream) {
  if (L < 1 || L > kMaxL || T % L != 0 || N % 4 != 0 || N < 4 ||
      N > kMaxN || Bt < 1 || H < 1 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch<float>(x, dt, A, B, C, y, h, Bt, T, H, P, N, L, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(x, dt, A, B, C, y, h, Bt,
                                                   T, H, P, N, L, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
