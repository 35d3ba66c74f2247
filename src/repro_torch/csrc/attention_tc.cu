// Prompt-prefill attention on the tensor cores, hand-written for Hopper
// (sm_90a), for bfloat16 inputs.
//
//   flash_attention_tc_kernel  replaces repro/kernels/flash_attention.py
//                              flash_attention (causal or not, GQA) for
//                              bf16; float32 inputs stay on the CUDA-core
//                              flash_attention_kernel of attention.cu (the
//                              wrapper picks by dtype: TF32 would not hold
//                              float32's parity checks)
//
// What it computes: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), Hq a
// multiple of Hkv; query row i sits at position Skv - Sq + i and, with
// causal, sees keys pos <= Skv - Sq + i; a row that sees no key outputs
// zeros. Output (B, Sq, Hq, D) in bf16, softmax and sums in float32.
//
// What bounds it on an H100. A 256-token prompt of tinyllama-1.1b (32/4
// heads of 64) is 268 MFLOP causal on 4.7 MB of q, k, v and out: 0.27 us
// at the bf16 tensor-core peak, 1.4 us for the bytes, so the limit is
// latency and how well the grid fills the card, not a peak rate. The
// CUDA-core kernel it replaces ran 512 blocks of 2 query rows, each loading
// the visible K/V again as float32 and scoring it with scalar FMAs.
//
// What the design does about it:
//   * One block per (64 (query row, head-in-group) pairs, KV head, batch).
//     The GQA group is packed into the 64 rows of the block's tile (pair m
//     is row m / G, head m % G), so one K/V tile in shared memory serves
//     the whole group; the causal limit of a pair is its own query row's.
//     tinyllama: 2048 pairs per KV head, 32 x 4 = 128 blocks; moonshot
//     (group 1, D 128): 4 x 16 = 64 blocks. Tiles of the last rows (the
//     longest causal walks) are issued first.
//   * K and V stay bf16: tiles of 64 keys reach shared memory by cp.async,
//     16 bytes a thread, in two stages (the next tile is in flight while
//     this one is multiplied). Rows are padded by 16 bytes, so the
//     ldmatrix reads of 8 rows hit 8 different bank groups. Tiles past the
//     block's last visible key are never loaded; only tiles that cross the
//     diagonal of the block's first row (or the end of the keys) are
//     masked.
//   * S = Q K^T and O += P V run on the tensor cores: mma.sync m16n8k16,
//     bf16 in, float32 accumulate, one warp per 16 rows. mma.sync, not
//     wgmma: at these shapes the work is a few hundred MFLOP and the
//     limit is latency and fill, which a 64-row warpgroup product would
//     not move; mma.sync keeps the softmax in the accumulator's registers.
//     Q's fragments are loaded once (ldmatrix), K's by ldmatrix, V's by
//     ldmatrix.trans.
//   * Online softmax in registers, FA2 style: the running max and sum of
//     each row live with the 4 lanes (a quad) that hold it, reduced by quad
//     shuffles; P is rounded to bf16 and repacked from the S accumulators
//     into A fragments without touching shared memory. The row sums add the
//     rounded P, so the weights of every output row sum to one.
//
// Interface: a plain C function (loaded with ctypes) returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;             // (query row, head) pairs per block
constexpr int kBN = 64;             // keys per K/V tile
constexpr int kWarps = kBM / 16;    // one warp per 16 pairs
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;             // bf16 elements of padding per row

template <int D>
constexpr size_t smem_bytes() {     // Q tile + two stages of K and V
  return static_cast<size_t>(kBM + 4 * kBN) * (D + kPad) * sizeof(bf16);
}

// grid (ceil(Sq * G / 64), Hkv, B), 128 threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int Sq, int Skv, int Hq, int Hkv, int causal,
                          float scale_log2) {
  constexpr int LD = D + kPad;      // shared-memory row, in elements
  constexpr int CH = D / 8;         // 16-byte chunks of a row
  constexpr int KS = D / 16;        // k-steps of Q K^T
  constexpr int NT = kBN / 8;       // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBM][LD]
  bf16* ks = qs + kBM * LD;                        // [2][kBN][LD]
  bf16* vs = ks + 2 * kBN * LD;                    // [2][kBN][LD]

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int M = Sq * G;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int shift = Skv - Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int first_row = m0 / G;
  const int last_row = (min(m0 + kBM, M) - 1) / G;
  // keys [0, kv_end) are visible to some row; [0, full_end) to every row
  const int kv_end = causal ? min(Skv, last_row + shift + 1) : Skv;
  const int full_end = causal ? min(Skv, first_row + shift + 1) : Skv;

  // pair m of this (batch, KV head) at q_base + (m / G) * Hq * D + (m % G) * D
  const int64_t q_base =
      (static_cast<int64_t>(b) * Sq * Hq + static_cast<int64_t>(hk) * G) * D;
  const int64_t kv_base = (static_cast<int64_t>(b) * Skv * Hkv + hk) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  auto pair_off = [&](int m) {
    return q_base + static_cast<int64_t>(m / G) * Hq * D
           + static_cast<int64_t>(m % G) * D;
  };

  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8, m = m0 + r;
    const bool ok = m < M;                         // else a zero row
    tc::cp_async16(qs + r * LD + c, q + (ok ? pair_off(m) + c : 0),
                   ok ? 16 : 0);
  }
  auto load_kv = [&](int tile, int stage) {
    bf16* kd = ks + stage * kBN * LD;
    bf16* vd = vs + stage * kBN * LD;
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8, pos = tile * kBN + r;
      const bool ok = pos < kv_end;                // else a zero row
      const int64_t off = ok ? kv_base + pos * kv_stride + c : 0;
      tc::cp_async16(kd + r * LD + c, k + off, ok ? 16 : 0);
      tc::cp_async16(vd + r * LD + c, v + off, ok ? 16 : 0);
    }
  };
  const int n_tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;
  if (n_tiles > 0) load_kv(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KS][4];               // this warp's 16 Q rows, A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    tc::ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16
                            + (lane >> 4) * 8);

  // This lane's two rows: pairs mA (h = 0) and mA + 8 (h = 1).
  const int mA = m0 + warp * 16 + (lane >> 2);
  const int lim[2] = {causal ? mA / G + shift : INT_MAX,
                      causal ? (mA + 8) / G + shift : INT_MAX};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};
  float lrow[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      tc::cp_async_wait<0>();       // tile j has landed
      __syncthreads();              // ... and tile j - 1's stage is free
    }
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) & 1);
    tc::cp_async_commit();
    const bf16* kt = ks + (j & 1) * kBN * LD;
    const bf16* vt = vs + (j & 1) * kBN * LD;

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        tc::ldsm_x4(r, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD
                           + kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    const int t0 = j * kBN;
    const bool masked = t0 + kBN > full_end;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int pos = t0 + nt * 8 + (lane & 3) * 2 + (e & 1);
          if (pos >= Skv || pos > lim[e >> 1]) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax, one row (h) at a time; exp2 of scores pre-scaled by
    // scale * log2(e).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(mrow[h] - m_use);   // -inf -> 0
      mrow[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = __bfloat162float(
              __float2bfloat16(exp2f(s[nt][e] - m_use)));
          s[nt][e] = p;
          sum += p;
        }
      }
      lrow[h] = lrow[h] * corr + sum;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * h] *= corr;
        o[dt][2 * h + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                                  * LD
                             + dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dp], a, r[0], r[1]);
        tc::mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrow[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;     // no visible key -> 0
    const int m = mA + 8 * h;
    if (m >= M) continue;
    bf16* dst = out + pair_off(m) + (lane & 3) * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                   float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB a block needs the opt-in; set once per head dim, before
  // any capture into a CUDA graph can start.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int M = Sq * (Hq / Hkv);
  const dim3 grid((M + kBM - 1) / kBM, Hkv, B);
  flash_attention_tc_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, Hq, Hkv,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v, out, contiguous, 16-byte aligned; D in {16, 32, 64, 128};
// B, Sq, Hkv >= 1, Skv >= 0. Anything else returns cudaErrorInvalidValue
// unlaunched.
int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Skv, int Hq,
                             int Hkv, int D, int causal, float scale,
                             void* stream) {
  if (B < 1 || Sq < 1 || Skv < 0 || Hkv < 1 || Hq % Hkv != 0 ||
      B > 65535 || Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, st); break;
    case 32: err = launch<32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, st); break;
    case 64: err = launch<64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, st); break;
    case 128: err = launch<128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
