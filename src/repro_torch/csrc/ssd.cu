// Mamba2 SSD (state-space duality) chunk scan, hand-written for Hopper
// (sm_90a).
//
//   ssd_chunked_kernel       replaces repro/kernels/mamba2_ssd.py
//                            ssd_chunked (its Pallas body _kernel)
//   ssd_chunked_loop_kernel  the first version of it (one block walks every
//                            chunk in order on the CUDA cores), kept to
//                            be timed beside it; the wrapper never calls it
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
// 24 heads of P = 64, N = 128, L = 64) the function needs 2.29e8 float32
// flops (the causal half of C B^T once per chunk, the rest per head) on
// 2.65 MB of inputs and outputs: 3.4 us at the CUDA cores' 67 TFLOP/s,
// 0.8 us of memory. The loop kernel runs 96 blocks on 132 SMs, each walking
// the 4 chunks in order, recomputing C B^T per head and column tile (1.76x
// the useful flops) on the CUDA cores, with its loads in the open. What
// sets the time is the latency of each block's chain of steps, not a rate
// (tools/ssd_ab.py splits it).
//
// What ssd_chunked_kernel does about it:
//   * Chunks in parallel. One block owns (b, h, a tile of PT columns of P)
//     and a run of consecutive chunks; the runs of one (b, h, tile) form a
//     thread-block cluster of c <= 8 blocks (c and PT come from the shapes:
//     _build.ssd_plan). Each block first computes its run's local state
//     S = sum over its chunks of the state update from zero, and its decay
//     D = prod exp(s_L), with no dependence on other blocks, and publishes
//     them in its shared memory. After a cluster barrier the blocks run the
//     combine h_in(k) = sum_{j<k} (prod_{j<i<k} D_i) S_j together, each
//     over a c-th of the state's elements, reading every block's S and
//     writing every block's h_in through distributed shared memory (no
//     block reads all its predecessors' S alone); the same pass writes
//     h_out. After a second cluster barrier a run of
//     one chunk adds exp(s_t) C h_in to y; a longer run walks its chunks
//     again from h_in (a two-level scan: in order inside a run, across the
//     runs by the cluster). A cluster of one walks the whole sequence once.
//     One launch, a grid from static shapes only (a CUDA graph replays it).
//   * The four products (C B^T, the masked product with dt x, C h_in and
//     B^T diag(w) dt x) run on the tensor cores (mma.sync m16n8k16) as
//     bf16x3: each float32 operand is split once, when it reaches shared
//     memory, into bf16 planes a = hi + lo (lo = bf16(a - hi)), fed to the
//     mma by ldmatrix, and a b ~ hi hi' + (hi lo' + lo hi') with float32
//     accumulation. The dropped lo lo' and the rounding of lo are ~2^-16 of
//     a product: a twentieth of the float32 limits the port holds it to,
//     for float32 and bfloat16 x alike (one bf16 pass would miss them).
//     Split once, not in every warp that reads an operand, the conversions
//     stay off the products' path. kTensorCores = false puts the same warp
//     tiles on the CUDA cores (tools/ssd_ab.py times both).
//   * C B^T is recomputed by every block, on the tensor cores and over the
//     causal 16 x 16 tiles only: with PT = P one block serves a whole head,
//     so the product is made H times a chunk (24 at mamba2-130m's shape,
//     where the loop kernel makes it 96 times); left out entirely it saves
//     a tenth of the kernel's time on an H100 (tools/ssd_ab.py's no-CB), so
//     sharing it across the blocks of a chunk cannot pay more. A
//     resident chunk's masked C B^T and its product with dt x run while
//     the second cluster barrier waits for the combine's remote writes.
//   * 16 warps a block, each product cut into 16 x 16 warp tiles, for
//     short dependent chains; B, C, x and dt are all requested before any
//     is waited for, and the log-decay scan is one warp's shuffle scan.
// All math is float32, as the TPU kernel's preferred_element_type (the
// products at bf16x3's accuracy); x is float32 or bfloat16 and y takes x's
// type. exp arguments of the mask are clamped at 0, as in _kernel.
//
// Interface: plain C functions (loaded with ctypes) returning the
// cudaError_t of their launch. Pointers are device pointers; the stream is
// a cudaStream_t. dtype (of x and y): 0 = float32, 1 = bfloat16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // the loop kernel's block
constexpr int kMaxL = 64;     // longest chunk a block tiles
constexpr int kPT = 16;       // columns of P per block of the loop kernel
constexpr int kMaxN = 256;    // largest state size the kernels take
constexpr int kRows = kMaxL / (kThreads / kMaxL);   // C B^T rows a thread
constexpr int kNTile = kMaxN / (kThreads / 4);      // state rows a thread
constexpr int kMaxDevices = 64;   // devices whose smem attribute is cached
constexpr int kCThreads = 512;    // ssd_chunked_kernel's block: 16 warps
constexpr int kCWarps = kCThreads / 32;
constexpr int kMaxCluster = 8;    // the portable cluster size limit
constexpr int kSmemLimit = 232448;   // a block's dynamic shared memory

// ssd_chunked_kernel's products on the tensor cores (bf16x3, below), or
// with false as FMAs on the CUDA cores in the same warp tiles, from the
// same split operands (tools/ssd_ab.py times both).
constexpr bool kTensorCores = true;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// ------------------------------------------------------ ssd_chunked_kernel

// An operand in shared memory, split once into two bf16 planes, v = hi +
// lo (lo = the rounding error of hi), element (row, col) at row * ld + col.
// Rows are ld * 2 bytes apart, an odd multiple of 16, so the 8 row
// addresses of an ldmatrix hit 8 different bank groups.
struct Planes {
  bf16* hi;
  bf16* lo;
  int ld;
};

// Shared memory of ssd_chunked_kernel, in bytes (kernels/_build.py's
// ssd_smem_bytes computes the same): the split planes of C and B (64 rows
// of round16(N) + 8), dt x and exp(s_L - s_t) dt x (64 rows of PT + 8), the
// masked C B^T (64 x 72) and h_in (round16(N) rows of PT + 8); the float32
// run state S (round16(N) rows of PT + 4), published to the cluster; the
// scan's s_t, exp(s_t), exp(s_L - s_t) and the decays. Rows past L (and
// columns past N) are zero wherever a product reads them.
struct ChunkLayout {
  int np, ldp, ldx, lds, c, b, x, w, g, h, s, ss, es, se, dec, total;
  static constexpr int kLdg = kMaxL + 8;
  __host__ __device__ ChunkLayout(int N, int PT)
      : np(round16(N)),
        ldp(np + 8),
        ldx(PT + 8),
        lds(PT + 4),
        c(0),
        b(c + 2 * kMaxL * ldp * 2),
        x(b + 2 * kMaxL * ldp * 2),
        w(x + 2 * kMaxL * ldx * 2),
        g(w + 2 * kMaxL * ldx * 2),
        h(g + 2 * kMaxL * kLdg * 2),
        s(h + 2 * np * ldx * 2),
        ss(s + np * lds * 4),
        es(ss + kMaxL * 4),
        se(es + kMaxL * 4),
        dec(se + kMaxL * 4),
        total(dec + 16) {}
};

// (v0, v1) = hi + lo, each a bf16 pair (v0 in the lower half).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tc::pack_bf16(v0, v1);
  lo = tc::pack_bf16(v0 - __uint_as_float(hi << 16),
                     v1 - __uint_as_float(hi & 0xffff0000u));
}

// Stores (v0, v1) at (row, col) and (row, col + 1) of P, split.
__device__ __forceinline__ void put2(const Planes& P, int row, int col,
                                     float v0, float v1) {
  uint32_t hi, lo;
  split_bf16(v0, v1, hi, lo);
  *reinterpret_cast<uint32_t*>(P.hi + row * P.ld + col) = hi;
  *reinterpret_cast<uint32_t*>(P.lo + row * P.ld + col) = lo;
}

// Stores v at (row, col..col + 3) of P, split (8 bytes a plane).
__device__ __forceinline__ void put4(const Planes& P, int row, int col,
                                     float4 v) {
  uint2 hi, lo;
  split_bf16(v.x, v.y, hi.x, lo.x);
  split_bf16(v.z, v.w, hi.y, lo.y);
  *reinterpret_cast<uint2*>(P.hi + row * P.ld + col) = hi;
  *reinterpret_cast<uint2*>(P.lo + row * P.ld + col) = lo;
}

__device__ __forceinline__ float get(const bf16* p, int ld, int row,
                                     int col) {
  return __bfloat162float(p[row * ld + col]);
}

// The A fragments (mma m16n8k16) of the 16 x 16 tile at rows m0, depth k0
// of a plane stored (m, k), or with kT (k, m).
template <bool kT>
__device__ __forceinline__ void ld_a(uint32_t (&r)[4], const bf16* p, int ld,
                                     int m0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3, rr = l & 7;
  if constexpr (kT) {
    tc::ldsm_x4_t(r, p + (k0 + rr + 8 * (i >> 1)) * ld + m0 + 8 * (i & 1));
  } else {
    tc::ldsm_x4(r, p + (m0 + rr + 8 * (i & 1)) * ld + k0 + 8 * (i >> 1));
  }
}

// The B fragments of the two 8-column tiles n0, n0 + 8 at depth k0 (r[0],
// r[1] the first's, r[2], r[3] the second's) of a plane stored (n, k), or
// with kT (k, n).
template <bool kT>
__device__ __forceinline__ void ld_b(uint32_t (&r)[4], const bf16* p, int ld,
                                     int n0, int k0) {
  const int l = threadIdx.x & 31, i = l >> 3, rr = l & 7;
  if constexpr (kT) {
    tc::ldsm_x4_t(r, p + (k0 + rr + 8 * (i & 1)) * ld + n0 + 8 * (i >> 1));
  } else {
    tc::ldsm_x4(r, p + (n0 + rr + 8 * (i >> 1)) * ld + k0 + 8 * (i & 1));
  }
}

// acc += A B for the warp's 16 x 16 tile: rows m0 of A (K deep), columns
// n0 of B; K a multiple of 16. acc[i] holds the 8-column tile n0 + 8 i in
// mma m16n8k16's accumulator layout (lane l, g = l / 4, t = l % 4: rows g
// and g + 8, columns 2t and 2t + 1). On the tensor cores as bf16x3: hi hi'
// + (lo hi' + hi lo'), the small terms in an accumulator of their own (two
// chains of dependent mmas, not one of three), lo lo' dropped, so a
// product keeps ~2^-16 of its size where one bf16 pass would keep 2^-8.
template <bool kTA, bool kTB>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4], const Planes& A,
                                         int m0, const Planes& B, int n0,
                                         int K) {
  if constexpr (kTensorCores) {
    float small[2][4] = {};            // the small terms, summed apart
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      ld_a<kTA>(ah, A.hi, A.ld, m0, k0);
      ld_a<kTA>(al, A.lo, A.ld, m0, k0);
      ld_b<kTB>(bh, B.hi, B.ld, n0, k0);
      ld_b<kTB>(bl, B.lo, B.ld, n0, k0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tc::mma_bf16(small[i], al, bh[2 * i], bh[2 * i + 1]);
        tc::mma_bf16(small[i], ah, bl[2 * i], bl[2 * i + 1]);
        tc::mma_bf16(acc[i], ah, bh[2 * i], bh[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += small[i][q];
    }
  } else {
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
    auto a = [&](int r, int k) {
      const int row = kTA ? k : m0 + r, col = kTA ? m0 + r : k;
      return get(A.hi, A.ld, row, col) + get(A.lo, A.ld, row, col);
    };
    auto b = [&](int k, int n) {
      const int row = kTB ? k : n0 + n, col = kTB ? n0 + n : k;
      return get(B.hi, B.ld, row, col) + get(B.lo, B.ld, row, col);
    };
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float a0 = a(g, k), a1 = a(g + 8, k);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float b0 = b(k, 8 * i + 2 * t), b1 = b(k, 8 * i + 2 * t + 1);
        acc[i][0] = fmaf(a0, b0, acc[i][0]);
        acc[i][1] = fmaf(a0, b1, acc[i][1]);
        acc[i][2] = fmaf(a1, b0, acc[i][2]);
        acc[i][3] = fmaf(a1, b1, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One block of ssd_chunked_kernel: its shared memory, its (b, h, column
// tile) and the steps of a chunk. Every thread of the block calls each
// step. Each product is cut into 16 x 16 warp tiles.
template <typename T, int PT>
struct ChunkBlock {
  const ChunkLayout lay;
  Planes pC, pB, pX, pW, pG, pH;
  float *sS, *ss, *ses, *se, *sdec;
  const T* x;
  const float *dt, *Bm, *Cm;
  T* y;
  int T_len, H, P, N, L, Lp, b, h, p0;
  float Ah;
  int tid, warp, g, t4;

  __device__ ChunkBlock(unsigned char* smem, const T* x_, const float* dt_,
                        const float* A, const float* Bm_, const float* Cm_,
                        T* y_, int T_len_, int H_, int P_, int N_, int L_)
      : lay(N_, PT),
        x(x_), dt(dt_), Bm(Bm_), Cm(Cm_), y(y_),
        T_len(T_len_), H(H_), P(P_), N(N_), L(L_), Lp(round16(L_)) {
    auto planes = [&](int off, int rows, int ld) {
      bf16* p = reinterpret_cast<bf16*>(smem + off);
      return Planes{p, p + rows * ld, ld};
    };
    pC = planes(lay.c, kMaxL, lay.ldp);
    pB = planes(lay.b, kMaxL, lay.ldp);
    pX = planes(lay.x, kMaxL, lay.ldx);
    pW = planes(lay.w, kMaxL, lay.ldx);
    pG = planes(lay.g, kMaxL, ChunkLayout::kLdg);
    pH = planes(lay.h, lay.np, lay.ldx);
    sS = reinterpret_cast<float*>(smem + lay.s);
    ss = reinterpret_cast<float*>(smem + lay.ss);
    ses = reinterpret_cast<float*>(smem + lay.es);
    se = reinterpret_cast<float*>(smem + lay.se);
    sdec = reinterpret_cast<float*>(smem + lay.dec);
    const int tiles = (P + PT - 1) / PT;
    b = blockIdx.z;
    h = blockIdx.y / tiles;
    p0 = (blockIdx.y % tiles) * PT;
    Ah = A[h];
    tid = threadIdx.x;
    warp = tid >> 5;
    g = (tid & 31) >> 2;
    t4 = tid & 3;
  }

  __device__ int64_t row0(int j) const {
    return static_cast<int64_t>(b) * T_len + static_cast<int64_t>(j) * L;
  }

  // The dt x pairs of a thread: pair i is row (tid + i * kCThreads) /
  // (PT / 2), columns 2 ((tid + i * kCThreads) % (PT / 2)) and one more.
  static constexpr int kPairs = kMaxL * PT / 2 / kCThreads;

  // Chunk j into shared memory: B and C (read as float4 rows) and dt x of
  // the block's columns split into their planes, s, exp(s_t),
  // exp(s_L - s_t) and sdec[0] = exp(s_L) by warp 0's shuffle scan (all
  // reads issued before any is waited for), then the planes of
  // exp(s_L - s_t) dt x. Ends in a block barrier; the caller makes sure
  // the previous chunk's readers are done.
  __device__ void load(int j) {
    constexpr int kBatch = 4;   // float4 of B and of C in flight a thread
    const int64_t r0 = row0(j);
    const int n4 = lay.np / 4, total = kMaxL * n4;
    const float* gB = Bm + r0 * N;
    const float* gC = Cm + r0 * N;
    // Warp 0's two steps of dt for the scan, and every thread's dt x pairs.
    const int t0 = 2 * (tid & 31);
    float a0 = 0.f, a1 = 0.f;
    if (warp == 0) {
      if (t0 < L) a0 = dt[(r0 + t0) * H + h];
      if (t0 + 1 < L) a1 = dt[(r0 + t0 + 1) * H + h];
    }
    float dx[kPairs][2];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int e = tid + i * kCThreads, t = e / (PT / 2);
      const int p = p0 + 2 * (e % (PT / 2));
      dx[i][0] = dx[i][1] = 0.f;
      if (t < L) {
        const int64_t r = r0 + t;
        const float d = dt[r * H + h];
        const T* xr = x + (r * H + h) * P;
        if (p < P) dx[i][0] = d * to_float(xr[p]);
        if (p + 1 < P) dx[i][1] = d * to_float(xr[p + 1]);
      }
    }
    // B and C, kBatch float4 of each at a time, into their planes.
#pragma unroll 1
    for (int base = tid; base < total; base += kBatch * kCThreads) {
      float4 vb[kBatch], vc[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = base + q * kCThreads, r = i / n4, col = (i % n4) * 4;
        const bool live = i < total && r < L && col < N;
        const int64_t off = static_cast<int64_t>(r) * N + col;
        vb[q] = live ? *reinterpret_cast<const float4*>(gB + off)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        vc[q] = live ? *reinterpret_cast<const float4*>(gC + off)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = base + q * kCThreads, r = i / n4, col = (i % n4) * 4;
        if (i < total) {
          put4(pB, r, col, vb[q]);
          put4(pC, r, col, vc[q]);
        }
      }
    }
    // s = A cumsum(dt): warp 0, two steps a lane, a shuffle scan.
    if (warp == 0) {
      const unsigned full = 0xffffffffu;
      const int lane = tid;
      float incl = a0 + a1;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(full, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(full, incl, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const int last = L - 1;
      const float sl = Ah * __shfl_sync(full, (last & 1) ? c1 : c0,
                                        last >> 1);
      const float cs[2] = {c0, c1};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = t0 + q;
        const float s = Ah * cs[q];
        const bool live = t < L;
        ss[t] = live ? s : 0.f;
        ses[t] = live ? expf(s) : 0.f;
        se[t] = live ? expf(sl - s) : 0.f;
      }
      if (lane == 0) sdec[0] = expf(sl);
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int e = tid + i * kCThreads;
      put2(pX, e / (PT / 2), 2 * (e % (PT / 2)), dx[i][0], dx[i][1]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {  // pW = exp(s_L - s_t) dt x
      const int e = tid + i * kCThreads, t = e / (PT / 2);
      put2(pW, t, 2 * (e % (PT / 2)), se[t] * dx[i][0], se[t] * dx[i][1]);
    }
    __syncthreads();
  }

  // S = B^T diag(exp(s_L - s_t)) (dt x) over round16(N) rows (rows past N
  // come out zero), into sS (first) or as sS = exp(s_L) sS + S; with
  // `split`, sS is also written to pH. Warp w owns the tiles w, w + 16, ...
  __device__ void state(bool first, bool split) const {
    const float el = first ? 0.f : sdec[0];
    const int cols = PT / 16, tiles = lay.np / 16 * cols;
    for (int tile = warp; tile < tiles; tile += kCWarps) {
      const int m0 = tile / cols * 16, n0 = tile % cols * 16;
      float acc[2][4] = {};
      tile_mma<true, true>(acc, pB, m0, pW, n0, Lp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + g + 8 * hf, col = n0 + 8 * i + 2 * t4;
          float2* d = reinterpret_cast<float2*>(sS + row * lay.lds + col);
          float2 v = make_float2(acc[i][2 * hf], acc[i][2 * hf + 1]);
          if (!first) {
            const float2 o = *d;
            v.x = fmaf(el, o.x, v.x);
            v.y = fmaf(el, o.y, v.y);
          }
          *d = v;
          if (split) put2(pH, row, col, v.x, v.y);
        }
      }
    }
  }

  // pG = (C B^T) o M over the causal 16 x 16 tiles: warp w owns rows
  // 16 (w / 4) and columns 16 (w % 4); tiles above the diagonal are
  // skipped (the products below never read them), entries past L are zero.
  __device__ void mask() const {
    const int m0 = (warp >> 2) * 16, n0 = (warp & 3) * 16;
    if (m0 >= Lp || n0 > m0) return;
    float acc[2][4] = {};
    tile_mma<false, false>(acc, pC, m0, pB, n0, lay.np);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = m0 + g + 8 * hf, u = n0 + 8 * i + 2 * t4;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v[q] = u + q <= t && t < L
                     ? acc[i][2 * hf + q] * expf(fminf(ss[t] - ss[u + q], 0.f))
                     : 0.f;
        }
        put2(pG, t, u, v[0], v[1]);
      }
    }
  }

  // The warp's y tile: rows 16 (w % 4), columns 16 (w / 4).
  __device__ bool out_tile(int& m0, int& n0) const {
    m0 = (warp & 3) * 16;
    n0 = (warp >> 2) * 16;
    return n0 < PT && m0 < Lp;
  }

  // acc = pG (dt x) for the warp's y tile; the masked product stops at the
  // diagonal.
  __device__ void intra(float (&acc)[2][4]) const {
    int m0, n0;
    if (!out_tile(m0, n0)) return;
    tile_mma<false, true>(acc, pG, m0, pX, n0, min(Lp, m0 + 16));
  }

  // y of chunk j = acc + exp(s_t) (C h_in), the second term only when
  // `inter` (h_in is not zero).
  __device__ void out(int j, const float (&acc)[2][4], bool inter) const {
    int m0, n0;
    if (!out_tile(m0, n0)) return;
    float acc2[2][4] = {};
    if (inter) tile_mma<false, true>(acc2, pC, m0, pH, n0, lay.np);
    const int64_t r0 = row0(j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = m0 + g + 8 * (q >> 1);
        const int p = p0 + n0 + 8 * i + 2 * t4 + (q & 1);
        if (t < L && p < P) {
          store(y + ((r0 + t) * H + h) * P + p,
                fmaf(ses[t], acc2[i][q], acc[i][q]));
        }
      }
    }
  }
};

// grid (c, H * ceil(P / PT), Bt) in clusters of (c, 1, 1), 512 threads.
// Block k of a cluster takes chunks [k n / c, (k + 1) n / c) of the n =
// T / L chunks of its (b, h, column tile).
template <typename T, int PT>
__global__ void __launch_bounds__(kCThreads, 1)
ssd_chunked_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, T* __restrict__ y,
                   float* __restrict__ hout, int T_len, int H, int P, int N,
                   int L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  using Block = ChunkBlock<T, PT>;
  Block blk(reinterpret_cast<unsigned char*>(smem), x, dt, A, Bm, Cm, y,
            T_len, H, P, N, L);
  const ChunkLayout& lay = blk.lay;
  const int nck = T_len / L, tid = threadIdx.x, q4 = PT / 4;
  const int j0 = static_cast<int>(static_cast<int64_t>(k) * nck / c);
  const int j1 = static_cast<int>(static_cast<int64_t>(k + 1) * nck / c);
  const bool resident = j1 - j0 == 1;  // the run's one chunk stays loaded
  float* hrow = hout + (static_cast<int64_t>(blk.b) * H + blk.h) * N * P
                + blk.p0;

  if (c > 1) {
    // (1) The run's local state S (in sS) and decay D (sdec[1]).
    float D = 1.f;                     // thread 0's product of exp(s_L)
    for (int j = j0; j < j1; ++j) {
      if (j > j0) __syncthreads();     // the last chunk's readers are done
      blk.load(j);
      if (tid == 0) D *= blk.sdec[0];
      blk.state(j == j0, false);
    }
    if (j1 == j0) {                    // no chunk (c > T / L): S = 0
      for (int i = tid; i < lay.np * lay.lds; i += kCThreads) {
        blk.sS[i] = 0.f;
      }
    }
    if (tid == 0) blk.sdec[1] = D;
    cluster_arrive_release();          // S and D are published
    cluster_wait();

    // (2) The combine, spread over the cluster: block k takes the k-th
    // c-th of the state's elements and, for each, runs h_in of block r =
    // sum over r' < r of (prod_{r'<i<r} D_i) S_r' up the cluster, writing
    // it into block r's pH, and h_out = D_{c-1} h_in + S_{c-1} to memory.
    float dec[kMaxCluster];
    const float* S[kMaxCluster];
    Planes hin[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c) {
        dec[r] = *cluster.map_shared_rank(blk.sdec + 1, r);
        S[r] = cluster.map_shared_rank(blk.sS, r);
        hin[r] = Planes{cluster.map_shared_rank(blk.pH.hi, r),
                        cluster.map_shared_rank(blk.pH.lo, r), blk.pH.ld};
      }
    }
    const int elems = lay.np * q4;
    const int e1 = static_cast<int>(static_cast<int64_t>(k + 1) * elems / c);
    for (int e = static_cast<int>(static_cast<int64_t>(k) * elems / c) + tid;
         e < e1; e += kCThreads) {
      const int n = e / q4, p = (e - n * q4) * 4;
      float4 sv[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {   // all reads in flight
        if (r < c) {
          sv[r] = *reinterpret_cast<const float4*>(S[r] + n * lay.lds + p);
        }
      }
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < c) {
          put4(hin[r], n, p, hv);
          hv.x = fmaf(dec[r], hv.x, sv[r].x);
          hv.y = fmaf(dec[r], hv.y, sv[r].y);
          hv.z = fmaf(dec[r], hv.z, sv[r].z);
          hv.w = fmaf(dec[r], hv.w, sv[r].w);
        }
      }
      if (n < N) {
        const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (blk.p0 + p + q < P) hrow[n * P + p + q] = hq[q];
        }
      }
    }
    cluster_arrive_release();
    // While the other blocks' writes land: a resident chunk's masked C B^T
    // and its product with dt x, which do not need h_in.
    float acc[2][4] = {};
    if (resident) {
      blk.mask();
      __syncthreads();
      blk.intra(acc);
    }
    cluster_wait();                    // every h_in is written, no S read

    // (3) y of the resident chunk from h_in; a longer run is walked again
    // below from h_in, carried in sS.
    if (resident) {
      blk.out(j0, acc, j0 > 0);
      return;
    }
    for (int i = tid; i < lay.np * PT; i += kCThreads) {
      const int n = i / PT, p = i % PT, e = n * blk.pH.ld + p;
      blk.sS[n * lay.lds + p] = __bfloat162float(blk.pH.hi[e])
                                + __bfloat162float(blk.pH.lo[e]);
    }
  }

  // The run in order from the state carried in sS (zero at chunk 0, where
  // h_in is not read); with one block (c = 1) the whole sequence, which
  // ends by writing h_out from the carry.
  for (int j = j0; j < j1; ++j) {
    __syncthreads();                   // the last chunk's readers are done
    blk.load(j);
    blk.mask();
    __syncthreads();
    float run[2][4] = {};
    blk.intra(run);
    blk.out(j, run, j > 0);
    if (j + 1 < j1 || c == 1) {
      __syncthreads();
      blk.state(j == 0, true);
    }
  }
  if (c == 1) {
    __syncthreads();
    for (int i = tid; i < N * PT; i += kCThreads) {
      const int n = i / PT, p = i % PT;
      if (blk.p0 + p < P) hrow[n * P + p] = blk.sS[n * lay.lds + p];
    }
  }
}

// ------------------------------------------------- ssd_chunked_loop_kernel

// Shared-memory layout of the loop kernel, in floats. Row strides: C N + 4
// (16-byte rows for float4 reads), B N + 1 (odd: a warp reading one column
// of 32 rows hits 32 banks), C B^T L + 1.
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
ssd_chunked_loop_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
cudaError_t launch_loop(const void* x, const void* dt, const void* A,
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
    err = cudaFuncSetAttribute(ssd_chunked_loop_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (seen != nullptr) *seen = bytes;
  }
  const dim3 grid((P + kPT - 1) / kPT, H, Bt);
  ssd_chunked_loop_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<T*>(y),
      static_cast<float*>(h), T_len, H, P, N, L);
  return cudaGetLastError();
}


// ------------------------------------------------------------- launchers

// Allows `kernel` the largest dynamic shared memory, once per device (not
// a stream operation: the first, eager call sets it, before any capture
// into a CUDA graph).
template <auto kernel>
cudaError_t allow_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int PT>
cudaError_t launch_chunks(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, void* y, void* h,
                          int Bt, int T_len, int H, int P, int N, int L,
                          int c, cudaStream_t st) {
  const size_t bytes = ChunkLayout(N, PT).total;
  if (bytes > static_cast<size_t>(kSmemLimit) ||
      static_cast<int64_t>(H) * ((P + PT - 1) / PT) > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem<ssd_chunked_kernel<T, PT>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, H * ((P + PT - 1) / PT), Bt);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, ssd_chunked_kernel<T, PT>, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<T*>(y), static_cast<float*>(h), T_len, H, P, N, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int pt, const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y, void* h,
                        int Bt, int T_len, int H, int P, int N, int L, int c,
                        cudaStream_t st) {
  switch (pt) {
    case 16:
      return launch_chunks<T, 16>(x, dt, A, B, C, y, h, Bt, T_len, H, P, N,
                                  L, c, st);
    case 32:
      return launch_chunks<T, 32>(x, dt, A, B, C, y, h, Bt, T_len, H, P, N,
                                  L, c, st);
    case 64:
      return launch_chunks<T, 64>(x, dt, A, B, C, y, h, Bt, T_len, H, P, N,
                                  L, c, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int Bt, int T, int H, int P, int N, int L) {
  return L < 1 || L > kMaxL || T % L != 0 || N % 4 != 0 || N < 4 ||
         N > kMaxN || Bt < 1 || Bt > 65535 || H < 1 || P < 1;
}

}  // namespace

extern "C" {

// x (Bt, T, H, P) float32 | bfloat16; dt (Bt, T, H), A (H,), B and C
// (Bt, T, N) float32, B and C 16-byte aligned -> y (Bt, T, H, P) in x's
// type, h (Bt, H, N, P) float32. L is the chunk length: 1 <= L <= 64,
// T % L == 0, N % 4 == 0, N <= 256; c (the cluster) in {1, 2, 4, 8}, pt
// (columns of P a block) in {16, 32, 64} with the shared memory within
// 227 KB (kernels/_build.py's ssd_plan picks both). Anything else returns
// cudaErrorInvalidValue unlaunched.
int repro_ssd_chunked(int dtype, const void* x, const void* dt,
                      const void* A, const void* B, const void* C, void* y,
                      void* h, int Bt, int T, int H, int P, int N, int L,
                      int c, int pt, void* stream) {
  if (bad_shape(Bt, T, H, P, N, L) || c < 1 || c > kMaxCluster ||
      (c & (c - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_tile<float>(pt, x, dt, A, B, C, y, h, Bt,
                                               T, H, P, N, L, c, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_tile<__nv_bfloat16>(
        pt, x, dt, A, B, C, y, h, Bt, T, H, P, N, L, c, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same function through ssd_chunked_loop_kernel (the first version: one
// block per (b, h, 16 columns) walking the chunks in order).
int repro_ssd_chunked_loop(int dtype, const void* x, const void* dt,
                           const void* A, const void* B, const void* C,
                           void* y, void* h, int Bt, int T, int H, int P,
                           int N, int L, void* stream) {
  if (bad_shape(Bt, T, H, P, N, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch_loop<float>(x, dt, A, B, C, y, h, Bt, T, H, P, N, L, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_loop<__nv_bfloat16>(
        x, dt, A, B, C, y, h, Bt, T, H, P, N, L, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
