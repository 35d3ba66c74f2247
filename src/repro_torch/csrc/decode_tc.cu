// Decode attention (one query token per slot) on the tensor cores,
// hand-written for Hopper (sm_90a), for bfloat16 inputs.
//
//   flash_decode_tc_kernel  replaces repro/kernels/flash_decode.py
//                           flash_decode (contiguous (B, S, Hkv, D) cache)
//   paged_decode_tc_kernel  replaces repro/kernels/paged_decode.py
//                           paged_decode ((NB, Bs, Hkv, D) pools through
//                           block tables)
// for bf16; float32 inputs stay on the CUDA-core flash_decode_kernel /
// paged_decode_kernel of attention.cu (the wrappers pick by dtype: TF32
// would not hold float32's parity checks).
//
// What it computes: q (B, 1, Hq, D), Hq = G * Hkv; slot b attends to keys
// [0, min(max(lengths[b], 0), S)) of its cache (S = max_blocks * Bs for
// the pools; table entries past the allocation are clamped into the pool
// and never read, being past the window); a slot with no key writes exact
// zeros. Softmax and sums in float32, output in bf16.
//
// What bounds it on an H100. Decode reads every visible K/V row once and
// does 4 * D flops per row and query head: ~G flops per byte, far below
// the ~295 the tensor cores need, so the bound is the bytes of K/V. At
// the serving shapes (8 slots of 100-384 keys; tinyllama-1.1b 32/4 heads
// of 64, moonshot-v1-16b-a3b 16/16 heads of 128) that is 1-4 MB, about a
// microsecond at 3.35 TB/s, so what sets the time is latency: how many
// SMs the grid keeps busy and how many dependent memory round trips a
// block waits for. The CUDA-core kernels it replaces ran one block per
// (slot, KV head), 32 blocks for tinyllama (one warp each for moonshot),
// walking the whole window with synchronous float32 tile copies.
//
// What the design does about it:
//   * Split-KV inside one launch. A (slot, KV head, 16-head slice of the
//     group) is served by a thread-block cluster of c <= 8 blocks. The
//     wrapper picks c from the static shapes: the largest that keeps the
//     grid within two blocks per SM, one wave (c 8 for tinyllama's 32
//     (slot, KV head) pairs, 2 for moonshot's 128; on the card a second
//     wave cost more than the longer shares it saves). Each block reads
//     lengths[b] on the device and takes its contiguous share (a multiple
//     of 16 keys) of the window, so the work follows the true lengths,
//     not the cache size, with no host sync. The blocks merge their
//     partial softmax states (m, l, acc) through distributed shared memory
//     after a cluster barrier; a block with an empty share publishes
//     m = -inf, l = 0 and still reaches the barriers. No second kernel, no
//     global workspace.
//   * Inside a block, 4 warps take 16 keys each of every 64-key tile and
//     merge through shared memory before the cluster merge.
//   * K and V stay bf16: tiles reach shared memory by cp.async, 16 bytes a
//     thread, in a ring of two tiles (the next tile is in flight while
//     this one is scored; a third stage measured no faster). Rows are
//     padded by 16 bytes so the ldmatrix reads of 8 rows hit 8 different
//     bank groups. A tile's row addresses are computed once per key (one
//     thread each; the paged form divides by the block size and reads the
//     table there), not once per 16-byte copy. Rows past the window are
//     zero-filled, not read.
//   * S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16,
//     bf16 in, float32 accumulate): the group's query heads are the rows
//     of the 16-row A tile (8 of 16 used for tinyllama, 6 for qwen2; the
//     unused rows cost registers only, decode being bound by bytes). A
//     group above 16 heads takes more 16-row slices along the grid's y.
//     A group of one (moonshot) is scored on the CUDA cores instead at D
//     64 and 128, two lanes a key and D / 32 output columns a lane, which
//     measured faster than a 1-of-16-row tile (kCoreScoringG1). D 112
//     (zamba2, also a group of one) does not split into 32 lanes of bf16
//     pairs and is scored on the tensor cores at every group.
//   * Online softmax in registers as in attention_tc.cu: scores
//     pre-scaled by scale * log2(e); on the tensor cores P is rounded to
//     bf16 once and repacked from the S accumulators into A fragments
//     without a shuffle, the row sums adding the rounded P; on the CUDA
//     cores P stays float32.
//
// Interface: plain C functions (loaded with ctypes), each returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;            // query heads per block: the mma's M
constexpr int kBN = 16 * kWarps;     // keys per tile, 16 per warp
constexpr int kPad = 8;              // bf16 elements of padding per row
constexpr int kMaxCluster = 8;       // the portable cluster size limit
constexpr int kShareAlign = 16;      // a block's share: whole 16-key steps
constexpr int kStages = 2;           // tiles in the K/V rings

// Q tile + K and V rings.
template <int D>
__host__ __device__ constexpr size_t ring_bytes() {
  return static_cast<size_t>(kRows + 2 * kStages * kBN) * (D + kPad)
         * sizeof(bf16);
}

// + the ring's row offsets.
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<D>() + kStages * kBN * sizeof(int64_t);
}

// The merge's floats (per-warp and published partials) reuse the K/V
// rings once the last tile is consumed.
template <int D>
__host__ __device__ constexpr size_t merge_bytes() {
  return ((kWarps + 1) * kRows * D + (2 * kWarps + 2) * kRows)
         * sizeof(float);
}

// The scoring of a group of one query head (D >= 64) on the CUDA cores:
// lane l scores key l % 16 over half l / 16 of the head dim, and P V takes
// D / 32 columns a lane, P kept in float32. Folds one warp's 16 keys
// (tiles kt, vt in shared memory; key kb first, keys >= hi masked) into
// the running (m, l, acc) of the single query row, whose half q_half this
// lane holds as bf16 pairs.
template <int D>
__device__ __forceinline__ void score_g1_core(
    const uint32_t (&q_half)[D / 4], const bf16* kt, const bf16* vt, int kb,
    int hi, float scale_log2, float& m, float& l, float (&acc)[D / 32]) {
  const int lane = threadIdx.x & 31, key = lane & 15;
  const uint4* kr = reinterpret_cast<const uint4*>(
      kt + key * (D + kPad) + (lane >> 4) * (D / 2));
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const uint4 x = kr[c];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q_half[4 * c + e]));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      dot = fmaf(a.x, b.x, fmaf(a.y, b.y, dot));
    }
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 16);
  const float x = kb + key < hi ? dot * scale_log2 : -INFINITY;
  float mx = x;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_new = fmaxf(m, mx);        // key kb is visible: finite
  const float corr = exp2f(m - m_new);     // -inf -> 0
  const float p = exp2f(x - m_new);
  float sum = p;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  m = m_new;
  l = l * corr + sum;
  constexpr int CPL = D / 32;              // columns a lane
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] *= corr;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float pk = __shfl_sync(0xffffffffu, p, k);
    const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(
        vt + k * (D + kPad) + lane * CPL);
#pragma unroll
    for (int i = 0; i < CPL / 2; ++i) {
      const float2 f = __bfloat1622float2(vr[i]);
      acc[2 * i] += pk * f.x;
      acc[2 * i + 1] += pk * f.y;
    }
  }
}

// The scoring of up to 16 query heads on the tensor cores: S = Q K^T and
// O += P V by mma.sync m16n8k16, one warp's 16 keys (tiles kt, vt in
// shared memory; key kb first, keys >= hi masked) folded into the running
// (m, l, o) of rows g and g + 8 (g = lane / 4; l summed over the quad
// later). P is rounded to bf16 once; the row sums add the rounded P.
template <int D>
__device__ __forceinline__ void score_tc(
    const uint32_t (&qf)[D / 16][4], const bf16* kt, const bf16* vt, int kb,
    int hi, float scale_log2, float (&mrow)[2], float (&lrow)[2],
    float (&o)[D / 8][4]) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;
  const int lane = threadIdx.x & 31;
  float s[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t r[4];
    tc::ldsm_x4(r, kt + ((lane >> 4) * 8 + (lane & 7)) * LD + kk * 16
                       + ((lane >> 3) & 1) * 8);
    tc::mma_bf16(s[0], qf[kk], r[0], r[1]);
    tc::mma_bf16(s[1], qf[kk], r[2], r[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = kb + nt * 8 + (lane & 3) * 2 + (e & 1);
      s[nt][e] = pos < hi ? s[nt][e] * scale_log2 : -INFINITY;
    }
  }
  // Every row sees the same keys and key kb < hi is visible, so each
  // row's maximum is finite.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                     fmaxf(s[1][2 * h], s[1][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(mrow[h], mx);
    const float corr = exp2f(mrow[h] - m_new);   // -inf -> 0
    mrow[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = __bfloat162float(
            __float2bfloat16(exp2f(s[nt][e] - m_new)));
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
  const uint32_t a[4] = {tc::pack_bf16(s[0][0], s[0][1]),
                         tc::pack_bf16(s[0][2], s[0][3]),
                         tc::pack_bf16(s[1][0], s[1][1]),
                         tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t r[4];
    tc::ldsm_x4_t(r, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD
                         + dp * 16 + (lane >> 4) * 8);
    tc::mma_bf16(o[2 * dp], a, r[0], r[1]);
    tc::mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
  }
}

// K/V row addressing: element offset of the (pos, kv-head) row.
struct DenseRows {         // (B, S, Hkv, D) contiguous cache
  int64_t base;            // offset of (b, pos 0, head)
  int64_t stride;          // Hkv * D
  __device__ int64_t operator()(int pos) const {
    return base + static_cast<int64_t>(pos) * stride;
  }
};

struct PagedRows {         // (NB, Bs, Hkv, D) pool through a block table
  const int* table;        // this slot's row of block_tables
  int block_size;
  int num_blocks;
  int64_t head_off;        // head * D
  int64_t row_stride;      // Hkv * D
  __device__ int64_t operator()(int pos) const {
    // Garbage entries past the allocation are clamped into the pool; only
    // positions inside the window get here.
    int phys = table[pos / block_size];
    phys = min(max(phys, 0), num_blocks - 1);
    return (static_cast<int64_t>(phys) * block_size + pos % block_size)
               * row_stride + head_off;
  }
};

// One block of a cluster: the query heads [q_base, q_base + rows_live * D)
// of one slot and KV head against that slot's keys [0, n), scored on the
// tensor cores or, with kCore (rows_live 1), on the CUDA cores. Every
// thread of every block of the cluster must call it.
template <int D, bool kCore, class Rows>
__device__ __forceinline__ void decode_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int64_t q_base,
    int rows_live, int n, Rows rows, float scale_log2) {
  constexpr int LD = D + kPad;      // shared-memory row, in elements
  constexpr int CH = D / 8;         // 16-byte chunks of a row
  constexpr int KS = D / 16;        // k-steps of Q K^T
  constexpr int S = kStages;
  static_assert(merge_bytes<D>() <= ring_bytes<D>() - kRows * LD * 2,
                "the merge must fit in the K/V rings");
  static_assert(!kCore || D >= 64, "CUDA-core scoring takes D >= 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);      // [kRows][LD]
  bf16* ks = qs + kRows * LD;                          // [S][kBN][LD]
  bf16* vs = ks + S * kBN * LD;                        // [S][kBN][LD]
  int64_t* roff = reinterpret_cast<int64_t*>(vs + S * kBN * LD);  // [S][kBN]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool ok = r < rows_live;                 // else a zero row
    tc::cp_async16(qs + r * LD + col, q + (ok ? q_base + r * D + col : 0),
                   ok ? 16 : 0);
  }
  tc::cp_async_commit();

  // This block's share of the window: keys [lo, hi).
  const int share = ((n + c - 1) / c + kShareAlign - 1) / kShareAlign
                    * kShareAlign;
  const int lo = min(n, rank * share);
  const int hi = min(n, lo + share);
  const int n_tiles = (hi - lo + kBN - 1) / kBN;

  auto fill_offsets = [&](int tile) {   // one thread per key of the tile
    if (tile < n_tiles && tid < kBN) {
      const int pos = lo + tile * kBN + tid;
      roff[(tile % S) * kBN + tid] = pos < hi ? rows(pos) : -1;
    }
  };
  auto load_tile = [&](int tile) {
    if (tile >= n_tiles) return;
    const int st = tile % S;
    bf16* kd = ks + st * kBN * LD;
    bf16* vd = vs + st * kBN * LD;
    const int64_t* ro = roff + st * kBN;
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, col = (i % CH) * 8;
      const int64_t off = ro[r];
      const bool ok = off >= 0;                    // else a zero row
      tc::cp_async16(kd + r * LD + col, k + (ok ? off + col : 0),
                     ok ? 16 : 0);
      tc::cp_async16(vd + r * LD + col, v + (ok ? off + col : 0),
                     ok ? 16 : 0);
    }
  };

  for (int t = 0; t < S - 1; ++t) fill_offsets(t);
  __syncthreads();
  for (int t = 0; t < S - 1; ++t) {
    load_tile(t);
    tc::cp_async_commit();
  }

  uint32_t q_half[kCore ? D / 4 : 1];    // CUDA cores: bf16 pairs
  float acc[kCore ? D / 32 : 1] = {};     // CUDA cores: this lane's columns
  uint32_t qf[KS][4];               // tensor cores: the 16 query rows
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float lrow[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    // Tile j + S - 1 goes to the stage of tile j - 1; its offsets' slot
    // was last read when tile j - 1 was issued, S - 1 barriers ago.
    fill_offsets(j + S - 1);
    tc::cp_async_wait<S - 2>();     // Q and tile j have landed
    __syncthreads();                // ... for every thread; j - 1 is done
    load_tile(j + S - 1);
    tc::cp_async_commit();
    if (j == 0) {
      if constexpr (kCore) {
        const uint32_t* qr =
            reinterpret_cast<const uint32_t*>(qs + (lane >> 4) * (D / 2));
#pragma unroll
        for (int i = 0; i < D / 4; ++i) q_half[i] = qr[i];
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tc::ldsm_x4(qf[kk], qs + (lane & 15) * LD + kk * 16
                                  + (lane >> 4) * 8);
      }
    }
    const int kb = lo + j * kBN + warp * 16;       // this warp's 16 keys
    if (kb >= hi) continue;
    const bf16* kt = ks + (j % S) * kBN * LD + warp * 16 * LD;
    const bf16* vt = vs + (j % S) * kBN * LD + warp * 16 * LD;
    if constexpr (kCore) {
      score_g1_core<D>(q_half, kt, vt, kb, hi, scale_log2, mrow[0], lrow[0],
                       acc);
    } else {
      score_tc<D>(qf, kt, vt, kb, hi, scale_log2, mrow, lrow, o);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                  // the rings are free for the merge

  float* wo = reinterpret_cast<float*>(ks);   // [kWarps][kRows][D]
  float* wm = wo + kWarps * kRows * D;        // [kWarps][kRows]
  float* wl = wm + kWarps * kRows;            // [kWarps][kRows]
  float* po = wl + kWarps * kRows;            // [kRows][D]  published
  float* pm = po + kRows * D;                 // [kRows]     published
  float* pl = pm + kRows;                     // [kRows]     published
  if constexpr (kCore) {
    if (lane == 0) {
      wm[warp * kRows] = mrow[0];
      wl[warp * kRows] = lrow[0];
    }
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      wo[warp * kRows * D + lane * (D / 32) + i] = acc[i];
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (lane >> 2) + 8 * h;
      float l = lrow[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if ((lane & 3) == 0) {
        wm[warp * kRows + row] = mrow[h];
        wl[warp * kRows + row] = l;
      }
      float* dst = wo + (warp * kRows + row) * D + (lane & 3) * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8) =
            make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
    }
  }
  __syncthreads();

  // The block's partial state: its warps merged (a warp that saw no key
  // has m = -inf and adds nothing).
  for (int i = tid; i < rows_live * D; i += kThreads) {
    const int row = i / D, col = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kRows + row]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * kRows + row];
      if (mw == -INFINITY) continue;
      const float f = exp2f(mw - mx);
      acc += f * wo[(w * kRows + row) * D + col];
      l += f * wl[w * kRows + row];
    }
    po[i] = acc;
    if (col == 0) {
      pm[row] = mx;
      pl[row] = l;
    }
  }
  cluster.sync();                   // every block's partial is published

  // The cluster merge: block `rank` takes every c-th group of 4 outputs.
  for (int i = rank * kThreads + tid; i < rows_live * (D / 4);
       i += c * kThreads) {
    const int row = i / (D / 4), col = (i % (D / 4)) * 4;
    float mr[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c) {
        mr[r] = cluster.map_shared_rank(pm, r)[row];
        mx = fmaxf(mx, mr[r]);
      }
    }
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c && mr[r] != -INFINITY) {
        const float f = exp2f(mr[r] - mx);
        l += f * cluster.map_shared_rank(pl, r)[row];
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(po, r) + row * D + col);
        acc.x += f * x.x;
        acc.y += f * x.y;
        acc.z += f * x.z;
        acc.w += f * x.w;
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;     // no visible key -> 0
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(out + q_base + row * D + col);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  cluster.sync();                   // no block leaves while it is read
}

// grid (c, Hkv * ceil(G / 16), B), clusters of (c, 1, 1), 128 threads.
template <int D, bool kCore>
__global__ void __launch_bounds__(kThreads)
flash_decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       const int* __restrict__ lengths, int S, int Hq,
                       int Hkv, float scale_log2) {
  const int G = Hq / Hkv, MT = (G + kRows - 1) / kRows;
  const int b = blockIdx.z, hk = blockIdx.y / MT, mt = blockIdx.y % MT;
  const int n = min(max(lengths[b], 0), S);
  const DenseRows rows{(static_cast<int64_t>(b) * S * Hkv + hk) * D,
                       static_cast<int64_t>(Hkv) * D};
  decode_block<D, kCore>(
      q, k, v, out,
      (static_cast<int64_t>(b) * Hq + hk * G + mt * kRows) * D,
      min(kRows, G - mt * kRows), n, rows, scale_log2);
}

// The same grid over the block pool.
template <int D, bool kCore>
__global__ void __launch_bounds__(kThreads)
paged_decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, int num_blocks,
                       int block_size, int max_blocks, int Hq, int Hkv,
                       float scale_log2) {
  const int G = Hq / Hkv, MT = (G + kRows - 1) / kRows;
  const int b = blockIdx.z, hk = blockIdx.y / MT, mt = blockIdx.y % MT;
  const int n = min(max(lengths[b], 0), max_blocks * block_size);
  const PagedRows rows{block_tables + static_cast<int64_t>(b) * max_blocks,
                       block_size, num_blocks,
                       static_cast<int64_t>(hk) * D,
                       static_cast<int64_t>(Hkv) * D};
  decode_block<D, kCore>(
      q, k, v, out,
      (static_cast<int64_t>(b) * Hq + hk * G + mt * kRows) * D,
      min(kRows, G - mt * kRows), n, rows, scale_log2);
}

// Launches `kernel` on grid (c, Hkv * ceil(G / 16), B) in clusters of c.
template <int D, auto kernel, class... Args>
cudaError_t launch(int c, int B, int Hq, int Hkv, cudaStream_t st,
                   Args... args) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB a block needs the opt-in; set once per kernel, before any
  // capture into a CUDA graph can start.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return opt_in;
  const int G = Hq / Hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, Hkv * ((G + kRows - 1) / kRows), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int c) {
  return B < 1 || B > 65535 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 ||
         c < 1 || c > kMaxCluster ||
         static_cast<int64_t>(Hkv) * ((Hq / Hkv + kRows - 1) / kRows)
             > 65535;
}

// A group of one query head (moonshot's) is scored on the CUDA cores
// (score_g1_core) at D 64 and 128: on the card that beat a 1-of-16-row
// tensor-core tile by 0.6-0.8 us a call (tools/decode_ab.py builds the
// source with this false to compare). D 112 takes the tile at every
// group: a CUDA-core layout of 4 columns a lane on 28 lanes measured
// slower there (15.8 against 12.9 us a call at zamba2-7b's decode shape).
constexpr bool kCoreScoringG1 = true;

// Runs f.run<D, core>() for the runtime head dim and scoring route.
template <class F>
cudaError_t dispatch(int D, bool g1, const F& f) {
  const bool core = kCoreScoringG1 && g1;
  switch (D) {
    case 16: return f.template run<16, false>();
    case 32: return f.template run<32, false>();
    case 64:
      return core ? f.template run<64, true>() : f.template run<64, false>();
    case 112: return f.template run<112, false>();
    case 128:
      return core ? f.template run<128, true>()
                  : f.template run<128, false>();
    default: return cudaErrorInvalidValue;
  }
}

struct FlashDecodeLaunch {
  const bf16 *q, *k, *v; bf16* out; const int* lengths;
  int B, S, Hq, Hkv; float scale_log2; int c;
  cudaStream_t st;
  template <int D, bool kCore> cudaError_t run() const {
    return launch<D, flash_decode_tc_kernel<D, kCore>>(
        c, B, Hq, Hkv, st, q, k, v, out, lengths, S, Hq, Hkv, scale_log2);
  }
};

struct PagedDecodeLaunch {
  const bf16 *q, *k, *v; bf16* out; const int *tables, *lengths;
  int B, NB, Bs, MB, Hq, Hkv; float scale_log2; int c;
  cudaStream_t st;
  template <int D, bool kCore> cudaError_t run() const {
    return launch<D, paged_decode_tc_kernel<D, kCore>>(
        c, B, Hq, Hkv, st, q, k, v, out, tables, lengths, NB, Bs, MB, Hq,
        Hkv, scale_log2);
  }
};

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

extern "C" {

// bf16 q, k, v, out, contiguous, 16-byte aligned; int32 lengths (B,);
// D in {16, 32, 64, 112, 128}; c in [1, 8]. Anything else returns
// cudaErrorInvalidValue unlaunched.
int repro_flash_decode_tc(const void* q, const void* k, const void* v,
                          void* out, const void* lengths, int B, int S,
                          int Hq, int Hkv, int D, float scale, int c,
                          void* stream) {
  if (bad_shape(B, Hq, Hkv, c) || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FlashDecodeLaunch f{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<const int*>(lengths), B, S, Hq, Hkv, scale * kLog2e, c,
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(D, Hq == Hkv, f));
}

// The same over (num_blocks, block_size, Hkv, D) pools and int32
// block_tables (B, max_blocks).
int repro_paged_decode_tc(const void* q, const void* k_pool,
                          const void* v_pool, void* out,
                          const void* block_tables, const void* lengths,
                          int B, int num_blocks, int block_size,
                          int max_blocks, int Hq, int Hkv, int D,
                          float scale, int c, void* stream) {
  if (bad_shape(B, Hq, Hkv, c) || num_blocks < 1 || block_size < 1 ||
      max_blocks < 0 ||
      static_cast<int64_t>(max_blocks) * block_size > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PagedDecodeLaunch f{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<bf16*>(out),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), B, num_blocks, block_size,
      max_blocks, Hq, Hkv, scale * kLog2e, c,
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(D, Hq == Hkv, f));
}

}  // extern "C"
