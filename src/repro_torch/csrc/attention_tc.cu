// Prefill attention on the tensor cores, hand-written for Hopper (sm_90a),
// for bfloat16 inputs.
//
//   flash_attention_tc_kernel  replaces repro/kernels/flash_attention.py
//                              flash_attention (causal or not, GQA) for
//                              bf16
//   paged_prefill_tc_kernel    replaces repro/kernels/paged_decode.py
//                              paged_prefill (an Sq-row chunk at q_offset
//                              against the block pool, GQA) for bf16
// float32 inputs stay on the CUDA-core flash_attention_kernel /
// paged_prefill_kernel of attention.cu (the wrappers pick by dtype: TF32
// would not hold float32's parity checks).
//
// What they compute. flash_attention: q (B, Sq, Hq, D), k and v (B, Skv,
// Hkv, D), Hq a multiple of Hkv; query row i sits at position Skv - Sq + i
// and, with causal, sees keys pos <= Skv - Sq + i. paged_prefill: q (B,
// Sq, Hq, D), pools (NB, Bs, Hkv, D) read through block_tables (B,
// max_blocks); row i sits at q_offset[b] + i and sees keys pos <=
// q_offset[b] + i and pos < lengths[b] (table entries past the
// allocation are clamped into the pool and never read, being past the
// window). flash_attention also takes V (and the output) narrower than Q
// and K: D 192 / Dv 128 is MLA's expanded prefill (models/mla.py: per
// head a 128-wide k_nope and the 64-wide shared RoPE key, 128-wide
// values), the same tile loop with the two widths as template
// parameters. A row that sees no key outputs zeros. Output in bf16, softmax
// and sums in float32. Both share one block routine (prefill_block), which
// takes the key rows' addressing as a policy (dense or through the table)
// and the position of row 0 (the causal origin).
//
// What bounds them on an H100. A 256-token prompt of tinyllama-1.1b (32/4
// heads of 64) is 268 MFLOP causal on 4.7 MB of q, k, v and out: 0.27 us
// at the bf16 tensor-core peak, 1.4 us for the bytes. A 64-token chunk at
// offset 128 (the chunked-prefill engine's) is ~84 MFLOP on 0.7 MB
// (tinyllama) or 2.1 MB (moonshot-v1-16b-a3b, 16/16 heads of 128): 0.2-0.6
// us for the bytes. So the limit is latency and how well the grid fills
// the card, not a peak rate. The CUDA-core kernels they replace ran blocks
// of a few query rows, each loading the visible K/V again as float32 and
// scoring it with scalar FMAs.
//
// What the design does about it:
//   * One block per (64 (query row, head-in-group) pairs, KV head, batch).
//     The GQA group is packed into the 64 rows of the block's tile (pair m
//     is row m / G, head m % G), so one K/V tile in shared memory serves
//     the whole group; the causal limit of a pair is its own query row's.
//     tinyllama's prompt: 2048 pairs per KV head, 32 x 4 = 128 blocks; its
//     chunk: 512 pairs, 8 x 4 = 32 blocks; moonshot's chunk (group 1, D
//     128): 1 x 16 blocks. Tiles of the last rows (the longest causal
//     walks) are issued first.
//   * K and V stay bf16: tiles of 64 keys reach shared memory by cp.async,
//     16 bytes a thread, in two stages (the next tile is in flight while
//     this one is multiplied). Through the block table, each key row's
//     offset is computed once, a tile ahead, one thread a key (the entry
//     read and clamped once), not once per 16-byte copy; a contiguous
//     cache's rows are addressed in place. Rows are padded by 16 bytes, so the
//     ldmatrix reads of 8 rows hit 8 different bank groups (a row is 2D + 16
//     bytes, an odd number of 16-byte groups at every D taken: 9 at D 64,
//     15 at D 112, 17 at D 128). Tiles past the
//     block's last visible key are never loaded; only tiles that cross the
//     diagonal of the block's first row (or the end of its keys) are
//     masked.
//   * S = Q K^T and O += P V run on the tensor cores: mma.sync m16n8k16,
//     bf16 in, float32 accumulate, one warp per 16 rows. mma.sync, not
//     wgmma: at these shapes the work is tens to hundreds of MFLOP and the
//     limit is latency and fill, which a 64-row warpgroup product would
//     not move; mma.sync keeps the softmax in the accumulator's registers.
//     Q's fragments are loaded once (ldmatrix), K's by ldmatrix, V's by
//     ldmatrix.trans.
//   * Online softmax in registers, FA2 style: the running max and sum of
//     each row live with the 4 lanes (a quad) that hold it, reduced by quad
//     shuffles; P is rounded to bf16 and repacked from the S accumulators
//     into A fragments without touching shared memory. The row sums add the
//     rounded P, so the weights of every output row sum to one.
//   * A chunk of prefill leaves most of the card idle (tinyllama's 32
//     blocks, moonshot's 16 on 132 SMs) and each warp walks every key
//     tile of its rows. paged_prefill may shorten those walks two ways,
//     both measured on the card (tools/prefill_ab.py). Within a block, at
//     D 128, two warps take each 16 rows, each scoring half of every key
//     tile, and merge (m, l, o) in shared memory at the end. Across
//     blocks, the keys may be split over a thread-block cluster of c
//     blocks: each takes a 16-key-aligned share of its row tile's keys
//     and the blocks merge through distributed shared memory between two
//     cluster barriers, as decode_tc.cu does (an empty share publishes
//     m = -inf). The wrapper's plan picks c from static shapes (offsets,
//     lengths and tables are read on the device, so a CUDA graph replays
//     it): 4 for a grid of at most 16 row tiles, else 1, since the merge
//     costs more than it saves on a larger grid.
//
// Interface: plain C functions (loaded with ctypes) returning the
// cudaError_t of their launch. Pointers are device pointers; the stream is
// a cudaStream_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "tc.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;             // (query row, head) pairs per block
constexpr int kBN = 64;             // keys per K/V tile
constexpr int kWarps = kBM / 16;    // one warp per 16 pairs
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;             // bf16 elements of padding per row
constexpr int kMaxCluster = 8;      // the portable cluster size limit
constexpr int kShareAlign = 16;     // a cluster block's share of the keys

// Q tile + two stages of K and V + the stages' row offsets; Q and K rows
// are D wide, V rows Dv.
template <int D, int Dv>
__host__ __device__ constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBM + 2 * kBN) * (D + kPad)
          + 2 * kBN * (Dv + kPad)) * sizeof(bf16)
         + 2 * kBN * sizeof(int64_t);
}

// The cluster merge's floats (a block's published o, m, l) reuse the
// tiles once the last one is consumed; o rows padded by 4 floats.
template <int Dv>
__host__ __device__ constexpr size_t merge_bytes() {
  return (static_cast<size_t>(kBM) * (Dv + 4) + 2 * kBM) * sizeof(float);
}

// K/V row addressing: the index of the (pos, KV head) row, in rows of one
// head (a K row's elements start at index * D, a V row's at index * Dv).
struct DenseRows {         // (B, S, Hkv, .) contiguous keys
  static constexpr bool kIndirect = false;
  int64_t base;            // index of (b, pos 0, head)
  int64_t stride;          // Hkv
  __device__ int64_t operator()(int pos) const {
    return base + static_cast<int64_t>(pos) * stride;
  }
};

struct PagedRows {         // (NB, Bs, Hkv, .) pool through a block table
  static constexpr bool kIndirect = true;   // offsets computed a tile ahead
  const int* table;        // this sequence's row of block_tables
  int block_size;
  int num_blocks;
  int64_t head;            // the KV head
  int64_t heads;           // Hkv
  __device__ int64_t operator()(int pos) const {
    // Garbage entries past the allocation are clamped into the pool; only
    // positions inside the window get here.
    int phys = table[pos / block_size];
    phys = min(max(phys, 0), num_blocks - 1);
    return (static_cast<int64_t>(phys) * block_size + pos % block_size)
               * heads + head;
  }
};

// One block: pairs [m0, m0 + 64) of one (sequence, KV head), pair m being
// head row p = q_base + (m / G) * Hq + m % G (q at p * D, out at p * Dv),
// of M pairs in all. Row r sits at position origin + r; with causal it
// sees keys pos <= origin + r, and every row sees keys pos < n, whose row
// indices are rows(pos). The block has 4 * kSlices warps: warp w scores
// the 16 rows w % 4 against slice w / 4 of the keys of every tile, and
// the slices merge through shared memory at the end. With kSplit the
// block is one of a cluster that shares those keys; every thread of
// every block of the cluster must call it.
template <int D, int Dv, bool kSplit, int kSlices, class Rows>
__device__ __forceinline__ void prefill_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int64_t q_base,
    int G, int Hq, int M, int m0, int origin, bool causal, int n, Rows rows,
    float scale_log2) {
  constexpr int kT = kThreads * kSlices;   // threads of the block
  constexpr int KB = kBN / kSlices;        // keys of a tile a warp scores
  constexpr int LD = D + kPad;      // Q and K shared-memory rows
  constexpr int LDV = Dv + kPad;    // V shared-memory rows
  constexpr int CH = D / 8;         // 16-byte chunks of a Q or K row
  constexpr int CHV = Dv / 8;       // ... of a V row
  constexpr int KS = D / 16;        // k-steps of Q K^T
  constexpr int NT = KB / 8;        // 8-key column tiles of S
  constexpr int PD = Dv + 4;        // a published o row, in floats
  static_assert(KB % 16 == 0, "a warp scores whole 16-key steps");
  static_assert((kSlices > 1 ? kSlices - 1 : 1) * merge_bytes<Dv>()
                    <= smem_bytes<D, Dv>(),
                "the merges must fit in the tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [kBM][LD]
  bf16* ks = qs + kBM * LD;                         // [2][kBN][LD]
  bf16* vs = ks + 2 * kBN * LD;                     // [2][kBN][LDV]
  int64_t* roff = reinterpret_cast<int64_t*>(vs + 2 * kBN * LDV);  // [2][kBN]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % kWarps, slice = warp / kWarps;

  const int first_row = m0 / G;
  const int last_row = (min(m0 + kBM, M) - 1) / G;
  // keys [0, kv_end) are visible to some row; [0, full_end) to every row
  const int kv_end = causal ? max(0, min(n, origin + last_row + 1)) : n;
  const int full_end = causal ? max(0, min(n, origin + first_row + 1)) : n;
  // this block's keys: [lo, hi)
  int lo = 0, hi = kv_end;
  if constexpr (kSplit) {
    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.num_blocks());
    const int share = ((kv_end + c - 1) / c + kShareAlign - 1)
                      / kShareAlign * kShareAlign;
    lo = min(kv_end, static_cast<int>(cluster.block_rank()) * share);
    hi = min(kv_end, lo + share);
  }
  const int n_tiles = (hi - lo + kBN - 1) / kBN;
  const int clean_end = min(full_end, hi);      // no mask below this key

  auto pair_row = [&](int m) {
    return q_base + static_cast<int64_t>(m / G) * Hq + m % G;
  };
  for (int i = tid; i < kBM * CH; i += kT) {
    const int r = i / CH, c = (i % CH) * 8, m = m0 + r;
    const bool ok = m < M;                         // else a zero row
    tc::cp_async16(qs + r * LD + c, q + (ok ? pair_row(m) * D + c : 0),
                   ok ? 16 : 0);
  }
  tc::cp_async_commit();
  auto row_off = [&](int tile, int r) {  // -1 past the block's keys
    const int pos = lo + tile * kBN + r;
    return pos < hi ? rows(pos) : int64_t{-1};
  };
  auto fill_offsets = [&](int tile) {   // one thread per key of the tile
    if (Rows::kIndirect && tile < n_tiles && tid < kBN)
      roff[(tile & 1) * kBN + tid] = row_off(tile, tid);
  };
  auto load_tile = [&](int tile) {
    if (tile >= n_tiles) return;
    bf16* kd = ks + (tile & 1) * kBN * LD;
    bf16* vd = vs + (tile & 1) * kBN * LDV;
    const int64_t* ro = roff + (tile & 1) * kBN;
    for (int i = tid; i < kBN * CH; i += kT) {
      const int r = i / CH, c = (i % CH) * 8;
      const int64_t off = Rows::kIndirect ? ro[r] : row_off(tile, r);
      const bool ok = off >= 0;                    // else a zero row
      tc::cp_async16(kd + r * LD + c, k + (ok ? off * D + c : 0),
                     ok ? 16 : 0);
      if constexpr (Dv == D)
        tc::cp_async16(vd + r * LDV + c, v + (ok ? off * Dv + c : 0),
                       ok ? 16 : 0);
    }
    if constexpr (Dv != D) {
      for (int i = tid; i < kBN * CHV; i += kT) {
        const int r = i / CHV, c = (i % CHV) * 8;
        const int64_t off = Rows::kIndirect ? ro[r] : row_off(tile, r);
        const bool ok = off >= 0;
        tc::cp_async16(vd + r * LDV + c, v + (ok ? off * Dv + c : 0),
                       ok ? 16 : 0);
      }
    }
  };
  fill_offsets(0);
  if (Rows::kIndirect) __syncthreads();
  load_tile(0);
  tc::cp_async_commit();

  uint32_t qf[KS][4];               // this warp's 16 Q rows, A fragments
  // This lane's two rows: pairs mA (h = 0) and mA + 8 (h = 1).
  const int mA = m0 + rg * 16 + (lane >> 2);
  const int lim[2] = {causal ? mA / G + origin : INT_MAX,
                      causal ? (mA + 8) / G + origin : INT_MAX};
  float o[Dv / 8][4];
#pragma unroll
  for (int i = 0; i < Dv / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};
  float lrow[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    // The offsets of tile j + 1 go to the slot tile j - 1 was issued
    // from, before the barrier of iteration j - 1.
    fill_offsets(j + 1);
    tc::cp_async_wait<0>();         // Q and tile j have landed
    __syncthreads();                // ... for every thread; j - 1 is done
    load_tile(j + 1);
    tc::cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::ldsm_x4(qf[kk], qs + (rg * 16 + (lane & 15)) * LD + kk * 16
                                + (lane >> 4) * 8);
    }
    const bf16* kt = ks + ((j & 1) * kBN + slice * KB) * LD;
    const bf16* vt = vs + ((j & 1) * kBN + slice * KB) * LDV;

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

    const int t0 = lo + j * kBN;
    const bool masked = t0 + kBN > clean_end;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int pos =
              t0 + slice * KB + nt * 8 + (lane & 3) * 2 + (e & 1);
          if (pos >= hi || pos > lim[e >> 1]) x = -INFINITY;
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
      for (int dt = 0; dt < Dv / 8; ++dt) {
        o[dt][2 * h] *= corr;
        o[dt][2 * h + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint32_t a[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < Dv / 16; ++dp) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                                  * LDV
                             + dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dp], a, r[0], r[1]);
        tc::mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }

  tc::cp_async_wait<0>();           // no copy is left to land (with no
                                    // tile, Q's would be)
#pragma unroll
  for (int h = 0; h < 2; ++h) {     // each row's sum over its quad
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }
  // A partial state (o, m, l) of the tile's 64 rows in shared memory:
  // [kBM][PD] floats of o, then m and l of each row.
  constexpr int kPart = kBM * PD + 2 * kBM;
  float* parts = reinterpret_cast<float*>(smem_raw);
  auto publish = [&](float* po) {   // this warp's 16 rows
    float* pm = po + kBM * PD;
    float* pl = pm + kBM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 16 + (lane >> 2) + 8 * h;
      if ((lane & 3) == 0) {
        pm[row] = mrow[h];
        pl[row] = lrow[h];
      }
      float* dst = po + row * PD + (lane & 3) * 2;
#pragma unroll
      for (int dt = 0; dt < Dv / 8; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8) =
            make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
    }
  };
  if constexpr (kSlices > 1) {      // slices 1.. into slice 0's registers
    __syncthreads();                // every warp is done with the tiles
    if (slice > 0) publish(parts + (slice - 1) * kPart);
    __syncthreads();
    if (slice == 0) {
#pragma unroll
      for (int sp = 1; sp < kSlices; ++sp) {
        const float* po = parts + (sp - 1) * kPart;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rg * 16 + (lane >> 2) + 8 * h;
          const float ms = po[kBM * PD + row];
          const float m_new = fmaxf(mrow[h], ms);
          if (m_new == -INFINITY) continue;        // neither saw a key
          const float f0 = exp2f(mrow[h] - m_new), fs = exp2f(ms - m_new);
          mrow[h] = m_new;
          lrow[h] = lrow[h] * f0 + po[kBM * PD + kBM + row] * fs;
          const float* src = po + row * PD + (lane & 3) * 2;
#pragma unroll
          for (int dt = 0; dt < Dv / 8; ++dt) {
            const float2 x = *reinterpret_cast<const float2*>(src + dt * 8);
            o[dt][2 * h] = o[dt][2 * h] * f0 + x.x * fs;
            o[dt][2 * h + 1] = o[dt][2 * h + 1] * f0 + x.y * fs;
          }
        }
      }
    }
  }

  if constexpr (!kSplit) {
    if (slice > 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = lrow[h] > 0.f ? 1.f / lrow[h] : 0.f;   // no key -> 0
      const int m = mA + 8 * h;
      if (m >= M) continue;
      bf16* dst = out + pair_row(m) * Dv + (lane & 3) * 2;
#pragma unroll
      for (int dt = 0; dt < Dv / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * h] * inv,
                                  o[dt][2 * h + 1] * inv);
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    float* pm = parts + kBM * PD;
    float* pl = pm + kBM;
    __syncthreads();                // the tiles (and slices' parts) are free
    if (slice == 0) publish(parts);
    cluster.sync();                 // every block's partial is published

    // Block `rank` takes every c-th group of 4 outputs of the tile.
    for (int i = rank * kT + tid; i < kBM * (Dv / 4); i += c * kT) {
      const int row = i / (Dv / 4), col = (i % (Dv / 4)) * 4;
      if (m0 + row >= M) continue;
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
              cluster.map_shared_rank(parts, r) + row * PD + col);
          acc.x += f * x.x;
          acc.y += f * x.y;
          acc.z += f * x.z;
          acc.w += f * x.w;
        }
      }
      const float inv = l > 0.f ? 1.f / l : 0.f;   // no visible key -> 0
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          out + pair_row(m0 + row) * Dv + col);
      dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    }
    cluster.sync();                 // no block leaves while it is read
  }
}

// grid (ceil(Sq * G / 64), Hkv, B), 128 threads; q and k rows D wide, v
// and out rows Dv.
template <int D, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int Sq, int Skv, int Hq, int Hkv, int causal,
                          float scale_log2) {
  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const DenseRows rows{static_cast<int64_t>(b) * Skv * Hkv + hk,
                       static_cast<int64_t>(Hkv)};
  prefill_block<D, Dv, false, 1>(
      q, k, v, out,
      static_cast<int64_t>(b) * Sq * Hq + static_cast<int64_t>(hk) * G,
      G, Hq, Sq * G, (gridDim.x - 1 - blockIdx.x) * kBM, Skv - Sq,
      causal != 0, Skv, rows, scale_log2);
}

// Key slices of a paged_prefill block: warps that score the same 16 rows
// against different keys of each tile. Two at D 128, where on the card
// (tools/prefill_ab.py) they took moonshot-v1-16b-a3b's chunk from 9.7 to
// 9.0 us; one at D 64, where they were no faster (flash_attention takes
// one).
template <int D>
constexpr int kPrefillSlices = D >= 128 ? 2 : 1;

// grid (c * ceil(Sq * G / 64), Hkv, B) in clusters of (c, 1, 1) (c = 1
// without kSplit), 128 * kPrefillSlices<D> threads.
template <int D, bool kSplit>
__global__ void __launch_bounds__(kThreads * kPrefillSlices<D>)
paged_prefill_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths,
                        const int* __restrict__ q_offset, int num_blocks,
                        int block_size, int max_blocks, int Sq, int Hq,
                        int Hkv, float scale_log2) {
  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  int c = 1;
  if constexpr (kSplit) c = static_cast<int>(cg::this_cluster().num_blocks());
  const int n = min(max(lengths[b], 0), max_blocks * block_size);
  const PagedRows rows{block_tables + static_cast<int64_t>(b) * max_blocks,
                       block_size, num_blocks, static_cast<int64_t>(hk),
                       static_cast<int64_t>(Hkv)};
  prefill_block<D, D, kSplit, kPrefillSlices<D>>(
      q, k, v, out,
      static_cast<int64_t>(b) * Sq * Hq + static_cast<int64_t>(hk) * G,
      G, Hq, Sq * G, (gridDim.x / c - 1 - blockIdx.x / c) * kBM,
      q_offset[b], true, n, rows, scale_log2);
}

// Launches `kernel` with its shared memory on `grid` of blocks of
// `threads`, in clusters of (c, 1, 1) when c > 1.
template <auto kernel, class... Args>
cudaError_t launch(dim3 grid, int threads, int c, size_t smem,
                   cudaStream_t st, Args... args) {
  // Above 48 KB a block needs the opt-in; set once per kernel, before any
  // capture into a CUDA graph can start.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return opt_in;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct FlashAttentionLaunch {
  const bf16 *q, *k, *v; bf16* out;
  int B, Sq, Skv, Hq, Hkv, causal; float scale_log2;
  cudaStream_t st;
  template <int D, int Dv = D> cudaError_t run() const {
    const dim3 grid((Sq * (Hq / Hkv) + kBM - 1) / kBM, Hkv, B);
    return launch<flash_attention_tc_kernel<D, Dv>>(
        grid, kThreads, 1, smem_bytes<D, Dv>(), st, q, k, v, out, Sq, Skv,
        Hq, Hkv, causal, scale_log2);
  }
};

struct PagedPrefillLaunch {
  const bf16 *q, *k, *v; bf16* out; const int *tables, *lengths, *offsets;
  int B, Sq, NB, Bs, MB, Hq, Hkv; float scale_log2; int c;
  cudaStream_t st;
  template <int D> cudaError_t run() const {
    const dim3 grid(c * ((Sq * (Hq / Hkv) + kBM - 1) / kBM), Hkv, B);
    constexpr int threads = kThreads * kPrefillSlices<D>;
    if (c > 1) {
      return launch<paged_prefill_tc_kernel<D, true>>(
          grid, threads, c, smem_bytes<D, D>(), st, q, k, v, out, tables,
          lengths, offsets, NB, Bs, MB, Sq, Hq, Hkv, scale_log2);
    }
    return launch<paged_prefill_tc_kernel<D, false>>(
        grid, threads, 1, smem_bytes<D, D>(), st, q, k, v, out, tables,
        lengths, offsets, NB, Bs, MB, Sq, Hq, Hkv, scale_log2);
  }
};

// Runs f.run<D>() for the runtime head dim.
template <class F>
cudaError_t dispatch(int D, const F& f) {
  switch (D) {
    case 16: return f.template run<16>();
    case 32: return f.template run<32>();
    case 64: return f.template run<64>();
    case 112: return f.template run<112>();
    case 128: return f.template run<128>();
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int Sq, int Hq, int Hkv) {
  return B < 1 || B > 65535 || Sq < 1 || Hkv < 1 || Hkv > 65535 ||
         Hq < Hkv || Hq % Hkv != 0 ||
         static_cast<int64_t>(Sq) * (Hq / Hkv) * kMaxCluster >= INT32_MAX;
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

extern "C" {

// bf16 q, k, v, out, contiguous, 16-byte aligned; q and k rows D wide, v
// and out rows Dv: Dv = D in {16, 32, 64, 112, 128}, or (D, Dv) = (192,
// 128), MLA's expanded prefill; B, Sq, Hkv >= 1, Skv >= 0. Anything else
// returns cudaErrorInvalidValue unlaunched.
int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Skv, int Hq,
                             int Hkv, int D, int Dv, int causal, float scale,
                             void* stream) {
  if (bad_shape(B, Sq, Hq, Hkv) || Skv < 0 ||
      (Dv != D && (D != 192 || Dv != 128))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FlashAttentionLaunch f{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Sq, Skv, Hq,
      Hkv, causal, scale * kLog2e, static_cast<cudaStream_t>(stream)};
  if (Dv != D) return static_cast<int>(f.run<192, 128>());
  return static_cast<int>(dispatch(D, f));
}

// The same over (num_blocks, block_size, Hkv, D) pools, int32 block_tables
// (B, max_blocks), lengths (B,) and q_offset (B,); c in [1, 8] blocks a
// cluster share each row tile's keys.
int repro_paged_prefill_tc(const void* q, const void* k_pool,
                           const void* v_pool, void* out,
                           const void* block_tables, const void* lengths,
                           const void* q_offset, int B, int Sq,
                           int num_blocks, int block_size, int max_blocks,
                           int Hq, int Hkv, int D, float scale, int c,
                           void* stream) {
  if (bad_shape(B, Sq, Hq, Hkv) || c < 1 || c > kMaxCluster ||
      num_blocks < 1 || block_size < 1 || max_blocks < 0 ||
      static_cast<int64_t>(max_blocks) * block_size > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PagedPrefillLaunch f{
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<bf16*>(out),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offset),
      B, Sq, num_blocks, block_size, max_blocks, Hq, Hkv, scale * kLog2e, c,
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(D, f));
}

}  // extern "C"
