// Latent attention decode (MLA, absorbed form) on the tensor cores,
// hand-written for Hopper (sm_90a), for bfloat16 inputs.
//
//   mla_paged_decode_kernel  replaces no Pallas kernel: the JAX package
//                            has no latent attention. It serves
//                            models/mla.py's decode for MLA configs
//                            (Moonlight-16B-A3B: 16 heads, r 512, RoPE 64)
//
// What it computes: q (B, H, Dk), H <= 16 query heads a slot, each Dk =
// Dv + 64 wide (Dk 576, Dv 512); a pool (NB, Bs, Dk) of latent rows read
// through block_tables (B, max_blocks): slot b's keys are its rows [0,
// min(max(lengths[b], 0), max_blocks * Bs)) (table entries past the
// allocation are clamped into the pool and never read, being past the
// window). Every head scores the same rows (MQA), and the values are the
// rows' first Dv columns:
//   out[b, h] = softmax_j(scale * q[b, h] . row_j) . row_j[:Dv].
// A slot with no key writes exact zeros. Softmax and sums in float32,
// output in bf16.
//
// What bounds it on an H100. A key costs 2 * (Dk + Dv) = 2,176 FLOPs a
// head, 34,816 for 16 heads, on one 1,152-byte row read once: ~30 FLOPs a
// byte, far below the ~295 at which the tensor cores, not the memory,
// would be the limit. So the bound is the bytes of the latent rows: at
// Moonlight's decode (64 slots of ~3,000 keys) 221 MB a layer, 66 us at
// 3.35 TB/s. Every row must therefore be read once for all 16 heads, and
// enough of them must be in flight to cover the latency.
//
// What the design does about it:
//   * One cluster of c <= 8 blocks a slot (split-KV, as decode_tc.cu): the
//     wrapper picks c from the static batch so that the grid is one wave
//     of two blocks an SM (c 4 at 64 slots). Each block reads lengths[b]
//     on the device, takes its contiguous share (whole 32-key tiles) of
//     the window, and the blocks merge their partial softmax states
//     (m, l, o) through distributed shared memory between two cluster
//     barriers; an empty share publishes m = -inf. No second kernel, no
//     global workspace, no host sync.
//   * The 16 heads are the 16 rows of the mma's A tile, so one tile of 32
//     rows in shared memory serves every head: the bytes are read once.
//     Tiles reach shared memory by cp.async, 16 bytes a thread, in a ring
//     of two (the next is in flight while this one is used); with two
//     blocks an SM, four tiles (147 KB) are in flight an SM. Rows are
//     padded by 16 bytes (73 16-byte groups, odd), so ldmatrix reads of 8
//     rows hit 8 bank groups. A tile's row addresses are computed once a
//     key (one thread each, reading the table there).
//   * S = Q K^T: warp w scores the tile's keys [8w, 8w + 8) over the 36
//     k-steps of Dk (mma.sync m16n8k16, bf16 in, float32 accumulate; Q's
//     fragments by ldmatrix from shared memory, not held: 144 registers
//     would not fit beside the output) and writes its scaled scores to a
//     16 x 32 float tile in shared memory. After a barrier every warp
//     runs the same online softmax over the whole 32-key tile (the quad
//     of lanes that holds a row reduces its maximum and sum by shuffles),
//     so each holds the same (m, l), and multiplies P (rounded to bf16
//     once; the sums add the rounded P) by its own 128 of the Dv value
//     columns, read from the same tile by ldmatrix.trans: O stays in
//     registers, 16 rows x 128 columns a warp (64 floats a lane).
//   * mma.sync, not wgmma: the bound is bytes, and at ~30 FLOPs a byte
//     the tensor cores are idle most of the time either way.
//
// Interface: a plain C function (loaded with ctypes) returning the
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
constexpr int kRows = 16;              // query heads a block: the mma's M
constexpr int kBN = 8 * kWarps;        // keys a tile, 8 a warp in Q K^T
constexpr int kStages = 2;             // tiles in the ring
constexpr int kPad = 8;                // bf16 elements of padding a row
constexpr int kSLd = kBN + 4;          // a score row in shared memory
constexpr int kMaxCluster = 8;         // the portable cluster size limit
constexpr int kDk = 576;               // latent (512) + RoPE (64)
constexpr int kDv = 512;               // the latent: the values
constexpr int kLd = kDk + kPad;
constexpr int kCols = kDv / kWarps;    // value columns a warp

constexpr size_t kSmem =
    (static_cast<size_t>(kRows) + kStages * kBN) * kLd * sizeof(bf16)
    + kRows * kSLd * sizeof(float) + kStages * kBN * sizeof(int64_t);

// Two 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i (lanes 16-31 repeat lanes 0-15's, unused).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(tc::smem_u32(p))
      : "memory");
}

// grid (c, 1, B), clusters of (c, 1, 1), 128 threads.
__global__ void __launch_bounds__(kThreads)
mla_paged_decode_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ pool,
                        bf16* __restrict__ out,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, int num_blocks,
                        int block_size, int max_blocks, int H,
                        float scale_log2) {
  static_assert(kDk % 16 == 0 && kCols % 16 == 0, "whole mma steps");
  static_assert(static_cast<size_t>(kRows) * kDv * sizeof(float)
                    + 2 * kRows * sizeof(float)
                    <= kStages * kBN * kLd * sizeof(bf16),
                "the published partial must fit in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // [kRows][kLd]
  bf16* ks = qs + kRows * kLd;                           // [S][kBN][kLd]
  float* ss = reinterpret_cast<float*>(ks + kStages * kBN * kLd);
  int64_t* roff = reinterpret_cast<int64_t*>(ss + kRows * kSLd);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int n = min(max(lengths[b], 0), max_blocks * block_size);
  const int* table = block_tables + static_cast<int64_t>(b) * max_blocks;
  const bf16* qb = q + static_cast<int64_t>(b) * H * kDk;

  constexpr int CH = kDk / 8;                  // 16-byte chunks a row
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool ok = r < H;                     // else a zero row
    tc::cp_async16(qs + r * kLd + col, qb + (ok ? r * kDk + col : 0),
                   ok ? 16 : 0);
  }
  tc::cp_async_commit();

  // This block's share of the window, whole tiles: keys [lo, hi).
  const int share = ((n + c - 1) / c + kBN - 1) / kBN * kBN;
  const int lo = min(n, rank * share);
  const int hi = min(n, lo + share);
  const int n_tiles = (hi - lo + kBN - 1) / kBN;

  auto fill_offsets = [&](int tile) {   // one thread a key of the tile
    if (tile < n_tiles && tid < kBN) {
      const int pos = lo + tile * kBN + tid;
      int64_t off = -1;
      if (pos < hi) {
        // Garbage entries past the allocation are clamped into the pool;
        // only positions inside the window get here.
        const int phys = min(max(table[pos / block_size], 0),
                             num_blocks - 1);
        off = (static_cast<int64_t>(phys) * block_size + pos % block_size)
              * kDk;
      }
      roff[(tile % kStages) * kBN + tid] = off;
    }
  };
  auto load_tile = [&](int tile) {
    if (tile >= n_tiles) return;
    bf16* kd = ks + (tile % kStages) * kBN * kLd;
    const int64_t* ro = roff + (tile % kStages) * kBN;
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, col = (i % CH) * 8;
      const int64_t off = ro[r];
      const bool ok = off >= 0;                // else a zero row
      tc::cp_async16(kd + r * kLd + col, pool + (ok ? off + col : 0),
                     ok ? 16 : 0);
    }
  };

  fill_offsets(0);
  __syncthreads();
  load_tile(0);
  tc::cp_async_commit();

  float o[kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};    // rows g and g + 8
  float lrow[2] = {0.f, 0.f};                // this lane's part of the sum
  const int g = lane >> 2, t = lane & 3;

  for (int j = 0; j < n_tiles; ++j) {
    // Tile j + 1 goes to the stage of tile j - 1, which every warp is done
    // with after this barrier; its offsets' slot was read when j - 1 was
    // issued.
    fill_offsets(j + 1);
    tc::cp_async_wait<0>();         // Q and tile j have landed
    __syncthreads();
    load_tile(j + 1);
    tc::cp_async_commit();
    const bf16* kt = ks + (j % kStages) * kBN * kLd;
    const int t0 = lo + j * kBN;

    // S = Q K^T for this warp's 8 keys, scaled, masked, to shared memory.
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kw = kt + warp * 8 * kLd;
#pragma unroll 4
      for (int kk = 0; kk < kDk / 16; ++kk) {
        uint32_t a[4], bb[2];
        tc::ldsm_x4(a, qs + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
        ldsm_x2(bb, kw + (lane & 7) * kLd + kk * 16
                        + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s, a, bb[0], bb[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 8 + 2 * t + (e & 1);
        ss[(g + 8 * (e >> 1)) * kSLd + key] =
            t0 + key < hi ? s[e] * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // The online softmax over the tile's 32 keys (every warp alike), then
    // O += P V on this warp's value columns.
    float p[2][2][4];               // [k-step][h][column pair of 2]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* sr = ss + (g + 8 * h) * kSLd;
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sr[kk * 16 + 2 * t + (e & 1) + 8 * (e >> 1)];
          p[kk][h][e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // key t0 < hi is visible, so every row's maximum is finite
      const float m_new = fmaxf(mrow[h], mx);
      const float corr = exp2f(mrow[h] - m_new);   // -inf -> 0
      mrow[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = __bfloat162float(
              __float2bfloat16(exp2f(p[kk][h][e] - m_new)));
          p[kk][h][e] = pe;
          sum += pe;
        }
      }
      lrow[h] = lrow[h] * corr + sum;
#pragma unroll
      for (int dt = 0; dt < kCols / 8; ++dt) {
        o[dt][2 * h] *= corr;
        o[dt][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t a[4] = {tc::pack_bf16(p[kk][0][0], p[kk][0][1]),
                             tc::pack_bf16(p[kk][1][0], p[kk][1][1]),
                             tc::pack_bf16(p[kk][0][2], p[kk][0][3]),
                             tc::pack_bf16(p[kk][1][2], p[kk][1][3])};
#pragma unroll
      for (int dp = 0; dp < kCols / 16; ++dp) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, kt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                                  * kLd
                             + warp * kCols + dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dp], a, r[0], r[1]);
        tc::mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the partial

  // The block's partial (o, m, l): each warp its columns, warp 0 m and l.
  float* po = reinterpret_cast<float*>(ks);   // [kRows][kDv]
  float* pm = po + kRows * kDv;               // [kRows]
  float* pl = pm + kRows;                     // [kRows]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    float l = lrow[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (warp == 0 && t == 0) {
      pm[row] = mrow[h];
      pl[row] = l;
    }
    float* dst = po + row * kDv + warp * kCols + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kCols / 8; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8) =
          make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
  }
  cluster.sync();                   // every block's partial is published

  // The cluster merge: block `rank` takes every c-th group of 4 outputs.
  bf16* ob = out + static_cast<int64_t>(b) * H * kDv;
  for (int i = rank * kThreads + tid; i < H * (kDv / 4);
       i += c * kThreads) {
    const int row = i / (kDv / 4), col = (i % (kDv / 4)) * 4;
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
            cluster.map_shared_rank(po, r) + row * kDv + col);
        acc.x += f * x.x;
        acc.y += f * x.y;
        acc.z += f * x.z;
        acc.w += f * x.w;
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;     // no visible key -> 0
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(ob + row * kDv + col);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  cluster.sync();                   // no block leaves while it is read
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

extern "C" {

// bf16 q (B, H, Dk), pool (NB, Bs, Dk) and out (B, H, Dv), contiguous,
// 16-byte aligned; int32 block_tables (B, max_blocks) and lengths (B,);
// (Dk, Dv) = (576, 512), 1 <= H <= 16, c in [1, 8]. Anything else returns
// cudaErrorInvalidValue unlaunched.
int repro_mla_paged_decode(const void* q, const void* pool, void* out,
                           const void* block_tables, const void* lengths,
                           int B, int num_blocks, int block_size,
                           int max_blocks, int H, int Dk, int Dv,
                           float scale, int c, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > kRows || Dk != kDk || Dv != kDv ||
      c < 1 || c > kMaxCluster || num_blocks < 1 || block_size < 1 ||
      max_blocks < 0 ||
      static_cast<int64_t>(max_blocks) * block_size > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Above 48 KB a block needs the opt-in; set once, before any capture
  // into a CUDA graph can start.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      mla_paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, mla_paged_decode_kernel, static_cast<const bf16*>(q),
      static_cast<const bf16*>(pool), static_cast<bf16*>(out),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), num_blocks, block_size, max_blocks,
      H, scale * kLog2e);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
