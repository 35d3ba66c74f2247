// Attention kernels of the serving path, hand-written for Hopper (sm_90a).
//
// Four kernels share one block routine (`attend`) and one online-softmax
// update (`softmax_update` / `merge_partials`); all are templated on the
// element type (float or __nv_bfloat16; accumulation is always float) and
// on the head dim D (16, 32, 64, 112, 128).
//
//   flash_attention_kernel  replaces repro/kernels/flash_attention.py
//                           flash_attention (prompt prefill, causal GQA)
//                           for float32; bf16 prefill runs on the tensor
//                           cores (flash_attention_tc_kernel,
//                           attention_tc.cu)
//   flash_decode_kernel     replaces repro/kernels/flash_decode.py
//                           flash_decode (Sq == 1, contiguous cache)
//                           for float32
//   paged_decode_kernel     replaces repro/kernels/paged_decode.py
//                           paged_decode (Sq == 1, block-table pool) for
//                           float32; bf16 decode runs split-KV on the
//                           tensor cores (flash_decode_tc_kernel,
//                           paged_decode_tc_kernel, decode_tc.cu)
//   paged_prefill_kernel    replaces repro/kernels/paged_decode.py
//                           paged_prefill (Sq-row chunk at q_offset) for
//                           float32; bf16 chunked prefill runs on the
//                           tensor cores (paged_prefill_tc_kernel,
//                           attention_tc.cu)
//
// What bounds them on an H100. Decode (Sq == 1) reads every visible K/V
// row once and does 4*D flops per row and query head: at GQA group 8 that
// is ~8 flops per byte of bf16 K/V, far below the ~295 the card needs to
// be compute-bound, so decode is bound by the bytes of K/V read. At the
// serving shapes (8 slots x a few hundred tokens x 4 KV heads) that is
// well under a megabyte per layer, so the real limit is launch overhead
// and how many SMs the grid fills. Prefill over a 256-token bucket does
// ~2*2*Sq*Skv*D/2 flops per query head on data that fits in L2: bound by
// issue rate of the CUDA cores in this first version (no tensor cores).
//
// What the design does about it:
//   * One thread block serves ALL query heads of one KV head (the GQA
//     group), so each K/V tile is read from device memory once per group,
//     not once per query head (the TPU grid ran one block per query head).
//   * The TPU grid carried (m, l, acc) in VMEM across a sequential KV grid
//     axis. Here a block walks its KV range in a loop over shared-memory
//     tiles; each lane keeps (m, l, acc[D]) in registers.
//   * Each (query row, head) pair is served by `nsplit` consecutive lanes
//     that score interleaved keys of every tile; their partial softmax
//     states are merged with warp shuffles at the end. The wrapper picks
//     nsplit so the grid fills the card: decode, with one query row, uses
//     up to 32 lanes per head; prefill fewer, with more rows per block.
//   * Blocks size their own KV loop from the device-side `lengths`,
//     `q_offset` and block tables; the grid is sized from static shapes
//     only, so no wrapper ever syncs with the host to launch. Keys past the
//     window (or the causal limit of the block's last row) are never read.
//   * Rows of the K/V tile past the window are zero-filled, so a masked key
//     can never turn the accumulator into NaN; a row with no visible key
//     (idle slot, length 0) writes zeros, as the TPU kernels do.
// The bf16 routes moved to the tensor cores (attention_tc.cu,
// decode_tc.cu); these kernels keep float32, whose parity checks TF32
// would not hold. The bf16 instantiations stay, to be timed beside their
// successors.
//
// Interface: plain C functions (loaded with ctypes), each returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t. dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;   // lanes per block, upper bound
constexpr int kTileElems = 4096;   // floats per K (and V) tile in smem
constexpr int kChunk = 8;          // keys per online-softmax update

__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T> struct VecWidth;   // elements per 16-byte load
template <> struct VecWidth<float> { static constexpr int n = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// K/V row addressing: element offset of the (pos, kv-head) row.
struct DenseRows {         // (B, S, Hkv, D) contiguous cache / prompt
  int64_t base;            // offset of (b, pos 0, head)
  int64_t stride;          // Hkv * D
  __device__ int64_t operator()(int pos) const {
    return base + static_cast<int64_t>(pos) * stride;
  }
};

struct PagedRows {         // (NB, Bs, Hkv, D) pool through a block table
  const int* table;        // this sequence's row of block_tables
  int block_size;
  int num_blocks;
  int64_t head_off;        // head * D
  int64_t row_stride;      // Hkv * D
  __device__ int64_t operator()(int pos) const {
    // Garbage entries past the allocation are clamped into the pool; the
    // window mask keeps their rows invisible.
    int phys = table[pos / block_size];
    phys = min(max(phys, 0), num_blocks - 1);
    return (static_cast<int64_t>(phys) * block_size + pos % block_size)
               * row_stride + head_off;
  }
};

// The online-softmax update: fold kChunk scores (masked ones are -inf)
// and their V rows into the running (m, l, acc).
template <int D>
__device__ __forceinline__ void softmax_update(const float (&s)[kChunk],
                                               float cmax, const float* v0,
                                               int vstride, float& m,
                                               float& l, float (&acc)[D]) {
  if (cmax == -INFINITY) return;
  const float m_new = fmaxf(m, cmax);
  const float corr = expf(m - m_new);          // m == -inf -> 0
  l *= corr;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    if (s[c] == -INFINITY) continue;
    const float p = expf(s[c] - m_new);
    l += p;
    const float* vr = v0 + c * vstride;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(vr + d);
      acc[d] += p * x.x;
      acc[d + 1] += p * x.y;
      acc[d + 2] += p * x.z;
      acc[d + 3] += p * x.w;
    }
  }
  m = m_new;
}

// Merge the partial states of the nsplit consecutive lanes of each
// (row, head) pair (the same algebra as softmax_update, state by state).
// Every lane of the warp must call it.
template <int D>
__device__ __forceinline__ void merge_partials(int nsplit, float& m,
                                               float& l, float (&acc)[D]) {
  for (int off = nsplit >> 1; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, mo);
    const float c1 = (m == -INFINITY) ? 0.f : expf(m - m_new);
    const float c2 = (mo == -INFINITY) ? 0.f : expf(mo - m_new);
    l = l * c1 + lo * c2;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * c1 + ao * c2;
    }
    m = m_new;
  }
}

// One block: walk keys [0, kv_end) in shared-memory tiles. Each lane owns
// one (query row, head) pair (q_off >= 0; -1 = idle lane) and scores the
// keys j == split (mod nsplit) of every tile that satisfy
// pos <= qlimit && pos < window. Every lane of the block must call it.
template <typename T, int D, class Rows>
__device__ void attend(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int64_t q_off, int qlimit, int window, int kv_end,
                       int split, int nsplit, float scale, Rows rows,
                       float* smem) {
  constexpr int VN = VecWidth<T>::n;
  constexpr int TK = kTileElems / D;       // keys per tile (36 at D 112)
  constexpr int KS = D + 4;                // padded row: spreads banks
  float* ks = smem;
  float* vs = smem + TK * KS;
  const bool live = q_off >= 0;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) { qr[d] = 0.f; acc[d] = 0.f; }
  if (live) {
#pragma unroll
    for (int c = 0; c < D; c += VN) load_vec(q + q_off + c, qr + c);
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] *= scale;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int t0 = 0; t0 < kv_end; t0 += TK) {
    __syncthreads();                       // previous tile fully consumed
    for (int i = threadIdx.x; i < TK * (D / VN); i += blockDim.x) {
      const int key = i / (D / VN);
      const int c = (i % (D / VN)) * VN;
      const int pos = t0 + key;
      float kx[VN];
      float vx[VN];
      if (pos < kv_end) {
        const int64_t r = rows(pos);
        load_vec(k + r + c, kx);
        load_vec(v + r + c, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) { kx[e] = 0.f; vx[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[key * KS + c + e] = kx[e];
        vs[key * KS + c + e] = vx[e];
      }
    }
    __syncthreads();
    if (live) {
      const int n_tile = min(TK, kv_end - t0);
      for (int j0 = split; j0 < n_tile; j0 += nsplit * kChunk) {
        float s[kChunk];
        float cmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int j = j0 + c * nsplit;
          const int pos = t0 + j;
          float x = -INFINITY;
          if (j < n_tile && pos <= qlimit && pos < window) {
            const float* kr = ks + j * KS;
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D; d += 4) {
              const float4 y = *reinterpret_cast<const float4*>(kr + d);
              dot += qr[d] * y.x + qr[d + 1] * y.y + qr[d + 2] * y.z
                     + qr[d + 3] * y.w;
            }
            x = dot;
          }
          s[c] = x;
          cmax = fmaxf(cmax, x);
        }
        softmax_update<D>(s, cmax, vs + j0 * KS, nsplit * KS, m, l, acc);
      }
    }
  }
  merge_partials<D>(nsplit, m, l, acc);
  if (live && split == 0) {
    const float inv = l > 0.f ? 1.f / l : 0.f;   // no visible key -> 0
#pragma unroll
    for (int d = 0; d < D; ++d) store(out + q_off + d, acc[d] * inv);
  }
}

// Lane layout shared by the kernels: lane -> (pair, split), pair ->
// (row r within the block's bq rows, head g within the GQA group).
struct Lane {
  int r, g, split;
  bool valid;
  __device__ Lane(int group, int nsplit, int bq) {
    const int pair = threadIdx.x / nsplit;
    split = threadIdx.x % nsplit;
    r = pair / group;
    g = pair % group;
    valid = r < bq;
  }
};

// grid (ceil(Sq/bq), Hkv, B). Query i sits at absolute position
// Skv - Sq + i; with causal, keys past the block's last row are skipped.
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
flash_attention_kernel(const T* q, const T* k, const T* v, T* out, int Sq,
                       int Skv, int Hq, int Hkv, int causal, float scale,
                       int nsplit, int bq) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, hk = blockIdx.y, group = Hq / Hkv;
  const Lane ln(group, nsplit, bq);
  const int row0 = blockIdx.x * bq;
  const int row = row0 + ln.r;
  const int shift = Skv - Sq;
  const bool live = ln.valid && row < Sq;
  const int last_row = min(row0 + bq, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + shift + 1) : Skv;
  const int qlimit = causal ? row + shift : INT_MAX;
  const int64_t q_off =
      live ? ((static_cast<int64_t>(b) * Sq + row) * Hq + hk * group + ln.g)
                 * D
           : -1;
  const DenseRows rows{(static_cast<int64_t>(b) * Skv * Hkv + hk) * D,
                       static_cast<int64_t>(Hkv) * D};
  attend<T, D>(q, k, v, out, q_off, qlimit, Skv, kv_end, ln.split, nsplit,
               scale, rows, smem);
}

// grid (1, Hkv, B): one query token per slot against a contiguous cache.
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
flash_decode_kernel(const T* q, const T* k, const T* v, T* out,
                    const int* lengths, int S, int Hq, int Hkv, float scale,
                    int nsplit) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, hk = blockIdx.y, group = Hq / Hkv;
  const Lane ln(group, nsplit, 1);
  const int n = min(max(lengths[b], 0), S);
  const int64_t q_off =
      ln.valid ? (static_cast<int64_t>(b) * Hq + hk * group + ln.g) * D : -1;
  const DenseRows rows{(static_cast<int64_t>(b) * S * Hkv + hk) * D,
                       static_cast<int64_t>(Hkv) * D};
  attend<T, D>(q, k, v, out, q_off, INT_MAX, n, n, ln.split, nsplit, scale,
               rows, smem);
}

// grid (1, Hkv, B): one query token per slot against the block pool.
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
paged_decode_kernel(const T* q, const T* k, const T* v, T* out,
                    const int* block_tables, const int* lengths,
                    int num_blocks, int block_size, int max_blocks, int Hq,
                    int Hkv, float scale, int nsplit) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, hk = blockIdx.y, group = Hq / Hkv;
  const Lane ln(group, nsplit, 1);
  const int n = min(max(lengths[b], 0), max_blocks * block_size);
  const int64_t q_off =
      ln.valid ? (static_cast<int64_t>(b) * Hq + hk * group + ln.g) * D : -1;
  const PagedRows rows{block_tables + static_cast<int64_t>(b) * max_blocks,
                       block_size, num_blocks,
                       static_cast<int64_t>(hk) * D,
                       static_cast<int64_t>(Hkv) * D};
  attend<T, D>(q, k, v, out, q_off, INT_MAX, n, n, ln.split, nsplit, scale,
               rows, smem);
}

// grid (ceil(Sq/bq), Hkv, B): query row i sits at q_offset[b] + i and sees
// keys kpos <= q_offset[b] + i && kpos < lengths[b].
template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
paged_prefill_kernel(const T* q, const T* k, const T* v, T* out,
                     const int* block_tables, const int* lengths,
                     const int* q_offset, int num_blocks, int block_size,
                     int max_blocks, int Sq, int Hq, int Hkv, float scale,
                     int nsplit, int bq) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, hk = blockIdx.y, group = Hq / Hkv;
  const Lane ln(group, nsplit, bq);
  const int row0 = blockIdx.x * bq;
  const int row = row0 + ln.r;
  const bool live = ln.valid && row < Sq;
  const int off = q_offset[b];
  const int n = min(max(lengths[b], 0), max_blocks * block_size);
  const int last_row = min(row0 + bq, Sq) - 1;
  const int kv_end = max(min(n, off + last_row + 1), 0);
  const int64_t q_off =
      live ? ((static_cast<int64_t>(b) * Sq + row) * Hq + hk * group + ln.g)
                 * D
           : -1;
  const PagedRows rows{block_tables + static_cast<int64_t>(b) * max_blocks,
                       block_size, num_blocks,
                       static_cast<int64_t>(hk) * D,
                       static_cast<int64_t>(Hkv) * D};
  attend<T, D>(q, k, v, out, q_off, off + row, n, kv_end, ln.split, nsplit,
               scale, rows, smem);
}

int threads_for(int group, int nsplit, int bq) {
  return ((group * nsplit * bq + 31) / 32) * 32;
}

constexpr size_t smem_bytes(int D) {
  return 2ull * (kTileElems / D) * (D + 4) * sizeof(float);
}

// Launchers: run<T, D>() launches the kernel for one (dtype, head dim).
struct FlashAttentionLaunch {
  const void *q, *k, *v; void* out;
  int B, Sq, Skv, Hq, Hkv, causal; float scale; int nsplit, bq;
  cudaStream_t st;
  template <typename T, int D> void run() const {
    const dim3 grid((Sq + bq - 1) / bq, Hkv, B);
    flash_attention_kernel<T, D><<<grid, threads_for(Hq / Hkv, nsplit, bq),
                                   smem_bytes(D), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
        causal, scale, nsplit, bq);
  }
};

struct FlashDecodeLaunch {
  const void *q, *k, *v; void* out; const void* lengths;
  int B, S, Hq, Hkv; float scale; int nsplit;
  cudaStream_t st;
  template <typename T, int D> void run() const {
    const dim3 grid(1, Hkv, B);
    flash_decode_kernel<T, D><<<grid, threads_for(Hq / Hkv, nsplit, 1),
                                smem_bytes(D), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<const int*>(lengths), S, Hq, Hkv, scale, nsplit);
  }
};

struct PagedDecodeLaunch {
  const void *q, *k, *v; void* out; const void *bt, *lengths;
  int B, NB, Bs, MB, Hq, Hkv; float scale; int nsplit;
  cudaStream_t st;
  template <typename T, int D> void run() const {
    const dim3 grid(1, Hkv, B);
    paged_decode_kernel<T, D><<<grid, threads_for(Hq / Hkv, nsplit, 1),
                                smem_bytes(D), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<const int*>(bt), static_cast<const int*>(lengths), NB,
        Bs, MB, Hq, Hkv, scale, nsplit);
  }
};

struct PagedPrefillLaunch {
  const void *q, *k, *v; void* out; const void *bt, *lengths, *offs;
  int B, Sq, NB, Bs, MB, Hq, Hkv; float scale; int nsplit, bq;
  cudaStream_t st;
  template <typename T, int D> void run() const {
    const dim3 grid((Sq + bq - 1) / bq, Hkv, B);
    paged_prefill_kernel<T, D><<<grid, threads_for(Hq / Hkv, nsplit, bq),
                                 smem_bytes(D), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<const int*>(bt), static_cast<const int*>(lengths),
        static_cast<const int*>(offs), NB, Bs, MB, Sq, Hq, Hkv, scale,
        nsplit, bq);
  }
};

// Runs f.run<T, D>() for the runtime (dtype, head dim); returns the
// launch's error (cudaErrorInvalidValue for an unsupported pair).
template <class F>
cudaError_t dispatch(int dtype, int D, const F& f) {
#define REPRO_CASE_D(T)                           \
  switch (D) {                                    \
    case 16: f.template run<T, 16>(); break;      \
    case 32: f.template run<T, 32>(); break;      \
    case 64: f.template run<T, 64>(); break;      \
    case 112: f.template run<T, 112>(); break;    \
    case 128: f.template run<T, 128>(); break;    \
    default: return cudaErrorInvalidValue;        \
  }
  if (dtype == 0) {
    REPRO_CASE_D(float)
  } else if (dtype == 1) {
    REPRO_CASE_D(__nv_bfloat16)
  } else {
    return cudaErrorInvalidValue;
  }
#undef REPRO_CASE_D
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, void* out, int B, int Sq, int Skv,
                          int Hq, int Hkv, int D, int causal, float scale,
                          int nsplit, int bq, void* stream) {
  const FlashAttentionLaunch f{q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                               scale, nsplit, bq,
                               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(dtype, D, f));
}

int repro_flash_decode(int dtype, const void* q, const void* k,
                       const void* v, void* out, const void* lengths, int B,
                       int S, int Hq, int Hkv, int D, float scale,
                       int nsplit, void* stream) {
  const FlashDecodeLaunch f{q, k, v, out, lengths, B, S, Hq, Hkv, scale,
                            nsplit, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(dtype, D, f));
}

int repro_paged_decode(int dtype, const void* q, const void* k_pool,
                       const void* v_pool, void* out,
                       const void* block_tables, const void* lengths, int B,
                       int num_blocks, int block_size, int max_blocks,
                       int Hq, int Hkv, int D, float scale, int nsplit,
                       void* stream) {
  const PagedDecodeLaunch f{q, k_pool, v_pool, out, block_tables, lengths,
                            B, num_blocks, block_size, max_blocks, Hq, Hkv,
                            scale, nsplit,
                            static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(dtype, D, f));
}

int repro_paged_prefill(int dtype, const void* q, const void* k_pool,
                        const void* v_pool, void* out,
                        const void* block_tables, const void* lengths,
                        const void* q_offset, int B, int Sq, int num_blocks,
                        int block_size, int max_blocks, int Hq, int Hkv,
                        int D, float scale, int nsplit, int bq,
                        void* stream) {
  const PagedPrefillLaunch f{q, k_pool, v_pool, out, block_tables, lengths,
                             q_offset, B, Sq, num_blocks, block_size,
                             max_blocks, Hq, Hkv, scale, nsplit, bq,
                             static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(dtype, D, f));
}

}  // extern "C"
