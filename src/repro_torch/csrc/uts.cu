// UTS node expansion, hand-written for Hopper (sm_90a).
//
//   uts_expand_kernel       replaces repro/kernels/uts_expand.py uts_expand
//                           (its Pallas body _kernel)
//   uts_expand_lane_kernel  the first version of the same (one thread per
//                           (node, lane)); the port no longer calls it,
//                           it is kept to be timed beside its successor
//
// What it computes, for M tree nodes (d0, d1) and `width` consecutive child
// indices idx = base + lane of each: the child descriptor
//   h0 = fmix32(d0 + idx * C3)
//   h1 = fmix32((d1 ^ h0) + idx * C4)
//   h0 = fmix32(h0 ^ h1)
// and its geometric child count #{k < 32 : h0 < T_k} (unsigned compares
// against the 32 thresholds of the tree's law), all in uint32 arithmetic
// modulo 2^32, bit-exact with the plain version (uts_expand_ref).
//
// What bounds it on an H100. At the UTS path's shape (M = 1024 places,
// width 256) it reads 12 KB of nodes and writes 3 MB of children: ~0.94 us
// at 3.35 TB/s. The function's ~95 int32 operations a lane (three fmix32
// of 8, 7 to mix the index in, 32 compares and 32 adds) are ~25 M
// operations, ~0.74 us at one operation per lane per clock on 132 SMs x
// 128 lanes x 1.98 GHz. So it is bound by the bytes it writes, over a
// launch that alone takes ~1.5 us replayed from a CUDA graph. The UTS
// loop launches it once per iteration of process (up to n a superstep), so
// there its launch and the host work around it cost more than the kernel.
//
// What the design does about it:
//   * The TPU kernel expands a (block_m, width) VMEM block per grid step
//     and needs M % block_m == 0. Here each thread owns kVec = 2
//     consecutive lanes of one node (any M is taken): it loads the node's
//     d0, d1 and base once, and writes its 2 descriptors and counts as one
//     8-byte store per output; a row whose width is odd (its rows are then
//     not 8-byte aligned) and its tail lane use scalar stores. On the card
//     (tools/uts_ab.py) 1 or 2 lanes a thread ran fastest, 4 slower and 8
//     much slower (too few threads to cover the latencies). The width is
//     a template parameter for the widths the executor and its tests run
//     (256, 64), so the node and lane of a thread come from shifts; any
//     other width takes the same kernel with the width at run time (one
//     division a thread, not one a lane). The grid is at most one wave
//     (132 SMs x 2,048 threads) and strides over the rest.
//   * The child count without 32 compares: each warp holds the table in
//     registers, T_k in lane k (read with __ldg; no shared memory, no
//     barrier), and checks with one vote that it is non-increasing, as
//     geom_thresholds makes it (T_k = floor(p^k 2^32), p < 1). Then
//     h0 < T_k holds for a prefix k < count, and the count is a branchless
//     binary search: five halving steps find min(count, 31), each reading
//     T at the current guess by a shuffle, and one last compare against
//     T at the result tells 31 from 32. A table that is not non-increasing
//     is counted by the 32 compares (shuffle broadcasts), so any table is
//     bit-exact. The vote needs no host sync and no argument.
//   * Descriptors arrive and leave as 32-bit words: the host side keeps
//     them in int32 tensors holding the uint32 bits, the kernel reads the
//     same bits as uint32.
//
// Interface: plain C functions (loaded with ctypes) returning the
// cudaError_t of their launch. Pointers are device pointers; the stream is
// a cudaStream_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChild = 32;
constexpr uint32_t kC1 = 0x7FEB352Du;
constexpr uint32_t kC2 = 0x846CA68Bu;
constexpr uint32_t kC3 = 0x9E3779B9u;
constexpr uint32_t kC4 = 0x85EBCA77u;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 15;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// ---------------------------------------------------------------- current
constexpr int kThreads = 128;
constexpr int kVec = 2;          // lanes a thread: 1, 2 or 4k
constexpr int kMaxBlocks = 132 * 2048 / kThreads;   // one wave

// #{k : h0 < T_k} with T_k in lane k of the warp (thr). With `sorted`
// (the table is non-increasing, warp-uniform) a binary search, else the
// 32 compares. Every lane of the warp must call it.
__device__ __forceinline__ int child_count(uint32_t h0, uint32_t thr,
                                           bool sorted) {
  int c = 0;
  if (sorted) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      c += h0 < __shfl_sync(kFull, thr, c + s - 1) ? s : 0;
    c += h0 < __shfl_sync(kFull, thr, c) ? 1 : 0;   // 31 or 32
  } else {
#pragma unroll
    for (int k = 0; k < kMaxChild; ++k)
      c += h0 < __shfl_sync(kFull, thr, k) ? 1 : 0;
  }
  return c;
}

// kW > 0: the width, known at compile time; kW == 0: the width W at run
// time. grid <= one wave of 128-thread blocks, striding over M *
// ceil(W / 4) threads' worth of lanes.
template <int kW>
__global__ void __launch_bounds__(kThreads)
    uts_expand_kernel(const uint32_t* __restrict__ d0,
                      const uint32_t* __restrict__ d1,
                      const int32_t* __restrict__ base,
                      const uint32_t* __restrict__ thresholds,
                      uint32_t* __restrict__ cd0, uint32_t* __restrict__ cd1,
                      int32_t* __restrict__ m, int M, int W_rt) {
  const unsigned W = kW > 0 ? kW : W_rt;
  const unsigned per_node = (W + kVec - 1) / kVec;     // threads a node
  const bool vec_rows = W % kVec == 0;        // rows aligned for them
  const uint32_t thr = __ldg(thresholds + (threadIdx.x & 31));
  const uint32_t next = __shfl_down_sync(kFull, thr, 1);
  const bool sorted = __all_sync(kFull, (threadIdx.x & 31) == 31 ||
                                            thr >= next);
  // total < 2^31 (checked by the host side) and the stride < 2^18, so the
  // unsigned index never wraps. The loop bound is the same for the whole
  // block, so every lane reaches the shuffles; lanes past the end compute
  // on node 0 and store nothing.
  const unsigned total = static_cast<unsigned>(M) * per_node;
  for (unsigned t0 = blockIdx.x * kThreads; t0 < total;
       t0 += gridDim.x * kThreads) {
    const unsigned t = t0 + threadIdx.x;
    const bool live = t < total;
    const unsigned node = live ? t / per_node : 0;
    const unsigned lane0 = (live ? t - node * per_node : 0) * kVec;
    const uint32_t a0 = __ldg(d0 + node), a1 = __ldg(d1 + node);
    const uint32_t idx0 = static_cast<uint32_t>(__ldg(base + node)) + lane0;
    uint32_t h0v[kVec], h1v[kVec];
    int mv[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const uint32_t idx = idx0 + e;
      uint32_t h0 = fmix32(a0 + idx * kC3);
      const uint32_t h1 = fmix32((a1 ^ h0) + idx * kC4);
      h0 = fmix32(h0 ^ h1);
      h0v[e] = h0;
      h1v[e] = h1;
      mv[e] = child_count(h0, thr, sorted);
    }
    if (!live) continue;
    const size_t off = static_cast<size_t>(node) * W + lane0;
    if (vec_rows) {
      if constexpr (kVec == 1) {
        cd0[off] = h0v[0];
        cd1[off] = h1v[0];
        m[off] = mv[0];
      } else if constexpr (kVec == 2) {
        *reinterpret_cast<uint2*>(cd0 + off) = make_uint2(h0v[0], h0v[1]);
        *reinterpret_cast<uint2*>(cd1 + off) = make_uint2(h1v[0], h1v[1]);
        *reinterpret_cast<int2*>(m + off) = make_int2(mv[0], mv[1]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          *reinterpret_cast<uint4*>(cd0 + off + e) =
              make_uint4(h0v[e], h0v[e + 1], h0v[e + 2], h0v[e + 3]);
          *reinterpret_cast<uint4*>(cd1 + off + e) =
              make_uint4(h1v[e], h1v[e + 1], h1v[e + 2], h1v[e + 3]);
          *reinterpret_cast<int4*>(m + off + e) =
              make_int4(mv[e], mv[e + 1], mv[e + 2], mv[e + 3]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (lane0 + e < W) {
          cd0[off + e] = h0v[e];
          cd1[off + e] = h1v[e];
          m[off + e] = mv[e];
        }
      }
    }
  }
}

template <int kW>
cudaError_t launch(const void* d0, const void* d1, const void* base,
                   const void* thresholds, void* cd0, void* cd1, void* m,
                   int M, int W, cudaStream_t st) {
  const long long total =
      static_cast<long long>(M) * ((W + kVec - 1) / kVec);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  uts_expand_kernel<kW><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(d0), static_cast<const uint32_t*>(d1),
      static_cast<const int32_t*>(base),
      static_cast<const uint32_t*>(thresholds), static_cast<uint32_t*>(cd0),
      static_cast<uint32_t*>(cd1), static_cast<int32_t*>(m), M, W);
  return cudaGetLastError();
}

// ---------------------------------------------------- the first version
constexpr int kLaneThreads = 256;
constexpr int kLaneMaxBlocks = 132 * 16;   // grid-stride cap: 16 per SM

// One thread per (node, lane) of the flattened M x W grid, the thresholds
// in shared memory, 32 compares a lane.
__global__ void __launch_bounds__(kLaneThreads)
    uts_expand_lane_kernel(const uint32_t* __restrict__ d0,
                           const uint32_t* __restrict__ d1,
                           const int32_t* __restrict__ base,
                           const uint32_t* __restrict__ thresholds,
                           uint32_t* __restrict__ cd0,
                           uint32_t* __restrict__ cd1,
                           int32_t* __restrict__ m, int M, int W) {
  __shared__ uint32_t thr[kMaxChild];
  if (threadIdx.x < kMaxChild) thr[threadIdx.x] = thresholds[threadIdx.x];
  __syncthreads();
  const unsigned total = static_cast<unsigned>(M) * W;
  const unsigned width = static_cast<unsigned>(W);
  for (unsigned i = blockIdx.x * kLaneThreads + threadIdx.x; i < total;
       i += gridDim.x * kLaneThreads) {
    const unsigned node = i / width;
    const uint32_t idx = static_cast<uint32_t>(base[node]) + (i - node * width);
    uint32_t h0 = fmix32(d0[node] + idx * kC3);
    const uint32_t h1 = fmix32((d1[node] ^ h0) + idx * kC4);
    h0 = fmix32(h0 ^ h1);
    int count = 0;
#pragma unroll
    for (int k = 0; k < kMaxChild; ++k) count += h0 < thr[k] ? 1 : 0;
    cd0[i] = h0;
    cd1[i] = h1;
    m[i] = count;
  }
}

bool bad_shape(int M, int W) {
  return M < 1 || W < 1 || static_cast<long long>(M) * W >= (1LL << 31);
}

}  // namespace

extern "C" {

// d0, d1 (M,) uint32 bits; base (M,) int32; thresholds (32,) uint32 bits ->
// cd0, cd1 (M, W) uint32 bits, m (M, W) int32, each 8-byte aligned where
// W is even. M >= 1, W >= 1 and M * W < 2^31; anything else returns
// cudaErrorInvalidValue unlaunched.
int repro_uts_expand(const void* d0, const void* d1, const void* base,
                     const void* thresholds, void* cd0, void* cd1, void* m,
                     int M, int W, void* stream) {
  if (bad_shape(M, W)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (W) {
    case 256: err = launch<256>(d0, d1, base, thresholds, cd0, cd1, m, M, W, st); break;
    case 64: err = launch<64>(d0, d1, base, thresholds, cd0, cd1, m, M, W, st); break;
    default: err = launch<0>(d0, d1, base, thresholds, cd0, cd1, m, M, W, st);
  }
  return static_cast<int>(err);
}

// The same function by the first version's kernel (uts_expand_lane_kernel).
int repro_uts_expand_lane(const void* d0, const void* d1, const void* base,
                          const void* thresholds, void* cd0, void* cd1,
                          void* m, int M, int W, void* stream) {
  if (bad_shape(M, W)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(M) * W;
  long long blocks = (total + kLaneThreads - 1) / kLaneThreads;
  if (blocks > kLaneMaxBlocks) blocks = kLaneMaxBlocks;
  uts_expand_lane_kernel<<<static_cast<int>(blocks), kLaneThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d0), static_cast<const uint32_t*>(d1),
      static_cast<const int32_t*>(base),
      static_cast<const uint32_t*>(thresholds), static_cast<uint32_t*>(cd0),
      static_cast<uint32_t*>(cd1), static_cast<int32_t*>(m), M, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
