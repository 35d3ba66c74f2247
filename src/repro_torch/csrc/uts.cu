// UTS node expansion, hand-written for Hopper (sm_90a).
//
//   uts_expand_kernel  replaces repro/kernels/uts_expand.py uts_expand
//                      (its Pallas body _kernel)
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
// at 3.35 TB/s. Its ~95 int32 operations a lane (three fmix32 of 8, 7 to
// mix the index in, 32 compares and 32 adds) are ~25 M operations, ~0.74 us
// at one operation per lane per clock on 132 SMs x 128 lanes x 1.98 GHz.
// So it is bound by the bytes it writes. The UTS loop launches it once per
// iteration of process (up to n a superstep), so there its launch and the
// host work around it cost more than the kernel.
//
// What the design does about it:
//   * The TPU kernel expands a (block_m, width) VMEM block per grid step
//     and needs M % block_m == 0. Here one thread owns one (node, lane) of
//     the flattened M x width grid, bounds-checked, in a grid-stride loop:
//     any M is taken, and consecutive threads write consecutive words
//     (coalesced 128-byte stores per warp).
//   * The 32 thresholds are loaded once per block into shared memory; the
//     32 compares are unrolled and read them as warp-wide broadcasts.
//   * Descriptors arrive and leave as 32-bit words: the host side keeps
//     them in int32 tensors holding the uint32 bits, the kernel reads the
//     same bits as uint32.
//
// Interface: a plain C function (loaded with ctypes) returning the
// cudaError_t of its launch. Pointers are device pointers; the stream is a
// cudaStream_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChild = 32;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride cap: 16 blocks per SM
constexpr uint32_t kC1 = 0x7FEB352Du;
constexpr uint32_t kC2 = 0x846CA68Bu;
constexpr uint32_t kC3 = 0x9E3779B9u;
constexpr uint32_t kC4 = 0x85EBCA77u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 15;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kThreads)
    uts_expand_kernel(const uint32_t* __restrict__ d0,
                      const uint32_t* __restrict__ d1,
                      const int32_t* __restrict__ base,
                      const uint32_t* __restrict__ thresholds,
                      uint32_t* __restrict__ cd0, uint32_t* __restrict__ cd1,
                      int32_t* __restrict__ m, int M, int W) {
  __shared__ uint32_t thr[kMaxChild];
  if (threadIdx.x < kMaxChild) thr[threadIdx.x] = thresholds[threadIdx.x];
  __syncthreads();
  // total < 2^31 (checked by the host side) and the stride < 2^20, so the
  // unsigned index never wraps.
  const unsigned total = static_cast<unsigned>(M) * W;
  const unsigned width = static_cast<unsigned>(W);
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
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

}  // namespace

extern "C" {

// d0, d1 (M,) uint32 bits; base (M,) int32; thresholds (32,) uint32 bits ->
// cd0, cd1 (M, W) uint32 bits, m (M, W) int32. M >= 1, W >= 1 and
// M * W < 2^31; anything else returns cudaErrorInvalidValue unlaunched.
int repro_uts_expand(const void* d0, const void* d1, const void* base,
                     const void* thresholds, void* cd0, void* cd1, void* m,
                     int M, int W, void* stream) {
  if (M < 1 || W < 1 ||
      static_cast<long long>(M) * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(M) * W;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  uts_expand_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d0), static_cast<const uint32_t*>(d1),
      static_cast<const int32_t*>(base),
      static_cast<const uint32_t*>(thresholds), static_cast<uint32_t*>(cd0),
      static_cast<uint32_t*>(cd1), static_cast<int32_t*>(m), M, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
