// hist.cu — the WordCount Map-phase histogram on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wordcount_hash/kernel.py::
// hist_pallas (body _hist_kernel). It computes the function of ref.py::
// hist_plain: for tokens (N,) int32, the (vocab,) int32 count of each key
// in [0, vocab), where a token equal to SENTINEL (2^31 - 1) is skipped and
// the key is the token itself or, in owner mode (hash_mod > 0),
// mix32(token) % hash_mod in uint32 (Murmur3 fmix32). Keys outside
// [0, vocab) are dropped. The caller zero-fills the output.
//
// Design. The TPU kernel avoided scatters with a (tokens x vocab-tile)
// compare-reduce, which at V = 262,144 and 2^27 tokens is 3.5e13
// compares. On Hopper the scatter is the native form:
//   * a persistent grid (two CTAs of 512 threads per SM) walks the tokens,
//     each warp reading 128 consecutive tokens per step, coalesced;
//   * the first min(vocab, 24,576) keys — the head of a Zipf corpus, about
//     96 % of its tokens at a = 1.3 — are privatised per CTA in dynamic
//     shared memory (96 KB), and flushed at the end with one global
//     atomicAdd per non-zero bin; keys past that go to global atomics
//     directly;
//   * before any atomic, the lanes of a warp holding the same key are
//     found with __match_any_sync and only the lowest adds their count:
//     under Zipf(1.3) a quarter of all tokens are key 1, and in owner mode
//     every token falls into hash_mod bins, so unaggregated atomics on one
//     address would serialise.
// Counts are int32 sums, exact whatever order the atomics land in.
//
// What bounds it. Each token is read once and each bin written once:
// N * 4 + vocab * 4 bytes (537.9 MB at N = 2^27, V = 262,144: 0.161 ms at
// 3.35 TB/s). The key arithmetic is a few integer operations a token, far
// below that. What can hold it back is the instruction rate of the
// atomics and matches, not the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPerLane = 4;                  // tokens a lane takes per step
constexpr int kPrivBins = 24576;             // 96 KB of shared counters
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ tokens, long long n,
                int* __restrict__ out, int vocab, unsigned hash_mod,
                int priv) {
  extern __shared__ int bins[];
  for (int i = threadIdx.x; i < priv; i += kThreads) bins[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long step = warps * 32 * kPerLane;
  long long base =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32) *
      32 * kPerLane;
  // `base` is the same for every lane of a warp, so all 32 lanes run the
  // same iterations and every __match_any_sync sees the whole warp
  for (; base < n; base += step) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const long long i = base + j * 32 + lane;
      const int tok = i < n ? tokens[i] : kSentinel;
      int key = -1;
      if (tok != kSentinel) {
        const long long k =
            hash_mod ? static_cast<long long>(
                           mix32(static_cast<uint32_t>(tok)) % hash_mod)
                     : static_cast<long long>(tok);
        if (k >= 0 && k < vocab) key = static_cast<int>(k);
      }
      const unsigned same = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == __ffs(same) - 1) {
        const int c = __popc(same);
        if (key < priv)
          atomicAdd(&bins[key], c);
        else
          atomicAdd(&out[key], c);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < priv; i += kThreads) {
    const int c = bins[i];
    if (c) atomicAdd(&out[i], c);
  }
}

}  // namespace

// Launch on ``stream`` (PyTorch's current stream) into ``out`` (vocab,)
// int32, which the caller has zero-filled. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not
// take, so the caller can raise.
extern "C" int hist_launch(const void* tokens, long long n, void* out,
                           int vocab, int hash_mod, void* stream) {
  if (n <= 0 || vocab <= 0 || hash_mod < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int priv = vocab < kPrivBins ? vocab : kPrivBins;
  const size_t smem = static_cast<size_t>(priv) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long per_cta = static_cast<long long>(kThreads) * kPerLane;
  long long blocks = (n + per_cta - 1) / per_cta;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  hist_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), n, static_cast<int*>(out), vocab,
      static_cast<unsigned>(hash_mod), priv);
  return static_cast<int>(cudaGetLastError());
}
