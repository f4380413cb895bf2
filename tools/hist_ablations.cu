// hist_ablations.cu — the loop of the first Hopper hist kernel
// (csrc/hist.cu before its redesign), cut down stage by stage, to find which
// stage of the per-token work sets its pace. Measurement only: nothing of
// the port calls it; tools/hist_turns.py builds and times it.
//
// The grid, block, loads and loop order are those of the old kernel: a
// persistent grid of two 512-thread CTAs an SM, each lane taking four
// scalar 4-byte loads a step, a warp reading 128 consecutive tokens. Each
// mode keeps what the stages before it computed alive by folding it into
// one per-thread value that is added to out[0] at the end:
//   mode 0  loads only: the sum of the tokens;
//   mode 1  loads and key: the keys (SENTINEL, the owner hash, the range);
//   mode 2  loads, key and match: __match_any_sync, __ffs and __popc;
//   mode 3  the whole loop: the shared and global atomics and the flush.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPerLane = 4;
constexpr int kPrivBins = 24576;
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    ablate_kernel(const int* __restrict__ tokens, long long n,
                  int* __restrict__ out, int vocab, unsigned hash_mod,
                  int priv) {
  extern __shared__ int bins[];
  if (kMode == 3) {
    for (int i = threadIdx.x; i < priv; i += kThreads) bins[i] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long step = warps * 32 * kPerLane;
  long long base =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32) *
      32 * kPerLane;
  unsigned acc = 0;
  for (; base < n; base += step) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const long long i = base + j * 32 + lane;
      const int tok = i < n ? tokens[i] : kSentinel;
      if (kMode == 0) {
        acc += static_cast<unsigned>(tok);
        continue;
      }
      int key = -1;
      if (tok != kSentinel) {
        const long long k =
            hash_mod ? static_cast<long long>(
                           mix32(static_cast<uint32_t>(tok)) % hash_mod)
                     : static_cast<long long>(tok);
        if (k >= 0 && k < vocab) key = static_cast<int>(k);
      }
      if (kMode == 1) {
        acc += static_cast<unsigned>(key);
        continue;
      }
      const unsigned same = __match_any_sync(0xffffffffu, key);
      if (kMode == 2) {
        if (key >= 0 && lane == __ffs(same) - 1) acc += __popc(same);
        continue;
      }
      if (key >= 0 && lane == __ffs(same) - 1) {
        const int c = __popc(same);
        if (key < priv)
          atomicAdd(&bins[key], c);
        else
          atomicAdd(&out[key], c);
      }
    }
  }
  if (kMode != 3) {
    if (acc == 0x9e3779b9u) atomicAdd(&out[0], 1);   // keeps acc alive
    return;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < priv; i += kThreads) {
    const int c = bins[i];
    if (c) atomicAdd(&out[i], c);
  }
}

template <int kMode>
int launch(const void* tokens, long long n, void* out, int vocab,
           int hash_mod, void* stream) {
  const int priv = vocab < kPrivBins ? vocab : kPrivBins;
  const size_t smem = kMode == 3 ? static_cast<size_t>(priv) * sizeof(int) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      ablate_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long per_cta = static_cast<long long>(kThreads) * kPerLane;
  long long blocks = (n + per_cta - 1) / per_cta;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  ablate_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), n, static_cast<int*>(out), vocab,
      static_cast<unsigned>(hash_mod), priv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist_launch's arguments, and the mode (0-3) of the ablation
extern "C" int hist_ablate_launch(const void* tokens, long long n, void* out,
                                  int vocab, int hash_mod, int mode,
                                  void* stream) {
  if (n <= 0 || vocab <= 0 || hash_mod < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return launch<0>(tokens, n, out, vocab, hash_mod, stream);
    case 1: return launch<1>(tokens, n, out, vocab, hash_mod, stream);
    case 2: return launch<2>(tokens, n, out, vocab, hash_mod, stream);
    case 3: return launch<3>(tokens, n, out, vocab, hash_mod, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
