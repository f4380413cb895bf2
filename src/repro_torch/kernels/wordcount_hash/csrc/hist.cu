// hist.cu — the WordCount Map-phase histogram on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wordcount_hash/kernel.py::
// hist_pallas (body _hist_kernel). It computes the function of ref.py::
// hist_plain: for tokens (N,) int32, the (vocab,) int32 count of each key
// in [0, vocab), where a token equal to SENTINEL (2^31 - 1) is skipped and
// the key is the token itself or, in owner mode (hash_mod > 0),
// mix32(token) % hash_mod in uint32 (Murmur3 fmix32). Keys outside
// [0, vocab) are dropped, negative tokens included. The caller zero-fills
// the output.
//
// What bounds it. Each token is read once and each bin written once:
// N * 4 + vocab * 4 bytes (537.9 MB at N = 2^27, V = 262,144: 0.161 ms at
// 3.35 TB/s). The key is a few integer operations a token, far below that.
// So the loop must keep enough bytes in flight to stream at the memory
// rate (Little's law: ~3.35 TB/s x ~0.7 us / 132 SMs ~ 18 KB an SM), and
// its per-token work must not stall the loads behind it.
//
// Design.
//   * One persistent CTA of 1,024 threads an SM. Each thread reads 16-byte
//     vectors, kVec of them a step (neighbouring threads on neighbouring
//     vectors), and issues the next step's loads before it counts the
//     current step's tokens: 64 B a thread, 64 KB an SM, stay in flight
//     while it counts. A head that is not 16-byte aligned (a view at any
//     offset) and a tail that is no multiple of 4 tokens are counted
//     one token a thread before the loop.
//   * The first kHot keys have a counter per thread in shared memory,
//     stored [key][thread], so no two lanes of a warp ever touch one
//     word or one bank: in owner mode (vocab <= kHot) every key, and in
//     count mode the head of a Zipf corpus (keys 1-15 are 63 % of the
//     tokens at a = 1.3; key 1 alone a quarter) count without conflicts
//     and without __match_any_sync.
//   * Keys in [kHot, kPrivBins) have one counter per CTA in shared memory
//     (a shared atomic each; under Zipf(1.3) two lanes of a warp rarely
//     share such a key). Keys past that (2.9 % of Zipf tokens, 84 % of a
//     uniform corpus over 262,144 keys) go to global atomics directly.
//   * The flush: each warp sums a hot key's 1,024 counters by shuffles;
//     the head's non-zero counters go out by one global atomic each, each
//     CTA starting at its own offset so CTAs do not queue on one line.
//   * % hash_mod is Lemire's exact multiply-shift for a runtime divisor
//     ("Faster Remainder by Direct Computation", 2019): with the 64-bit
//     magic M = floor((2^64 - 1) / d) + 1 made once on the host, a mod d is
//     the high 64 bits of (M * a mod 2^64) * d, exact for every 32-bit a
//     and d (d = 1 gives M = 0 and 0).
//   * The host reads the SM count and raises the shared-memory limit once
//     per device, not on every call.
// Counts are int32 sums, exact whatever order the atomics land in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kVec = 4;                      // 16-byte vectors a step
constexpr int kHot = 16;                     // keys with a counter a thread
constexpr int kPrivBins = 40960;             // keys with a counter a CTA
constexpr int kSentinel = 0x7fffffff;
constexpr int kMaxDevices = 64;
constexpr size_t kSmemMax =
    (static_cast<size_t>(kHot) * kThreads + kPrivBins) * sizeof(int);

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// one 16-byte load that is read once: no L1 line, the L2 fetches 256 B.
// volatile, as the shared adds below are: the next step's loads stay
// issued before this step's adds
__device__ __forceinline__ int4 load_stream(const int4* p) {
  int4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void shared_add_one(uint32_t addr) {
  asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(addr) : "memory");
}

struct Bins {
  uint32_t lane;    // shared address of this thread's counter of key 0;
                    // key k < hot at lane + 4 k kThreads
  uint32_t head;    // shared address of the CTA counter of key 0; keys in
                    // [hot, priv) at head + 4 k
  int* out;
  uint32_t vocab, hash_mod, priv, hot;
  unsigned long long magic;

  __device__ __forceinline__ void take(int tok) const {
    uint32_t key = static_cast<uint32_t>(tok);
    if (hash_mod)
      key = static_cast<uint32_t>(__umul64hi(
          magic * mix32(key), static_cast<unsigned long long>(hash_mod)));
    if (tok == kSentinel || key >= vocab) return;
    if (key < priv)
      shared_add_one(key < hot ? lane + key * (4 * kThreads)
                               : head + 4 * key);
    else
      atomicAdd(out + key, 1);
  }

  __device__ __forceinline__ void take(const int4& v) const {
    take(v.x);
    take(v.y);
    take(v.z);
    take(v.w);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    hist_kernel(const int* __restrict__ tokens, long long n,
                int* __restrict__ out, uint32_t vocab, uint32_t hash_mod,
                unsigned long long magic, uint32_t priv, uint32_t hot) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int tid = threadIdx.x;
  const int words = static_cast<int>(hot) * kThreads + static_cast<int>(priv);
  for (int i = tid; i < (words + 3) / 4; i += kThreads)
    smem4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const Bins bins{base + 4 * tid, base + 4 * (hot * kThreads - hot), out,
                  vocab, hash_mod, priv, hot, magic};

  // tokens before the first 16-byte boundary and after the last vector
  const long long skew = (reinterpret_cast<uintptr_t>(tokens) >> 2) & 3;
  const long long lead = ((4 - skew) & 3) < n ? ((4 - skew) & 3) : n;
  const long long nv = (n - lead) >> 2;
  const long long trail = (n - lead) & 3;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (g < lead + trail)
    bins.take(tokens[g < lead ? g : lead + 4 * nv + (g - lead)]);

  const int4* vec = reinterpret_cast<const int4*>(tokens + lead);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int4 none = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
  int4 cur[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long long j = g + u * stride;
    cur[u] = j < nv ? load_stream(vec + j) : none;
  }
  for (long long i = g; i < nv; i += kVec * stride) {
    int4 nxt[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long j = i + (kVec + u) * stride;
      nxt[u] = j < nv ? load_stream(vec + j) : none;
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) bins.take(cur[u]);
#pragma unroll
    for (int u = 0; u < kVec; ++u) cur[u] = nxt[u];
  }
  __syncthreads();

  // hot keys: warp w sums key w's counters over the CTA's threads
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = warp; k < static_cast<int>(hot); k += kThreads / 32) {
    int s = 0;
    for (int t = lane; t < kThreads; t += 32) s += smem[k * kThreads + t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && s) atomicAdd(out + k, s);
  }
  // the head, from this CTA's own offset round
  const int* head = smem + hot * kThreads - hot;
  const int span = static_cast<int>(priv - hot);
  const int shift =
      span ? static_cast<int>((static_cast<long long>(blockIdx.x) * span) /
                              gridDim.x)
           : 0;
  for (int j = tid; j < span; j += kThreads) {
    int key = static_cast<int>(hot) + j + shift;
    if (key >= static_cast<int>(priv)) key -= span;
    const int c = head[key];
    if (c) atomicAdd(out + key, c);
  }
}

int g_sms[kMaxDevices];    // SM count of each device, 0 until first use

}  // namespace

// Launch on ``stream`` (PyTorch's current stream) into ``out`` (vocab,)
// int32, which the caller has zero-filled. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not
// take, so the caller can raise.
extern "C" int hist_launch(const void* tokens, long long n, void* out,
                           int vocab, int hash_mod, void* stream) {
  if (n <= 0 || vocab <= 0 || hash_mod < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_sms[device] == 0) {
    err = cudaFuncSetAttribute(hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemMax));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device] = sms;
  }
  const uint32_t priv = vocab < kPrivBins ? vocab : kPrivBins;
  const uint32_t hot = priv < kHot ? priv : kHot;
  const size_t smem = (static_cast<size_t>(hot) * kThreads + priv + 3) / 4 *
                      4 * sizeof(int);
  const unsigned long long magic =
      hash_mod ? ~0ULL / static_cast<unsigned>(hash_mod) + 1 : 0;
  const long long per_cta = static_cast<long long>(kThreads) * kVec * 4;
  long long blocks = (n + per_cta - 1) / per_cta;
  if (blocks > g_sms[device]) blocks = g_sms[device];
  hist_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), n, static_cast<int*>(out),
      static_cast<uint32_t>(vocab), static_cast<uint32_t>(hash_mod), magic,
      priv, hot);
  return static_cast<int>(cudaGetLastError());
}
