// slots_ablations.cu — the bucket-slot kernel cut down stage by stage, and
// varied, for tools/slots_turns.py --ablate.
//
// The first design of src/repro_torch/kernels/moe_dispatch/csrc/
// bucket_slots.cu (256-thread CTAs, a tile of 256 * kItems ids, a
// decoupled look-back over epoch-tagged status words), kept to measure
// where its time went, with
//   kStage 0: load the ids and write them back as slots (the streaming);
//          1: + the rank in the tile (slots = the place in the tile);
//          2: + publish and look back: the whole kernel, exact;
//   kBallot: rank by log2(E) ballots in place of __match_any_sync;
//   kBackoff: __nanosleep between two reads of a word not yet published;
//   kTogether: re-read every word of a look-back round not yet published
//          at once (the shipping kernel), not one word after another;
//   kItems: ids a thread (the tile is 256 kItems ids);
//   kTrace: each CTA writes the device's clock (%globaltimer, ns) and its
//          SM's (clock64) at its start and after its rank, its publish,
//          its look-back and its stores, and its SM, into the buffer
//          slots_ablate_set_trace set.
// Its device times say where the time of a call goes; only kStage 2 is
// held to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLook = 16;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;
constexpr int kNone = 0x7fffffff;
constexpr long long kSpinLimit = 1ll << 22;
// a CTA's trace: %globaltimer at start, rank, publish, look-back and end;
// its SM; clock64() at the same five points
constexpr int kTracePoints = 11;

__device__ unsigned long long* g_trace;

__device__ __forceinline__ void stamp(int tile, int point) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_trace[tile * kTracePoints + point] = t;
  g_trace[tile * kTracePoints + 6 + point] = clock64();
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned flag,
                                        unsigned epoch, unsigned count) {
  const unsigned long long v =
      (static_cast<unsigned long long>((epoch << 2) | flag) << 32) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

template <int kStage, bool kBallot, bool kBackoff, bool kTogether,
          int kItems, bool kTrace = false>
__global__ void __launch_bounds__(kThreads, 4)
    ablate_kernel(const int* __restrict__ ids, long long T, int E,
                  int group_log2, int id_bits, int* __restrict__ slots,
                  int* __restrict__ counts, unsigned* epoch_word,
                  unsigned long long* status) {
  constexpr int kTile = kThreads * kItems;
  extern __shared__ int smem[];
  int* woff = smem;
  int* pre = smem + kWarps * E;
  const int tile = blockIdx.x, nb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kTrace && threadIdx.x == 0) {
    stamp(tile, 0);
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_trace[tile * kTracePoints + 5] = sm;
  }
  unsigned epoch;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(epoch)
               : "l"(epoch_word) : "memory");
  epoch += 1u;
  const long long first = static_cast<long long>(tile) * kTile +
                          warp * (kItems * 32) + lane;
  int id[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long t = first + j * 32;
    id[j] = t < T ? __ldg(ids + t) : -1;
  }
  if (kStage == 0) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long t = first + j * 32;
      if (t < T) slots[t] = id[j];
    }
    return;
  }
  for (int i = threadIdx.x; i < kWarps * E; i += kThreads) woff[i] = 0;
  __syncthreads();
  int* mine = woff + warp * E;
  const unsigned lanes_below = (1u << lane) - 1u;
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = static_cast<unsigned>(id[j]) < static_cast<unsigned>(E);
    unsigned same;
    if (kBallot) {
      same = __ballot_sync(0xffffffffu, valid);
      for (int b = 0; b < id_bits; ++b) {
        const bool bit = (id[j] >> b) & 1;
        const unsigned m = __ballot_sync(0xffffffffu, bit);
        same &= bit ? m : ~m;
      }
    } else {
      same = __match_any_sync(0xffffffffu, valid ? id[j] : -1);
    }
    const int below = __popc(same & lanes_below);
    rank[j] = valid ? mine[id[j]] + below : -1;
    __syncwarp();
    if (valid && below == 0) mine[id[j]] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  if (kTrace && threadIdx.x == 0) stamp(tile, 1);
  if (threadIdx.x < E) {
    const int e = threadIdx.x;
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = woff[w * E + e];
      woff[w * E + e] = run;
      run += c;
    }
    pre[e] = run;
    if (kStage == 2)
      publish(status + static_cast<long long>(e) * nb + tile,
              tile == 0 ? kInclusive : kAggregate, epoch, run);
  }
  __syncthreads();
  if (kTrace && threadIdx.x == 0) stamp(tile, 2);
  int packed[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    packed[j] = rank[j] < 0 ? -1 : ((mine[id[j]] + rank[j]) << 8) | id[j];
  if (kStage == 1) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long t = first + j * 32;
      if (t < T) slots[t] = packed[j] < 0 ? -1 : packed[j] >> 8;
    }
    return;
  }

  const int P = 1 << group_log2;
  const int e = threadIdx.x >> group_log2;
  const int p = threadIdx.x & (P - 1);
  unsigned long long* column = status + static_cast<long long>(e) * nb;
  unsigned prefix = 0;
  bool done = tile == 0 || e >= E;
  long long hi = tile;
  while (__any_sync(0xffffffffu, !done)) {
    unsigned long long word[kLook];
    int newest = kNone;
    if (!done) {
#pragma unroll
      for (int c = 0; c < kLook; ++c) {
        const long long j = hi - 1 - p - static_cast<long long>(P) * c;
        word[c] = j >= 0 ? load_relaxed(column + j) : 0ull;
      }
      if (kTogether) {
        unsigned pending = 0;
#pragma unroll
        for (int c = 0; c < kLook; ++c)
          if (hi - 1 - p - P * c >= 0 && (word[c] >> 34) != epoch)
            pending |= 1u << c;
        for (long long spins = 0; pending; ++spins) {
          if (spins > kSpinLimit) __trap();
#pragma unroll
          for (int c = 0; c < kLook; ++c)
            if ((pending >> c) & 1u)
              word[c] = load_relaxed(column + (hi - 1 - p - P * c));
#pragma unroll
          for (int c = 0; c < kLook; ++c)
            if (((pending >> c) & 1u) && (word[c] >> 34) == epoch)
              pending &= ~(1u << c);
        }
      }
#pragma unroll
      for (int c = 0; c < kLook; ++c) {
        const long long j = hi - 1 - p - static_cast<long long>(P) * c;
        if (j < 0) break;
        long long spins = 0;
        while ((word[c] >> 34) != epoch) {
          if (++spins > kSpinLimit) __trap();
          if (kBackoff) __nanosleep(64);
          word[c] = load_relaxed(column + j);
        }
        if (newest == kNone && ((word[c] >> 32) & 3u) == kInclusive)
          newest = p + P * c;
      }
    }
    for (int o = P >> 1; o > 0; o >>= 1)
      newest = min(newest, __shfl_xor_sync(0xffffffffu, newest, o, P));
    unsigned sum = 0;
    if (!done) {
#pragma unroll
      for (int c = 0; c < kLook; ++c) {
        const int r = p + P * c;
        if (hi - 1 - r >= 0 && r <= newest)
          sum += static_cast<unsigned>(word[c]);
      }
    }
    for (int o = P >> 1; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o, P);
    if (!done) {
      prefix += sum;
      hi -= static_cast<long long>(P) * kLook;
      done = newest != kNone || hi <= 0;
    }
  }
  if (e < E && p == 0) {
    const unsigned count = static_cast<unsigned>(pre[e]);
    if (tile > 0) publish(column + tile, kInclusive, epoch, prefix + count);
    pre[e] = static_cast<int>(prefix);
    if (tile == nb - 1) counts[e] = static_cast<int>(prefix + count);
  }
  __syncthreads();
  if (kTrace && threadIdx.x == 0) stamp(tile, 3);
  if (tile == nb - 1 && threadIdx.x == 0)
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(epoch_word),
                 "r"(epoch) : "memory");
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long t = first + j * 32;
    if (t < T)
      slots[t] = packed[j] < 0 ? -1 : pre[packed[j] & 255] + (packed[j] >> 8);
  }
  if (kTrace) {
    __syncthreads();
    if (threadIdx.x == 0) stamp(tile, 4);
  }
}

template <int kStage, bool kBallot, bool kBackoff, bool kTogether,
          int kItems, bool kTrace = false>
int launch(const void* eids, long long T, int E, void* slots, void* counts,
           void* scratch, cudaStream_t s) {
  const long long nb = (T + kThreads * kItems - 1) / (kThreads * kItems);
  int group_log2 = 0;
  while (group_log2 < 5 && (2 << group_log2) * E <= kThreads) ++group_log2;
  int id_bits = 0;
  while ((1 << id_bits) < E) ++id_bits;
  ablate_kernel<kStage, kBallot, kBackoff, kTogether, kItems, kTrace>
      <<<static_cast<unsigned>(nb), kThreads, (kWarps + 1) * E * sizeof(int),
         s>>>(static_cast<const int*>(eids), T, E, group_log2, id_bits,
              static_cast<int*>(slots), static_cast<int*>(counts),
              static_cast<unsigned*>(scratch),
              static_cast<unsigned long long*>(scratch) + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``variant``: 0 stream, 1 rank (match), 2 rank (ballot), 3 whole (match),
// 4 whole (ballot), 5 whole (ballot, back-off), 6 whole (ballot, 16 ids a
// thread), 7 whole (match, unpublished words re-read together), 8 the same
// with 16 ids a thread, 9 the same with 4 ids a thread, 10 variant 7
// traced (slots_ablate_set_trace first). ``scratch`` as the
// shipping kernel's, sized for the variant's tile (``slots_ablate_tile``).
extern "C" int slots_ablate_tile(int variant) {
  return kThreads * (variant == 6 || variant == 8 ? 16 : variant == 9 ? 4
                                                                      : 8);
}

extern "C" int slots_ablate_launch(int variant, const void* eids, long long T,
                                   int E, void* slots, void* counts,
                                   void* scratch, void* stream) {
  if (T <= 0 || T > 0x7fffffffLL || E < 1 || E > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SLOTS_ABLATE(...) \
  launch<__VA_ARGS__>(eids, T, E, slots, counts, scratch, s)
  switch (variant) {
    case 0: return SLOTS_ABLATE(0, false, false, false, 8);
    case 1: return SLOTS_ABLATE(1, false, false, false, 8);
    case 2: return SLOTS_ABLATE(1, true, false, false, 8);
    case 3: return SLOTS_ABLATE(2, false, false, false, 8);
    case 4: return SLOTS_ABLATE(2, true, false, false, 8);
    case 5: return SLOTS_ABLATE(2, true, true, false, 8);
    case 6: return SLOTS_ABLATE(2, true, false, false, 16);
    case 7: return SLOTS_ABLATE(2, false, false, true, 8);
    case 8: return SLOTS_ABLATE(2, false, false, true, 16);
    case 9: return SLOTS_ABLATE(2, false, false, true, 4);
    case 10: return SLOTS_ABLATE(2, false, false, true, 8, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLOTS_ABLATE
}

// Where variant 10 writes its trace: kTracePoints unsigned 64-bit words a
// CTA (``trace`` on the card). Returns the CUDA error (0 on success).
extern "C" int slots_ablate_set_trace(void* trace) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace)));
}
