// bucket_slots.cu — the displacement window's bucket slots on Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_dispatch/kernel.py::
// bucket_slots_pallas (body _slots_kernel). It computes the function of
// ref.py::bucket_slots_ref: for ids (T,) int32 and E experts, each record's
// slot within its bucket, slot[t] = #{t' < t : id[t'] == id[t]}, and each
// bucket's fill count; an id below 0 or at or above E gets slot -1 and is
// not counted. All int32: the result is exact and independent of the
// order in which CTAs run.
//
// Design: one launch a call, a single pass with a decoupled look-back.
// The TPU kernel carries per-expert running totals across a sequential
// grid of token blocks in VMEM. Here one CTA of 1,024 threads (one an SM)
// takes one tile of 1,024 K ids, K = 1, 2, 4 or 8 ids a thread: the
// wrapper picks the fewest that keep the tiles to one wave of the card's
// SMs (K = 1 at the routing shape, 96 tiles; K = 8 at the owner window,
// 128 tiles), and every id is read from device memory once:
//   1. rank in the tile: warp w holds ids [32 K w, 32 K (w + 1)) of the
//      tile, 32 at a time in token order; __match_any_sync finds the lanes
//      with the same id, the popcount of those below a lane is its rank
//      among them, and a per-warp running count per expert in shared
//      memory adds the warp's earlier ids (a serial chain of K steps);
//   2. the 32 warps' counts of an expert are scanned by one warp's
//      shuffles, which gives each warp's offset and the tile's count,
//      published at once: one 64-bit status word per (expert, tile),
//      stored expert by expert, with a flag (aggregate, or inclusive
//      prefix for tile 0) and the call's epoch in the high half, the count
//      in the low half;
//   3. look back: each expert gets P lanes (32 at E <= 32, 16 at E = 64,
//      4 at E = 256), which read 8 P earlier tiles' words at once (256 at
//      E = 8), a warp's loads on neighbouring words (a tile before tile 0
//      reads as a published 0), re-reading together those not yet
//      published; the lanes find the newest inclusive prefix among them
//      (a min over xor shuffles) and sum the words down to it (a sum over
//      xor shuffles), and rounds go on until one is found (tile 0 always
//      has one). The tile then publishes its own inclusive prefix and
//      writes its slots: prefix + warp offset + rank. The last tile writes
//      the counts.
// The status words live in a scratch buffer the wrapper keeps per
// (device, stream) and zeroes once when it allocates it. A word counts
// only when its epoch is this call's (one more than the epoch word at the
// buffer's start, which thread 0 of each CTA reads and the last tile
// advances once its look-back is done, when every tile has read it), so
// no call needs a fill and words of earlier calls are never mistaken for
// this call's. Tiles wait only on tiles of lower index, which CUDA
// dispatches first; a wait that outlasts seconds traps rather than hangs.
// Shared memory: 33 E + 32 ints.
//
// What bounds it. Ids read once, slots and counts written once: 8 T + 4 E
// bytes (0.79 MB at T = 98,304, E = 64; 8.4 MB at T = 2^20, E = 8), under
// 3 us at 3.35 TB/s. At these sizes one launch's latency and the chain of
// dependent steps inside a CTA (load, rank, publish, look back, write)
// set the time: fewer tiles shorten the look-back, fewer ids a warp the
// rank.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;               // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLook = 8;                     // words a lane reads a round
constexpr int kMaxExperts = 256;             // an id fits 8 bits of a place
constexpr unsigned kAggregate = 1u, kInclusive = 2u;
constexpr int kNone = 0x7fffffff;            // no inclusive prefix seen
constexpr int kSpinLimit = 1 << 22;          // ~seconds of polls of a word

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

#ifdef BUCKET_SLOTS_TRACE
// tools/slots_turns.py --trace builds a copy of this file with the macro
// set: thread 0 of each CTA writes %globaltimer at its start and after
// its rank, its publish, its look-back and its stores, its SM, and
// clock64() at the same points, 11 words a CTA, where
// bucket_slots_set_trace says
__device__ unsigned long long* g_trace;
__device__ __forceinline__ void stamp(int point) {
  if (threadIdx.x != 0) return;
  unsigned long long* t = g_trace + blockIdx.x * 11ull;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t[point]));
  t[6 + point] = clock64();
  if (point == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    t[5] = sm;
  }
}
#define SLOTS_STAMP(point) stamp(point)
#else
#define SLOTS_STAMP(point)
#endif

__device__ __forceinline__ void publish(unsigned long long* p, unsigned flag,
                                        unsigned epoch, unsigned count) {
  const unsigned long long v =
      (static_cast<unsigned long long>((epoch << 2) | flag) << 32) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// One CTA a tile of kThreads * kItems ids; dynamic shared memory
// kWarps * (E + 1) + E ints. ``group_log2``: log2 of the look-back lanes
// of an expert (P).
template <int kItems>
__global__ void __launch_bounds__(kThreads, 1)
    slots_kernel(const int* __restrict__ ids, long long T, int E,
                 int group_log2, int* __restrict__ slots,
                 int* __restrict__ counts, unsigned* epoch_word,
                 unsigned long long* status) {
  constexpr int kTile = kThreads * kItems;
  extern __shared__ int smem[];
  const int stride = E + 1;          // a row a warp, padded off the banks
  int* woff = smem;                  // [warp][expert]: counts, then offsets
  int* pre = smem + kWarps * stride; // [expert]: tile count, then prefix
  const int tile = blockIdx.x, nb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ unsigned epoch_s;
  SLOTS_STAMP(0);
  if (threadIdx.x == 0) {            // one read of the epoch word a CTA
    unsigned last;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(last)
                 : "l"(epoch_word) : "memory");
    epoch_s = last + 1u;             // this call's
  }

  const long long first = static_cast<long long>(tile) * kTile +
                          warp * (kItems * 32) + lane;
  int id[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long t = first + j * 32;
    id[j] = t < T ? __ldg(ids + t) : -1;
  }
  for (int i = threadIdx.x; i < kWarps * stride; i += kThreads) woff[i] = 0;
  __syncthreads();
  const unsigned epoch = epoch_s;

  // 1. rank within the warp's ids, in token order
  int* mine = woff + warp * stride;
  const unsigned lanes_below = (1u << lane) - 1u;
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = static_cast<unsigned>(id[j]) < static_cast<unsigned>(E);
    const unsigned same = __match_any_sync(0xffffffffu, valid ? id[j] : -1);
    const int below = __popc(same & lanes_below);
    rank[j] = valid ? mine[id[j]] + below : -1;
    __syncwarp();
    if (valid && below == 0) mine[id[j]] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  SLOTS_STAMP(1);

  // 2. warp w scans experts w, w + 32, ...: lane l holds warp l's count
  for (int e = warp; e < E; e += kWarps) {
    const int c = woff[lane * stride + e];
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    woff[lane * stride + e] = x - c;
    if (lane == 31) {
      pre[e] = x;
      publish(status + static_cast<long long>(e) * nb + tile,
              tile == 0 ? kInclusive : kAggregate, epoch, x);
    }
  }
  __syncthreads();
  SLOTS_STAMP(2);
  // each id's place in the tile and its expert, (place << 8) | expert
  int packed[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    packed[j] = rank[j] < 0 ? -1 : ((mine[id[j]] + rank[j]) << 8) | id[j];

  // 3. look back: lanes [P e, P e + P) sum expert e's earlier tiles; in
  // a round, lane p reads tiles hi - 1 - p - P c (c < kLook), so a warp's
  // loads are of neighbouring words, and r = p + P c orders the words
  // newest first
  const int P = 1 << group_log2;
  const int e = threadIdx.x >> group_log2;
  const int p = threadIdx.x & (P - 1);
  unsigned long long* column = status + static_cast<long long>(e) * nb;
  // the word of a tile before tile 0: published, an aggregate of 0
  const unsigned long long none =
      static_cast<unsigned long long>((epoch << 2) | kAggregate) << 32;
  unsigned prefix = 0;
  bool done = tile == 0 || e >= E;
  int hi = tile;                               // tiles below hi: not summed
  while (__any_sync(0xffffffffu, !done)) {
    unsigned long long word[kLook];
    int newest = kNone;        // this lane's newest inclusive prefix (its r)
    if (!done) {
      const int top = hi - 1 - p;              // this lane's newest tile
#pragma unroll
      for (int c = 0; c < kLook; ++c)
        word[c] = top - P * c >= 0 ? load_relaxed(column + (top - P * c))
                                   : none;
      // wait until every word of the round is published, re-reading all
      // those that are not at once (one round trip a poll, not one a word)
      unsigned pending = 0;
#pragma unroll
      for (int c = 0; c < kLook; ++c)
        if (static_cast<unsigned>(word[c] >> 34) != epoch) pending |= 1u << c;
      for (int spins = 0; pending; ++spins) {
        if (spins > kSpinLimit) __trap();
#pragma unroll
        for (int c = 0; c < kLook; ++c)
          if ((pending >> c) & 1u)
            word[c] = load_relaxed(column + (top - P * c));
#pragma unroll
        for (int c = 0; c < kLook; ++c)
          if (static_cast<unsigned>(word[c] >> 34) == epoch)
            pending &= ~(1u << c);
      }
#pragma unroll
      for (int c = kLook - 1; c >= 0; --c)
        if (((word[c] >> 32) & 3u) == kInclusive) newest = p + P * c;
    }
    // an xor by o < P stays within the aligned group of P lanes
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < P) newest = min(newest, __shfl_xor_sync(0xffffffffu, newest, o));
    unsigned sum = 0;
    if (!done) {
#pragma unroll
      for (int c = 0; c < kLook; ++c)
        if (p + P * c <= newest) sum += static_cast<unsigned>(word[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < P) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (!done) {
      prefix += sum;
      hi -= P * kLook;
      done = newest != kNone || hi <= 0;
    }
  }
  if (e < E && p == 0) {
    const unsigned count = static_cast<unsigned>(pre[e]);
    if (tile > 0)
      publish(column + tile, kInclusive, epoch, prefix + count);
    pre[e] = static_cast<int>(prefix);
    if (tile == nb - 1) counts[e] = static_cast<int>(prefix + count);
  }
  __syncthreads();
  SLOTS_STAMP(3);
  // every tile has read the epoch before the last one's look-back ends
  if (tile == nb - 1 && threadIdx.x == 0)
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(epoch_word),
                 "r"(epoch) : "memory");

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long t = first + j * 32;
    if (t < T)
      slots[t] = packed[j] < 0 ? -1 : pre[packed[j] & 255] + (packed[j] >> 8);
  }
#ifdef BUCKET_SLOTS_TRACE
  __syncthreads();
  SLOTS_STAMP(4);
#endif
}

template <int kItems>
int launch(const void* eids, long long T, int E, void* slots, void* counts,
           void* scratch, cudaStream_t stream) {
  constexpr int kTile = kThreads * kItems;
  const long long nb = (T + kTile - 1) / kTile;
  int group_log2 = 0;                          // P: 32 lanes or fewer
  while (group_log2 < 5 && (2 << group_log2) * E <= kThreads) ++group_log2;
  const size_t smem = static_cast<size_t>(kWarps * (E + 1) + E) * sizeof(int);
  slots_kernel<kItems><<<static_cast<unsigned>(nb), kThreads, smem, stream>>>(
      static_cast<const int*>(eids), T, E, group_log2,
      static_cast<int*>(slots), static_cast<int*>(counts),
      static_cast<unsigned*>(scratch),
      static_cast<unsigned long long*>(scratch) + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the kernel on ``stream`` (PyTorch's current stream), ``items``
// (1, 2, 4 or 8) ids a thread. ``scratch``: 8 + 8 * ceil(T / (1024 items))
// * E bytes, 8-byte aligned, zeroed when the caller allocated it and then
// passed to every call on this stream, as the last call left it (an epoch
// word, then the status words); at most 2^30 - 2 calls a buffer, after
// which the caller zeroes a new one. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape the kernel
// does not take, so the caller can raise.
extern "C" int bucket_slots_launch(const void* eids, long long T, int E,
                                   int items, void* slots, void* counts,
                                   void* scratch, void* stream) {
  if (T <= 0 || T > 0x7fffffffLL || E < 1 || E > kMaxExperts)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (items) {
    case 1: return launch<1>(eids, T, E, slots, counts, scratch, s);
    case 2: return launch<2>(eids, T, E, slots, counts, scratch, s);
    case 4: return launch<4>(eids, T, E, slots, counts, scratch, s);
    case 8: return launch<8>(eids, T, E, slots, counts, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef BUCKET_SLOTS_TRACE
// Where the traced kernel writes: 11 unsigned 64-bit words a CTA.
extern "C" int bucket_slots_set_trace(void* trace) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace)));
}
#endif
