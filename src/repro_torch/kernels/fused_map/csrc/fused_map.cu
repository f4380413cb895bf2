// fused_map.cu — one MR-1S engine step for all P ranks, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_map/kernel.py::
// fused_map_pallas (body _fused_kernel, helper _dup_sum). Per rank r it
// computes exactly what ref.py::fused_step_ref computes:
//   1. the dup-sum of the task's S records with key-ascending ranks (the
//      layout of kv.local_reduce), int32 sums wrapping mod 2^32;
//   2. the whole footnote-5 repeat recurrence, rep[r] - 1 more dup-sums,
//      each over the task's S records plus the previous result's negative
//      slots (not idempotent on wrap-negative sums, so never shortened);
//   3. the owner lookup in the carried owner_map/owner_split rows, split
//      keys picking a replica by mix32(task_id);
//   4. bucket placement into the (P, cap) push buckets with
//      kv.bucketize's capacity rule, and the per-owner fill counts;
//   5. the fold of the pending chunk and of the bucket overflow into the
//      window table[r] — IN PLACE.
//
// What bounds it. The bytes are tiny (about 120 KB a step at P = 8,
// S = 256, cap = 64, V = 262,144: 0.04 us at 3.35 TB/s), and so are the
// operations. What the card cannot hide is the hot rank's chain of
// dependent passes: each of its rep[r] dup-sums needs the one before
// (its negative slots), so the kernel takes as long as one block runs
// rep[r] passes in sequence, whatever the other ranks do. The TPU kernel
// did each pass as an O(L^2) compare matrix (L = 2S), which its matrix
// unit eats; on this card that loop was the whole time.
//
// Design. One block serves one rank: a cluster would only pay if a
// single pass were bound by the block's width, and a pass is bound by its
// chain of shuffles and barriers. Each pass is a sort-based reduce of its
// own L = 2S records, nothing of the previous pass carried but the
// (uk, uv) dependency:
//   * a bitonic sort of NP = pow2(2S) >= 64 (key, value) pairs in signed
//     key order (KEY_SENTINEL = INT_MAX sorts last), NP / 2 threads each
//     holding the pairs 2t and 2t + 1 in registers, the stages unrolled
//     for each NP. Stride 1 stays inside a thread, strides 2-32 go through
//     warp shuffles with no barrier, and only strides of 64 or more meet
//     in shared memory: a double-buffered exchange, one barrier a stage;
//   * head flags and one block-wide segmented scan give each run of equal
//     keys its unsigned sum (wrapping mod 2^32) and its rank: the heads
//     before it, which is its slot. Slots at or past S are dropped, as
//     the ghost slot of _dup_sum drops them.
// Bucketize is a scan too: thread t holds slot t (NP / 2 >= S), and
// __match_any_sync groups a warp's slots by owner, a popc gives each
// slot's place among its warp's, and per-warp owner counts in shared
// memory give the places of earlier warps, so no atomic decides a slot.
// The overflow and pending folds stay int32 atomicAdds into table[r]:
// their sums are order-free. The window's untouched slots are never read
// (the TPU kernel streams all of it through VMEM: it cannot scatter).
//
// Task sizes past 1,024 (NP 4,096-32,768) take a kernel of their own,
// fused_map_wide_kernel (one kernel for every E took 4.5 % more device
// time at S 256, its registers up from 48 to 64 there):
//   * its 1,024 threads each hold E = NP / 1,024 neighbouring pairs, E t
//     to E t + E - 1, in registers. Strides below E stay inside a thread,
//     strides up to 16 E go through warp shuffles, longer ones through
//     the exchange; the stages loop (each stride inside a thread unrolled
//     once) instead of unrolling;
//   * a scan of each thread's E pairs, then the block scan of the
//     threads' totals;
//   * bucketize in rounds of 1,024 slots (slot j 1,024 + t in round j),
//     per-owner totals carried in shared memory from round to round;
//   * up to NP 8,192 (S <= 4,096) the exchange and the task's and reduced
//     records live in shared memory (196 KB of the 227 KB at NP 8,192).
//     Past it they do not fit and live in a global scratch of 4 NP + 4 S
//     ints a rank (768 KB at S 16,384), which the caller gives and which
//     stays in the 50 MB L2; __syncthreads orders a block's global writes
//     as it does its shared ones. At NP 32,768 the 32 pairs a thread do
//     not fit its 64 registers, and ptxas spills some to local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The segmented-scan element: heads so far, and the sum of the current
// run so far. ``combine(a, b)`` is ``a`` followed by ``b``; {0, 0} is its
// identity.
struct Seg {
  unsigned heads;
  unsigned sum;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.heads + b.heads, b.heads ? b.sum : a.sum + b.sum};
}

__device__ __forceinline__ Seg warp_scan(Seg x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg y{__shfl_up_sync(kFull, x.heads, d),
                __shfl_up_sync(kFull, x.sum, d)};
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// One compare-exchange: element ``i`` holding ``key`` and seeing its
// partner's (pk, pv) at stride ``j`` of a bitonic merge of size ``k``.
// The lower index of an ascending pair keeps the smaller key; on equal
// keys both sides keep their own pair.
__device__ __forceinline__ void exchange(int i, int k, int j, int pk, int pv,
                                         int& key, int& val) {
  const bool keep_min = ((i & k) == 0) == ((i & j) == 0);
  if (keep_min ? pk < key : pk > key) {
    key = pk;
    val = pv;
  }
}

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

// Sort the block's NP pairs, thread t holding pairs 2t and 2t + 1, into
// signed key order. ``x`` holds two NP-wide exchange buffers of
// (key, value); ``buf`` is the one the next shared stage uses.
template <int NP>
__device__ __forceinline__ void bitonic_sort(int (&key)[2], int (&val)[2],
                                             int2* x, int& buf) {
  constexpr int kLog = log2_of(NP);
  const int t = threadIdx.x;
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j == 1) {                       // partner in this thread
        if (((2 * t) & k) == 0 ? key[1] < key[0] : key[1] > key[0]) {
          const int tk = key[0], tv = val[0];
          key[0] = key[1];
          val[0] = val[1];
          key[1] = tk;
          val[1] = tv;
        }
      } else if (j < 64) {                // partner in this warp
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pk = __shfl_xor_sync(kFull, key[e], j >> 1);
          const int pv = __shfl_xor_sync(kFull, val[e], j >> 1);
          exchange(2 * t + e, k, j, pk, pv, key[e], val[e]);
        }
      } else {                            // partner in another warp
        int4* ex = reinterpret_cast<int4*>(x + buf * NP);
        ex[t] = make_int4(key[0], val[0], key[1], val[1]);
        __syncthreads();
        const int4 p = ex[t ^ (j >> 1)];
        exchange(2 * t, k, j, p.x, p.y, key[0], val[0]);
        exchange(2 * t + 1, k, j, p.z, p.w, key[1], val[1]);
        buf ^= 1;
      }
    }
  }
}

// One dup-sum pass: sorts and reduces the task's S records plus the
// dependency on the previous pass (uk[i], uv[i] where uv[i] < 0) into
// uk/uv[0:S), key ascending and sentinel padded — value-identical to
// kv.local_reduce(concat(task, dep), S). Ends with a barrier.
template <int NP>
__device__ void dup_sum_pass(const int* tk, const int* tv, int* uk, int* uv,
                             int S, int2* x, Seg* wscan, int& buf) {
  constexpr int B = NP / 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int key[2], val[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = 2 * t + e;
    if (i < S) {
      key[e] = tk[i];
      val[e] = tv[i];
    } else if (i < 2 * S && uv[i - S] < 0) {
      key[e] = uk[i - S];
      val[e] = uv[i - S];
    } else {
      key[e] = kSentinel;
      val[e] = 0;
    }
  }
  __syncthreads();                        // every dependency is read
  if (t < S) {                            // B >= S
    uk[t] = kSentinel;
    uv[t] = 0;
  }
  bitonic_sort<NP>(key, val, x, buf);

  // the sorted pairs, for each run's neighbours
  int2* sx = x + buf * NP;
  reinterpret_cast<int4*>(sx)[t] = make_int4(key[0], val[0], key[1], val[1]);
  __syncthreads();

  // the segmented scan: a head starts each run of equal keys
  const int prev = t > 0 ? sx[2 * t - 1].x : 0;
  const int next = t < B - 1 ? sx[2 * t + 2].x : 0;
  const Seg el0{(t == 0 || prev != key[0]) ? 1u : 0u,
                static_cast<unsigned>(val[0])};
  const Seg el1{key[1] != key[0] ? 1u : 0u, static_cast<unsigned>(val[1])};
  const Seg inc = warp_scan(combine(el0, el1), lane);
  if (lane == 31) wscan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    constexpr int nw = B / 32;
    Seg w = lane < nw ? wscan[lane] : Seg{0u, 0u};
    w = warp_scan(w, lane);
    if (lane < nw) wscan[lane] = w;
  }
  __syncthreads();
  Seg run{__shfl_up_sync(kFull, inc.heads, 1),
          __shfl_up_sync(kFull, inc.sum, 1)};
  if (lane == 0) run = Seg{0u, 0u};
  if (warp > 0) run = combine(wscan[warp - 1], run);
  run = combine(run, el0);
  // a run's last pair holds its sum; its heads less one are its slot,
  // and a slot past S is the ghost slot: dropped
  int slot = static_cast<int>(run.heads) - 1;
  if (key[1] != key[0] && key[0] != kSentinel && slot < S) {
    uk[slot] = key[0];
    uv[slot] = static_cast<int>(run.sum);
  }
  run = combine(run, el1);
  slot = static_cast<int>(run.heads) - 1;
  if ((t == B - 1 || next != key[1]) && key[1] != kSentinel && slot < S) {
    uk[slot] = key[1];
    uv[slot] = static_cast<int>(run.sum);
  }
  __syncthreads();
}

template <int NP>
__global__ void __launch_bounds__(NP / 2) fused_map_kernel(
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ rep, const int* __restrict__ task_id,
    const int* __restrict__ owner_map, const int* __restrict__ owner_split,
    const int* __restrict__ pending_k, const int* __restrict__ pending_v,
    int* __restrict__ table, int* __restrict__ bk, int* __restrict__ bv,
    int* __restrict__ counts, int P, int S, int V, int cap) {
  extern __shared__ int4 smem4[];
  constexpr int B = NP / 2, nw = B / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int2* x = reinterpret_cast<int2*>(smem4);   // 2 NP: sort exchange
  int* tk = reinterpret_cast<int*>(x + 2 * NP);  // S: the task's records
  int* tv = tk + S;               // S
  int* uk = tv + S;               // S: reduced records, key ascending
  int* uv = uk + S;               // S
  Seg* wscan = reinterpret_cast<Seg*>(uv + S);          // 32: warp scan
  int* wcnt = reinterpret_cast<int*>(wscan + kMaxWarps);  // nw * P
  int* tot = wcnt + nw * P;       // P: records per owner

  const int r = blockIdx.x;
  const long long rec = static_cast<long long>(r) * S;
  const long long win = static_cast<long long>(r) * V;
  const long long buck = static_cast<long long>(r) * P * cap;

  for (int i = t; i < S; i += B) {
    const int k = keys[rec + i];
    tk[i] = k;
    tv[i] = k == kSentinel ? 0 : vals[rec + i];   // invalid adds nothing
    uk[i] = kSentinel;                            // no dependency yet
    uv[i] = 0;
  }
  for (int i = t; i < nw * P; i += B) wcnt[i] = 0;
  __syncthreads();

  // local reduce and the footnote-5 repeat recurrence: rep[r] passes,
  // each sorting and reducing its own 2S records
  const int n_rep = max(rep[r], 1);
  int buf = 0;
  for (int it = 0; it < n_rep; ++it) {
    dup_sum_pass<NP>(tk, tv, uk, uv, S, x, wscan, buf);
  }

  // owner lookup: partition.lookup_owner on this rank's carried maps;
  // thread t holds slot t (blockDim >= S), threads past S owner -1
  int o = -1, u = kSentinel, w = 0;
  if (t < S) {
    u = uk[t];
    w = uv[t];
    o = P;
    if (u != kSentinel && u >= 0 && u < V) {
      const uint32_t mixed = mix32(static_cast<uint32_t>(task_id[r]));
      const int base = owner_map[win + u];
      const int ks = max(owner_split[win + u], 1);
      const unsigned int pick =
          ks > 1 ? mixed % static_cast<uint32_t>(ks) : 0u;
      o = static_cast<int>(static_cast<unsigned int>(base) + pick) % P;
      if (o < 0) o += P;
    }
  }

  // bucketize by scan: a slot's place in its owner's bucket is the count
  // of earlier same-owner slots (the stable owner sort of kv.bucketize)
  const unsigned same = __match_any_sync(kFull, o);
  const int before_in_warp = __popc(same & ((1u << lane) - 1u));
  if (o >= 0 && o < P && lane == __ffs(same) - 1) {
    wcnt[warp * P + o] = __popc(same);
  }
  __syncthreads();
  for (int p = t; p < P; p += B) {
    int n = 0;
    for (int q = 0; q < nw; ++q) n += wcnt[q * P + p];
    tot[p] = n;
  }
  if (o >= 0 && o < P) {    // sentinel / out of window: neither pushed nor kept
    int pos = before_in_warp;
    for (int q = 0; q < warp; ++q) pos += wcnt[q * P + o];
    if (pos < cap) {
      const long long at = buck + static_cast<long long>(o) * cap + pos;
      bk[at] = u;
      bv[at] = w;
    } else {
      atomicAdd(&table[win + u], w);      // ownership transfer
    }
  }
  __syncthreads();
  for (int i = t; i < P * cap; i += B) {  // the buckets' empty tails
    if (i % cap >= min(tot[i / cap], cap)) {
      bk[buck + i] = kSentinel;
      bv[buck + i] = 0;
    }
  }
  // fold the in-flight chunk; keys follow the reference scatter (sentinel
  // and out-of-range dropped, [-V, 0) wraps)
  for (int i = t; i < P * cap; i += B) {
    int k = pending_k[buck + i];
    if (k == kSentinel) continue;
    if (k < 0) k += V;
    if (k >= 0 && k < V) atomicAdd(&table[win + k], pending_v[buck + i]);
  }
  for (int p = t; p < P; p += B) {
    counts[static_cast<long long>(r) * P + p] = min(tot[p], cap);
  }
}

// ---------------------------------------------------------------------------
// Task sizes past 1,024: NP 4,096-32,768 pairs on 1,024 threads
// ---------------------------------------------------------------------------

constexpr int kSmemPairs = 8192;    // NP past this sorts in global scratch

// The block of a pass over NP > 2,048 pairs: pairs a thread, and where
// the exchange and the records live.
template <int NP>
struct Wide {
  static constexpr int B = kMaxThreads;
  static constexpr int E = NP / B;
  static constexpr bool kGlobal = NP > kSmemPairs;
};

// Stride J < E of a merge of size k, between pairs of thread t.
template <int E, int J>
__device__ __forceinline__ void in_thread(int t, int k, int (&key)[E],
                                          int (&val)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((e & J) == 0) {
      const int hi = e | J;
      const bool up = ((E * t + e) & k) == 0;
      if (up ? key[hi] < key[e] : key[hi] > key[e]) {
        const int tk = key[e], tv = val[e];
        key[e] = key[hi];
        val[e] = val[hi];
        key[hi] = tk;
        val[hi] = tv;
      }
    }
  }
}

// in_thread at a stride known only at run time: one unrolled body for
// each stride below E.
template <int E, int J = 1>
__device__ __forceinline__ void in_thread_at(int j, int t, int k,
                                             int (&key)[E], int (&val)[E]) {
  if constexpr (J < E) {
    if (j == J) {
      in_thread<E, J>(t, k, key, val);
    } else {
      in_thread_at<E, 2 * J>(j, t, k, key, val);
    }
  }
}

// One stage (merge size k, stride j) of the sort of NP pairs. ``x``
// holds two NP-wide exchange buffers of (key, value), pairs 2q and
// 2q + 1 of thread t at int4 q B + t; ``buf`` is the one the next
// exchange uses.
template <int NP>
__device__ __forceinline__ void wide_sort_stage(int k, int j,
                                                int (&key)[Wide<NP>::E],
                                                int (&val)[Wide<NP>::E],
                                                int2* x, int& buf) {
  constexpr int B = Wide<NP>::B, E = Wide<NP>::E;
  const int t = threadIdx.x;
  if (j < E) {                            // partner in this thread
    in_thread_at<E>(j, t, k, key, val);
  } else if (j < 32 * E) {                // partner in this warp
    const int m = j / E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int pk = __shfl_xor_sync(kFull, key[e], m);
      const int pv = __shfl_xor_sync(kFull, val[e], m);
      exchange(E * t + e, k, j, pk, pv, key[e], val[e]);
    }
  } else {                                // partner in another warp
    int4* ex = reinterpret_cast<int4*>(x + buf * NP);
#pragma unroll
    for (int q = 0; q < E / 2; ++q) {
      ex[q * B + t] = make_int4(key[2 * q], val[2 * q], key[2 * q + 1],
                                val[2 * q + 1]);
    }
    __syncthreads();
    const int p = t ^ (j / E);
#pragma unroll
    for (int q = 0; q < E / 2; ++q) {
      const int4 o = ex[q * B + p];
      exchange(E * t + 2 * q, k, j, o.x, o.y, key[2 * q], val[2 * q]);
      exchange(E * t + 2 * q + 1, k, j, o.z, o.w, key[2 * q + 1],
               val[2 * q + 1]);
    }
    buf ^= 1;
  }
}

// One dup-sum pass over NP > 2,048 pairs: wide_sort_stage's sort, then
// the segmented scan of each thread's E pairs and of the threads'
// totals; the same contract as dup_sum_pass. Ends with a barrier.
template <int NP>
__device__ void wide_dup_sum_pass(const int* tk, const int* tv, int* uk,
                                  int* uv, int S, int2* x, Seg* wscan,
                                  int& buf) {
  constexpr int B = Wide<NP>::B, E = Wide<NP>::E;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int key[E], val[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = E * t + e;
    if (i < S) {
      key[e] = tk[i];
      val[e] = tv[i];
    } else if (i < 2 * S && uv[i - S] < 0) {
      key[e] = uk[i - S];
      val[e] = uv[i - S];
    } else {
      key[e] = kSentinel;
      val[e] = 0;
    }
  }
  __syncthreads();                        // every dependency is read
  for (int i = t; i < S; i += B) {
    uk[i] = kSentinel;
    uv[i] = 0;
  }
#pragma unroll 1
  for (int k = 2; k <= NP; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j > 0; j >>= 1) {
      wide_sort_stage<NP>(k, j, key, val, x, buf);
    }
  }

  // the sorted pairs, for each run's neighbours
  int4* sx = reinterpret_cast<int4*>(x + buf * NP);
#pragma unroll
  for (int q = 0; q < E / 2; ++q) {
    sx[q * B + t] = make_int4(key[2 * q], val[2 * q], key[2 * q + 1],
                              val[2 * q + 1]);
  }
  __syncthreads();

  // the segmented scan: a head starts each run of equal keys
  const int prev = t > 0 ? sx[(E / 2 - 1) * B + t - 1].z : 0;
  const int next = t < B - 1 ? sx[t + 1].x : 0;
  Seg own{(t == 0 || prev != key[0]) ? 1u : 0u,
          static_cast<unsigned>(val[0])};
#pragma unroll
  for (int e = 1; e < E; ++e) {
    own = combine(own, Seg{key[e] != key[e - 1] ? 1u : 0u,
                           static_cast<unsigned>(val[e])});
  }
  const Seg inc = warp_scan(own, lane);
  if (lane == 31) wscan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg w = warp_scan(wscan[lane], lane);   // B / 32 = 32 warps
    wscan[lane] = w;
  }
  __syncthreads();
  Seg run{__shfl_up_sync(kFull, inc.heads, 1),
          __shfl_up_sync(kFull, inc.sum, 1)};
  if (lane == 0) run = Seg{0u, 0u};
  if (warp > 0) run = combine(wscan[warp - 1], run);
  // a run's last pair holds its sum; its heads less one are its slot,
  // and a slot past S is the ghost slot: dropped
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool head = e == 0 ? (t == 0 || prev != key[0])
                             : key[e] != key[e > 0 ? e - 1 : 0];
    run = combine(run, Seg{head ? 1u : 0u, static_cast<unsigned>(val[e])});
    const bool last = e + 1 < E ? key[e + 1 < E ? e + 1 : e] != key[e]
                                : (t == B - 1 || next != key[e]);
    const int slot = static_cast<int>(run.heads) - 1;
    if (last && key[e] != kSentinel && slot < S) {
      uk[slot] = key[e];
      uv[slot] = static_cast<int>(run.sum);
    }
  }
  __syncthreads();
}

template <int NP>
__global__ void __launch_bounds__(kMaxThreads) fused_map_wide_kernel(
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ rep, const int* __restrict__ task_id,
    const int* __restrict__ owner_map, const int* __restrict__ owner_split,
    const int* __restrict__ pending_k, const int* __restrict__ pending_v,
    int* __restrict__ table, int* __restrict__ bk, int* __restrict__ bv,
    int* __restrict__ counts, int* __restrict__ scratch, int P, int S, int V,
    int cap) {
  extern __shared__ int4 smem4[];
  constexpr int B = Wide<NP>::B, nw = B / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r = blockIdx.x;
  // the sort exchange (2 NP pairs) and the records (4 S): in shared
  // memory up to NP 8,192, else in this rank's share of the scratch
  int* const shared = reinterpret_cast<int*>(smem4);
  int* const big = Wide<NP>::kGlobal
      ? scratch + static_cast<long long>(r) * (4 * NP + 4 * S)
      : shared;
  int2* x = reinterpret_cast<int2*>(big);          // 2 NP: sort exchange
  int* tk = big + 4 * NP;         // S: the task's records
  int* tv = tk + S;               // S
  int* uk = tv + S;               // S: reduced records, key ascending
  int* uv = uk + S;               // S
  Seg* wscan = reinterpret_cast<Seg*>(Wide<NP>::kGlobal ? shared : uv + S);
  int* wcnt = reinterpret_cast<int*>(wscan + kMaxWarps);  // nw * P
  int* tot = wcnt + nw * P;       // P: records per owner, to this round
  int* done = tot + P;            // P: records per owner, earlier rounds

  const long long rec = static_cast<long long>(r) * S;
  const long long win = static_cast<long long>(r) * V;
  const long long buck = static_cast<long long>(r) * P * cap;

  for (int i = t; i < S; i += B) {
    const int k = keys[rec + i];
    tk[i] = k;
    tv[i] = k == kSentinel ? 0 : vals[rec + i];   // invalid adds nothing
    uk[i] = kSentinel;                            // no dependency yet
    uv[i] = 0;
  }
  for (int i = t; i < nw * P; i += B) wcnt[i] = 0;
  for (int p = t; p < P; p += B) done[p] = 0;
  __syncthreads();

  // local reduce and the footnote-5 repeat recurrence: rep[r] passes
  const int n_rep = max(rep[r], 1);
  int buf = 0;
  for (int it = 0; it < n_rep; ++it) {
    wide_dup_sum_pass<NP>(tk, tv, uk, uv, S, x, wscan, buf);
  }

  // owner lookup and bucketize by scan, as fused_map_kernel's, in rounds
  // of B slots, slot s = base + t; slots past S owner -1
  const uint32_t mixed = mix32(static_cast<uint32_t>(task_id[r]));
  for (int base = 0; base < S; base += B) {
    const int s = base + t;
    int o = -1, u = kSentinel, w = 0;
    if (s < S) {
      u = uk[s];
      w = uv[s];
      o = P;
      if (u != kSentinel && u >= 0 && u < V) {
        const int own = owner_map[win + u];
        const int ks = max(owner_split[win + u], 1);
        const unsigned int pick =
            ks > 1 ? mixed % static_cast<uint32_t>(ks) : 0u;
        o = static_cast<int>(static_cast<unsigned int>(own) + pick) % P;
        if (o < 0) o += P;
      }
    }
    const unsigned same = __match_any_sync(kFull, o);
    const int before_in_warp = __popc(same & ((1u << lane) - 1u));
    if (o >= 0 && o < P && lane == __ffs(same) - 1) {
      wcnt[warp * P + o] = __popc(same);
    }
    __syncthreads();
    for (int p = t; p < P; p += B) {
      int n = done[p];
      for (int q = 0; q < nw; ++q) n += wcnt[q * P + p];
      tot[p] = n;
    }
    if (o >= 0 && o < P) {  // sentinel / out of window: neither pushed nor kept
      int pos = done[o] + before_in_warp;
      for (int q = 0; q < warp; ++q) pos += wcnt[q * P + o];
      if (pos < cap) {
        const long long at = buck + static_cast<long long>(o) * cap + pos;
        bk[at] = u;
        bv[at] = w;
      } else {
        atomicAdd(&table[win + u], w);    // ownership transfer
      }
    }
    __syncthreads();
    if (base + B < S) {     // another round: carry the totals, clear counts
      for (int p = t; p < P; p += B) done[p] = tot[p];
      for (int i = t; i < nw * P; i += B) wcnt[i] = 0;
      __syncthreads();
    }
  }
  for (int i = t; i < P * cap; i += B) {  // the buckets' empty tails
    if (i % cap >= min(tot[i / cap], cap)) {
      bk[buck + i] = kSentinel;
      bv[buck + i] = 0;
    }
  }
  // fold the in-flight chunk, as fused_map_kernel does
  for (int i = t; i < P * cap; i += B) {
    int k = pending_k[buck + i];
    if (k == kSentinel) continue;
    if (k < 0) k += V;
    if (k >= 0 && k < V) atomicAdd(&table[win + k], pending_v[buck + i]);
  }
  for (int p = t; p < P; p += B) {
    counts[static_cast<long long>(r) * P + p] = min(tot[p], cap);
  }
}

constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxTaskSize = 16384;       // NP 32,768: 32 pairs a thread

// The pairs a pass sorts: 2S records padded to a power of two, two a
// thread, a warp at least.
int pairs_of(int S) {
  int np = 64;
  while (np < 2 * S) np <<= 1;
  return np;
}

size_t smem_of(int P, int S) {
  const int np = pairs_of(S);
  if (np <= 2 * kMaxThreads) {              // fused_map_kernel
    return static_cast<size_t>(4 * np + 4 * S + (np / 64) * P + P) *
               sizeof(int) + kMaxWarps * sizeof(Seg);
  }
  const int records = np > kSmemPairs ? 0 : 4 * np + 4 * S;
  return static_cast<size_t>(records + kMaxWarps * P + 2 * P) *
             sizeof(int) + kMaxWarps * sizeof(Seg);
}

template <int NP>
cudaError_t launch(const int* keys, const int* vals, const int* rep,
                   const int* task_id, const int* owner_map,
                   const int* owner_split, const int* pending_k,
                   const int* pending_v, int* table, int* bk, int* bv,
                   int* counts, int* scratch, int P, int S, int V, int cap,
                   size_t smem, cudaStream_t s) {
  if constexpr (NP <= 2 * kMaxThreads) {
    fused_map_kernel<NP><<<P, NP / 2, smem, s>>>(
        keys, vals, rep, task_id, owner_map, owner_split, pending_k,
        pending_v, table, bk, bv, counts, P, S, V, cap);
  } else {
    if (Wide<NP>::kGlobal && scratch == nullptr) {
      return cudaErrorInvalidValue;
    }
    fused_map_wide_kernel<NP><<<P, kMaxThreads, smem, s>>>(
        keys, vals, rep, task_id, owner_map, owner_split, pending_k,
        pending_v, table, bk, bv, counts, scratch, P, S, V, cap);
  }
  return cudaGetLastError();
}

template <int NP>
cudaError_t allow_smem() {
  if constexpr (NP <= 2 * kMaxThreads) {
    return cudaFuncSetAttribute(fused_map_kernel<NP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmem);
  } else {
    return cudaFuncSetAttribute(fused_map_wide_kernel<NP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmem);
  }
}

}  // namespace

// Once, before the first launch (and outside any graph capture): let the
// kernels take dynamic shared memory past 48 KB. Returns a cudaError_t.
extern "C" int fused_map_prepare() {
  const cudaError_t errs[] = {
      allow_smem<64>(),   allow_smem<128>(),  allow_smem<256>(),
      allow_smem<512>(),  allow_smem<1024>(), allow_smem<2048>(),
      allow_smem<4096>(), allow_smem<8192>(), allow_smem<16384>(),
      allow_smem<32768>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The int32 scratch that launches at (P, S) need: 0 up to S 4,096, else
// 6 NP ints a rank, enough for every S of the same NP (4 NP + 4 S), so
// that they can share one buffer.
extern "C" long long fused_map_scratch_ints(int P, int S) {
  const int np = pairs_of(S);
  return np > kSmemPairs ? 6LL * np * P : 0;
}

// Launch on ``stream`` (PyTorch's current stream); returns
// cudaGetLastError() so the caller can raise on a refused launch. Takes
// 1 <= S <= 16,384: NP = pow2(2S) pairs, NP / 2 threads up to S 1,024
// and 1,024 past it. ``scratch`` holds fused_map_scratch_ints(P, S)
// ints (null where that is 0).
extern "C" int fused_map_launch(
    const int* keys, const int* vals, const int* rep, const int* task_id,
    const int* owner_map, const int* owner_split, const int* pending_k,
    const int* pending_v, int* table, int* bk, int* bv, int* counts,
    int* scratch, int P, int S, int V, int cap, void* stream) {
  if (S < 1 || S > kMaxTaskSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_of(P, S);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (pairs_of(S)) {
#define FUSED_MAP_CASE(np)                                                  \
  case np:                                                                  \
    e = launch<np>(keys, vals, rep, task_id, owner_map, owner_split,        \
                   pending_k, pending_v, table, bk, bv, counts, scratch, P, \
                   S, V, cap, smem, s);                                     \
    break;
    FUSED_MAP_CASE(64)
    FUSED_MAP_CASE(128)
    FUSED_MAP_CASE(256)
    FUSED_MAP_CASE(512)
    FUSED_MAP_CASE(1024)
    FUSED_MAP_CASE(2048)
    FUSED_MAP_CASE(4096)
    FUSED_MAP_CASE(8192)
    FUSED_MAP_CASE(16384)
    FUSED_MAP_CASE(32768)
#undef FUSED_MAP_CASE
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
