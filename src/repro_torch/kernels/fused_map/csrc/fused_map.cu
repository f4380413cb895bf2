// fused_map.cu — one MR-1S engine step for all P ranks, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_map/kernel.py::
// fused_map_pallas (body _fused_kernel, helper _dup_sum). Per rank r it
// computes exactly what ref.py::fused_step_ref computes:
//   1. the dup-sum of the task's S records with key-ascending ranks (the
//      layout of kv.local_reduce), int32 sums wrapping mod 2^32;
//   2. the whole footnote-5 repeat recurrence, rep[r] - 1 more dup-sums,
//      each seeded with the previous result's negative slots (not
//      idempotent on wrap-negative sums, so never shortened);
//   3. the owner lookup in the carried owner_map/owner_split rows, split
//      keys picking a replica by mix32(task_id);
//   4. bucket placement into the (P, cap) push buckets with
//      kv.bucketize's capacity rule, and the per-owner fill counts;
//   5. the fold of the pending chunk and of the bucket overflow into the
//      window table[r] — IN PLACE.
//
// Design. The TPU kernel streams the whole (V,) window through VMEM over
// a sequential vocab grid, because a TPU cannot scatter. Hopper can: the
// fold is an int32 atomicAdd of the P*cap pending records and the
// overflow into table[r], touching P*cap + S slots instead of V. That is
// exact because int32 sums are order-free mod 2^32. One block runs one
// rank; the record pass lives in shared memory (8S ints + 2S bytes, 34 KB
// at S = 1024) as the reference's S x S first-occurrence compare.
//
// What bounds it. The bytes are tiny (about 150 KB a step at P = 8,
// S = 256, cap = 64, V = 262,144), so no byte or operation roof is near:
// the kernel is bound by latency — P blocks on 132 SMs, and an O(L^2)
// compare pass per dup-sum (L = 2S in a repeat) done by one block. The
// design keeps every record intermediate in shared memory and never
// touches the untouched part of the window; spreading a rank over more
// blocks (or a block sort) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Dup-sum of the L records k[0:L), v[0:L) in shared memory into out_cap
// slots uk/uv, key ascending and sentinel padded: value-identical to
// kv.local_reduce for n_unique <= out_cap. Ends with a barrier.
__device__ void dup_sum(const int* k, const int* v, int L, int* sums,
                        unsigned char* first, int* uk, int* uv,
                        int out_cap) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int ki = k[i];
    unsigned int s = 0u;
    bool f = ki != kSentinel;
    if (f) {
      for (int j = 0; j < L; ++j) {
        if (k[j] == ki) {
          s += static_cast<unsigned int>(v[j]);
          f = f && j >= i;
        }
      }
    }
    sums[i] = static_cast<int>(s);
    first[i] = f ? 1 : 0;
  }
  for (int i = threadIdx.x; i < out_cap; i += blockDim.x) {
    uk[i] = kSentinel;
    uv[i] = 0;
  }
  __syncthreads();
  // rank = number of distinct keys strictly smaller -> sorted layout
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    if (first[i]) {
      const int ki = k[i];
      int rank = 0;
      for (int j = 0; j < L; ++j) rank += (first[j] && k[j] < ki) ? 1 : 0;
      if (rank < out_cap) {
        uk[rank] = ki;
        uv[rank] = sums[i];
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_map_kernel(
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ rep, const int* __restrict__ task_id,
    const int* __restrict__ owner_map, const int* __restrict__ owner_split,
    const int* __restrict__ pending_k, const int* __restrict__ pending_v,
    int* __restrict__ table, int* __restrict__ bk, int* __restrict__ bv,
    int* __restrict__ counts, int P, int S, int V, int cap) {
  extern __shared__ int smem[];
  int* kbuf = smem;          // 2S: the task's records, then the dependency
  int* vbuf = kbuf + 2 * S;  // 2S
  int* sums = vbuf + 2 * S;  // 2S: dup sums, later each slot's owner
  int* uk = sums + 2 * S;    // S: reduced records, key ascending
  int* uv = uk + S;          // S
  int* tot = uv + S;         // P: records per owner
  unsigned char* first = reinterpret_cast<unsigned char*>(tot + P);  // 2S

  const int r = blockIdx.x;
  const long long rec = static_cast<long long>(r) * S;
  const long long win = static_cast<long long>(r) * V;
  const long long buck = static_cast<long long>(r) * P * cap;

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    kbuf[i] = keys[rec + i];
    vbuf[i] = vals[rec + i];
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) tot[p] = 0;
  __syncthreads();

  // local reduce and the footnote-5 repeat recurrence, rep[r] passes
  dup_sum(kbuf, vbuf, S, sums, first, uk, uv, S);
  const int n_rep = max(rep[r], 1);
  for (int it = 1; it < n_rep; ++it) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const bool neg = uv[i] < 0;
      kbuf[S + i] = neg ? uk[i] : kSentinel;
      vbuf[S + i] = neg ? uv[i] : 0;
    }
    __syncthreads();
    dup_sum(kbuf, vbuf, 2 * S, sums, first, uk, uv, S);
  }

  // owner lookup: partition.lookup_owner on this rank's carried maps
  int* owner = sums;
  const uint32_t mixed = mix32(static_cast<uint32_t>(task_id[r]));
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int u = uk[i];
    int o = P;
    if (u != kSentinel && u >= 0 && u < V) {
      const int base = owner_map[win + u];
      const int ks = max(owner_split[win + u], 1);
      const unsigned int pick =
          ks > 1 ? mixed % static_cast<uint32_t>(ks) : 0u;
      o = static_cast<int>(static_cast<unsigned int>(base) + pick) % P;
      if (o < 0) o += P;
    }
    owner[i] = o;
  }
  for (int i = threadIdx.x; i < P * cap; i += blockDim.x) {
    bk[buck + i] = kSentinel;
    bv[buck + i] = 0;
  }
  __syncthreads();

  // bucketize: the slots are key ascending, so a record's position in
  // its owner's bucket is the count of earlier same-owner slots (the
  // stable owner sort of kv.bucketize); past cap it stays local
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int o = owner[i];
    if (o >= P) continue;  // sentinel / out of window: neither pushed nor kept
    int pos = 0;
    for (int j = 0; j < i; ++j) pos += owner[j] == o ? 1 : 0;
    atomicAdd(&tot[o], 1);
    if (pos < cap) {
      const long long at = buck + static_cast<long long>(o) * cap + pos;
      bk[at] = uk[i];
      bv[at] = uv[i];
    } else {
      atomicAdd(&table[win + uk[i]], uv[i]);  // ownership transfer
    }
  }
  // fold the in-flight chunk; keys follow the reference scatter (sentinel
  // and out-of-range dropped, [-V, 0) wraps)
  for (int i = threadIdx.x; i < P * cap; i += blockDim.x) {
    int k = pending_k[buck + i];
    if (k == kSentinel) continue;
    if (k < 0) k += V;
    if (k >= 0 && k < V) atomicAdd(&table[win + k], pending_v[buck + i]);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    counts[static_cast<long long>(r) * P + p] = min(tot[p], cap);
  }
}

}  // namespace

// Launch on ``stream`` (PyTorch's current stream); returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fused_map_launch(
    const int* keys, const int* vals, const int* rep, const int* task_id,
    const int* owner_map, const int* owner_split, const int* pending_k,
    const int* pending_v, int* table, int* bk, int* bv, int* counts,
    int P, int S, int V, int cap, void* stream) {
  const size_t smem = static_cast<size_t>(8 * S + P) * sizeof(int) +
                      static_cast<size_t>(2 * S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_map_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, vals, rep, task_id, owner_map, owner_split, pending_k,
      pending_v, table, bk, bv, counts, P, S, V, cap);
  return static_cast<int>(cudaGetLastError());
}
