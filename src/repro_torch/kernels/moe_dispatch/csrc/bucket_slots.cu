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
// Design. The TPU kernel carries per-expert running totals across a
// sequential grid of token blocks in VMEM. CTAs run in no order, so the
// carry becomes a scan across blocks, in three launches:
//   1. block_pass<false>: one CTA of 1,024 threads per 1,024-token block
//      counts its tokens per expert, giving an (nb, E) array;
//   2. scan_blocks: one CTA per expert takes the exclusive scan of its
//      column over the blocks (the block's offset) and the column's total
//      (the expert's fill count);
//   3. block_pass<true>: each block ranks its records in token order and
//      adds its offset.
// The rank within a block: __match_any_sync finds the lanes of a warp
// holding the same id, and the popcount of those below a lane is its rank
// in the warp; the lowest lane writes the group's size into a (32 warps x
// E) table in shared memory, whose exclusive scan over the warps (one
// thread per expert) gives each warp's offset within the block. E is at
// most 256 (32 KB of shared memory).
//
// What bounds it. Ids read once, slots and counts written once: 8 T + 4 E
// bytes (0.79 MB at T = 98,304, E = 64; 8.4 MB at T = 2^20, E = 8), under
// 3 us at 3.35 TB/s. At these sizes the three launches, not the bytes,
// set the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;                 // tokens and threads of a CTA
constexpr int kWarps = kBlock / 32;
constexpr int kMaxExperts = 256;

template <bool kWriteSlots>
__global__ void __launch_bounds__(kBlock)
    block_pass(const int* __restrict__ eids, long long T, int E,
               int* __restrict__ blk_cnt, const int* __restrict__ blk_off,
               int* __restrict__ slots) {
  __shared__ int wcnt[kWarps * kMaxExperts];   // [warp][expert]
  for (int i = threadIdx.x; i < kWarps * E; i += kBlock) wcnt[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const int id = t < T ? eids[t] : -1;
  const bool valid = id >= 0 && id < E;
  const unsigned same = __match_any_sync(0xffffffffu, valid ? id : -1);
  const int below = __popc(same & ((1u << lane) - 1u));
  if (valid && below == 0) wcnt[warp * E + id] = __popc(same);
  __syncthreads();

  for (int e = threadIdx.x; e < E; e += kBlock) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * E + e];
      wcnt[w * E + e] = run;
      run += c;
    }
    if (!kWriteSlots) blk_cnt[static_cast<long long>(blockIdx.x) * E + e] = run;
  }
  if (kWriteSlots) {
    __syncthreads();
    if (t < T)
      slots[t] = valid ? blk_off[static_cast<long long>(blockIdx.x) * E + id] +
                             wcnt[warp * E + id] + below
                       : -1;
  }
}

// one CTA per expert e: blk_off[:, e] = exclusive scan of blk_cnt[:, e]
// over the nb blocks, counts[e] = its total
__global__ void __launch_bounds__(kBlock)
    scan_blocks(const int* __restrict__ blk_cnt, int nb, int E,
                int* __restrict__ blk_off, int* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;
  const int e = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kBlock) {
    const int b = base + threadIdx.x;
    const int v = b < nb ? blk_cnt[static_cast<long long>(b) * E + e] : 0;
    int x = v;                                 // inclusive scan in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {                           // inclusive scan of the warps
      int s = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    if (b < nb)
      blk_off[static_cast<long long>(b) * E + e] =
          carry + (warp ? warp_sum[warp - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kWarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[e] = carry;
}

}  // namespace

// Launch the three passes on ``stream`` (PyTorch's current stream).
// blk_cnt and blk_off are (ceil(T / 1024), E) int32 scratch that the
// caller allocates. Returns cudaGetLastError() after each launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take,
// so the caller can raise.
extern "C" int bucket_slots_launch(const void* eids, long long T, int E,
                                   void* slots, void* counts, void* blk_cnt,
                                   void* blk_off, void* stream) {
  if (T <= 0 || E < 1 || E > kMaxExperts)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (T + kBlock - 1) / kBlock;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(eids);
  int* cnt = static_cast<int*>(blk_cnt);
  int* off = static_cast<int*>(blk_off);
  block_pass<false><<<static_cast<unsigned>(nb), kBlock, 0, s>>>(
      ids, T, E, cnt, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_blocks<<<E, kBlock, 0, s>>>(cnt, static_cast<int>(nb), E, off,
                                   static_cast<int*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_pass<true><<<static_cast<unsigned>(nb), kBlock, 0, s>>>(
      ids, T, E, nullptr, off, static_cast<int*>(slots));
  return static_cast<int>(cudaGetLastError());
}
