// flash_decode.cu — one query token against a long KV cache on Hopper
// (sm_90a): an asynchronous K/V ring per CTA, warps that own whole tiles,
// and the splits combined by the last CTA of each (b, kv) head.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py::
// flash_decode_pallas (body _fd_kernel). It computes the function of
// ref.py::flash_decode_plain on the layouts as they lie in memory, read
// with their strides (no transpose): q (B, H, hd), k and v (B, S, KV, hd),
// query head h reading KV head h / (H / KV); the output is (B, H, hd),
// contiguous. The current length t is read on the device (or passed by
// value), so a decode loop never waits on the host:
//   * q, k, v are bf16 or fp32 (template T). fp32: q is scaled by
//     hd**-0.5 (times log2(e): the softmax runs on exp2) before the dot;
//     bf16: the products of the bf16 values are exact in fp32, so q·k
//     sums in fp32 and is scaled after the sum: the plain version's
//     scores up to fp32 rounding;
//   * positions at or past min(t, S) are never read; a masked key has no
//     p, so t = 0 gives zeros;
//   * the online softmax (m, l), p and p·V's products and sums are fp32
//     (bf16 hands the tensor cores p as the sum of three bf16 parts, which
//     hold its 24 bits); the output is acc / max(l, 1e-30), cast to T.
//
// What bounds it. Decode is bytes: K and V below t are read once (136.3 MB
// for olmo-1b's B 8, KV 16, hd 128, t 2,079 in bf16: 0.041 ms at 3.35
// TB/s) against ~2 G FLOPs a byte, far below the card's ~295. So the
// design keeps bytes in flight all the time (Little's law: ~3 MB on the
// card, ~25 KB an SM) and keeps its instructions from standing in the
// way of the loads.
//
// Design.
//   * Grid (B*KV, splits). The G query rows of one KV head ride together,
//     so K and V are read once per group. The wrapper picks the split
//     count so that the grid fills whole waves of the CTAs the card holds
//     at once (flash_decode_ctas_per_sm: cudaOccupancyMaxActiveBlocks...
//     on this kernel's shared memory and registers, times the SM count);
//     each split takes an even share of the kTile-key tiles below t (at
//     most block_kv keys: the split count sees to that). On an H100 that
//     is one wave at both served caches: 3 x 128 CTAs at olmo-1b's, 6 x 64
//     at h2o-danube-1.8b's.
//   * A ring of kStages stages of K and V tiles in shared memory, in the
//     cache's own dtype, filled by one producer warp with 16-byte cp.async
//     copies (32 a warp instruction) that complete on the stage's full
//     mbarrier through cp.async.mbarrier.arrive (one arrival a producer
//     lane); a consumer warp releases the stage on its empty mbarrier as
//     soon as it is done with it, and the producer refills it. A staged
//     row carries a 16-byte pad, so that lanes reading their own keys'
//     rows do not share banks. One cp.async.bulk a row, and TMA boxes
//     (tensor maps encoded per call from the strides), were built and
//     timed in turns with this fill on the served caches (PERF.md, PR
//     17): neither was faster at either cache.
//   * kWarps consumer warps with a stage each, each owning whole tiles
//     (tile i goes to warp i % kWarps) with its own (m, l, acc) for the G
//     rows. No __syncthreads in the loop: a warp waits on its stage's full
//     barrier and releases it on the empty one.
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, fp32
//     accumulators): not for their FLOPs, but because a CUDA-core warp
//     spends ~1,000 instructions a 32-key tile at G = 4, hd 80, and those
//     did not hide behind the loads; the mma path spends ~40 mma and ~40
//     ldmatrix. The G <= 16 query rows are the 16 rows of A, staged once
//     in shared memory; K comes by ldmatrix (its rows are B's columns); S
//     is scaled in fp32 and masked past n by a select; P is split in
//     place into three bf16 parts (p less each part's rounding leaves the
//     next, exactly), each the A of an mma of P·V, with V read transposed
//     by ldmatrix once for the three: P·V thus takes fp32 p, as the plain
//     version does, for twice the mma a tile of rounding p to bf16. In a
//     ragged tile the warp zeroes the V rows past n (stale or never
//     written), so that 0 * V is 0. fp32 runs on the CUDA cores: a lane
//     scores its key for the G rows (q broadcast from shared memory) and a
//     lane of p·V owns 4 columns.
//   * At the end the warps merge their (m, l, acc) in shared memory (the
//     ring is free by then). With one split the CTA writes the output;
//     otherwise it writes its partial to scratch, and the last CTA of its
//     (b, kv) to finish, found with a per-head counter that it resets to
//     0 itself, merges the splits online, 8 splits' loads at a time: one
//     launch a call, on the caller's stream, with no host sync.
//   * What is left (PERF.md): the CTAs of the wave, with equal work,
//     stream at unequal rates, so the call ends with the slowest; a
//     dynamic hand-out of tiles would even them, but would make the sums'
//     order, and so the output's last bits, vary from call to call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                    // keys a stage: a key a lane
constexpr int kMaxG = 16;                    // query heads per KV head
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;
// bf16 parts of an fp32 p in P·V: 8 significant bits each, so three hold
// p's 24 (for p above ~2**-100, where bf16's subnormals start to cut the
// last part; such a p moves no output)
constexpr int kParts = 3;

// The ring's shape: one stage per consumer warp (tile i sits in stage
// i % kStages and goes to warp i % kWarps, so a warp waits on its own
// stage only and never runs a phase ahead of it) and one producer warp.
constexpr int kWarps = 4;
constexpr int kStages = kWarps;
constexpr int kThreads = 32 * (kWarps + 1);
static_assert(kStages % kWarps == 0, "each stage has one consumer warp");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* t_dev;                          // device t, or null: t_host
  int t_host;
  void* out;                                 // (B, H, hd) contiguous
  float* part;                               // (B*KV, splits, G, hd + 2)
  int* count;                                // (B*KV), 0 between calls
  int S, KV, G, hd, splits;
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h;   // in elements
  float scale;                               // hd**-0.5 * log2(e)
};

__host__ __device__ constexpr int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// bytes of one staged row: the row and a 16-byte pad
template <typename T>
__host__ __device__ int row_bytes(int hd) {
  return hd * static_cast<int>(sizeof(T)) + 16;
}

template <typename T>
__host__ __device__ int stage_bytes(int hd) {
  return align_up(2 * kTile * row_bytes<T>(hd), 128);
}

// ring, then q (fp32: G*hd floats and p, kWarps x kTile x GMAX floats;
// bf16: 16 rows of hd + 8), then the 2 * kStages mbarriers and a flag
template <typename T, int GMAX>
__host__ __device__ int smem_bytes(int hd, int G) {
  const int q = sizeof(T) == 4
                    ? align_up(G * hd * 4, 16) + kWarps * kTile * GMAX * 4
                    : 16 * (hd + 8) * 2;
  return kStages * stage_bytes<T>(hd) + q + 2 * kStages * 8 + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes from global to shared memory (L2 only), tracked by this
// thread's cp.async group
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// a consumer warp done with a stage hands it back: once every lane's
// reads are done, one arrival on the empty barrier
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

template <int N>
__device__ __forceinline__ void consumers_sync() {   // N consumer threads
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}


__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 lds4(const void* p) {
  return *reinterpret_cast<const float4*>(p);
}

// two floats rounded to a bf16x2 word (the first in the low half), each
// left holding what the rounding dropped: exact in fp32, so the parts that
// successive calls take sum to the floats given
__device__ __forceinline__ uint32_t take_bf16(float& lo, float& hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(x);
  lo -= f.x;
  hi -= f.y;
  return *reinterpret_cast<const uint32_t*>(&x);
}

// four 8x8 bf16 matrices from shared memory, lane i giving the address of
// row i % 8 of matrix i / 8; TRANS hands each lane the transposed pairs
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fp32 path of a consumer warp (CUDA cores): a lane scores its key
// for the G rows (q broadcast from shared memory), the warp takes the
// tile's max by shuffles, and for p·V a lane owns 4 columns, so where hd
// is below 128 several keys go in one pass and their groups fold by
// shuffles at the end. Leaves (m, l, acc) of its G rows in mw, lw, aw.
template <int GMAX>
__device__ __forceinline__ void consume_fp32(
    const Args& a, const unsigned char* ring, int sb, int rb, float* qs,
    float* ps, uint32_t full0, uint32_t empty0, int start, int end,
    int ntiles, int warp, int lane, float* aw, float* mw, float* lw) {
  constexpr int kCols = 4, kEpc = 4;
  const int hd = a.hd, G = a.G;
  float m[GMAX], l[GMAX], acc[GMAX][kCols];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[g][e] = 0.f;
  }
  float* pw = ps + warp * kTile * GMAX;
  const int nch = hd / kEpc;                 // 16-byte chunks a row
  const int lpk = hd / kCols, groups = 32 / lpk;   // lanes a key, keys a pass
  const int grp = lane / lpk, col = (lane % lpk) * kCols;
  for (int i = warp; i < ntiles; i += kWarps) {
    const int s = i % kStages, ph = (i / kStages) & 1;
    const int n = min(kTile, end - (start + i * kTile));
    const unsigned char* kt = ring + s * sb;
    const unsigned char* vt = kt + kTile * rb;
    bar_wait(full0 + 8 * s, ph);

    float sc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
    if (lane < n) {                          // this lane's key: G scores
      const unsigned char* row = kt + lane * rb;
      for (int c = 0; c < nch; ++c) {
        const float4 kf = lds4(row + c * 16);
        const float* qc = qs + c * kEpc;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 qv = lds4(qc + g * hd);
            sc[g] += qv.x * kf.x + qv.y * kf.y + qv.z * kf.z + qv.w * kf.w;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {         // online softmax on exp2
      if (g < G) {
        const float x = lane < n ? sc[g] : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(x));
        const float corr = exp2f(m[g] - m_new);
        const float p = lane < n ? exp2f(x - m_new) : 0.f;
        l[g] = l[g] * corr + p;              // this lane's share of l
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[g][e] *= corr;
        pw[lane * GMAX + g] = p;
      }
    }
    __syncwarp();
    if (grp < groups) {                      // acc += p V
      for (int j = grp; j < n; j += groups) {
        const float4 vf = lds4(vt + j * rb + col * 4);
        float p[GMAX];
        if constexpr (GMAX % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GMAX; g += 4) {
            const float4 x = lds4(pw + j * GMAX + g);
            p[g] = x.x;
            p[g + 1] = x.y;
            p[g + 2] = x.z;
            p[g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) p[g] = pw[j * GMAX + g];
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            acc[g][0] += p[g] * vf.x;
            acc[g][1] += p[g] * vf.y;
            acc[g][2] += p[g] * vf.z;
            acc[g][3] += p[g] * vf.w;
          }
        }
      }
    }
    release(empty0 + 8 * s, lane);
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {           // fold the key groups
    l[g] = warp_sum(l[g]);
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const float x = acc[g][e];
      for (int k = 1; k < groups; ++k)
        acc[g][e] += __shfl_sync(0xffffffffu, x, (lane + k * lpk) & 31);
    }
  }
  consumers_sync<32 * kWarps>();             // every tile consumed
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        mw[warp * G + g] = m[g];
        lw[warp * G + g] = l[g];
      }
      if (grp == 0) {
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          aw[(warp * G + g) * hd + col + e] = acc[g][e];
      }
    }
  }
}

// The bf16 path of a consumer warp (tensor cores, mma.sync m16n8k16): the
// G <= 16 query rows are the 16 rows of A, staged in shared memory as given
// (qh: rows of HD + 8, zero past G) and taken by ldmatrix each tile, which
// leaves the registers to the accumulators; S = q K^T takes K from the
// stage by ldmatrix (its rows are B's columns), is scaled in fp32 and
// masked past n; the online softmax runs on S's fragments (a row spread
// over the 4 lanes of a quad); P, packed to bf16 in place, is the A of
// O += P V, with V read transposed by ldmatrix. Leaves (m, l, o) of its G
// rows in mw, lw, aw.
template <int HD>
__device__ __forceinline__ void consume_bf16(
    const Args& a, unsigned char* ring, int sb, int rb, uint32_t qh,
    uint32_t full0, uint32_t empty0, int start, int end, int ntiles,
    int warp, int lane, float* aw, float* mw, float* lw) {
  constexpr int NK = HD / 16, ND = HD / 8;   // k-steps of q K^T, n-tiles of O
  const int G = a.G;
  const int r0 = lane >> 2, c2 = (lane & 3) * 2;   // fragment row, columns
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows r0, r0 + 8
  // this lane's ldmatrix row: matrix lane / 8, row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  for (int i = warp; i < ntiles; i += kWarps) {
    const int s = i % kStages, ph = (i / kStages) & 1;
    const int n = min(kTile, end - (start + i * kTile));
    const uint32_t kt = smem_u32(ring + s * sb), vt = kt + kTile * rb;
    bar_wait(full0 + 8 * s, ph);

    float sc[4][4];                          // keys nt * 8 + c2 + {0, 1}
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4];                        // rows 0-15, columns 16 kk + 0-15
      ldsm_x4<false>(qh + (((mi & 1) * 8 + mr) * (HD + 8) + kk * 16 +
                           (mi >> 1) * 8) * 2,
                     qa);
#pragma unroll
      for (int np = 0; np < 2; ++np) {       // keys of n-tiles 2np, 2np + 1
        uint32_t r[4];
        ldsm_x4<false>(kt + ((2 * np + (mi >> 1)) * 8 + mr) * rb +
                           (kk * 16 + (mi & 1) * 8) * 2,
                       r);
        mma_bf16(sc[2 * np], qa, r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qa, r[2], r[3]);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + c2 + (e & 1);
        sc[nt][e] = key < n ? sc[nt][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {            // online softmax on exp2
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = exp2f(sc[nt][e] - m[e >> 1]);   // 0 where masked
        l[e >> 1] += sc[nt][e];              // this lane's share of l
      }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= corr[e >> 1];
    if (n < kTile) {                         // V rows past n: zeros, so
      unsigned char* vr = ring + s * sb + kTile * rb;   // their p = 0 gives 0
      for (int e = lane; e < (kTile - n) * (HD / 8); e += 32)
        *reinterpret_cast<uint4*>(vr + (n + e / (HD / 8)) * rb +
                                  (e % (HD / 8)) * 16) = make_uint4(0, 0, 0, 0);
      __syncwarp();
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {         // keys 16 ks .. 16 ks + 15
      float* s0 = sc[2 * ks];
      float* s1 = sc[2 * ks + 1];
      uint32_t pa[kParts][4];                // p = the sum of the parts
#pragma unroll
      for (int j = 0; j < kParts; ++j) {
        pa[j][0] = take_bf16(s0[0], s0[1]);
        pa[j][1] = take_bf16(s0[2], s0[3]);
        pa[j][2] = take_bf16(s1[0], s1[1]);
        pa[j][3] = take_bf16(s1[2], s1[3]);
      }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {  // columns of n-tiles 2np, 2np+1
        uint32_t r[4];
        ldsm_x4<true>(vt + (ks * 16 + (mi & 1) * 8 + mr) * rb +
                          (2 * np + (mi >> 1)) * 8 * 2,
                      r);
#pragma unroll
        for (int j = kParts - 1; j >= 0; --j) {   // the smallest part first
          mma_bf16(o[2 * np], pa[j], r[0], r[1]);
          mma_bf16(o[2 * np + 1], pa[j], r[2], r[3]);
        }
      }
    }
    release(empty0 + 8 * s, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {              // l over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  consumers_sync<32 * kWarps>();             // every tile consumed
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = r0 + 8 * h;
    if (g < G) {
      if (c2 == 0) {
        mw[warp * G + g] = m[h];
        lw[warp * G + g] = l[h];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        float* dst = aw + (warp * G + g) * HD + nd * 8 + c2;
        dst[0] = o[nd][2 * h];
        dst[1] = o[nd][2 * h + 1];
      }
    }
  }
}

// fp32 takes the CUDA-core path (GMAX >= G rows, any hd; HD is 0), bf16
// the tensor-core path (HD the head dim; GMAX unused, 1).
// bf16 asks for three CTAs an SM (at most 136 registers a thread): the
// bytes in flight that the served caches need.
template <typename T, int GMAX, int HD>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 1)
    decode_kernel(const Args a) {
  constexpr int kEpc = 16 / sizeof(T);       // elements a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = a.hd, G = a.G;
  const int rb = row_bytes<T>(hd), sb = stage_bytes<T>(hd);
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + kStages * sb);
  float* ps = qs + align_up(G * hd, 4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + smem_bytes<T, GMAX>(hd, G) - 2 * kStages * 8 - 16);
  int* flag = reinterpret_cast<int*>(bars + 2 * kStages);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int bkv = blockIdx.x, b = bkv / a.KV, kvh = bkv % a.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int t = a.t_dev ? *a.t_dev : a.t_host;
  t = t < 0 ? 0 : (t > a.S ? a.S : t);
  // this split's share of the tiles below t: an even one, so that no
  // split is left with a short tail
  const int below = (t + kTile - 1) / kTile;
  const int first = static_cast<int>(1ll * blockIdx.y * below / a.splits);
  const int ntiles =
      static_cast<int>(1ll * (blockIdx.y + 1) * below / a.splits) - first;
  const int start = first * kTile, end = min(start + ntiles * kTile, t);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, 32);          // a cp.async arrival a lane
      bar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {                      // the producer warp
    const T* kb = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;
    const uint32_t row_len = hd * sizeof(T);
    const int per_row = row_len / 16;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages, ph = (i / kStages) & 1;
      const int row0 = start + i * kTile, n = min(kTile, end - row0);
      const uint32_t kdst = smem_u32(ring + s * sb), vdst = kdst + kTile * rb;
      bar_wait(empty0 + 8 * s, ph ^ 1);
      for (int e = lane; e < n * per_row; e += 32) {
        const int r = e / per_row, c = e % per_row;
        cp_async16(kdst + r * rb + c * 16, kb + (row0 + r) * a.k_s + c * kEpc);
        cp_async16(vdst + r * rb + c * 16, vb + (row0 + r) * a.v_s + c * kEpc);
      }
      cp_async_arrive(full0 + 8 * s);       // once this lane's copies land
    }
    return;
  }

  // the consumer warps: tiles warp, warp + kWarps, ...; then they merge
  // their (m, l, acc) in the (by then idle) ring: acc (kWarps, G, hd), m
  // and l (kWarps, G)
  float* aw = reinterpret_cast<float*>(ring);
  float* mw = aw + kWarps * G * hd;
  float* lw = mw + kWarps * G;
  if constexpr (HD == 0) {
    const T* qb = static_cast<const T*>(a.q) + b * a.q_b + kvh * G * a.q_h;
    for (int e = tid; e < G * hd; e += 32 * kWarps)
      qs[e] = qb[(e / hd) * a.q_h + e % hd] * a.scale;
    consumers_sync<32 * kWarps>();
    consume_fp32<GMAX>(a, ring, sb, rb, qs, ps, full0, empty0, start, end,
                       ntiles, warp, lane, aw, mw, lw);
  } else {
    __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(qs);
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                              b * a.q_b + kvh * G * a.q_h;
    for (int e = tid; e < 16 * HD; e += 32 * kWarps) {
      const int g = e / HD, d = e % HD;
      qh[g * (HD + 8) + d] = g < G ? qb[g * a.q_h + d] : __float2bfloat16(0.f);
    }
    consumers_sync<32 * kWarps>();
    consume_bf16<HD>(a, ring, sb, rb, smem_u32(qh), full0, empty0, start,
                     end, ntiles, warp, lane, aw, mw, lw);
  }
  consumers_sync<32 * kWarps>();

  T* out = static_cast<T*>(a.out) + static_cast<long long>(bkv) * G * hd;
  const int pstride = G * (hd + 2);          // floats a split's partial
  float* part = a.part + (static_cast<long long>(bkv) * a.splits +
                          blockIdx.y) * pstride;
  for (int e = tid; e < G * hd; e += 32 * kWarps) {
    const int g = e / hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * G + g]);
    float lsum = 0.f, asum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mw[w * G + g] - mx);
      lsum += lw[w * G + g] * wt;
      asum += aw[w * G * hd + e] * wt;
    }
    if (a.splits == 1) {
      store(out + e, asum / fmaxf(lsum, 1e-30f));
    } else {
      part[e] = asum;
      if (e % hd == 0) {
        part[G * hd + g] = mx;
        part[G * hd + G + g] = lsum;
      }
    }
  }
  if (a.splits == 1) return;

  // the last CTA of this (b, kv) head combines the splits
  __threadfence();
  consumers_sync<32 * kWarps>();
  if (tid == 0) {
    const int done = atomicAdd(a.count + bkv, 1);
    *flag = done == a.splits - 1;
    if (*flag) a.count[bkv] = 0;             // ready for the next call
    __threadfence();
  }
  consumers_sync<32 * kWarps>();
  if (!*flag) return;
  // an online merge over batches of kBatch splits, each batch's loads
  // issued together (one L2 round trip a batch, not three a split)
  constexpr int kBatch = 8;
  const float* p0 = a.part + static_cast<long long>(bkv) * a.splits * pstride;
  for (int e = tid; e < G * hd; e += 32 * kWarps) {
    const int g = e / hd;
    float mx = kNegInf, lsum = 0.f, asum = 0.f;
    for (int s0 = 0; s0 < a.splits; s0 += kBatch) {
      float ms[kBatch], ls[kBatch], as[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool in = s0 + j < a.splits;
        const float* ps_ = p0 + (s0 + j) * pstride;
        ms[j] = in ? __ldcg(ps_ + G * hd + g) : kNegInf;
        ls[j] = in ? __ldcg(ps_ + G * hd + G + g) : 0.f;
        as[j] = in ? __ldcg(ps_ + e) : 0.f;
      }
      float m_new = mx;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) m_new = fmaxf(m_new, ms[j]);
      const float corr = exp2f(mx - m_new);
      lsum *= corr;
      asum *= corr;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float wt = exp2f(ms[j] - m_new);
        lsum += ls[j] * wt;
        asum += as[j] * wt;
      }
      mx = m_new;
    }
    store(out + e, asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int GMAX, int HD>
int ctas_per_sm(int hd, int G) {
  auto kern = decode_kernel<T, GMAX, HD>;
  // the largest this instantiation takes, so any call's launch fits
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, GMAX>(HD ? HD : kMaxHd, kMaxG));
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kern, kThreads, smem_bytes<T, GMAX>(hd, G));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <typename T, int GMAX, int HD>
int launch(const Args& a, int B, cudaStream_t s) {
  decode_kernel<T, GMAX, HD><<<dim3(B * a.KV, a.splits), kThreads,
                               smem_bytes<T, GMAX>(a.hd, a.G), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

struct OccupancyFn {
  int hd, G;
  template <typename T, int GMAX, int HD>
  int run() const {
    return ctas_per_sm<T, GMAX, HD>(hd, G);
  }
};

struct LaunchFn {
  const Args* a;
  int B;
  cudaStream_t s;
  template <typename T, int GMAX, int HD>
  int run() const {
    return launch<T, GMAX, HD>(*a, B, s);
  }
};

// f.template run<T, GMAX, HD>() for the instantiation that takes dtype
// (0 fp32, 1 bf16), hd and G: fp32 by the G rows it holds (1, 4 or 16),
// bf16 by its head dim. The caller checks the arguments.
template <typename F>
int dispatch(int dtype, int hd, int G, F f) {
  if (dtype == 0) {
    if (G == 1) return f.template run<float, 1, 0>();
    if (G <= 4) return f.template run<float, 4, 0>();
    return f.template run<float, 16, 0>();
  }
  if (hd == 32) return f.template run<__nv_bfloat16, 1, 32>();
  if (hd == 64) return f.template run<__nv_bfloat16, 1, 64>();
  if (hd == 80) return f.template run<__nv_bfloat16, 1, 80>();
  return f.template run<__nv_bfloat16, 1, 128>();
}

bool args_ok(int dtype, int hd, int G) {
  return (hd == 32 || hd == 64 || hd == 80 || hd == 128) && G >= 1 &&
         G <= kMaxG && (dtype == 0 || dtype == 1);
}

}  // namespace

// CTAs of the instantiation for (dtype, hd, G) that one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor on its shared
// memory, after raising its dynamic shared-memory limit), or minus a CUDA
// error code.
extern "C" int flash_decode_ctas_per_sm(int dtype, int hd, int G) {
  if (!args_ok(dtype, hd, G)) return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, hd, G, OccupancyFn{hd, G});
}

// Launch on ``stream`` (PyTorch's current stream), after
// flash_decode_ctas_per_sm for the same (dtype, hd, G) on this
// device. ``t_dev`` points at a device int32 holding t, or is null and
// t_host is t. Strides are in elements (the last dim of q, k and v has
// stride 1). ``count`` holds B*KV int32 counters, zero before the call and
// left zero after it, and ``part`` (B*KV, splits, G, hd + 2) fp32
// partials (unused when splits is 1); out is (B, H, hd) contiguous.
// dtype is 0 for fp32, 1 for bf16; hd 32, 64, 80 or 128; G at most 16.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take, so the caller
// can raise.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* t_dev,
    int t_host, void* out, void* count, void* part, int B, int S, int KV,
    int G, int hd, int splits, long long q_b, long long q_h,
    long long k_b, long long k_s, long long k_h, long long v_b,
    long long v_s, long long v_h, float scale, int dtype, void* stream) {
  if (splits < 1 || splits > 65535 || B * KV < 1 || !args_ok(dtype, hd, G))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.t_dev = static_cast<const int*>(t_dev);
  a.t_host = t_host;
  a.out = out;
  a.count = static_cast<int*>(count);
  a.part = static_cast<float*>(part);
  a.S = S;
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.splits = splits;
  a.q_b = q_b;
  a.q_h = q_h;
  a.k_b = k_b;
  a.k_s = k_s;
  a.k_h = k_h;
  a.v_b = v_b;
  a.v_s = v_s;
  a.v_h = v_h;
  a.scale = scale * 1.4426950408889634f;
  return dispatch(dtype, hd, G,
                  LaunchFn{&a, B, static_cast<cudaStream_t>(stream)});
}
