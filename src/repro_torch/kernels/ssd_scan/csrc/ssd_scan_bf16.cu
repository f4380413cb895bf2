// ssd_scan_bf16.cu — the Mamba-2 chunked SSD scan in bf16 on Hopper
// (sm_90a): three chunk-parallel passes, the products on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_pallas
// (body _ssd_kernel) for bf16 inputs; fp32 keeps csrc/ssd_scan.cu. It
// computes the function of ref.py::ssd_plain on the layouts as they lie in
// memory: x, y (B, S, H, P) bf16; dt (B, S, H) fp32 or bf16; A (H,) fp32;
// B, C (B, S, G, N) bf16, head h reading group h / (H / G); the final
// state (B, H, P, N) fp32. Per chunk c of `chunk` rows, cum is the
// inclusive cumsum of dt * A over the chunk and last_c = cum[len - 1].
// The three passes (ref.py::ssd_chunked_plain does the same in torch):
//   (a) chunk_state_kernel, a CTA per (b, h, chunk): cum by a block scan
//       (kept with dt in a scratch buffer for (b) and (c)), and the
//       chunk's own state from zero,
//         U_c = sum_j (x_j dt_j exp(last_c - cum_j))^T B_j      (P, N) fp32;
//   (b) state_pass_kernel, a thread per 4 state entries of one (b, h):
//         S_in[0] = 0, S_in[c] = S_in[c-1] exp(last_{c-1}) + U_{c-1},
//       written over U in place, and the final state S_in[n_chunks];
//   (c) chunk_out_kernel, a CTA per (b, h, chunk, 64-row tile; a chunk
//       that is not a multiple of 64 rows ends in a short tile), the tile
//       with the most causal work first within each chunk:
//         y_i = exp(cum_i) (C_i . S_in[c]^T)
//               + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j.
// At the served shape that is 3072 CTAs in (a) and 12288 in (c), where the
// TPU grid's sequential chunk axis gave 384 CTAs that each walked 8 chunks.
// The decay of a pair is selected, never multiplied by a 0/1 mask: above
// the diagonal exp(cum_i - cum_j) can overflow to inf, and inf * 0 is NaN.
// Below the diagonal tile it is factored as e^{cum_i - cum_r} e^{cum_r -
// cum_j}, r the key tile's last row: both factors are at most 1. Rows at
// or past S (the ragged tail of the last chunk) are read as dt = 0, x = B
// = C = 0, which is identity decay and no update, and are never written.
// A chunk is any multiple of 16 rows up to 256 (16 for the SMOKE configs):
// (a) scans 256 rows with dt = 0 past the chunk's, so cum stays flat there
// and last_c = cum[len - 1], and keeps cum and dt for the chunk rounded up
// to whole 64-row tiles (cpad rows), which (b) and (c) read: (c)'s last
// tile then reads cum flat and dt 0 past the chunk, as past a ragged S.
// P is 16, 32 or 64 and N 16, 32 or 128.
//
// The tensor cores (mma.sync m16n8k16 bf16, operands by ldmatrix) take the
// four products: C_i . B_j^T, M . x_j with M_ij = (C_i . B_j) exp(cum_i -
// cum_j) dt_j, C_i . S_in^T and the update (x dt exp(last - cum))^T B.
// Each keeps one side an exact bf16 input (C, x, C, B). The bf16-parts
// rule: the fp32 side (M, S_in, the weighted x) goes in as kParts bf16
// parts, v = hi + lo with hi = bf16(v) and lo = bf16(v - hi), about 16
// significant bits, and no fp32 value is rounded to a single bf16 on its
// way to the tensor cores: that rounding would add an error the size of
// the bf16 reference path's own. Sums are fp32 throughout; y is rounded
// to bf16 once, at the end.
//
// What bounds it. At the served shape (B 8, S 2048, H 48, P 64, N 128,
// G 1, chunk 256) the function's bound is its bytes: 223.9 MB of x, y, dt,
// B, C and the state at 3.35 TB/s (0.067 ms), against 63 GFLOP of visible
// pairs and state products that take 0.064 ms at the bf16 tensor-core
// rate. The passes move more: U written by (a) and read by (b), S_in
// written by (b) and read by (c), two round trips of 100.7 MB of chunk
// states, and x read by both (a) and (c): ~0.7 GB, ~0.2 ms at the memory
// rate. The parts double three of the four products, to ~103 GFLOP, and
// mma.sync runs at about half the tensor cores' wgmma rate, so the
// products need ~0.2 ms too. Both (a) and (c) are held back by latency
// more than by either: their CTAs hold few tiles each, so the loads of a
// prologue and the barriers of a short tile loop stand in the way, and
// registers and shared memory cap (c) at 16 warps an SM.
//
// Design. Tiles are staged by 16-byte cp.async into rows padded by 8 bf16
// (16 bytes), so the 8 rows of an ldmatrix land in 8 different bank
// groups. (a) runs up to 8 warps a CTA, each a 16 x (8k) block of U; it
// keeps the next tile's x in registers and its B in flight while the
// tensor cores take the current one. (b) stores S_in[c] as bf16 (hi, lo)
// parts in U's bytes, each 8 entries as their 8 hi then their 8 lo, so
// (c) loads both parts by ldmatrix; a pair of threads owns 8 entries. In
// (c) a warp owns 16 rows of the tile: one round of cp.async brings the
// chunk's cum and dt, C_i and S_in[c]; C_i's fragments stay in registers
// for the whole tile; the scores of 32 keys at a time go from the
// accumulators straight into the A fragments of M . x (no shared-memory
// round trip); the B_j, x_j tiles are double-buffered, in the bytes that
// C_i and S_in held; on the diagonal tile a warp skips the keys past its
// last row.
//
// What a later PR would do next: fuse (b) into (c) with a decoupled
// look-back (chunk c takes S_in from chunk c - 1 through a flag in global
// memory, a ticket counter keeping predecessors resident), which removes
// (b)'s ~200 MB; wgmma on 64-row warpgroup tiles fed by TMA, which reads
// each B, x and S_in tile from shared memory once per 64 rows and runs at
// twice mma.sync's rate; and, at G = 1, C_i . B_j^T shared by all the
// heads of a group (a quarter of the products here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;              // rows of a staged tile
constexpr int kMaxChunk = 256;
constexpr int kParts = 2;              // bf16 parts of an fp32 operand
constexpr int kOutThreads = 128;       // pass (c): 4 warps of 16 rows
constexpr int kStateThreads = 256;     // pass (b)
constexpr int kStateBatch = 4;         // chunks whose U (b) loads at once

// pass (a)'s warps: up to 8, each a 16-row by (8k)-column block of U
template <int P, int N>
__host__ __device__ constexpr int state_threads() {
  return 32 * ((P / 16) * (N / 8) < 8 ? (P / 16) * (N / 8) : 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float load_dt(const void* dt, long long i,
                                         int dt_bf16) {
  return dt_bf16 ? __bfloat162float(static_cast<const bf16*>(dt)[i])
                 : static_cast<const float*>(dt)[i];
}

// 16 bytes from global to shared memory (L2 only)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the next bf16 part of the pair (lo, hi): packs bf16(lo), bf16(hi) and
// leaves the remainders, so that kParts successive calls take parts that
// sum to the floats given
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

// rows [row0, row0 + 64) of a bf16 matrix of width W (row stride `ld`
// elements) into dst[64][W + 8] by 16-byte cp.async, by T threads; rows
// at or past `n` are zeroed. The caller commits the group.
template <int W, int T>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ld, int row0, int n) {
  constexpr int kVec = W / 8;          // 16-byte pieces of a row
  for (int i = threadIdx.x; i < kTile * kVec; i += T) {
    const int r = i / kVec, v = i % kVec;
    bf16* d = dst + r * (W + 8) + v * 8;
    if (row0 + r < n)
      cp_async16(smem_u32(d), src + static_cast<long long>(row0 + r) * ld +
                                  v * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// (a) each chunk's own state from zero, U_c = (x dt e^{last - cum})^T B
// ---------------------------------------------------------------------------

// dt of the chunk's rows into dts[256] (zero at or past len), then cum =
// the inclusive cumsum of dt * a over the 256 rows (flat past len): each
// of the T threads 256 / T neighbouring rows, a warp scan by shuffles, the
// warps' totals through wsum. Ends with the block synchronised.
template <int T>
__device__ __forceinline__ void chunk_cumsum(const void* dt, int dt_bf16,
                                             long long dt0, long long dt_ld,
                                             int len, float a, float* dts,
                                             float* cum, float* wsum) {
  constexpr int R = kMaxChunk / T;
  static_assert(R * T == kMaxChunk && R >= 1, "rows a thread");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int r = t; r < kMaxChunk; r += T)
    dts[r] = r < len ? load_dt(dt, dt0 + static_cast<long long>(r) * dt_ld,
                               dt_bf16)
                     : 0.f;
  __syncthreads();
  float v[R], own = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    v[k] = dts[R * t + k] * a;
    own += v[k];
  }
  float incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    run += v[k];
    cum[R * t + k] = run;
  }
  __syncthreads();
}

template <int P, int N>
constexpr int state_smem() {
  // dts, cum, wsum; two stages of B; the x parts
  return (2 * kMaxChunk + 16) * 4 + 2 * kTile * (N + 8) * 2 +
         kParts * kTile * (P + 8) * 2;
}

template <int P, int N>
__global__ void __launch_bounds__(state_threads<P, N>())
chunk_state_kernel(const bf16* __restrict__ x, const void* __restrict__ dt,
                   int dt_bf16, const float* __restrict__ A,
                   const bf16* __restrict__ Bm, float* __restrict__ work,
                   float* __restrict__ cumdt, int S, int H, int G, int chunk,
                   int cpad, int n_chunks) {
  constexpr int T = state_threads<P, N>();
  constexpr int kLdN = N + 8, kLdP = P + 8;
  constexpr int MT = P / 16;           // 16-row m-tiles of U (rows p)
  constexpr int NS = T / 32 / MT;      // warps side by side over U's columns
  constexpr int NW = N / NS;           // columns of U a warp owns
  constexpr int NT = NW / 8;           // its 8-column n-tiles (>= 1)
  constexpr int kVec = P / 8;          // 16-byte pieces of an x row
  constexpr int XR = (kTile * kVec + T - 1) / T;   // x pieces a thread
  static_assert(NW % 8 == 0 && NS * MT * 32 == T, "warp layout of U");
  extern __shared__ uint4 smem4[];
  float* dts = reinterpret_cast<float*>(smem4);              // [256]
  float* cum = dts + kMaxChunk;                              // [256]
  float* wsum = cum + kMaxChunk;                             // [16]
  bf16* bs = reinterpret_cast<bf16*>(wsum + 16);             // [2][64][kLdN]
  bf16* xs = bs + 2 * kTile * kLdN;            // [kParts][64][kLdP] x dt e

  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, len = min(chunk, S - c0);
  const int n_tiles = (len + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long x_ld = static_cast<long long>(H) * P;
  const long long bc_ld = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const bf16* xc = x + row0 * x_ld + static_cast<long long>(h) * P;
  const bf16* bc = Bm + row0 * bc_ld + static_cast<long long>(g) * N;

  // x of tile jt into registers (zeros at or past len)
  uint4 xr[XR];
  auto load_x = [&](int jt) {
#pragma unroll
    for (int k = 0; k < XR; ++k) {
      const int i = tid + k * T, r = i / kVec, j = jt * kTile + r;
      xr[k] = make_uint4(0, 0, 0, 0);
      if (i < kTile * kVec && j < len)
        xr[k] = *reinterpret_cast<const uint4*>(
            xc + static_cast<long long>(j) * x_ld + (i % kVec) * 8);
    }
  };
  stage_rows<N, T>(bs, bc, bc_ld, 0, len);
  cp_async_commit();
  load_x(0);
  chunk_cumsum<T>(dt, dt_bf16, row0 * H + h, H, len, A[h], dts, cum, wsum);
  const float last = cum[kMaxChunk - 1];
  float* cd = cumdt + (static_cast<long long>(bh) * n_chunks + c) * 2 * cpad;
  for (int r = tid; r < cpad; r += T) {      // for passes (b) and (c)
    cd[r] = cum[r];
    cd[cpad + r] = dts[r];
  }

  const int m0 = (warp % MT) * 16, n0 = (warp / MT) * NW;
  const int mi = lane >> 3, mr = lane & 7;   // this lane's ldmatrix row
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile;
    // x_j dt_j e^{last - cum_j} as kParts bf16 parts, 8 columns a piece
#pragma unroll
    for (int k = 0; k < XR; ++k) {
      const int i = tid + k * T, r = i / kVec, v = i % kVec;
      if (i >= kTile * kVec) break;
      const float w = dts[j0 + r] * __expf(last - cum[j0 + r]);
      const bf16* e = reinterpret_cast<const bf16*>(&xr[k]);
      float f[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) f[q] = __bfloat162float(e[q]) * w;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        uint4 out;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = take_bf16(f[2 * q], f[2 * q + 1]);
        *reinterpret_cast<uint4*>(xs + (part * kTile + r) * kLdP + v * 8) =
            out;
      }
    }
    if (jt + 1 < n_tiles) {            // the next tile's loads, in flight
      stage_rows<N, T>(bs + ((jt + 1) & 1) * kTile * kLdN, bc, bc_ld,
                       j0 + kTile, len);
      cp_async_commit();
      load_x(jt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // U[m0 + 16, n0 + NW] += (x dt e)^T[m, j] B[j, n]: A from the x parts
    // (stored [j][p], so ldmatrix transposes), B from bs (stored [j][n]:
    // transposed too)
    const bf16* bt = bs + (jt & 1) * kTile * kLdN;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[kParts][4];
#pragma unroll
      for (int part = 0; part < kParts; ++part)
        ldsm_x4<true>(smem_u32(xs + (part * kTile + kk * 16 + (mi >> 1) * 8 +
                                     mr) * kLdP +
                               m0 + (mi & 1) * 8),
                      a[part]);
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {
        uint32_t r[4];   // n-tiles 2np, 2np + 1 (the second unused at NT 1)
        ldsm_x4<true>(smem_u32(bt + (kk * 16 + (mi & 1) * 8 + mr) * kLdN +
                               n0 + (2 * np + (mi >> 1)) * 8),
                      r);
#pragma unroll
        for (int part = kParts - 1; part >= 0; --part) {   // smallest first
          mma_bf16(acc[2 * np], a[part], r[0], r[1]);
          if (2 * np + 1 < NT)
            mma_bf16(acc[(2 * np + 1) % NT], a[part], r[2], r[3]);
        }
      }
    }
    __syncthreads();                   // xs and this B stage are free
  }

  // U through shared memory (B's stages are free), then out in 16-byte
  // pieces, neighbouring threads on neighbouring addresses
  constexpr int kLdU = N + 4;
  static_assert(P * kLdU * 4 <= 2 * kTile * kLdN * 2, "U fits B's stages");
  float* us = reinterpret_cast<float*>(bs);                  // [P][kLdU]
  const int r0 = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + c2;
    *reinterpret_cast<float2*>(us + (m0 + r0) * kLdU + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(us + (m0 + r0 + 8) * kLdU + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncthreads();
  float4* u = reinterpret_cast<float4*>(
      work + (static_cast<long long>(bh) * n_chunks + c) * P * N);
  for (int i = tid; i < P * N / 4; i += T)
    u[i] = *reinterpret_cast<const float4*>(us + (4 * i / N) * kLdU +
                                            4 * i % N);
}

// ---------------------------------------------------------------------------
// (b) the entering states, chunk after chunk, in place over U
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 decay_add(float4 s, float d, float4 u) {
  return make_float4(fmaf(s.x, d, u.x), fmaf(s.y, d, u.y), fmaf(s.z, d, u.z),
                     fmaf(s.w, d, u.w));
}

// A thread owns 4 neighbouring entries of one (b, h) state, a pair of
// threads 8: for each chunk a thread reads its U (16 bytes), and the pair
// writes, in the same 32 bytes, the entering state's 8 hi parts (the even
// thread) and then its 8 lo parts (the odd one), so that pass (c) takes
// both parts by ldmatrix.
__global__ void __launch_bounds__(kStateThreads)
state_pass_kernel(float* __restrict__ work, const float* __restrict__ cumdt,
                  float* __restrict__ state, int pn, int cpad, int n_chunks,
                  int blocks_per_bh) {
  const int bh = blockIdx.x / blocks_per_bh;
  const int q = (blockIdx.x % blocks_per_bh) * kStateThreads + threadIdx.x;
  const int n4 = pn / 4;               // float4s of a (P, N) state
  if (q >= n4) return;                 // whole warps: n4 is a multiple of 32
  const bool odd = q & 1;
  float4* w4 = reinterpret_cast<float4*>(
                   work + static_cast<long long>(bh) * n_chunks * pn) + q;
  const float* cd = cumdt + static_cast<long long>(bh) * n_chunks * 2 * cpad;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cb = 0; cb < n_chunks; cb += kStateBatch) {
    float4 u[kStateBatch];
    float d[kStateBatch];
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k)
      if (cb + k < n_chunks) {
        u[k] = w4[static_cast<long long>(cb + k) * n4];
        d[k] = cd[static_cast<long long>(cb + k) * 2 * cpad + cpad - 1];
      }
#pragma unroll
    for (int k = 0; k < kStateBatch; ++k) {
      if (cb + k >= n_chunks) break;
      float f[4] = {s.x, s.y, s.z, s.w};
      uint32_t hi[2], lo[2];
      hi[0] = take_bf16(f[0], f[1]);
      hi[1] = take_bf16(f[2], f[3]);
      lo[0] = take_bf16(f[0], f[1]);
      lo[1] = take_bf16(f[2], f[3]);
      // the even thread keeps the pair's hi parts, the odd one the lo parts
      const uint32_t give0 = odd ? hi[0] : lo[0], give1 = odd ? hi[1] : lo[1];
      const uint32_t got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
      const uint32_t got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
      reinterpret_cast<uint4*>(w4)[static_cast<long long>(cb + k) * n4] =
          odd ? make_uint4(got0, got1, lo[0], lo[1])
              : make_uint4(hi[0], hi[1], got0, got1);
      s = decay_add(s, expf(d[k]), u[k]);   // the chunk's decay, e^{last}
    }
  }
  reinterpret_cast<float4*>(state + static_cast<long long>(bh) * pn)[q] = s;
}

// ---------------------------------------------------------------------------
// (c) the outputs of one 64-row tile of a chunk
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr int out_smem() {
  constexpr int first = kTile * (N + 8) * 2 + P * (N * 4 + 16);   // C, S_in
  constexpr int tiles = 2 * (kTile * (N + 8) + kTile * (P + 8)) * 2;  // B, x
  return 3 * kMaxChunk * 4 + (first > tiles ? first : tiles);
}

template <int P, int N>
__global__ void __launch_bounds__(kOutThreads)
chunk_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ work,
                 const float* __restrict__ cumdt, bf16* __restrict__ y, int S,
                 int H, int G, int chunk, int cpad, int n_chunks) {
  constexpr int T = kOutThreads;
  constexpr int kLdN = N + 8, kLdP = P + 8;
  constexpr int kLdS = N * 4 + 16;     // bytes of a row of S_in's parts
  constexpr int KN = N / 16;           // k-steps over N
  constexpr int NTP = P / 8;           // n-tiles of y
  extern __shared__ uint4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);              // [256]
  float* dts = cum + kMaxChunk;                              // [256]
  float* colf = dts + kMaxChunk;       // [256] e^{cum_r - cum_j} dt_j
  bf16* region = reinterpret_cast<bf16*>(colf + kMaxChunk);
  // first C_i and S_in's parts, then (C_i's fragments in registers) the
  // double-buffered B_j, x_j tiles in the same bytes
  bf16* cs = region;                                         // [64][kLdN]
  unsigned char* sp = reinterpret_cast<unsigned char*>(cs + kTile * kLdN);
  bf16* bs = region;                                         // [2][64][kLdN]
  bf16* xs = bs + 2 * kTile * kLdN;                          // [2][64][kLdP]

  const int n_it = cpad / kTile;
  const int it = n_it - 1 - static_cast<int>(blockIdx.x % n_it);
  const int bhc = blockIdx.x / n_it;
  const int c = bhc % n_chunks, bh = bhc / n_chunks;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, len = min(chunk, S - c0), i0 = it * kTile;
  if (i0 >= len) return;               // a tile past the ragged end
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long x_ld = static_cast<long long>(H) * P;
  const long long bc_ld = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + c0;
  const bf16* xc = x + row0 * x_ld + static_cast<long long>(h) * P;
  const bf16* bc = Bm + row0 * bc_ld + static_cast<long long>(g) * N;
  const bf16* cc = Cm + row0 * bc_ld + static_cast<long long>(g) * N;

  // one round trip: cum and dt of the chunk (pass (a)'s), C_i, S_in[c]
  const float* cd = cumdt + static_cast<long long>(bhc) * 2 * cpad;
  for (int i = tid; i < cpad / 4; i += T) {
    cp_async16(smem_u32(cum + 4 * i), cd + 4 * i);
    cp_async16(smem_u32(dts + 4 * i), cd + cpad + 4 * i);
  }
  stage_rows<N, T>(cs, cc, bc_ld, i0, len);
  if (c > 0) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        work + static_cast<long long>(bhc) * P * N);
    for (int i = tid; i < P * N / 4; i += T) {     // 16-byte pieces
      const int p = i / (N / 4), v = i % (N / 4);
      cp_async16(smem_u32(sp + p * kLdS + v * 16), src + 16 * i);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int j = tid; j < chunk; j += T)
    colf[j] = __expf(cum[j | (kTile - 1)] - cum[j]) * dts[j];

  const int mi = lane >> 3, mr = lane & 7;   // this lane's ldmatrix row
  const int r0 = lane >> 2, c2 = (lane & 3) * 2;
  const int wr = warp * 16;                  // the warp's rows in the tile
  const int ia = i0 + wr + r0, ib = ia + 8;  // this lane's rows in the chunk
  uint32_t cf[KN][4];                        // C_i, rows wr .. wr + 15
#pragma unroll
  for (int kk = 0; kk < KN; ++kk)
    ldsm_x4<false>(smem_u32(cs + (wr + (mi & 1) * 8 + mr) * kLdN + kk * 16 +
                            (mi >> 1) * 8),
                   cf[kk]);
  float acc[NTP][4];
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const float cum_a = cum[ia], cum_b = cum[ib];
  if (c > 0) {   // exp(cum_i) C_i . S_in^T: S_in's rows p are B's columns
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        // 8 entries of a row: their hi parts, then their lo parts
        const uint32_t a = smem_u32(sp + (np * 16 + (mi >> 1) * 8 + mr) * kLdS +
                                    (kk * 2 + (mi & 1)) * 32);
        uint32_t r[4];
        ldsm_x4<false>(a + 16, r);                         // smallest first
        mma_bf16(acc[2 * np], cf[kk], r[0], r[1]);
        mma_bf16(acc[2 * np + 1], cf[kk], r[2], r[3]);
        ldsm_x4<false>(a, r);
        mma_bf16(acc[2 * np], cf[kk], r[0], r[1]);
        mma_bf16(acc[2 * np + 1], cf[kk], r[2], r[3]);
      }
    const float ea = __expf(cum_a), eb = __expf(cum_b);
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      acc[nt][0] *= ea;
      acc[nt][1] *= ea;
      acc[nt][2] *= eb;
      acc[nt][3] *= eb;
    }
  }
  __syncthreads();                     // the region now takes B_j and x_j

  auto stage_j = [&](int jt) {
    const int buf = jt & 1;
    stage_rows<N, T>(bs + buf * kTile * kLdN, bc, bc_ld, jt * kTile, len);
    stage_rows<P, T>(xs + buf * kTile * kLdP, xc, x_ld, jt * kTile, len);
    cp_async_commit();
  };
  stage_j(0);
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      stage_j(jt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* bt = bs + (jt & 1) * kTile * kLdN;
    const bf16* xt = xs + (jt & 1) * kTile * kLdP;
    const int j0 = jt * kTile;
    // k-steps of 16 keys this warp needs: on the diagonal tile only the
    // keys up to its last row
    const bool diag = jt == it;
    const int ks_end = diag ? warp + 1 : kTile / 16;
    const float cr = cum[j0 + kTile - 1];
    const float fa = __expf(cum_a - cr), fb = __expf(cum_b - cr);
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // keys 32 half .. 32 half + 31
      if (2 * half >= ks_end) break;
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {   // B_j's rows are B's columns
          uint32_t r[4];
          ldsm_x4<false>(smem_u32(bt + (half * 32 + np * 16 + (mi >> 1) * 8 +
                                        mr) * kLdN +
                                  kk * 16 + (mi & 1) * 8),
                         r);
          mma_bf16(sc[2 * np], cf[kk], r[0], r[1]);
          mma_bf16(sc[2 * np + 1], cf[kk], r[2], r[3]);
        }
      // M = scores x exp(cum_i - cum_j) x dt_j where j <= i, else 0
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = j0 + half * 32 + nt * 8 + c2;
        if (diag) {
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          sc[nt][0] = ia >= j ? sc[nt][0] * __expf(cum_a - cj.x) * dj.x : 0.f;
          sc[nt][1] = ia > j ? sc[nt][1] * __expf(cum_a - cj.y) * dj.y : 0.f;
          sc[nt][2] = ib >= j ? sc[nt][2] * __expf(cum_b - cj.x) * dj.x : 0.f;
          sc[nt][3] = ib > j ? sc[nt][3] * __expf(cum_b - cj.y) * dj.y : 0.f;
        } else {
          const float2 kf = *reinterpret_cast<const float2*>(colf + j);
          sc[nt][0] *= fa * kf.x;
          sc[nt][1] *= fa * kf.y;
          sc[nt][2] *= fb * kf.x;
          sc[nt][3] *= fb * kf.y;
        }
      }
      // y += M x_j, M as kParts bf16 parts; x_j stored [j][p] is B
      // transposed
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (2 * half + ks >= ks_end) break;
        uint32_t pa[kParts][4];
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          pa[part][0] = take_bf16(sc[2 * ks][0], sc[2 * ks][1]);
          pa[part][1] = take_bf16(sc[2 * ks][2], sc[2 * ks][3]);
          pa[part][2] = take_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
          pa[part][3] = take_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t r[4];
          ldsm_x4<true>(smem_u32(xt + (half * 32 + ks * 16 + (mi & 1) * 8 +
                                       mr) * kLdP +
                                 np * 16 + (mi >> 1) * 8),
                        r);
#pragma unroll
          for (int part = kParts - 1; part >= 0; --part) {
            mma_bf16(acc[2 * np], pa[part], r[0], r[1]);
            mma_bf16(acc[2 * np + 1], pa[part], r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();                   // the buffer is free for tile jt + 2
  }

  bf16* yc = y + row0 * x_ld + static_cast<long long>(h) * P;
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt) {
    const int col = nt * 8 + c2;
    if (ia < len)
      *reinterpret_cast<__nv_bfloat162*>(yc + ia * x_ld + col) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (ib < len)
      *reinterpret_cast<__nv_bfloat162*>(yc + ib * x_ld + col) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// the shared-memory limit of a kernel above 48 KB, set once
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <int P, int N>
int launch(const void* x, const void* dt, int dt_bf16, const void* A,
           const void* Bm, const void* Cm, void* y, void* st, void* work,
           void* cumdt, int B, int S, int H, int G, int chunk,
           cudaStream_t stream) {
  constexpr int kStateSmem = state_smem<P, N>(), kOutSmem = out_smem<P, N>();
  // once per instantiation, not on every call
  static const cudaError_t attr = [] {
    const cudaError_t e =
        allow_smem(chunk_state_kernel<P, N>, state_smem<P, N>());
    return e != cudaSuccess
               ? e
               : allow_smem(chunk_out_kernel<P, N>, out_smem<P, N>());
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_chunks = (S + chunk - 1) / chunk;
  const int cpad = (chunk + kTile - 1) / kTile * kTile;   // whole tiles
  const long long bh = static_cast<long long>(B) * H;
  const long long state_ctas = bh * n_chunks;
  const int blocks_per_bh = (P * N / 4 + kStateThreads - 1) / kStateThreads;
  const long long out_ctas = state_ctas * (cpad / kTile);
  if (out_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  float* w = static_cast<float*>(work);
  float* cd = static_cast<float*>(cumdt);
  chunk_state_kernel<P, N><<<static_cast<unsigned>(state_ctas),
                             state_threads<P, N>(), kStateSmem, stream>>>(
      xb, dt, dt_bf16, static_cast<const float*>(A), bb, w, cd, S, H, G,
      chunk, cpad, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  state_pass_kernel<<<static_cast<unsigned>(bh * blocks_per_bh),
                      kStateThreads, 0, stream>>>(
      w, cd, static_cast<float*>(st), P * N, cpad, n_chunks, blocks_per_bh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_out_kernel<P, N><<<static_cast<unsigned>(out_ctas), kOutThreads,
                           kOutSmem, stream>>>(
      xb, bb, static_cast<const bf16*>(Cm), w, cd, static_cast<bf16*>(y), S,
      H, G, chunk, cpad, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(const void* x, const void* dt, int dt_bf16, const void* A,
             const void* Bm, const void* Cm, void* y, void* st, void* work,
             void* cumdt, int B, int S, int H, int G, int N, int chunk,
             cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<P, 16>(x, dt, dt_bf16, A, Bm, Cm, y, st, work, cumdt, B,
                           S, H, G, chunk, s);
    case 32:
      return launch<P, 32>(x, dt, dt_bf16, A, Bm, Cm, y, st, work, cumdt, B,
                           S, H, G, chunk, s);
    case 128:
      return launch<P, 128>(x, dt, dt_bf16, A, Bm, Cm, y, st, work, cumdt, B,
                            S, H, G, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Three launches on ``stream`` (PyTorch's current stream): (a), (b), (c).
// x, B, C, y are bf16 with 16-byte aligned data; dt_dtype is 0 for fp32 dt
// and 1 for bf16. Scratch the wrapper allocates: ``work`` holds
// B*H*ceil(S/chunk)*P*N floats (U, then S_in), ``cumdt``
// B*H*ceil(S/chunk)*2*cpad, cpad the chunk rounded up to a multiple of 64
// (each chunk's cum, then its dt). P is 16, 32
// or 64, N 16, 32 or 128, chunk a multiple of 16 up to 256 (the wrapper's
// ``ops.supported``). Returns cudaGetLastError() of
// the first launch that failed, or cudaErrorInvalidValue for a shape the
// kernel is not built for, so the caller can raise.
extern "C" int ssd_scan_bf16_launch(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, void* y, void* state,
                                    void* work, void* cumdt, int B, int S,
                                    int H, int G, int P, int N, int chunk,
                                    int dt_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || G < 1 || H % G || chunk < 16 || chunk > kMaxChunk ||
      chunk % 16 || (dt_dtype != 0 && dt_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 16)
    return launch_n<16>(x, dt, dt_dtype, A, Bm, Cm, y, state, work, cumdt, B,
                        S, H, G, N, chunk, s);
  if (P == 32)
    return launch_n<32>(x, dt, dt_dtype, A, Bm, Cm, y, state, work, cumdt, B,
                        S, H, G, N, chunk, s);
  if (P == 64)
    return launch_n<64>(x, dt, dt_dtype, A, Bm, Cm, y, state, work, cumdt, B,
                        S, H, G, N, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
