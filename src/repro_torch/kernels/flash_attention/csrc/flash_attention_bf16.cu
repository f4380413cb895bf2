// flash_attention_bf16.cu — online-softmax attention for bf16 on Hopper's
// tensor cores (sm_90a: wgmma, TMA, mbarriers, warp specialisation), with
// causal and sliding-window masks, GQA and a ragged tail.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _fa_kernel) for bf16 inputs; fp32 inputs go
// to flash_attention.cu. It computes the function of
// ref.py::flash_attention_plain on the (B, S, H, hd) layout as it lies in
// memory (no transposes, no padded copies), for any hd that is a multiple
// of 4 from 16 to 160 (the widths are below):
//   * scores are bf16 q . bf16 k summed in fp32; hd**-0.5 (with log2(e)
//     folded in, for exp2f) is applied to the fp32 scores, in the exp's
//     FFMA;
//   * the online softmax starts at m = -1e30, l = 0; a key is visible when
//     k_pos < Skv, k_pos <= q_pos (causal) and k_pos > q_pos - window
//     (window > 0); a hidden score is -1e30 before the row max and its p
//     is zeroed after the exp;
//   * the output is acc / max(l, 1e-30), cast to bf16;
//   * query head h reads KV head h / (H / KV);
//   * a KV tile that the causal or window mask hides from every row of the
//     Q tile is never loaded.
//
// What bounds it. At the served shape (B 8, S 2048, H = KV = 16, hd 128,
// causal) the two products take ~137 GFLOP against ~268 MB of q, k, v and
// o: the bound is the tensor cores' (0.14 ms at 989 TFLOP/s bf16), not
// the memory's (0.08 ms at 3.35 TB/s). What each choice does about it:
//   * both products run on the tensor cores (wgmma.mma_async m64nNk16,
//     fp32 accumulators in registers); operands stay bf16 in shared memory
//     in the swizzled layout that wgmma reads, nothing is upcast;
//   * S = Q K^T reads Q and K from shared memory (both K-major); P is
//     converted to bf16 in registers, where wgmma's accumulator layout is
//     already its A-operand layout, so O += P V takes P from registers and
//     P never touches shared memory; V is read MN-major (transposed by
//     wgmma, not by a copy);
//   * the row max and sum stay in registers: a row's scores lie in one
//     quad of lanes, so two shuffles reduce them;
//   * one producer warpgroup keeps TMA loads (cp.async.bulk.tensor) of K
//     and V in flight through a 3-stage ring guarded by full/empty
//     mbarriers (2 stages at hd 160, below), and hands its registers to
//     the consumers (setmaxnreg: 24 for it, 240 for each consumer, so the
//     pipelined loop below does not spill at hd 128 or 160);
//     K and V have barriers of their own, so S of a tile starts before its
//     V has landed. Two consumer warpgroups own 64 query rows each (block
//     128 x 128 keys), so one's softmax overlaps the other's products;
//   * within a warpgroup the tiles are software-pipelined: S of tile i and
//     P V of tile i - 1 are issued together, and the softmax of tile i
//     runs while P V of tile i - 1 is still on the tensor cores;
//   * element masks are applied only on tiles that cross the diagonal,
//     the window's edge or Skv; interior tiles run unmasked. TMA fills
//     rows past Sq or Skv with zeros, so the ragged tail needs no padding;
//   * the CTAs of a head start with its heaviest causal Q tiles.
// hd 80: a 160-byte row does not fit one 128-byte swizzle atom, so the
// head dim is cut into two panels, each a TMA box of its own: columns
// [0, 64) in 128-byte swizzle and [64, 80) in 32-byte swizzle (hd 128:
// two 64-column panels; hd 64: one). QK^T takes one k16 step per 16
// columns of either panel; PV issues one wgmma per panel (n64, then n64
// or n16), each with its own descriptor.
// hd 160: three panels, [0, 64) and [64, 128) in 128-byte swizzle and
// [128, 160) (64-byte rows) in 64-byte swizzle; QK^T takes 4 + 4 + 2 k16
// steps and PV one n64, n64 and n32 wgmma a k16 step, so a consumer holds
// 80 fp32 of O beside the 64 of S. Q and a 3-stage ring of 128 x 160 K
// and V tiles would take 287,848 bytes of shared memory against the
// 232,448 a CTA may have, so the ring has 2 stages at hd 160 (205,896
// bytes); the smaller head dims keep 3.
//
// hd 16, 32 and 48 (the SMOKE configs' widths): panel 0 is 16 columns in
// 32-byte swizzle or 32 columns in 64-byte swizzle, and 48 is a 32-column
// panel 0 and a 16-column panel 1; QK^T takes one k16 step per 16 columns
// and PV one n16 or n32 wgmma per panel, as the panels above do.
//
// Any other hd that is a multiple of 4 from 16 to 160 runs on the
// instantiation of the smallest width W in {16, 32, 48, 64, 80, 128, 160}
// that holds it (20 and 24 on 32, 100 on 128), with the columns past hd
// zero in shared memory, so those columns add nothing to QK^T and make O
// columns that are not stored. TMA cannot load such a head: its zero fill
// needs a box past the tensor's hd, and at hd 20 a head's row (40 bytes)
// breaks TMA's 16-byte stride rule. So when hd < W the producer warpgroup
// loads the tiles itself: 8-byte cp.async pieces (zero-filled past hd and
// past S) written in the panels' swizzle, then a proxy fence and an
// arrival on the same full barriers. That producer is an instantiation of
// its own (kPlain), so a head at exactly W runs the TMA kernel as it was,
// its 24-register producer untouched by the loader's addressing.
//
// Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the build needs no -lcuda)
// and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;               // 2 consumer warpgroups x 64 rows
constexpr int kBlockKV = 128;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + 1 producer warpgroup
constexpr float kNegInf = -1e30f;

// wgmma's layout code of a panel of w columns (w * 2-byte rows in the
// swizzle of that span): 1 for 128-byte swizzle, 2 for 64, 3 for 32
__host__ __device__ constexpr int swizzle_layout(int w) {
  return w == 64 ? 1 : w == 32 ? 2 : 3;
}

// The panels of a head of HD columns (HD the instantiation's width):
// panel 0 holds columns [0, kW0) with kW0 = 64 from HD 64 up (128-byte
// rows in 128-byte swizzle), 32 at HD 32 and 48 (64-byte swizzle) and 16
// at HD 16 (32-byte swizzle); panel 1 holds the next kW1 columns: none
// for HD 16, 32 and 64, 16 in 32-byte swizzle for HD 48 and 80, 64 in
// 128-byte swizzle for HD 128 and 160; panel 2 holds [kW0 + kW1, HD): 32
// columns in 64-byte swizzle for HD 160, none otherwise. A panel is a
// TMA box of its own. kStages is the K/V ring's depth.
template <int HD>
struct Panels {
  static constexpr int kW0 = HD >= 64 ? 64 : HD >= 32 ? 32 : 16;
  static constexpr int kW1 = HD - kW0 < 64 ? HD - kW0 : 64;
  static constexpr int kW2 = HD - kW0 - kW1;
  static_assert(HD == 16 || HD == 32 || HD == 48 || HD == 64 || HD == 80 ||
                    HD == 128 || HD == 160,
                "the width is 16, 32, 48, 64, 80, 128 or 160");
  static constexpr int kRow0 = kW0 * 2;          // bytes of a panel-0 row
  static constexpr int kSbo0 = 8 * kRow0;        // one 8-row swizzle atom
  static constexpr int kLayout0 = swizzle_layout(kW0);
  static constexpr int kRow1 = kW1 * 2;          // bytes of a panel-1 row
  static constexpr int kSbo1 = 8 * kRow1;
  static constexpr int kLayout1 = swizzle_layout(kW1);
  static constexpr int kRow2 = kW2 * 2;          // bytes of a panel-2 row
  static constexpr int kSbo2 = 8 * kRow2;
  static constexpr int kLayout2 = swizzle_layout(kW2);
  static constexpr int kStages = HD > 128 ? 2 : 3;
};

// wgmma descriptor of a swizzled tile at shared address `addr`: `sbo` is
// the byte stride between 8-row atoms, `layout` 1 (128-byte swizzle), 2
// (64-byte) or 3 (32-byte). The leading offset is unused for these
// layouts.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
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

// One box of a 4-d tensor map (hd, heads, S, B) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(b), "r"(bar)
      : "memory");
}

// 8 bytes from global to shared memory, or 8 zero bytes when `bytes` is 0
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [row0, row0 + kRows) of head `head` of x (B, S, heads, hd) into the
// tile at `dst`, laid out as the TMA boxes of Panels<HD> lay it out (each
// panel at rows x the row bytes of the panels before it, in its swizzle:
// the 16-byte chunk bits [4, 4 + k) of a byte offset XORed with its bits
// [7, 7 + k), k 3, 2 and 1 for 128-, 64- and 32-byte swizzle), with
// columns at or past hd and rows at or past S zero. Each of the 128
// producer threads (`t`) moves 4 columns at a time (hd is a multiple of 4,
// so a piece is all in or all past hd), waits for its copies, and fences
// them for the async proxy (wgmma reads the tile through it); the caller
// then arrives on the tile's full barrier.
template <int HD, int kRows>
__device__ __forceinline__ void load_plain(uint32_t dst,
                                           const __nv_bfloat16* x, int S,
                                           int heads, int hd, int head,
                                           int row0, int b, int t) {
  using P = Panels<HD>;
  constexpr int kPieces = HD / 4;
  for (int i = t; i < kRows * kPieces; i += 128) {
    const int r = i / kPieces, c = (i % kPieces) * 4;
    uint32_t base = 0, off;
    int w = P::kW0;
    if (c < P::kW0) {
      off = r * P::kRow0 + c * 2;
    } else if (c < P::kW0 + P::kW1) {
      base = kRows * P::kRow0;
      off = r * P::kRow1 + (c - P::kW0) * 2;
      w = P::kW1;
    } else {
      base = kRows * (P::kRow0 + P::kRow1);
      off = r * P::kRow2 + (c - P::kW0 - P::kW1) * 2;
      w = P::kW2;
    }
    const uint32_t mask = w == 64 ? 7 : w == 32 ? 3 : 1;
    const int s = row0 + r;
    const bool in = s < S && c < hd;
    const __nv_bfloat16* src =
        in ? x + ((static_cast<long long>(b) * S + s) * heads + head) * hd + c
           : x;
    cp_async8(dst + base + (off ^ (((off >> 7) & mask) << 4)), src,
              in ? 8 : 0);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Returns once at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d(64 x 128, fp32) (+)= A(64 x 16, smem, K-major) . B(128 x 16, smem,
// K-major)^T; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 64, fp32) += A(64 x 16, bf16 registers) . B(16 x 64, smem,
// MN-major: wgmma transposes it).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 32, fp32) += A(64 x 16, bf16 registers) . B(16 x 32, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 16, fp32) += A(64 x 16, bf16 registers) . B(16 x 16, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
constexpr int smem_bytes() {
  // Q, then kStages K tiles, then kStages V tiles, then the mbarriers;
  // 1024 bytes of slack to align the base to the 128-byte swizzle's atom
  constexpr int kStages = Panels<HD>::kStages;
  return kBlockQ * HD * 2 + 2 * kStages * kBlockKV * HD * 2 +
         (1 + 4 * kStages) * 8 + 1024;
}
static_assert(smem_bytes<160>() <= 232448, "a CTA has 227 KB on sm_90");

// Accumulator layout of wgmma m64nN (fp32), per thread of a warpgroup:
// warp w, lane l own rows 16w + l/4 (entries 4j, 4j+1) and 16w + l/4 + 8
// (entries 4j+2, 4j+3) at columns 8j + 2(l%4) + {0, 1}.
template <int HD, bool kPlain>
__global__ void __launch_bounds__(kThreads, 1)
fa_bf16_kernel(const __grid_constant__ CUtensorMap tq0,
               const __grid_constant__ CUtensorMap tq1,
               const __grid_constant__ CUtensorMap tq2,
               const __grid_constant__ CUtensorMap tk0,
               const __grid_constant__ CUtensorMap tk1,
               const __grid_constant__ CUtensorMap tk2,
               const __grid_constant__ CUtensorMap tv0,
               const __grid_constant__ CUtensorMap tv1,
               const __grid_constant__ CUtensorMap tv2,
               const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int KV,
               int hd, int causal, int window, float scale_log2) {
  using P = Panels<HD>;
  constexpr int kStages = P::kStages;
  constexpr int kTile = kBlockKV * HD * 2;   // bytes of a K or V tile
  constexpr int kOff1 = P::kRow0;            // panel 1 at kOff1 * rows
  constexpr int kOff2 = P::kRow0 + P::kRow1; // panel 2 at kOff2 * rows
  constexpr int kQBytes = kBlockQ * HD * 2;
  // TMA loads a head at the width (hd == HD); a narrower one the producer
  // loads (kPlain)
  const int ld_hd = kPlain ? hd : HD;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + kQBytes;                 // + stage * kTile
  const uint32_t sv = sk + kStages * kTile;         // + stage * kTile
  const uint32_t bars = sv + kStages * kTile;
  const uint32_t q_full = bars;
  // k_full(s), v_full(s), k_empty(s), v_empty(s)
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);

  // the KV tiles holding a key that some row of this Q tile may see
  const int n_kt = (Skv + kBlockKV - 1) / kBlockKV;
  const int kt_hi = causal ? min(n_kt, (q0 + kBlockQ - 1) / kBlockKV + 1)
                           : n_kt;
  int kt_lo = 0;
  if (window > 0) {
    const int x = q0 - window - (kBlockKV - 1);
    kt_lo = x < 0 ? 0 : x / kBlockKV + 1;
  }
  const int n_tiles = kt_hi > kt_lo ? kt_hi - kt_lo : 0;

  if (threadIdx.x == 0) {
    // a full barrier takes TMA's one arrival (and its bytes), or one from
    // each producer thread
    const int loaders = kPlain ? 128 : 1;
    bar_init(q_full, loaders);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full(s), loaders);
      bar_init(v_full(s), loaders);
      bar_init(k_empty(s), kConsumerWarps);
      bar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // producer warpgroup: gives its registers to the consumers; one lane
    // issues every TMA load, or all 128 threads load a narrower head
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    constexpr int c1 = P::kW0, c2 = P::kW0 + P::kW1;   // panels' columns
    if constexpr (kPlain) {
      const int t = threadIdx.x - kConsumerWarps * 32;
      load_plain<HD, kBlockQ>(sq, q, Sq, H, hd, h, q0, b, t);
      bar_arrive(q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, ph = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kBlockKV;
        bar_wait(k_empty(st), ph ^ 1);
        load_plain<HD, kBlockKV>(sk + st * kTile, k, Skv, KV, hd, kvh, k0,
                                 b, t);
        bar_arrive(k_full(st));
        bar_wait(v_empty(st), ph ^ 1);
        load_plain<HD, kBlockKV>(sv + st * kTile, v, Skv, KV, hd, kvh, k0,
                                 b, t);
        bar_arrive(v_full(st));
      }
    } else if (warp == kConsumerWarps && lane == 0) {   // TMA
      bar_expect_tx(q_full, kQBytes);
      tma_load(sq, &tq0, q_full, 0, h, q0, b);
      if constexpr (P::kW1 > 0)
        tma_load(sq + kBlockQ * kOff1, &tq1, q_full, c1, h, q0, b);
      if constexpr (P::kW2 > 0)
        tma_load(sq + kBlockQ * kOff2, &tq2, q_full, c2, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, ph = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kBlockKV;
        const uint32_t dk = sk + st * kTile, dv = sv + st * kTile;
        bar_wait(k_empty(st), ph ^ 1);
        bar_expect_tx(k_full(st), kTile);
        tma_load(dk, &tk0, k_full(st), 0, kvh, k0, b);
        if constexpr (P::kW1 > 0)
          tma_load(dk + kBlockKV * kOff1, &tk1, k_full(st), c1, kvh, k0, b);
        if constexpr (P::kW2 > 0)
          tma_load(dk + kBlockKV * kOff2, &tk2, k_full(st), c2, kvh, k0, b);
        bar_wait(v_empty(st), ph ^ 1);
        bar_expect_tx(v_full(st), kTile);
        tma_load(dv, &tv0, v_full(st), 0, kvh, k0, b);
        if constexpr (P::kW1 > 0)
          tma_load(dv + kBlockKV * kOff1, &tv1, v_full(st), c1, kvh, k0, b);
        if constexpr (P::kW2 > 0)
          tma_load(dv + kBlockKV * kOff2, &tv2, v_full(st), c2, kvh, k0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, wq = warp % 4;
  const int qw0 = q0 + wg * 64;
  const int row0 = qw0 + wq * 16 + lane / 4;        // and row0 + 8
  const int col_l = 2 * (lane % 4);
  const uint32_t qa0 = sq + wg * 64 * P::kRow0;
  const uint32_t qa1 = sq + kBlockQ * kOff1 + wg * 64 * P::kRow1;
  const uint32_t qa2 = sq + kBlockQ * kOff2 + wg * 64 * P::kRow2;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float s[64];
  uint32_t pa[8][4];
  float o0[P::kW0 / 2];
  float o1[P::kW1 > 0 ? P::kW1 / 2 : 1];
  float o2[P::kW2 > 0 ? P::kW2 / 2 : 1];
#pragma unroll
  for (int i = 0; i < P::kW0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (P::kW1 > 0 ? P::kW1 / 2 : 1); ++i) o1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (P::kW2 > 0 ? P::kW2 / 2 : 1); ++i) o2[i] = 0.f;

  auto fence_o = [&]() {
    fence_regs(o0);
    fence_regs(o1);
    if constexpr (P::kW2 > 0) fence_regs(o2);
  };
  // S = Q K^T of the tile in stage st, fp32 in registers
  auto issue_qk = [&](int st) {
    const uint32_t kb = sk + st * kTile;
#pragma unroll
    for (int kk = 0; kk < P::kW0 / 16; ++kk)
      wgmma_ss_n128(s, desc(qa0 + 32 * kk, P::kSbo0, P::kLayout0),
                    desc(kb + 32 * kk, P::kSbo0, P::kLayout0), kk);
#pragma unroll
    for (int kk = 0; kk < P::kW1 / 16; ++kk)
      wgmma_ss_n128(s, desc(qa1 + 32 * kk, P::kSbo1, P::kLayout1),
                    desc(kb + kBlockKV * kOff1 + 32 * kk, P::kSbo1,
                         P::kLayout1),
                    1);
#pragma unroll
    for (int kk = 0; kk < P::kW2 / 16; ++kk)
      wgmma_ss_n128(s, desc(qa2 + 32 * kk, P::kSbo2, P::kLayout2),
                    desc(kb + kBlockKV * kOff2 + 32 * kk, P::kSbo2,
                         P::kLayout2),
                    1);
    wg_commit();
    fence_regs(s);
  };
  // O += P V with P from registers and V in stage st
  auto issue_pv = [&](int st) {
    const uint32_t vb = sv + st * kTile;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint64_t d0 = desc(vb + t * 16 * P::kRow0, P::kSbo0, P::kLayout0);
      if constexpr (P::kW0 == 64)
        wgmma_rs_n64(o0, pa[t], d0);
      else if constexpr (P::kW0 == 32)
        wgmma_rs_n32(o0, pa[t], d0);
      else
        wgmma_rs_n16(o0, pa[t], d0);
      if constexpr (P::kW1 > 0) {
        const uint64_t d1 = desc(vb + kBlockKV * kOff1 + t * 16 * P::kRow1,
                                 P::kSbo1, P::kLayout1);
        if constexpr (P::kW1 == 64)
          wgmma_rs_n64(o1, pa[t], d1);
        else
          wgmma_rs_n16(o1, pa[t], d1);
      }
      if constexpr (P::kW2 > 0)
        wgmma_rs_n32(o2, pa[t],
                     desc(vb + kBlockKV * kOff2 + t * 16 * P::kRow2,
                          P::kSbo2, P::kLayout2));
    }
    wg_commit();
    fence_o();
  };
  // the online softmax of the tile at key k0: p (fp32) in place of s, the
  // row max m and sum l updated, corr the rescale of the rows' O. Only a
  // tile that crosses Skv, the diagonal or the window's edge for some row
  // of this warpgroup is masked. The scale (in log2 units) goes into the
  // exp's FFMA; the max is taken over the raw scores (scale > 0).
  auto softmax = [&](int k0) {
    const bool edge = k0 + kBlockKV > Skv ||
                      (causal && k0 + kBlockKV - 1 > qw0) ||
                      (window > 0 && k0 <= qw0 + 63 - window);
    float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int qp = row0 + (e >> 1) * 8;
          const int kp = k0 + 8 * j + col_l + (e & 1);
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) s[4 * j + e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e];
        float p = exp2f(fmaf(x, scale_log2, -m[e >> 1]));
        if (edge && x == kNegInf) p = 0.f;   // zeroed after the exp
        s[4 * j + e] = p;
        rs[e >> 1] += p;
      }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
  };
  // rescale O (no product may be in flight on it), then P into bf16
  // registers laid out as wgmma's A operand: k16 step t takes accumulator
  // entries 8t .. 8t+7
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int i = 0; i < P::kW0 / 2; ++i) o0[i] *= corr[(i >> 1) & 1];
    if constexpr (P::kW1 > 0) {
#pragma unroll
      for (int i = 0; i < P::kW1 / 2; ++i) o1[i] *= corr[(i >> 1) & 1];
    }
    if constexpr (P::kW2 > 0) {
#pragma unroll
      for (int i = 0; i < P::kW2 / 2; ++i) o2[i] *= corr[(i >> 1) & 1];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
  };

  // Software pipeline: the softmax of tile i runs while the tensor cores
  // do P V of tile i - 1 (issued just before, behind S of tile i).
  bar_wait(q_full, 0);
  if (n_tiles > 0) {
    bar_wait(k_full(0), 0);
    wg_fence();
    issue_qk(0);
    wg_wait<0>();
    fence_regs(s);
    if (lane == 0) bar_arrive(k_empty(0));
    softmax(kt_lo * kBlockKV);
    rescale_and_pack();
  }
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % kStages, ph = (i / kStages) & 1;
    const int sp = (i - 1) % kStages, pp = ((i - 1) / kStages) & 1;
    bar_wait(k_full(st), ph);
    wg_fence();
    issue_qk(st);
    bar_wait(v_full(sp), pp);
    issue_pv(sp);
    wg_wait<1>();                          // S of tile i is in
    fence_regs(s);
    if (lane == 0) bar_arrive(k_empty(st));
    softmax((kt_lo + i) * kBlockKV);
    wg_wait<0>();                          // P V of tile i - 1 is done
    fence_o();
    if (lane == 0) bar_arrive(v_empty(sp));
    rescale_and_pack();
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % kStages;
    bar_wait(v_full(sp), ((n_tiles - 1) / kStages) & 1);
    wg_fence();
    issue_pv(sp);
    wg_wait<0>();
    fence_o();
    if (lane == 0) bar_arrive(v_empty(sp));
  }

  // epilogue: each row's l is the sum over its quad of lanes
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // only the hd columns are stored: a pair of columns (col_l even, hd a
  // multiple of 4) lies wholly below hd or wholly past it
  const long long ld = static_cast<long long>(H) * ld_hd;
  constexpr int c1 = P::kW0, c2 = P::kW0 + P::kW1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* row = o + (static_cast<long long>(b) * Sq + qp) * ld +
                         static_cast<long long>(h) * ld_hd + col_l;
#pragma unroll
    for (int j = 0; j < P::kW0 / 8; ++j)
      if (!kPlain || 8 * j + col_l < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(o0[4 * j + 2 * r] * inv[r],
                                  o0[4 * j + 2 * r + 1] * inv[r]);
    if constexpr (P::kW1 > 0) {
#pragma unroll
      for (int j = 0; j < P::kW1 / 8; ++j)
        if (!kPlain || c1 + 8 * j + col_l < hd)
          *reinterpret_cast<__nv_bfloat162*>(row + c1 + 8 * j) =
              __floats2bfloat162_rn(o1[4 * j + 2 * r] * inv[r],
                                    o1[4 * j + 2 * r + 1] * inv[r]);
    }
    if constexpr (P::kW2 > 0) {
#pragma unroll
      for (int j = 0; j < P::kW2 / 8; ++j)
        if (!kPlain || c2 + 8 * j + col_l < hd)
          *reinterpret_cast<__nv_bfloat162*>(row + c2 + 8 * j) =
              __floats2bfloat162_rn(o2[4 * j + 2 * r] * inv[r],
                                    o2[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// The map of x (B, S, heads, hd) as the 4-d tensor (hd, heads, S, B) with
// boxes of `cols` columns by `rows` rows of one head, in the swizzle whose
// span is a box row (64 columns: 128 bytes, 32: 64, 16: 32); rows past S
// read as zeros.
bool make_map(EncodeFn enc, CUtensorMap* map, const void* x, int B, int S,
              int heads, int hd, int cols, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2,
      static_cast<cuuint64_t>(heads) * hd * 2,
      static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
             : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kPlain>
int launch_kernel(const CUtensorMap (&m)[9], const void* q, const void* k,
                  const void* v, void* o, int B, int Sq, int Skv, int H,
                  int KV, int hd, int causal, int window, float scale,
                  cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_bf16_kernel<HD, kPlain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  fa_bf16_kernel<HD, kPlain><<<grid, kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8],
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Skv, H, KV, hd, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  using P = Panels<HD>;
  CUtensorMap m[9] = {};   // q, k, v: panels 0, 1 and 2 each
  // a head narrower than the width: the producer's own loads, no maps (no
  // head dim is narrower than 16)
  if constexpr (HD > 16)
    if (hd < HD)
      return launch_kernel<HD, true>(m, q, k, v, o, B, Sq, Skv, H, KV, hd,
                                     causal, window, scale, stream);
  const EncodeFn enc = encode_fn();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // a panel the width lacks gets an unused map as wide as panel 0
  const int w[3] = {P::kW0, P::kW1 > 0 ? P::kW1 : P::kW0,
                    P::kW2 > 0 ? P::kW2 : P::kW0};
  for (int p = 0; p < 3; ++p)
    if (!make_map(enc, &m[p], q, B, Sq, H, HD, w[p], kBlockQ) ||
        !make_map(enc, &m[3 + p], k, B, Skv, KV, HD, w[p], kBlockKV) ||
        !make_map(enc, &m[6 + p], v, B, Skv, KV, HD, w[p], kBlockKV))
      return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel<HD, false>(m, q, k, v, o, B, Sq, Skv, H, KV, hd,
                                  causal, window, scale, stream);
}

}  // namespace

// Launch on ``stream`` (PyTorch's current stream). q, k, v are contiguous
// bf16 with 16-byte aligned bases; hd is a multiple of 4 no wider than
// ``width``, the instantiation that runs it (16, 32, 48, 64, 80, 128 or
// 160; the wrapper picks it, ``ops.supported``). Returns
// cudaGetLastError(), or an error code for a width the kernel is not built
// for, an hd it does not hold or a tensor map cuTensorMapEncodeTiled
// refuses, so the caller can raise.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Sq, int Skv, int H, int KV,
                                           int hd, int width, int causal,
                                           int window, float scale,
                                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 16 || hd % 4 || hd > width)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 16:
      return launch<16>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                        scale, s);
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                        scale, s);
    case 48:
      return launch<48>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                        scale, s);
    case 80:
      return launch<80>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                         scale, s);
    case 160:
      return launch<160>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal, window,
                         scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
