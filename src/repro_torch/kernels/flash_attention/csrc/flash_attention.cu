// flash_attention.cu — online-softmax attention for fp32 inputs on the
// CUDA cores (sm_90a), with causal and sliding-window masks, GQA and a
// ragged tail. bf16 inputs go to flash_attention_bf16.cu (tensor cores).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _fa_kernel) for fp32 inputs. It computes
// the function of ref.py::flash_attention_plain, on the (B, S, H, hd)
// layout as it lies in memory (no transposes), for any hd that is a
// multiple of 4 from 16 to 160:
//   * q is scaled by hd**-0.5 in fp32;
//   * the online softmax starts at m = -1e30, l = 0; a key is visible when
//     k_pos < Skv, k_pos <= q_pos (causal) and k_pos > q_pos - window
//     (window > 0); a hidden score is -1e30 before the row max and its
//     p = exp(s - m_new) is zeroed AFTER the exp, so a row with nothing
//     visible so far never takes p = 1;
//   * the output is acc / max(l, 1e-30);
//   * query head h reads KV head h / (H / KV);
//   * a KV tile that the causal or window mask hides from every row of the
//     Q tile is never loaded.
//
// Design. One CTA of 256 threads per (b*H + h, 64-row Q tile); the TPU
// grid's sequential kv axis is the CTA's loop over 64-key tiles. The Q
// tile sits in shared memory (scaled); K and then V of each KV tile are
// staged through one shared buffer, and P goes back through shared memory
// transposed. Thread (ty, tx) owns score rows ty*4..+3 and columns
// tx + 16j, and output rows ty*4..+3 and columns g*64 + tx*4..+3 (plus
// the tail columns 64 * (W / 64) + 16t + tx: t 0 at W 16 and 80, t 0 and
// 1 at W 32 and 160, t 0-2 at W 48): each row's 16 owners are one
// half-warp,
// so row max and row sum are shuffles, and every operand read is a float4
// from a bank-conflict-free row (rows padded by 4 floats). W is the
// instantiation's width, the smallest of 16, 32, 48, 64, 80, 128 and 160
// that holds hd. A head of exactly W columns runs flash_attention_kernel
// <W, false>, whose strides and loads are compile-time and whose stores
// are unguarded; a narrower one runs <W, true>: the tiles are staged W
// columns wide with the columns past hd zero, so they add nothing to the
// scores and make output columns that are not stored.
//
// What bounds it. fp32 has no tensor-core rate that holds the reference's
// fp32 tolerance (TF32 keeps ~3 digits), so the products are fp32 FMAs at
// the CUDA cores' 67 TFLOP/s. fp32 is not on the served path; this kernel
// keeps the fp32 function exact to that tolerance, not fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kBlockQ + 4;   // padded row of the transposed P tile
constexpr float kNegInf = -1e30f;
static_assert(kBlockQ == kBlockKV, "load_tile stages 64-row tiles of both");

template <int HD>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(2 * kBlockQ * (HD + 4) + kBlockKV * kLdP) *
         sizeof(float);
}

// rows [row0, row0 + 64) of one head of x (row stride `ld` elements, hd
// columns) into dst[64][HD + 4] times `mul`; rows at or past `n` and, with
// kPad, columns at or past hd are zero
template <int HD, bool kPad>
__device__ __forceinline__ void load_tile(float* dst, const float* x,
                                          long long ld, int row0, int n,
                                          int hd, float mul) {
  for (int i = threadIdx.x; i < kBlockKV * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = row0 + r;
    dst[r * (HD + 4) + d] =
        s < n && (!kPad || d < hd)
            ? x[static_cast<long long>(s) * ld + d] * mul : 0.f;
  }
}

template <int HD, bool kPad>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Skv, int H, int KV, int hd, int causal,
                       int window, float scale) {
  constexpr int kLd = HD + 4;      // padded row of the Q and K/V tiles
  constexpr int kGroups = HD / 64; // float4 output column groups per thread
  constexpr int kTail = HD % 64 / 16;  // tail columns per thread
  constexpr int kCols = 4 * kGroups + kTail;   // output columns per thread
  static_assert(HD == 16 || HD == 32 || HD == 48 || HD == 64 || HD == 80 ||
                    HD == 128 || HD == 160,
                "the width is 16, 32, 48, 64, 80, 128 or 160");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][kLd], scaled Q
  float* kv = qs + kBlockQ * kLd;               // [64][kLd], K then V
  float* ps = kv + kBlockKV * kLd;              // [64 keys][kLdP], P^T

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int D = kPad ? hd : HD;    // the head's columns in memory
  const long long q_ld = static_cast<long long>(H) * D;
  const long long kv_ld = static_cast<long long>(KV) * D;
  const long long q_base = static_cast<long long>(b) * Sq * q_ld + h * D;
  const long long kv_base = static_cast<long long>(b) * Skv * kv_ld + kvh * D;

  load_tile<HD, kPad>(qs, q + q_base, q_ld, q0, Sq, hd, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // the KV tiles holding a key that some row of this Q tile may see
  const int n_kt = (Skv + kBlockKV - 1) / kBlockKV;
  const int kt_hi = causal ? min(n_kt, (q0 + kBlockQ - 1) / kBlockKV + 1)
                           : n_kt;
  int kt_lo = 0;
  if (window > 0) {
    const int x = q0 - window - (kBlockKV - 1);
    kt_lo = x < 0 ? 0 : x / kBlockKV + 1;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockKV;
    __syncthreads();  // Q is in; the last tile's PV is done with kv and ps
    load_tile<HD, kPad>(kv, k + kv_base, kv_ld, k0, Skv, hd, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(kv + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online softmax of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool vis[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        vis[j] = ok;
        if (!ok) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = vis[j] ? p : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * kLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every thread is done reading K; P is in
    load_tile<HD, kPad>(kv, v + kv_base, kv_ld, k0, Skv, hd, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockKV; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + c * kLdP + ty * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 vb =
            *reinterpret_cast<const float4*>(kv + c * kLd + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pr[i], vb.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pr[i], vb.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pr[i], vb.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pr[i], vb.w, acc[i][g * 4 + 3]);
        }
      }
#pragma unroll
      for (int t = 0; t < kTail; ++t) {
        const float vt = kv[c * kLd + 64 * kGroups + 16 * t + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][4 * kGroups + t] =
              fmaf(pr[i], vt, acc[i][4 * kGroups + t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* row = o + q_base + static_cast<long long>(s) * q_ld;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!kPad || g * 64 + tx * 4 + e < hd)
          row[g * 64 + tx * 4 + e] = acc[i][g * 4 + e] / den;
#pragma unroll
    for (int t = 0; t < kTail; ++t)
      if (!kPad || 64 * kGroups + 16 * t + tx < hd)
        row[64 * kGroups + 16 * t + tx] = acc[i][4 * kGroups + t] / den;
  }
}

template <int HD, bool kPad>
int launch_kernel(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int H, int KV, int hd, int causal,
                  int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_attention_kernel<HD, kPad><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  // no head dim is narrower than 16
  if constexpr (HD > 16)
    if (hd < HD)
      return launch_kernel<HD, true>(q, k, v, o, B, Sq, Skv, H, KV, hd,
                                     causal, window, scale, stream);
  return launch_kernel<HD, false>(q, k, v, o, B, Sq, Skv, H, KV, hd, causal,
                                  window, scale, stream);
}

}  // namespace

// Launch on ``stream`` (PyTorch's current stream). q, k, v are contiguous
// fp32; hd is a multiple of 4 no wider than ``width``, the instantiation
// that runs it (16, 32, 48, 64, 80, 128 or 160; the wrapper picks it,
// ``ops.supported``). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a width the kernel is not built for or an hd it does not hold, so
// the caller can raise.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
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
