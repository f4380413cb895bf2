// flash_decode.cu — one query token against a long KV cache on Hopper
// (sm_90a), as a split-KV pass plus a combine pass.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py::
// flash_decode_pallas (body _fd_kernel). It computes the function of
// ref.py::flash_decode_plain on the layouts as they lie in memory, read
// with their strides (no transpose): q (B, H, hd), k and v (B, S, KV, hd),
// query head h reading KV head h / (H / KV); the output is (B, H, hd),
// contiguous. The current length t is read on the device (or passed by
// value), so a decode loop never waits on the host:
//   * q, k, v are read as bf16 or fp32 (template T) and upcast to fp32; q
//     is scaled by hd**-0.5 in fp32;
//   * positions at or past min(t, S) are never read; a masked score is
//     -1e30 and its p is 0, so t = 0 gives zeros;
//   * the output is acc / max(l, 1e-30), cast to T.
//
// Design. The TPU grid is (B*KV, kv blocks) with the kv axis sequential.
// At olmo-1b's decode that is B*KV = 128 programs, less than one wave on
// 132 SMs, so the kv axis is split: grid (B*KV, splits), each CTA of 128
// threads streaming its share of [0, t) in 64-key tiles. The G query rows
// of one KV head ride together in the CTA, so K and V are read once per
// group. Per tile: K is staged in shared memory as fp32 (rows padded to
// 130 floats: the two threads of a key read even and odd columns, and the
// 32 lanes hit 32 banks), each key's G scores are two half-dots joined by
// a shuffle, one warp per query row takes the tile's max and rescales the
// fp32 online softmax (m, l), V is staged into the same buffer, and each
// thread folds p V into the (g, d) accumulators it owns in registers. The
// CTA writes its (m, l, acc) partial to scratch that the caller allocates;
// a second launch, one CTA per (b, kv), combines the splits with the
// max-stabilised weights exp(m_s - max m). A split that starts at or past
// t writes the empty partial (m = -1e30, l = 0, acc = 0), which the
// combine weights to nothing, or to 0/1e-30 = 0 when every split is empty.
// 45,760 bytes of static shared memory a CTA.
//
// What bounds it. Decode is bytes: K and V up to t are read once (136.2 MB
// for olmo-1b's B = 8, KV = 16, hd = 128, t = 2,079 in bf16: 0.041 ms at
// 3.35 TB/s) against 2 * 2 * hd FLOPs a key and query head. This kernel
// loads with 16-byte vector reads but stages through shared memory without
// overlapping the next tile's load; cp.async or TMA double-buffering is
// the step that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                    // keys a tile
constexpr int kMaxG = 16;                    // query heads per KV head
constexpr int kMaxHd = 128;
constexpr int kLd = kMaxHd + 2;              // padded row of a staged tile
constexpr int kAcc = kMaxG * kMaxHd / kThreads;
constexpr float kNegInf = -1e30f;
static_assert(kThreads == 2 * kTile, "two threads score each key");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + n) of one head (row stride `ld` elements) into
// dst[n][kLd] as fp32, in 16-byte vector reads (hd a multiple of the
// vector, row starts 16-byte aligned: the caller checks both)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int row0, int n,
                                          int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = hd / kVec;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        src + static_cast<long long>(row0 + r) * ld + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* o = dst + r * kLd + c;
#pragma unroll
    for (int x = 0; x < kVec; ++x) o[x] = to_f32(vals[x]);
  }
}

struct Strides {
  long long q_b, q_h;                        // q (B, H, hd), last dim 1
  long long k_b, k_s, k_h;                   // k (B, S, KV, hd), last dim 1
  long long v_b, v_s, v_h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ t_dev,
                 int t_host, int S, int KV, int G, int hd, int chunk,
                 Strides st, float scale, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part) {
  __shared__ float qs[kMaxG * kMaxHd];
  __shared__ float kv[kTile * kLd];
  __shared__ float ps[kMaxG * kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = t_dev ? *t_dev : t_host;
  t = t < 0 ? 0 : (t > S ? S : t);
  const int start = blockIdx.y * chunk;
  const int end = min(start + chunk, t);

  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    qs[e] = to_f32(q[b * st.q_b + (kvh * G + g) * st.q_h + d]) * scale;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  const T* kb = k + b * st.k_b + kvh * st.k_h;
  const T* vb = v + b * st.v_b + kvh * st.v_h;
  const int key = tid >> 1, half = tid & 1;
  for (int row0 = start; row0 < end; row0 += kTile) {
    const int n = min(kTile, end - row0);
    load_tile(kv, kb, st.k_s, row0, n, hd);
    __syncthreads();
    for (int g = 0; g < G; ++g) {            // scores: two threads a key
      float s = 0.f;
      for (int i = half; i < hd; i += 2) s += qs[g * hd + i] * kv[key * kLd + i];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (!half) ps[g * kTile + key] = key < n ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // online softmax, a warp a row
      const float s0 = ps[g * kTile + lane], s1 = ps[g * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      ps[g * kTile + lane] = p0;
      ps[g * kTile + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    load_tile(kv, vb, st.v_s, row0, n, hd);  // the scores read K already
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {         // acc = acc * corr + p V
      const int e = tid + i * kThreads;
      if (e < G * hd) {
        const int g = e / hd, d = e % hd;
        float a = acc[i] * corr_s[g];
        for (int j = 0; j < n; ++j) a += ps[g * kTile + j] * kv[j * kLd + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const long long part = (static_cast<long long>(bkv) * gridDim.y + blockIdx.y) * G;
  if (tid < G) {
    m_part[part + tid] = m_s[tid];
    l_part[part + tid] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * hd) acc_part[part * hd + e] = acc[i];
  }
}

// one CTA per (b, kv): out[b, kv*G + g, d] from the splits' partials
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ m_part,
                   const float* __restrict__ l_part,
                   const float* __restrict__ acc_part, int splits, int G,
                   int hd, T* __restrict__ out) {
  const int bkv = blockIdx.x;
  for (int e = threadIdx.x; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    const long long base = static_cast<long long>(bkv) * splits * G + g;
    float m = kNegInf;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, m_part[base + s * G]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(m_part[base + s * G] - m);
      l += l_part[base + s * G] * w;
      a += acc_part[(base + s * G) * hd + d] * w;
    }
    // out is contiguous (B, H, hd) with H = KV * G: row bkv * G + g
    out[(static_cast<long long>(bkv) * G + g) * hd + d] =
        from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* t_dev,
           int t_host, void* out, float* m_part, float* l_part,
           float* acc_part, int B, int S, int KV, int G, int hd, int splits,
           int chunk, const Strides& st, float scale, cudaStream_t s) {
  split_kernel<T><<<dim3(B * KV, splits), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), t_dev, t_host, S, KV, G, hd, chunk, st, scale,
      m_part, l_part, acc_part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T><<<B * KV, kThreads, 0, s>>>(m_part, l_part, acc_part,
                                                splits, G, hd,
                                                static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both passes on ``stream`` (PyTorch's current stream). ``t_dev``
// points at a device int32 holding t, or is null and t_host is t. Strides
// are in elements (the last dim of q, k and v has stride 1). m_part,
// l_part (B*KV, splits, G) and acc_part (B*KV, splits, G, hd) are fp32
// scratch; out is (B, H, hd) contiguous. dtype is 0 for fp32, 1 for bf16;
// hd is 32, 64, 80 or 128 and G at most 16. Returns cudaGetLastError()
// after each launch (0 on success), or cudaErrorInvalidValue for a shape
// or type the kernel does not take, so the caller can raise.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* t_dev,
    int t_host, void* out, void* m_part, void* l_part, void* acc_part,
    int B, int S, int KV, int G, int hd, int splits, int chunk,
    long long q_b, long long q_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h, float scale,
    int dtype, void* stream) {
  if (G < 1 || G > kMaxG || splits < 1 || chunk < 1 || B * KV < 1 ||
      splits > 65535 || !(hd == 32 || hd == 64 || hd == 80 || hd == 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* td = static_cast<const int*>(t_dev);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (dtype == 0)
    return launch<float>(q, k, v, td, t_host, out, mp, lp, ap, B, S, KV, G,
                         hd, splits, chunk, st, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, td, t_host, out, mp, lp, ap, B, S,
                                 KV, G, hd, splits, chunk, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
