// ssd_scan.cu — the Mamba-2 chunked SSD scan on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_pallas
// (body _ssd_kernel). It computes the function of ref.py::ssd_plain on the
// layouts as they lie in memory: x, y (B, S, H, P); dt (B, S, H); A (H,)
// fp32; B, C (B, S, G, N), head h reading group h / (H / G); the final
// state (B, H, P, N) fp32. Every operand is upcast to fp32. Per chunk of
// `chunk` rows, with the state carried from chunk to chunk:
//   cum   = inclusive cumsum of dt * A over the chunk's rows;
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) (x_j dt_j)
//           + exp(cum_i) (C_i . state^T)     [the state BEFORE this chunk];
//   state = state exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) B_j^T.
// The decay of a pair is selected, never multiplied by a 0/1 mask: above
// the diagonal exp(cum_i - cum_j) can overflow to inf, and inf * 0 is NaN.
// Rows at or past S (the ragged tail of the last chunk) are read as
// dt = 0, x = 0, B = C = 0, which is identity decay and no update, and
// are never written: the TPU kernel's zero padding without the copy. A
// chunk is any multiple of 16 rows up to 256 (16 for the SMOKE configs);
// dt and cum are kept over the chunk rounded up to whole 64-row tiles, dt
// 0 and cum flat past the chunk, so a short chunk's last tile reads them
// as it reads a ragged tail's. P is 16 (fp32 only), 32 or 64 and N 16, 32
// or 128.
//
// Design. One CTA of 256 threads per (b, h); the TPU grid's sequential
// chunk axis is the CTA's loop over chunks. The (P, N) state lives in
// shared memory for the whole sequence. Within a chunk, the first warp
// scans dt * A into `cum`; then for each 64-row tile i the C tile is
// staged, and for each 64-row tile j <= i the B tile and x*dt tile are
// staged, the 64 x 64 scores C_i B_j^T formed with fp32 FMAs, decayed and
// causally selected, and stored transposed so the product with x*dt reads
// float4 rows. Thread (ty, tx) owns y rows ty*4..+3 and columns
// tx*P/16..+P/16-1 in registers. The carried-in term is added from the
// shared state before the tile is written. Only after every tile of the
// chunk has read the old state does a second pass over the chunk's tiles
// fold the update in, each thread owning a (P/16) x (N/16) block of it.
// Rows of the staged tiles are padded by 4 floats so float4 reads spread
// over the banks. At P = 64, N = 128, chunk = 256 a CTA takes 138,240
// bytes of dynamic shared memory: one CTA per SM.
//
// What bounds it. At the served shape (B = 8, S = 2048, H = 48, P = 64,
// N = 128, G = 1, chunk 256, bf16) the card's bound is the bytes: 223.9 MB
// of x, y, dt, B, C and the state at 3.35 TB/s (0.067 ms), against 63 GFLOP
// of visible pairs and state products that the tensor cores would do in
// 0.064 ms. This kernel runs the products as fp32 FMAs on the CUDA cores
// (67 TFLOP/s at best), re-stages B and x*dt once per tile pair, and has
// 8 warps per SM to hide latency; wgmma on bf16 tiles fed by TMA, and a
// chunk-parallel split of the state pass, are the redesign that closes
// that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;           // rows of a staged tile
constexpr int kThreads = 256;
constexpr int kLdS = kTile + 4;     // padded row of the transposed scores
constexpr int kMaxChunk = 256;

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

__device__ __forceinline__ float load_dt(const void* dt, long long i,
                                         int dt_bf16) {
  return dt_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(dt)[i])
                 : static_cast<const float*>(dt)[i];
}

// rows of dt and cum kept for a chunk: whole 64-row tiles
__host__ __device__ inline int padded_chunk(int chunk) {
  return (chunk + kTile - 1) / kTile * kTile;
}

template <int P, int N>
size_t smem_bytes(int chunk) {
  return static_cast<size_t>((P + 2 * kTile) * (N + 4) + kTile * (P + 4) +
                             kTile * kLdS + 2 * padded_chunk(chunk)) *
         sizeof(float);
}

// rows [row0, row0 + 64) of one group of B or C (row stride `ld`) into
// dst[64][W + 4] as fp32; rows at or past `n` are zero
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ld, int row0, int n) {
  for (int i = threadIdx.x; i < kTile * W; i += kThreads) {
    const int r = i / W, c = i % W;
    dst[r * (W + 4) + c] =
        row0 + r < n ? to_f32(src[static_cast<long long>(row0 + r) * ld + c])
                     : 0.f;
  }
}

// rows [row0, row0 + 64) of one head of x times dt (fp32) into
// dst[64][P + 4], times exp(last - cum) when `to_end`; `row0` and `n`
// count from the chunk's first row, as `dts` and `cum` do
template <typename T, int P>
__device__ __forceinline__ void load_xdt(float* dst, const T* src,
                                         long long ld, int row0, int n,
                                         const float* dts, const float* cum,
                                         bool to_end, float last) {
  for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
    const int r = i / P, c = i % P;
    const int s = row0 + r;
    float v = 0.f;
    if (s < n) {
      v = to_f32(src[static_cast<long long>(s) * ld + c]) * dts[s];
      if (to_end) v *= expf(last - cum[s]);
    }
    dst[r * (P + 4) + c] = v;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const void* __restrict__ dt,
                int dt_bf16, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                T* __restrict__ y, float* __restrict__ st_out, int S, int H,
                int G, int chunk) {
  constexpr int kLdN = N + 4, kLdP = P + 4;
  constexpr int PT = P / 16;  // y columns per thread, state rows per thread
  constexpr int NT = N / 16;  // state columns per thread
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N are multiples of 16");
  extern __shared__ float4 smem4[];
  float* state = reinterpret_cast<float*>(smem4);  // [P][kLdN]
  float* cs = state + P * kLdN;                    // [64][kLdN] C tile i
  float* bs = cs + kTile * kLdN;                   // [64][kLdN] B tile j
  float* xs = bs + kTile * kLdN;                   // [64][kLdP] x*dt tile j
  float* sc = xs + kTile * kLdP;                   // [64 j][kLdS] scores^T
  const int rows = padded_chunk(chunk);            // rows of dts and cum
  float* dts = sc + kTile * kLdS;                  // [rows] dt
  float* cum = dts + rows;                         // [rows] cumsum(dt * A)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a_h = A[h];
  const long long x_ld = static_cast<long long>(H) * P;
  const long long bc_ld = static_cast<long long>(G) * N;
  const long long x_base = static_cast<long long>(b) * S * x_ld +
                           static_cast<long long>(h) * P;
  const long long bc_base = static_cast<long long>(b) * S * bc_ld +
                            static_cast<long long>(g) * N;
  const long long dt_base = static_cast<long long>(b) * S * H + h;

  for (int i = tid; i < P * kLdN; i += kThreads) state[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = min(chunk, S - c0);  // rows of this chunk below S
    const int n_tiles = (len + kTile - 1) / kTile;
    const T* xc = x + x_base + static_cast<long long>(c0) * x_ld;
    T* yc = y + x_base + static_cast<long long>(c0) * x_ld;
    const T* bc = Bm + bc_base + static_cast<long long>(c0) * bc_ld;
    const T* cc = Cm + bc_base + static_cast<long long>(c0) * bc_ld;

    __syncthreads();  // the last chunk's update pass is done with cum
    for (int r = tid; r < rows; r += kThreads)
      dts[r] = r < len ? load_dt(dt, dt_base + static_cast<long long>(c0 + r)
                                              * H, dt_bf16)
                       : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive scan of dt * A: 32 lanes of rows/32 rows
      const int per = rows / 32, r0 = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        run += dts[r0 + k] * a_h;
        cum[r0 + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int k = 0; k < per; ++k) cum[r0 + k] += excl;
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // cum is in; the last tile is done with cs, xs, sc
      load_rows<T, N>(cs, cc, bc_ld, i0, len);
      float acc[4][PT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < PT; ++k) acc[a][k] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // the last j tile's product is done with xs, sc
        load_rows<T, N>(bs, bc, bc_ld, j0, len);
        load_xdt<T, P>(xs, xc, x_ld, j0, len, dts, cum, false, 0.f);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 ca[4], bb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            ca[a] = *reinterpret_cast<const float4*>(cs + (ty * 4 + a) * kLdN + n);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bb[c] = *reinterpret_cast<const float4*>(bs + (tx + 16 * c) * kLdN + n);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float t = s[a][c];
              t = fmaf(ca[a].x, bb[c].x, t);
              t = fmaf(ca[a].y, bb[c].y, t);
              t = fmaf(ca[a].z, bb[c].z, t);
              t = fmaf(ca[a].w, bb[c].w, t);
              s[a][c] = t;
            }
        }
        // decay and causal select, stored transposed: sc[j][i]
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int gj = j0 + tx + 16 * c;
          float v[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int gi = i0 + ty * 4 + a;
            v[a] = gi >= gj ? s[a][c] * expf(cum[gi] - cum[gj]) : 0.f;
          }
          *reinterpret_cast<float4*>(sc + (tx + 16 * c) * kLdS + ty * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          const float4 pa = *reinterpret_cast<const float4*>(sc + j * kLdS + ty * 4);
          const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
          const float* xr = xs + j * kLdP + tx * PT;
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const float xv = xr[k];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][k] = fmaf(pr[a], xv, acc[a][k]);
          }
        }
      }

      // carried-in term from the state before this chunk's update
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
        float t[PT];
#pragma unroll
        for (int k = 0; k < PT; ++k) t[k] = 0.f;
        for (int n = 0; n < N; n += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + r * kLdN + n);
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const float4 sv = *reinterpret_cast<const float4*>(
                state + (tx * PT + k) * kLdN + n);
            t[k] = fmaf(cv.x, sv.x, t[k]);
            t[k] = fmaf(cv.y, sv.y, t[k]);
            t[k] = fmaf(cv.z, sv.z, t[k]);
            t[k] = fmaf(cv.w, sv.w, t[k]);
          }
        }
        const int gi = i0 + r;
        if (gi < len) {
          const float e = expf(cum[gi]);
          T* row = yc + static_cast<long long>(gi) * x_ld + tx * PT;
#pragma unroll
          for (int k = 0; k < PT; ++k) row[k] = from_f32<T>(acc[a][k] + t[k] * e);
        }
      }
    }

    // the state update, after every tile of the chunk has read the state
    const float last = cum[len - 1];
    float u[PT][NT];
#pragma unroll
    for (int m = 0; m < PT; ++m)
#pragma unroll
      for (int k = 0; k < NT; ++k) u[m][k] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // the carried-in reads and the last pass are done
      load_rows<T, N>(bs, bc, bc_ld, j0, len);
      load_xdt<T, P>(xs, xc, x_ld, j0, len, dts, cum, true, last);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float xv[PT], bv[NT];
#pragma unroll
        for (int m = 0; m < PT; ++m) xv[m] = xs[r * kLdP + ty * PT + m];
#pragma unroll
        for (int k = 0; k < NT; ++k) bv[k] = bs[r * kLdN + tx * NT + k];
#pragma unroll
        for (int m = 0; m < PT; ++m)
#pragma unroll
          for (int k = 0; k < NT; ++k) u[m][k] = fmaf(xv[m], bv[k], u[m][k]);
      }
    }
    const float decay = expf(last);
#pragma unroll
    for (int m = 0; m < PT; ++m)
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        float* e = state + (ty * PT + m) * kLdN + tx * NT + k;
        *e = *e * decay + u[m][k];
      }
  }

  __syncthreads();
  float* out = st_out + static_cast<long long>(blockIdx.x) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    out[i] = state[(i / N) * kLdN + i % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, int dt_bf16, const void* A,
           const void* Bm, const void* Cm, void* y, void* st, int B, int S,
           int H, int G, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes<P, N>(chunk);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_kernel<T, P, N><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, dt_bf16, static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), static_cast<float*>(st), S, H, G, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const void* x, const void* dt, int dt_bf16, const void* A,
             const void* Bm, const void* Cm, void* y, void* st, int B, int S,
             int H, int G, int N, int chunk, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(x, dt, dt_bf16, A, Bm, Cm, y, st, B, S, H, G,
                              chunk, s);
    case 32:
      return launch<T, P, 32>(x, dt, dt_bf16, A, Bm, Cm, y, st, B, S, H, G,
                              chunk, s);
    case 128:
      return launch<T, P, 128>(x, dt, dt_bf16, A, Bm, Cm, y, st, B, S, H, G,
                               chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_p(const void* x, const void* dt, int dt_bf16, const void* A,
             const void* Bm, const void* Cm, void* y, void* st, int B, int S,
             int H, int G, int P, int N, int chunk, cudaStream_t s) {
  // P 16 only in fp32: bf16 goes to ssd_scan_bf16.cu, and each
  // instantiation adds to the build
  if constexpr (std::is_same_v<T, float>)
    if (P == 16)
      return launch_n<T, 16>(x, dt, dt_bf16, A, Bm, Cm, y, st, B, S, H, G, N,
                             chunk, s);
  if (P == 32)
    return launch_n<T, 32>(x, dt, dt_bf16, A, Bm, Cm, y, st, B, S, H, G, N,
                           chunk, s);
  if (P == 64)
    return launch_n<T, 64>(x, dt, dt_bf16, A, Bm, Cm, y, st, B, S, H, G, N,
                           chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on ``stream`` (PyTorch's current stream). dtype and dt_dtype are
// 0 for fp32 and 1 for bf16 (x, B, C and y share dtype); P is 32 or 64
// (16 too in fp32), N 16, 32 or 128, chunk a multiple of 16 up to 256.
// Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or type the
// kernel is not built for, so the caller can raise.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int B, int S, int H, int G, int P,
                               int N, int chunk, int dtype, int dt_dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || G < 1 || H % G || chunk < 16 || chunk > kMaxChunk ||
      chunk % 16 || (dt_dtype != 0 && dt_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_p<float>(x, dt, dt_dtype, A, Bm, Cm, y, state, B, S, H, G,
                           P, N, chunk, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, dt_dtype, A, Bm, Cm, y, state, B,
                                   S, H, G, P, N, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
