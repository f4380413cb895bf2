// mutants.cu — fleetlint's three mutant kernels on Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/analysis/corpus.py, the kernels
// of the linter's own self-test:
//   * copy_rows      <- _pal001.fn: an (8, 128) f32 array copied by
//                       (1, 128) blocks over a grid of 8;
//   * table_add      <- _pal001_fused.fn: a (512,) int32 table in 64-int
//                       tiles over a grid of 8, each output tile the
//                       table tile its map names plus recs[0] of the
//                       (16,) record block its map names (the Pallas body
//                       reads r_ref[0], not the whole block);
//   * copy_rows_i32  <- _pal002.fn: copy_rows in int32.
// They compute the functions of ../ref.py on the same maps.
//
// The block map is data. Each operand's block index on each array dim is
// scale * g + shift at grid point g, passed by the wrapper from the same
// launch spec (rules.LaunchSpec) that PAL001 checks, so the map that was
// checked is the map that runs. The kernels neither clamp nor bound a
// block index: a map that leaves its array reads or writes outside it.
// That is the fault PAL001 rules out before any launch, and the one the
// memcheck of chip_smoke.py must find when a bad twin runs in its child.
//
// Design. One CTA per grid point, one thread per element of a block
// (128 or 64), so a CTA's loads are one coalesced row. Sums are int32
// with wraparound (added as uint32), as JAX and torch add int32.
//
// What bounds it. 8 KB (a copy: 4 KB read, 4 KB written) and 4,100 B
// (table_add: the table, recs[0], the output) of device memory, a few
// nanoseconds at 3.35 TB/s. The launch, a few microseconds, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Map2 {           // block index (s0 * g + t0, s1 * g + t1)
  int s0, t0, s1, t1;
};

struct Map1 {           // block index s * g + t
  int s, t;
};

// out block (o) <- x block (in); both arrays row-major with row lengths
// ld_in and ld_out, blocks (b0, b1)
template <typename T>
__global__ void copy_blocks(const T* __restrict__ x, T* __restrict__ out,
                            int b0, int b1, int ld_in, int ld_out, Map2 in,
                            Map2 o) {
  const int g = blockIdx.x;
  const long long r_in = static_cast<long long>(in.s0 * g + in.t0) * b0;
  const long long c_in = static_cast<long long>(in.s1 * g + in.t1) * b1;
  const long long r_out = static_cast<long long>(o.s0 * g + o.t0) * b0;
  const long long c_out = static_cast<long long>(o.s1 * g + o.t1) * b1;
  for (int e = threadIdx.x; e < b0 * b1; e += blockDim.x) {
    const int r = e / b1, c = e % b1;
    out[(r_out + r) * ld_out + c_out + c] = x[(r_in + r) * ld_in + c_in + c];
  }
}

// out tile (o) <- table tile (tm) + recs[first entry of record block (rm)]
__global__ void table_add_kernel(const int* __restrict__ table,
                                 const int* __restrict__ recs,
                                 int* __restrict__ out, int tile, int rblock,
                                 Map1 tm, Map1 rm, Map1 om) {
  const int j = blockIdx.x;
  const unsigned r0 = static_cast<unsigned>(
      recs[static_cast<long long>(rm.s * j + rm.t) * rblock]);
  const long long src = static_cast<long long>(tm.s * j + tm.t) * tile;
  const long long dst = static_cast<long long>(om.s * j + om.t) * tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    out[dst + e] = static_cast<int>(static_cast<unsigned>(table[src + e]) + r0);
}

int threads_for(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 1024 ? t : 1024;
}

template <typename T>
int launch_copy(const void* x, void* out, int grid, int b0, int b1,
                int ld_in, int ld_out, int is0, int it0, int is1, int it1,
                int os0, int ot0, int os1, int ot1, void* stream) {
  copy_blocks<T><<<grid, threads_for(b0 * b1), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), b0, b1, ld_in, ld_out,
      Map2{is0, it0, is1, it1}, Map2{os0, ot0, os1, ot1});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int copy_rows_launch(const void* x, void* out, int grid, int b0,
                                int b1, int ld_in, int ld_out, int is0,
                                int it0, int is1, int it1, int os0, int ot0,
                                int os1, int ot1, void* stream) {
  return launch_copy<float>(x, out, grid, b0, b1, ld_in, ld_out, is0, it0,
                            is1, it1, os0, ot0, os1, ot1, stream);
}

extern "C" int copy_rows_i32_launch(const void* x, void* out, int grid,
                                    int b0, int b1, int ld_in, int ld_out,
                                    int is0, int it0, int is1, int it1,
                                    int os0, int ot0, int os1, int ot1,
                                    void* stream) {
  return launch_copy<int>(x, out, grid, b0, b1, ld_in, ld_out, is0, it0,
                          is1, it1, os0, ot0, os1, ot1, stream);
}

extern "C" int table_add_launch(const void* table, const void* recs,
                                void* out, int grid, int tile, int rblock,
                                int ts, int tt, int rs, int rt, int os,
                                int ot, void* stream) {
  table_add_kernel<<<grid, threads_for(tile), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(recs),
      static_cast<int*>(out), tile, rblock, Map1{ts, tt}, Map1{rs, rt},
      Map1{os, ot});
  return static_cast<int>(cudaGetLastError());
}
