// launch_floor.cu — an empty kernel, the least one call of a kernel
// wrapper can take on the card.
//
// tools/slots_turns.py builds it with the port's backend (nvcc for
// sm_90a into a shared library, loaded with ctypes) and launches it the
// way a wrapper launches its kernel, at one CTA and at a kernel's grid:
// its CUDA-event time back to back is the host's floor a call, its
// device time the device's.

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

// Launch ``blocks`` CTAs of ``threads`` threads on ``stream``; returns
// cudaGetLastError() (0 on success).
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
