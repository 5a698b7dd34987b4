// K2 standalone launcher: Threefry-2x32 blocks for given counters, so the
// device version of utils/ktf.threefry2x32 can be checked bit for bit
// against the PyTorch version (chip_smoke.py). The path loop itself calls
// the __device__ functions of ktf.cuh inline. One thread per counter pair;
// bound by memory traffic (16 bytes per thread).
#include <cuda_runtime.h>

#include "ktf.cuh"

__global__ void ktf_threefry_kernel(uint32_t k0, uint32_t k1, const int* __restrict__ c0,
                                    const int* __restrict__ c1, int n, int* __restrict__ x0,
                                    int* __restrict__ x1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a, b;
  ktf::threefry2x32(k0, k1, static_cast<uint32_t>(c0[i]), static_cast<uint32_t>(c1[i]), a, b);
  x0[i] = static_cast<int>(a);
  x1[i] = static_cast<int>(b);
}

extern "C" int rt_ktf_threefry(uint32_t k0, uint32_t k1, const int* c0, const int* c1, int n,
                               int* x0, int* x1, int block, void* stream) {
  if (n > 0) {
    const int grid = (n + block - 1) / block;
    ktf_threefry_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(k0, k1, c0, c1, n,
                                                                               x0, x1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
