// K2 standalone launchers: Threefry-2x32 blocks for given counters. The
// fused path loop calls the __device__ functions of ktf.cuh inline; the
// differentiable path (models/megakernel.py) draws every random number
// through these launchers: `rt_ktf_threefry` under one key (the ktf
// family), `rt_ktf_threefry_keyed` under a key per element (the
// jax.random family of utils/rng.py, whose lane keys are themselves
// Threefry outputs). One thread per counter pair; bound by memory
// traffic (16 or 24 bytes per thread).
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

__global__ void ktf_threefry_keyed_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                                          const int* __restrict__ c0, const int* __restrict__ c1,
                                          int n, int* __restrict__ x0, int* __restrict__ x1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a, b;
  ktf::threefry2x32(static_cast<uint32_t>(k0[i]), static_cast<uint32_t>(k1[i]),
                    static_cast<uint32_t>(c0[i]), static_cast<uint32_t>(c1[i]), a, b);
  x0[i] = static_cast<int>(a);
  x1[i] = static_cast<int>(b);
}

extern "C" int rt_ktf_threefry_keyed(const int* k0, const int* k1, const int* c0, const int* c1,
                                     int n, int* x0, int* x1, int block, void* stream) {
  if (n > 0) {
    const int grid = (n + block - 1) / block;
    ktf_threefry_keyed_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        k0, k1, c0, c1, n, x0, x1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
