// P-ktf: the int32 operations, Threefry, u01 and the unit-vector map that
// the path loop draws its random numbers with, one small kernel per case on
// an [8, 128] tile.
//
// Replaces scripts/ktf_kernel_probe.py run_case (:21; TPU calls :34, :141),
// whose kernels check that Mosaic compiles utils/ktf.py's operations into
// the bits the host computes. The wrapper, the plain PyTorch version and
// the entry point are raytracer_tpu_torch/probes/ktf_probe.py. Every case
// takes its functions from ktf.cuh, the code K3 inlines, so the probe holds
// the path loop's own draws against utils/ktf.py:
//
//   intops        a + b, a ^ b, rotl(a, 13), a >>> 9 (logical: on uint32)
//   threefry      threefry2x32 under the script's key words
//   u01           u01 of the bits
//   unitvec       unit_vector of two u01 draws (sqrtf, cosf, sinf)
//   sampler_tile  Sampler{key, pixel, sample 5, bounce 2}: uniform(RR) and
//                 unit_vector(SCATTER), the K3 lane's draw pattern
//
// One block of 1,024 threads, one element each (the tile). What bounds it:
// the launch; the work is a few hundred integer and float operations per
// element.
#include <cuda_runtime.h>

#include <cstdint>

#include "ktf.cuh"

namespace probe_ktf {

enum Case { INTOPS, THREEFRY, U01, UNITVEC, SAMPLER_TILE, N_CASES };
constexpr int TILE = 8 * 128;
constexpr uint32_t SAMPLE = 5, BOUNCE = 2;

// a, b: the case's int32 inputs (unitvec: the two bit planes; sampler_tile:
// the pixel ids in a); o0..o3 its outputs, int32 for intops and threefry,
// float32 otherwise.
template <int C>
__global__ void __launch_bounds__(TILE)
    probe_ktf_kernel(const int* __restrict__ a, const int* __restrict__ b, uint32_t k0,
                     uint32_t k1, void* o0, void* o1, void* o2, void* o3) {
  const int i = threadIdx.x;
  const uint32_t x = static_cast<uint32_t>(a[i]);
  if constexpr (C == INTOPS) {
    const uint32_t y = static_cast<uint32_t>(b[i]);
    static_cast<int*>(o0)[i] = static_cast<int>(x + y);
    static_cast<int*>(o1)[i] = static_cast<int>(x ^ y);
    static_cast<int*>(o2)[i] = static_cast<int>(ktf::rotl(x, 13));
    static_cast<int*>(o3)[i] = static_cast<int>(x >> 9);
  } else if constexpr (C == THREEFRY) {
    uint32_t x0, x1;
    ktf::threefry2x32(k0, k1, x, static_cast<uint32_t>(b[i]), x0, x1);
    static_cast<int*>(o0)[i] = static_cast<int>(x0);
    static_cast<int*>(o1)[i] = static_cast<int>(x1);
  } else if constexpr (C == U01) {
    static_cast<float*>(o0)[i] = ktf::u01(x);
  } else if constexpr (C == UNITVEC) {
    float vx, vy, vz;
    ktf::unit_vector(ktf::u01(x), ktf::u01(static_cast<uint32_t>(b[i])), vx, vy, vz);
    static_cast<float*>(o0)[i] = vx;
    static_cast<float*>(o1)[i] = vy;
    static_cast<float*>(o2)[i] = vz;
  } else {
    const ktf::Sampler smp{k0, k1, x, SAMPLE, BOUNCE};
    float vx, vy, vz;
    smp.unit_vector(ktf::SCATTER, vx, vy, vz);
    static_cast<float*>(o0)[i] = smp.uniform(ktf::RR);
    static_cast<float*>(o1)[i] = vx;
    static_cast<float*>(o2)[i] = vy;
    static_cast<float*>(o3)[i] = vz;
  }
}

using KernelFn = void (*)(const int*, const int*, uint32_t, uint32_t, void*, void*, void*, void*);

KernelFn kernel_of(int c) {
  switch (c) {
    case INTOPS: return probe_ktf_kernel<INTOPS>;
    case THREEFRY: return probe_ktf_kernel<THREEFRY>;
    case U01: return probe_ktf_kernel<U01>;
    case UNITVEC: return probe_ktf_kernel<UNITVEC>;
    default: return probe_ktf_kernel<SAMPLER_TILE>;
  }
}

}  // namespace probe_ktf

extern "C" int rt_probe_ktf(int c, const int* a, const int* b, uint32_t k0, uint32_t k1,
                            void* o0, void* o1, void* o2, void* o3, void* stream) {
  using namespace probe_ktf;
  if (c < 0 || c >= N_CASES) return static_cast<int>(cudaErrorInvalidValue);
  kernel_of(c)<<<1, TILE, 0, static_cast<cudaStream_t>(stream)>>>(a, b, k0, k1, o0, o1, o2, o3);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_ktf_attrs(int c, int* num_regs, int* local_bytes) {
  using namespace probe_ktf;
  if (c < 0 || c >= N_CASES) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_of(c));
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
