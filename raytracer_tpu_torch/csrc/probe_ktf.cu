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
// Mapping (probe_tile.cuh, as P-mosaic and P-feature): one block of 8
// warps, warp s is row s and thread l owns the 4 adjacent lanes 4l..4l+3,
// so each input is one 128-bit load per thread through the read-only path
// and each output one 128-bit store, all outputs of a case in one [n_out,
// 8, 128] buffer. A thread's 4 lanes are independent, so Threefry's 20
// dependent rounds run 4 chains at once (ILP) instead of 1 in 1,024
// threads of one element each.
//
// What bounds it: the launch. The work is a few hundred integer and float
// operations an element (0.0000095 ms of int32 operations a tile at the
// card's peak); the call is the wrapper's host work and the launch, which
// the wrapper keeps to one signature comparison per input, one allocation
// and one ctypes call (probes/ktf_probe.py). cosf and sinf keep their slow
// path for large arguments out of line, with a small stack frame (unitvec
// 32 bytes, sampler_tile 16 of local memory); the angles here are in
// [0, 2 pi), so it never runs.
#include <cuda_runtime.h>

#include <cstdint>

#include "ktf.cuh"
#include "probe.cuh"
#include "probe_tile.cuh"

namespace probe_ktf {

enum Case { INTOPS, THREEFRY, U01, UNITVEC, SAMPLER_TILE, N_CASES };
constexpr int TILE = 8 * 128;
constexpr int WORDS = TILE / tile::VEC;  // 16-byte words of a tile: one per thread
constexpr uint32_t SAMPLE = 5, BOUNCE = 2;

__device__ __forceinline__ void words(const int* __restrict__ p, int i, uint32_t (&x)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p) + i);
  x[0] = static_cast<uint32_t>(v.x);
  x[1] = static_cast<uint32_t>(v.y);
  x[2] = static_cast<uint32_t>(v.z);
  x[3] = static_cast<uint32_t>(v.w);
}
// Output `k` of the case, 16-byte word i.
__device__ __forceinline__ void put(void* out, int k, int i, const uint32_t (&v)[4]) {
  reinterpret_cast<int4*>(out)[k * WORDS + i] =
      make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]), static_cast<int>(v[2]),
                static_cast<int>(v[3]));
}
__device__ __forceinline__ void put(void* out, int k, int i, const float (&v)[4]) {
  reinterpret_cast<float4*>(out)[k * WORDS + i] = make_float4(v[0], v[1], v[2], v[3]);
}

// a, b: the case's int32 inputs [8, 128] (unitvec: the two bit planes;
// sampler_tile: the pixel ids in a), 16-byte aligned; out: the case's
// outputs [n_out, 8, 128], int32 for intops and threefry, float32
// otherwise.
template <int C>
__global__ void __launch_bounds__(probe::P_SUB * 32)
    probe_ktf_kernel(const int* __restrict__ a, const int* __restrict__ b, uint32_t k0,
                     uint32_t k1, void* __restrict__ out) {
  const int i = threadIdx.x;  // word i: row i >> 5, lanes 4 (i & 31) .. + 3
  uint32_t x[4];
  words(a, i, x);
  if constexpr (C == INTOPS) {
    uint32_t y[4], add[4], xr[4], rot[4], shr[4];
    words(b, i, y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      add[j] = x[j] + y[j];
      xr[j] = x[j] ^ y[j];
      rot[j] = ktf::rotl(x[j], 13);
      shr[j] = x[j] >> 9;
    }
    put(out, 0, i, add);
    put(out, 1, i, xr);
    put(out, 2, i, rot);
    put(out, 3, i, shr);
  } else if constexpr (C == THREEFRY) {
    uint32_t y[4], x0[4], x1[4];
    words(b, i, y);
#pragma unroll
    for (int j = 0; j < 4; ++j) ktf::threefry2x32(k0, k1, x[j], y[j], x0[j], x1[j]);
    put(out, 0, i, x0);
    put(out, 1, i, x1);
  } else if constexpr (C == U01) {
    float u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = ktf::u01(x[j]);
    put(out, 0, i, u);
  } else if constexpr (C == UNITVEC) {
    uint32_t y[4];
    float vx[4], vy[4], vz[4];
    words(b, i, y);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ktf::unit_vector(ktf::u01(x[j]), ktf::u01(y[j]), vx[j], vy[j], vz[j]);
    put(out, 0, i, vx);
    put(out, 1, i, vy);
    put(out, 2, i, vz);
  } else {
    float rr[4], vx[4], vy[4], vz[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const ktf::Sampler smp{k0, k1, x[j], SAMPLE, BOUNCE};
      smp.unit_vector(ktf::SCATTER, vx[j], vy[j], vz[j]);
      rr[j] = smp.uniform(ktf::RR);
    }
    put(out, 0, i, rr);
    put(out, 1, i, vx);
    put(out, 2, i, vy);
    put(out, 3, i, vz);
  }
}

using KernelFn = void (*)(const int*, const int*, uint32_t, uint32_t, void*);

KernelFn kernel_of(int c) {
  switch (c) {
    case INTOPS: return probe_ktf_kernel<INTOPS>;
    case THREEFRY: return probe_ktf_kernel<THREEFRY>;
    case U01: return probe_ktf_kernel<U01>;
    case UNITVEC: return probe_ktf_kernel<UNITVEC>;
    case SAMPLER_TILE: return probe_ktf_kernel<SAMPLER_TILE>;
    default: return nullptr;
  }
}

}  // namespace probe_ktf

// Case c on the tile a (and b; nullptr where the case takes one input),
// both 16-byte aligned; out: the case's outputs, [n_out, 8, 128] in one
// 16-byte aligned buffer. cudaErrorInvalidValue for another case.
extern "C" int rt_probe_ktf(int c, const int* a, const int* b, uint32_t k0, uint32_t k1,
                            void* out, void* stream) {
  const probe_ktf::KernelFn k = probe_ktf::kernel_of(c);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  k<<<1, probe_ktf::WORDS, 0, static_cast<cudaStream_t>(stream)>>>(a, b, k0, k1, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_ktf_attrs(int c, int* num_regs, int* local_bytes) {
  const probe_ktf::KernelFn k = probe_ktf::kernel_of(c);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  const cudaError_t e = cudaFuncGetAttributes(&attr, k);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
