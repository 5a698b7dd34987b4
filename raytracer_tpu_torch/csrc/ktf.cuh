// K2: counter-based Threefry-2x32 draws as __device__ functions.
//
// Replaces raytracer_tpu/utils/ktf.py (threefry2x32 :65, u01 :100,
// KtfSampler :122), which the TPU path loop runs inside its Pallas kernel.
// Plain PyTorch version: raytracer_tpu_torch/utils/ktf.py.
//
// Spec: standard Threefry-2x32, 20 rounds, on uint32 (wrapping adds);
// counter c0 = pixel, c1 = sample<<9 | bounce<<4 | purpose; uniform
// u01(bits) = float(bits >> 9) * 2^-23 (exact). Bitwise equal to the JAX
// and PyTorch versions for the same key words.
//
// Cost on this card: 20 rounds of add/rotate/xor on two registers — a few
// dozen integer instructions per block of two draws; it is never the
// bound of the path loop, whose threads wait on BVH loads.
#pragma once
#include <cstdint>

namespace ktf {

enum Purpose : uint32_t { JITTER = 1, LENS = 2, RR = 3, SCATTER = 4, DIELECTRIC = 5 };

constexpr float TWO_PI = 6.28318530717958647692f;  // float32(2*pi), as both Python versions

__host__ __device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                                      uint32_t c1, uint32_t& out0,
                                                      uint32_t& out1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#define KTF_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;
#define KTF_ROUNDS_A KTF_ROUND(13) KTF_ROUND(15) KTF_ROUND(26) KTF_ROUND(6)
#define KTF_ROUNDS_B KTF_ROUND(17) KTF_ROUND(29) KTF_ROUND(16) KTF_ROUND(24)
  KTF_ROUNDS_A
  x0 += k1;  x1 += ks2 + 1u;
  KTF_ROUNDS_B
  x0 += ks2; x1 += k0 + 2u;
  KTF_ROUNDS_A
  x0 += k0;  x1 += k1 + 3u;
  KTF_ROUNDS_B
  x0 += k1;  x1 += ks2 + 4u;
  KTF_ROUNDS_A
  x0 += ks2; x1 += k0 + 5u;
#undef KTF_ROUNDS_B
#undef KTF_ROUNDS_A
#undef KTF_ROUND
  out0 = x0;
  out1 = x1;
}

__host__ __device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(bits >> 9) * 1.1920928955078125e-07f;  // 2^-23
}

__host__ __device__ __forceinline__ uint32_t counter(uint32_t sample, uint32_t bounce,
                                                     uint32_t purpose) {
  return (sample << 9) | (bounce << 4) | purpose;
}

// One keyed draw context: (key, pixel, sample, bounce), like KtfSampler.
struct Sampler {
  uint32_t k0, k1, pixel, sample, bounce;

  __device__ __forceinline__ void uniform_pair(uint32_t purpose, float& a, float& b) const {
    uint32_t x0, x1;
    threefry2x32(k0, k1, pixel, counter(sample, bounce, purpose), x0, x1);
    a = u01(x0);
    b = u01(x1);
  }
  __device__ __forceinline__ float uniform(uint32_t purpose) const {
    uint32_t x0, x1;
    threefry2x32(k0, k1, pixel, counter(sample, bounce, purpose), x0, x1);
    return u01(x0);
  }
  // Uniform direction on the sphere (ktf::unit_vector below).
  __device__ __forceinline__ void unit_vector(uint32_t purpose, float& x, float& y,
                                              float& z) const;
  // Uniform point in the unit disk (polar closed form).
  __device__ __forceinline__ void disk(uint32_t purpose, float& x, float& y) const {
    float u1, u2;
    uniform_pair(purpose, u1, u2);
    const float r = sqrtf(u1);
    const float theta = TWO_PI * u2;
    x = r * cosf(theta);
    y = r * sinf(theta);
  }
};

// Uniform direction on the sphere from two uniforms: z = 1-2u1, phi = 2*pi*u2.
__device__ __forceinline__ void unit_vector(float u1, float u2, float& x, float& y, float& z) {
  z = 1.0f - 2.0f * u1;
  const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float phi = TWO_PI * u2;
  x = r * cosf(phi);
  y = r * sinf(phi);
}

__device__ __forceinline__ void Sampler::unit_vector(uint32_t purpose, float& x, float& y,
                                                     float& z) const {
  float u1, u2;
  uniform_pair(purpose, u1, u2);
  ktf::unit_vector(u1, u2, x, y, z);
}

}  // namespace ktf
