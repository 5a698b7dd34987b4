// K2: Threefry-2x32 standalone, and the draw kernels of the
// differentiable path.
//
// Replaces raytracer_tpu/utils/ktf.py threefry2x32 (:65) where it runs
// outside the path loop, and the jax.random draws of
// raytracer_tpu/utils/rng.py (:41-120), which XLA fuses inside the JAX
// package's jit. The fused path loop calls the __device__ functions of
// ktf.cuh inline instead.
//
// The launchers `rt_ktf_threefry` (one key: the ktf family) and
// `rt_ktf_threefry_keyed` (a key per element: the jax.random family of
// utils/rng.py, whose lane keys are themselves Threefry outputs) compute
// blocks for given counters; utils/rng.py key, split and lane_keys call
// them. One thread per counter pair; 16 or 24 bytes per thread.
//
// The draw kernels compute one draw site's numbers in one launch, one
// thread per lane, with no tensor of counters or keys in between:
//   - camera draws (render.render_pixels, camera.generate_rays): jitter u
//     and v and the lens disk of every lane of a trace; lanes are
//     sample-major, so lane l is pixel l % n at sample s0 + l / n and the
//     lane reads its pixel's key (or id) and its sample from its index.
//     The jax family also writes the sample-folded lane keys that the
//     bounces fold;
//   - bounce draws (models/megakernel.bounce_step, ops/materials.scatter):
//     the roulette uniform (from min_bounces on), the scatter unit vector
//     [N, 3] and the dielectric uniform.
// The jax family runs jax.random's chain per lane: fold the bounce, fold
// each purpose, random_bits, uniform, and for the unit vector three
// normals through XLA's ErfInv with the coefficients and operation order
// of utils/rng.erf_inv, normalised as utils/rng.random_unit_vector does.
// The ktf family builds its counters as ktf::Sampler does. Plain PyTorch
// versions: the per-method chains of utils/rng.KeySampler and
// utils/ktf.KtfSampler (kernel=False), which the wrappers take on CPU
// tensors. Bits and uniforms are theirs bit for bit; normals too wherever
// log1pf rounds as torch's log1p on the card does.
//
// Bound: integer operations (72 per Threefry block; a jax-family bounce
// runs 9 blocks per lane with the roulette draw, its camera 8), not bytes
// (28 and 24 bytes per lane).
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

namespace draws {

// utils/rng.py purpose tags.
constexpr uint32_t P_JITTER_U = 0x11, P_JITTER_V = 0x12, P_LENS = 0x13, P_RR = 0x21,
                   P_SCATTER = 0x31, P_DIELECTRIC = 0x32;
// float32 constants of utils/rng.py, as hex literals so that no decimal
// rounds twice: nextafter(-1, 0), float32(1) - that (2.0), float32(sqrt(2))
// and float32(1e-12).
constexpr float NORMAL_LO = -0x1.fffffep-1f, NORMAL_SPAN = 2.0f, SQRT2 = 0x1.6a09e6p+0f,
                TINY = 0x1.197998p-40f;

struct Key {
  uint32_t k0, k1;
};

// jax.random.fold_in(k, d) = threefry2x32(k, (0, d)).
__device__ __forceinline__ Key fold(Key k, uint32_t d) {
  Key r;
  ktf::threefry2x32(k.k0, k.k1, 0u, d, r.k0, r.k1);
  return r;
}

// Element i of jax.random.bits(k, shape): x0 ^ x1 of threefry2x32(k, (0, i)).
__device__ __forceinline__ uint32_t bits(Key k, uint32_t i) {
  uint32_t a, b;
  ktf::threefry2x32(k.k0, k.k1, 0u, i, a, b);
  return a ^ b;
}

// jax.random.uniform on [0, 1): bitcast(bits >>> 9 | 1.0f) - 1 (the
// scale by 1 and the shift by 0 are exact and left out).
__device__ __forceinline__ float uniform(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// XLA's float32 ErfInv, utils/rng.erf_inv operation for operation, with
// XLA's ErfInv32 coefficients (w < 5, w >= 5; hex literals as above).
__device__ __forceinline__ float erf_inv(float x) {
  const float lt5[9] = {0x1.e2cb1p-26f,   0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                        -0x1.11c9dep-8f,  0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
                        0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

// jax.random.normal: sqrt(2) * erf_inv(uniform on [nextafter(-1, 0), 1)).
__device__ __forceinline__ float normal(uint32_t b) {
  return SQRT2 * erf_inv(fmaxf(uniform(b) * NORMAL_SPAN + NORMAL_LO, NORMAL_LO));
}

// utils/rng.random_unit_vector: three normals over one key, normalised
// (torch.clamp_min keeps a NaN norm).
__device__ __forceinline__ void unit_vector(Key k, float& x, float& y, float& z) {
  const float g0 = normal(bits(k, 0)), g1 = normal(bits(k, 1)), g2 = normal(bits(k, 2));
  const float nn = sqrtf(g0 * g0 + g1 * g1 + g2 * g2);
  const float d = isnan(nn) ? nn : fmaxf(nn, TINY);
  x = g0 / d;
  y = g1 / d;
  z = g2 / d;
}

// utils/rng.random_in_unit_disk (x, y): two uniforms over one key.
__device__ __forceinline__ void disk(Key k, float& x, float& y) {
  const float r = sqrtf(uniform(bits(k, 0)));
  const float theta = ktf::TWO_PI * uniform(bits(k, 1));
  x = r * cosf(theta);
  y = r * sinf(theta);
}

constexpr int BLOCK = 256;

// Camera draws, jax family: pixel keys pk [n]; out rows jitter u, jitter
// v, lens x, lens y [total] each; keys_out rows k0, k1 [total].
__global__ void camera_jax_kernel(const int* __restrict__ pk0, const int* __restrict__ pk1, int n,
                                  int total, int s0, int* __restrict__ keys_out,
                                  float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= total) return;
  const size_t t = static_cast<size_t>(total);
  const int i = l % n;
  const Key s = fold(Key{static_cast<uint32_t>(pk0[i]), static_cast<uint32_t>(pk1[i])},
                     static_cast<uint32_t>(s0 + l / n));
  keys_out[l] = static_cast<int>(s.k0);
  keys_out[t + l] = static_cast<int>(s.k1);
  out[l] = uniform(bits(fold(s, P_JITTER_U), 0u));
  out[t + l] = uniform(bits(fold(s, P_JITTER_V), 0u));
  float x, y;
  disk(fold(s, P_LENS), x, y);
  out[2 * t + l] = x;
  out[3 * t + l] = y;
}

// Bounce draws, jax family: lane keys lk [total]; out rows roulette (only
// when rr), dielectric [total] each, then the unit vectors [total, 3].
__global__ void bounce_jax_kernel(const int* __restrict__ lk0, const int* __restrict__ lk1,
                                  int total, int bounce, int rr, float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= total) return;
  const size_t t = static_cast<size_t>(total);
  const Key b = fold(Key{static_cast<uint32_t>(lk0[l]), static_cast<uint32_t>(lk1[l])},
                     static_cast<uint32_t>(bounce));
  if (rr) out[l] = uniform(bits(fold(b, P_RR), 0u));
  out[t + l] = uniform(bits(fold(b, P_DIELECTRIC), 0u));
  float x, y, z;
  unit_vector(fold(b, P_SCATTER), x, y, z);
  float* u = out + 2 * t + 3 * static_cast<size_t>(l);
  u[0] = x;
  u[1] = y;
  u[2] = z;
}

// The ktf family's sampler of lane l: key words per pixel (key_step 1) or
// one pair (key_step 0), the pixel's id, its sample, the bounce.
__device__ __forceinline__ ktf::Sampler ktf_lane(const int* __restrict__ k0,
                                                 const int* __restrict__ k1, int key_step,
                                                 const int* __restrict__ pix, int n, int s0,
                                                 int bounce, int l) {
  const int i = l % n;
  return ktf::Sampler{static_cast<uint32_t>(k0[i * key_step]),
                      static_cast<uint32_t>(k1[i * key_step]), static_cast<uint32_t>(pix[i]),
                      static_cast<uint32_t>(s0 + l / n), static_cast<uint32_t>(bounce)};
}

// Camera draws, ktf family: out as camera_jax_kernel's.
__global__ void camera_ktf_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                                  int key_step, const int* __restrict__ pix, int n, int total,
                                  int s0, float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= total) return;
  const size_t t = static_cast<size_t>(total);
  const ktf::Sampler smp = ktf_lane(k0, k1, key_step, pix, n, s0, 0, l);
  float a, b;
  smp.uniform_pair(ktf::JITTER, a, b);
  out[l] = a;
  out[t + l] = b;
  smp.disk(ktf::LENS, a, b);
  out[2 * t + l] = a;
  out[3 * t + l] = b;
}

// Bounce draws, ktf family: out as bounce_jax_kernel's.
__global__ void bounce_ktf_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                                  int key_step, const int* __restrict__ pix, int n, int total,
                                  int s0, int bounce, int rr, float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= total) return;
  const size_t t = static_cast<size_t>(total);
  const ktf::Sampler smp = ktf_lane(k0, k1, key_step, pix, n, s0, bounce, l);
  if (rr) out[l] = smp.uniform(ktf::RR);
  out[t + l] = smp.uniform(ktf::DIELECTRIC);
  float x, y, z;
  smp.unit_vector(ktf::SCATTER, x, y, z);
  float* u = out + 2 * t + 3 * static_cast<size_t>(l);
  u[0] = x;
  u[1] = y;
  u[2] = z;
}

inline int grid(int total) { return (total + BLOCK - 1) / BLOCK; }

}  // namespace draws

// The draw kernels' entry points (utils/rng.py and utils/ktf.py wrap
// them): `total` lanes, n pixels per sample (total = n * samples), s0 the
// trace's first sample index.
extern "C" int rt_draws_camera_jax(const int* pk0, const int* pk1, int n, int total, int s0,
                                   int* keys_out, float* out, void* stream) {
  if (total > 0)
    draws::camera_jax_kernel<<<draws::grid(total), draws::BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(pk0, pk1, n, total, s0,
                                                                    keys_out, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_draws_bounce_jax(const int* lk0, const int* lk1, int total, int bounce, int rr,
                                   float* out, void* stream) {
  if (total > 0)
    draws::bounce_jax_kernel<<<draws::grid(total), draws::BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(lk0, lk1, total, bounce, rr,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_draws_camera_ktf(const int* k0, const int* k1, int key_step, const int* pix,
                                   int n, int total, int s0, float* out, void* stream) {
  if (total > 0)
    draws::camera_ktf_kernel<<<draws::grid(total), draws::BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(k0, k1, key_step, pix, n,
                                                                    total, s0, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_draws_bounce_ktf(const int* k0, const int* k1, int key_step, const int* pix,
                                   int n, int total, int s0, int bounce, int rr, float* out,
                                   void* stream) {
  if (total > 0)
    draws::bounce_ktf_kernel<<<draws::grid(total), draws::BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(k0, k1, key_step, pix, n,
                                                                    total, s0, bounce, rr, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
