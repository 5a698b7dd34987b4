// K3: the whole path loop per pixel lane in one kernel, and K3-profile,
// its instrumented twin.
//
// Replaces raytracer_tpu/ops/pallas_megakernel.py _render_packets_fused
// (:623), whose kernel is _make_mega_kernel (:121); the wrapper is
// raytracer_tpu_torch/ops/cuda_megakernel.py render_tiles_fused and the
// plain PyTorch version is _render_plain there.
//
// Shape: one thread per pixel lane, looping samples and bounces — the
// CUDA reference's own shape (CUDAKernels.h:102-166). The nested loop is
// exactly the per-lane sequence of the TPU kernel's regeneration state
// machine: every draw is keyed by (pixel, sample + sample_offset, bounce,
// purpose) (ktf.cuh), samples accumulate in order, and the TPU's loop
// bound spp*max_bounces+2 never binds, so none is needed. The pieces of a
// path iteration live in path.cuh, shared with K5 (interleave.cu). A lane
// killed by roulette ends its sample with zero, as the TPU's dead lanes do.
//
// K3-profile (PROFILE = true; _make_mega_kernel(profile=True), :493-535)
// also counts, per lane, its path iterations (passes through the bounce
// loop, a pass that roulette kills included) and its K1 steps
// (traverse<true>), and writes cost = iterations + K1 steps, the TPU's
// `cost + trav_out[6] + where(active, 1, 0)` (:509-510). A second kernel
// then writes the per-packet aux plane ([N/1024, 8, 128]): row 0 is the
// packet's lockstep bill ON THE CARD — the sum over its 32 warps of the
// largest lane total of K1 steps in the warp, since the warp is what runs
// in lockstep here, where the TPU summed over traversal calls the largest
// of its 8 sub-warp chains; row 1 is the packet's outer path iterations,
// the largest lane iteration count (the TPU's `path_iters - out[0]`);
// rows 2-7 are zero. The radiance is the production kernel's bit for bit:
// the counters only add integers beside it. The production instantiation
// (PROFILE = false) has no counter.
//
// What bounds it on an H100: the traversal's dependent loads and the
// divergence of lanes that leave their samples at different bounces; the
// shading arithmetic and Threefry draws are a small share. The camera,
// roulette and sample constants travel by value in FusedParams; spheres
// (<= 16) and materials (<= 28) are read from small global tables whose
// uniform or few distinct addresses the L1 serves.
#include <cuda_runtime.h>

#include "path.cuh"

namespace {

constexpr int PACKET = 1024;   // lanes of one aux packet (8 x 128 on the TPU)
constexpr int WARP = 32;

template <bool PROFILE>
__global__ void fused_path_kernel(FusedParams p, trav::BvhView bvh, const int* __restrict__ pix,
                                  const int* __restrict__ pxi, const int* __restrict__ pyi,
                                  path::Tables tb, int n, float* __restrict__ out,
                                  float* __restrict__ cost, int* __restrict__ k1_steps,
                                  int* __restrict__ path_iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint32_t pixel = static_cast<uint32_t>(pix[lane]);
  const float pxf = static_cast<float>(pxi[lane]);
  const float pyf = static_cast<float>(pyi[lane]);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  int k1 = 0, iters = 0;  // K3-profile counts

  for (int s = 0; s < p.spp; ++s) {
    const uint32_t s_eff = static_cast<uint32_t>(s + p.sample_offset);
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;  // this sample's radiance
    path::Ray r;
    path::camera_ray(p, pixel, s_eff, pxf, pyf, r);
    for (int bounce = 0;; ++bounce) {
      if constexpr (PROFILE) ++iters;
      const ktf::Sampler smp{p.k0, p.k1, pixel, s_eff, static_cast<uint32_t>(bounce)};
      if (!path::roulette(p, smp, bounce, r)) break;  // killed: this sample adds zero
      const float a_q = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
      const path::SphereHit sh = path::sphere_sweep(p, tb, r, a_q);
      // K1: closest triangle in [t_min, t_sph).
      const trav::Hit h = trav::traverse<PROFILE>(bvh, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, sh.t,
                                                  p.t_min, PROFILE ? &k1 : nullptr);
      if (!path::shade(p, tb, smp, bounce, sh, h, a_q, r, cx, cy, cz)) break;
    }
    ax = ax + cx;
    ay = ay + cy;
    az = az + cz;
  }
  out[3 * lane] = ax;
  out[3 * lane + 1] = ay;
  out[3 * lane + 2] = az;
  if constexpr (PROFILE) {
    cost[lane] = static_cast<float>(iters + k1);
    k1_steps[lane] = k1;
    path_iters[lane] = iters;
  }
}

// K3-profile's aux plane, one thread per 1024-lane packet (exact integer
// sums and maxima, written as floats like the TPU's plane).
__global__ void packet_bill_kernel(const int* __restrict__ k1_steps,
                                   const int* __restrict__ path_iters, int g,
                                   float* __restrict__ aux) {
  const int pk = blockIdx.x * blockDim.x + threadIdx.x;
  if (pk >= g) return;
  const int* k1 = k1_steps + static_cast<size_t>(pk) * PACKET;
  const int* it = path_iters + static_cast<size_t>(pk) * PACKET;
  int lockstep = 0, outer = 0;
  for (int w = 0; w < PACKET / WARP; ++w) {
    int wmax = 0;
    for (int l = 0; l < WARP; ++l) wmax = max(wmax, k1[WARP * w + l]);
    lockstep += wmax;
  }
  for (int l = 0; l < PACKET; ++l) outer = max(outer, it[l]);
  float* a = aux + static_cast<size_t>(pk) * PACKET;
  for (int j = 0; j < 128; ++j) {
    a[j] = static_cast<float>(lockstep);
    a[128 + j] = static_cast<float>(outer);
  }
  for (int j = 256; j < PACKET; ++j) a[j] = 0.0f;
}

}  // namespace

extern "C" int rt_render_fused(const FusedParams* p, const trav::BvhView* bvh, const int* pix,
                               const int* px, const int* py, const float* sph, const int* sph_mat,
                               const float* mat, const int* mat_type, int n, float* out,
                               int block, void* stream) {
  if (bvh->width != trav::K) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int grid = (n + block - 1) / block;
    fused_path_kernel<false><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        *p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n, out, nullptr,
        nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3-profile: radiance sums (out, [n, 3]), cost [n], aux [n] (n % 1024 == 0);
// k1_steps and path_iters are [n] int scratch the wrapper allocates.
extern "C" int rt_render_fused_profile(const FusedParams* p, const trav::BvhView* bvh,
                                       const int* pix, const int* px, const int* py,
                                       const float* sph, const int* sph_mat, const float* mat,
                                       const int* mat_type, int n, float* out, float* cost,
                                       int* k1_steps, int* path_iters, float* aux, int block,
                                       void* stream) {
  if (bvh->width != trav::K || n % PACKET != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (n + block - 1) / block;
    fused_path_kernel<true><<<grid, block, 0, s>>>(*p, *bvh, pix, px, py,
                                                   path::Tables{sph, sph_mat, mat, mat_type}, n,
                                                   out, cost, k1_steps, path_iters);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int g = n / PACKET;
    packet_bill_kernel<<<(g + 127) / 128, 128, 0, s>>>(k1_steps, path_iters, g, aux);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K3 (profile = 0) or
// K3-profile (profile = 1), as cudaFuncGetAttributes reports them.
extern "C" int rt_render_fused_attrs(int profile, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = profile ? cudaFuncGetAttributes(&a, fused_path_kernel<true>)
                                : cudaFuncGetAttributes(&a, fused_path_kernel<false>);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
