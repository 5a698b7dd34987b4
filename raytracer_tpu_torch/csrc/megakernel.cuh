// K3: the whole path loop per pixel lane in one kernel, and K3-profile,
// its instrumented twin, as templates over the tree width K.
//
// Replaces raytracer_tpu/ops/pallas_megakernel.py _render_packets_fused
// (:623), whose kernel is _make_mega_kernel (:121); the wrapper is
// raytracer_tpu_torch/ops/cuda_megakernel.py render_tiles_fused and the
// plain PyTorch version is _render_plain there. megakernel.cu holds the C
// entry points and the width-8 instantiations, megakernel_w4.cu the
// width-4 ones, so that nvcc builds the two in parallel.
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
// (traverse<K, true>), and writes cost = iterations + K1 steps, the TPU's
// `cost + trav_out[6] + where(active, 1, 0)` (:509-510). megakernel.cu's
// packet_bill_kernel then writes the per-packet aux plane. The radiance is
// the production kernel's bit for bit: the counters only add integers
// beside it. The production instantiation (PROFILE = false) has no counter.
//
// What bounds it on an H100: the traversal's dependent loads and the
// divergence of lanes that leave their samples at different bounces; the
// shading arithmetic and Threefry draws are a small share. The camera,
// roulette and sample constants travel by value in FusedParams; spheres
// (<= 16) and materials (<= 28) are read from small global tables whose
// uniform or few distinct addresses the L1 serves.
#pragma once
#include <cuda_runtime.h>

#include "path.cuh"

namespace mk {

// One launch of K3 or K3-profile: the lanes, the tables and the outputs
// (cost, k1_steps and path_iters are K3-profile's, null for K3).
struct FusedArgs {
  FusedParams p;
  trav::BvhView bvh;
  const int* pix;
  const int* px;
  const int* py;
  path::Tables tb;
  int n;
  float* out;
  float* cost;
  int* k1_steps;
  int* path_iters;
  int block;
  cudaStream_t stream;
};

template <int K, bool PROFILE>
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
      const trav::Hit h = trav::traverse<K, PROFILE>(bvh, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                                     sh.t, p.t_min, PROFILE ? &k1 : nullptr);
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

template <int K, bool PROFILE>
cudaError_t launch(const FusedArgs& a) {
  const int grid = (a.n + a.block - 1) / a.block;
  fused_path_kernel<K, PROFILE><<<grid, a.block, 0, a.stream>>>(
      a.p, a.bvh, a.pix, a.px, a.py, a.tb, a.n, a.out, a.cost, a.k1_steps, a.path_iters);
  return cudaGetLastError();
}

template <int K, bool PROFILE>
cudaError_t attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, fused_path_kernel<K, PROFILE>);
}

// The width-4 instantiations (megakernel_w4.cu).
cudaError_t launch_w4(bool profile, const FusedArgs& a);
cudaError_t attributes_w4(bool profile, cudaFuncAttributes* attr);

}  // namespace mk
