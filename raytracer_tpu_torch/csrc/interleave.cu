// K5: the fused path loop with two lanes per thread (G = 2).
//
// Replaces the interleave = 2 form of raytracer_tpu/ops/pallas_megakernel.py
// _make_mega_kernel (per_pair, :538-584), which runs two packets' path
// loops in one while loop and merges their traversals in
// raytracer_tpu/ops/pallas_interleave.py traverse_tiles (:22). The wrapper
// is raytracer_tpu_torch/ops/cuda_megakernel.py render_tiles_fused
// (interleave=2, or RAYTRACER_TPU_INTERLEAVE=2); the plain version is
// _render_plain there, since G = 2 equals G = 1 per lane. One
// instantiation per built tree width (traverse.cuh), chosen by
// BvhView::width.
//
// Shape: thread t carries lanes 2t and 2t+1, so a warp covers 64
// neighbouring lanes (an odd lane count leaves the last thread one lane).
// One loop per thread; in each step each of the thread's pending lanes
// advances one path iteration: claim a sample and generate its camera ray,
// Russian roulette, the sphere sweep, then K1 for both rays at once in
// trav::traverse2 (one loop stepping two stacks, each ray with its own
// t_best), then shading. A lane whose samples are done idles while the
// other goes on. Per lane this is K3's nested loop (megakernel.cu) with
// the same pieces (path.cuh) in the same order, so each lane's radiance
// equals K3's bit for bit.
//
// Why: a K1 step is a chain of dependent loads (node boxes, child codes,
// the stack); two independent chains per thread give the warp schedulers
// a second load to issue while the first waits. The price is live state:
// two lanes' carries (ray, throughput, sums, sample, bounce) and two
// 256-entry stacks (2 KB of local memory per thread), so more registers
// and fewer resident warps than K3. On the TPU the same trade lost
// (pallas_interleave.py:4-9); that figure says nothing about this card.
#include <cuda_runtime.h>

#include "path.cuh"

namespace {

// One lane's path-loop state between steps.
struct Lane {
  uint32_t pixel;
  float pxf, pyf;
  int sample, bounce;
  bool active;
  path::Ray r;
  float ax, ay, az;  // radiance sum over finished samples
  float cx, cy, cz;  // the current sample's radiance
};

// What a lane carries from before its traversal to after it.
struct Pending {
  bool live, survived;
  float a_q;
  path::SphereHit sh;
  trav::Ray ray;  // t_lim = -1 (dead, direction (1, 1, 1)) when the lane traces nothing
};

__device__ __forceinline__ ktf::Sampler sampler(const FusedParams& p, const Lane& L) {
  return ktf::Sampler{p.k0, p.k1, L.pixel, static_cast<uint32_t>(L.sample + p.sample_offset),
                      static_cast<uint32_t>(L.bounce)};
}

// Before K1: claim a sample (camera ray at bounce 0) if the lane has none,
// Russian roulette, the sphere sweep.
__device__ __forceinline__ void begin(const FusedParams& p, const path::Tables& tb, Lane& L,
                                      Pending& st) {
  st.live = L.active || L.sample < p.spp;
  st.survived = false;
  st.ray = trav::Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, -1.0f};  // dead, but fully set
  if (!st.live) return;
  if (!L.active) {
    path::camera_ray(p, L.pixel, static_cast<uint32_t>(L.sample + p.sample_offset), L.pxf,
                     L.pyf, L.r);
    L.bounce = 0;
    L.active = true;
    L.cx = 0.0f;
    L.cy = 0.0f;
    L.cz = 0.0f;
  }
  st.survived = path::roulette(p, sampler(p, L), L.bounce, L.r);
  if (!st.survived) return;  // killed: this sample adds zero
  st.a_q = L.r.dx * L.r.dx + L.r.dy * L.r.dy + L.r.dz * L.r.dz;
  st.sh = path::sphere_sweep(p, tb, L.r, st.a_q);
  st.ray = trav::Ray{L.r.ox, L.r.oy, L.r.oz, L.r.dx, L.r.dy, L.r.dz, st.sh.t};
}

// After K1: shade; a lane whose sample ends adds it and goes back to claiming.
__device__ __forceinline__ void finish(const FusedParams& p, const path::Tables& tb, Lane& L,
                                       const Pending& st, const trav::Hit& h) {
  if (!st.live) return;
  if (st.survived &&
      path::shade(p, tb, sampler(p, L), L.bounce, st.sh, h, st.a_q, L.r, L.cx, L.cy, L.cz)) {
    ++L.bounce;
    return;
  }
  L.ax = L.ax + L.cx;
  L.ay = L.ay + L.cy;
  L.az = L.az + L.cz;
  ++L.sample;
  L.active = false;
}

__device__ __forceinline__ Lane load_lane(const FusedParams& p, const int* __restrict__ pix,
                                          const int* __restrict__ pxi,
                                          const int* __restrict__ pyi, int lane, bool present) {
  Lane L{};
  L.sample = present ? 0 : p.spp;  // an absent lane is never pending
  if (present) {
    L.pixel = static_cast<uint32_t>(pix[lane]);
    L.pxf = static_cast<float>(pxi[lane]);
    L.pyf = static_cast<float>(pyi[lane]);
  }
  return L;
}

template <int K>
__global__ void fused_path_g2_kernel(FusedParams p, trav::BvhView bvh,
                                     const int* __restrict__ pix, const int* __restrict__ pxi,
                                     const int* __restrict__ pyi, path::Tables tb, int n,
                                     float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int l0 = 2 * t;
  if (l0 >= n) return;
  const bool has1 = l0 + 1 < n;
  Lane a = load_lane(p, pix, pxi, pyi, l0, true);
  Lane b = load_lane(p, pix, pxi, pyi, l0 + 1, has1);

  while (a.active || a.sample < p.spp || b.active || b.sample < p.spp) {
    Pending sa, sb;
    begin(p, tb, a, sa);
    begin(p, tb, b, sb);
    trav::Hit ha, hb;
    trav::traverse2<K>(bvh, sa.ray, sb.ray, p.t_min, ha, hb);
    finish(p, tb, a, sa, ha);
    finish(p, tb, b, sb, hb);
  }
  out[3 * l0] = a.ax;
  out[3 * l0 + 1] = a.ay;
  out[3 * l0 + 2] = a.az;
  if (has1) {
    out[3 * l0 + 3] = b.ax;
    out[3 * l0 + 4] = b.ay;
    out[3 * l0 + 5] = b.az;
  }
}

}  // namespace

// `block` is threads per block; each thread takes two lanes.
extern "C" int rt_render_fused_g2(const FusedParams* p, const trav::BvhView* bvh, const int* pix,
                                  const int* px, const int* py, const float* sph,
                                  const int* sph_mat, const float* mat, const int* mat_type, int n,
                                  float* out, int block, void* stream) {
  if (!trav::built_width(bvh->width)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int threads = (n + 1) / 2;
    const int grid = (threads + block - 1) / block;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const path::Tables tb{sph, sph_mat, mat, mat_type};
    if (bvh->width == 4)
      fused_path_g2_kernel<4><<<grid, block, 0, s>>>(*p, *bvh, pix, px, py, tb, n, out);
    else
      fused_path_g2_kernel<8><<<grid, block, 0, s>>>(*p, *bvh, pix, px, py, tb, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K5 at tree width 4 or 8.
extern "C" int rt_render_fused_g2_attrs(int width, int* num_regs, int* local_bytes) {
  if (!trav::built_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(
      &a, width == 4 ? fused_path_g2_kernel<4> : fused_path_g2_kernel<8>);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
