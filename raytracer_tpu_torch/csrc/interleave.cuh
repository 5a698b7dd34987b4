// K5: the fused path loop with two lanes per thread (G = 2), as a template
// over the tree width K.
//
// Replaces the interleave = 2 form of raytracer_tpu/ops/pallas_megakernel.py
// _make_mega_kernel (per_pair, :538-584), which runs two packets' path
// loops in one while loop and merges their traversals in
// raytracer_tpu/ops/pallas_interleave.py traverse_tiles (:22). The wrapper
// is raytracer_tpu_torch/ops/cuda_megakernel.py render_tiles_fused
// (interleave=2, or RAYTRACER_TPU_INTERLEAVE=2); the plain version is
// _render_plain there, since G = 2 equals G = 1 per lane. interleave.cu
// holds the C entry points and the width-8 instantiation, interleave_w4.cu
// the width-4 one, so that nvcc builds the two in parallel.
//
// Shape: K3's (megakernel.cuh) with two slots per thread. Persistent
// blocks, as many as fill the card at the kernel's occupancy; each of a
// thread's two slots takes its lane from the block's lane list (take_lane)
// and, when that lane's samples are done, writes its radiance and takes
// the next lane. So no lane waits for its partner, and the frame's tail is
// shared by all threads. In each step each occupied slot advances one path
// iteration: claim a sample and generate its camera ray, Russian roulette,
// the sphere sweep, then K1 for both rays at once in trav::traverse2 (one
// loop stepping two stacks, each ray with its own t_best and its own
// culled brute pre-pass over the brute set staged once per block), then
// shading. Per lane this is K3's loop with the same pieces (path.cuh) in
// the same order, so each lane's radiance equals K3's bit for bit,
// whichever thread and slot take it.
//
// Why: a K1 step is a chain of dependent loads (node boxes, child codes,
// the stack); two independent chains per thread give the warp schedulers
// a second load to issue while the first waits. The price is live state:
// two lanes' carries (ray, throughput, sums, sample, bounce) and two
// 256-entry stacks (2 KB of local memory per thread), so more registers
// and fewer resident warps than K3. On the TPU the same trade lost
// (pallas_interleave.py:4-9); that figure says nothing about this card.
#pragma once
#include <cuda_runtime.h>

#include "megakernel.cuh"

namespace g2 {

// One slot's path-loop state: its lane (-1 once the list is done) and the
// lane's sample under way.
struct Slot {
  int lane;
  uint32_t pixel;
  float pxf, pyf;
  int sample, bounce;
  bool active;
  path::Ray r;
  float ax, ay, az;  // radiance sum over finished samples
  float cx, cy, cz;  // the current sample's radiance
};

// What a slot carries from before its traversal to after it.
struct Pending {
  bool survived;
  float a_q;
  path::SphereHit sh;
  trav::Ray ray;  // t_lim = -1 (dead, direction (1, 1, 1)) when the slot traces nothing
};

__device__ __forceinline__ void load(Slot& L, int lane, const int* __restrict__ pix,
                                     const int* __restrict__ pxi, const int* __restrict__ pyi) {
  L.lane = lane;
  L.sample = 0;
  L.active = false;
  L.ax = 0.0f;
  L.ay = 0.0f;
  L.az = 0.0f;
  if (lane >= 0) {
    L.pixel = static_cast<uint32_t>(pix[lane]);
    L.pxf = static_cast<float>(pxi[lane]);
    L.pyf = static_cast<float>(pyi[lane]);
  }
}

__device__ __forceinline__ ktf::Sampler sampler(const FusedParams& p, const Slot& L) {
  return ktf::Sampler{p.k0, p.k1, L.pixel, static_cast<uint32_t>(L.sample + p.sample_offset),
                      static_cast<uint32_t>(L.bounce)};
}

// Before K1: claim a sample (camera ray at bounce 0) if the slot has none,
// Russian roulette, the sphere sweep (or with TREE the sphere tree's search).
template <bool TREE>
__device__ __forceinline__ void begin(const FusedParams& p, const path::Tables& tb,
                                      const path::SphereTreeView& tree, Slot& L, Pending& st) {
  st.survived = false;
  st.ray = trav::Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, -1.0f};  // dead, but fully set
  if (L.lane < 0) return;
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
  st.sh = path::spheres<TREE, false>(p, tb, tree, L.r, st.a_q, nullptr, nullptr);
  st.ray = trav::Ray{L.r.ox, L.r.oy, L.r.oz, L.r.dx, L.r.dy, L.r.dz, st.sh.t};
}

// After K1: shade. A slot whose sample ends adds it; once its lane's
// samples are done it writes the lane and takes the next one.
__device__ __forceinline__ void finish(const FusedParams& p, const path::Tables& tb, Slot& L,
                                       const Pending& st, const trav::Hit& h,
                                       unsigned long long* word, int* __restrict__ next, int n,
                                       int chunk, const int* __restrict__ pix,
                                       const int* __restrict__ pxi, const int* __restrict__ pyi,
                                       float* __restrict__ out) {
  if (L.lane < 0) return;
  if (st.survived &&
      path::shade(p, tb, sampler(p, L), L.bounce, st.sh, h, st.a_q, L.r, L.cx, L.cy, L.cz)) {
    ++L.bounce;
    return;
  }
  L.ax = L.ax + L.cx;
  L.ay = L.ay + L.cy;
  L.az = L.az + L.cz;
  L.active = false;
  if (++L.sample < p.spp) return;
  out[3 * L.lane] = L.ax;
  out[3 * L.lane + 1] = L.ay;
  out[3 * L.lane + 2] = L.az;
  load(L, mk::take_lane(word, next, n, chunk), pix, pxi, pyi);
}

// The kernel's body; `next` is the lane-list counter (zero before the
// launch) and `chunk` the lanes a block takes at a time, as K3's.
template <int K, bool TREE>
__device__ __forceinline__ void body(const FusedParams& p, const trav::BvhView& bvh_in,
                                     const int* __restrict__ pix, const int* __restrict__ pxi,
                                     const int* __restrict__ pyi, const path::Tables& tb, int n,
                                     int chunk, int* __restrict__ next, float* __restrict__ out,
                                     const path::SphereTreeView& tree) {
  __shared__ trav::BruteStage stage;
  const trav::BvhView bvh = trav::stage_brute(bvh_in, stage);
  __shared__ unsigned long long word;
  if (threadIdx.x == 0) word = static_cast<unsigned long long>(atomicAdd(next, chunk)) << 32;
  __syncthreads();
  Slot a, b;
  load(a, mk::take_lane(&word, next, n, chunk), pix, pxi, pyi);
  load(b, mk::take_lane(&word, next, n, chunk), pix, pxi, pyi);
  while (a.lane >= 0 || b.lane >= 0) {
    Pending sa, sb;
    begin<TREE>(p, tb, tree, a, sa);
    begin<TREE>(p, tb, tree, b, sb);
    trav::Hit ha, hb;
    trav::traverse2<K>(bvh, sa.ray, sb.ray, p.t_min, ha, hb);
    finish(p, tb, a, sa, ha, &word, next, n, chunk, pix, pxi, pyi, out);
    finish(p, tb, b, sb, hb, &word, next, n, chunk, pix, pxi, pyi, out);
  }
}

// __maxnreg__(80) caps the registers: six blocks of 128 threads fit an SM
// (24 warps; 128 registers uncapped, 16 warps) at 2,288 bytes of local
// memory per thread against 2,096. The 2K kernel ran 7% faster than
// uncapped so, and 5% faster than at 96 registers (PERF.md §6).
// TREE: as K3's; the tree's argument comes last.
template <int K, bool TREE>
__global__ void __maxnreg__(80)
    fused_path_g2_kernel(FusedParams p, trav::BvhView bvh, const int* __restrict__ pix,
                         const int* __restrict__ pxi, const int* __restrict__ pyi,
                         path::Tables tb, int n, int chunk, int* __restrict__ next,
                         float* __restrict__ out, path::SphereTreeView tree) {
  body<K, TREE>(p, bvh, pix, pxi, pyi, tb, n, chunk, next, out, tree);
}

template <int K, bool TREE = false>
cudaError_t launch(const mk::FusedArgs& a) {
  int grid = 0;  // no more blocks than the lanes fill at two per thread
  const cudaError_t e = mk::persistent_grid(fused_path_g2_kernel<K, TREE>, a.block,
                                            (a.n + 2 * a.block - 1) / (2 * a.block), grid);
  if (e != cudaSuccess) return e;
  fused_path_g2_kernel<K, TREE><<<grid, a.block, 0, a.stream>>>(
      a.p, a.bvh, a.pix, a.px, a.py, a.tb, a.n, a.chunk, a.next, a.out, a.st);
  return cudaGetLastError();
}

template <int K, bool TREE = false>
cudaError_t attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, fused_path_g2_kernel<K, TREE>);
}

// The width-4 instantiations (interleave_w4.cu).
cudaError_t launch_w4(const mk::FusedArgs& a);
cudaError_t attributes_w4(cudaFuncAttributes* attr);

// The sphere tree's instantiation over a width-8 triangle tree
// (interleave_tree.cu).
cudaError_t launch_tree(const mk::FusedArgs& a);
cudaError_t attributes_tree(cudaFuncAttributes* attr);

}  // namespace g2
