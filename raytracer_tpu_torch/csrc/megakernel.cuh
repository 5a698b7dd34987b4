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
// Shape: persistent blocks whose threads refill from the lane list. The
// launch fills the card (occupancy x SMs blocks); a block takes `chunk`
// lanes of the list at a time with one global atomicAdd, and a thread whose
// pixel has finished its spp samples takes the block's next lane with a
// shared-memory atomicAdd. A thread runs one flat loop, one path iteration
// per trip: claim the next sample (camera ray) when the last one ended,
// roulette, spheres, K1, shading. So a lane whose path ends early starts its
// next sample, or its next pixel, while the warp's other lanes go on, where
// the nested sample/bounce loops of one thread per lane (the earlier
// kernel, the CUDA reference's own shape, CUDAKernels.h:102-166) kept it
// idle until the warp's longest path of that sample had ended (PERF.md §6
// times the two). Per lane the sequence is the TPU kernel's regeneration state
// machine, which both shapes follow:
// every draw is keyed by (pixel, sample + sample_offset, bounce, purpose)
// (ktf.cuh), a pixel's samples run in one thread in order and accumulate in
// order, and out[3*lane..] is written once. Which thread takes which lane
// does not change any lane's result, so the frame, the profile counts and
// the aux plane are the same bit for bit at every block and chunk size. The
// TPU's loop bound spp*max_bounces+2 never binds, so none is needed. The
// pieces of a path iteration live in path.cuh, shared with K5
// (interleave.cu). A lane killed by roulette ends its sample with zero, as
// the TPU's dead lanes do.
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
// What bounds it on an H100: instructions at one warp per scheduler (the
// brute pre-pass was ~95% of the counted fp32 work until K1 culled it) and
// the divergence of lanes that leave their samples at different bounces,
// which the refill answers; the BVH's dependent loads and the Threefry
// draws are a smaller share. The camera,
// roulette and sample constants travel by value in FusedParams; spheres
// and materials are read from global tables whose uniform or few distinct
// addresses the L1 serves. Up to 16 spheres are swept by every ray; a
// scene of more takes the TREE instantiations, which find them through the
// sphere tree (path.cuh sphere_search, megakernel_tree.cu).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "path.cuh"

namespace mk {

// One launch of K3, K3-profile or K5: the lanes, the tables and the
// outputs (cost, k1_steps and path_iters are K3-profile's, null for K3 and
// K5); `next`
// is the lane-list counter (int, zero before the launch) and `chunk` the
// lanes a block takes at a time.
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
  int chunk;
  int* next;
  cudaStream_t stream;
  // The sphere tree's launches (TREE): the tree, and K3-profile's lane
  // counts of its walk (null otherwise).
  path::SphereTreeView st;
  int* sph_steps;
  int* sph_tests;
};

// One take of the word: add 1 and return the word as it was. The threads
// that take together are coalesced by hand: one atomic add of the group's
// size, whose old value the leader shuffles to the others, each adding its
// rank (the CUDA programming guide's warp-aggregated atomic). ptxas made
// that aggregation of a plain atomicAdd itself, and in K5 (four take sites,
// two slots refilled apart) it now and then handed a warp a stale or zero
// base, or let the count skip `chunk`: lane 0 went out twice and a fetched
// chunk was overwritten unread (a lost lane, NaN under the wrapper's fill),
// or no take saw `chunk` and the block waited for ever (PERF.md §7).
__device__ __forceinline__ unsigned long long take_word(unsigned long long* word) {
  const cooperative_groups::coalesced_group g = cooperative_groups::coalesced_threads();
  unsigned long long w = 0;
  if (g.thread_rank() == 0) w = atomicAdd(word, static_cast<unsigned long long>(g.size()));
  return g.shfl(w, 0) + g.thread_rank();
}

// The next lane for this thread, or -1 when the list is done. `word` holds
// the block's chunk: its first lane (high 32 bits) and how many takes it
// has seen (low 32 bits). Why no lane is taken twice or lost without a lock:
//  - each take adds 1 to the word atomically (take_word), so within a
//    chunk the counts 0, 1, 2, ... go to one take each; a count below
//    `chunk` is a lane (-1 past the list's end);
//  - exactly one take sees count == chunk. That thread alone fetches the
//    next chunk (one global atomicAdd, so no two blocks share a lane) and
//    replaces the word by (new base, 0) with atomicExch. Takes that came
//    between its add and its exchange saw counts above `chunk`, got no
//    lane, and are dropped with the old count;
//  - a take that saw a count above `chunk` waits until the word's base
//    differs from the one it saw, then takes again. Bases come from one
//    counter that only grows, so a different base is a newer chunk. The
//    wait reads the whole word in one aligned 64-bit load;
//  - a base >= n means the list is done. The counter then passes n by at
//    most one chunk per block (the wrapper checks int32 overflow);
//  - after the first barrier no thread waits for a barrier, and the fetcher
//    never waits, so a thread that has left holds no one up. Threads of one
//    warp may wait for a lane of their own warp: independent thread
//    scheduling (sm_70 and later) lets that lane go on.
// test_k3_matches_plain_and_launch_shape and test_k3_lane_list_corners
// (tests/test_torch_cuda.py) hold the image at chunk 1 and at chunks larger
// than the block, with fewer lanes than threads.
__device__ __forceinline__ int take_lane(unsigned long long* word, int* __restrict__ next, int n,
                                         int chunk) {
  // The first take stands before the retry loop: with it inside the loop,
  // K3 and K5 ran markedly slower at 2K on an H100 (PERF.md §7).
  unsigned long long w = take_word(word);
  for (;;) {
    const int base = static_cast<int>(w >> 32);
    const unsigned taken = static_cast<unsigned>(w);
    if (base >= n) return -1;
    if (taken < static_cast<unsigned>(chunk)) {
      const int lane = base + static_cast<int>(taken);
      return lane < n ? lane : -1;
    }
    if (taken == static_cast<unsigned>(chunk)) {
      const int nb = atomicAdd(next, chunk);
      atomicExch(word, static_cast<unsigned long long>(nb) << 32);
    } else {
      while (static_cast<int>(*reinterpret_cast<volatile unsigned long long*>(word) >> 32) == base)
        __nanosleep(32);
    }
    w = take_word(word);
  }
}

// __launch_bounds__(256, 4) caps the registers so that four blocks of 256
// threads fit an SM: K3 keeps 64 registers and 32 warps per SM (78
// uncapped, 24 warps) at a few more bytes of local memory, and runs faster
// so (PERF.md §6). Blocks of more than 256 threads do not launch.
//
// TREE: the spheres are found through the sphere tree (path::sphere_search)
// in place of the sweep over all of them; K3-profile then also counts each
// lane's sphere-tree steps and sphere tests. The tree's arguments come last,
// so the instantiations without it (TREE = false: every scene of at most 16
// spheres) take their parameters where they did before the tree existed.
template <int K, bool PROFILE, bool TREE>
__global__ void __launch_bounds__(256, 4) fused_path_kernel(FusedParams p, trav::BvhView bvh_in,
                                  const int* __restrict__ pix, const int* __restrict__ pxi,
                                  const int* __restrict__ pyi, path::Tables tb, int n, int chunk,
                                  int* __restrict__ next, float* __restrict__ out,
                                  float* __restrict__ cost, int* __restrict__ k1_steps,
                                  int* __restrict__ path_iters, path::SphereTreeView st,
                                  int* __restrict__ sph_steps, int* __restrict__ sph_tests) {
  __shared__ trav::BruteStage stage;
  const trav::BvhView bvh = trav::stage_brute(bvh_in, stage);
  __shared__ unsigned long long word;
  if (threadIdx.x == 0) word = static_cast<unsigned long long>(atomicAdd(next, chunk)) << 32;
  __syncthreads();
  int lane = take_lane(&word, next, n, chunk);
  uint32_t pixel = 0;
  float pxf = 0.0f, pyf = 0.0f;
  if (lane >= 0) {
    pixel = static_cast<uint32_t>(pix[lane]);
    pxf = static_cast<float>(pxi[lane]);
    pyf = static_cast<float>(pyi[lane]);
  }
  int s = 0, bounce = 0;
  bool active = false;  // a sample is under way
  path::Ray r;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;  // radiance sum of the finished samples
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;  // the current sample's radiance
  int k1 = 0, iters = 0;                  // K3-profile counts
  int ssteps = 0, stests = 0;             // K3-profile's sphere-tree counts (TREE)
  while (lane >= 0) {
    const uint32_t s_eff = static_cast<uint32_t>(s + p.sample_offset);
    if (!active) {
      path::camera_ray(p, pixel, s_eff, pxf, pyf, r);
      bounce = 0;
      cx = 0.0f;
      cy = 0.0f;
      cz = 0.0f;
      active = true;
    }
    if constexpr (PROFILE) ++iters;
    const ktf::Sampler smp{p.k0, p.k1, pixel, s_eff, static_cast<uint32_t>(bounce)};
    bool more = false;
    if (path::roulette(p, smp, bounce, r)) {  // killed: this sample adds zero
      const float a_q = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
      const path::SphereHit sh = path::spheres<TREE, PROFILE>(p, tb, st, r, a_q, &ssteps,
                                                              &stests);
      // K1: closest triangle in [t_min, t_sph).
      const trav::Hit h = trav::traverse<K, PROFILE>(bvh, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                                     sh.t, p.t_min, PROFILE ? &k1 : nullptr);
      more = path::shade(p, tb, smp, bounce, sh, h, a_q, r, cx, cy, cz);
    }
    if (more) {
      ++bounce;
      continue;
    }
    ax = ax + cx;
    ay = ay + cy;
    az = az + cz;
    active = false;
    if (++s < p.spp) continue;
    out[3 * lane] = ax;
    out[3 * lane + 1] = ay;
    out[3 * lane + 2] = az;
    if constexpr (PROFILE) {
      cost[lane] = static_cast<float>(iters + k1);
      k1_steps[lane] = k1;
      path_iters[lane] = iters;
      if constexpr (TREE) {
        sph_steps[lane] = ssteps;
        sph_tests[lane] = stests;
      }
    }
    lane = take_lane(&word, next, n, chunk);
    if (lane >= 0) {
      pixel = static_cast<uint32_t>(pix[lane]);
      pxf = static_cast<float>(pxi[lane]);
      pyf = static_cast<float>(pyi[lane]);
    }
    s = 0;
    ax = 0.0f;
    ay = 0.0f;
    az = 0.0f;
    k1 = 0;
    iters = 0;
    ssteps = 0;
    stests = 0;
  }
}

// The grid of persistent blocks: as many as fill the card at the kernel's
// occupancy, and no more than `fill`, the blocks the lanes fill (a block
// past that would only stage the brute set and find the list done).
template <typename F>
cudaError_t persistent_grid(F kernel, int block, int fill, int& grid) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = per_sm * sms < fill ? per_sm * sms : fill;
  return cudaSuccess;
}

template <int K, bool PROFILE, bool TREE = false>
cudaError_t launch(const FusedArgs& a) {
  int grid = 0;
  const cudaError_t e = persistent_grid(fused_path_kernel<K, PROFILE, TREE>, a.block,
                                        (a.n + a.block - 1) / a.block, grid);
  if (e != cudaSuccess) return e;
  fused_path_kernel<K, PROFILE, TREE><<<grid, a.block, 0, a.stream>>>(
      a.p, a.bvh, a.pix, a.px, a.py, a.tb, a.n, a.chunk, a.next, a.out, a.cost, a.k1_steps,
      a.path_iters, a.st, a.sph_steps, a.sph_tests);
  return cudaGetLastError();
}

template <int K, bool PROFILE, bool TREE = false>
cudaError_t attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, fused_path_kernel<K, PROFILE, TREE>);
}

// The width-4 instantiations (megakernel_w4.cu).
cudaError_t launch_w4(bool profile, const FusedArgs& a);
cudaError_t attributes_w4(bool profile, cudaFuncAttributes* attr);

// The sphere tree's instantiations over a width-8 triangle tree
// (megakernel_tree.cu).
cudaError_t launch_tree(bool profile, const FusedArgs& a);
cudaError_t attributes_tree(bool profile, cudaFuncAttributes* attr);

// K3-profile's per-packet aux plane after its launch (megakernel.cu).
cudaError_t packet_bill(const int* k1_steps, const int* path_iters, int n, float* aux,
                        cudaStream_t stream);

}  // namespace mk
