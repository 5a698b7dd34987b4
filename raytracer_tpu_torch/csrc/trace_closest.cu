// K4: batched closest hit, one thread per ray calling K1 (traverse.cuh).
//
// Replaces raytracer_tpu/ops/pallas_traverse.py _traverse_packets (:907),
// whose kernel is _make_kernel (:282) -> _kernel_body (:849), at the
// contract of trace_closest_pallas (:961). The wrapper is
// raytracer_tpu_torch/ops/cuda_traverse.py trace_closest; with sort=True
// (K4-sort, :975-1038) it argsorts the rays by coherence key and permutes
// them around this kernel, which is unchanged: one thread per ray, so a
// ray's record does not depend on the order. The differentiable path
// (ops/intersect.intersect_scene) launches it once per bounce; the fused
// path loop calls K1 inline instead. Bound like K1: dependent BVH loads
// and divergence; the ray I/O is 7 floats in and 6 words out per thread.
// One instantiation per built tree width (traverse.cuh), chosen by
// BvhView::width. A block stages the brute set and its cull table
// (traverse.cuh stage_brute) before its threads trace.
#include <cuda_runtime.h>

#include "traverse.cuh"

template <int K>
__global__ void trace_closest_kernel(trav::BvhView bvh, const float* __restrict__ o,
                                     const float* __restrict__ d, const float* __restrict__ tlim,
                                     float t_min, int n, float* __restrict__ t_out,
                                     int* __restrict__ id_out, int* __restrict__ mat_out,
                                     float* __restrict__ n_out) {
  __shared__ trav::BruteStage stage;
  const trav::BvhView view = trav::stage_brute(bvh, stage);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const trav::Hit h = trav::traverse<K>(view, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                     d[3 * i + 1], d[3 * i + 2], tlim[i], t_min);
  t_out[i] = h.t;
  id_out[i] = h.prim;
  mat_out[i] = h.mat;
  n_out[3 * i] = h.nx;
  n_out[3 * i + 1] = h.ny;
  n_out[3 * i + 2] = h.nz;
}

extern "C" int rt_trace_closest(const trav::BvhView* bvh, const float* o, const float* d,
                                const float* tlim, float t_min, int n, float* t_out, int* id_out,
                                int* mat_out, float* n_out, int block, void* stream) {
  if (!trav::view_ok(*bvh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int grid = (n + block - 1) / block;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bvh->width == 4)
      trace_closest_kernel<4><<<grid, block, 0, s>>>(*bvh, o, d, tlim, t_min, n, t_out, id_out,
                                                     mat_out, n_out);
    else
      trace_closest_kernel<8><<<grid, block, 0, s>>>(*bvh, o, d, tlim, t_min, n, t_out, id_out,
                                                     mat_out, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K4 at tree width 4 or 8.
extern "C" int rt_trace_closest_attrs(int width, int* num_regs, int* local_bytes) {
  if (!trav::built_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(
      &a, width == 4 ? trace_closest_kernel<4> : trace_closest_kernel<8>);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
