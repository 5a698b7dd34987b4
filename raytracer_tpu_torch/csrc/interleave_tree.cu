// K5 with the sphere tree (interleave.cuh, TREE = true) over a width-8
// triangle tree: its C entry points, in a source of their own so that they
// compile in parallel with interleave.cu.
#include <cuda_runtime.h>

#include "interleave.cuh"

cudaError_t g2::launch_tree(const mk::FusedArgs& a) { return g2::launch<8, true>(a); }

cudaError_t g2::attributes_tree(cudaFuncAttributes* attr) {
  return g2::attributes<8, true>(attr);
}

// rt_render_fused_g2's contract, the spheres found through the tree `st`.
extern "C" int rt_render_fused_g2_tree(const FusedParams* p, const trav::BvhView* bvh,
                                       const int* pix, const int* px, const int* py,
                                       const float* sph, const int* sph_mat, const float* mat,
                                       const int* mat_type, int n, float* out, int block,
                                       int chunk, int* next, void* stream,
                                       const path::SphereTreeView* st) {
  if (!trav::view_ok(*bvh) || bvh->width != 8 || st == nullptr || chunk < 1 || p->spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const mk::FusedArgs a{*p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n,
                          out, nullptr, nullptr, nullptr, block, chunk, next,
                          static_cast<cudaStream_t>(stream), *st, nullptr, nullptr};
    return static_cast<int>(g2::launch_tree(a));
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K5 with the tree.
extern "C" int rt_render_fused_g2_tree_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = g2::attributes_tree(&a);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
