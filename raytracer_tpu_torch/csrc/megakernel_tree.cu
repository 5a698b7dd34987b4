// K3 and K3-profile with the sphere tree (megakernel.cuh, TREE = true) over
// a width-8 triangle tree: the C entry points of the scenes whose spheres
// are found through scene/types.SphereTree. In a source of their own, so
// that they compile in parallel with megakernel.cu, whose entry points and
// instantiations they leave as they were.
#include <cuda_runtime.h>

#include "megakernel.cuh"

cudaError_t mk::launch_tree(bool profile, const FusedArgs& a) {
  return profile ? mk::launch<8, true, true>(a) : mk::launch<8, false, true>(a);
}

cudaError_t mk::attributes_tree(bool profile, cudaFuncAttributes* attr) {
  return profile ? mk::attributes<8, true, true>(attr) : mk::attributes<8, false, true>(attr);
}

namespace {

bool tree_ok(const trav::BvhView& bvh, const path::SphereTreeView* st) {
  return trav::view_ok(bvh) && bvh.width == 8 && st != nullptr && st->bounds != nullptr &&
         st->children != nullptr && st->sph != nullptr && st->ids != nullptr &&
         st->n_sweep >= 0 && (st->n_sweep == 0 || st->sweep != nullptr);
}

}  // namespace

// rt_render_fused's contract, the spheres found through the tree `st`.
extern "C" int rt_render_fused_tree(const FusedParams* p, const trav::BvhView* bvh,
                                    const int* pix, const int* px, const int* py,
                                    const float* sph, const int* sph_mat, const float* mat,
                                    const int* mat_type, int n, float* out, int block, int chunk,
                                    int* next, void* stream, const path::SphereTreeView* st) {
  if (!tree_ok(*bvh, st) || chunk < 1 || p->spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const mk::FusedArgs a{*p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n,
                          out, nullptr, nullptr, nullptr, block, chunk, next,
                          static_cast<cudaStream_t>(stream), *st, nullptr, nullptr};
    return static_cast<int>(mk::launch_tree(false, a));
  }
  return static_cast<int>(cudaGetLastError());
}

// rt_render_fused_profile's contract with the tree, and each lane's
// sphere-tree steps and sphere tests (sph_steps, sph_tests: [n] int).
extern "C" int rt_render_fused_profile_tree(const FusedParams* p, const trav::BvhView* bvh,
                                            const int* pix, const int* px, const int* py,
                                            const float* sph, const int* sph_mat,
                                            const float* mat, const int* mat_type, int n,
                                            float* out, float* cost, int* k1_steps,
                                            int* path_iters, float* aux, int block, int chunk,
                                            int* next, void* stream,
                                            const path::SphereTreeView* st, int* sph_steps,
                                            int* sph_tests) {
  if (!tree_ok(*bvh, st) || n % 1024 != 0 || chunk < 1 || p->spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const mk::FusedArgs a{*p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n,
                          out, cost, k1_steps, path_iters, block, chunk, next, s, *st, sph_steps,
                          sph_tests};
    const cudaError_t e = mk::launch_tree(true, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(mk::packet_bill(k1_steps, path_iters, n, aux, s));
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K3 (profile = 0) or
// K3-profile (profile = 1) with the tree.
extern "C" int rt_render_fused_tree_attrs(int profile, int* num_regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = mk::attributes_tree(profile != 0, &a);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
