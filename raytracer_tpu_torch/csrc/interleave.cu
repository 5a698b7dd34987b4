// K5 (interleave.cuh): the C entry points, which dispatch on the tree width
// (8 here, 4 in interleave_w4.cu).
#include <cuda_runtime.h>

#include "interleave.cuh"

// `block` threads per block, two lanes per thread; `chunk` lanes per take
// from the lane list; `next` an int on the card, 0 before the launch (the
// wrapper's torch.zeros).
extern "C" int rt_render_fused_g2(const FusedParams* p, const trav::BvhView* bvh, const int* pix,
                                  const int* px, const int* py, const float* sph,
                                  const int* sph_mat, const float* mat, const int* mat_type, int n,
                                  float* out, int block, int chunk, int* next, void* stream) {
  if (!trav::view_ok(*bvh) || chunk < 1 || p->spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const mk::FusedArgs a{*p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n,
                          out, nullptr, nullptr, nullptr, block, chunk, next,
                          static_cast<cudaStream_t>(stream), {}, nullptr, nullptr};
    return static_cast<int>(bvh->width == 4 ? g2::launch_w4(a) : g2::launch<8>(a));
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K5 at tree width 4 or 8.
extern "C" int rt_render_fused_g2_attrs(int width, int* num_regs, int* local_bytes) {
  if (!trav::built_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = width == 4 ? g2::attributes_w4(&a) : g2::attributes<8>(&a);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
