// K3 and K3-profile (megakernel.cuh): the C entry points, which dispatch on
// the tree width (8 here, 4 in megakernel_w4.cu), and K3-profile's aux
// plane.
//
// The aux plane ([N/1024, 8, 128]): row 0 is the packet's lockstep bill ON
// THE CARD — the sum over its 32 warps of the largest lane total of K1
// steps in the warp, since the warp is what runs in lockstep here, where
// the TPU summed over traversal calls the largest of its 8 sub-warp
// chains; row 1 is the packet's outer path iterations, the largest lane
// iteration count (the TPU's `path_iters - out[0]`); rows 2-7 are zero.
#include <cuda_runtime.h>

#include "megakernel.cuh"

namespace {

constexpr int PACKET = 1024;   // lanes of one aux packet (8 x 128 on the TPU)
constexpr int WARP = 32;

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

cudaError_t launch_fused(bool profile, const mk::FusedArgs& a) {
  if (a.bvh.width == 4) return mk::launch_w4(profile, a);
  return profile ? mk::launch<8, true>(a) : mk::launch<8, false>(a);
}

}  // namespace

cudaError_t mk::packet_bill(const int* k1_steps, const int* path_iters, int n, float* aux,
                            cudaStream_t stream) {
  const int g = n / PACKET;
  packet_bill_kernel<<<(g + 127) / 128, 128, 0, stream>>>(k1_steps, path_iters, g, aux);
  return cudaGetLastError();
}

// `chunk` lanes per take from the lane list; `next` an int on the card, 0
// before the launch (the wrapper's torch.zeros).
extern "C" int rt_render_fused(const FusedParams* p, const trav::BvhView* bvh, const int* pix,
                               const int* px, const int* py, const float* sph, const int* sph_mat,
                               const float* mat, const int* mat_type, int n, float* out,
                               int block, int chunk, int* next, void* stream) {
  if (!trav::view_ok(*bvh) || chunk < 1 || p->spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const mk::FusedArgs a{*p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n,
                          out, nullptr, nullptr, nullptr, block, chunk, next,
                          static_cast<cudaStream_t>(stream), {}, nullptr, nullptr};
    return static_cast<int>(launch_fused(false, a));
  }
  return static_cast<int>(cudaGetLastError());
}

// K3-profile: radiance sums (out, [n, 3]), cost [n], aux [n] (n % 1024 == 0);
// k1_steps and path_iters are [n] int scratch the wrapper allocates;
// chunk and next as rt_render_fused's.
extern "C" int rt_render_fused_profile(const FusedParams* p, const trav::BvhView* bvh,
                                       const int* pix, const int* px, const int* py,
                                       const float* sph, const int* sph_mat, const float* mat,
                                       const int* mat_type, int n, float* out, float* cost,
                                       int* k1_steps, int* path_iters, float* aux, int block,
                                       int chunk, int* next, void* stream) {
  if (!trav::view_ok(*bvh) || n % PACKET != 0 || chunk < 1 || p->spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const mk::FusedArgs a{*p, *bvh, pix, px, py, path::Tables{sph, sph_mat, mat, mat_type}, n,
                          out, cost, k1_steps, path_iters, block, chunk, next, s, {}, nullptr,
                          nullptr};
    const cudaError_t e = launch_fused(true, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(mk::packet_bill(k1_steps, path_iters, n, aux, s));
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K3 (profile = 0) or
// K3-profile (profile = 1) at tree width 4 or 8, as cudaFuncGetAttributes
// reports them.
extern "C" int rt_render_fused_attrs(int width, int profile, int* num_regs, int* local_bytes) {
  if (!trav::built_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = width == 4 ? mk::attributes_w4(profile != 0, &a)
                        : profile  ? mk::attributes<8, true>(&a)
                                   : mk::attributes<8, false>(&a);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
