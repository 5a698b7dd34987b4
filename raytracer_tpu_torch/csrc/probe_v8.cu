// P-v8 entry points and the kernels of chain width W = 1 (the kernel and its
// design: probe_v8.cuh).
#include "probe_v8.cuh"

using namespace probe_v8;

namespace {

KernelFn kernel_of(int variant, int w) {
  if (variant < 0 || variant >= N_VARIANTS) return nullptr;
  switch (w) {
    case 1: return kernel_at<1>(variant);
    case 2: return kernel_w2(variant);
    case 4: return kernel_w4(variant);
    default: return nullptr;
  }
}

}  // namespace

// The chain width the entry point takes for `packets` packets of `variant`
// on the current card: the widest admitted W that keeps the card at
// WARPS_PER_SM warps per SM or fewer (probes/common.pick_w), 1 where none
// does; <= 0 on an error (a CUDA error code, negated).
extern "C" int rt_probe_v8_pick_w(int packets, int variant) {
  if (variant < 0 || variant >= N_VARIANTS || packets < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const long long warps = static_cast<long long>(packets) * P_SUB;
  for (int w = 4; w > 1; w >>= 1)
    if (admits(w) && warps * w <= static_cast<long long>(WARPS_PER_SM) * sms) return w;
  return 1;
}

// t f32[packets, 8, 128] of `iters` iterations of variant `variant`
// (probes/ablate_v8.VARIANTS order) at chain width w (1, 2 or 4) over node
// f32[n_nodes, 128], tri f32[n_trirows, 128] (both 16-byte aligned), o / d
// f32[packets, 3, 8, 128]. cudaErrorInvalidValue for a w not admitted.
extern "C" int rt_probe_v8_w(const float* node, const float* tri, const float* o, const float* d,
                             int n_nodes, int n_trirows, int iters, int packets, int variant,
                             int w, float* out, void* stream) {
  const KernelFn k = kernel_of(variant, w);
  if (k == nullptr || n_nodes < P_SUB || n_trirows < P_SUB || iters < 0 || packets < 0 ||
      (reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(tri)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (packets > 0)
    k<<<packets * w, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(node, tri, o, d, n_nodes,
                                                                   n_trirows, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// As rt_probe_v8_w, at the chain width rt_probe_v8_pick_w takes.
extern "C" int rt_probe_v8(const float* node, const float* tri, const float* o, const float* d,
                           int n_nodes, int n_trirows, int iters, int packets, int variant,
                           float* out, void* stream) {
  const int w = rt_probe_v8_pick_w(packets, variant);
  if (w <= 0) return -w;
  return rt_probe_v8_w(node, tri, o, d, n_nodes, n_trirows, iters, packets, variant, w, out,
                       stream);
}

// Registers and local memory (bytes per thread) of a variant's kernel at
// chain width w; cudaErrorInvalidValue for a w not admitted.
extern "C" int rt_probe_v8_attrs_w(int variant, int w, int* num_regs, int* local_bytes) {
  const KernelFn k = kernel_of(variant, w);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}

// Registers and local memory of a variant's kernel at W = 1, the width of a
// full card.
extern "C" int rt_probe_v8_attrs(int variant, int* num_regs, int* local_bytes) {
  return rt_probe_v8_attrs_w(variant, 1, num_regs, local_bytes);
}
