// P-v8 entry points and the kernels of full, no_fetch and no_leaf (the
// kernel and its design: probe_v8.cuh).
#include "probe_v8.cuh"

using namespace probe_v8;

namespace {

KernelFn kernel_of(int variant) {
  switch (variant) {
    case FULL_BODY: return probe_v8_kernel<FULL_BODY>;
    case NO_FETCH: return probe_v8_kernel<NO_FETCH>;
    case NO_LEAF: return probe_v8_kernel<NO_LEAF>;
    default: return part2_kernel(variant);
  }
}

}  // namespace

// t f32[packets, 8, 128] of `iters` iterations of variant `variant`
// (probes/ablate_v8.VARIANTS order) over node f32[n_nodes, 128], tri
// f32[n_trirows, 128], o / d f32[packets, 3, 8, 128].
extern "C" int rt_probe_v8(const float* node, const float* tri, const float* o, const float* d,
                           int n_nodes, int n_trirows, int iters, int packets, int variant,
                           float* out, void* stream) {
  if (variant < 0 || variant >= N_VARIANTS || n_nodes < P_SUB || n_trirows < P_SUB || iters < 0 ||
      packets < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = kernel_of(variant);
  if (packets > 0)
    k<<<packets, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, n_nodes, n_trirows, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of a variant's kernel.
extern "C" int rt_probe_v8_attrs(int variant, int* num_regs, int* local_bytes) {
  if (variant < 0 || variant >= N_VARIANTS) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(variant));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
