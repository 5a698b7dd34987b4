// P-ablate / P-load / P-floor / P-base entry points and the kernels of full, no_leaf,
// no_internal, no_scalar, no_fetch and full16 (the kernel and its design:
// probe_v5.cuh).
#include "probe_v5.cuh"

using namespace probe_v5;

namespace {

KernelFn kernel_of(int mode) {
  switch (mode) {
    case FULL_BODY: return probe_v5_kernel<FULL_BODY>;
    case NO_LEAF: return probe_v5_kernel<NO_LEAF>;
    case NO_INTERNAL: return probe_v5_kernel<NO_INTERNAL>;
    case NO_SCALAR: return probe_v5_kernel<NO_SCALAR>;
    case NO_FETCH: return probe_v5_kernel<NO_FETCH>;
    case FULL16: return probe_v5_kernel<FULL16>;
    default: return part2_kernel(mode);
  }
}

}  // namespace

// t f32[packets, 8, 128] of `iters` iterations of mode `mode` over the v5
// tables node f32[rows, 128] and tri f32[rows, 128] (zero_row its trailing
// all-zero row), rays o / d f32[packets, 3, 8, 128], limits tlim
// f32[packets, 8, 128].
extern "C" int rt_probe_v5(const float* node, const float* tri, const float* o, const float* d,
                           const float* tlim, int zero_row, int iters, int packets, int mode,
                           float* out, void* stream) {
  if (mode < 0 || mode >= N_MODES || iters < 0 || packets < 0 || zero_row < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = kernel_of(mode);
  if (packets > 0)
    k<<<packets, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, tlim, zero_row, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of a mode's kernel.
extern "C" int rt_probe_v5_attrs(int mode, int* num_regs, int* local_bytes) {
  if (mode < 0 || mode >= N_MODES) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(mode));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
