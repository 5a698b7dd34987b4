// P-morph entry points and the kernels of chain width W = 1 of variants 0-6,
// v0_ablate .. v0_noclamp (the kernel and its design: probe_morph.cuh).
#include "probe_morph.cuh"

using namespace probe_morph;

namespace {

KernelFn kernel_of(int variant, int w) {
  if (variant < 0 || variant >= N_VARIANTS) return nullptr;
  switch (w) {
    case 1: return variant < SPLIT ? kernels_in<1, 0, SPLIT>(variant) : kernel_w1_hi(variant);
    case 2: return kernel_w2(variant);
    case 4: return kernel_w4(variant);
    default: return nullptr;
  }
}

}  // namespace

// The outputs of `variant` (morph.VARIANTS order) at chain width w (1, 2 or
// 4) over the v5 tables node / tri f32[rows, 128] (both 16-byte aligned;
// zero_row the trailing all-zero row, the n_brute_rows before it the
// brute-force rows) for rays o / d f32[packets, 3, 8, 128] and limits tlim
// f32[packets, 8, 128]: t f32[packets, 8, 128] and, for the six-output
// variants, id and mat i32, nx, ny, nz f32 (else nullptr); iters
// i32[packets], the iterations each packet's loop ran (a `while` variant's
// the largest of its chains', which this entry point zeroes before the
// launch). iters is the fixed count of the counted loops, max_iters the
// guard of the alive-count loop. cudaErrorInvalidValue for a w the variant
// does not admit. The caller picks w (probes/morph.chosen_w).
extern "C" int rt_probe_morph_w(const float* node, const float* tri, const float* o,
                                const float* d, const float* tlim, int zero_row, int n_brute_rows,
                                int stack_cap, int iters, int max_iters, int packets, int variant,
                                int w, float* t, int* id, int* mat, float* nx, float* ny,
                                float* nz, int* pk_iters, void* stream) {
  const KernelFn k = kernel_of(variant, w);
  if (k == nullptr || packets < 0 || iters < 0 || max_iters < 0 || n_brute_rows < 0 ||
      zero_row < n_brute_rows || stack_cap < 4 || stack_cap > 4096 ||
      (reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(tri)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int loop = SPECS[variant].loop;
  const int threads = block_of(loop, w);
  const size_t smem = sizeof(int) * (threads / 32) * static_cast<size_t>(stack_cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packets == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess && loop == WHILE)
    e = cudaMemsetAsync(pk_iters, 0, sizeof(int) * static_cast<size_t>(packets), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<packets * P_SUB * 32 * w / threads, threads, smem, s>>>(
      node, tri, o, d, tlim, zero_row, n_brute_rows, stack_cap, iters, max_iters, t, id, mat, nx,
      ny, nz, pk_iters);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of a variant's kernel at
// chain width w; cudaErrorInvalidValue for a w the variant does not admit.
extern "C" int rt_probe_morph_attrs_w(int variant, int w, int* num_regs, int* local_bytes) {
  const KernelFn k = kernel_of(variant, w);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
