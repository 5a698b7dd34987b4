// P-morph entry points and the kernels of variants 0-6, v0_ablate ..
// v0_noclamp (the kernel and its design: probe_morph.cuh).
#include "probe_morph.cuh"

using namespace probe_morph;

namespace probe_morph {

KernelFn part1_kernel(int variant) {
  switch (variant) {
    case 0: return probe_morph_kernel<FORI, false, false, false, true>;     // v0_ablate
    case 1: return probe_morph_kernel<WHILE, false, false, false, true>;    // v1_while
    case 2: return probe_morph_kernel<WHILE, true, false, false, true>;     // v2_outs6
    case 3: return probe_morph_kernel<WHILE, true, true, false, true>;      // v3_rootinit
    case 4: return probe_morph_kernel<WHILE, true, true, true, true>;       // v4_brute
    case 5: return probe_morph_kernel<WHILE, true, true, true, false>;      // v5_noclamp
    case 6: return probe_morph_kernel<FORI, false, false, false, false>;    // v0_noclamp
    default: return nullptr;
  }
}

}  // namespace probe_morph

namespace {

KernelFn kernel_of(int variant) {
  const KernelFn k = part1_kernel(variant);
  return k ? k : part2_kernel(variant);
}

}  // namespace

// The outputs of `variant` (morph.VARIANTS order) over the v5 tables node /
// tri f32[rows, 128] (zero_row the trailing all-zero row, the n_brute_rows
// before it the brute-force rows) for rays o / d f32[packets, 3, 8, 128] and
// limits tlim f32[packets, 8, 128]: t f32[packets, 8, 128] and, for the
// six-output variants, id and mat i32, nx, ny, nz f32 (else nullptr); iters
// i32[packets], the iterations each packet's loop ran. iters is the fixed
// count of the counted loops, max_iters the guard of the alive-count loop.
extern "C" int rt_probe_morph(const float* node, const float* tri, const float* o,
                              const float* d, const float* tlim, int zero_row, int n_brute_rows,
                              int stack_cap, int iters, int max_iters, int packets, int variant,
                              float* t, int* id, int* mat, float* nx, float* ny, float* nz,
                              int* pk_iters, void* stream) {
  if (variant < 0 || variant >= N_VARIANTS || packets < 0 || iters < 0 || max_iters < 0 ||
      n_brute_rows < 0 || zero_row < n_brute_rows || stack_cap < 4 || stack_cap > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * P_SUB * static_cast<size_t>(stack_cap);
  if (packets > 0)
    kernel_of(variant)<<<packets, P_SUB * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, tlim, zero_row, n_brute_rows, stack_cap, iters, max_iters, t, id, mat,
        nx, ny, nz, pk_iters);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of a variant's kernel.
extern "C" int rt_probe_morph_attrs(int variant, int* num_regs, int* local_bytes) {
  if (variant < 0 || variant >= N_VARIANTS) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(variant));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
