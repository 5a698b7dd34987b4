// P-ablate / P-load / P-floor / P-base entry points and the kernels of chain
// width W = 1 of modes full .. loads0 (the kernel and its design:
// probe_v5.cuh).
#include "probe_v5.cuh"

using namespace probe_v5;

namespace {

KernelFn kernel_of(int mode, int w) {
  if (mode < 0 || mode >= N_MODES) return nullptr;
  switch (w) {
    case 1: return mode < SPLIT ? kernels_in<1, 0, SPLIT>(mode) : kernel_w1_hi(mode);
    case 2: return kernel_w2(mode);
    case 4: return kernel_w4(mode);
    default: return nullptr;
  }
}

}  // namespace

// The chain width the entry point takes for `packets` packets of `mode` on
// the current card: the widest W the mode admits that keeps the card at
// WARPS_PER_SM warps per SM or fewer (probes/common.pick_w), 1 where none
// does; <= 0 on an error (a CUDA error code, negated).
extern "C" int rt_probe_v5_pick_w(int packets, int mode) {
  if (mode < 0 || mode >= N_MODES || packets < 0) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const long long warps = static_cast<long long>(packets) * P_SUB;
  for (int w = 4; w > 1; w >>= 1)
    if (kernel_of(mode, w) != nullptr && warps * w <= static_cast<long long>(WARPS_PER_SM) * sms)
      return w;
  return 1;
}

// t f32[packets, 8, 128] of `iters` iterations of mode `mode` at chain width
// w (1, 2 or 4) over the v5 tables node f32[rows, 128] and tri f32[rows,
// 128] (both 16-byte aligned; zero_row the trailing all-zero row), rays o /
// d f32[packets, 3, 8, 128], limits tlim f32[packets, 8, 128].
// cudaErrorInvalidValue for a w the mode does not admit.
extern "C" int rt_probe_v5_w(const float* node, const float* tri, const float* o, const float* d,
                             const float* tlim, int zero_row, int iters, int packets, int mode,
                             int w, float* out, void* stream) {
  const KernelFn k = kernel_of(mode, w);
  if (k == nullptr || iters < 0 || packets < 0 || zero_row < 0 ||
      (reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(tri)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_of(mode, w);
  if (packets > 0)
    k<<<packets * P_SUB * 32 * w / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, tlim, zero_row, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// As rt_probe_v5_w, at the chain width rt_probe_v5_pick_w takes.
extern "C" int rt_probe_v5(const float* node, const float* tri, const float* o, const float* d,
                           const float* tlim, int zero_row, int iters, int packets, int mode,
                           float* out, void* stream) {
  const int w = rt_probe_v5_pick_w(packets, mode);
  if (w <= 0) return -w;
  return rt_probe_v5_w(node, tri, o, d, tlim, zero_row, iters, packets, mode, w, out, stream);
}

// Registers and local memory (bytes per thread) of a mode's kernel at chain
// width w; cudaErrorInvalidValue for a w the mode does not admit.
extern "C" int rt_probe_v5_attrs_w(int mode, int w, int* num_regs, int* local_bytes) {
  const KernelFn k = kernel_of(mode, w);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}

// Registers and local memory of a mode's kernel at W = 1, the width of a
// full card.
extern "C" int rt_probe_v5_attrs(int mode, int* num_regs, int* local_bytes) {
  return rt_probe_v5_attrs_w(mode, 1, num_regs, local_bytes);
}
