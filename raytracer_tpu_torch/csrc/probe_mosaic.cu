// P-mosaic: the seven single-primitive kernels of the Mosaic probe, one
// [8, 128] tile each.
//
// Replaces scripts/mosaic_probe.py run (:21; TPU call :22) and its kernels
// (:44-145). The wrapper, the plain PyTorch version and the entry point are
// raytracer_tpu_torch/probes/mosaic.py; the plain version takes the same
// operations in the same order (the lane sum's too), so the two agree bit
// for bit, and both are held to the script's NumPy expectation at rtol /
// atol 1e-5.
//
//   colbcast      x * x[:, 3:4]
//   lanesum       x + sum(x, axis=1): the thread's 4 lanes in order, then a
//                 __shfl_xor_sync butterfly
//   packsum       the packed int sum (x > 0) + ((x < -0.5) << 16) of a row,
//                 split into its halves lo * 1000 + hi
//   concat        row 0 replicated to 8 rows, times its lane 5
//   bitcast       the int32 bits of lanes 25 and 26 (record 1, fields 9:11)
//                 of each row, which are denormal floats: moved as bits with
//                 __float_as_int, no float arithmetic touches them
//   extract_smem  x[s, 7] > 0 written to shared memory by lane 0 of warp s,
//                 read back by every lane of the row
//   dynload       row s of tab[idx[s, 0]], the index staged in shared memory
//                 (clamped into the table as jax.lax.dynamic_slice clamps)
//
// Mapping: one block of 8 warps, warp s is row s, thread l owns lanes l,
// l+32, l+64, l+96 (probe.cuh). What bounds it: the launch; each case does
// at most a few operations per element on 4 KiB (dynload: 8 rows of the
// table).
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_mosaic {

using namespace probe;

enum Case { COLBCAST, LANESUM, PACKSUM, CONCAT, BITCAST, EXTRACT_SMEM, DYNLOAD, N_CASES };

// x: f32[8, 128] (dynload: tab f32[rows, 128]); idx: i32[8, 128] (dynload
// only); out: f32 or i32 [8, 128].
template <int C>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_mosaic_kernel(const float* __restrict__ x, const int* __restrict__ idx, int rows,
                        void* out) {
  __shared__ int sm[P_SUB];
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* row = x + s * ROW;
  float* fo = static_cast<float*>(out) + s * ROW;
  int* io = static_cast<int*>(out) + s * ROW;
  if constexpr (C == COLBCAST) {
    const float col = row[3];
#pragma unroll
    for (int j = 0; j < LPT; ++j) fo[lane + 32 * j] = row[lane + 32 * j] * col;
  } else if constexpr (C == LANESUM) {
    float v = row[lane];
#pragma unroll
    for (int j = 1; j < LPT; ++j) v = v + row[lane + 32 * j];
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(FULL, v, m);
#pragma unroll
    for (int j = 0; j < LPT; ++j) fo[lane + 32 * j] = row[lane + 32 * j] + v;
  } else if constexpr (C == PACKSUM) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const float v = row[lane + 32 * j];
      cnt += (v > 0.0f ? 1 : 0) + shl16(v < -0.5f ? 1 : 0);
    }
    const int a01 = warp_sum(cnt);
    const int lo = a01 & 0xFFFF, hi = a01 >> 16;
#pragma unroll
    for (int j = 0; j < LPT; ++j) io[lane + 32 * j] = lo * 1000 + hi;
  } else if constexpr (C == CONCAT) {
    const float c5 = x[5];
#pragma unroll
    for (int j = 0; j < LPT; ++j) fo[lane + 32 * j] = x[lane + 32 * j] * c5;
  } else if constexpr (C == BITCAST) {
    const int id0 = __float_as_int(row[TRI_STRIDE + 9]);
    const int id1 = __float_as_int(row[TRI_STRIDE + 10]);
#pragma unroll
    for (int j = 0; j < LPT; ++j) io[lane + 32 * j] = id0 + 0 * id1;
  } else if constexpr (C == EXTRACT_SMEM) {
    if (lane == 0) sm[s] = row[7] > 0.0f ? 1 : 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < LPT; ++j) io[lane + 32 * j] = sm[s];
  } else {
    if (lane == 0) sm[s] = idx[s * ROW];
    __syncthreads();
    const int r = min(max(sm[s], 0), rows - 1);
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      fo[lane + 32 * j] = x[static_cast<size_t>(r) * ROW + lane + 32 * j];
  }
}

using KernelFn = void (*)(const float*, const int*, int, void*);

KernelFn kernel_of(int c) {
  switch (c) {
    case COLBCAST: return probe_mosaic_kernel<COLBCAST>;
    case LANESUM: return probe_mosaic_kernel<LANESUM>;
    case PACKSUM: return probe_mosaic_kernel<PACKSUM>;
    case CONCAT: return probe_mosaic_kernel<CONCAT>;
    case BITCAST: return probe_mosaic_kernel<BITCAST>;
    case EXTRACT_SMEM: return probe_mosaic_kernel<EXTRACT_SMEM>;
    default: return probe_mosaic_kernel<DYNLOAD>;
  }
}

}  // namespace probe_mosaic

extern "C" int rt_probe_mosaic(int c, const float* x, const int* idx, int rows, void* out,
                               void* stream) {
  using namespace probe_mosaic;
  if (c < 0 || c >= N_CASES || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel_of(c)<<<1, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(x, idx, rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_mosaic_attrs(int c, int* num_regs, int* local_bytes) {
  using namespace probe_mosaic;
  if (c < 0 || c >= N_CASES) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(c));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
