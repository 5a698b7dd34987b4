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
//   colbcast      x * x[:, 3:4]; x[s, 3] is lane 0's fourth word
//   lanesum       x + sum(x, axis=1): the thread's 4 lanes in order, then a
//                 5-step __shfl_xor_sync butterfly
//   packsum       the packed int sum (x > 0) + ((x < -0.5) << 16) of a row
//                 (__reduce_add_sync), split into its halves lo * 1000 + hi
//   concat        row 0 replicated to 8 rows, times its lane 5 (lane 1's
//                 second word)
//   bitcast       the int32 bits of lanes 25 and 26 (record 1, fields 9:11)
//                 of each row, which are denormal floats: moved as bits with
//                 __float_as_int, no float arithmetic touches them
//   extract_smem  x[s, 7] > 0 for the whole row. The script's SMEM is the
//                 TPU scalar unit's memory; the card's counterpart of a
//                 scalar handed to every vector lane is a warp-uniform value,
//                 tested by lane 0 and broadcast with __shfl_sync
//   dynload       row s of tab[idx[s, 0]], the index read by lane 0 and
//                 broadcast (clamped into the table as jax.lax.dynamic_slice
//                 clamps)
//
// Mapping (probe_tile.cuh): one block of 8 warps, warp s is row s, thread l
// owns the adjacent lanes 4l..4l+3: one 128-bit load and one 128-bit store
// per row, a scalar read once per warp and broadcast. What bounds it: the
// launch (its bound is 0.0000024 ms of bytes); the design keeps the body to
// one access each way, so the card's time is the launch's.
#include <cuda_runtime.h>

#include "probe.cuh"
#include "probe_tile.cuh"

namespace probe_mosaic {

using probe::FULL;
using probe::P_SUB;
using probe::ROW;
using probe::TRI_STRIDE;

enum Case { COLBCAST, LANESUM, PACKSUM, CONCAT, BITCAST, EXTRACT_SMEM, DYNLOAD, N_CASES };

__device__ __forceinline__ int pack(float v) {
  return (v > 0.0f ? 1 : 0) + probe::shl16(v < -0.5f ? 1 : 0);
}

// x: f32[8, 128] (dynload: tab f32[rows, 128]), 16-byte aligned; idx:
// i32[8, 128] (dynload only); out: f32 or i32 [8, 128].
template <int C>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_mosaic_kernel(const float* __restrict__ x, const int* __restrict__ idx, int rows,
                        void* out) {
  using namespace tile;
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* row = x + s * ROW;
  float* fo = static_cast<float*>(out) + s * ROW;
  int* io = static_cast<int*>(out) + s * ROW;
  if constexpr (C == COLBCAST) {
    const float4 v = load4(row, lane);
    store4(fo, lane, mul(v, __shfl_sync(FULL, v.w, 0)));
  } else if constexpr (C == LANESUM) {
    const float4 v = load4(row, lane);
    float t = ((v.x + v.y) + v.z) + v.w;
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) t = t + __shfl_xor_sync(FULL, t, m);
    store4(fo, lane, add(v, t));
  } else if constexpr (C == PACKSUM) {
    const float4 v = load4(row, lane);
    const int a01 = __reduce_add_sync(FULL, ((pack(v.x) + pack(v.y)) + pack(v.z)) + pack(v.w));
    store4(io, lane, (a01 & 0xFFFF) * 1000 + (a01 >> 16));
  } else if constexpr (C == CONCAT) {
    const float4 v = load4(x, lane);
    store4(fo, lane, mul(v, __shfl_sync(FULL, v.y, 1)));
  } else if constexpr (C == BITCAST) {
    int id0 = 0, id1 = 0;
    if (lane == 0) {
      id0 = __float_as_int(row[TRI_STRIDE + 9]);
      id1 = __float_as_int(row[TRI_STRIDE + 10]);
    }
    id0 = __shfl_sync(FULL, id0, 0);
    id1 = __shfl_sync(FULL, id1, 0);
    store4(io, lane, id0 + 0 * id1);
  } else if constexpr (C == EXTRACT_SMEM) {
    const int b = lane == 0 ? (row[7] > 0.0f ? 1 : 0) : 0;
    store4(io, lane, __shfl_sync(FULL, b, 0));
  } else {
    const int r0 = lane == 0 ? idx[s * ROW] : 0;
    const int r = min(max(__shfl_sync(FULL, r0, 0), 0), rows - 1);
    store4(fo, lane, load4(x + static_cast<size_t>(r) * ROW, lane));
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
