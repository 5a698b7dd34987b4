// P-bitcast: id bitcasts and int (8,1) -> (8,128) broadcast-selects on the
// v5 tables, p1-p4, one [8, 128] tile each.
//
// Replaces scripts/bitcast_probe.py p1 (:48), p2 (:83), p3 (:116) and p4
// (:149) (TPU calls :69, :101, :136, :173). The wrapper, the plain PyTorch
// version and the entry point are raytracer_tpu_torch/probes/bitcast.py;
// the plain version reads the same bits (Tensor.view(torch.int32)), so the
// two agree bit for bit.
//
//   p1  row r0 (the first brute-force row) replicated to the 8 chains; lane
//       2k of every row takes the bits of record k's prim id (field 9), lane
//       2k+1 those of its material id (field 10), the other lanes 0
//   p2  best = where(x > k * 0.5, 100 + k, best) for k = 0..3 from -1
//   p3  chain s reads node s (row s // 4, record s % 4: the select chain of
//       _select_record is a record offset here); lane k < 4 takes the bits
//       of its child code k, the other lanes 0
//   p4  p1's row: lane c takes the bits of record c % 8's prim id (best)
//       and material id (mat)
//
// The ids in the tables are float-encoded (v5_tables.pack_tables, the TPU
// kernel's _pack_tables), so their bits are float bit patterns: p1, p3 and
// p4 reproduce the script's bitcast, __float_as_int, and not the f2i the
// traversal converts ids with.
//
// Mapping: one block of 8 warps, warp s is row s, thread l owns lanes l,
// l+32, l+64, l+96 (probe.cuh). What bounds it: the launch; a tile reads at
// most 8 table rows.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_bitcast {

using namespace probe;

enum Case { P1, P2, P3, P4, N_CASES };

// tab: the triangle table (p1, p4), the node table (p3), or x f32[8, 128]
// (p2); r0: p1's and p4's row; o0, o1: i32[8, 128] (o1: p4's mat).
template <int C>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_bitcast_kernel(const float* __restrict__ tab, int r0, int* __restrict__ o0,
                         int* __restrict__ o1) {
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int c = lane + 32 * j;
    const size_t i = static_cast<size_t>(s) * ROW + c;
    if constexpr (C == P1 || C == P4) {
      const float* row = tab + static_cast<size_t>(r0) * ROW;
      int acc = 0, best = -1, mat = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int id0 = __float_as_int(row[k * TRI_STRIDE + 9]);
        const int id1 = __float_as_int(row[k * TRI_STRIDE + 10]);
        if constexpr (C == P1) {
          acc = c == 2 * k ? id0 : acc;
          acc = c == 2 * k + 1 ? id1 : acc;
        } else {
          const bool ok = floormod(c, 8) == k;
          best = ok ? id0 : best;
          mat = ok ? id1 : mat;
        }
      }
      if constexpr (C == P1) {
        o0[i] = acc;
      } else {
        o0[i] = best;
        o1[i] = mat;
      }
    } else if constexpr (C == P2) {
      const float x = tab[i];
      int best = -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) best = x > static_cast<float>(k) * 0.5f ? 100 + k : best;
      o0[i] = best;
    } else {
      const float* nrec = tab + static_cast<size_t>(floordiv(s, 4)) * ROW +
                          NODE_STRIDE * floormod(s, 4);
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = c == k ? __float_as_int(nrec[24 + k]) : acc;
      o0[i] = acc;
    }
  }
}

using KernelFn = void (*)(const float*, int, int*, int*);

KernelFn kernel_of(int c) {
  switch (c) {
    case P1: return probe_bitcast_kernel<P1>;
    case P2: return probe_bitcast_kernel<P2>;
    case P3: return probe_bitcast_kernel<P3>;
    default: return probe_bitcast_kernel<P4>;
  }
}

}  // namespace probe_bitcast

extern "C" int rt_probe_bitcast(int c, const float* tab, int r0, int* o0, int* o1,
                                void* stream) {
  using namespace probe_bitcast;
  if (c < 0 || c >= N_CASES || r0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel_of(c)<<<1, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(tab, r0, o0, o1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_bitcast_attrs(int c, int* num_regs, int* local_bytes) {
  using namespace probe_bitcast;
  if (c < 0 || c >= N_CASES) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(c));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
