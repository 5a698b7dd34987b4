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
// Mapping (probe_tile.cuh): one block of 8 warps, warp s is row s, thread l
// owns the adjacent lanes 4l..4l+3 and writes them with one 128-bit store.
// Record k's ids sit at floats 16k + 9 and 16k + 10 of row r0, an odd offset
// no 8-byte load reaches; fields 8-11 are one 16-byte aligned word. So in
// p1 and p4 lanes 0-7 of a warp each load one record's word (8 loads a
// warp), and the ids reach the threads that store them by __shfl_sync. p3's child codes are fields
// 24-27 of a node record, 16-byte aligned: thread 0 of a warp loads them as
// one word. What bounds it: the launch (the bound is 0.0000012-0.0000025 ms
// of bytes, mostly the output tiles); the body is at most one load and one
// shuffle round before each thread's store.
#include <cuda_runtime.h>

#include "probe.cuh"
#include "probe_tile.cuh"

namespace probe_bitcast {

using probe::FULL;
using probe::NODE_STRIDE;
using probe::P_SUB;
using probe::ROW;
using probe::TRI_STRIDE;

enum Case { P1, P2, P3, P4, N_CASES };

__device__ __forceinline__ void store4(int* row, int lane, int4 v) {
  reinterpret_cast<int4*>(row)[lane] = v;
}

// Record k's (prim id, material id) bits, k = lane & 7, read by lanes 0-7
// as fields 8-11 of row `row` and held by every lane l as record l & 7's.
__device__ __forceinline__ int2 record_ids(const float* __restrict__ row, int lane) {
  int2 ids = make_int2(0, 0);
  if (lane < 8) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(row + lane * TRI_STRIDE + 8));
    ids = make_int2(__float_as_int(f.y), __float_as_int(f.z));
  }
  return ids;
}

// tab: the triangle table (p1, p4), the node table (p3), or x f32[8, 128]
// (p2), 16-byte aligned; r0: p1's and p4's row; o0, o1: i32[8, 128] (o1:
// p4's mat).
template <int C>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_bitcast_kernel(const float* __restrict__ tab, int r0, int* __restrict__ o0,
                         int* __restrict__ o1) {
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* row0 = o0 + s * ROW;
  if constexpr (C == P2) {
    const float4 v = tile::load4(tab + s * ROW, lane);
    const float x[4] = {v.x, v.y, v.z, v.w};
    int best[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        best[i] = x[i] > static_cast<float>(k) * 0.5f ? 100 + k : best[i];
      }
    }
    store4(row0, lane, make_int4(best[0], best[1], best[2], best[3]));
  } else if constexpr (C == P3) {
    // Node s: row s / 4, record s % 4; its child codes are fields 24-27.
    int4 ch = make_int4(0, 0, 0, 0);
    if (lane == 0) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(
          tab + (s >> 2) * ROW + NODE_STRIDE * (s & 3) + 24));
      ch = make_int4(__float_as_int(f.x), __float_as_int(f.y), __float_as_int(f.z),
                     __float_as_int(f.w));
    }
    store4(row0, lane, ch);
  } else {
    const int2 ids = record_ids(tab + static_cast<size_t>(r0) * ROW, lane);
    if constexpr (C == P1) {
      // Thread l < 4 holds lanes 4l..4l+3: records 2l and 2l + 1.
      const int k = (2 * lane) & 7;
      const int a0 = __shfl_sync(FULL, ids.x, k), a1 = __shfl_sync(FULL, ids.y, k);
      const int b0 = __shfl_sync(FULL, ids.x, k + 1), b1 = __shfl_sync(FULL, ids.y, k + 1);
      store4(row0, lane, lane < 4 ? make_int4(a0, a1, b0, b1) : make_int4(0, 0, 0, 0));
    } else {
      // Lane 4l + i has c % 8 = 4 (l & 1) + i: records 4 (l & 1)..+3.
      const int k = 4 * (lane & 1);
      int best[4], mat[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        best[i] = __shfl_sync(FULL, ids.x, k + i);
        mat[i] = __shfl_sync(FULL, ids.y, k + i);
      }
      store4(row0, lane, make_int4(best[0], best[1], best[2], best[3]));
      store4(o1 + s * ROW, lane, make_int4(mat[0], mat[1], mat[2], mat[3]));
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
