// P-feature: one kernel construct of the traversal kernel per stage, s1-s6,
// on [8, 128] tiles.
//
// Replaces scripts/kernel_feature_probe.py s1 (:36) .. s6 (:196) (TPU calls
// :46, :72, :103, :142, :186, :232). The wrapper, the plain PyTorch version
// and the entry point are raytracer_tpu_torch/probes/feature.py, whose plain
// version takes the same operations in the same order, so the two agree bit
// for bit; s7 runs K4 (trace_closest.cu) and has no kernel here.
//
//   s1  six outputs, x + i, written as six consecutive tiles of one buffer
//   s2  a loop over the packets inside the block, each x * 2; each thread
//       covers its 4 lanes of every packet, four packets' loads at a time
//   s3  a while loop whose trip count n the kernel reads from a device
//       int32[1], acc += x per trip
//   s4  a task array in shared memory mutated inside a block-wide while
//       loop that runs while sum(task > 1) over the 8 chains is > 0
//       (__syncthreads_count of lane 0's test); acc += x per trip
//   s5  a stack in shared memory pushed at dynamic indices (16 pushes, one
//       or two stores each) by thread 0, then popped 8 times, every lane
//       adding the popped values
//   s6  the table's first 16 rows (8 KiB, all that floormod(t, 16) can
//       reach) staged in shared memory by one TMA bulk copy on an mbarrier;
//       inside a 6-trip loop chain s then reads row floormod(t, 16) (row 0
//       for t < 0) and its record floormod(t, 4) of 32 lanes from shared
//       memory, t the chain's task in shared memory, which steps down
//       through negative values: jnp's % is a floor mod, C's % is not
//
// Mapping (probe_tile.cuh): one block of 8 warps, warp s is row s, thread l
// owns the adjacent lanes 4l..4l+3, one 128-bit load of x and one 128-bit
// store per row and output; what the script keeps in SMEM lives in shared
// memory, written by one lane and read after a barrier. What bounds it: the
// launch (its bound is 0.0000098 ms of bytes, s2's); each stage does a few
// operations per element.
#include <cuda_runtime.h>

#include "probe.cuh"
#include "probe_tile.cuh"

namespace probe_feature {

using probe::floormod;
using probe::P_SUB;
using probe::ROW;

enum Case { S1, S2, S3, S4, S5, S6, N_CASES };
constexpr int S4_N0 = 8, S5_PUSHES = 16, S5_POPS = 8, S5_STACK = 64, S6_TRIPS = 6;
constexpr int S2_BATCH = 4;  // s2's packets whose loads are in flight together
constexpr int S6_ROWS = 16;  // the rows floormod(t, 16) reaches

// x: the case's f32 input, 16-byte aligned ([8, 128]; s2: [packets, 8,
// 128]; s6: the table f32[rows >= 16, 128]); n: s3's trip count i32[1];
// out: the output, f32 (s1: its six outputs as consecutive tiles).
template <int C>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_feature_kernel(const float* __restrict__ x, const int* __restrict__ n, int packets,
                         float* out) {
  using namespace tile;
  __shared__ int s_task[P_SUB];
  __shared__ int s_sp, s_stack[S5_STACK];
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = s * ROW;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (C == S1) {
    const float4 v = load4(x + base, lane);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      store4(out + i * P_SUB * ROW + base, lane, add(v, static_cast<float>(i)));
    return;
  } else if constexpr (C == S2) {
    // Four packets' loads in flight before their stores (a store may alias
    // a later load for all the compiler knows), then the rest one by one.
    const size_t packet = P_SUB * ROW;
    int p = 0;
    for (; p + S2_BATCH <= packets; p += S2_BATCH) {
      float4 v[S2_BATCH];
#pragma unroll
      for (int k = 0; k < S2_BATCH; ++k) v[k] = load4(x + (p + k) * packet + base, lane);
#pragma unroll
      for (int k = 0; k < S2_BATCH; ++k)
        store4(out + (p + k) * packet + base, lane, mul(v[k], 2.0f));
    }
    for (; p < packets; ++p)
      store4(out + p * packet + base, lane, mul(load4(x + p * packet + base, lane), 2.0f));
    return;
  } else if constexpr (C == S3) {
    const float4 v = load4(x + base, lane);
    int i = n[0];
    while (i > 0) {
      acc = add(acc, v);
      i = i - 1;
    }
  } else if constexpr (C == S4) {
    const float4 v = load4(x + base, lane);
    if (lane == 0) s_task[s] = s + 3;
    __syncthreads();
    int alive = S4_N0;
    while (alive > 0) {
      const int t = s_task[s];
      __syncwarp();
      if (lane == 0) s_task[s] = t - 1;
      alive = __syncthreads_count(lane == 0 && t > 1);
      acc = add(acc, v);
    }
  } else if constexpr (C == S5) {
    const float4 v = load4(x + base, lane);
    if (threadIdx.x == 0) {
      s_sp = 0;
      for (int i = 0; i < S5_PUSHES; ++i) {
        const int sp = s_sp;
        const bool even = floormod(i, 2) == 0;
        s_stack[sp] = i;
        s_stack[sp + (even ? 1 : 0)] = i * 10;
        s_sp = sp + (even ? 2 : 1);
      }
    }
    __syncthreads();
    for (int i = 0; i < S5_POPS; ++i) {
      const int sp = s_sp;
      const int val = s_stack[max(sp - 1, 0)];
      __syncthreads();  // every thread has read sp before thread 0 moves it
      if (threadIdx.x == 0) s_sp = sp - 1;
      __syncthreads();
      acc = add(acc, static_cast<float>(val));
    }
    acc = make_float4(acc.x + 0.0f * v.x, acc.y + 0.0f * v.y, acc.z + 0.0f * v.z,
                      acc.w + 0.0f * v.w);
  } else {
    __shared__ __align__(128) float s_tab[S6_ROWS * ROW];
    __shared__ __align__(8) uint64_t s_bar;
    if (threadIdx.x == 0) bulk_load(s_tab, x, sizeof(s_tab), &s_bar);
    if (lane == 0) s_task[s] = floormod(5 * s, 17);
    __syncthreads();
    bulk_wait(&s_bar);
    for (int trip = S6_TRIPS; trip > 0; --trip) {
      const int t = s_task[s];
      const float* rec = s_tab + (t >= 0 ? floormod(t, 16) : 0) * ROW + 32 * floormod(t, 4);
      // output lane 4l + k takes record lane (4l + k) mod 32
      acc = add(acc, reinterpret_cast<const float4*>(rec)[lane & 7]);
      __syncwarp();
      if (lane == 0) s_task[s] = t - 1;
      __syncwarp();
    }
  }
  store4(out + base, lane, acc);
}

using KernelFn = void (*)(const float*, const int*, int, float*);

KernelFn kernel_of(int c) {
  switch (c) {
    case S1: return probe_feature_kernel<S1>;
    case S2: return probe_feature_kernel<S2>;
    case S3: return probe_feature_kernel<S3>;
    case S4: return probe_feature_kernel<S4>;
    case S5: return probe_feature_kernel<S5>;
    default: return probe_feature_kernel<S6>;
  }
}

}  // namespace probe_feature

extern "C" int rt_probe_feature(int c, const float* x, const int* n, int packets, float* out,
                                void* stream) {
  using namespace probe_feature;
  if (c < 0 || c >= N_CASES || packets < 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel_of(c)<<<1, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(x, n, packets, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_feature_attrs(int c, int* num_regs, int* local_bytes) {
  using namespace probe_feature;
  if (c < 0 || c >= N_CASES) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(c));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
