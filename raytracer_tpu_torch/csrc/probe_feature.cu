// P-feature: one kernel construct of the traversal kernel per stage, s1-s6,
// on [8, 128] tiles.
//
// Replaces scripts/kernel_feature_probe.py s1 (:36) .. s6 (:196) (TPU calls
// :46, :72, :103, :142, :186, :232). The wrapper, the plain PyTorch version
// and the entry point are raytracer_tpu_torch/probes/feature.py, whose plain
// version takes the same operations in the same order, so the two agree bit
// for bit; s7 runs K4 (trace_closest.cu) and has no kernel here.
//
//   s1  six outputs, x + i
//   s2  a loop over 4 packets inside the block, each x * 2
//   s3  a while loop whose trip count n the kernel reads from a device
//       int32[1], acc += x per trip
//   s4  a task array in shared memory mutated inside a block-wide while
//       loop that runs while sum(task > 1) over the 8 chains is > 0
//       (__syncthreads_count of lane 0's test); acc += x per trip
//   s5  a stack in shared memory pushed at dynamic indices (16 pushes, one
//       or two stores each) by thread 0, then popped 8 times, every lane
//       adding the popped values
//   s6  inside a 6-trip loop, chain s loads row floormod(t, 16) of the
//       table (row 0 for t < 0) and its record floormod(t, 4) of 32 lanes,
//       t the chain's task in shared memory, which steps down through
//       negative values: jnp's % is a floor mod, C's % is not
//
// Mapping: one block of 8 warps, warp s is row s, thread l owns lanes l,
// l+32, l+64, l+96 (probe.cuh); what the script keeps in SMEM lives in
// shared memory, written by one lane and read after a barrier. What bounds
// it: the launch; each stage does a few operations per element.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_feature {

using namespace probe;

enum Case { S1, S2, S3, S4, S5, S6, N_CASES };
constexpr int S4_N0 = 8, S5_PUSHES = 16, S5_POPS = 8, S5_STACK = 64, S6_TRIPS = 6;

// x: the case's f32 input ([8, 128]; s2: [packets, 8, 128]; s6: the table
// f32[rows, 128]); n: s3's trip count i32[1]; out: the outputs, f32.
template <int C>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_feature_kernel(const float* __restrict__ x, const int* __restrict__ n, int packets,
                         float* o0, float* o1, float* o2, float* o3, float* o4, float* o5) {
  __shared__ int s_task[P_SUB];
  __shared__ int s_sp, s_stack[S5_STACK];
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = s * ROW + lane;
  float acc[LPT] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (C == S1) {
    float* outs[6] = {o0, o1, o2, o3, o4, o5};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        outs[i][base + 32 * j] = x[base + 32 * j] + static_cast<float>(i);
    }
    return;
  } else if constexpr (C == S2) {
    for (int p = 0; p < packets; ++p) {
      const size_t off = static_cast<size_t>(p) * P_SUB * ROW + base;
#pragma unroll
      for (int j = 0; j < LPT; ++j) o0[off + 32 * j] = x[off + 32 * j] * 2.0f;
    }
    return;
  } else if constexpr (C == S3) {
    int i = n[0];
    while (i > 0) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + x[base + 32 * j];
      i = i - 1;
    }
  } else if constexpr (C == S4) {
    if (lane == 0) s_task[s] = s + 3;
    __syncthreads();
    int alive = S4_N0;
    while (alive > 0) {
      const int t = s_task[s];
      __syncwarp();
      if (lane == 0) s_task[s] = t - 1;
      alive = __syncthreads_count(lane == 0 && t > 1);
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + x[base + 32 * j];
    }
  } else if constexpr (C == S5) {
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
      const int v = s_stack[max(sp - 1, 0)];
      __syncthreads();  // every thread has read sp before thread 0 moves it
      if (threadIdx.x == 0) s_sp = sp - 1;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + static_cast<float>(v);
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + 0.0f * x[base + 32 * j];
  } else {
    if (lane == 0) s_task[s] = floormod(5 * s, 17);
    __syncwarp();
    for (int trip = S6_TRIPS; trip > 0; --trip) {
      const int t = s_task[s];
      const float* row = x + static_cast<size_t>(t >= 0 ? floormod(t, 16) : 0) * ROW;
      const float* rec = row + 32 * floormod(t, 4);
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + rec[lane];
      __syncwarp();
      if (lane == 0) s_task[s] = t - 1;
      __syncwarp();
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) o0[base + 32 * j] = acc[j];
}

using KernelFn = void (*)(const float*, const int*, int, float*, float*, float*, float*, float*,
                          float*);

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

extern "C" int rt_probe_feature(int c, const float* x, const int* n, int packets, float* o0,
                                float* o1, float* o2, float* o3, float* o4, float* o5,
                                void* stream) {
  using namespace probe_feature;
  if (c < 0 || c >= N_CASES || packets < 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel_of(c)<<<1, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(x, n, packets, o0, o1,
                                                                         o2, o3, o4, o5);
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
