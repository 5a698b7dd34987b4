// P-interleave: the v5 `full` traversal body with G independent packets per
// loop iteration, G in {1, 2, 4, 8}.
//
// Replaces scripts/kernel_interleave_probe.py make_kernel (:37; TPU call
// :216). Wrapper and plain PyTorch version:
// raytracer_tpu_torch/probes/interleave_probe.py (`interleave`,
// `interleave_plain`). A packet's output does not depend on G: it is the v5
// `full` body's (probe_v5.cuh), and the plain version is v5_body.v5_plain in
// mode "full", bit for bit.
//
// The TPU question: the iteration is a latency chain (task -> row loads ->
// vector work -> scalar decision -> task); do G independent chains in one
// instruction stream hide it? The card's form of it: a block of 8 warps
// carries G packets, warp s runs chain s of each, and a thread holds
// 4·G lanes (4 of each packet), so G dependence chains interleave inside one
// thread. Each iteration reads the G tasks and forms the G row addresses
// first, then runs the G packets' 8 MT records and 4 slabs, then the G
// decisions and push/pops, as the script orders its phases; the row loads
// issue where the compute first reads them, and nvcc's scheduler is free to
// hoist them across packets. The grid is packets / G blocks.
//
// What bounds it: the chain of one iteration, as in probe_v5.cuh, against
// the issue slots of the SM's four schedulers. More ILP per warp costs
// registers: 44 per packet for the lanes alone, so past G = 2 the arrays
// spill to local memory (kernel_resources reports numRegs and
// localSizeBytes per G). At the script's 128 packets G = 8 is 16 blocks:
// fewer blocks and more ILP change together there, so the probe also runs
// at 1,056 packets, where G = 8 is 132 blocks, one per SM.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_interleave {

using namespace probe;

constexpr int STACK_CAP = 40;
constexpr int N_G = 4;  // G = 1, 2, 4, 8

template <int G>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_interleave_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                            const float* __restrict__ o, const float* __restrict__ d,
                            const float* __restrict__ tlim, int zero_row, int iters,
                            float* __restrict__ out) {
  __shared__ int s_task[G][P_SUB], s_sp[G][P_SUB];
  __shared__ int s_stack[G][P_SUB][STACK_CAP];
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Lanes L[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int p = blockIdx.x * G + g;
    load_rays(L[g], o, d, p, s, lane);
    const size_t base = (static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      L[g].t_best[j] = tlim[base + 32 * j];
      L[g].best[j] = NONE;
    }
    if (lane == 0) {
      s_task[g][s] = 0;
      s_sp[g][s] = 0;
    }
  }
  __syncwarp();

  for (int i = 0; i < iters; ++i) {
    // ---- fetch: the G tasks and row addresses
    int task[G];
    const float* nrec[G];
    const float* trow[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      task[g] = s_task[g][s];
      const bool is_int = task[g] >= 0, is_leaf = task[g] <= -2;
      const float* nrow = node + static_cast<size_t>(is_int ? floordiv(task[g], 4) : 0) * ROW;
      nrec[g] = nrow + NODE_STRIDE * (is_int ? floormod(task[g], 4) : 0);
      trow[g] = tri + static_cast<size_t>(is_leaf ? floordiv(neg2(task[g]), 64) : zero_row) * ROW;
    }

    // ---- compute: each packet's 8 MT records, 4 slabs and hit counts
    int ch[G][4], pa[G], pb[G];
    float rep[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ch[g][k] = f2i(nrec[g][24 + k]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float r[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) r[c] = trow[g][k * TRI_STRIDE + c];
        mt_record(L[g], r, f2i(trow[g][k * TRI_STRIDE + 9]));
      }
      int hits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float b[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) b[c] = nrec[g][k * 6 + c];
        float r0 = 0.0f;
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          float tk;
          const bool h = slab(L[g], j, b, tk);
          if (j == 0) r0 = h ? tk : HALF_BIG;
          cnt += h ? 1 : 0;
        }
        rep[g][k] = __shfl_sync(FULL, r0, 0);
        hits[k] = cnt;
      }
      pa[g] = warp_sum(hits[0] + shl16(hits[1]));
      pb[g] = warp_sum(hits[2] + shl16(hits[3]));
    }

    // ---- decide: each packet's chain pushes, pops and takes its next task
    int new_task[G], new_sp[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool is_int = task[g] >= 0;
      bool anyk[4] = {(pa[g] & 0xFFFF) > 0, (pa[g] >> 16) > 0, (pb[g] & 0xFFFF) > 0,
                      (pb[g] >> 16) > 0};
      int nhit = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        anyk[k] = anyk[k] && (ch[g][k] != NONE);
        nhit += anyk[k] ? 1 : 0;
      }
      nhit = is_int ? nhit : 0;
      float tm[4];
      int cc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        tm[k] = anyk[k] ? rep[g][k] : BIG;
        cc[k] = ch[g][k];
      }
      PROBE_CSWAP(tm, cc, 0, 2) PROBE_CSWAP(tm, cc, 1, 3) PROBE_CSWAP(tm, cc, 0, 1)
      PROBE_CSWAP(tm, cc, 2, 3) PROBE_CSWAP(tm, cc, 1, 2)
      int* stack = s_stack[g][s];
      const int sp = s_sp[g][s];
      if (lane == 0) {
        stack[sp + max(nhit - 4, 0)] = cc[3];
        stack[sp + max(nhit - 3, 0)] = cc[2];
        stack[sp + max(nhit - 2, 0)] = cc[1];
      }
      __syncwarp();
      const int nsp = min(sp + max(nhit - 1, 0), STACK_CAP - 4);
      const int desc = nhit > 0 ? cc[0] : NONE;
      const bool do_pop = (desc == NONE) && (nsp > 0) && (task[g] != NONE);
      const int popped = stack[max(nsp - 1, 0)];
      const int nxt = do_pop ? popped : desc;
      new_task[g] = nxt == NONE ? 0 : nxt;  // a finished walk restarts at the root
      new_sp[g] = do_pop ? nsp - 1 : nsp;
    }
    // Every lane read the tasks and stack pointers before the last packet's
    // __syncwarp above.
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s_task[g][s] = new_task[g];
        s_sp[g][s] = new_sp[g];
      }
    }
    __syncwarp();  // the next iteration reads what lane 0 wrote
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t base = ((static_cast<size_t>(blockIdx.x) * G + g) * P_SUB + s) * P_LANE + lane;
#pragma unroll
    for (int j = 0; j < LPT; ++j) out[base + 32 * j] = L[g].t_best[j];
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, float*);

KernelFn kernel_of(int gi) {
  switch (gi) {
    case 0: return probe_interleave_kernel<1>;
    case 1: return probe_interleave_kernel<2>;
    case 2: return probe_interleave_kernel<4>;
    case 3: return probe_interleave_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace probe_interleave

using namespace probe_interleave;

// t f32[packets, 8, 128] of `iters` iterations of the v5 full body, G =
// 1 << gi packets per block; the v5 tables, rays and limits as rt_probe_v5
// takes them. packets must be a multiple of G.
extern "C" int rt_probe_interleave(const float* node, const float* tri, const float* o,
                                   const float* d, const float* tlim, int zero_row, int iters,
                                   int packets, int gi, float* out, void* stream) {
  if (gi < 0 || gi >= N_G || iters < 0 || packets < 0 || zero_row < 0 ||
      packets % (1 << gi) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (packets > 0)
    kernel_of(gi)<<<packets >> gi, P_SUB * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, tlim, zero_row, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of the G = 1 << gi kernel.
extern "C" int rt_probe_interleave_attrs(int gi, int* num_regs, int* local_bytes) {
  if (gi < 0 || gi >= N_G) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(gi));
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
