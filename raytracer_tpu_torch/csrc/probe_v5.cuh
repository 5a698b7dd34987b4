// P-ablate, P-load, P-floor, P-base: the fixed-iteration v5 traversal body
// over a 4-wide tree in the v5 tables, one mode per knockout of four scripts.
//
// Replaces scripts/kernel_ablate.py make_kernel (:33; TPU call :213),
// scripts/kernel_load_probe.py make_kernel (:43; :214),
// scripts/kernel_floor_probe.py make_kernel (:48; :263) and
// scripts/kernel_base_probe.py make_kernel (:40; :209). Wrapper and plain
// PyTorch version: raytracer_tpu_torch/probes/v5_body.py (`v5`, `v5_plain`),
// which take the same operations in the same order, so the two agree bit for
// bit. Modes, in v5_body.MODES order: full, no_leaf, no_internal, no_scalar,
// no_fetch (ablate); full16, loads8, loads0 (load); empty, carry8, smem8,
// prod_smem, prod_carry (floor); base, noconcat, noc_nosc, minimal (base).
// full, full16 and prod_smem are one body; minimal is smem8's.
//
// One block of 8 warps per packet, one warp per chain (probe.cuh). Per
// iteration a chain reads its task, loads its node row (the task's record of
// four) and its triangle row (the leaf's, or the trailing zero row), every
// lane tests 8 triangle records and 4 child boxes, lane 0's rep keys and
// the packed hit counts (warp sums) decide the next task, and lane 0 pushes
// the other hit children onto the chain's 40-entry stack in shared memory.
// The task and stack pointer live in shared memory, or in registers in
// carry8 and prod_carry. loads0 makes both rows from chain 0's t_best + the
// task, as the script does: warp 0 publishes its t_best in shared memory
// (double-buffered, one __syncthreads() per iteration).
//
// The base modes make both rows with no loads, as loads0 does, but each
// chain from its OWN t_best, which a warp stages in its own slice of shared
// memory (one __syncwarp, no block barrier). base adds the chain's own
// task; noconcat adds chain 0's task, which warp 0 publishes at the end of
// each iteration in a double-buffered slot that every warp reads after one
// __syncthreads(); noc_nosc is noconcat with the task stepping 0..1000
// instead of push/pop; minimal is the loop and the shared-memory task
// alone. On the TPU base − noconcat measured the cross-sublane concatenate
// that assembles 8 chains' rows; a warp has no such assembly, so here it
// measures the chain's own task against a shared task and a block barrier.
//
// What bounds it: the dependence chain of one iteration (task → row load →
// 8 MT records → slabs → shuffles → push/pop → task), not bytes or fp32
// operations (540 per lane). At the scripts' 128 packets the card holds
// 1,024 warps, under 8 per SM.
#pragma once
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_v5 {

using namespace probe;

constexpr int STACK_CAP = 40;
constexpr int RESTART = 1000;
enum Mode {
  FULL_BODY, NO_LEAF, NO_INTERNAL, NO_SCALAR, NO_FETCH, FULL16, LOADS8, LOADS0, EMPTY, CARRY8,
  SMEM8, PROD_SMEM, PROD_CARRY, BASE, NOCONCAT, NOC_NOSC, MINIMAL, N_MODES
};

template <int M>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_v5_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tlim, int zero_row, int iters,
                    float* __restrict__ out) {
  constexpr bool FETCH = M != NO_FETCH, LEAF = M != NO_LEAF, INTERNAL = M != NO_INTERNAL;
  constexpr bool SCALAR = M != NO_SCALAR && M != NOC_NOSC;
  constexpr bool OWN_ROW = M == BASE || M == NOCONCAT || M == NOC_NOSC;
  constexpr bool TASK0 = M == NOCONCAT || M == NOC_NOSC;  // rows add chain 0's task
  constexpr int LOADS = M == LOADS8 ? 8 : (M == LOADS0 || OWN_ROW) ? 0 : 16;
  constexpr bool CARRY = M == CARRY8 || M == PROD_CARRY;
  constexpr bool LOOP_ONLY = M == EMPTY || M == CARRY8 || M == SMEM8 || M == MINIMAL;
  __shared__ int s_task[P_SUB], s_sp[P_SUB];
  __shared__ int s_stack[P_SUB][STACK_CAP];
  __shared__ float s_row0[M == LOADS0 ? 2 : 1][M == LOADS0 ? P_LANE : 1];
  __shared__ float s_own[OWN_ROW ? P_SUB : 1][OWN_ROW ? P_LANE : 1];
  __shared__ int s_task0[2];
  const int p = blockIdx.x, s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Lanes L;
  load_rays(L, o, d, p, s, lane);
  const size_t out_base = (static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    L.t_best[j] = tlim[out_base + 32 * j];
    L.best[j] = NONE;
  }
  if (lane == 0) {
    s_task[s] = 0;
    s_sp[s] = 0;
  }
  if (TASK0 && threadIdx.x == 0) s_task0[0] = 0;  // read after iteration 0's barrier
  __syncwarp();
  int task_r = 0, sp_r = 0;  // carry8, prod_carry: the state in registers
  int* stack = s_stack[s];

  if (LOOP_ONLY) {
    for (int i = 0; i < iters; ++i) {
      if (M == CARRY8) {
        task_r = task_r >= RESTART ? 0 : task_r + 1;
        keep(task_r);
      } else if (M == SMEM8 || M == MINIMAL) {
        const int t = s_task[s];
        __syncwarp();
        if (lane == 0) s_task[s] = t >= RESTART ? 0 : t + 1;
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < LPT; ++j) L.t_best[j] = L.t_best[j] + 1.0f;
    }
  } else {
    for (int i = 0; i < iters; ++i) {
      const int task = CARRY ? task_r : s_task[s];
      const bool is_int = task >= 0, is_leaf = task <= -2;

      // ---- the node record and the triangle row
      const float* nrec;
      const float* trow;
      if constexpr (OWN_ROW) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) s_own[s][lane + 32 * j] = L.t_best[j];
        if (TASK0) {
          __syncthreads();  // warp 0's task of the last iteration is published
        } else {
          __syncwarp();
        }
        nrec = trow = s_own[s];
      } else if constexpr (LOADS == 0) {
        if (s == 0) {
#pragma unroll
          for (int j = 0; j < LPT; ++j) s_row0[i & 1][lane + 32 * j] = L.t_best[j];
        }
        __syncthreads();
        nrec = trow = s_row0[i & 1];
      } else if constexpr (FETCH) {
        const float* nrow = node + static_cast<size_t>(is_int ? floordiv(task, 4) : 0) * ROW;
        nrec = nrow + NODE_STRIDE * (is_int ? floormod(task, 4) : 0);
        trow = LOADS == 8 ? nrow
                          : tri + static_cast<size_t>(is_leaf ? floordiv(neg2(task), 64)
                                                              : zero_row) * ROW;
      } else {
        nrec = node;
        trow = tri;
      }
      const float ftask = static_cast<float>(TASK0 ? s_task0[i & 1] : task);
      // A lane of a row: the rows of loads0 and the base modes are a t_best
      // row + a task.
      auto at = [&](const float* row, int c) {
        return LOADS == 0 ? row[c] + ftask : row[c];
      };
      int ch[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ch[k] = f2i(at(nrec, 24 + k));

      // ---- leaf: 8 MT records
      if (LEAF) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float r[9];
#pragma unroll
          for (int c = 0; c < 9; ++c) r[c] = at(trow, k * TRI_STRIDE + c);
          mt_record(L, r, f2i(at(trow, k * TRI_STRIDE + 9)));
        }
      }

      // ---- internal: 4 slabs, lane 0's rep keys, the packed hit counts
      float rep[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int pa = 0, pb = 0;
      if (INTERNAL) {
        int hits[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float b[6];
#pragma unroll
          for (int c = 0; c < 6; ++c) b[c] = at(nrec, k * 6 + c);
          float r0 = 0.0f;
          int cnt = 0;
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            float tk;
            const bool h = slab(L, j, b, tk);
            if (j == 0) r0 = h ? tk : HALF_BIG;
            cnt += h ? 1 : 0;
          }
          rep[k] = __shfl_sync(FULL, r0, 0);
          hits[k] = cnt;
        }
        pa = warp_sum(hits[0] + shl16(hits[1]));
        pb = warp_sum(hits[2] + shl16(hits[3]));
      }

      // ---- scalar: the chain's decision and push/pop
      int new_task, new_sp = 0;
      if (SCALAR) {
        bool anyk[4] = {(pa & 0xFFFF) > 0, (pa >> 16) > 0, (pb & 0xFFFF) > 0, (pb >> 16) > 0};
        int nhit = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          anyk[k] = anyk[k] && (ch[k] != NONE);
          nhit += anyk[k] ? 1 : 0;
        }
        nhit = is_int ? nhit : 0;
        float tm[4];
        int cc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tm[k] = anyk[k] ? rep[k] : BIG;
          cc[k] = ch[k];
        }
        PROBE_CSWAP(tm, cc, 0, 2) PROBE_CSWAP(tm, cc, 1, 3) PROBE_CSWAP(tm, cc, 0, 1)
        PROBE_CSWAP(tm, cc, 2, 3) PROBE_CSWAP(tm, cc, 1, 2)
        const int sp = CARRY ? sp_r : s_sp[s];
        if (lane == 0) {
          stack[sp + max(nhit - 4, 0)] = cc[3];
          stack[sp + max(nhit - 3, 0)] = cc[2];
          stack[sp + max(nhit - 2, 0)] = cc[1];
        }
        __syncwarp();
        const int nsp = min(sp + max(nhit - 1, 0), STACK_CAP - 4);
        const int desc = nhit > 0 ? cc[0] : NONE;
        const bool do_pop = (desc == NONE) && (nsp > 0) && (task != NONE);
        const int popped = stack[max(nsp - 1, 0)];
        const int nxt = do_pop ? popped : desc;
        new_task = nxt == NONE ? 0 : nxt;  // a finished walk restarts at the root
        new_sp = do_pop ? nsp - 1 : nsp;
      } else {
        new_task = task >= RESTART ? 0 : task + 1;
        if (!CARRY) __syncwarp();  // every lane has read this iteration's task
      }
      if (CARRY) {
        task_r = new_task;
        sp_r = new_sp;
      } else if (lane == 0) {
        s_task[s] = new_task;
        if (SCALAR) s_sp[s] = new_sp;
        // The slot the other warps read in the last iteration, before this
        // one's barrier.
        if (TASK0 && s == 0) s_task0[(i + 1) & 1] = new_task;
      }
      __syncwarp();  // the next iteration reads what lane 0 wrote
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) out[out_base + 32 * j] = L.t_best[j];
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, float*);

// The kernels of loads8 .. prod_carry, instantiated in probe_v5_part2.cu, and
// of base .. minimal, in probe_v5_part3.cu, so that nvcc compiles them beside
// probe_v5.cu's (cudalib starts one nvcc per source, all at once); nullptr
// for another mode.
KernelFn part2_kernel(int mode);
KernelFn part3_kernel(int mode);

}  // namespace probe_v5
