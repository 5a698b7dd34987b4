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
// A chain is W warps (W = 1, 2 or 4; probe.cuh). A block of 256 threads holds
// 8 / W chains, except in the modes with a packet-wide barrier (loads0,
// noconcat, noc_nosc: packet_block), where a block is one packet of 8 chains,
// 256 W threads. Per iteration each warp of a chain reads its task and issues
// its node record (28 floats: 7 lanes' 16-byte loads) and its triangle row
// (the leaf's, or the trailing zero row: a 16-byte load per lane) together
// into its slice of shared memory, where every thread reads a record's
// 16-byte words back as it uses them (31 per iteration for the 108 floats);
// every thread tests its 4 / W lanes against 8 triangle records and 4 child
// boxes, the chain's lane 0 rep keys and the packed hit counts (warp sums;
// with W > 1 each warp's sums and lane 0's keys through shared memory under
// the chain's named barrier, double buffered by iteration) decide the next
// task, and lane 0 pushes the other hit children onto the warp's copy of the
// chain's 40-entry stack in shared memory. The task and stack pointer live in
// the warp's slice of shared memory, or in registers in carry8 and
// prod_carry. loads0 makes both rows from chain 0's t_best + the task, as the
// script does: chain 0 publishes its t_best in shared memory (double
// buffered, one __syncthreads() per iteration).
//
// The base modes make both rows with no loads, as loads0 does, but each
// chain from its OWN t_best, which a chain stages in its own slice of shared
// memory (a __syncwarp, or the chain's barrier where W > 1; double buffered
// there). base adds the chain's own task; noconcat adds chain 0's task,
// which chain 0 publishes at the end of each iteration in a double-buffered
// slot that every warp reads after one __syncthreads(); noc_nosc is
// noconcat with the task stepping 0..1000 instead of push/pop; minimal is
// the loop and the shared-memory task alone. On the TPU base − noconcat
// measured the cross-sublane concatenate that assembles 8 chains' rows; a
// warp has no such assembly, so here it measures the chain's own task
// against a shared task and a block barrier.
//
// What bounds it: the issue of the lanes' instructions (8 MT records and 4
// slabs per lane, 540 fp32 operations) with the dependence chain of one
// iteration (task → rows → records → slabs → reductions → push/pop → task)
// exposed where the card holds few warps: at the scripts' 128 packets a
// warp per chain leaves 7.8 warps per SM. W > 1 adds warps and cuts each
// warp's lane work; the entry point picks W from the packets and the SM
// count (rt_probe_v5_pick_w), as P-v8's does.
#pragma once
#include <cuda_runtime.h>

#include <utility>

#include "probe.cuh"

namespace probe_v5 {

using namespace probe;

constexpr int STACK_CAP = 40;
constexpr int RESTART = 1000;
constexpr int NREC_Q = 7;   // 16-byte words of a node record's 28 floats
constexpr int ROW_Q = 32;   // 16-byte words of a row
enum Mode {
  FULL_BODY, NO_LEAF, NO_INTERNAL, NO_SCALAR, NO_FETCH, FULL16, LOADS8, LOADS0, EMPTY, CARRY8,
  SMEM8, PROD_SMEM, PROD_CARRY, BASE, NOCONCAT, NOC_NOSC, MINIMAL, N_MODES
};

// The modes whose chains meet at a packet-wide barrier: a block is a packet.
__host__ __device__ constexpr bool packet_block(int m) {
  return m == LOADS0 || m == NOCONCAT || m == NOC_NOSC;
}
// Threads per block of mode m at chain width w.
__host__ __device__ constexpr int block_of(int m, int w) {
  return packet_block(m) ? P_SUB * 32 * w : P_SUB * 32;
}
// The chain widths a mode admits (probes/v5_body.ADMITTED_W): every mode
// each of 1, 2 and 4.
__host__ __device__ constexpr bool admits(int /* mode */, int w) {
  return w == 1 || w == 2 || w == 4;
}
// The warps per SM up to which the entry point widens a chain
// (probes/v5_body.WARPS_PER_SM).
constexpr int WARPS_PER_SM = 16;
// The blocks per SM __launch_bounds__ makes room for: three of 256 threads
// (80 registers each) where the W = 1 kernel fits them without spilling
// (phase 13, 1,056 packets, H100: full 4.86 ms against 5.29 at two), else two;
// one packet block of 256 W threads. no_fetch, loads0, prod_carry, base
// and noconcat spill at 80 registers (ptxas, sm_90a).
__host__ __device__ constexpr int min_blocks(int m, int w) {
  return block_of(m, w) != P_SUB * 32 ? 1
         : (w == 1 && m != NO_FETCH && m != LOADS0 && m != PROD_CARRY && m != BASE &&
            m != NOCONCAT)
             ? 3
             : 2;
}

template <int M, int W>
__global__ void __launch_bounds__(block_of(M, W), min_blocks(M, W))
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
  constexpr int N = LPT / W;                                   // lanes per thread
  constexpr int CPB = packet_block(M) ? P_SUB : P_SUB / W;     // chains per block
  constexpr int XB = W > 1 ? 2 : 1;                            // buffers by iteration parity
  __shared__ int s_task[CPB * W], s_sp[CPB * W];               // one per warp
  __shared__ int s_stack[CPB * W][STACK_CAP];
  __shared__ __align__(16) float s_row0[M == LOADS0 ? 2 : 1][M == LOADS0 ? P_LANE : 4];
  __shared__ __align__(16) float s_own[OWN_ROW ? XB : 1][OWN_ROW ? CPB : 1][OWN_ROW ? P_LANE : 4];
  __shared__ int s_task0[2];
  __shared__ float4 s_nrec[LOADS == 16 ? CPB * W : 1][NREC_Q];  // each warp's loaded rows
  __shared__ float4 s_trow[LOADS > 0 ? CPB * W : 1][ROW_Q];
  __shared__ float s_rep[XB][CPB][4];      // the chain's lane 0 keys (W > 1)
  __shared__ int s_pab[XB][CPB][W][2];     // each warp's packed hit sums (W > 1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp / W, ws = warp % W;  // chain in the block, warp in the chain
  const int chain = blockIdx.x * CPB + c;
  const int p = chain / P_SUB, s = chain % P_SUB;
  const int lane0 = lane + 32 * N * ws;   // the thread's first lane of the chain
  LanesN<N> L;
  load_rays(L, o, d, p, s, lane0);
  const size_t out_base = (static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    L.t_best[j] = tlim[out_base + 32 * j];
    L.best[j] = NONE;
  }
  if (lane == 0) {
    s_task[warp] = 0;
    s_sp[warp] = 0;
  }
  if (TASK0 && threadIdx.x == 0) s_task0[0] = 0;  // read after iteration 0's barrier
  __syncwarp();
  int task_r = 0, sp_r = 0;  // carry8, prod_carry: the state in registers
  int* stack = s_stack[warp];
  // Chain barrier: a warp's own __syncwarp where the chain is one warp.
  auto sync_chain = [&]() {
    if (W == 1) {
      __syncwarp();
    } else {
      chain_sync(1 + c, 32 * W);
    }
  };

  if (LOOP_ONLY) {
    for (int i = 0; i < iters; ++i) {
      if (M == CARRY8) {
        task_r = task_r >= RESTART ? 0 : task_r + 1;
        keep(task_r);
      } else if (M == SMEM8 || M == MINIMAL) {
        const int t = s_task[warp];
        __syncwarp();
        if (lane == 0) s_task[warp] = t >= RESTART ? 0 : t + 1;
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < N; ++j) L.t_best[j] = L.t_best[j] + 1.0f;
    }
  } else {
    for (int i = 0; i < iters; ++i) {
      const int task = CARRY ? task_r : s_task[warp];
      const bool is_int = task >= 0, is_leaf = task <= -2;

      // ---- the node record and the triangle row: loaded (one 16-byte word
      // per lane, issued together) into the warp's slice of shared memory,
      // or made there from t_best rows; read back word by word where used
      const float4* nq;
      const float4* tq;
      float ftask = 0.0f;  // the task a row made from t_best adds
      if constexpr (LOADS == 0) {
        const float* row;
        if constexpr (OWN_ROW) {
          row = s_own[i & (XB - 1)][c];
#pragma unroll
          for (int j = 0; j < N; ++j) s_own[i & (XB - 1)][c][lane0 + 32 * j] = L.t_best[j];
          if (TASK0) {
            __syncthreads();  // chain 0's task of the last iteration is published
          } else {
            sync_chain();
          }
        } else {
          row = s_row0[i & 1];
          if (s == 0) {
#pragma unroll
            for (int j = 0; j < N; ++j) s_row0[i & 1][lane0 + 32 * j] = L.t_best[j];
          }
          __syncthreads();
        }
        ftask = static_cast<float>(TASK0 ? s_task0[i & 1] : task);
        nq = tq = reinterpret_cast<const float4*>(row);
      } else {
        const float* nrec;
        const float* trow;
        if constexpr (FETCH) {
          const float* nrow = node + static_cast<size_t>(is_int ? floordiv(task, 4) : 0) * ROW;
          nrec = nrow + NODE_STRIDE * (is_int ? floormod(task, 4) : 0);
          trow = LOADS == 8 ? nrow
                            : tri + static_cast<size_t>(is_leaf ? floordiv(neg2(task), 64)
                                                                : zero_row) * ROW;
        } else {
          nrec = opaque(node);
          trow = opaque(tri);
        }
        // loads8: one row, the node row, whose record the node fields are.
        float4 wn, wt;
        if (LOADS == 16 && lane < NREC_Q) wn = row_word(nrec, lane);
        if (LEAF || LOADS == 8) wt = row_word(trow, lane);
        if (LOADS == 16 && lane < NREC_Q) s_nrec[warp][lane] = wn;
        if (LEAF || LOADS == 8) s_trow[warp][lane] = wt;
        __syncwarp();
        tq = s_trow[warp];
        nq = LOADS == 8 ? tq + (nrec - trow) / 4 : s_nrec[LOADS == 16 ? warp : 0];
      }
      // Float f of the node record and of triangle record k (a t_best row's
      // + the task; a loaded row's as it is: + 0 would turn -0 into +0).
      auto at = [&](float v) { return LOADS == 0 ? v + ftask : v; };
      auto nf = [&](int f) { return at(elem(nq[f >> 2], f & 3)); };
      auto tf = [&](int k, int f) { return at(elem(tq[k * TRI_STRIDE / 4 + (f >> 2)], f & 3)); };
      int ch[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ch[k] = f2i(nf(24 + k));

      // ---- leaf: 8 MT records
      if (LEAF) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float r[9];
#pragma unroll
          for (int f = 0; f < 9; ++f) r[f] = tf(k, f);
          mt_record(L, r, f2i(tf(k, 9)));
        }
      }

      // ---- internal: 4 slabs, lane 0's rep keys, the packed hit counts
      float rep[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int pa = 0, pb = 0;
      if (INTERNAL) {
        float r0[4];
        int hits[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float b[6];
#pragma unroll
          for (int f = 0; f < 6; ++f) b[f] = nf(k * 6 + f);
          r0[k] = 0.0f;
          hits[k] = 0;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            float tk;
            const bool h = slab(L, j, b, tk);
            if (j == 0) r0[k] = h ? tk : HALF_BIG;
            hits[k] += h ? 1 : 0;
          }
        }
        pa = warp_sum(hits[0] + shl16(hits[1]));
        pb = warp_sum(hits[2] + shl16(hits[3]));
        if (W == 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) rep[k] = __shfl_sync(FULL, r0[k], 0);
        } else if (SCALAR) {
          // Each warp's sums and the chain's lane 0 keys; only the scalar
          // phase reads them.
          float(&xr)[4] = s_rep[i & (XB - 1)][c];
          int(&xp)[W][2] = s_pab[i & (XB - 1)][c];
          if (lane == 0) {
            xp[ws][0] = pa;
            xp[ws][1] = pb;
            if (ws == 0) {
#pragma unroll
              for (int k = 0; k < 4; ++k) xr[k] = r0[k];
            }
          }
          sync_chain();
#pragma unroll
          for (int k = 0; k < 4; ++k) rep[k] = xr[k];
          pa = xp[0][0];
          pb = xp[0][1];
#pragma unroll
          for (int w = 1; w < W; ++w) {
            pa += xp[w][0];
            pb += xp[w][1];
          }
        }
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
        const int sp = CARRY ? sp_r : s_sp[warp];
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
        s_task[warp] = new_task;
        if (SCALAR) s_sp[warp] = new_sp;
        // The slot the other warps read in the last iteration, before this
        // one's barrier.
        if (TASK0 && s == 0 && ws == 0) s_task0[(i + 1) & 1] = new_task;
      }
      __syncwarp();  // the next iteration reads what lane 0 wrote
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) out[out_base + 32 * j] = L.t_best[j];
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, float*);

// The kernel of mode M at chain width W, nullptr for a W that M does not
// admit.
template <int M, int W>
KernelFn kernel_if_admitted() {
  if constexpr (admits(M, W)) {
    return probe_v5_kernel<M, W>;
  } else {
    return nullptr;
  }
}

// The kernel of `mode` at chain width W when LO <= mode < HI, else nullptr.
template <int W, int LO, int... I>
KernelFn kernel_in(int mode, std::integer_sequence<int, I...>) {
  // Not static: a template's static local is one symbol for the whole process
  // (GNU unique), so two builds of these sources loaded side by side (phase
  // 15 of chip_smoke.py loads the parent's) would launch each other's stubs.
  const KernelFn table[] = {kernel_if_admitted<LO + I, W>()...};
  return mode >= LO && mode < LO + static_cast<int>(sizeof...(I)) ? table[mode - LO] : nullptr;
}
template <int W, int LO, int HI>
KernelFn kernels_in(int mode) {
  return kernel_in<W, LO>(mode, std::make_integer_sequence<int, HI - LO>{});
}

// The kernels of each chain width, half of the modes per source so that
// nvcc compiles them in parallel (cudalib starts one nvcc per source, all
// at once): probe_v5.cu (W = 1, modes full .. loads0), probe_v5_part2.cu (W
// = 1, empty .. minimal), probe_v5_part3.cu (W = 2) and probe_v5_part4.cu
// (W = 4). nullptr for another mode or width.
constexpr int SPLIT = EMPTY;
KernelFn kernel_w1_hi(int mode);
KernelFn kernel_w2(int mode);
KernelFn kernel_w4(int mode);

}  // namespace probe_v5
