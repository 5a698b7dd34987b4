// P-morph: the v5 traversal body morphed toward K4 one structural delta at a
// time, thirteen variants.
//
// Replaces scripts/kernel_morph.py run_variant (:52; TPU call :324), whose
// VARIANTS (:27-49) are tuples (loop, outs, init, brute, clamp). Wrapper,
// plain PyTorch version and entry point: raytracer_tpu_torch/probes/morph.py
// (`morph`, `morph_plain`, `main`), which take the same operations in the
// same order, so the two agree bit for bit. The deltas are this template's
// parameters, so that each variant compiles its own loop:
//
//   LOOP   FORI: ITERS iterations (a chain whose walk ends restarts at the
//          root). WHILE: while the packet's alive count (its chains whose
//          next task is not NONE) is > 0; a finished chain stays NONE.
//          WHILECOUNTER: FORI's loop as a counter the condition reads.
//          WHILEALIVECAP: while counter > 0 and alive > 0, restarting as
//          FORI does (the count, taken before the restart, rarely reaches 0).
//   OUTS6  t only, or t, best, mat and the unnormalised normal e1 x e2.
//   ROOT   every chain starts at the root, or only a chain with a lane that
//          hits the union of the root's child boxes (at NONE otherwise).
//   BRUTE  the brute-force rows before the zero row swept first.
//   CLAMP  pushes with the stack pointer clamped to stack_cap - 4, or not.
//
// The packet's loop is the block's: the alive count is __syncthreads_count
// of lane 0's nxt != NONE in each warp, as the script's condition reads the
// sum over the 8 chains, so a block of WHILE runs until its last chain
// ends. FORI and WHILECOUNTER have no block-wide step. The stack is one flat
// array of 8 * stack_cap entries in shared memory, chain s at s * stack_cap
// (stack_cap: the tree's stack bound, which the builder sizes so that no
// walk reaches it); an unclamped push beyond the array traps. A chain's task
// and stack pointer live in shared memory, written by lane 0 and read by
// every lane after __syncwarp, as in probe_v5.cuh.
//
// What bounds it: the dependence chain of one iteration (task -> row loads
// -> 8 MT records -> 4 slabs -> shuffles -> push/pop -> task) as in the v5
// body, and for WHILE the block's slowest chain; at the script's 8 packets,
// 8 blocks on 132 SMs.
#pragma once
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_morph {

using namespace probe;

enum Loop { FORI, WHILE, WHILECOUNTER, WHILEALIVECAP };
constexpr int N_VARIANTS = 13;

template <int LOOP, bool OUTS6, bool ROOT, bool BRUTE, bool CLAMP>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_morph_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tlim, int zero_row, int n_brute_rows,
                       int stack_cap, int iters, int max_iters, float* __restrict__ t_out,
                       int* __restrict__ id_out, int* __restrict__ mat_out,
                       float* __restrict__ nx_out, float* __restrict__ ny_out,
                       float* __restrict__ nz_out, int* __restrict__ iters_out) {
  extern __shared__ int s_stack[];  // [P_SUB * stack_cap], chain s at s * stack_cap
  __shared__ int s_task[P_SUB], s_sp[P_SUB];
  const int p = blockIdx.x, s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = s * stack_cap, n_stack = P_SUB * stack_cap;
  Lanes L;
  Rec R;
  load_rays(L, o, d, p, s, lane);
  const size_t out_base = (static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    L.t_best[j] = tlim[out_base + 32 * j];
    L.best[j] = NONE;
    R.mat[j] = 0;
    R.nx[j] = 0.0f;
    R.ny[j] = 0.0f;
    R.nz[j] = 0.0f;
  }
  if (BRUTE) {
    for (int r = zero_row - n_brute_rows; r < zero_row; ++r)
      mt_row8(L, R, tri + static_cast<size_t>(r) * ROW);
  }

  int n_alive;
  if (ROOT) {
    float box[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[c] = jmin(jmin(node[c], node[6 + c]), jmin(node[12 + c], node[18 + c]));
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = node[6 * k + 3] > -BIG ? node[6 * k + 3 + c] : -BIG;
      box[3 + c] = jmax(jmax(v[0], v[1]), jmax(v[2], v[3]));
    }
    int hits = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      float tm;
      hits += slab(L, j, box, tm) ? 1 : 0;
    }
    const bool alive = warp_sum(hits) > 0;
    if (lane == 0) {
      s_task[s] = alive ? 0 : NONE;
      s_sp[s] = 0;
    }
    n_alive = __syncthreads_count(lane == 0 && alive);
  } else {
    if (lane == 0) {
      s_task[s] = 0;
      s_sp[s] = 0;
    }
    __syncwarp();
    n_alive = P_SUB;
  }

  // One iteration of chain s; returns its next task before any restart.
  auto body = [&]() -> int {
    const int task = s_task[s];
    const bool is_int = task >= 0, is_leaf = task <= -2;
    const float* nrow = node + static_cast<size_t>(is_int ? floordiv(task, 4) : 0) * ROW;
    const float* nrec = nrow + NODE_STRIDE * (is_int ? floormod(task, 4) : 0);
    const float* trow =
        tri + static_cast<size_t>(is_leaf ? floordiv(neg2(task), 64) : zero_row) * ROW;
    int ch[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ch[k] = f2i(nrec[24 + k]);

    // ---- leaf: the 8 records of the row
    mt_row8(L, R, trow);

    // ---- internal: 4 slabs, lane 0's rep keys, the packed hit counts
    float rep[4];
    int hits[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float b[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) b[c] = nrec[k * 6 + c];
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
    const int pa = warp_sum(hits[0] + shl16(hits[1]));
    const int pb = warp_sum(hits[2] + shl16(hits[3]));

    // ---- scalar: the chain's decision and push/pop
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
    const int sp = s_sp[s];
    if (!CLAMP && base + sp + max(nhit - 2, 0) >= n_stack) __trap();  // beyond the array
    if (lane == 0) {
      s_stack[base + sp + max(nhit - 4, 0)] = cc[3];
      s_stack[base + sp + max(nhit - 3, 0)] = cc[2];
      s_stack[base + sp + max(nhit - 2, 0)] = cc[1];
    }
    __syncwarp();
    const int nsp = CLAMP ? min(sp + max(nhit - 1, 0), stack_cap - 4) : sp + max(nhit - 1, 0);
    const int desc = nhit > 0 ? cc[0] : NONE;
    const bool do_pop = (desc == NONE) && (nsp > 0) && (task != NONE);
    const int popped = s_stack[base + max(nsp - 1, 0)];
    const int nxt = do_pop ? popped : desc;
    __syncwarp();  // every lane has read this iteration's task and stack
    if (lane == 0) {
      // WHILE keeps a finished chain at NONE; the others restart it at the root.
      s_task[s] = LOOP == WHILE ? nxt : (nxt == NONE ? 0 : nxt);
      s_sp[s] = do_pop ? nsp - 1 : nsp;
    }
    __syncwarp();  // the next iteration reads what lane 0 wrote
    return nxt;
  };

  int it = 0;
  if (LOOP == FORI) {
    for (int i = 0; i < iters; ++i) body();
    it = iters > 0 ? iters : 0;
  } else if (LOOP == WHILECOUNTER) {
    for (int c = iters; c > 0; --c, ++it) body();
  } else if (LOOP == WHILE) {
    // max_iters guards the card against a walk that never ends; the plain
    // version stops there too, and the entry point checks it was not hit.
    for (; n_alive > 0 && it < max_iters; ++it) {
      const int nxt = body();
      n_alive = __syncthreads_count(lane == 0 && nxt != NONE);
    }
  } else {
    for (int c = iters; c > 0 && n_alive > 0; --c, ++it) {
      const int nxt = body();
      n_alive = __syncthreads_count(lane == 0 && nxt != NONE);
    }
  }

#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const size_t i = out_base + 32 * j;
    t_out[i] = L.t_best[j];
    if (OUTS6) {
      id_out[i] = L.best[j];
      mat_out[i] = R.mat[j];
      nx_out[i] = R.nx[j];
      ny_out[i] = R.ny[j];
      nz_out[i] = R.nz[j];
    }
  }
  if (threadIdx.x == 0) iters_out[p] = it;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, int, int, int, float*, int*, int*, float*, float*, float*,
                          int*);

// The kernels of v0_ablate .. v0_noclamp (variants 0-6) are instantiated in
// probe_morph.cu, those of v6_whilecounter .. v11_cap_noclamp (7-12) in
// probe_morph_part2.cu, so that nvcc compiles the two halves in parallel;
// nullptr for another variant.
KernelFn part1_kernel(int variant);
KernelFn part2_kernel(int variant);

}  // namespace probe_morph
