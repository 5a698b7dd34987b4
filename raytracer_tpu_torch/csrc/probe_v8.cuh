// P-v8: the fixed-iteration round-5 BVH8 traversal body with one phase
// knocked out per variant (fetch, leaf, slab, reduce, sort, scalar).
//
// Replaces scripts/kernel_ablate_v8.py make_kernel (:49; TPU call :360).
// Wrapper and plain PyTorch version: raytracer_tpu_torch/probes/ablate_v8.py
// (`ablate_v8`, `ablate_v8_plain`), which take the same operations in the
// same order, so the two agree bit for bit.
//
// One block of 8 warps per packet, one warp per chain (probe.cuh). Per
// iteration a chain loads its node row (56 floats read by every lane, one
// L1 line set) and its triangle row, every lane tests 8 triangle records and
// 8 child boxes, the 8 rep keys are warp min-reductions and the 4 packed
// hit counts warp sums, both 8-key sorting networks and the pair packing run
// warp-uniform in every lane, and lane 0 does the push/pop on the chain's
// two 68-entry stacks in shared memory. The task streams are synthetic
// ((|next| + i) mod rows), so every variant runs the same iterations.
//
// What bounds it: the dependence chain of one iteration (task from shared
// memory → row load → slabs → shuffle reductions → sort → push/pop → task),
// not bytes (the tables sit in L2) nor fp32 operations (658 per lane).
// At the script's 64 packets the card holds 512 warps, under 4 per SM.
#pragma once
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_v8 {

using namespace probe;

constexpr int K = 8;
constexpr int STACK_CAP = 68;
constexpr int EMPTY16 = 0xFFFF;       // "no code" half of a pair-packed entry
constexpr int SPARE_NONE = -1;        // both halves empty
constexpr int SPARE_HIGH = -65536;    // 0xFFFF0000: empty high half
enum Variant { FULL_BODY, NO_FETCH, NO_LEAF, NO_SLAB, NO_REDUCE, NO_SORT, NO_SCALAR, N_VARIANTS };

__device__ __forceinline__ int low16(int x) { return x & EMPTY16; }
__device__ __forceinline__ int consume(int x) { return ((x >> 16) & EMPTY16) | SPARE_HIGH; }

// ops/bvh4.SORT_PAIRS[8].
__device__ __forceinline__ void sort8(float (&key)[K], int (&code)[K]) {
  PROBE_CSWAP(key, code, 0, 1) PROBE_CSWAP(key, code, 2, 3)
  PROBE_CSWAP(key, code, 4, 5) PROBE_CSWAP(key, code, 6, 7)
  PROBE_CSWAP(key, code, 0, 2) PROBE_CSWAP(key, code, 1, 3)
  PROBE_CSWAP(key, code, 4, 6) PROBE_CSWAP(key, code, 5, 7)
  PROBE_CSWAP(key, code, 1, 2) PROBE_CSWAP(key, code, 5, 6)
  PROBE_CSWAP(key, code, 0, 4) PROBE_CSWAP(key, code, 1, 5)
  PROBE_CSWAP(key, code, 2, 6) PROBE_CSWAP(key, code, 3, 7)
  PROBE_CSWAP(key, code, 2, 4) PROBE_CSWAP(key, code, 3, 5)
  PROBE_CSWAP(key, code, 1, 2) PROBE_CSWAP(key, code, 3, 4)
  PROBE_CSWAP(key, code, 5, 6)
}

template <int V>
__global__ void __launch_bounds__(P_SUB * 32)
    probe_v8_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                    const float* __restrict__ o, const float* __restrict__ d, int n_nodes,
                    int n_trirows, int iters, float* __restrict__ out) {
  constexpr bool FETCH = V != NO_FETCH, LEAF = V != NO_LEAF, SLAB = V != NO_SLAB;
  constexpr bool REDUCE = V != NO_REDUCE, SORT = V != NO_SORT, SCALAR = V != NO_SCALAR;
  __shared__ int s_ntask[P_SUB], s_sp[P_SUB], s_ltask[P_SUB], s_lsp[P_SUB];
  __shared__ int s_ispare[P_SUB], s_lspare[P_SUB];
  __shared__ int s_stack[P_SUB][STACK_CAP], s_lstack[P_SUB][STACK_CAP];
  const int p = blockIdx.x, s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Lanes L;
  load_rays(L, o, d, p, s, lane);
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    L.t_best[j] = BIG;
    L.best[j] = NONE;
  }
  if (lane == 0) {
    s_ntask[s] = s;
    s_sp[s] = 0;
    s_ltask[s] = s;
    s_lsp[s] = 0;
    s_ispare[s] = SPARE_NONE;
    s_lspare[s] = SPARE_NONE;
  }
  __syncwarp();
  int* stack = s_stack[s];
  int* lstack = s_lstack[s];

  for (int i = 0; i < iters; ++i) {
    // ---- fetch
    const int nt = s_ntask[s], lt = s_ltask[s];
    const float* nrow = FETCH ? node + static_cast<size_t>(nt >= 0 ? nt : 0) * ROW : node;
    int ch8[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ch8[k] = f2i(nrow[6 * K + k]);

    // ---- leaf block
    if (LEAF) {
      const float* trow = tri + static_cast<size_t>(lt >= 0 ? lt : 0) * ROW;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float r[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) r[c] = trow[k * TRI_STRIDE + c];
        mt_record(L, r, f2i(trow[k * TRI_STRIDE + 9]));
      }
    }

    // ---- slabs and the reductions (rep keys + packs)
    float rep[K];
    int hits[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float b[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) b[c] = nrow[k * 6 + c];
      float rmin = BIG, t0 = 0.0f;
      int cnt = 0;
      bool h0 = false;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        float tk;
        bool h;
        if (SLAB) {
          h = slab(L, j, b, tk);
        } else {
          h = (L.ox[j] + static_cast<float>(i)) > 0.5f;
          tk = L.ox[j];
        }
        if (j == 0) {
          h0 = h;
          t0 = tk;
        }
        rmin = fminf(rmin, h ? tk : BIG);  // tk is no NaN where h holds
        cnt += h ? 1 : 0;
      }
      if (REDUCE) {
        rep[k] = warp_min(rmin);
        hits[k] = cnt;
      } else {
        rep[k] = __shfl_sync(FULL, t0, 0);
        hits[k] = __shfl_sync(FULL, h0 ? 1 : 0, 0);
      }
    }
    int pack[K / 2];
#pragma unroll
    for (int q = 0; q < K / 2; ++q)
      pack[q] = REDUCE ? warp_sum(hits[2 * q] + shl16(hits[2 * q + 1])) : hits[2 * q] * 65537;

    float ki[K], kl[K];
    int ci[K], cl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int half = (k & 1) ? (pack[k >> 1] >> 16) : (pack[k >> 1] & 0xFFFF);
      const bool valid = (half > 0) && (ch8[k] != NONE);
      const bool is_leaf = ch8[k] <= -2;
      ki[k] = (valid && !is_leaf) ? rep[k] : BIG;
      kl[k] = (valid && is_leaf) ? rep[k] : BIG;
      ci[k] = ch8[k];
      cl[k] = ch8[k];
    }

    // ---- sorts + pair packing
    if (SORT) {
      sort8(ki, ci);
      sort8(kl, cl);
    }
    int n_int = 0, n_leaf = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      n_int += ki[k] < BIG ? 1 : 0;
      n_leaf += kl[k] < BIG ? 1 : 0;
    }
    int ci_e[K], cl_e[K];  // codes 1..7 of each sorted list, then an empty half
#pragma unroll
    for (int k = 1; k < K; ++k) {
      ci_e[k - 1] = ki[k] < BIG ? abs(ci[k]) : EMPTY16;
      cl_e[k - 1] = kl[k] < BIG ? abs(cl[k]) : EMPTY16;
    }
    ci_e[K - 1] = EMPTY16;
    cl_e[K - 1] = EMPTY16;
    int pair_i[K / 2], pair_l[K / 2];
#pragma unroll
    for (int e = 0; e < K / 2; ++e) {
      pair_i[e] = ci_e[2 * e] | shl16(ci_e[2 * e + 1]);
      pair_l[e] = cl_e[2 * e] | shl16(cl_e[2 * e + 1]);
    }
    const int lA_col = abs(cl[0]), desc_col = abs(ci[0]);

    // ---- scalar phase: the push/pop of both stacks (synthetic next task)
    if (SCALAR) {
      const int sp = s_sp[s], lsp = s_lsp[s], spare = s_ispare[s], lspare = s_lspare[s];
      const bool stall = lsp >= STACK_CAP - 4 - K;
      const int nh_i = !stall ? n_int : 0, nh_l = !stall ? n_leaf : 0;

      const bool has_spare = low16(spare) != EMPTY16;
      const int ne = nh_i >> 1;
      const bool spare_push = has_spare && (ne > 0);
      const int sp_eff = sp + (spare_push ? 1 : 0);
      const bool l_has = low16(lspare) != EMPTY16;
      const int nle = nh_l >> 1;
      const bool l_spush = l_has && (nle > 0);
      const int lsp_eff = lsp + (l_spush ? 1 : 0);
      if (lane == 0) {
        stack[sp] = spare;
#pragma unroll
        for (int e = K / 2 - 1; e >= 0; --e) stack[sp_eff + max(ne - 1 - e, 0)] = pair_i[e];
        lstack[lsp] = lspare;
#pragma unroll
        for (int e = K / 2 - 1; e >= 0; --e) lstack[lsp_eff + max(nle - 1 - e, 0)] = pair_l[e];
      }
      __syncwarp();

      const int new_sp = min(sp_eff + ne, STACK_CAP - 4);
      const int desc = nh_i > 0 ? desc_col : NONE;
      const int spare1 = spare_push ? SPARE_NONE : spare;
      const bool has_spare1 = has_spare && !spare_push;
      const bool use_spare = (desc == NONE) && has_spare1;
      const bool do_pop = (desc == NONE) && !has_spare1 && (new_sp > 0);
      const int popped = stack[max(new_sp - 1, 0)];
      const int nxt = stall ? nt
                      : desc != NONE ? desc
                      : use_spare    ? low16(spare1)
                      : do_pop       ? low16(popped)
                                     : NONE;
      const int ispare1 = use_spare ? consume(spare1) : do_pop ? consume(popped) : spare1;
      const int ntask1 = floormod(abs(nxt) + i, n_nodes);
      const int sp1 = do_pop ? new_sp - 1 : min(new_sp, STACK_CAP / 2);

      const int new_lsp = min(lsp_eff + nle, STACK_CAP - 4);
      const int lt0 = nh_l > 0 ? lA_col : NONE;
      const int lspare1 = l_spush ? SPARE_NONE : lspare;
      const bool l_has1 = l_has && !l_spush;
      const bool l_use = (lt0 == NONE) && l_has1;
      const bool l_pop = (lt0 == NONE) && !l_has1 && (new_lsp > 0);
      const int l_popped = lstack[max(new_lsp - 1, 0)];
      const int ltA = lt0 != NONE ? lt0 : l_use ? low16(lspare1) : l_pop ? low16(l_popped) : NONE;
      const int lspare2 = l_use ? consume(lspare1) : l_pop ? consume(l_popped) : lspare1;
      const int ltask1 = floormod(abs(ltA) + i, n_trirows);
      const int lsp1 = l_pop ? new_lsp - 1 : min(new_lsp, STACK_CAP / 2);
      if (lane == 0) {
        s_ntask[s] = ntask1;
        s_sp[s] = sp1;
        s_ispare[s] = ispare1;
        s_ltask[s] = ltask1;
        s_lsp[s] = lsp1;
        s_lspare[s] = lspare2;
      }
    } else {
      __syncwarp();  // every lane has read this iteration's tasks
      if (lane == 0) {
        s_ntask[s] = floormod(nt + 1, n_nodes);
        s_ltask[s] = floormod(lt + 1, n_trirows);
      }
    }
    __syncwarp();  // the next iteration reads what lane 0 wrote

    // ---- keep everything live
#pragma unroll
    for (int j = 0; j < LPT; ++j) L.t_best[j] = jmin(L.t_best[j], rep[0] + BIG);
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    out[(static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane + 32 * j] =
        L.t_best[j] + static_cast<float>(L.best[j]) * 0.0f;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, int, int, int,
                          float*);

// The kernels of no_slab .. no_scalar, instantiated in probe_v8_part2.cu so
// that nvcc compiles them beside probe_v8.cu's (cudalib starts one nvcc per
// source, all at once); nullptr for another variant.
KernelFn part2_kernel(int variant);

}  // namespace probe_v8
