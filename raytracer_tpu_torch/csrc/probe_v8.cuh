// P-v8: the fixed-iteration round-5 BVH8 traversal body with one phase
// knocked out per variant (fetch, leaf, slab, reduce, sort, scalar).
//
// Replaces scripts/kernel_ablate_v8.py make_kernel (:49; TPU call :360).
// Wrapper and plain PyTorch version: raytracer_tpu_torch/probes/ablate_v8.py
// (`ablate_v8`, `ablate_v8_plain`), which take the same operations in the
// same order, so the two agree bit for bit.
//
// A chain is W warps (W = 1, 2 or 4; probe.cuh), a block of 256 threads holds
// 8 / W chains, the grid packets * W blocks. Per iteration each warp of a
// chain issues its node row (56 floats: 14 lanes' 16-byte loads) and its
// triangle row (512 bytes: a 16-byte load per lane) together into its slice
// of shared memory, where every thread reads a record's 16-byte words back as
// it uses them (38 per iteration for the 136 floats), every thread tests its
// 4 / W lanes against 8 triangle records and 8 child boxes, the 8 rep keys
// are min-reductions and the 4 packed hit counts int32 sums over the chain (a
// warp butterfly; with W > 1 then each warp's result through shared memory
// under the chain's named barrier, double buffered by iteration), both 8-key
// sorting networks, the pair packing and the push/pop decision run chain-
// uniform in every thread, and the task, stack pointers and spares are
// registers of every thread. Each warp keeps its own copy of the chain's two
// 68-entry stacks in shared memory: its lane 0 pushes and pops and broadcasts
// the popped entries, so no barrier is needed for them. The task streams are
// synthetic ((|next| + i) mod rows), so every variant runs the same
// iterations.
//
// What bounds it: the issue of the lanes' instructions (8 MT records and 8
// slabs per lane, ~660 fp32 operations) and the chain-uniform work every
// warp repeats, with the dependence chain of one iteration (task → rows →
// records → slabs → reductions → sorts → push/pop → task) exposed where the
// card holds few warps. At the script's 64 packets a warp per chain leaves
// one warp per scheduler (512 warps on 132 SMs): W = 2 puts two there and
// halves each warp's lane work; at 1,056 packets the card is full and W = 1
// pays the chain-uniform work once. The entry point picks W from the packets
// and the SM count (rt_probe_v8_pick_w).
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
constexpr int BLOCK = P_SUB * 32;     // threads per block at every W
constexpr int NODE_Q = 14;            // 16-byte words of a node row's 56 floats
enum Variant { FULL_BODY, NO_FETCH, NO_LEAF, NO_SLAB, NO_REDUCE, NO_SORT, NO_SCALAR, N_VARIANTS };

// The chain widths every variant admits (probes/ablate_v8.ADMITTED_W), and
// the warps per SM up to which the entry point widens a chain
// (probes/ablate_v8.WARPS_PER_SM: every warp repeats two sorts and both
// stacks' push/pop, so W = 2 beat W = 4 at the script's 64 packets).
constexpr bool admits(int w) { return w == 1 || w == 2 || w == 4; }
constexpr int WARPS_PER_SM = 8;

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

template <int V, int W>
__global__ void __launch_bounds__(BLOCK, 2)
    probe_v8_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                    const float* __restrict__ o, const float* __restrict__ d, int n_nodes,
                    int n_trirows, int iters, float* __restrict__ out) {
  constexpr bool FETCH = V != NO_FETCH, LEAF = V != NO_LEAF, SLAB = V != NO_SLAB;
  constexpr bool REDUCE = V != NO_REDUCE, SORT = V != NO_SORT, SCALAR = V != NO_SCALAR;
  constexpr int N = LPT / W;        // lanes per thread
  constexpr int CPB = P_SUB / W;    // chains per block
  constexpr int XB = W > 1 ? 2 : 1;  // exchange buffers (by iteration parity)
  __shared__ int s_stack[P_SUB][STACK_CAP], s_lstack[P_SUB][STACK_CAP];  // one pair per warp
  __shared__ float4 s_node[P_SUB][NODE_Q], s_tri[P_SUB][LEAF ? 32 : 1];   // each warp's rows
  __shared__ __align__(16) float s_rep[XB][CPB][W][K];
  __shared__ __align__(16) int s_pack[XB][CPB][W][K / 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp / W, ws = warp % W;  // chain in the block, warp in the chain
  const int chain = blockIdx.x * CPB + c;
  const int p = chain / P_SUB, s = chain % P_SUB;
  const int lane0 = lane + 32 * N * ws;   // the thread's first lane of the chain
  LanesN<N> L;
  load_rays(L, o, d, p, s, lane0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    L.t_best[j] = BIG;
    L.best[j] = NONE;
  }
  int nt = s, lt = s, sp = 0, lsp = 0, ispare = SPARE_NONE, lspare = SPARE_NONE;
  int* stack = s_stack[warp];
  int* lstack = s_lstack[warp];

  for (int i = 0; i < iters; ++i) {
    // ---- fetch: both rows' loads issued together, one word per lane
    const float* nrow = FETCH ? node + static_cast<size_t>(nt >= 0 ? nt : 0) * ROW : opaque(node);
    const float* trow = tri + static_cast<size_t>(lt >= 0 ? lt : 0) * ROW;
    float4 wn, wt;
    if (lane < NODE_Q) wn = row_word(nrow, lane);
    if (LEAF) wt = row_word(trow, lane);
    __syncwarp();  // every lane has read the last iteration's rows
    if (lane < NODE_Q) s_node[warp][lane] = wn;
    if (LEAF) s_tri[warp][lane] = wt;
    __syncwarp();
    const float4* nq = s_node[warp];
    const float4* tq = s_tri[warp];
    auto nf = [&](int f) { return elem(nq[f >> 2], f & 3); };
    int ch8[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ch8[k] = f2i(nf(6 * K + k));

    // ---- leaf block
    if (LEAF) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float r[9];
#pragma unroll
        for (int f = 0; f < 9; ++f) r[f] = elem(tq[k * TRI_STRIDE / 4 + (f >> 2)], f & 3);
        mt_record(L, r, f2i(elem(tq[k * TRI_STRIDE / 4 + 2], 1)));
      }
    }

    // ---- slabs and the reductions (rep keys + packs)
    float rep[K];
    int cnt[K], h0[K];
    float t0[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float b[6];
#pragma unroll
      for (int f = 0; f < 6; ++f) b[f] = nf(k * 6 + f);
      float rmin = BIG;
      cnt[k] = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float tk;
        bool h;
        if (SLAB) {
          h = slab(L, j, b, tk);
        } else {
          h = (L.ox[j] + static_cast<float>(i)) > 0.5f;
          tk = L.ox[j];
        }
        if (j == 0) {
          h0[k] = h ? 1 : 0;
          t0[k] = tk;
        }
        rmin = fminf(rmin, h ? tk : BIG);  // tk is no NaN where h holds
        cnt[k] += h ? 1 : 0;
      }
      rep[k] = rmin;
    }
    int pack[K / 2];
    if (REDUCE) {
#pragma unroll
      for (int k = 0; k < K; ++k) rep[k] = warp_min(rep[k]);
#pragma unroll
      for (int q = 0; q < K / 2; ++q) pack[q] = warp_sum(cnt[2 * q] + shl16(cnt[2 * q + 1]));
    } else if (W == 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) rep[k] = __shfl_sync(FULL, t0[k], 0);
#pragma unroll
      for (int q = 0; q < K / 2; ++q) pack[q] = __shfl_sync(FULL, h0[2 * q], 0) * 65537;
    }
    if (W > 1) {
      // Each warp's minima and sums (REDUCE), or the chain's lane 0 values
      // (no_reduce: warp 0 alone), through shared memory.
      float(&xr)[W][K] = s_rep[i & (XB - 1)][c];
      int(&xp)[W][K / 2] = s_pack[i & (XB - 1)][c];
      if (lane == 0 && (REDUCE || ws == 0)) {
#pragma unroll
        for (int k = 0; k < K; ++k) xr[ws][k] = REDUCE ? rep[k] : t0[k];
#pragma unroll
        for (int q = 0; q < K / 2; ++q) xp[ws][q] = REDUCE ? pack[q] : h0[2 * q] * 65537;
      }
      chain_sync(1 + c, 32 * W);
#pragma unroll
      for (int k = 0; k < K; ++k) rep[k] = xr[0][k];
#pragma unroll
      for (int q = 0; q < K / 2; ++q) pack[q] = xp[0][q];
      if (REDUCE) {
#pragma unroll
        for (int w = 1; w < W; ++w) {
#pragma unroll
          for (int k = 0; k < K; ++k) rep[k] = fminf(rep[k], xr[w][k]);
#pragma unroll
          for (int q = 0; q < K / 2; ++q) pack[q] += xp[w][q];
        }
      }
    }

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
      const bool stall = lsp >= STACK_CAP - 4 - K;
      const int nh_i = !stall ? n_int : 0, nh_l = !stall ? n_leaf : 0;

      const bool has_spare = low16(ispare) != EMPTY16;
      const int ne = nh_i >> 1;
      const bool spare_push = has_spare && (ne > 0);
      const int sp_eff = sp + (spare_push ? 1 : 0);
      const int new_sp = min(sp_eff + ne, STACK_CAP - 4);
      const bool l_has = low16(lspare) != EMPTY16;
      const int nle = nh_l >> 1;
      const bool l_spush = l_has && (nle > 0);
      const int lsp_eff = lsp + (l_spush ? 1 : 0);
      const int new_lsp = min(lsp_eff + nle, STACK_CAP - 4);
      int popped = 0, l_popped = 0;
      if (lane == 0) {
        stack[sp] = ispare;
#pragma unroll
        for (int e = K / 2 - 1; e >= 0; --e) stack[sp_eff + max(ne - 1 - e, 0)] = pair_i[e];
        lstack[lsp] = lspare;
#pragma unroll
        for (int e = K / 2 - 1; e >= 0; --e) lstack[lsp_eff + max(nle - 1 - e, 0)] = pair_l[e];
        popped = stack[max(new_sp - 1, 0)];
        l_popped = lstack[max(new_lsp - 1, 0)];
      }
      popped = __shfl_sync(FULL, popped, 0);
      l_popped = __shfl_sync(FULL, l_popped, 0);

      const int desc = nh_i > 0 ? desc_col : NONE;
      const int spare1 = spare_push ? SPARE_NONE : ispare;
      const bool has_spare1 = has_spare && !spare_push;
      const bool use_spare = (desc == NONE) && has_spare1;
      const bool do_pop = (desc == NONE) && !has_spare1 && (new_sp > 0);
      const int nxt = stall ? nt
                      : desc != NONE ? desc
                      : use_spare    ? low16(spare1)
                      : do_pop       ? low16(popped)
                                     : NONE;
      ispare = use_spare ? consume(spare1) : do_pop ? consume(popped) : spare1;
      nt = floormod(abs(nxt) + i, n_nodes);
      sp = do_pop ? new_sp - 1 : min(new_sp, STACK_CAP / 2);

      const int lt0 = nh_l > 0 ? lA_col : NONE;
      const int lspare1 = l_spush ? SPARE_NONE : lspare;
      const bool l_has1 = l_has && !l_spush;
      const bool l_use = (lt0 == NONE) && l_has1;
      const bool l_pop = (lt0 == NONE) && !l_has1 && (new_lsp > 0);
      const int ltA = lt0 != NONE ? lt0 : l_use ? low16(lspare1) : l_pop ? low16(l_popped) : NONE;
      lspare = l_use ? consume(lspare1) : l_pop ? consume(l_popped) : lspare1;
      lt = floormod(abs(ltA) + i, n_trirows);
      lsp = l_pop ? new_lsp - 1 : min(new_lsp, STACK_CAP / 2);
    } else {
      nt = floormod(nt + 1, n_nodes);
      lt = floormod(lt + 1, n_trirows);
    }

    // ---- keep everything live
#pragma unroll
    for (int j = 0; j < N; ++j) L.t_best[j] = jmin(L.t_best[j], rep[0] + BIG);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    out[(static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane0 + 32 * j] =
        L.t_best[j] + static_cast<float>(L.best[j]) * 0.0f;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, int, int, int,
                          float*);

// The kernel of `variant` at chain width W, nullptr for a W not admitted.
template <int W>
KernelFn kernel_at(int variant) {
  if constexpr (!admits(W)) {
    return nullptr;
  } else {
    switch (variant) {
      case FULL_BODY: return probe_v8_kernel<FULL_BODY, W>;
      case NO_FETCH: return probe_v8_kernel<NO_FETCH, W>;
      case NO_LEAF: return probe_v8_kernel<NO_LEAF, W>;
      case NO_SLAB: return probe_v8_kernel<NO_SLAB, W>;
      case NO_REDUCE: return probe_v8_kernel<NO_REDUCE, W>;
      case NO_SORT: return probe_v8_kernel<NO_SORT, W>;
      case NO_SCALAR: return probe_v8_kernel<NO_SCALAR, W>;
      default: return nullptr;
    }
  }
}

// The kernels of W = 2 and W = 4, instantiated in probe_v8_part2.cu and
// probe_v8_part3.cu so that nvcc compiles them beside probe_v8.cu's W = 1
// (cudalib starts one nvcc per source, all at once).
KernelFn kernel_w2(int variant);
KernelFn kernel_w4(int variant);

}  // namespace probe_v8
