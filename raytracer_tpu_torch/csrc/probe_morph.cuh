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
// A chain is W warps (W = 1, 2 or 4; probe.cuh), each thread holding N = 4
// / W of its lanes and their six-output records. Per iteration each warp
// of a chain issues its node record (7 of its lanes' 16-byte loads) and its
// triangle row (the leaf's, or the trailing zero row: one per lane)
// together into its slice of shared memory, where every thread reads the
// 16-byte words back as it uses them; the chain's lane 0 rep keys and the
// packed hit counts decide the next task (with W > 1 each warp's sums and
// lane 0's keys go through shared memory under the chain's named barrier,
// double buffered by iteration), and lane 0 pushes the other hit children
// onto the warp's copy of the chain's stack (stack_cap entries in dynamic
// shared memory, the tree's stack bound, which scene/builder.py sizes so no
// walk reaches it), so a pop needs no barrier. The brute pre-pass and the
// root-union test split over the chain's warps in the same way; the root
// test's hit count is summed across them.
//
// The loops. A finished WHILE chain (task NONE) changes nothing in the
// script's packet-wide loop: no push or pop and no hit on the zero row, so
// each WHILE chain loops on its own and stops when its next task is NONE,
// or at max_iters; the packet's loop count, the largest of its chains'
// counts, is their atomicMax into the count the entry point zeroed. A WHILE
// block is one chain (32 W threads), so a chain that ends early hands its
// SM slot to the next at once (blocks of 8 / W chains held a finished
// chain's warps until the block's last chain ended: at 1,056 packets the W
// = 1 `while` variants took 1.3-1.5x their W = 4 times, and one-chain
// blocks took v1_while from 4.43 to 4.12 ms). FORI and WHILECOUNTER chains
// all run the same count, so their blocks hold 8 / W chains (256 threads),
// which timed 3% faster than one-chain blocks at 1,056 packets.
// WHILEALIVECAP's stop is the packet's alive count in the same iteration,
// and its finished chains restart at the root, so a block is one packet of
// 8 chains (256 W threads) and the count is __syncthreads_count of each
// chain's leader thread.
//
// An unclamped push past the chain's own stack traps; the plain version
// raises there.
//
// What bounds it: the issue of the lanes' instructions (8 six-output MT
// records and 4 slabs per lane and iteration) and the dependence chain of
// one iteration (task -> rows -> records -> slabs -> reductions ->
// push/pop -> task), exposed where the card holds few warps (the script's 8
// packets); W > 1 adds warps and cuts each warp's lane work, and the
// wrapper picks W (probes/morph.chosen_w).
#pragma once
#include <cuda_runtime.h>

#include <utility>

#include "probe.cuh"

namespace probe_morph {

using namespace probe;

enum Loop { FORI, WHILE, WHILECOUNTER, WHILEALIVECAP };
constexpr int N_VARIANTS = 13;
constexpr int NREC_Q = 7;   // 16-byte words of a node record's 28 floats
constexpr int ROW_Q = 32;   // 16-byte words of a row

// The template arguments of each variant, in morph.VARIANTS order.
struct Spec {
  int loop;
  bool outs6, root, brute, clamp;
};
constexpr Spec SPECS[N_VARIANTS] = {
    {FORI, false, false, false, true},            // v0_ablate
    {WHILE, false, false, false, true},           // v1_while
    {WHILE, true, false, false, true},            // v2_outs6
    {WHILE, true, true, false, true},             // v3_rootinit
    {WHILE, true, true, true, true},              // v4_brute
    {WHILE, true, true, true, false},             // v5_noclamp
    {FORI, false, false, false, false},           // v0_noclamp
    {WHILECOUNTER, false, false, false, true},    // v6_whilecounter
    {WHILEALIVECAP, false, false, false, true},   // v7_whilealive_cap
    {WHILEALIVECAP, true, false, false, true},    // v8_cap_outs6
    {WHILEALIVECAP, true, true, false, true},     // v9_cap_rootinit
    {WHILEALIVECAP, true, true, true, true},      // v10_cap_brute
    {WHILEALIVECAP, true, true, true, false},     // v11_cap_noclamp
};

// WHILEALIVECAP's chains meet at a packet-wide barrier: a block is a packet.
__host__ __device__ constexpr bool packet_block(int loop) { return loop == WHILEALIVECAP; }
// Chains per block of a loop kind at chain width w: a packet, a chain
// (WHILE) or 256 threads.
__host__ __device__ constexpr int chains_of(int loop, int w) {
  return packet_block(loop) ? P_SUB : loop == WHILE ? 1 : P_SUB / w;
}
__host__ __device__ constexpr int block_of(int loop, int w) { return 32 * w * chains_of(loop, w); }
// The chain widths a variant admits (probes/morph.ADMITTED_W): each of 1, 2
// and 4, but for the six-output WHILEALIVECAP variants at W = 4, whose
// packet block of 1,024 threads leaves a thread 64 registers: v8_cap_outs6
// spilled 8 bytes there, the others sat at 63-64 (ptxas, sm_90a).
constexpr bool admits(int variant, int w) {
  return (w == 1 || w == 2 || w == 4) &&
         !(w == 4 && packet_block(SPECS[variant].loop) && SPECS[variant].outs6);
}
// Registers a thread may take: 80 (the room of 24 warps per SM) for the
// one-output kernels of W = 1, 128 (16 warps) for the six-output ones,
// which take 117-121 there, and for W > 1.
__host__ __device__ constexpr int regs_of(bool outs6, int w) {
  return w == 1 && !outs6 ? 80 : 128;
}
// The blocks per SM __launch_bounds__ makes room for at that budget (24 or
// 16 warps, probe.cuh warps_for_regs); at least one packet block.
__host__ __device__ constexpr int min_blocks(int loop, bool outs6, int w) {
  return warps_for_regs(regs_of(outs6, w)) / (block_of(loop, w) / 32) > 0
             ? warps_for_regs(regs_of(outs6, w)) / (block_of(loop, w) / 32)
             : 1;
}

template <int LOOP, bool OUTS6, bool ROOT, bool BRUTE, bool CLAMP, int W>
__global__ void __launch_bounds__(block_of(LOOP, W), min_blocks(LOOP, OUTS6, W))
    probe_morph_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tlim, int zero_row, int n_brute_rows,
                       int stack_cap, int iters, int max_iters, float* __restrict__ t_out,
                       int* __restrict__ id_out, int* __restrict__ mat_out,
                       float* __restrict__ nx_out, float* __restrict__ ny_out,
                       float* __restrict__ nz_out, int* __restrict__ iters_out) {
  constexpr bool PB = packet_block(LOOP);
  constexpr int N = LPT / W;                  // lanes per thread
  constexpr int CPB = chains_of(LOOP, W);      // chains per block
  constexpr int WPB = CPB * W;                 // warps per block
  constexpr int XB = W > 1 ? 2 : 1;            // buffers by iteration parity
  extern __shared__ int s_stack[];             // [WPB][stack_cap]: each warp's copy
  __shared__ int s_task[WPB], s_sp[WPB];       // one per warp
  __shared__ float4 s_nrec[WPB][NREC_Q];       // each warp's loaded rows
  __shared__ float4 s_trow[WPB][ROW_Q];
  __shared__ float s_rep[XB][CPB][4];          // the chain's lane 0 keys (W > 1)
  __shared__ int s_pab[XB][CPB][W][2];         // each warp's packed hit sums (W > 1)
  __shared__ int s_root[CPB][W];               // each warp's root hits (W > 1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp / W, ws = warp % W;  // chain in the block, warp in the chain
  const int chain = blockIdx.x * CPB + c;
  const int p = chain / P_SUB, s = chain % P_SUB;
  const int lane0 = lane + 32 * N * ws;   // the thread's first lane of the chain
  const bool leader = ws == 0 && lane == 0;
  // The thread's first lane in the [P, 8, 128] outputs, made again where
  // used (held across the loop it takes two registers the 1,024-thread
  // packet block of W = 4 lacks).
  auto out_base = [&]() { return (static_cast<size_t>(p) * P_SUB + s) * P_LANE + lane0; };
  LanesN<N> L;
  RecN<N> R;
  load_rays(L, o, d, p, s, lane0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    L.t_best[j] = tlim[out_base() + 32 * j];
    L.best[j] = NONE;
    R.mat[j] = 0;
    R.nx[j] = 0.0f;
    R.ny[j] = 0.0f;
    R.nz[j] = 0.0f;
  }
  const int sbase = warp * stack_cap;  // the warp's copy of the chain's stack
  // Chain barrier: a warp's own __syncwarp where the chain is one warp.
  auto sync_chain = [&]() {
    if (W == 1) {
      __syncwarp();
    } else {
      chain_sync(1 + c, 32 * W);
    }
  };

  if (BRUTE) {
    for (int r = zero_row - n_brute_rows; r < zero_row; ++r) {
      s_trow[warp][lane] = row_word(tri + static_cast<size_t>(r) * ROW, lane);
      __syncwarp();
      mt_row8(L, R, s_trow[warp]);
      __syncwarp();  // every lane has read the row before the next is stored
    }
  }

  bool alive = true;
  if (ROOT) {
    float box[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box[k] = jmin(jmin(node[k], node[6 + k]), jmin(node[12 + k], node[18 + k]));
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = node[6 * q + 3] > -BIG ? node[6 * q + 3 + k] : -BIG;
      box[3 + k] = jmax(jmax(v[0], v[1]), jmax(v[2], v[3]));
    }
    int hits = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float tm;
      hits += slab(L, j, box, tm) ? 1 : 0;
    }
    hits = warp_sum(hits);
    if (W > 1) {
      if (lane == 0) s_root[c][ws] = hits;
      sync_chain();
      hits = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) hits += s_root[c][w];
    }
    alive = hits > 0;
  }
  if (lane == 0) {
    s_task[warp] = alive ? 0 : NONE;
    s_sp[warp] = 0;
  }
  __syncwarp();
  // WHILEALIVECAP: the packet's chains alive, counted once per chain.
  int n_alive = PB ? __syncthreads_count(leader && alive) : 0;

  // Iteration i of the chain; returns its next task before any restart.
  auto body = [&](int i) -> int {
    const int task = s_task[warp];
    const bool is_int = task >= 0, is_leaf = task <= -2;
    const float* nrow = node + static_cast<size_t>(is_int ? floordiv(task, 4) : 0) * ROW;
    const float* nrec = nrow + NODE_STRIDE * (is_int ? floormod(task, 4) : 0);
    const float* trow =
        tri + static_cast<size_t>(is_leaf ? floordiv(neg2(task), 64) : zero_row) * ROW;
    float4 wn;
    if (lane < NREC_Q) wn = row_word(nrec, lane);
    const float4 wt = row_word(trow, lane);
    if (lane < NREC_Q) s_nrec[warp][lane] = wn;
    s_trow[warp][lane] = wt;
    __syncwarp();
    const float4* nq = s_nrec[warp];
    auto nf = [&](int f) { return elem(nq[f >> 2], f & 3); };

    // ---- leaf: the 8 records of the row
    mt_row8(L, R, s_trow[warp]);

    // ---- internal: 4 slabs, lane 0's rep keys, the packed hit counts
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
    int pa = warp_sum(hits[0] + shl16(hits[1]));
    int pb = warp_sum(hits[2] + shl16(hits[3]));
    float rep[4];
    if (W == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) rep[k] = __shfl_sync(FULL, r0[k], 0);
    } else {
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

    // ---- scalar: the chain's decision and push/pop
    int ch[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ch[k] = f2i(nf(24 + k));
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
    const int sp = s_sp[warp];
    if (!CLAMP && sp + max(nhit - 2, 0) >= stack_cap) __trap();  // past the chain's stack
    if (lane == 0) {
      s_stack[sbase + sp + max(nhit - 4, 0)] = cc[3];
      s_stack[sbase + sp + max(nhit - 3, 0)] = cc[2];
      s_stack[sbase + sp + max(nhit - 2, 0)] = cc[1];
    }
    __syncwarp();
    const int nsp = CLAMP ? min(sp + max(nhit - 1, 0), stack_cap - 4) : sp + max(nhit - 1, 0);
    const int desc = nhit > 0 ? cc[0] : NONE;
    const bool do_pop = (desc == NONE) && (nsp > 0) && (task != NONE);
    const int popped = s_stack[sbase + max(nsp - 1, 0)];
    const int nxt = do_pop ? popped : desc;
    __syncwarp();  // every lane has read this iteration's task, rows and stack
    if (lane == 0) {
      // WHILE keeps a finished chain at NONE; the others restart it at the root.
      s_task[warp] = LOOP == WHILE ? nxt : (nxt == NONE ? 0 : nxt);
      s_sp[warp] = do_pop ? nsp - 1 : nsp;
    }
    __syncwarp();  // the next iteration reads what lane 0 wrote
    return nxt;
  };

  int it = 0;
  if (LOOP == FORI) {
    for (; it < iters; ++it) body(it);
  } else if (LOOP == WHILECOUNTER) {
    for (int k = iters; k > 0; --k, ++it) body(it);
  } else if (LOOP == WHILE) {
    // max_iters guards the card against a walk that never ends; the plain
    // version stops there too, and the entry point checks it was not hit.
    for (; alive && it < max_iters; ++it) alive = body(it) != NONE;
  } else {
    for (int k = iters; k > 0 && n_alive > 0; --k, ++it) {
      const int nxt = body(it);
      n_alive = __syncthreads_count(leader && nxt != NONE);
    }
  }

#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t q = out_base() + 32 * j;
    t_out[q] = L.t_best[j];
    if (OUTS6) {
      id_out[q] = L.best[j];
      mat_out[q] = R.mat[j];
      nx_out[q] = R.nx[j];
      ny_out[q] = R.ny[j];
      nz_out[q] = R.nz[j];
    }
  }
  if (LOOP == WHILE) {
    if (leader) atomicMax(iters_out + p, it);  // zeroed by the entry point
  } else if (leader && s == 0) {
    iters_out[p] = it;
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, int, int, int, float*, int*, int*, float*, float*, float*,
                          int*);

// The kernel of variant V at chain width W, nullptr for a W that V does not
// admit.
template <int V, int W>
KernelFn kernel_if_admitted() {
  if constexpr (admits(V, W)) {
    constexpr Spec S = SPECS[V];
    return probe_morph_kernel<S.loop, S.outs6, S.root, S.brute, S.clamp, W>;
  } else {
    return nullptr;
  }
}

// The kernel of `variant` at chain width W when LO <= variant < HI, else
// nullptr.
template <int W, int LO, int... I>
KernelFn kernel_in(int variant, std::integer_sequence<int, I...>) {
  // Not static: a template's static local is one symbol for the whole process
  // (GNU unique), so two builds of these sources loaded side by side (phase
  // 15 of chip_smoke.py loads the parent's) would launch each other's stubs.
  const KernelFn table[] = {kernel_if_admitted<LO + I, W>()...};
  return variant >= LO && variant < LO + static_cast<int>(sizeof...(I)) ? table[variant - LO]
                                                                         : nullptr;
}
template <int W, int LO, int HI>
KernelFn kernels_in(int variant) {
  return kernel_in<W, LO>(variant, std::make_integer_sequence<int, HI - LO>{});
}

// The kernels of each chain width, spread over sources so that nvcc compiles
// them in parallel (cudalib starts one nvcc per source, all at once):
// probe_morph.cu (W = 1, v0_ablate .. v0_noclamp), probe_morph_part2.cu
// (W = 1, v6_whilecounter .. v11_cap_noclamp), probe_morph_part3.cu (W =
// 2) and probe_morph_part4.cu (W = 4). nullptr for another variant or width.
constexpr int SPLIT = 7;
KernelFn kernel_w1_hi(int variant);
KernelFn kernel_w2(int variant);
KernelFn kernel_w4(int variant);

}  // namespace probe_morph
