// P-interleave: the v5 `full` traversal body with G independent chains in
// one thread's instruction stream, G in {1, 2, 4, 8}.
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
// instruction stream hide it? The card's form of it: a chain group is W
// warps (W = 1, 2 or 4) that carry G chains, chain s of each of G packets;
// a thread holds 4 / W lanes of each, 4 G / W in all, so G dependence chains
// interleave inside one thread. Each iteration takes the script's phase
// order: fetch (every warp reads the G tasks and issues the G node records
// and G triangle rows together, 16-byte words in registers), compute (chain
// by chain, its words stored into the warp's slice of shared memory and
// read back word by word where used, then its 8 MT records, 4 slabs and hit
// counts: a chain's compute waits for its own loads, not the others'), decide
// (each chain's push/pop on the warp's copy of its 40-entry stack, so a pop
// needs no barrier). With W > 1 the G chains' partial hit sums and lane 0
// rep keys go through shared memory under the group's named barrier, one
// per iteration, double buffered by iteration parity. At G = 1 this is the
// v5 full body's design (probe_v5.cuh) at the same W, block and register
// budget. A block holds 8 / (W G) chain groups, at least one: G = 1 the v5
// body's 256 threads, the wider G smaller blocks, so a small grid still
// spreads over the SMs.
//
// What bounds it: the issue of the lanes' instructions (8 MT records and 4
// slabs per lane, 540 fp32 operations) with the dependence chain of one
// iteration exposed where the card holds few warps; more ILP per thread
// costs registers, 11 per lane held, so a G is built only at the W at which
// its 4 G / W lanes fit without spilling (admits). The wrapper takes the
// widest of those that leaves a thread two lanes or more
// (probes/interleave_probe.chosen_w), the fastest W of each G at 128 and
// at 1,056 packets on an H100 (chip_smoke.py phase 13).
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_interleave {

using namespace probe;

constexpr int STACK_CAP = 40;
constexpr int NREC_Q = 7;   // 16-byte words of a node record's 28 floats
constexpr int ROW_Q = 32;   // 16-byte words of a row
constexpr int N_G = 4;      // G = 1, 2, 4, 8

// The chain widths G admits (probes/interleave_probe.ADMITTED_W): those at
// which a thread's 4 G / W lanes (11 registers each) fit in its registers
// without spilling (ptxas, sm_90a): G = 8 needs W >= 2.
__host__ __device__ constexpr bool admits(int g, int w) {
  return (w == 1 || w == 2 || w == 4) && 4 * g / w <= 16;
}
// Chain groups per block: 8 / (W G), at least one.
__host__ __device__ constexpr int groups_of(int g, int w) {
  return g * w >= P_SUB ? 1 : P_SUB / (g * w);
}
__host__ __device__ constexpr int block_of(int g, int w) { return 32 * w * groups_of(g, w); }
// Registers a thread may take, from what it holds: 11 per lane and 8 per
// chain for the fetch's two 16-byte words in flight. 80 up to 60 of them
// (the v5 full body's budget, three 256-thread blocks per SM at G = 1 and
// W = 1), 128 up to 110, 168 up to 150, else the most (ptxas, sm_90a: at
// 80 G = 4 / W = 4 spilled, at 128 G = 8 / W = 4 and G = 4 / W = 2).
__host__ __device__ constexpr int need_of(int g, int w) { return 11 * 4 * g / w + 8 * g; }
__host__ __device__ constexpr int regs_of(int g, int w) {
  return need_of(g, w) <= 60 ? 80 : need_of(g, w) <= 110 ? 128 : need_of(g, w) <= 150 ? 168 : 255;
}
// The blocks per SM __launch_bounds__ makes room for at that budget
// (probe.cuh warps_for_regs; the v5 body's three or two at G = 1).
__host__ __device__ constexpr int min_blocks(int g, int w) {
  return g == 1 ? (w == 1 ? 3 : 2)
                : (warps_for_regs(regs_of(g, w)) / (block_of(g, w) / 32) > 0
                       ? warps_for_regs(regs_of(g, w)) / (block_of(g, w) / 32)
                       : 1);
}

template <int G, int W>
__global__ void __launch_bounds__(block_of(G, W), min_blocks(G, W))
    probe_interleave_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                            const float* __restrict__ o, const float* __restrict__ d,
                            const float* __restrict__ tlim, int zero_row, int iters,
                            float* __restrict__ out) {
  constexpr int N = LPT / W;              // lanes per thread of each chain
  constexpr int CPB = groups_of(G, W);    // chain groups per block
  constexpr int WPB = CPB * W;            // warps per block
  constexpr int XB = W > 1 ? 2 : 1;       // buffers by iteration parity
  __shared__ int s_task[WPB][G], s_sp[WPB][G];          // one per warp and chain
  __shared__ int s_stack[WPB][G][STACK_CAP];
  __shared__ float4 s_nrec[WPB][G][NREC_Q];             // each warp's loaded rows
  __shared__ float4 s_trow[WPB][G][ROW_Q];
  __shared__ float s_rep[XB][CPB][G][4];                // each chain's lane 0 keys (W > 1)
  __shared__ int s_pab[XB][CPB][W][G][2];               // each warp's packed hit sums (W > 1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp / W, ws = warp % W;  // group in the block, warp in the group
  const int group = blockIdx.x * CPB + c;
  const int s = group % P_SUB, p0 = (group / P_SUB) * G;  // chain s of packets p0 .. p0 + G - 1
  const int lane0 = lane + 32 * N * ws;   // the thread's first lane of each chain
  LanesN<N> L[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_rays(L[g], o, d, p0 + g, s, lane0);
    const size_t base = (static_cast<size_t>(p0 + g) * P_SUB + s) * P_LANE + lane0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L[g].t_best[j] = tlim[base + 32 * j];
      L[g].best[j] = NONE;
    }
    if (lane == 0) {
      s_task[warp][g] = 0;
      s_sp[warp][g] = 0;
    }
  }
  __syncwarp();

  for (int i = 0; i < iters; ++i) {
    // ---- fetch: the G tasks, and the G node records and triangle rows
    // issued together into the warp's slice of shared memory
    float4 wn[G], wt[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int task = s_task[warp][g];
      const bool is_int = task >= 0, is_leaf = task <= -2;
      const float* nrow = node + static_cast<size_t>(is_int ? floordiv(task, 4) : 0) * ROW;
      const float* nrec = nrow + NODE_STRIDE * (is_int ? floormod(task, 4) : 0);
      const float* trow =
          tri + static_cast<size_t>(is_leaf ? floordiv(neg2(task), 64) : zero_row) * ROW;
      if (lane < NREC_Q) wn[g] = row_word(nrec, lane);
      wt[g] = row_word(trow, lane);
    }

    // ---- compute: each chain's 8 MT records, 4 slabs and hit counts, its
    // rows stored and read back as they come (the next chain's loads land
    // meanwhile)
    float rep[W == 1 ? G : 1][4];
    int pab[W == 1 ? G : 1][2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane < NREC_Q) s_nrec[warp][g][lane] = wn[g];
      s_trow[warp][g][lane] = wt[g];
      __syncwarp();
      const float4* nq = s_nrec[warp][g];
      const float4* tq = s_trow[warp][g];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4* q = tq + k * (TRI_STRIDE / 4);
        float r[9];
#pragma unroll
        for (int f = 0; f < 9; ++f) r[f] = elem(q[f >> 2], f & 3);
        mt_record(L[g], r, f2i(q[2].y));
      }
      float r0[4];
      int hits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float b[6];
#pragma unroll
        for (int f = 0; f < 6; ++f) b[f] = elem(nq[(k * 6 + f) >> 2], (k * 6 + f) & 3);
        r0[k] = 0.0f;
        hits[k] = 0;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float tk;
          const bool h = slab(L[g], j, b, tk);
          if (j == 0) r0[k] = h ? tk : HALF_BIG;
          hits[k] += h ? 1 : 0;
        }
      }
      const int pa = warp_sum(hits[0] + shl16(hits[1]));
      const int pb = warp_sum(hits[2] + shl16(hits[3]));
      if constexpr (W == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) rep[g][k] = __shfl_sync(FULL, r0[k], 0);
        pab[g][0] = pa;
        pab[g][1] = pb;
      } else if (lane == 0) {
        s_pab[i & (XB - 1)][c][ws][g][0] = pa;
        s_pab[i & (XB - 1)][c][ws][g][1] = pb;
        if (ws == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) s_rep[i & (XB - 1)][c][g][k] = r0[k];
        }
      }
    }
    if (W > 1) chain_sync(1 + c, 32 * W);

    // ---- decide: each chain pushes, pops and takes its next task
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4* nq = s_nrec[warp][g];
      const int task = s_task[warp][g];
      const bool is_int = task >= 0;
      float rk[4];
      int pa, pb;
      if constexpr (W == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) rk[k] = rep[g][k];
        pa = pab[g][0];
        pb = pab[g][1];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) rk[k] = s_rep[i & (XB - 1)][c][g][k];
        pa = s_pab[i & (XB - 1)][c][0][g][0];
        pb = s_pab[i & (XB - 1)][c][0][g][1];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          pa += s_pab[i & (XB - 1)][c][w][g][0];
          pb += s_pab[i & (XB - 1)][c][w][g][1];
        }
      }
      int ch[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ch[k] = f2i(elem(nq[(24 + k) >> 2], (24 + k) & 3));
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
        tm[k] = anyk[k] ? rk[k] : BIG;
        cc[k] = ch[k];
      }
      PROBE_CSWAP(tm, cc, 0, 2) PROBE_CSWAP(tm, cc, 1, 3) PROBE_CSWAP(tm, cc, 0, 1)
      PROBE_CSWAP(tm, cc, 2, 3) PROBE_CSWAP(tm, cc, 1, 2)
      int* stack = s_stack[warp][g];
      const int sp = s_sp[warp][g];
      if (lane == 0) {
        stack[sp + max(nhit - 4, 0)] = cc[3];
        stack[sp + max(nhit - 3, 0)] = cc[2];
        stack[sp + max(nhit - 2, 0)] = cc[1];
      }
      __syncwarp();  // every lane has read the chain's task and stack pointer
      const int nsp = min(sp + max(nhit - 1, 0), STACK_CAP - 4);
      const int desc = nhit > 0 ? cc[0] : NONE;
      const bool do_pop = (desc == NONE) && (nsp > 0) && (task != NONE);
      const int popped = stack[max(nsp - 1, 0)];
      const int nxt = do_pop ? popped : desc;
      if (lane == 0) {
        s_task[warp][g] = nxt == NONE ? 0 : nxt;  // a finished walk restarts at the root
        s_sp[warp][g] = do_pop ? nsp - 1 : nsp;
      }
    }
    __syncwarp();  // the next iteration reads what lane 0 wrote, and rewrites the rows
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t base = (static_cast<size_t>(p0 + g) * P_SUB + s) * P_LANE + lane0;
#pragma unroll
    for (int j = 0; j < N; ++j) out[base + 32 * j] = L[g].t_best[j];
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, float*);

template <int G, int W>
KernelFn kernel_if_admitted() {
  if constexpr (admits(G, W)) {
    return probe_interleave_kernel<G, W>;
  } else {
    return nullptr;
  }
}

template <int G>
KernelFn kernel_at(int w) {
  switch (w) {
    case 1: return kernel_if_admitted<G, 1>();
    case 2: return kernel_if_admitted<G, 2>();
    case 4: return kernel_if_admitted<G, 4>();
    default: return nullptr;
  }
}

// The kernel of G = 1 << gi at chain width w, nullptr where not built.
KernelFn kernel_of(int gi, int w) {
  switch (gi) {
    case 0: return kernel_at<1>(w);
    case 1: return kernel_at<2>(w);
    case 2: return kernel_at<4>(w);
    case 3: return kernel_at<8>(w);
    default: return nullptr;
  }
}

}  // namespace probe_interleave

using namespace probe_interleave;

// t f32[packets, 8, 128] of `iters` iterations of the v5 full body, G = 1
// << gi chains per thread, at chain width w; the v5 tables (16-byte
// aligned), rays and limits as rt_probe_v5 takes them. packets must be a
// multiple of G; cudaErrorInvalidValue for a w that G does not admit. The
// caller picks w (probes/interleave_probe.chosen_w).
extern "C" int rt_probe_interleave_w(const float* node, const float* tri, const float* o,
                                     const float* d, const float* tlim, int zero_row, int iters,
                                     int packets, int gi, int w, float* out, void* stream) {
  const KernelFn k = kernel_of(gi, w);
  if (k == nullptr || iters < 0 || packets < 0 || zero_row < 0 || packets % (1 << gi) != 0 ||
      (reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(tri)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_of(1 << gi, w);
  const long long warps = static_cast<long long>(packets >> gi) * P_SUB * w;
  if (packets > 0)
    k<<<static_cast<int>(warps * 32 / threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, tlim, zero_row, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of the G = 1 << gi kernel
// at chain width w; cudaErrorInvalidValue where it is not built.
extern "C" int rt_probe_interleave_attrs_w(int gi, int w, int* num_regs, int* local_bytes) {
  const KernelFn k = kernel_of(gi, w);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
