// P-v6: dual-unit traversal of a 4-wide tree in the row-per-node v6 tables.
//
// Replaces scripts/kernel_v6_probe.py _make_kernel_v6 (:94; TPU call :358)
// and its body _kernel_body_v6 (:124). Wrapper, plain PyTorch version and
// entry point: raytracer_tpu_torch/probes/v6.py (`v6`, `v6_plain`, `main`),
// which take the same operations in the same order, so the two agree bit
// for bit; tables: probes/v6_tables.py.
//
// What a chain does. After the brute-force pre-pass, a chain starts at node
// 0 if any of its lanes hits the union of the root's child boxes (the max
// side guarded by max > -BIG), at NONE otherwise. In each iteration both
// units of the chain run:
//   - the leaf unit sweeps the 8 records of triangle row `lt` (the zero row
//     when idle) and updates t_best, best, mat and the normal;
//   - the internal unit slabs the 4 children of node row `nt` (row 0 when
//     the chain has no node) against the updated t_best.
// Lane 0's entry distances are the sort keys (HALF_BIG for a child only
// other lanes hit); a child counts as hit if any lane hits it (the packed
// sums pa, pb). Internal and leaf children are sorted apart by the
// 5-comparator network, and the other hit children are pushed far to near,
// with the script's clamped stores, onto the chain's node stack and
// leaf-row stack; a chain whose leaf stack is within 8 of full repeats its
// node (the stall guard). Both clamps and the guard are the script's: at a
// small stack_cap they change the result.
//
// Mapping. A chain is W = 2 or 4 warps, in a block of its own (32 W
// threads, one block per chain of the [P, 8] grid); each thread holds N = 4
// / W of the chain's 128 lanes (probe.cuh LanesN<N>, RecN<N>). Per
// iteration each warp loads its node row's 7 16-byte words and its
// triangle row's 32 (row_word) into its own slice of shared memory, where
// every thread reads them back as it uses them. The chain's state (both
// tasks and both stack pointers) is chain-uniform: every thread computes
// the same values in registers from the chain-uniform sums and keys. Each
// warp's packed sums and the first warp's lane 0 keys go through shared
// memory under the block's barrier, double buffered by iteration parity;
// the sums are int32 and the keys one lane's, so the bits do not depend on
// W. Each warp keeps its own copy of both stacks
// (stack_cap entries each, dynamic shared memory): every warp's lane 0
// pushes the same values at the same clamped positions, so a pop needs no
// barrier across warps. The brute pre-pass and the root test split over
// the chain's warps the same way; the root hit count is summed across them.
//
// Why a chain may stop alone. The script's loop runs a packet while any of
// its chains has work. A finished chain (next task NONE, leaf task IDLE)
// changes nothing in the iterations it would still run there: it reads node
// row 0 and the zero triangle row, which no ray hits (e1 = e2 = 0, so a =
// 0), and nt < 0 forces nh_i = nh_l = 0, so it pushes nothing past its
// stack pointers; its leaf stack is empty (it would have popped), so no
// stall, and nt == NONE forbids a pop. So each chain loops to its own end,
// or to max_iters (the script's n_node_rows + n_leaf_rows + 8), and its
// block exits at once: the SM takes the next chain instead of holding a
// packet's block until its longest chain ends. iters_out[p, s] is the
// chain's own count, the packet loop's count of its live iterations.
//
// What bounds it: the dependence chain of one iteration (task -> row loads
// -> 8 six-output MT records -> 4 slabs -> sums -> push/pop -> task) while
// the card holds few chains, and the issue of the lanes' work (8 records
// and 4 slabs per lane and iteration, -fmad=false) once it holds many. At
// the script's 128 packets the longest chain's 146 iterations set the
// time, and 4 warps a chain (one lane a thread) shorten each iteration.
// At 1,056 packets the card is full, and W = 2 repeats the chain-uniform
// work in fewer warps. An NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// phases 13 and 15): 0.545 ms at 128 packets (W = 4; its issue bound 38%
// of that), 2.637 ms at 1,056 (W = 2; 52%); one packet per block of 8
// one-warp chains took 1.191 / 4.604 ms at 128 / 1,056 packets in turns
// with this design's 0.554 / 2.626. A chain of one warp (4 lanes a
// thread) was the slowest at both sizes, 0.865 ms and 4.509 ms, so it is
// not built.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace probe_v6 {

using namespace probe;

constexpr int IDLE = -1;    // leaf unit idle: it sweeps the zero row
constexpr int NODE_Q = 7;   // 16-byte words of a node row's 28 used floats
constexpr int ROW_Q = 32;   // 16-byte words of a row

// Registers a thread may take: 128 (16 warps an SM).
constexpr int REGS = 128;
// The blocks (chains) per SM __launch_bounds__ makes room for at that budget.
__host__ __device__ constexpr int min_blocks(int w) { return warps_for_regs(REGS) / w; }

template <int W>
__global__ void __launch_bounds__(32 * W, min_blocks(W))
    probe_v6_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tlim, int zero_row, int n_brute_rows, int stack_cap,
                    int max_iters, float* __restrict__ t_out, int* __restrict__ id_out,
                    int* __restrict__ mat_out, float* __restrict__ nx_out,
                    float* __restrict__ ny_out, float* __restrict__ nz_out,
                    int* __restrict__ iters_out) {
  static_assert(W == 2 || W == 4, "chain widths built: 2 and 4");
  constexpr int N = LPT / W;          // lanes per thread
  extern __shared__ int s_stacks[];   // [W][2][stack_cap]: each warp's node and leaf-row stacks
  __shared__ float4 s_nrow[W][NODE_Q];  // each warp's loaded rows
  __shared__ float4 s_trow[W][ROW_Q];
  __shared__ float s_rep[2][4];         // the chain's lane 0 keys, by iteration parity
  __shared__ int s_pab[2][W][2];        // each warp's packed hit sums, by iteration parity
  __shared__ int s_root[W];             // each warp's root hits
  const int ws = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x / P_SUB, s = blockIdx.x % P_SUB;
  const int lane0 = lane + 32 * N * ws;  // the thread's first lane of the chain
  int* stack = s_stacks + 2 * ws * stack_cap;
  int* lstack = stack + stack_cap;
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

  // Brute pre-pass: the rows before the zero row.
  for (int r = zero_row - n_brute_rows; r < zero_row; ++r) {
    s_trow[ws][lane] = row_word(tri + static_cast<size_t>(r) * ROW, lane);
    __syncwarp();
    mt_row8(L, R, s_trow[ws]);
    __syncwarp();  // every lane has read the row before the next is stored
  }

  // Root test: the union of the root's child boxes.
  float box[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    box[c] = jmin(jmin(node[c], node[6 + c]), jmin(node[12 + c], node[18 + c]));
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = node[6 * k + 3] > -BIG ? node[6 * k + 3 + c] : -BIG;
    box[3 + c] = jmax(jmax(v[0], v[1]), jmax(v[2], v[3]));
  }
  int root = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float tm;
    root += slab(L, j, box, tm) ? 1 : 0;
  }
  root = warp_sum(root);
  if (lane == 0) s_root[ws] = root;
  __syncthreads();
  root = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) root += s_root[w];

  // The chain's state, the same in every thread.
  int nt = root > 0 ? 0 : NONE, sp = 0, lt = IDLE, lsp = 0;
  bool alive = nt != NONE;
  int it = 0;
  for (; it < max_iters && alive; ++it) {
    const float* nrow = node + static_cast<size_t>(nt >= 0 ? nt : 0) * ROW;
    const float* trow = tri + static_cast<size_t>(lt >= 0 ? lt : zero_row) * ROW;
    float4 wn;
    if (lane < NODE_Q) wn = row_word(nrow, lane);
    const float4 wt = row_word(trow, lane);
    if (lane < NODE_Q) s_nrow[ws][lane] = wn;
    s_trow[ws][lane] = wt;
    __syncwarp();
    const float4* nq = s_nrow[ws];
    auto nf = [&](int f) { return elem(nq[f >> 2], f & 3); };
    int ch[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ch[k] = f2i(nf(24 + k));

    // ---- leaf unit: the 8 records of the row (t_best first)
    mt_row8(L, R, s_trow[ws]);

    // ---- internal unit: 4 slabs, lane 0's keys, the packed hit counts
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
    float(&xr)[4] = s_rep[it & 1];
    int(&xp)[W][2] = s_pab[it & 1];
    if (lane == 0) {
      xp[ws][0] = pa;
      xp[ws][1] = pb;
      if (ws == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) xr[k] = r0[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) rep[k] = xr[k];
    pa = xp[0][0];
    pb = xp[0][1];
#pragma unroll
    for (int w = 1; w < W; ++w) {
      pa += xp[w][0];
      pb += xp[w][1];
    }
    const bool anyk[4] = {(pa & 0xFFFF) > 0, (pa >> 16) > 0, (pb & 0xFFFF) > 0, (pb >> 16) > 0};

    // ---- decisions: internal and leaf children sorted apart
    float ki[4], kl[4];
    int ci[4], cl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool valid = anyk[k] && (ch[k] != NONE);
      const bool leaf = ch[k] <= -2;
      ki[k] = (valid && !leaf) ? rep[k] : BIG;
      kl[k] = (valid && leaf) ? rep[k] : BIG;
      ci[k] = ch[k];
      cl[k] = ch[k];
    }
    PROBE_CSWAP(ki, ci, 0, 2) PROBE_CSWAP(ki, ci, 1, 3) PROBE_CSWAP(ki, ci, 0, 1)
    PROBE_CSWAP(ki, ci, 2, 3) PROBE_CSWAP(ki, ci, 1, 2)
    PROBE_CSWAP(kl, cl, 0, 2) PROBE_CSWAP(kl, cl, 1, 3) PROBE_CSWAP(kl, cl, 0, 1)
    PROBE_CSWAP(kl, cl, 2, 3) PROBE_CSWAP(kl, cl, 1, 2)
    int n_int = 0, n_leaf = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      n_int += ki[k] < BIG ? 1 : 0;
      n_leaf += kl[k] < BIG ? 1 : 0;
    }

    // ---- scalar phase: both stacks (each warp's own copy)
    const bool stall = lsp >= stack_cap - 8;
    const int nh_i = (nt >= 0 && !stall) ? n_int : 0;
    const int nh_l = (nt >= 0 && !stall) ? n_leaf : 0;
    if (lane == 0) {
      stack[sp + max(nh_i - 4, 0)] = ci[3];
      stack[sp + max(nh_i - 3, 0)] = ci[2];
      stack[sp + max(nh_i - 2, 0)] = ci[1];
      lstack[lsp + max(nh_l - 4, 0)] = neg2(cl[3]);
      lstack[lsp + max(nh_l - 3, 0)] = neg2(cl[2]);
      lstack[lsp + max(nh_l - 2, 0)] = neg2(cl[1]);
    }
    // Lane 0's pushes are seen by the warp's pops. No barrier closes the
    // iteration: the next one stores rows and pushes only after its first
    // __syncwarp, which every lane reaches after this iteration's reads.
    __syncwarp();
    const int new_sp = min(sp + max(nh_i - 1, 0), stack_cap - 4);
    const int desc = nh_i > 0 ? ci[0] : NONE;
    const bool do_pop = !stall && (desc == NONE) && (new_sp > 0) && (nt != NONE);
    const int popped = stack[max(new_sp - 1, 0)];
    const int nxt = stall ? nt : (do_pop ? popped : desc);
    const int new_lsp = min(lsp + max(nh_l - 1, 0), stack_cap - 4);
    int lt_new = nh_l > 0 ? neg2(cl[0]) : IDLE;
    const bool l_pop = (lt_new == IDLE) && (new_lsp > 0);
    const int l_popped = lstack[max(new_lsp - 1, 0)];
    lt_new = l_pop ? l_popped : lt_new;
    nt = nxt;
    sp = do_pop ? new_sp - 1 : new_sp;
    lt = lt_new;
    lsp = l_pop ? new_lsp - 1 : new_lsp;
    alive = (nt != NONE) || (lt != IDLE);
  }

#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t i = out_base() + 32 * j;
    t_out[i] = L.t_best[j];
    id_out[i] = L.best[j];
    mat_out[i] = R.mat[j];
    nx_out[i] = R.nx[j];
    ny_out[i] = R.ny[j];
    nz_out[i] = R.nz[j];
  }
  if (threadIdx.x == 0) iters_out[static_cast<size_t>(p) * P_SUB + s] = it;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          int, int, int, int, float*, int*, int*, float*, float*, float*, int*);

// The kernel of chain width w (the widths built: probes/v6.ADMITTED_W),
// nullptr for a w not built.
KernelFn kernel_of(int w) {
  switch (w) {
    case 2: return probe_v6_kernel<2>;
    case 4: return probe_v6_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace probe_v6

// The dual-unit traversal at chain width w (2 or 4; the caller picks it,
// probes/v6.chosen_w) over the v6 tables node / tri f32[rows, 128] (both
// 16-byte aligned; zero_row the trailing all-zero row of tri, the
// n_brute_rows before it the brute-force rows) for rays o / d f32[packets,
// 3, 8, 128] and limits tlim f32[packets, 8, 128]. Out: t, nx, ny, nz
// f32[packets, 8, 128]; id, mat i32[packets, 8, 128]; iters i32[packets, 8],
// the iterations each chain ran. cudaErrorInvalidValue for a w not built or
// arguments out of range.
extern "C" int rt_probe_v6_w(const float* node, const float* tri, const float* o, const float* d,
                             const float* tlim, int zero_row, int n_brute_rows, int stack_cap,
                             int max_iters, int packets, int w, float* t, int* id, int* mat,
                             float* nx, float* ny, float* nz, int* iters, void* stream) {
  using namespace probe_v6;
  const KernelFn k = kernel_of(w);
  if (k == nullptr || packets < 0 || max_iters < 0 || zero_row < n_brute_rows ||
      n_brute_rows < 0 || stack_cap < 12 || stack_cap > 4096 ||
      (reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(tri)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * 2 * w * static_cast<size_t>(stack_cap);
  if (packets == 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k<<<packets * P_SUB, 32 * w, smem, static_cast<cudaStream_t>(stream)>>>(
      node, tri, o, d, tlim, zero_row, n_brute_rows, stack_cap, max_iters, t, id, mat, nx, ny,
      nz, iters);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of the kernel of chain width
// w; cudaErrorInvalidValue for a w not built.
extern "C" int rt_probe_v6_attrs_w(int w, int* num_regs, int* local_bytes) {
  const probe_v6::KernelFn k = probe_v6::kernel_of(w);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
