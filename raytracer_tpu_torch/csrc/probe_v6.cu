// P-v6: dual-unit traversal of a 4-wide tree in the row-per-node v6 tables.
//
// Replaces scripts/kernel_v6_probe.py _make_kernel_v6 (:94; TPU call :358)
// and its body _kernel_body_v6 (:124). Wrapper, plain PyTorch version and
// entry point: raytracer_tpu_torch/probes/v6.py (`v6`, `v6_plain`, `main`),
// which take the same operations in the same order, so the two agree bit
// for bit; tables: probes/v6_tables.py.
//
// A packet's 8 chains are a block's 8 warps (probe.cuh: thread l of a warp
// owns lanes l, l+32, l+64, l+96). After the brute-force pre-pass, a chain
// starts at node 0 if any of its lanes hits the union of the root's child
// boxes (the max side guarded by max > -BIG), at NONE otherwise. In each
// iteration both units of the chain run:
//   - the leaf unit sweeps the 8 records of triangle row `ltask` (the zero
//     row when idle) and updates t_best, best, mat and the normal;
//   - the internal unit slabs the 4 children of node row `ntask` (row 0
//     when the chain has no node) against the updated t_best.
// Lane 0's entry distances are the sort keys (HALF_BIG for a child only
// other lanes hit); a child counts as hit if any lane hits it (the packed
// warp sums pa, pb). Internal and leaf children are sorted apart by the
// 5-comparator network. Lane 0 then pushes the other hit children, far to
// near with the script's clamped stores, onto the chain's node stack and
// leaf-row stack in shared memory; a chain whose leaf stack is within 8 of
// full repeats its node (the stall guard). The task, both stack pointers
// and both stacks live in shared memory, written by lane 0 and read by all
// lanes with __syncwarp between. A chain ends when it has neither a node
// nor a leaf row, or after max_iters iterations (the script's
// n_node_rows + n_leaf_rows + 8): a finished chain's iterations in the
// script's packet-wide loop change nothing, so each warp stops on its own.
//
// What bounds it: the dependence chain of one iteration (task -> row loads
// -> 8 MT records -> 4 slabs -> shuffles -> push/pop -> task), as in the v5
// body (probe_v5.cuh), with one more stack and the leaf unit's sweep in
// every iteration.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_v6 {

using namespace probe;

constexpr int IDLE = -1;             // leaf unit idle: it sweeps the zero row

__global__ void __launch_bounds__(P_SUB * 32)
    probe_v6_kernel(const float* __restrict__ node, const float* __restrict__ tri,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tlim, int zero_row, int n_brute_rows, int stack_cap,
                    int max_iters, float* __restrict__ t_out, int* __restrict__ id_out,
                    int* __restrict__ mat_out, float* __restrict__ nx_out,
                    float* __restrict__ ny_out, float* __restrict__ nz_out,
                    int* __restrict__ iters_out) {
  extern __shared__ int s_stacks[];  // [P_SUB][2][stack_cap]: node stack, leaf-row stack
  __shared__ int s_ntask[P_SUB], s_sp[P_SUB], s_ltask[P_SUB], s_lsp[P_SUB];
  const int p = blockIdx.x, s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* stack = s_stacks + 2 * s * stack_cap;
  int* lstack = stack + stack_cap;
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

  // Brute pre-pass: the rows before the zero row.
  for (int r = zero_row - n_brute_rows; r < zero_row; ++r)
    mt_row8(L, R, tri + static_cast<size_t>(r) * ROW);

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
  for (int j = 0; j < LPT; ++j) {
    float tm;
    root += slab(L, j, box, tm) ? 1 : 0;
  }
  bool alive = warp_sum(root) > 0;
  if (lane == 0) {
    s_ntask[s] = alive ? 0 : NONE;
    s_sp[s] = 0;
    s_ltask[s] = IDLE;
    s_lsp[s] = 0;
  }
  __syncwarp();

  int it = 0;
  for (; it < max_iters && alive; ++it) {
    const int nt = s_ntask[s], lt = s_ltask[s];
    const float* nrow = node + static_cast<size_t>(nt >= 0 ? nt : 0) * ROW;
    const float* trow = tri + static_cast<size_t>(lt >= 0 ? lt : zero_row) * ROW;
    int ch[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ch[k] = f2i(nrow[24 + k]);

    // ---- leaf unit: the 8 records of the row (t_best first)
    mt_row8(L, R, trow);

    // ---- internal unit: 4 slabs, lane 0's keys, the packed hit counts
    float rep[4];
    int hits[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float b[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) b[c] = nrow[k * 6 + c];
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

    // ---- scalar phase: both stacks
    const int sp = s_sp[s], lsp = s_lsp[s];
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
    alive = (nxt != NONE) || (lt_new != IDLE);
    __syncwarp();  // every lane has read this iteration's state and stacks
    if (lane == 0) {
      s_ntask[s] = nxt;
      s_sp[s] = do_pop ? new_sp - 1 : new_sp;
      s_ltask[s] = lt_new;
      s_lsp[s] = l_pop ? new_lsp - 1 : new_lsp;
    }
    __syncwarp();  // the next iteration reads what lane 0 wrote
  }

#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const size_t i = out_base + 32 * j;
    t_out[i] = L.t_best[j];
    id_out[i] = L.best[j];
    mat_out[i] = R.mat[j];
    nx_out[i] = R.nx[j];
    ny_out[i] = R.ny[j];
    nz_out[i] = R.nz[j];
  }
  if (lane == 0) iters_out[static_cast<size_t>(p) * P_SUB + s] = it;
}

}  // namespace probe_v6

// out: t, nx, ny, nz f32[P, 8, 128]; id, mat i32[P, 8, 128]; iters i32[P, 8],
// the iterations each chain ran.
extern "C" int rt_probe_v6(const float* node, const float* tri, const float* o, const float* d,
                           const float* tlim, int zero_row, int n_brute_rows, int stack_cap,
                           int max_iters, int packets, float* t, int* id, int* mat, float* nx,
                           float* ny, float* nz, int* iters, void* stream) {
  using namespace probe_v6;
  if (packets < 0 || max_iters < 0 || zero_row < n_brute_rows || n_brute_rows < 0 ||
      stack_cap < 12 || stack_cap > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * 2 * P_SUB * static_cast<size_t>(stack_cap);
  if (packets > 0)
    probe_v6_kernel<<<packets, P_SUB * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        node, tri, o, d, tlim, zero_row, n_brute_rows, stack_cap, max_iters, t, id, mat, nx, ny,
        nz, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_v6_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, probe_v6::probe_v6_kernel);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
