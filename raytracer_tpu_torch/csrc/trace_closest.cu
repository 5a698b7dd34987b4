// K4: batched closest hit, one ray per thread calling K1 (traverse.cuh),
// and the key kernel of its coherence-sort route (K4-sort).
//
// Replaces raytracer_tpu/ops/pallas_traverse.py _traverse_packets (:907),
// whose kernel is _make_kernel (:282) -> _kernel_body (:849), at the
// contract of trace_closest_pallas (:961). The wrapper is
// raytracer_tpu_torch/ops/cuda_traverse.py trace_closest. With sort=True
// (K4-sort, :961-1050) the card runs three launches: the key kernel here
// (one thread per ray: ops/packets.coherence_keys32), torch's stable
// argsort of the keys (the JAX package sorts with XLA outside its Pallas
// call too, :985-986), and K4 through the permutation: thread i traces ray
// perm[i] and writes its record at perm[i], so there is no gather, no
// scatter and no inverse argsort (JAX's :1029). A ray's record does not
// depend on which thread traces it: sorted and unsorted calls agree bit for
// bit, and the sort only changes how coherent a warp's rays are.
//
// K4 finishes the record itself (t = BIG, tri_id = mat_id = 0 on a miss;
// the normal; hit as one byte of a torch.bool tensor), reads a scalar limit
// by value or a per-ray one through a pointer, and skips any output whose
// pointer is null. The differentiable path (ops/intersect.intersect_scene)
// launches it once per bounce; the fused path loop calls K1 inline instead.
// Bound like K1: dependent BVH loads and divergence; the ray I/O is 7 floats
// in and up to 6 words and a byte out per ray. Through the permutation that
// I/O is scattered: at the training path's 1,048,576 rays K4 through the
// sort's permutation takes about twice K4 in call order, the stores most
// of it (PERF.md §6), so a caller asks only for the fields it reads. One
// instantiation per built tree width (traverse.cuh), chosen by
// BvhView::width. A block stages the brute set and its cull table
// (traverse.cuh stage_brute) before its threads trace.
#include <cuda_runtime.h>

#include <cstdint>

#include "traverse.cuh"

namespace {

// Where a launch writes the record; a null pointer is not written.
struct Record {
  float* t;
  int* id;
  int* mat;
  float* nrm;
  unsigned char* hit;
};

// Ray r of the call: K1, then the finished record at r.
template <int K>
__device__ __forceinline__ void trace_ray(const trav::BvhView& view, const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ tlim, float t_max,
                                          float t_min, int64_t r, const Record& rec) {
  const float lim = tlim != nullptr ? tlim[r] : t_max;
  const trav::Hit h = trav::traverse<K>(view, o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r],
                                        d[3 * r + 1], d[3 * r + 2], lim, t_min);
  const bool found = h.prim >= 0;
  if (rec.t != nullptr) rec.t[r] = found ? h.t : trav::BIG;
  if (rec.id != nullptr) rec.id[r] = found ? h.prim : 0;
  if (rec.mat != nullptr) rec.mat[r] = found ? h.mat : 0;
  if (rec.nrm != nullptr) {
    rec.nrm[3 * r] = h.nx;
    rec.nrm[3 * r + 1] = h.ny;
    rec.nrm[3 * r + 2] = h.nz;
  }
  if (rec.hit != nullptr) rec.hit[r] = found ? 1 : 0;
}

// One thread per entry of the call: entry i is ray perm[i] (i when perm is
// null). Persistent blocks that take entries from a list (K3's lanes) lost
// to this grid on the training path's sorted calls (PERF.md §6).
template <int K>
__global__ void trace_closest_kernel(trav::BvhView bvh, const float* __restrict__ o,
                                     const float* __restrict__ d, const float* __restrict__ tlim,
                                     float t_max, float t_min, int n,
                                     const int64_t* __restrict__ perm, Record rec) {
  __shared__ trav::BruteStage stage;
  const trav::BvhView view = trav::stage_brute(bvh, stage);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_ray<K>(view, o, d, tlim, t_max, t_min, perm != nullptr ? perm[i] : i, rec);
}

// 10 bits spread to every third position (the standard Morton magic; the
// products wrap at 32 bits, and every bit the masks keep lies below 32).
__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// torch.clamp's float32 rule: NaN stays NaN.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// Grid cell 0..1023 of one origin coordinate: the float operations of
// ops/packets.morton3d and coherence_keys, truncated toward zero (NaN to 0,
// as a float-to-int conversion on the card does).
__device__ __forceinline__ uint32_t cell(float o, float lo, float inv_ext) {
  const float u = clamp((o - lo) * inv_ext, 0.0f, 1.0f);
  return static_cast<uint32_t>(static_cast<int>(clamp(u * 1024.0f, 0.0f, 1023.0f)));
}

// The sort key of ray i, ops/packets.coherence_keys32: (octant << 29 |
// Morton(origin) >> 1) with its top bit flipped, as int32, so that a signed
// sort orders it as the unsigned key. `box` is the tree's sort box (lo xyz,
// 1/extent xyz). The octant tests d < 0, so -0.0 counts as positive.
__global__ void coherence_key_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                     const float* __restrict__ box, int n,
                                     int32_t* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t octant = (d[3 * i] < 0.0f ? 1u : 0u) | (d[3 * i + 1] < 0.0f ? 2u : 0u) |
                          (d[3 * i + 2] < 0.0f ? 4u : 0u);
  const uint32_t m = (expand_bits(cell(o[3 * i], box[0], box[3])) << 2) |
                     (expand_bits(cell(o[3 * i + 1], box[1], box[4])) << 1) |
                     expand_bits(cell(o[3 * i + 2], box[2], box[5]));
  keys[i] = static_cast<int32_t>(((octant << 29) | (m >> 1)) ^ 0x80000000u);
}

}  // namespace

// K4 on n rays, one thread per entry: tlim (per ray) or, when it is null,
// the scalar t_max; perm (int64, n entries) or, when it is null, the
// identity; any output may be null.
extern "C" int rt_trace_closest(const trav::BvhView* bvh, const float* o, const float* d,
                                const float* tlim, float t_max, float t_min, int n,
                                const int64_t* perm, float* t_out, int* id_out, int* mat_out,
                                float* n_out, unsigned char* hit_out, int block, void* stream) {
  if (!trav::view_ok(*bvh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const Record rec{t_out, id_out, mat_out, n_out, hit_out};
    const int grid = (n + block - 1) / block;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bvh->width == 4)
      trace_closest_kernel<4><<<grid, block, 0, s>>>(*bvh, o, d, tlim, t_max, t_min, n, perm, rec);
    else
      trace_closest_kernel<8><<<grid, block, 0, s>>>(*bvh, o, d, tlim, t_max, t_min, n, perm, rec);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int32 sort keys of n rays (coherence_key_kernel) in the frame `box`
// (the tree's sort box, 6 floats on the card).
extern "C" int rt_coherence_keys(const float* o, const float* d, const float* box, int n,
                                 int32_t* keys, void* stream) {
  if (n > 0) {
    const int block = 256;
    coherence_key_kernel<<<(n + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, box, n, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (bytes per thread) of K4 at tree width 4 or 8.
extern "C" int rt_trace_closest_attrs(int width, int* num_regs, int* local_bytes) {
  if (!trav::built_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(
      &a, width == 4 ? trace_closest_kernel<4> : trace_closest_kernel<8>);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
