// K1: closest-hit traversal of one ray as a __device__ function, with a
// counting instantiation for K3-profile, and traverse2, the walks of two
// rays merged into one loop for K5. Its walk (`walk`) takes the leaf test
// as a template parameter: Möller–Trumbore here (TriangleLeaf), the
// ray-sphere test for the sphere tree (path.cuh sphere_search).
//
// Replaces raytracer_tpu/ops/pallas_traverse.py traverse_tile (:319) with
// hoist_invariants (:254), the body shared by the TPU's path-loop kernel
// and its per-bounce traversal kernel. Plain PyTorch version:
// raytracer_tpu_torch/ops/cuda_traverse.py (_traverse_plain), which takes
// the same steps in the same order, so the two agree bit for bit.
//
// Contract: closest hit with t in [t_min, t_lim); t_lim = -1 marks a dead
// ray. A Möller–Trumbore (MT) sweep over the oversized triangles
// (Bvh4.brute_*) primes t_best, then the wide BVH is walked nearest child
// first from a per-thread stack. Returns t_best (t_lim when nothing is
// hit), the original face id (-1 when nothing is hit), its material id
// (0 then) and the unnormalized cross(e1, e2).
//
// The brute pre-pass is culled (brute_skip): a triangle is tested with MT
// unless its padded box misses [t_min, t_best) AND the ray is far enough
// from parallel to its plane that MT's t is trustworthy. The triangles
// that are tested are tested in index order with the unchanged mt_record,
// so the hit record is the exhaustive pass's bit for bit (a cull against
// t_lim, which is at least the running best, skips no more); the argument and
// the choice of the pad are at ops/cuda_traverse.py (BOX_PAD), whose
// brute_may_hit is this rule's plain mirror. traverse and traverse2 (K5)
// run the same culled pre-pass (brute_prepass). The plain traversal
// (_traverse_plain) keeps the exhaustive pass: chip_smoke.py holds K3
// against it on every lane of the 2K frame, and K5 against the exhaustive
// K5 of the commit before its cull (phase 15). On the reference scene a
// traced ray tests ~3 of its 32 brute triangles instead of all of them:
// the pre-pass was ~95% of K3's counted work.
// Each kernel stages the brute records and the cull table once per block
// (stage_brute) so that the warp's uniform reads cost no global load.
//
// What the TPU kernel needed and this one does not: the 8x128 sub-warp
// chains, the pair-packed SMEM stacks, the float-encoded ids and the
// row-per-node table all work around Mosaic. Here each thread owns one ray
// and reads the Bvh4 arrays as they are.
//
// What bounds it on an H100: dependent loads (node boxes, child codes,
// triangle records) and warp divergence, not FLOPs. Each expansion reads
// K*6 floats + K ints of one node; neighbouring rays of a warp mostly
// visit the same nodes, which L1/L2 serve: the 50 MB L2 holds the bunny
// scene's whole 0.8 MB node table and 4 MB triangle table. The stack lives
// in local memory (L1-cached).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace trav {

constexpr float BIG = 3.0e38f;
constexpr int NONE = -1;
constexpr int STACK_CAP = 256;  // utils/cudalib.STACK_CAP; the wrapper checks stack_depth+4
constexpr int MAX_BRUTE = 64;   // brute triangles a kernel stages (utils/cudalib.MAX_BRUTE)
constexpr int BOX_STRIDE = 12;  // floats per row of the cull table

// The tree widths K the kernels are built for (utils/cudalib.BVH_WIDTHS):
// 8, scene/builder's default, and 4, the native builder's own tree
// (RAYTRACER_TPU_BVH_WIDTH=4). Each entry point dispatches on
// BvhView::width and refuses any other.
__host__ __device__ constexpr bool built_width(int k) { return k == 4 || k == 8; }

struct BvhView {
  const float* bounds;    // [n_nodes, width, 6] child boxes (min xyz, max xyz)
  const int* children;    // [n_nodes, width]; >=0 node, -1 empty, <=-2 leaf -(2+lo*8+cnt-1)
  const float* tri;       // [T, 9] v0, e1, e2 in leaf order
  const int* prim;        // [T] original face ids
  const int* fmat;        // [T] material ids
  const float* btri;      // [Tb, 9] brute-force set (may be null when n_brute == 0)
  const int* bprim;       // [Tb]
  const int* bmat;        // [Tb]
  const float* bbox;      // [Tb + 1, 12] cull table (ops/cuda_traverse.brute_boxes)
  int n_brute;            // <= MAX_BRUTE
  int width;              // 4 or 8: the K of the instantiation each entry point launches
};

// A view the culling kernels (K3, K3-profile, K4) take: a built width, and
// a brute set within the stage's capacity with its cull table.
inline bool view_ok(const BvhView& v) {
  return built_width(v.width) && v.n_brute >= 0 && v.n_brute <= MAX_BRUTE &&
         (v.n_brute == 0 || v.bbox != nullptr);
}

struct Hit {
  float t;
  int prim;
  int mat;
  float nx, ny, nz;
};

// Möller–Trumbore of one triangle record, the terms of
// pallas_traverse.mt_record in the same order. Updates h on a strictly
// closer hit.
__device__ __forceinline__ void mt_record(const float* __restrict__ rec, int prim, int mat,
                                          float ox, float oy, float oz, float dx, float dy,
                                          float dz, float t_min, Hit& h) {
  const float v0x = rec[0], v0y = rec[1], v0z = rec[2];
  const float e1x = rec[3], e1y = rec[4], e1z = rec[5];
  const float e2x = rec[6], e2y = rec[7], e2z = rec[8];
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  bool ok = fabsf(a) >= 1e-8f;
  const float f = 1.0f / (ok ? a : 1.0f);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  ok = ok && (u >= 0.0f) && (u <= 1.0f);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (dx * qx + dy * qy + dz * qz);
  ok = ok && (v >= 0.0f) && (u + v <= 1.0f);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  ok = ok && (t >= t_min) && (t < h.t);
  if (ok) {
    h.t = t;
    h.prim = prim;
    h.mat = mat;
    h.nx = e1y * e2z - e1z * e2y;
    h.ny = e1z * e2x - e1x * e2z;
    h.nz = e1x * e2y - e1y * e2x;
  }
}

// Slab test of one child box. 1/d may be +-inf, and (b - o) * inf is NaN
// when the ray starts on a slab plane it runs parallel to. The reference
// takes min/max with jnp.minimum/maximum, which propagate NaN, so the final
// `tmax > tmin` is false: a miss. fminf/fmaxf would drop the NaN and could
// turn that miss into a hit, so any NaN among the six plane distances is a
// miss here, explicitly; otherwise fminf/fmaxf give the same values.
__device__ __forceinline__ bool slab(const float* __restrict__ b, float ox, float oy, float oz,
                                     float ix, float iy, float iz, float t_min, float t_best,
                                     float& entry) {
  const float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
  const float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
  const float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) || isnan(t1z))
    return false;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), t_min));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), t_best));
  entry = tmin;
  return tmax > tmin;
}

// The slab test of a child box grown by g on every side (a sphere tree's
// walk: path.cuh sphere_search), slab's rules otherwise.
__device__ __forceinline__ bool slab_grown(const float* __restrict__ b, float g, float ox,
                                           float oy, float oz, float ix, float iy, float iz,
                                           float t_min, float t_best, float& entry) {
  const float grown[6] = {b[0] - g, b[1] - g, b[2] - g, b[3] + g, b[4] + g, b[5] + g};
  return slab(grown, ox, oy, oz, ix, iy, iz, t_min, t_best, entry);
}

// min / max that return NaN when either operand is NaN (PTX min.NaN and
// max.NaN, sm_80+), as torch.minimum / maximum do in the plain mirror.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The cull of brute triangle j, row b of the cull table (lo xyz, -, hi xyz,
// -, guard normal xyz, -): true only where MT cannot accept the triangle
// within [t_min, t_best). The slab's NaN rule is the opposite of the node
// slab's: a NaN plane distance passes (a false pass costs one MT, a false
// skip would change the image), and the box passes at tf == tn. `sd` is
// (|o - c|inf + R) |d|inf of the ray (the table's last row holds c, R).
// ops/cuda_traverse.brute_may_hit is its plain mirror, operation for
// operation.
__device__ __forceinline__ bool brute_skip(const float* __restrict__ b, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float ix,
                                           float iy, float iz, float sd, float t_min,
                                           float t_best) {
  const float t0x = (b[0] - ox) * ix, t1x = (b[4] - ox) * ix;
  const float t0y = (b[1] - oy) * iy, t1y = (b[5] - oy) * iy;
  const float t0z = (b[2] - oz) * iz, t1z = (b[6] - oz) * iz;
  const float tn =
      nan_max(nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)), nan_min(t0z, t1z)), t_min);
  const float tf =
      nan_min(nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z)), t_best);
  const float g = dx * b[8] + dy * b[9] + dz * b[10];
  return (tf < tn) && (fabsf(g) >= sd);
}

// The culled brute pre-pass of one ray against t_lim, into h. Culls every
// triangle first, then tests this lane's own survivors in index order: a
// warp runs as many MT records as its busiest lane needs, not one for
// every triangle any lane needs (a cull just before each test ran slower:
// PERF.md §6).
__device__ __forceinline__ void brute_prepass(const BvhView& bvh, float ox, float oy, float oz,
                                              float dx, float dy, float dz, float ix, float iy,
                                              float iz, float t_lim, float t_min, Hit& h) {
  if (bvh.n_brute <= 0) return;
  const float* fr = bvh.bbox + BOX_STRIDE * bvh.n_brute;  // c, R
  const float s =
      nan_max(nan_max(fabsf(ox - fr[0]), fabsf(oy - fr[1])), fabsf(oz - fr[2])) + fr[3];
  const float sd = s * nan_max(nan_max(fabsf(dx), fabsf(dy)), fabsf(dz));
  unsigned long long pass = 0;
  for (int j = 0; j < bvh.n_brute; ++j)
    if (!brute_skip(bvh.bbox + BOX_STRIDE * j, ox, oy, oz, dx, dy, dz, ix, iy, iz, sd, t_min,
                    t_lim))
      pass |= 1ull << j;
  while (pass) {
    const int j = __ffsll(static_cast<long long>(pass)) - 1;
    pass &= pass - 1;
    mt_record(bvh.btri + 9 * j, bvh.bprim[j], bvh.bmat[j], ox, oy, oz, dx, dy, dz, t_min, h);
  }
}

// The brute set and its cull table, copied into shared memory once per
// block: every lane of a warp reads the same record at the same time, and
// a shared-memory broadcast costs no global load (the constant bank and
// global memory as given were slower: PERF.md §6).
struct BruteStage {
  float tri[MAX_BRUTE * 9];
  float box[(MAX_BRUTE + 1) * BOX_STRIDE];
  int prim[MAX_BRUTE];
  int mat[MAX_BRUTE];
};

// The view the block's threads traverse with: its brute pointers moved to
// the staged copy. Every thread of the block calls it, then the block
// synchronizes before any thread traverses.
__device__ __forceinline__ BvhView stage_brute(const BvhView& bvh, BruteStage& st) {
  BvhView v = bvh;
  const int n = bvh.n_brute;
  const int n_box = n > 0 ? BOX_STRIDE * (n + 1) : 0;  // no table without a brute set
  for (int i = threadIdx.x; i < 9 * n; i += blockDim.x) st.tri[i] = bvh.btri[i];
  for (int i = threadIdx.x; i < n_box; i += blockDim.x) st.box[i] = bvh.bbox[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    st.prim[i] = bvh.bprim[i];
    st.mat[i] = bvh.bmat[i];
  }
  v.btri = st.tri;
  v.bbox = st.box;
  v.bprim = st.prim;
  v.bmat = st.mat;
  return v;
}

#define TRAV_CSWAP(i, j)                           \
  {                                                \
    const bool sw = key[i] > key[j];               \
    const float ki = sw ? key[j] : key[i];         \
    const float kj = sw ? key[i] : key[j];         \
    const int ci = sw ? code[j] : code[i];         \
    const int cj = sw ? code[i] : code[j];         \
    key[i] = ki;                                   \
    key[j] = kj;                                   \
    code[i] = ci;                                  \
    code[j] = cj;                                  \
  }

// ops/bvh4.SORT_PAIRS[K]: keys ascending; a swap only on a strictly greater
// key. Another network would order equal keys differently, and the kernel
// would then part from the plain version at ties.
template <int K>
__device__ __forceinline__ void sort_children(float (&key)[K], int (&code)[K]) {
  static_assert(built_width(K), "the kernels are built for widths 4 and 8");
  if constexpr (K == 8) {
    TRAV_CSWAP(0, 1) TRAV_CSWAP(2, 3) TRAV_CSWAP(4, 5) TRAV_CSWAP(6, 7)
    TRAV_CSWAP(0, 2) TRAV_CSWAP(1, 3) TRAV_CSWAP(4, 6) TRAV_CSWAP(5, 7)
    TRAV_CSWAP(1, 2) TRAV_CSWAP(5, 6)
    TRAV_CSWAP(0, 4) TRAV_CSWAP(1, 5) TRAV_CSWAP(2, 6) TRAV_CSWAP(3, 7)
    TRAV_CSWAP(2, 4) TRAV_CSWAP(3, 5)
    TRAV_CSWAP(1, 2) TRAV_CSWAP(3, 4) TRAV_CSWAP(5, 6)
  } else {
    TRAV_CSWAP(0, 2) TRAV_CSWAP(1, 3) TRAV_CSWAP(0, 1) TRAV_CSWAP(2, 3) TRAV_CSWAP(1, 2)
  }
}
#undef TRAV_CSWAP

// One step of a ray's walk from its own stack, as walk's loop body
// takes it: expand the node in `task` (nearest hit child next, the other
// hit children pushed far to near) or test the leaf it names, then take
// the next task. False once the walk has ended. traverse2 runs it;
// walk keeps the body written out: calling step there took K3 from 64
// to 68 registers (ptxas, sm_90a) and its 2K spp8 mb20 kernel from 46.27
// to 47.39 ms, median of 10 in alternating turns with non-overlapping
// ranges (NVIDIA H100 80GB HBM3, 700 W). K4 went from 54 to 50 registers
// and 8.45 to 7.96 ms per 20 calls, within its run-to-run spread.
template <int K>
__device__ __forceinline__ bool step(const BvhView& bvh, float ox, float oy, float oz, float dx,
                                     float dy, float dz, float ix, float iy, float iz,
                                     float t_min, Hit& h, int (&stack)[STACK_CAP], int& sp,
                                     int& task) {
  int next = NONE;
  if (task >= 0) {
    const float* nb = bvh.bounds + static_cast<size_t>(task) * (K * 6);
    const int* nc = bvh.children + static_cast<size_t>(task) * K;
    float key[K];
    int code[K];
    int nhit = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = nc[k];
      float entry = 0.0f;
      const bool valid = slab(nb + 6 * k, ox, oy, oz, ix, iy, iz, t_min, h.t, entry) &&
                         c != NONE;
      key[k] = valid ? entry : BIG;
      code[k] = c;
      nhit += valid ? 1 : 0;
    }
    sort_children<K>(key, code);
    if (nhit > 0) next = code[0];
    // Push the other hit children far to near, so the nearest pops first.
#pragma unroll
    for (int k = K - 1; k >= 1; --k)
      if (k < nhit && sp < STACK_CAP) stack[sp++] = code[k];
  } else {
    const int c = -task - 2;
    const int lo = c >> 3;
    const int cnt = (c & 7) + 1;
    for (int k = 0; k < cnt; ++k)
      mt_record(bvh.tri + 9 * static_cast<size_t>(lo + k), bvh.prim[lo + k], bvh.fmat[lo + k],
                ox, oy, oz, dx, dy, dz, t_min, h);
  }
  if (next == NONE) {
    if (sp == 0) return false;
    next = stack[--sp];
  }
  task = next;
  return true;
}

// The leaf test of K1's walk over the triangle tree: Möller–Trumbore of
// each record of the leaf's range, in order, into h.
struct TriangleLeaf {
  static constexpr bool GROWN = false;  // the walk's boxes as the tree holds them
  const BvhView& bvh;
  float ox, oy, oz, dx, dy, dz, t_min;
  __device__ __forceinline__ void operator()(int lo, int cnt, Hit& h) const {
    for (int k = 0; k < cnt; ++k)
      mt_record(bvh.tri + 9 * static_cast<size_t>(lo + k), bvh.prim[lo + k], bvh.fmat[lo + k],
                ox, oy, oz, dx, dy, dz, t_min, h);
  }
};

// K1's walk of one ray over a K-wide tree (bounds [n, K, 6], children
// [n, K] coded as in BvhView) from a per-thread stack of CAP entries,
// nearest child first: expand the node (the hit children sorted by entry
// distance, the nearest next, the others pushed far to near) or run
// `leaf(lo, cnt, h)` on the leaf range, then take the next task. The leaf
// test updates the running best h, whose t bounds the slab tests, and
// says whether the boxes are grown by its `g` (Leaf::GROWN): TriangleLeaf
// for the triangle tree (traverse), path.cuh's SphereLeaf for the sphere
// tree. COUNT adds to *iters the steps the walk takes, one node expansion
// or one leaf each. h is a parameter of its own, not a member of the leaf
// test: so K3, K3-profile and K4 compile to the SASS they had before the
// walk was shared, instruction for instruction (sm_90a, nvcc 12.8).
template <int K, int CAP, bool COUNT, class Best, class Leaf>
__device__ __forceinline__ void walk(const float* bounds, const int* children, float ox,
                                     float oy, float oz, float ix, float iy, float iz,
                                     float t_min, Best& h, const Leaf& leaf, int* iters) {
  int stack[CAP];
  int sp = 0;
  int task = 0;  // the root
  while (true) {
    if constexpr (COUNT) ++*iters;
    int next = NONE;
    if (task >= 0) {
      const float* nb = bounds + static_cast<size_t>(task) * (K * 6);
      const int* nc = children + static_cast<size_t>(task) * K;
      float key[K];
      int code[K];
      int nhit = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = nc[k];
        float entry = 0.0f;
        bool valid;
        if constexpr (Leaf::GROWN) {
          valid = slab_grown(nb + 6 * k, leaf.g, ox, oy, oz, ix, iy, iz, t_min, h.t, entry);
        } else {
          valid = slab(nb + 6 * k, ox, oy, oz, ix, iy, iz, t_min, h.t, entry);
        }
        valid = valid && c != NONE;
        key[k] = valid ? entry : BIG;
        code[k] = c;
        nhit += valid ? 1 : 0;
      }
      sort_children<K>(key, code);
      if (nhit > 0) next = code[0];
      // Push the other hit children far to near, so the nearest pops first.
#pragma unroll
      for (int k = K - 1; k >= 1; --k)
        if (k < nhit && sp < CAP) stack[sp++] = code[k];
    } else {
      const int c = -task - 2;
      const int lo = c >> 3;
      const int cnt = (c & 7) + 1;
      leaf(lo, cnt, h);
    }
    if (next == NONE) {
      if (sp == 0) break;
      next = stack[--sp];
    }
    task = next;
  }
}

// COUNT (K3-profile) adds to *iters the number of steps the walk takes:
// one node expansion or one leaf each, 0 for a dead ray and for the brute
// pre-pass. It is the per-thread counterpart of traverse_tile(profile=True)'s
// per-chain count (pallas_traverse.py:333-345). The production
// instantiation (COUNT = false) has no counter and compiles as it did
// before the counter existed.
template <int K, bool COUNT = false>
__device__ inline Hit traverse(const BvhView& bvh, float ox, float oy, float oz, float dx,
                               float dy, float dz, float t_lim, float t_min,
                               int* iters = nullptr) {
  Hit h{t_lim, NONE, 0, 0.0f, 0.0f, 0.0f};
  // Nothing lies in [t_min, t_lim) for a dead ray: skip all work (exact).
  if (!(t_lim > t_min)) return h;

  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  brute_prepass(bvh, ox, oy, oz, dx, dy, dz, ix, iy, iz, t_lim, t_min, h);
  const TriangleLeaf leaf{bvh, ox, oy, oz, dx, dy, dz, t_min};
  walk<K, STACK_CAP, COUNT>(bvh.bounds, bvh.children, ox, oy, oz, ix, iy, iz, t_min, h, leaf,
                            iters);
  return h;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float t_lim;  // as traverse's: t_lim <= t_min marks a dead ray
};

// K5's traversal (raytracer_tpu/ops/pallas_interleave.py traverse_tiles
// :22): the walks of two rays merged into one loop, each ray with its own
// stack and its own t_best, so that one thread keeps two independent
// chains of dependent loads in flight. A ray whose walk has ended idles
// while the other goes on. Each ray takes exactly the steps traverse
// takes for it, in the same order, its culled brute pre-pass included
// (the caller stages the brute set: stage_brute), so h0 and h1 equal
// traverse's bit for bit.
template <int K>
__device__ inline void traverse2(const BvhView& bvh, const Ray& r0, const Ray& r1, float t_min,
                                 Hit& h0, Hit& h1) {
  h0 = Hit{r0.t_lim, NONE, 0, 0.0f, 0.0f, 0.0f};
  h1 = Hit{r1.t_lim, NONE, 0, 0.0f, 0.0f, 0.0f};
  bool go0 = r0.t_lim > t_min;
  bool go1 = r1.t_lim > t_min;
  if (!(go0 || go1)) return;

  const float ix0 = 1.0f / r0.dx, iy0 = 1.0f / r0.dy, iz0 = 1.0f / r0.dz;
  const float ix1 = 1.0f / r1.dx, iy1 = 1.0f / r1.dy, iz1 = 1.0f / r1.dz;
  if (go0)
    brute_prepass(bvh, r0.ox, r0.oy, r0.oz, r0.dx, r0.dy, r0.dz, ix0, iy0, iz0, r0.t_lim, t_min,
                  h0);
  if (go1)
    brute_prepass(bvh, r1.ox, r1.oy, r1.oz, r1.dx, r1.dy, r1.dz, ix1, iy1, iz1, r1.t_lim, t_min,
                  h1);
  int stack0[STACK_CAP], stack1[STACK_CAP];
  int sp0 = 0, sp1 = 0;
  int task0 = 0, task1 = 0;  // the root
  while (go0 || go1) {
    if (go0)
      go0 = step<K>(bvh, r0.ox, r0.oy, r0.oz, r0.dx, r0.dy, r0.dz, ix0, iy0, iz0, t_min, h0, stack0,
                 sp0, task0);
    if (go1)
      go1 = step<K>(bvh, r1.ox, r1.oy, r1.oz, r1.dx, r1.dy, r1.dz, ix1, iy1, iz1, t_min, h1, stack1,
                 sp1, task1);
  }
}

}  // namespace trav
