// The pieces of one path iteration of the fused path loop, shared by K3
// (megakernel.cu, one lane per thread) and K5 (interleave.cu, two lanes
// per thread), so that both take the same operations in the same order
// and agree bit for bit per lane.
//
// Semantics kept from pallas_megakernel.py pre_trav/post_trav (:191-467),
// with the same formulas, select order and comparison strictness:
// thin-lens camera ray with jitter and lens draws at bounce 0; Russian
// roulette from min_bounces with survival min(max throughput,
// rr_max_prob); sphere sweep against the running best (root_near <=
// t_sph), or with the sphere tree the same answer through it
// (sphere_search); K1 (traverse.cuh) with t_lim = t_sph; tri_wins = t_tri < t_sph;
// the four materials' scatter; emission with the quirk flag; sky on miss;
// black at max bounce.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "ktf.cuh"
#include "traverse.cuh"

struct FusedParams {
  float ll[3], hor[3], ver[3], pos[3], right[3], up[3];
  float lens_r, inv_w, inv_h, rr_max_prob, t_min;
  uint32_t k0, k1;
  int sample_offset, spp, max_bounces, min_bounces, emission_quirk, n_spheres, n_materials;
};

namespace path {

constexpr float SKY_TOP_X = 0.5f, SKY_TOP_Y = 0.7f, SKY_TOP_Z = 1.0f;
constexpr float EPS_NEAR_ZERO = 1e-8f;
constexpr float EPS_SQ_1E20 = 1e-20f * 1e-20f;  // float32 product, as the reference

// A lane's ray and throughput between path iterations.
struct Ray {
  float ox, oy, oz, dx, dy, dz, tx, ty, tz;
};

// The scene tables of the kernels: spheres (center, radius) + material
// ids, materials (albedo, emission, roughness, ior) + type tags.
struct Tables {
  const float* __restrict__ sph;
  const int* __restrict__ sph_mat;
  const float* __restrict__ mat;
  const int* __restrict__ mat_type;
};

// Camera ray of sample s_eff (Core/Camera.cuh:32-44), draws keyed at
// bounce 0; the throughput starts at one.
__device__ __forceinline__ void camera_ray(const FusedParams& p, uint32_t pixel, uint32_t s_eff,
                                           float pxf, float pyf, Ray& r) {
  const ktf::Sampler smp0{p.k0, p.k1, pixel, s_eff, 0u};
  float ldx, ldy, ju, jv;
  smp0.disk(ktf::LENS, ldx, ldy);
  const float rdx = p.lens_r * ldx;
  const float rdy = p.lens_r * ldy;
  const float offx = p.right[0] * rdx + p.up[0] * rdy;
  const float offy = p.right[1] * rdx + p.up[1] * rdy;
  const float offz = p.right[2] * rdx + p.up[2] * rdy;
  smp0.uniform_pair(ktf::JITTER, ju, jv);
  const float u = (pxf + ju) * p.inv_w;
  const float v = (pyf + jv) * p.inv_h;
  r.ox = p.pos[0] + offx;
  r.oy = p.pos[1] + offy;
  r.oz = p.pos[2] + offz;
  r.dx = p.ll[0] + u * p.hor[0] + v * p.ver[0] - p.pos[0] - offx;
  r.dy = p.ll[1] + u * p.hor[1] + v * p.ver[1] - p.pos[1] - offy;
  r.dz = p.ll[2] + u * p.hor[2] + v * p.ver[2] - p.pos[2] - offz;
  r.tx = 1.0f;
  r.ty = 1.0f;
  r.tz = 1.0f;
}

// Russian roulette (CUDAKernels.h:113-121): false when the path is
// killed (its sample then adds zero); a survivor's throughput is scaled.
__device__ __forceinline__ bool roulette(const FusedParams& p, const ktf::Sampler& smp, int bounce,
                                         Ray& r) {
  const bool do_rr = bounce >= p.min_bounces;
  const float survival = fminf(fmaxf(fmaxf(r.tx, r.ty), r.tz), p.rr_max_prob);
  const float u_rr = smp.uniform(ktf::RR);
  if (do_rr && (u_rr > survival)) return false;
  if (do_rr) {
    const float rr_scale = 1.0f / fmaxf(survival, 1e-12f);
    r.tx = r.tx * rr_scale;
    r.ty = r.ty * rr_scale;
    r.tz = r.tz * rr_scale;
  }
  return true;
}

// The closest sphere in [t_min, BIG] and what shading needs of it.
struct SphereHit {
  float t, cx, cy, cz, r;
  int mat;
};

__device__ __forceinline__ SphereHit sphere_sweep(const FusedParams& p, const Tables& tb,
                                                  const Ray& r, float a_q) {
  SphereHit s{trav::BIG, 0.0f, 0.0f, 0.0f, 1.0f, 0};
  for (int k = 0; k < p.n_spheres; ++k) {
    const float scx = tb.sph[4 * k], scy = tb.sph[4 * k + 1], scz = tb.sph[4 * k + 2];
    const float srad = tb.sph[4 * k + 3];
    const float ocx = r.ox - scx, ocy = r.oy - scy, ocz = r.oz - scz;
    const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - srad * srad;
    const float disc = half_b * half_b - a_q * c_q;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float root_near = (-half_b - sq) / a_q;
    const float root_far = (-half_b + sq) / a_q;
    const bool near_ok = (root_near >= p.t_min) && (root_near <= s.t);
    const bool far_ok = (root_far >= p.t_min) && (root_far <= s.t);
    const float root = near_ok ? root_near : root_far;
    const bool valid = (disc >= 0.0f) && (near_ok || far_ok);
    if (valid && (root < s.t)) {
      s.t = root;
      s.cx = scx;
      s.cy = scy;
      s.cz = scz;
      s.r = (srad != 0.0f) ? srad : 1.0f;
      s.mat = tb.sph_mat[k];
    }
  }
  return s;
}

// The sphere tree (scene/types.SphereTree, utils/cudalib.SphereTreeView):
// an 8-wide tree over the spheres' padded boxes, its leaves' spheres
// (center, radius) and their indices in leaf order, and the sweep set, the
// few spheres whose boxes would swallow the root (the ground), which every
// ray tests first, in ascending index order.
constexpr int SPHERE_STACK_CAP = 64;  // utils/cudalib.SPHERE_STACK_CAP
struct SphereTreeView {
  const float* bounds;   // [n, 8, 6]
  const int* children;   // [n, 8], coded as trav::BvhView's
  const float4* sph;     // [L] center, radius in leaf order
  const int* ids;        // [L] sphere index of each leaf slot
  const int* sweep;      // [n_sweep] sphere indices, ascending
  int n_sweep;
  // The growth of the walk's boxes for a ray from o (scene/builder
  // .sphere_growth): g = (ga L + gb) L + gc with L = |o - c| + h.
  float cx, cy, cz, h, ga, gb, gc;
};

// The best sphere so far: its root and index (-1 before any).
struct SphereBest {
  float t;
  int id;
};

// sphere_sweep's test of sphere k against the running best, with its
// formula and comparisons, and one more rule: an equal root goes to the
// lower index. The sweep keeps the first of equal roots, the lowest
// index; a walk meets the spheres in another order, and this rule gives
// it the sweep's sphere.
__device__ __forceinline__ void sphere_test(const FusedParams& p, float scx, float scy,
                                            float scz, float srad, int k, const Ray& r,
                                            float a_q, SphereBest& b) {
  const float ocx = r.ox - scx, ocy = r.oy - scy, ocz = r.oz - scz;
  const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - srad * srad;
  const float disc = half_b * half_b - a_q * c_q;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float root_near = (-half_b - sq) / a_q;
  const float root_far = (-half_b + sq) / a_q;
  const bool near_ok = (root_near >= p.t_min) && (root_near <= b.t);
  const bool far_ok = (root_far >= p.t_min) && (root_far <= b.t);
  const float root = near_ok ? root_near : root_far;
  const bool valid = (disc >= 0.0f) && (near_ok || far_ok);
  if (valid && ((root < b.t) || (root == b.t && k < b.id))) {
    b.t = root;
    b.id = k;
  }
}

// The leaf test of the sphere tree's walk (trav::walk): sphere_test of
// each sphere of the leaf's range, in order, into the best b; the walk's
// boxes grown by g; COUNT adds the tests to *tests (K3-profile).
template <bool COUNT>
struct SphereLeaf {
  static constexpr bool GROWN = true;
  const SphereTreeView& st;
  const FusedParams& p;
  const Ray& r;
  float a_q;
  int* tests;
  float g;
  __device__ __forceinline__ void operator()(int lo, int cnt, SphereBest& b) const {
    for (int k = 0; k < cnt; ++k) {
      const float4 s = st.sph[lo + k];
      sphere_test(p, s.x, s.y, s.z, s.w, st.ids[lo + k], r, a_q, b);
    }
    if constexpr (COUNT) *tests += cnt;
  }
};

// sphere_sweep's answer through the tree: the sweep set, then the walk
// limited by its best. Each sphere's root is sphere_sweep's, and the
// winner is the least root with the least index among equal roots, as
// the sweep's. The walk's boxes are the spheres' own, grown for this ray
// by g, more than the sweep's roots can round outside a sphere from this
// far away (scene/builder.sphere_growth), so no box is culled whose
// sphere the sweep would take. COUNT adds the walk's steps and leaf
// tests to *steps and *tests.
template <bool COUNT>
__device__ __forceinline__ SphereHit sphere_search(const FusedParams& p, const Tables& tb,
                                                   const SphereTreeView& st, const Ray& r,
                                                   float a_q, int* steps, int* tests) {
  const float ex = r.ox - st.cx, ey = r.oy - st.cy, ez = r.oz - st.cz;
  const float reach = sqrtf(ex * ex + ey * ey + ez * ez) + st.h;
  const float g = (st.ga * reach + st.gb) * reach + st.gc;
  SphereBest b{trav::BIG, -1};
  for (int j = 0; j < st.n_sweep; ++j) {
    const int k = st.sweep[j];
    sphere_test(p, tb.sph[4 * k], tb.sph[4 * k + 1], tb.sph[4 * k + 2], tb.sph[4 * k + 3], k, r,
                a_q, b);
  }
  const SphereLeaf<COUNT> leaf{st, p, r, a_q, tests, g};
  trav::walk<8, SPHERE_STACK_CAP, COUNT>(st.bounds, st.children, r.ox, r.oy, r.oz,
                                         1.0f / r.dx, 1.0f / r.dy, 1.0f / r.dz, p.t_min, b, leaf,
                                         steps);
  SphereHit s{trav::BIG, 0.0f, 0.0f, 0.0f, 1.0f, 0};
  if (b.t < trav::BIG) {
    const int k = b.id;
    const float srad = tb.sph[4 * k + 3];
    s.t = b.t;
    s.cx = tb.sph[4 * k];
    s.cy = tb.sph[4 * k + 1];
    s.cz = tb.sph[4 * k + 2];
    s.r = (srad != 0.0f) ? srad : 1.0f;
    s.mat = tb.sph_mat[k];
  }
  return s;
}

// The closest sphere of a path iteration: with the tree (TREE), the
// search; without it, the sweep over every sphere.
template <bool TREE, bool COUNT>
__device__ __forceinline__ SphereHit spheres(const FusedParams& p, const Tables& tb,
                                             const SphereTreeView& st, const Ray& r, float a_q,
                                             int* steps, int* tests) {
  if constexpr (TREE) {
    return sphere_search<COUNT>(p, tb, st, r, a_q, steps, tests);
  } else {
    return sphere_sweep(p, tb, r, a_q);
  }
}

// The rest of a path iteration once K1 has found h within [t_min, s.t):
// resolve the hit, then sky, emission or scatter. True when the path goes
// on (r is the next ray); false when its sample ends, with the sample's
// radiance in c (which the caller zeroes: it stays zero when the path is
// absorbed or reaches max_bounces).
__device__ __forceinline__ bool shade(const FusedParams& p, const Tables& tb,
                                      const ktf::Sampler& smp, int bounce, const SphereHit& s,
                                      const trav::Hit& h, float a_q, Ray& r, float& cx, float& cy,
                                      float& cz) {
  const bool tri_wins = h.t < s.t;
  const float t_hit = tri_wins ? h.t : s.t;
  const float inv_dl = 1.0f / sqrtf(a_q);
  if (!(t_hit < trav::BIG)) {
    // Miss: sky gradient on the current direction (CRTUtility.cuh:34-38).
    const float sky_t = 0.5f * (r.dy * inv_dl + 1.0f);
    cx = r.tx * ((1.0f - sky_t) + sky_t * SKY_TOP_X);
    cy = r.ty * ((1.0f - sky_t) + sky_t * SKY_TOP_Y);
    cz = r.tz * ((1.0f - sky_t) + sky_t * SKY_TOP_Z);
    return false;
  }
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  const float hpx = r.ox + t_hit * dx, hpy = r.oy + t_hit * dy, hpz = r.oz + t_hit * dz;
  const float rnx = tri_wins ? h.nx : (hpx - s.cx) / s.r;
  const float rny = tri_wins ? h.ny : (hpy - s.cy) / s.r;
  const float rnz = tri_wins ? h.nz : (hpz - s.cz) / s.r;
  const float inv_nn = 1.0f / sqrtf(fmaxf(rnx * rnx + rny * rny + rnz * rnz, 1e-24f));
  const float nnx = rnx * inv_nn, nny = rny * inv_nn, nnz = rnz * inv_nn;
  const bool front = (dx * nnx + dy * nny + dz * nnz) < 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  const float nx = nnx * fsign, ny = nny * fsign, nz = nnz * fsign;
  const int mid = tri_wins ? h.mat : s.mat;

  // Material lookup (ops/materials.lookup_params defaults off-table).
  int mtype = 0;
  float albx = 0.0f, alby = 0.0f, albz = 0.0f, emx = 0.0f, emy = 0.0f, emz = 0.0f;
  float rough = 0.0f, ior = 1.0f;
  if (mid >= 0 && mid < p.n_materials) {
    const float* mr = tb.mat + 8 * mid;
    mtype = tb.mat_type[mid];
    albx = mr[0]; alby = mr[1]; albz = mr[2];
    emx = mr[3]; emy = mr[4]; emz = mr[5];
    rough = mr[6]; ior = mr[7];
  }

  if (mtype == 3) {  // DiffuseLight: emits and never scatters.
    if (p.emission_quirk) {
      cx = emx; cy = emy; cz = emz;
    } else {
      cx = r.tx * emx; cy = r.ty * emy; cz = r.tz * emz;
    }
    return false;
  }

  // --- Scatter (pallas_megakernel.py post_trav formulas).
  float scdx, scdy, scdz;
  bool scattered;
  if (mtype == 2) {  // Dielectric (Core/Material.cuh:109-137)
    const float u_die = smp.uniform(ktf::DIELECTRIC);
    const float ri = front ? 1.0f / ior : ior;
    const float uix = dx * inv_dl, uiy = dy * inv_dl, uiz = dz * inv_dl;
    const float cos_t = fminf(-(uix * nx + uiy * ny + uiz * nz), 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = (ri * sin_t) > 1.0f;
    const float r0q = (1.0f - ri) / (1.0f + ri);
    const float r0 = r0q * r0q;
    const float one_mc = 1.0f - cos_t;
    const float omc2 = one_mc * one_mc;
    const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * one_mc;
    if (cannot || (schlick > u_die)) {
      const float u_dot = uix * nx + uiy * ny + uiz * nz;
      scdx = uix - 2.0f * u_dot * nx;
      scdy = uiy - 2.0f * u_dot * ny;
      scdz = uiz - 2.0f * u_dot * nz;
    } else {
      const float rpx = ri * (uix + cos_t * nx);
      const float rpy = ri * (uiy + cos_t * ny);
      const float rpz = ri * (uiz + cos_t * nz);
      const float rp2 = rpx * rpx + rpy * rpy + rpz * rpz;
      const float rpar = -sqrtf(fmaxf(fabsf(1.0f - rp2), 1e-12f));
      scdx = rpx + rpar * nx;
      scdy = rpy + rpar * ny;
      scdz = rpz + rpar * nz;
    }
    albx = 1.0f; alby = 1.0f; albz = 1.0f;
    scattered = true;
  } else {
    float uvx, uvy, uvz;
    smp.unit_vector(ktf::SCATTER, uvx, uvy, uvz);
    if (mtype == 1) {  // Metal: normalize(reflect(d, n)) + roughness * unit vector
      const float d_dot_n = dx * nx + dy * ny + dz * nz;
      const float refx = dx - 2.0f * d_dot_n * nx;
      const float refy = dy - 2.0f * d_dot_n * ny;
      const float refz = dz - 2.0f * d_dot_n * nz;
      const float inv_rl =
          1.0f / sqrtf(fmaxf(refx * refx + refy * refy + refz * refz, EPS_SQ_1E20));
      scdx = refx * inv_rl + rough * uvx;
      scdy = refy * inv_rl + rough * uvy;
      scdz = refz * inv_rl + rough * uvz;
      scattered = (scdx * nx + scdy * ny + scdz * nz) > 0.0f;
    } else {  // Lambertian (type 0 and any unknown tag, as the select chain)
      scdx = nx + uvx;
      scdy = ny + uvy;
      scdz = nz + uvz;
      if (fabsf(scdx) < EPS_NEAR_ZERO && fabsf(scdy) < EPS_NEAR_ZERO &&
          fabsf(scdz) < EPS_NEAR_ZERO) {
        scdx = nx;
        scdy = ny;
        scdz = nz;
      }
      scattered = (mtype == 0);
    }
  }
  if (!(scattered && (bounce + 1 < p.max_bounces))) return false;  // absorbed / max bounce

  r.tx = r.tx * albx;
  r.ty = r.ty * alby;
  r.tz = r.tz * albz;
  r.ox = hpx;
  r.oy = hpy;
  r.oz = hpz;
  r.dx = scdx;
  r.dy = scdy;
  r.dz = scdz;
  return true;
}

}  // namespace path
