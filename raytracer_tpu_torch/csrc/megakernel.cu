// K3: the whole path loop per pixel lane in one kernel.
//
// Replaces raytracer_tpu/ops/pallas_megakernel.py _render_packets_fused
// (:623), whose kernel is _make_mega_kernel (:121); the wrapper is
// raytracer_tpu_torch/ops/cuda_megakernel.py render_tiles_fused and the
// plain PyTorch version is _render_plain there.
//
// Shape: one thread per pixel lane, looping samples and bounces — the
// CUDA reference's own shape (CUDAKernels.h:102-166). The nested loop is
// exactly the per-lane sequence of the TPU kernel's regeneration state
// machine: every draw is keyed by (pixel, sample + sample_offset, bounce,
// purpose) (ktf.cuh), samples accumulate in order, and the TPU's loop
// bound spp*max_bounces+2 never binds, so none is needed.
//
// Semantics kept from pre_trav/post_trav (:191-467), with the same
// formulas, select order and comparison strictness: thin-lens camera ray
// with jitter and lens draws at bounce 0; Russian roulette from
// min_bounces with survival min(max throughput, rr_max_prob); sphere sweep
// against the running best (root_near <= t_sph); K1 (traverse.cuh) with
// t_lim = t_sph; tri_wins = t_tri < t_sph; the four materials' scatter;
// emission with the quirk flag; sky on miss; black at max bounce. A lane
// killed by roulette ends its sample with zero, as the TPU's dead lanes do.
//
// What bounds it on an H100: the traversal's dependent loads and the
// divergence of lanes that leave their samples at different bounces; the
// shading arithmetic and Threefry draws are a small share. The camera,
// roulette and sample constants travel by value in FusedParams; spheres
// (<= 16) and materials (<= 28) are read from small global tables whose
// uniform or few distinct addresses the L1 serves.
#include <cuda_runtime.h>

#include "ktf.cuh"
#include "traverse.cuh"

struct FusedParams {
  float ll[3], hor[3], ver[3], pos[3], right[3], up[3];
  float lens_r, inv_w, inv_h, rr_max_prob, t_min;
  uint32_t k0, k1;
  int sample_offset, spp, max_bounces, min_bounces, emission_quirk, n_spheres, n_materials;
};

namespace {

constexpr float SKY_TOP_X = 0.5f, SKY_TOP_Y = 0.7f, SKY_TOP_Z = 1.0f;
constexpr float EPS_NEAR_ZERO = 1e-8f;
constexpr float EPS_SQ_1E20 = 1e-20f * 1e-20f;  // float32 product, as the reference

__global__ void fused_path_kernel(FusedParams p, trav::BvhView bvh, const int* __restrict__ pix,
                                  const int* __restrict__ pxi, const int* __restrict__ pyi,
                                  const float* __restrict__ sph, const int* __restrict__ sph_mat,
                                  const float* __restrict__ mat, const int* __restrict__ mat_type,
                                  int n, float* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint32_t pixel = static_cast<uint32_t>(pix[lane]);
  const float pxf = static_cast<float>(pxi[lane]);
  const float pyf = static_cast<float>(pyi[lane]);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;

  for (int s = 0; s < p.spp; ++s) {
    const uint32_t s_eff = static_cast<uint32_t>(s + p.sample_offset);
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;  // this sample's radiance

    // --- Camera ray (Core/Camera.cuh:32-44), draws keyed at bounce 0.
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
    float ox = p.pos[0] + offx, oy = p.pos[1] + offy, oz = p.pos[2] + offz;
    float dx = p.ll[0] + u * p.hor[0] + v * p.ver[0] - p.pos[0] - offx;
    float dy = p.ll[1] + u * p.hor[1] + v * p.ver[1] - p.pos[1] - offy;
    float dz = p.ll[2] + u * p.hor[2] + v * p.ver[2] - p.pos[2] - offz;
    float tx = 1.0f, ty = 1.0f, tz = 1.0f;

    for (int bounce = 0;; ++bounce) {
      const ktf::Sampler smp{p.k0, p.k1, pixel, s_eff, static_cast<uint32_t>(bounce)};

      // --- Russian roulette (CUDAKernels.h:113-121).
      const bool do_rr = bounce >= p.min_bounces;
      const float survival = fminf(fmaxf(fmaxf(tx, ty), tz), p.rr_max_prob);
      const float u_rr = smp.uniform(ktf::RR);
      if (do_rr && (u_rr > survival)) break;  // killed: this sample adds zero
      if (do_rr) {
        const float rr_scale = 1.0f / fmaxf(survival, 1e-12f);
        tx = tx * rr_scale;
        ty = ty * rr_scale;
        tz = tz * rr_scale;
      }

      // --- Sphere sweep against the running best.
      const float a_q = dx * dx + dy * dy + dz * dz;
      float t_sph = trav::BIG;
      float cselx = 0.0f, csely = 0.0f, cselz = 0.0f, r_sel = 1.0f;
      int m_self = 0;
      for (int k = 0; k < p.n_spheres; ++k) {
        const float scx = sph[4 * k], scy = sph[4 * k + 1], scz = sph[4 * k + 2];
        const float srad = sph[4 * k + 3];
        const float ocx = ox - scx, ocy = oy - scy, ocz = oz - scz;
        const float half_b = ocx * dx + ocy * dy + ocz * dz;
        const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - srad * srad;
        const float disc = half_b * half_b - a_q * c_q;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float root_near = (-half_b - sq) / a_q;
        const float root_far = (-half_b + sq) / a_q;
        const bool near_ok = (root_near >= p.t_min) && (root_near <= t_sph);
        const bool far_ok = (root_far >= p.t_min) && (root_far <= t_sph);
        const float root = near_ok ? root_near : root_far;
        const bool valid = (disc >= 0.0f) && (near_ok || far_ok);
        if (valid && (root < t_sph)) {
          t_sph = root;
          cselx = scx;
          csely = scy;
          cselz = scz;
          r_sel = (srad != 0.0f) ? srad : 1.0f;
          m_self = sph_mat[k];
        }
      }

      // --- K1: closest triangle in [t_min, t_sph).
      const trav::Hit h = trav::traverse(bvh, ox, oy, oz, dx, dy, dz, t_sph, p.t_min);
      const bool tri_wins = h.t < t_sph;
      const float t_hit = tri_wins ? h.t : t_sph;
      const float inv_dl = 1.0f / sqrtf(a_q);
      if (!(t_hit < trav::BIG)) {
        // Miss: sky gradient on the current direction (CRTUtility.cuh:34-38).
        const float sky_t = 0.5f * (dy * inv_dl + 1.0f);
        cx = tx * ((1.0f - sky_t) + sky_t * SKY_TOP_X);
        cy = ty * ((1.0f - sky_t) + sky_t * SKY_TOP_Y);
        cz = tz * ((1.0f - sky_t) + sky_t * SKY_TOP_Z);
        break;
      }
      const float hpx = ox + t_hit * dx, hpy = oy + t_hit * dy, hpz = oz + t_hit * dz;
      const float rnx = tri_wins ? h.nx : (hpx - cselx) / r_sel;
      const float rny = tri_wins ? h.ny : (hpy - csely) / r_sel;
      const float rnz = tri_wins ? h.nz : (hpz - cselz) / r_sel;
      const float inv_nn = 1.0f / sqrtf(fmaxf(rnx * rnx + rny * rny + rnz * rnz, 1e-24f));
      const float nnx = rnx * inv_nn, nny = rny * inv_nn, nnz = rnz * inv_nn;
      const bool front = (dx * nnx + dy * nny + dz * nnz) < 0.0f;
      const float fsign = front ? 1.0f : -1.0f;
      const float nx = nnx * fsign, ny = nny * fsign, nz = nnz * fsign;
      const int mid = tri_wins ? h.mat : m_self;

      // --- Material lookup (ops/materials.lookup_params defaults off-table).
      int mtype = 0;
      float albx = 0.0f, alby = 0.0f, albz = 0.0f, emx = 0.0f, emy = 0.0f, emz = 0.0f;
      float rough = 0.0f, ior = 1.0f;
      if (mid >= 0 && mid < p.n_materials) {
        const float* mr = mat + 8 * mid;
        mtype = mat_type[mid];
        albx = mr[0]; alby = mr[1]; albz = mr[2];
        emx = mr[3]; emy = mr[4]; emz = mr[5];
        rough = mr[6]; ior = mr[7];
      }

      if (mtype == 3) {  // DiffuseLight: emits and never scatters.
        if (p.emission_quirk) {
          cx = emx; cy = emy; cz = emz;
        } else {
          cx = tx * emx; cy = ty * emy; cz = tz * emz;
        }
        break;
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
      if (!(scattered && (bounce + 1 < p.max_bounces))) break;  // absorbed / max bounce: black

      tx = tx * albx;
      ty = ty * alby;
      tz = tz * albz;
      ox = hpx;
      oy = hpy;
      oz = hpz;
      dx = scdx;
      dy = scdy;
      dz = scdz;
    }
    ax = ax + cx;
    ay = ay + cy;
    az = az + cz;
  }
  out[3 * lane] = ax;
  out[3 * lane + 1] = ay;
  out[3 * lane + 2] = az;
}

}  // namespace

extern "C" int rt_render_fused(const FusedParams* p, const trav::BvhView* bvh, const int* pix,
                               const int* px, const int* py, const float* sph, const int* sph_mat,
                               const float* mat, const int* mat_type, int n, float* out,
                               int block, void* stream) {
  if (bvh->width != trav::K) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int grid = (n + block - 1) / block;
    fused_path_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        *p, *bvh, pix, px, py, sph, sph_mat, mat, mat_type, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
