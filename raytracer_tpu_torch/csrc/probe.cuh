// Pieces shared by the traversal-iteration probes (probe_v8.cuh,
// probe_v5.cuh, probe_morph.cuh, probe_v6.cu and the others): the lanes of a
// chain, the probes' slab test and their two Möller–Trumbore records (the
// one-output record of P-v8 and the v5 body, the six-output record of P-v6
// and P-morph), the chain reductions and the integer and float conversions
// with the TPU script's semantics.
//
// Mapping. A TPU packet is (8, 128): 8 chains ("sub-warps") of 128 lanes,
// each chain with its own task. Here a chain is one warp and a packet one
// block of 8 warps; thread l of a warp owns lanes l, l+32, l+64, l+96. What
// is per chain (task, stack pointer, spares, child codes, sort keys) is
// warp-uniform: every lane computes the same value. What the TPU kept in
// SMEM lives in the warp's slice of shared memory, written by lane 0 and
// read by all lanes, with __syncwarp() between.
//
// Every operation is the script's, in its order, in float32 without
// contraction (-fmad=false), so the kernels equal their plain PyTorch
// versions bit for bit. A reduction over a chain's lanes is a pass over the
// thread's 4 lanes and a __shfl_xor_sync butterfly: a min is order-free and
// an int32 sum exact.
//
// P-v8, the v5 body, P-morph, P-interleave and P-v6 may spread a chain over
// W warps instead: each thread then owns N = 4 / W of its lanes (LanesN<N>,
// the lanes lane0 + 32 j of load_rays), and the chain's warps combine their
// partial reductions through shared memory under a named barrier
// (chain_sync).
#pragma once
#include <cstdint>

namespace probe {

constexpr int P_SUB = 8;             // chains (warps) per packet (block)
constexpr int P_LANE = 128;          // lanes per chain
constexpr int LPT = P_LANE / 32;     // lanes per thread
constexpr int ROW = 128;             // floats per table row
constexpr int TRI_STRIDE = 16;       // floats per triangle record
constexpr int NODE_STRIDE = 32;      // floats per node record (4 per row)
constexpr float BIG = 3.0e38f;
constexpr float HALF_BIG = 1.5e38f;  // orders rep-miss (but visited) children last
constexpr int NONE = -1;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }

// jnp.minimum (and torch's): NaN in, NaN out; fminf drops a NaN.
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}

// astype(int32) of a float-encoded id, as XLA converts: toward zero,
// saturating, NaN -> 0.
__device__ __forceinline__ int f2i(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return static_cast<int>(x);
}

// jnp's // and % on int32: floor division (C's / and % truncate).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// x << 16 as int32 wraps it (0xFFFF << 16 = -65536); a signed shift into the
// sign bit is undefined in C, so shift the bits unsigned.
__device__ __forceinline__ int shl16(int x) {
  return static_cast<int>(static_cast<uint32_t>(x) << 16);
}
// -x - 2 with int32 wrap-around (a garbage task of loads0 may be INT_MIN).
__device__ __forceinline__ int neg2(int x) {
  return static_cast<int>(0u - static_cast<uint32_t>(x) - 2u);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// Keeps a value that reaches no output computed (carry8's task).
__device__ __forceinline__ void keep(int x) { asm volatile("" : : "r"(x)); }

// A thread's N lanes of a chain (N = LPT where a warp is the chain).
template <int N>
struct LanesN {
  float ox[N], oy[N], oz[N], dx[N], dy[N], dz[N], ix[N], iy[N], iz[N];
  float t_best[N];
  int best[N];
};
using Lanes = LanesN<LPT>;

// Rays of chain s of packet p from o, d f32[P, 3, 8, 128], lanes lane0 +
// 32 j of the thread; 1/d as the scripts take it.
template <int N>
__device__ __forceinline__ void load_rays(LanesN<N>& L, const float* __restrict__ o,
                                          const float* __restrict__ d, int p, int s, int lane0) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = lane0 + 32 * j;
    const size_t base = (static_cast<size_t>(p) * 3 * P_SUB + s) * P_LANE + l;
    const size_t c = P_SUB * P_LANE;
    L.ox[j] = o[base];
    L.oy[j] = o[base + c];
    L.oz[j] = o[base + 2 * c];
    L.dx[j] = d[base];
    L.dy[j] = d[base + c];
    L.dz[j] = d[base + 2 * c];
    L.ix[j] = 1.0f / L.dx[j];
    L.iy[j] = 1.0f / L.dy[j];
    L.iz[j] = 1.0f / L.dz[j];
  }
}

// The scripts' mt_record for all of the thread's lanes: fields v0, e1, e2 of
// one record (per chain), prim its float-encoded id.
template <int N>
__device__ __forceinline__ void mt_record(LanesN<N>& L, const float (&r)[9], int prim) {
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float dx = L.dx[j], dy = L.dy[j], dz = L.dz[j];
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    bool ok = fabsf(a) >= 1e-8f;
    const float f = 1.0f / (ok ? a : 1.0f);
    const float sx = L.ox[j] - v0x, sy = L.oy[j] - v0y, sz = L.oz[j] - v0z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    ok = ok & (u >= 0.0f) & (u <= 1.0f);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (dx * qx + dy * qy + dz * qz);
    ok = ok & (v >= 0.0f) & (u + v <= 1.0f);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    ok = ok & (t >= 1e-3f) & (t < L.t_best[j]);
    L.t_best[j] = ok ? t : L.t_best[j];
    L.best[j] = ok ? prim : L.best[j];
  }
}

// What a hit carries besides t_best and best, for a thread's N lanes.
template <int N>
struct RecN {
  int mat[N];
  float nx[N], ny[N], nz[N];
};

// The 6-field mt_record of the v6 and morph scripts for the thread's N
// lanes: fields v0, e1, e2 of one record, its float-encoded prim and
// material ids converted; a hit also takes the material id and the
// unnormalised normal e1 x e2. f is __frcp_rn, the IEEE round-to-nearest
// reciprocal: the bits of 1.0f / x (both are correctly rounded). Its SASS
// has as many instructions as the division's, yet P-morph with it takes
// 0.77-0.90x the time of P-morph with the division (an H100 at 700 W,
// chip_smoke.py phase 15 against the division's build); why is not
// measured.
template <int N>
__device__ __forceinline__ void mt_record6(LanesN<N>& L, RecN<N>& R, const float (&r)[9],
                                           int prim, int matid) {
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float cx = e1y * e2z - e1z * e2y;
  const float cy = e1z * e2x - e1x * e2z;
  const float cz = e1x * e2y - e1y * e2x;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float dx = L.dx[j], dy = L.dy[j], dz = L.dz[j];
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    bool ok = fabsf(a) >= 1e-8f;
    const float f = __frcp_rn(ok ? a : 1.0f);
    const float sx = L.ox[j] - v0x, sy = L.oy[j] - v0y, sz = L.oz[j] - v0z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    ok = ok & (u >= 0.0f) & (u <= 1.0f);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (dx * qx + dy * qy + dz * qz);
    ok = ok & (v >= 0.0f) & (u + v <= 1.0f);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    ok = ok & (t >= 1e-3f) & (t < L.t_best[j]);
    L.t_best[j] = ok ? t : L.t_best[j];
    L.best[j] = ok ? prim : L.best[j];
    R.mat[j] = ok ? matid : R.mat[j];
    R.nx[j] = ok ? cx : R.nx[j];
    R.ny[j] = ok ? cy : R.ny[j];
    R.nz[j] = ok ? cz : R.nz[j];
  }
}

// The scripts' slab for lane j against box b (min xyz, max xyz): hit and
// entry distance tmin. The scripts take min/max with jnp.minimum/maximum,
// which propagate NaN: a NaN plane distance makes tmin NaN and the test a
// miss, and so does a NaN t_best. Here that is the explicit rule of
// traverse.cuh's `slab` — any NaN among the six distances is a miss,
// with tmin NaN — and fminf/fmaxf otherwise, which then give jnp's values.
template <int N>
__device__ __forceinline__ bool slab(const LanesN<N>& L, int j, const float (&b)[6],
                                     float& tmin) {
  const float t0x = (b[0] - L.ox[j]) * L.ix[j], t1x = (b[3] - L.ox[j]) * L.ix[j];
  const float t0y = (b[1] - L.oy[j]) * L.iy[j], t1y = (b[4] - L.oy[j]) * L.iy[j];
  const float t0z = (b[2] - L.oz[j]) * L.iz[j], t1z = (b[5] - L.oz[j]) * L.iz[j];
  const bool nan6 = isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) ||
                    isnan(t1z);
  tmin = nan6 ? qnan()
              : fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), 1e-3f));
  const float tmax =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), L.t_best[j]));
  return !nan6 && !isnan(L.t_best[j]) && tmax > tmin;
}

// Element c (0..3, a constant once unrolled) of a float4.
__device__ __forceinline__ float elem(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The 8 records of a triangle row staged as 16-byte words in shared memory
// (row_word).
template <int N>
__device__ __forceinline__ void mt_row8(LanesN<N>& L, RecN<N>& R, const float4* tq) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4* q = tq + k * (TRI_STRIDE / 4);
    float r[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) r[f] = elem(q[f >> 2], f & 3);
    mt_record6(L, R, r, f2i(q[2].y), f2i(q[2].z));
  }
}

// 16-byte word i of a 16-byte aligned row: a warp's lanes read a row of up
// to 32 words in one coalesced load, lane i word i, into the warp's slice of
// shared memory, where every lane reads back what it uses (a broadcast).
// Held in registers, a P-v8 iteration's 38 words would take 152 of them.
__device__ __forceinline__ float4 row_word(const float* __restrict__ row, int i) {
  return __ldg(reinterpret_cast<const float4*>(row) + i);
}

// p, as a value the compiler cannot see through: the loads of a static row
// (the no_fetch modes) stay in the loop, as a dynamic row's do.
__device__ __forceinline__ const float* opaque(const float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// The warps an SM holds when each thread takes `regs` registers: each of its
// 4 schedulers has a quarter of the 65,536 registers, given to a warp in
// units of 256 (8 a thread), so 80 registers hold 6 warps a scheduler, 24
// an SM (__launch_bounds__ room for 25 one-warp blocks leaves 72).
__host__ __device__ constexpr int warps_for_regs(int regs) {
  return 4 * (16384 / (32 * ((regs + 7) / 8 * 8)));
}

// Barrier `id` (1..15; 0 is __syncthreads) over the `threads` threads of
// one chain, which are whole warps.
__device__ __forceinline__ void chain_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(threads) : "memory");
}

// One compare-exchange of a sorting network over (key, code) arrays: keys
// ascending, a swap only on a strictly greater key.
#define PROBE_CSWAP(key, code, i, j)          \
  {                                           \
    const bool sw = key[i] > key[j];          \
    const float ki_ = sw ? key[j] : key[i];   \
    const float kj_ = sw ? key[i] : key[j];   \
    const int ci_ = sw ? code[j] : code[i];   \
    const int cj_ = sw ? code[i] : code[j];   \
    key[i] = ki_;                             \
    key[j] = kj_;                             \
    code[i] = ci_;                            \
    code[j] = cj_;                            \
  }

}  // namespace probe
