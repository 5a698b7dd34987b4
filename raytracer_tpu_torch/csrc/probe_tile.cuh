// The [8, 128] tile mapping of the single-tile probes redesigned for Hopper
// (probe_mosaic.cu, probe_feature.cu, probe_ktf.cu, probe_bitcast.cu); the
// other probes keep probe.cuh's.
//
// One block of 8 warps; warp s is row s, and thread l owns the four
// adjacent lanes 4l..4l+3 of it, so a warp reads or writes its row as 512
// contiguous bytes, one 128-bit access per thread (loads through the
// read-only path). A scalar of a row is read once, by the lane that holds
// it or by lane 0, and broadcast with __shfl_sync. A table is staged in
// shared memory by one TMA bulk copy (cp.async.bulk) that completes on an
// mbarrier.
//
// Every operation is one float32 operation per lane, as in the plain
// PyTorch versions (-fmad=false), so the bits are theirs.
#pragma once
#include <cstdint>

namespace tile {

constexpr int VEC = 4;  // lanes per thread

__device__ __forceinline__ float4 load4(const float* __restrict__ row, int lane) {
  return __ldg(reinterpret_cast<const float4*>(row) + lane);
}
__device__ __forceinline__ void store4(float* row, int lane, float4 v) {
  reinterpret_cast<float4*>(row)[lane] = v;
}
__device__ __forceinline__ void store4(int* row, int lane, int v) {
  reinterpret_cast<int4*>(row)[lane] = make_int4(v, v, v, v);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 add(float4 a, float b) {
  return make_float4(a.x + b, a.y + b, a.z + b, a.w + b);
}
__device__ __forceinline__ float4 mul(float4 a, float b) {
  return make_float4(a.x * b, a.y * b, a.z * b, a.w * b);
}

// ---- one TMA bulk copy, global -> shared, on an mbarrier ------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// By one thread: the barrier expects one arrival; the copy of `bytes` (a
// multiple of 16, both addresses 16-byte aligned) completes its phase 0.
// The other threads wait only after a __syncthreads that follows this.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: spin until the barrier's phase 0 has completed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

}  // namespace tile
