// Latency calibration for the chain probes' dependence bounds: the SM clocks
// one dependent integer ALU operation and one warp shuffle take on the
// current card. chip_smoke.py phase 13 multiplies P-vstack's chains
// (probes/vstack.dependence_steps) and the P-scalar tables pre-pass's
// (probes/scalar_cost.tables_work) by them; no probe's path runs this.
// Wrapper: raytracer_tpu_torch/probes/common.py latency_clocks.
//
// One warp runs `n` steps (a multiple of 16) of one chain, each step's
// operand the last step's result, between two clock64 reads around the
// whole loop; lane 0 writes the clocks. kind 0: two integer ALU operations,
// (y + i) ^ K (IADD3 then LOP3: no pass folds them across steps); kind 1: a
// shuffle from lane (lane + i) mod 32 (SHFL.IDX; a warp-uniform index would
// let ptxas drop a shuffle of a uniform value). The loop's own count runs
// beside the chain, so clocks / n is at most a step's latency plus the two
// reads spread over n.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace probe_latency {

using probe::FULL;

__global__ void __launch_bounds__(32)
    probe_latency_kernel(int n, int kind, long long* __restrict__ clocks, int* __restrict__ sink) {
  const int lane = static_cast<int>(threadIdx.x);
  int y = lane;
  const long long t0 = clock64();
  if (kind == 0) {
    for (int i = 0; i < n; i += 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) y = (y + (i + k)) ^ 0x5bd1e995;
    }
  } else {
    for (int i = 0; i < n; i += 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) y = __shfl_sync(FULL, y, (lane + i + k) & 31);
    }
  }
  if (y == 0x7fffffff) sink[lane] = y;  // keeps the chain live
  const long long t1 = clock64();
  if (lane == 0) *clocks = t1 - t0;
}

}  // namespace probe_latency

// probe_latency_kernel once: n dependent steps (n > 0, a multiple of 16) of
// kind 0 (IADD3 and LOP3) or 1 (SHFL); clocks int64[1] takes their clock64
// count, sink int32[32] is written only if the chain ends at INT_MAX.
extern "C" int rt_probe_latency(int n, int kind, long long* clocks, int* sink, void* stream) {
  if (n <= 0 || n % 16 != 0 || kind < 0 || kind > 1 || clocks == nullptr || sink == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_latency::probe_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n, kind, clocks, sink);
  return static_cast<int>(cudaGetLastError());
}
