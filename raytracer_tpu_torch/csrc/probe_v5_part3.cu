// The v5-body kernels of P-base's modes base, noconcat, noc_nosc and minimal
// (see probe_v5.cuh), in a source of their own so that they compile in
// parallel with probe_v5.cu's and probe_v5_part2.cu's.
#include "probe_v5.cuh"

namespace probe_v5 {

KernelFn part3_kernel(int mode) {
  switch (mode) {
    case BASE: return probe_v5_kernel<BASE>;
    case NOCONCAT: return probe_v5_kernel<NOCONCAT>;
    case NOC_NOSC: return probe_v5_kernel<NOC_NOSC>;
    case MINIMAL: return probe_v5_kernel<MINIMAL>;
    default: return nullptr;
  }
}

}  // namespace probe_v5
