// The v5-body kernels of loads8, loads0, empty, carry8, smem8, prod_smem and
// prod_carry (see probe_v5.cuh), in a source of their own so that they
// compile in parallel with probe_v5.cu's.
#include "probe_v5.cuh"

namespace probe_v5 {

KernelFn part2_kernel(int mode) {
  switch (mode) {
    case LOADS8: return probe_v5_kernel<LOADS8>;
    case LOADS0: return probe_v5_kernel<LOADS0>;
    case EMPTY: return probe_v5_kernel<EMPTY>;
    case CARRY8: return probe_v5_kernel<CARRY8>;
    case SMEM8: return probe_v5_kernel<SMEM8>;
    case PROD_SMEM: return probe_v5_kernel<PROD_SMEM>;
    case PROD_CARRY: return probe_v5_kernel<PROD_CARRY>;
    default: return part3_kernel(mode);
  }
}

}  // namespace probe_v5
