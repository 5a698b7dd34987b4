// The v5-body kernels of chain width W = 1 of modes empty .. minimal (see
// probe_v5.cuh), in a source of their own so that they compile in parallel
// with probe_v5.cu's.
#include "probe_v5.cuh"

namespace probe_v5 {

KernelFn kernel_w1_hi(int mode) { return kernels_in<1, SPLIT, N_MODES>(mode); }

}  // namespace probe_v5
