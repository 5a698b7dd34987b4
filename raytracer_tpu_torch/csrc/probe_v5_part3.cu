// The v5-body kernels of chain width W = 2 (see probe_v5.cuh), in a source
// of their own so that they compile in parallel with probe_v5.cu's.
#include "probe_v5.cuh"

namespace probe_v5 {

KernelFn kernel_w2(int mode) { return kernels_in<2, 0, N_MODES>(mode); }

}  // namespace probe_v5
