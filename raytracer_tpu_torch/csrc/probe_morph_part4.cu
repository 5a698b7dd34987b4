// The P-morph kernels of chain width W = 4 (see probe_morph.cuh), in a
// source of their own so that they compile in parallel with probe_morph.cu's.
#include "probe_morph.cuh"

namespace probe_morph {

KernelFn kernel_w4(int variant) { return kernels_in<4, 0, N_VARIANTS>(variant); }

}  // namespace probe_morph
