// The P-morph kernels of chain width W = 2 (see probe_morph.cuh), in a
// source of their own so that they compile in parallel with probe_morph.cu's.
#include "probe_morph.cuh"

namespace probe_morph {

KernelFn kernel_w2(int variant) { return kernels_in<2, 0, N_VARIANTS>(variant); }

}  // namespace probe_morph
