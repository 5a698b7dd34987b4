// The P-morph kernels of chain width W = 1 of variants 7-12,
// v6_whilecounter .. v11_cap_noclamp (see probe_morph.cuh), in a source of
// their own so that they compile in parallel with probe_morph.cu's.
#include "probe_morph.cuh"

namespace probe_morph {

KernelFn kernel_w1_hi(int variant) { return kernels_in<1, SPLIT, N_VARIANTS>(variant); }

}  // namespace probe_morph
