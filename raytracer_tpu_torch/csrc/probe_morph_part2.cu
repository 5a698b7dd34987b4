// The P-morph kernels of variants 7-12, v6_whilecounter .. v11_cap_noclamp
// (see probe_morph.cuh), in a source of their own so that they compile in
// parallel with probe_morph.cu's.
#include "probe_morph.cuh"

namespace probe_morph {

KernelFn part2_kernel(int variant) {
  switch (variant) {
    // v6_whilecounter, v7_whilealive_cap, v8_cap_outs6, v9_cap_rootinit, v10_cap_brute,
    // v11_cap_noclamp
    case 7: return probe_morph_kernel<WHILECOUNTER, false, false, false, true>;
    case 8: return probe_morph_kernel<WHILEALIVECAP, false, false, false, true>;
    case 9: return probe_morph_kernel<WHILEALIVECAP, true, false, false, true>;
    case 10: return probe_morph_kernel<WHILEALIVECAP, true, true, false, true>;
    case 11: return probe_morph_kernel<WHILEALIVECAP, true, true, true, true>;
    case 12: return probe_morph_kernel<WHILEALIVECAP, true, true, true, false>;
    default: return nullptr;
  }
}

}  // namespace probe_morph
