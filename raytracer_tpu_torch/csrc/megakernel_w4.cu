// K3 and K3-profile on a 4-wide tree (see megakernel.cuh), in a source of
// their own so that they compile in parallel with megakernel.cu's width-8
// instantiations.
#include "megakernel.cuh"

namespace mk {

cudaError_t launch_w4(bool profile, const FusedArgs& a) {
  return profile ? launch<4, true>(a) : launch<4, false>(a);
}

cudaError_t attributes_w4(bool profile, cudaFuncAttributes* attr) {
  return profile ? attributes<4, true>(attr) : attributes<4, false>(attr);
}

}  // namespace mk
