// K5 on a 4-wide tree (see interleave.cuh), in a source of its own so that
// it compiles in parallel with interleave.cu's width-8 instantiation.
#include "interleave.cuh"

namespace g2 {

cudaError_t launch_w4(const mk::FusedArgs& a) { return launch<4>(a); }

cudaError_t attributes_w4(cudaFuncAttributes* attr) { return attributes<4>(attr); }

}  // namespace g2
