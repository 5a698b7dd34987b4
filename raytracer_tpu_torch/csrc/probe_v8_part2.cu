// The P-v8 kernels of chain width W = 2 (see probe_v8.cuh), in a source of
// their own so that they compile in parallel with probe_v8.cu's.
#include "probe_v8.cuh"

namespace probe_v8 {

KernelFn kernel_w2(int variant) { return kernel_at<2>(variant); }

}  // namespace probe_v8
