// The P-v8 kernels of chain width W = 4 (see probe_v8.cuh), in a source of
// their own so that they compile in parallel with probe_v8.cu's.
#include "probe_v8.cuh"

namespace probe_v8 {

KernelFn kernel_w4(int variant) { return kernel_at<4>(variant); }

}  // namespace probe_v8
