// The P-v8 kernels of no_slab, no_reduce, no_sort and no_scalar (see
// probe_v8.cuh), in a source of their own so that they compile in parallel
// with probe_v8.cu's.
#include "probe_v8.cuh"

namespace probe_v8 {

KernelFn part2_kernel(int variant) {
  switch (variant) {
    case NO_SLAB: return probe_v8_kernel<NO_SLAB>;
    case NO_REDUCE: return probe_v8_kernel<NO_REDUCE>;
    case NO_SORT: return probe_v8_kernel<NO_SORT>;
    case NO_SCALAR: return probe_v8_kernel<NO_SCALAR>;
    default: return nullptr;
  }
}

}  // namespace probe_v8
