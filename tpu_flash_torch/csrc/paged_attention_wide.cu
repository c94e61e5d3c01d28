// B2 at head dims 257 to 512: the instantiations of paged_attention.cuh's
// kernels for those widths (the split route with two 8-column chunks a
// lane, the shared route at width 512), in a source of their own so that
// nvcc compiles them beside paged_attention.cu's. The entry point,
// tf_paged_attention in paged_attention.cu, checks the arguments and calls
// launch_wide for d > 256.

#include "paged_attention.cuh"

cudaError_t tf_paged::launch_wide(int page_type, int out_dtype, int route, const Args& a,
                                  cudaStream_t stream) {
  return by_out<true>(out_dtype, page_type, route, a, stream);
}
