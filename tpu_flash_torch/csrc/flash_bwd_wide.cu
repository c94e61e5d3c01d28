// B4 and B5 at width 512 (head dims 257 to 512): the instantiations of
// flash_bwd.cuh's WMMA (bf16) and FMA (float32) kernels for that width,
// with and without the int8 dP product, in a source of their own so that
// nvcc compiles them beside flash_bwd.cu's. The entry points,
// tf_flash_bwd_dq and tf_flash_bwd_dkv in flash_bwd.cu, check the
// arguments and call these for d 512; the design (the output's 256-column
// halves on the grid) is described at the top of flash_bwd.cu.

#include "flash_bwd.cuh"

cudaError_t tf_bwd::launch_wide_dq(const BwdParams& p, int bh, int dtype, bool dp,
                                   cudaStream_t stream) {
  if (dtype == 1)
    return dp ? launch_dq<bf16, 512, true>(p, bh, stream)
              : launch_dq<bf16, 512, false>(p, bh, stream);
  if (dtype == 0)
    return dp ? launch_dq<float, 512, true>(p, bh, stream)
              : launch_dq<float, 512, false>(p, bh, stream);
  return cudaErrorInvalidValue;
}

cudaError_t tf_bwd::launch_wide_dkv(const BwdParams& p, int bh_kv, int dtype, bool dp,
                                    cudaStream_t stream) {
  if (dtype == 1)
    return dp ? launch_dkv<bf16, 512, true>(p, bh_kv, stream)
              : launch_dkv<bf16, 512, false>(p, bh_kv, stream);
  if (dtype == 0)
    return dp ? launch_dkv<float, 512, true>(p, bh_kv, stream)
              : launch_dkv<float, 512, false>(p, bh_kv, stream);
  return cudaErrorInvalidValue;
}
