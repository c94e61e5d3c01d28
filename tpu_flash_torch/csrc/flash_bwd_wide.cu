// B4 and B5 in bf16 at width 512 (head dims 257 to 512): the instantiations
// of flash_bwd_tc.cuh's TMA + wgmma kernels for that width, with and without
// the int8 dP product, in a source of their own so that nvcc compiles them
// beside flash_bwd.cu's (float32 at 512: flash_bwd_f32_wide.cu). The entry
// points, tf_flash_bwd_dq and tf_flash_bwd_dkv in flash_bwd.cu, check the
// arguments and call these for bf16 at d 512; the design (B4's dQ halves
// split between a CTA's consumers, B5's dK/dV halves on the grid, the score
// products over the full width) is described at the top of flash_bwd.cu.

#include "flash_bwd.cuh"
#include "flash_bwd_tc.cuh"

cudaError_t tf_bwd::launch_wide_dq(const BwdParams& p, int bh, int dtype, bool dp,
                                   cudaStream_t stream) {
  if (dtype == 1)
    return dp ? launch_dq_wide<512, true>(p, bh, stream)
              : launch_dq_wide<512, false>(p, bh, stream);
  return cudaErrorInvalidValue;
}

cudaError_t tf_bwd::launch_wide_dkv(const BwdParams& p, int bh_kv, int dtype, bool dp,
                                    cudaStream_t stream) {
  if (dtype == 1)
    return dp ? launch_dkv_wide<512, true>(p, bh_kv, stream)
              : launch_dkv_wide<512, false>(p, bh_kv, stream);
  return cudaErrorInvalidValue;
}
