// B4 and B5 in float32 at compiled widths 256 and 512: the instantiations of
// flash_bwd_f32.cuh's 3×TF32 kernels with the head dim split across a
// thread-block cluster (a 128-column slice a CTA: 2 CTAs at 256, 4 at 512),
// with and without the int8 dP product, in a source of their own so that
// nvcc compiles them beside flash_bwd_f32.cu's. The design, the exchange of
// the score products' partial sums and the shared-memory budget are
// described at the top of flash_bwd_f32.cuh.

#include "flash_bwd_f32.cuh"

namespace tf_bwd {

cudaError_t launch_f32_wide_dq(const BwdParams& p, int bh, int d, bool dp,
                               cudaStream_t stream) {
  if (d == 256) return dp ? launch_dq_f32<128, true, 2>(p, bh, stream)
                          : launch_dq_f32<128, false, 2>(p, bh, stream);
  if (d == 512) return dp ? launch_dq_f32<128, true, 4>(p, bh, stream)
                          : launch_dq_f32<128, false, 4>(p, bh, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32_wide_dkv(const BwdParams& p, int bh_kv, int d, bool dp,
                                cudaStream_t stream) {
  if (d == 256) return dp ? launch_dkv_f32<128, true, 2>(p, bh_kv, stream)
                          : launch_dkv_f32<128, false, 2>(p, bh_kv, stream);
  if (d == 512) return dp ? launch_dkv_f32<128, true, 4>(p, bh_kv, stream)
                          : launch_dkv_f32<128, false, 4>(p, bh_kv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tf_bwd
