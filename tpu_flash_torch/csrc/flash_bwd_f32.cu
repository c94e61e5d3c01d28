// B4 and B5 in float32 at compiled widths 64 and 128: the instantiations of
// flash_bwd_f32.cuh's 3×TF32 kernels (one CTA of the whole width), and the
// float32 dispatch that flash_bwd.cu's entry points call, which sends widths
// 256 and 512 to flash_bwd_f32_wide.cu's cluster instantiations. The design
// and the shared-memory budget are described at the top of
// flash_bwd_f32.cuh.

#include "flash_bwd_f32.cuh"

namespace tf_bwd {

cudaError_t launch_f32_dq(const BwdParams& p, int bh, int d, bool dp, cudaStream_t stream) {
  if (d == 64 && !dp) return launch_dq_f32<64, false, 1>(p, bh, stream);
  if (d == 128) return dp ? launch_dq_f32<128, true, 1>(p, bh, stream)
                          : launch_dq_f32<128, false, 1>(p, bh, stream);
  if (d == 256 || d == 512) return launch_f32_wide_dq(p, bh, d, dp, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32_dkv(const BwdParams& p, int bh_kv, int d, bool dp, cudaStream_t stream) {
  if (d == 64 && !dp) return launch_dkv_f32<64, false, 1>(p, bh_kv, stream);
  if (d == 128) return dp ? launch_dkv_f32<128, true, 1>(p, bh_kv, stream)
                          : launch_dkv_f32<128, false, 1>(p, bh_kv, stream);
  if (d == 256 || d == 512) return launch_f32_wide_dkv(p, bh_kv, d, dp, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tf_bwd
