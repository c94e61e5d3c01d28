// B1 in float32 at compiled widths 64 and 128: the instantiations of
// flash_fwd_f32.cuh's 3×TF32 kernel (one CTA of the whole width), and the
// float32 dispatch that flash_fwd.cu's entry point calls, which sends
// widths 256 and 512 to flash_fwd_f32_wide.cu's cluster instantiations. The
// design and the shared-memory budget are described at the top of
// flash_fwd_f32.cuh.

#include "flash_fwd_f32.cuh"

namespace tf_fwd {

cudaError_t launch_f32(const F32Params& p, int d, cudaStream_t stream) {
  if (d == 64) return launch_fwd_f32<64, 1>(p, stream);
  if (d == 128) return launch_fwd_f32<128, 1>(p, stream);
  if (d == 256 || d == 512) return launch_f32_wide(p, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tf_fwd
