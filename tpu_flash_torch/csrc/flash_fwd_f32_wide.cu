// B1 in float32 at compiled widths 256 and 512: the instantiations of
// flash_fwd_f32.cuh's 3×TF32 kernel with the head dim split across a
// thread-block cluster (a 128-column slice a CTA: 2 CTAs at 256, 4 at 512),
// in a source of their own so that nvcc compiles them beside
// flash_fwd_f32.cu's. The design and the exchange of the score product's
// partial sums are described at the top of flash_fwd_f32.cuh.

#include "flash_fwd_f32.cuh"

namespace tf_fwd {

cudaError_t launch_f32_wide(const F32Params& p, int d, cudaStream_t stream) {
  if (d == 256) return launch_fwd_f32<128, 2>(p, stream);
  if (d == 512) return launch_fwd_f32<128, 4>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tf_fwd
