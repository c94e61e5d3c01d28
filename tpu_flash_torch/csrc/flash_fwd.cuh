// B1's float32 parameters and the declarations that flash_fwd.cu's entry
// point calls across: flash_fwd_f32.cu (widths 64 and 128) and
// flash_fwd_f32_wide.cu (widths 256 and 512), which compile beside it and
// instantiate flash_fwd_f32.cuh's 3×TF32 kernels.

#pragma once

#include <cuda_runtime.h>

namespace tf_fwd {

// What the float32 kernels take: the entry point's operands (q prescaled,
// k and v halo-extended under the circulant, all at the compiled width d),
// outputs, the norm bound's key norms (null: the exact max), the schedule
// (schedule.cuh's Sched, field by field), the GQA heads, the caller's
// value dim and the TF32 passes.
struct F32Params {
  const float* q;     // (bh, n_q, d)
  const float* k;     // (bh / hq · hkv, n_kv, d)
  const float* v;
  float* o;           // (bh, n_q, d)
  float* lse;         // (bh, n_q) or null
  const float* kmax;  // (bh / hq · hkv) or null
  int bh, n_q, n_kv, kind, offset, radius, section;
  int hq, hkv;
  int dv;           // the caller's value dim: a CTA whose columns lie past it
                    // loads no V and writes no O
  int tf32_passes;  // 3 (3×TF32), or 1 (one TF32 pass: the checks' planted
                    // fault)
};

// widths 64 and 128, in flash_fwd_f32.cu; widths 256 and 512 (a cluster a
// q tile) in flash_fwd_f32_wide.cu
cudaError_t launch_f32(const F32Params& p, int d, cudaStream_t stream);
cudaError_t launch_f32_wide(const F32Params& p, int d, cudaStream_t stream);

}  // namespace tf_fwd
