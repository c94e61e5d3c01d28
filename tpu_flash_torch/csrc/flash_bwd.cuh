// B4/B5's parameters and the declarations that the sources sharing them
// call across: flash_bwd.cu (the entry points, the bf16 TMA + wgmma kernels
// of widths 64 and 128, and the bf16 instantiation at width 256),
// flash_bwd_wide.cu (the bf16 width-512 instantiations), flash_bwd_f32.cu and
// flash_bwd_f32_wide.cu (float32 on 3×TF32 wgmma, widths 64/128 and
// 256/512), which compile side by side. The bf16 kernels of widths 256 and
// 512 are in flash_bwd_tc.cuh, the float32 ones in flash_bwd_f32.cuh. The
// design is described at the top of flash_bwd.cu (float32:
// flash_bwd_f32.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "schedule.cuh"

namespace tf_bwd {

// What both families take: operands, the dp operands (null without dp),
// outputs, the schedule (schedule.cuh's Sched, field by field) and the GQA
// heads.
struct BwdParams {
  const void* q;      // (bh, n_q, HD), prescaled
  const void* k;      // (bh_kv, n_kv, HD)
  const void* v;
  const void* dout;   // (bh, n_q, HD)
  const void* v8;     // dp: V̂ (bh_kv, n_kv, HD) int8
  const void* do8;    // dp: dÔ (bh, n_q, HD) int8
  const void* qs;     // dp: q·σdo (bh, n_q, HD)
  const float* sdo;   // dp: σdo (bh, n_q)
  const float* lse2;  // (bh, n_q)
  const float* delta; // (bh, n_q), divided by σdo under dp
  void* dq;
  void* dk;
  void* dv;
  int n_q, n_kv, kind, offset, radius, section;
  int hq, hkv;
  int dv_cols;  // B5: the caller's value dim; a half (a slice) past it takes no dV
  int tf32_passes;  // float32: 3 (3×TF32), or 1 (one TF32 pass: the chip
                    // check's planted fault)
};

// B4 and B5 at width 512 in bf16 (dtype 1; no other), in flash_bwd_wide.cu
cudaError_t launch_wide_dq(const BwdParams& p, int bh, int dtype, bool dp,
                           cudaStream_t stream);
cudaError_t launch_wide_dkv(const BwdParams& p, int bh_kv, int dtype, bool dp,
                            cudaStream_t stream);

// B4 and B5 in float32 (3×TF32 on wgmma) at widths 64, 128, 256 and 512, in
// flash_bwd_f32.cu; widths 256 and 512 (a cluster a tile) in
// flash_bwd_f32_wide.cu
cudaError_t launch_f32_dq(const BwdParams& p, int bh, int d, bool dp, cudaStream_t stream);
cudaError_t launch_f32_dkv(const BwdParams& p, int bh_kv, int d, bool dp, cudaStream_t stream);
cudaError_t launch_f32_wide_dq(const BwdParams& p, int bh, int d, bool dp,
                               cudaStream_t stream);
cudaError_t launch_f32_wide_dkv(const BwdParams& p, int bh_kv, int d, bool dp,
                                cudaStream_t stream);

}  // namespace tf_bwd

namespace {

using bf16 = __nv_bfloat16;
using tf_bwd::BwdParams;

constexpr float LN2 = 0.693147180559945309f;

__host__ __device__ __forceinline__ Sched sched_of(const BwdParams& p) {
  return Sched{p.n_q, p.n_kv, p.kind, p.offset, p.radius, p.section};
}

}  // namespace
