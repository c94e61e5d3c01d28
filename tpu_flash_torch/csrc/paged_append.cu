// B3: one-token-per-lane paged cache append for Hopper, sm_90a.
//
// Replaces tpu_flash/ops/paged.py:_append_kernel (launched by fused_append)
// and the append half of _paged_kernel's fused append. For each lane: read
// pos = lengths[slot] (lengths are NOT advanced here; the caller adds one
// per lane afterwards, on the same stream), then write row pos % page of
// physical page page_tables[slot, pos / page] for every kv head — the new
// K/V quantized to int8 with a per-token scale, or cast to the page dtype.
//
// Bit-identical to the host quantizer (quant/qarray.py:quantize,
// ops/paged.py:_encode_row): float32 math, scale = max(amax, 1e-12) / 127
// and x / scale as true IEEE divisions, rintf (round half to even), clip to
// ±127. Build without --use_fast_math, which would turn both divisions
// into approximate reciprocals.
//
// What bounds it on an H100: HBM bytes and launch latency — it moves only
// a few KB per call (16 lanes × 8 heads × 128 values), so one launch per
// layer costs what the launch costs. Design: one block per lane, one warp
// per (K or V, kv head) row; a warp holds its row in registers (d/32
// values per lane), reduces amax by shuffles and writes the row with
// consecutive lanes on consecutive bytes; where d is not a multiple of 32
// the last lanes of the last column group hold zeros and write nothing. Idle lanes all sit on the trash
// slot, whose table row is all zeros: they race on the same row of the
// trash page (harmless, nobody reads it) and can never reach a granted
// page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 256;

__device__ float to_f32(float x) { return x; }
__device__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ void store(float* p, float x) { *p = x; }
__device__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename TI, typename TC>
__global__ void __launch_bounds__(NTHREADS)
paged_append_kernel(const TI* __restrict__ k_new, const TI* __restrict__ v_new,
                    TC* __restrict__ k_pages, TC* __restrict__ v_pages,
                    float* __restrict__ k_scales, float* __restrict__ v_scales,
                    const int* __restrict__ slots, const int* __restrict__ lengths,
                    const int* __restrict__ page_tables, int kvh, int d, int page,
                    int total_pages, int max_pages) {
  constexpr bool quantized = sizeof(TC) == 1;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = slots[b];
  const int pos = lengths[slot];
  // clamp like the reference's table gather: a corrupt length must never
  // index past the slot's table row
  const int tpage = min(pos / page, max_pages - 1);
  const int phys = page_tables[(size_t)slot * max_pages + tpage];
  const int off = pos % page;

  for (int task = warp; task < 2 * kvh; task += NWARPS) {
    const bool is_v = task >= kvh;
    const int h = is_v ? task - kvh : task;
    const TI* src = (is_v ? v_new : k_new) + ((size_t)b * kvh + h) * d;
    TC* dst = (is_v ? v_pages : k_pages) +
              (((size_t)h * total_pages + phys) * page + off) * d;
    float x[MAX_D / 32];
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      x[j] = lane + 32 * j < d ? to_f32(src[lane + 32 * j]) : 0.0f;
    if constexpr (quantized) {
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j)
        amax = fmaxf(amax, fabsf(x[j]));  // the tail's zeros add nothing
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float sc = fmaxf(amax, 1e-12f) / 127.0f;
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j) {
        if (lane + 32 * j < d) {
          const float qv = fminf(fmaxf(rintf(x[j] / sc), -127.0f), 127.0f);
          dst[lane + 32 * j] = static_cast<int8_t>(static_cast<int>(qv));
        }
      }
      if (lane == 0)
        (is_v ? v_scales : k_scales)[((size_t)h * total_pages + phys) * page + off] = sc;
    } else {
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j)
        if (lane + 32 * j < d) store(dst + lane + 32 * j, x[j]);
    }
  }
}

template <typename TI, typename TC>
cudaError_t launch(const void* kn, const void* vn, void* kp, void* vp,
                   float* ks, float* vs, const int* slots, const int* lengths,
                   const int* tables, int b, int kvh, int d, int page, int total,
                   int maxp, cudaStream_t stream) {
  paged_append_kernel<TI, TC><<<b, NTHREADS, 0, stream>>>(
      static_cast<const TI*>(kn), static_cast<const TI*>(vn),
      static_cast<TC*>(kp), static_cast<TC*>(vp), ks, vs, slots, lengths,
      tables, kvh, d, page, total, maxp);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t by_cache(int cache_dtype, const void* kn, const void* vn, void* kp,
                     void* vp, float* ks, float* vs, const int* slots,
                     const int* lengths, const int* tables, int b, int kvh, int d,
                     int page, int total, int maxp, cudaStream_t stream) {
  switch (cache_dtype) {
    case 0:
      return launch<TI, float>(kn, vn, kp, vp, ks, vs, slots, lengths, tables, b,
                               kvh, d, page, total, maxp, stream);
    case 1:
      return launch<TI, __nv_bfloat16>(kn, vn, kp, vp, ks, vs, slots, lengths,
                                       tables, b, kvh, d, page, total, maxp, stream);
    case 2:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TI, int8_t>(kn, vn, kp, vp, ks, vs, slots, lengths, tables, b,
                                kvh, d, page, total, maxp, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// k_new, v_new: (b, kvh, d) of in_dtype (0 float32, 1 bf16); pages:
// (kvh, total, page, d) of cache_dtype (0 float32, 1 bf16, 2 int8);
// scales: (kvh, total, page) float32 for int8, else null; slots (b,),
// lengths (max_seqs,), page_tables (max_seqs, max_pages) int32. d is a
// multiple of 8, at most 256. All contiguous.
extern "C" cudaError_t tf_paged_append(
    const void* k_new, const void* v_new, void* k_pages, void* v_pages,
    float* k_scales, float* v_scales, const int* slots, const int* lengths,
    const int* page_tables, int b, int kvh, int d, int page, int total_pages,
    int max_pages, int in_dtype, int cache_dtype, cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  if (d <= 0 || d % 8 != 0 || d > MAX_D || page < 1 || max_pages < 1)
    return cudaErrorInvalidValue;
  if (in_dtype == 0)
    return by_cache<float>(cache_dtype, k_new, v_new, k_pages, v_pages, k_scales,
                           v_scales, slots, lengths, page_tables, b, kvh, d, page,
                           total_pages, max_pages, stream);
  if (in_dtype == 1)
    return by_cache<__nv_bfloat16>(cache_dtype, k_new, v_new, k_pages, v_pages,
                                   k_scales, v_scales, slots, lengths, page_tables, b,
                                   kvh, d, page, total_pages, max_pages, stream);
  return cudaErrorInvalidValue;
}
