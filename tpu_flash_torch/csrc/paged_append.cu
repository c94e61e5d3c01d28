// B3: one-token-per-lane paged cache append for Hopper, sm_90a.
//
// Replaces tpu_flash/ops/paged.py:_append_kernel (launched by fused_append)
// and the append half of _paged_kernel's fused append. For each lane: read
// pos = lengths[slot] (lengths are NOT advanced here; the caller adds one
// per lane afterwards, on the same stream), then write row pos % page of
// physical page page_tables[slot, pos / page] for every kv head — the new
// K/V encoded for the page type (paged_page.cuh: cast to float32 or bf16;
// int8, int4 in halves or e4m3 with a per-token scale).
//
// The encode is paged_page.cuh:encode_row, which B2's fused append runs
// too: bit-identical to the host encode (cache/paged_cache.py:encode).
// Build without --use_fast_math, which would turn its divisions into
// approximate reciprocals.
//
// What bounds it on an H100: HBM bytes and launch latency — it moves only
// a few KB per call (16 lanes × 8 heads × 128 values), so one launch per
// layer costs what the launch costs. Design: one block per lane, one warp
// per (K or V, kv head) row; a warp holds its row in registers (⌈d/32⌉
// values per lane, or for int4 both elements of each byte it writes),
// reduces amax by shuffles and writes the row with consecutive lanes on
// consecutive storage units. Idle lanes all sit on the trash slot, whose
// table row is all zeros: they race on the same row of the trash page
// (harmless, nobody reads it) and can never reach a granted page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_page.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

__device__ float to_f32(float x) { return x; }
__device__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TI, int PT>
__global__ void __launch_bounds__(NTHREADS)
paged_append_kernel(const TI* __restrict__ k_new, const TI* __restrict__ v_new,
                    void* __restrict__ k_pages, void* __restrict__ v_pages,
                    float* __restrict__ k_scales, float* __restrict__ v_scales,
                    const int* __restrict__ slots, const int* __restrict__ lengths,
                    const int* __restrict__ page_tables, int kvh, int d, int page,
                    int total_pages, int max_pages) {
  using TC = typename Page<PT>::T;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = row_units(PT, d);
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
    const size_t row = ((size_t)h * total_pages + phys) * page + off;
    TC* dst = static_cast<TC*>(is_v ? v_pages : k_pages) + row * units;
    TC u[ROW_J];
    const float sc = encode_row<PT, ROW_J>([&](int c) { return to_f32(src[c]); }, d, lane, u);
#pragma unroll
    for (int j = 0; j < ROW_J; ++j)
      if (lane + 32 * j < units) dst[lane + 32 * j] = u[j];
    if (Page<PT>::QUANT && lane == 0) (is_v ? v_scales : k_scales)[row] = sc;
  }
}

template <typename TI, int PT>
cudaError_t launch(const void* kn, const void* vn, void* kp, void* vp,
                   float* ks, float* vs, const int* slots, const int* lengths,
                   const int* tables, int b, int kvh, int d, int page, int total,
                   int maxp, cudaStream_t stream) {
  if (Page<PT>::QUANT && (ks == nullptr || vs == nullptr)) return cudaErrorInvalidValue;
  paged_append_kernel<TI, PT><<<b, NTHREADS, 0, stream>>>(
      static_cast<const TI*>(kn), static_cast<const TI*>(vn), kp, vp, ks, vs, slots,
      lengths, tables, kvh, d, page, total, maxp);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t by_page(int page_type, const void* kn, const void* vn, void* kp, void* vp,
                    float* ks, float* vs, const int* slots, const int* lengths,
                    const int* tables, int b, int kvh, int d, int page, int total,
                    int maxp, cudaStream_t stream) {
#define TF_APPEND(PT)                                                                   \
  return launch<TI, PT>(kn, vn, kp, vp, ks, vs, slots, lengths, tables, b, kvh, d, page, \
                        total, maxp, stream)
  switch (page_type) {
    case PT_F32: TF_APPEND(PT_F32);
    case PT_BF16: TF_APPEND(PT_BF16);
    case PT_I8: TF_APPEND(PT_I8);
    case PT_I4: TF_APPEND(PT_I4);
    case PT_E4M3: TF_APPEND(PT_E4M3);
  }
#undef TF_APPEND
  return cudaErrorInvalidValue;
}

}  // namespace

// k_new, v_new: (b, kvh, d) of in_dtype (0 float32, 1 bf16); pages:
// (kvh, total, page, row_units) of page_type (paged_page.cuh: 0 float32,
// 1 bf16, 2 int8, 3 int4 in halves of d/2 bytes, 4 e4m3); scales: (kvh,
// total, page) float32 for the quantized types (2-4), else null; slots
// (b,), lengths (max_seqs,), page_tables (max_seqs, max_pages) int32. d is
// 1 to 512 (even for int4 pages). All contiguous.
extern "C" cudaError_t tf_paged_append(
    const void* k_new, const void* v_new, void* k_pages, void* v_pages,
    float* k_scales, float* v_scales, const int* slots, const int* lengths,
    const int* page_tables, int b, int kvh, int d, int page, int total_pages,
    int max_pages, int in_dtype, int page_type, cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  if (d <= 0 || d > ROW_MAX_D || (page_type == PT_I4 && d % 2 != 0) || page < 1 ||
      max_pages < 1 || !page_type_ok(page_type))
    return cudaErrorInvalidValue;
  if (in_dtype == 0)
    return by_page<float>(page_type, k_new, v_new, k_pages, v_pages, k_scales, v_scales,
                          slots, lengths, page_tables, b, kvh, d, page, total_pages,
                          max_pages, stream);
  if (in_dtype == 1)
    return by_page<__nv_bfloat16>(page_type, k_new, v_new, k_pages, v_pages, k_scales,
                                  v_scales, slots, lengths, page_tables, b, kvh, d, page,
                                  total_pages, max_pages, stream);
  return cudaErrorInvalidValue;
}
