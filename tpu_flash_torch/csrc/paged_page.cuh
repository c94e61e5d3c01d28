// The paged cache's page types, shared by B2 (paged_attention.cu, whose
// split route fuses B3's append) and B3 (paged_append.cu): how a page row
// stores d values, and the one encode of a new row that both kernels run,
// so that they stay bit-identical to each other and to the host encode
// (tpu_flash_torch/cache/paged_cache.py:encode, the reference's
// tpu_flash/ops/paged.py:_encode_row).
//
// Codes are kernels.PAGE_CODES (by CacheConfig.page_type). The kernels take
// the page type as a code and dispatch on it through Page<PT>, never on the
// storage's byte width: int8, int4 and e4m3 rows are all bytes.
//
//   0 float32, 1 bf16: the values, d a row, unscaled;
//   2 int8: codes in [-127, 127], d bytes a row, a float32 scale a row;
//   3 int4: codes in [-8, 7] packed in halves, d/2 bytes a row: byte j
//     holds element j in its low nibble and element j + d/2 in its high
//     nibble; a float32 scale a row;
//   4 e4m3 (float8_e4m3fn): d bytes a row, a float32 scale a row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

enum PageType { PT_F32 = 0, PT_BF16 = 1, PT_I8 = 2, PT_I4 = 3, PT_E4M3 = 4 };

template <int PT>
struct Page;
template <>
struct Page<PT_F32> {
  using T = float;
  static constexpr bool QUANT = false;
};
template <>
struct Page<PT_BF16> {
  using T = __nv_bfloat16;
  static constexpr bool QUANT = false;
};
template <>
struct Page<PT_I8> {
  using T = int8_t;
  static constexpr bool QUANT = true;
  static constexpr float QMAX = 127.0f;
};
template <>
struct Page<PT_I4> {
  using T = uint8_t;
  static constexpr bool QUANT = true;
  static constexpr float QMAX = 7.0f;
};
template <>
struct Page<PT_E4M3> {
  using T = __nv_fp8_storage_t;
  static constexpr bool QUANT = true;
  static constexpr float QMAX = 448.0f;
};

__host__ __device__ inline bool page_type_ok(int pt) { return pt >= PT_F32 && pt <= PT_E4M3; }
__host__ __device__ inline bool page_quantized(int pt) { return pt >= PT_I8; }
// storage units of a row (elements, or int4's bytes) and its bytes
__host__ __device__ inline int row_units(int pt, int d) { return pt == PT_I4 ? d / 2 : d; }
__host__ __device__ inline int row_bytes(int pt, int d) {
  return pt == PT_F32 ? 4 * d : pt == PT_BF16 ? 2 * d : row_units(pt, d);
}

constexpr int ROW_MAX_D = 256;
constexpr int ROW_J = ROW_MAX_D / 32;  // storage units a lane holds

__device__ __forceinline__ float warp_allmax(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One warp encodes one new row of d <= 256 values (x(c), c < d, reads
// element c as a float): lane l ends holding storage units l + 32 j of the
// row (j < ROW_J; units past row_units(PT, d) are 0 and are not to be
// written) and returns the row's scale (1 for unscaled pages). Float32
// math as the host's: scale = max(amax, 1e-12) / qmax and x / scale as IEEE
// divides (never --use_fast_math); int8 and int4 round half to even
// (rintf) and clip to [-127, 127] and [-8, 7]; e4m3 rounds to nearest even
// with saturation, which the host's .to(float8_e4m3fn) equals at |x / scale|
// <= 448. An all-zero row gives the scale 1e-12 / qmax and codes 0. For
// int4 a lane loads both elements of each byte it writes (j and j + d/2),
// so the halves packing needs no exchange between lanes.
template <int PT, typename X>
__device__ __forceinline__ float encode_row(X x, int d, int lane,
                                            typename Page<PT>::T (&u)[ROW_J]) {
  using T = typename Page<PT>::T;
  if constexpr (PT == PT_I4) {
    const int h = d / 2;
    float lo[ROW_J / 2], hi[ROW_J / 2];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < ROW_J / 2; ++j) {
      const int c = lane + 32 * j;
      lo[j] = c < h ? x(c) : 0.0f;
      hi[j] = c < h ? x(c + h) : 0.0f;
      amax = fmaxf(amax, fmaxf(fabsf(lo[j]), fabsf(hi[j])));
    }
    const float sc = __fdiv_rn(fmaxf(warp_allmax(amax), 1e-12f), Page<PT>::QMAX);
#pragma unroll
    for (int j = 0; j < ROW_J / 2; ++j) {
      const int a = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(lo[j], sc)), -8.0f), 7.0f));
      const int b = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(hi[j], sc)), -8.0f), 7.0f));
      u[j] = static_cast<T>((a & 0xF) | ((b & 0xF) << 4));
      u[j + ROW_J / 2] = 0;
    }
    return sc;
  } else {
    float v[ROW_J];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < ROW_J; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < d ? x(c) : 0.0f;
      amax = fmaxf(amax, fabsf(v[j]));
    }
    if constexpr (!Page<PT>::QUANT) {
#pragma unroll
      for (int j = 0; j < ROW_J; ++j) {
        if constexpr (PT == PT_BF16) u[j] = __float2bfloat16_rn(v[j]);
        else u[j] = v[j];
      }
      return 1.0f;
    } else {
      const float sc = __fdiv_rn(fmaxf(warp_allmax(amax), 1e-12f), Page<PT>::QMAX);
#pragma unroll
      for (int j = 0; j < ROW_J; ++j) {
        const float y = __fdiv_rn(v[j], sc);
        if constexpr (PT == PT_I8)
          u[j] = static_cast<T>(static_cast<int>(fminf(fmaxf(rintf(y), -127.0f), 127.0f)));
        else
          u[j] = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
      }
      return sc;
    }
  }
}
