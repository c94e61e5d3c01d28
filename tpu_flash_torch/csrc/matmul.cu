// B14: tiled matrix product for Hopper, sm_90a.
//
// Replaces tpu_flash/ops/matmul.py:_mm_kernel (launched by matmul at :85):
// out = a @ b for row-major a (m, k) and b (k, n), the sum kept in float32
// and rounded once to the output type (float32 or bfloat16). The TPU grid's
// sequential k axis (a VMEM accumulator carried from step to step) becomes a
// loop over k-slabs inside one block per output tile.
//
// What bounds it on an H100: at 4096³ bf16 the 137 GFLOP of tensor-core work
// (0.139 ms at 989 TFLOP/s) against 100 MB of traffic; float32 runs on the
// FMA units (67 TFLOP/s: 2.05 ms); a one-column product (matvec) is bytes,
// the matrix read once. Design, simple first:
// - bfloat16: 64 × 64 output tiles, 4 warps each owning 32 × 32 (2 × 2 WMMA
//   16×16×16 fragments with float32 accumulators, as B1 does); 64 × 32 and
//   32 × 64 slabs of a and b staged in shared memory, 16-byte vector loads
//   where k (for a) or n (for b) is a multiple of 8 and the base is aligned,
//   element loads otherwise;
// - float32: 64 × 64 tiles, 256 threads each owning a 4 × 4 register tile of
//   FMA sums over 16-deep slabs (no TF32: the reference's float32 dot is
//   exact float32);
// - ragged m, n and k edges are zero-filled in shared memory, so the host
//   pads nothing; the epilogue writes only the real rows and columns.
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64;
constexpr int BK16 = 32;  // k-slab of the bf16 kernel
constexpr int BK32 = 16;  // k-slab of the f32 kernel
constexpr int LDA = BK16 + 8, LDB = BN + 8, LDC = BN + 4;

template <typename O> __device__ O to_out(float x);
template <> __device__ float to_out<float>(float x) { return x; }
template <> __device__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <bool VA, bool VB, typename O>
__global__ void __launch_bounds__(128)
mm_bf16(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
        O* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(32) __nv_bfloat16 as[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 bs[BK16 * LDB];
  __shared__ __align__(32) float cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < k; k0 += BK16) {
    __syncthreads();  // the previous slab's fragments are loaded
    if (VA) {
      for (int idx = threadIdx.x; idx < BM * BK16 / 8; idx += 128) {
        const int r = idx / (BK16 / 8), c = (idx % (BK16 / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (m0 + r < m && k0 + c < k)
          val = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * k + k0 + c);
        *reinterpret_cast<uint4*>(as + r * LDA + c) = val;
      }
    } else {
      for (int idx = threadIdx.x; idx < BM * BK16; idx += 128) {
        const int r = idx / BK16, c = idx % BK16;
        as[r * LDA + c] = (m0 + r < m && k0 + c < k)
                              ? a[(size_t)(m0 + r) * k + k0 + c] : zero;
      }
    }
    if (VB) {
      for (int idx = threadIdx.x; idx < BK16 * BN / 8; idx += 128) {
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k0 + r < k && n0 + c < n)
          val = *reinterpret_cast<const uint4*>(b + (size_t)(k0 + r) * n + n0 + c);
        *reinterpret_cast<uint4*>(bs + r * LDB + c) = val;
      }
    } else {
      for (int idx = threadIdx.x; idx < BK16 * BN; idx += 128) {
        const int r = idx / BN, c = idx % BN;
        bs[r * LDB + c] = (k0 + r < k && n0 + c < n)
                              ? b[(size_t)(k0 + r) * n + n0 + c] : zero;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * LDA + kk, LDA);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += 128) {
    const int r = idx / BN, c = idx % BN;
    if (m0 + r < m && n0 + c < n)
      out[(size_t)(m0 + r) * n + n0 + c] = to_out<O>(cs[r * LDC + c]);
  }
}

template <typename O>
__global__ void __launch_bounds__(256)
mm_f32(const float* __restrict__ a, const float* __restrict__ b,
       O* __restrict__ out, int m, int n, int k) {
  __shared__ float as[BK32][BM + 4];  // a's slab, transposed: as[k][m]
  __shared__ float bs[BK32][BN + 4];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BK32; idx += 256) {
      const int r = idx / BK32, c = idx % BK32;
      as[c][r] = (m0 + r < m && k0 + c < k) ? a[(size_t)(m0 + r) * k + k0 + c] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < BK32 * BN; idx += 256) {
      const int r = idx / BN, c = idx % BN;
      bs[r][c] = (k0 + r < k && n0 + c < n) ? b[(size_t)(k0 + r) * n + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= m) break;
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < n) out[(size_t)r * n + c] = to_out<O>(acc[i][j]);
    }
  }
}

template <typename O>
cudaError_t launch_bf16(const void* a, const void* b, void* out, int m, int n,
                        int k, cudaStream_t stream) {
  const bool va = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  auto pa = static_cast<const __nv_bfloat16*>(a);
  auto pb = static_cast<const __nv_bfloat16*>(b);
  auto po = static_cast<O*>(out);
  if (va && vb) mm_bf16<true, true, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  else if (va) mm_bf16<true, false, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  else if (vb) mm_bf16<false, true, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  else mm_bf16<false, false, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_f32(const void* a, const void* b, void* out, int m, int n,
                       int k, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_f32<O><<<grid, 256, 0, stream>>>(static_cast<const float*>(a),
                                      static_cast<const float*>(b),
                                      static_cast<O*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// a: (m, k), b: (k, n), out: (m, n), all row-major and contiguous. in_dtype
// (a and b) and out_dtype: 0 = float32, 1 = bfloat16. k = 0 writes zeros.
extern "C" cudaError_t tf_matmul(const void* a, const void* b, void* out, int m,
                                 int n, int k, int in_dtype, int out_dtype,
                                 cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0 || (m + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  if (in_dtype == 1 && out_dtype == 1)
    return launch_bf16<__nv_bfloat16>(a, b, out, m, n, k, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_bf16<float>(a, b, out, m, n, k, stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_f32<float>(a, b, out, m, n, k, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_f32<__nv_bfloat16>(a, b, out, m, n, k, stream);
  return cudaErrorInvalidValue;
}
