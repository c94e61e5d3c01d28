// B13a–f: fused softmax for Hopper, sm_90a.
//
// Replaces the six kernels behind tpu_flash/ops/softmax.py:fused_softmax:
//   tf_softmax_onepass  ← _row_onepass_kernel (:59) and _col_onepass_kernel
//                         (:158): max, exp, sum and divide with the fiber
//                         resident in shared memory, o = p / Σp;
//   tf_softmax_stats    ← _row_stats_kernel (:66) and _col_stats_kernel
//                         (:165): the online (m, l) merge over chunks of the
//                         fiber → lse = m + log(l), float32;
//   tf_softmax_norm     ← _row_norm_kernel (:87) and _col_norm_kernel (:186):
//                         o = exp(x − lse).
// One kernel serves rows and columns: x is viewed as (L, n, m) and a fiber
// f = l·m + j runs along n with element stride m, so element i of fiber f
// sits at (f / m)·n·m + i·m + f % m. Rows are m = 1 (the reference's row
// kernels); m > 1 is the softmax over axis −2 with no transpose (its column
// kernels). Input and output are float32 or bfloat16; the math is float32
// with expf/logf (no fast math).
//
// Ragged fibers are masked here, where the TPU padded them with −1e30
// (_NEG_BIG): a masked element adds nothing to l, and m starts at −1e30 as
// the reference's does, so the sums equal the reference's.
//
// What bounds it on an H100: bytes. A one-pass call reads x once and writes
// o once (8 B an f32 element); a two-pass call reads x twice (stats, norm)
// and writes o once, a handful of flops an element against ~295 FLOP/B of
// ridge. Design for that:
// - rows (m = 1): one block of 256 threads per fiber, threads striding the
//   fiber, so a warp reads 32 neighbouring elements; the one-pass block
//   keeps its fiber in shared memory (the reference's "fiber resident"),
//   the stats block merges 8-element register chunks (one exp per element
//   plus one per chunk) and then its threads' (m, l) pairs;
// - columns (m > 1): one block of 32 × 8 threads per 32 neighbouring fibers
//   of a slab; threadIdx.x picks the fiber, so a warp row reads 32
//   neighbouring addresses (a thread-per-fiber walk down a row-major array
//   would be a strided read), and the 8 thread rows split the fiber length
//   and merge through shared memory;
// - norm: a grid-stride elementwise pass over the whole array.
// The one-pass path is taken while the resident fibers fit in 64 KiB of
// shared memory (rows n ≤ 16384, columns n ≤ 512; the wrapper decides);
// longer fibers take stats + norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_FIBERS = 32;  // fibers per column block (threadIdx.x)
constexpr int COL_ROWS = 8;     // thread rows splitting a column fiber
constexpr int CHUNK = 8;        // register chunk of the row stats merge
constexpr int ONEPASS_SMEM = 64 * 1024;
constexpr float NEG_BIG = -1e30f;  // the reference's initial running max

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static __device__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
  static __device__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
};
template <> struct Ty<float> {
  static __device__ float t(float x) { return x; }
  static __device__ float f(float x) { return x; }
};

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max (or sum) over a 1-D block; every thread gets the result
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free from any earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x / 32) ? red[lane] : (MAX ? -INFINITY : 0.0f);
  return MAX ? warp_max(v) : warp_sum(v);
}

// max (or sum) over the COL_ROWS thread rows of a column block, per fiber
template <bool MAX>
__device__ float col_reduce(float v, float* red) {
  __syncthreads();
  red[threadIdx.y * COL_FIBERS + threadIdx.x] = v;
  __syncthreads();
  float r = red[threadIdx.x];
  for (int y = 1; y < COL_ROWS; ++y) {
    const float u = red[y * COL_FIBERS + threadIdx.x];
    r = MAX ? fmaxf(r, u) : r + u;
  }
  return r;
}

// ----------------------------------------------------------------- one-pass

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
onepass_rows(const T* __restrict__ x, T* __restrict__ out, int n) {
  extern __shared__ float buf[];  // the fiber, n floats
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * n;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) {
    const float v = Ty<T>::f(x[base + i]);
    buf[i] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += ROW_THREADS) {  // this thread's own i
    const float p = expf(buf[i] - mx);
    buf[i] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);
  for (int i = threadIdx.x; i < n; i += ROW_THREADS)
    out[base + i] = Ty<T>::t(buf[i] / sum);
}

template <typename T>
__global__ void __launch_bounds__(COL_FIBERS * COL_ROWS)
onepass_cols(const T* __restrict__ x, T* __restrict__ out, int n, int m,
             int groups) {
  extern __shared__ float buf[];  // n × COL_FIBERS floats
  __shared__ float red[COL_ROWS * COL_FIBERS];
  const int slab = blockIdx.x / groups;
  const int j = (blockIdx.x % groups) * COL_FIBERS + threadIdx.x;
  const bool live = j < m;
  const size_t base = (size_t)slab * n * m + j;
  float mx = -INFINITY;
  for (int i = threadIdx.y; i < n; i += COL_ROWS) {
    const float v = live ? Ty<T>::f(x[base + (size_t)i * m]) : 0.0f;
    buf[i * COL_FIBERS + threadIdx.x] = v;
    mx = fmaxf(mx, v);
  }
  mx = col_reduce<true>(mx, red);
  float sum = 0.0f;
  for (int i = threadIdx.y; i < n; i += COL_ROWS) {
    const float p = expf(buf[i * COL_FIBERS + threadIdx.x] - mx);
    buf[i * COL_FIBERS + threadIdx.x] = p;
    sum += p;
  }
  sum = col_reduce<false>(sum, red);
  if (!live) return;
  for (int i = threadIdx.y; i < n; i += COL_ROWS)
    out[base + (size_t)i * m] = Ty<T>::t(buf[i * COL_FIBERS + threadIdx.x] / sum);
}

// -------------------------------------------------------------------- stats

// (m, l) of several partial fibers merged: m = max, l = Σ l_k·exp(m_k − m)
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
stats_rows(const T* __restrict__ x, float* __restrict__ lse, int n) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * n;
  float m = NEG_BIG, l = 0.0f;
  for (int i0 = threadIdx.x; i0 < n; i0 += ROW_THREADS * CHUNK) {
    float v[CHUNK];
    float cm = NEG_BIG;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int i = i0 + c * ROW_THREADS;
      v[c] = i < n ? Ty<T>::f(x[base + i]) : NEG_BIG;
      cm = fmaxf(cm, v[c]);
    }
    const float m_new = fmaxf(m, cm);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
      if (i0 + c * ROW_THREADS < n) s += expf(v[c] - m_new);
    l = l * expf(m - m_new) + s;
    m = m_new;
  }
  const float mx = block_reduce<true>(m, red);
  const float sum = block_reduce<false>(l * expf(m - mx), red);
  if (threadIdx.x == 0) lse[blockIdx.x] = mx + logf(sum);
}

template <typename T>
__global__ void __launch_bounds__(COL_FIBERS * COL_ROWS)
stats_cols(const T* __restrict__ x, float* __restrict__ lse, int n, int m_,
           int groups) {
  __shared__ float red[COL_ROWS * COL_FIBERS];
  const int slab = blockIdx.x / groups;
  const int j = (blockIdx.x % groups) * COL_FIBERS + threadIdx.x;
  const bool live = j < m_;
  const size_t base = (size_t)slab * n * m_ + j;
  float m = NEG_BIG, l = 0.0f;
  if (live) {
    for (int i0 = threadIdx.y; i0 < n; i0 += COL_ROWS * 4) {
      float v[4];
      float cm = NEG_BIG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + c * COL_ROWS;
        v[c] = i < n ? Ty<T>::f(x[base + (size_t)i * m_]) : NEG_BIG;
        cm = fmaxf(cm, v[c]);
      }
      const float m_new = fmaxf(m, cm);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i0 + c * COL_ROWS < n) s += expf(v[c] - m_new);
      l = l * expf(m - m_new) + s;
      m = m_new;
    }
  }
  const float mx = col_reduce<true>(m, red);
  const float sum = col_reduce<false>(l * expf(m - mx), red);
  if (live && threadIdx.y == 0) lse[(size_t)slab * m_ + j] = mx + logf(sum);
}

// --------------------------------------------------------------------- norm

template <typename T>
__global__ void norm_kernel(const T* __restrict__ x, const float* __restrict__ lse,
                            T* __restrict__ out, size_t total, size_t nm, int m) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const size_t fiber = m == 1 ? e / nm : (e / nm) * m + e % m;
    out[e] = Ty<T>::t(expf(Ty<T>::f(x[e]) - lse[fiber]));
  }
}

int norm_blocks(size_t total) {
  const size_t want = (total + 255) / 256;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

template <typename T>
cudaError_t onepass(const void* x, void* out, int n, int fibers, int m,
                    cudaStream_t stream) {
  if (m == 1) {
    const size_t smem = sizeof(float) * n;
    if (smem > ONEPASS_SMEM) return cudaErrorInvalidValue;
    auto kern = onepass_rows<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ONEPASS_SMEM);
    if (err != cudaSuccess) return err;
    kern<<<fibers, ROW_THREADS, smem, stream>>>(static_cast<const T*>(x),
                                                 static_cast<T*>(out), n);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * n * COL_FIBERS;
  if (smem > ONEPASS_SMEM) return cudaErrorInvalidValue;
  auto kern = onepass_cols<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ONEPASS_SMEM);
  if (err != cudaSuccess) return err;
  const int groups = (m + COL_FIBERS - 1) / COL_FIBERS;
  kern<<<(fibers / m) * groups, dim3(COL_FIBERS, COL_ROWS), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, m, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats(const void* x, float* lse, int n, int fibers, int m,
                  cudaStream_t stream) {
  if (m == 1) {
    stats_rows<T><<<fibers, ROW_THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                      lse, n);
  } else {
    const int groups = (m + COL_FIBERS - 1) / COL_FIBERS;
    stats_cols<T><<<(fibers / m) * groups, dim3(COL_FIBERS, COL_ROWS), 0,
                    stream>>>(static_cast<const T*>(x), lse, n, m, groups);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t norm(const void* x, const float* lse, void* out, int n, int fibers,
                 int m, cudaStream_t stream) {
  const size_t total = (size_t)fibers * n;
  norm_kernel<T><<<norm_blocks(total), 256, 0, stream>>>(
      static_cast<const T*>(x), lse, static_cast<T*>(out), total,
      (size_t)n * m, m);
  return cudaGetLastError();
}

bool bad(int n, int fibers, int m) {
  return n <= 0 || fibers <= 0 || m <= 0 || fibers % m != 0;
}

}  // namespace

// x, out: (fibers / m, n, m) contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); lse: (fibers,) float32, fiber f = l·m + j. m = 1 for rows.
extern "C" cudaError_t tf_softmax_onepass(const void* x, void* out, int n,
                                          int fibers, int m, int dtype,
                                          cudaStream_t stream) {
  if (bad(n, fibers, m)) return cudaErrorInvalidValue;
  if (dtype == 0) return onepass<float>(x, out, n, fibers, m, stream);
  if (dtype == 1) return onepass<__nv_bfloat16>(x, out, n, fibers, m, stream);
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t tf_softmax_stats(const void* x, float* lse, int n,
                                        int fibers, int m, int dtype,
                                        cudaStream_t stream) {
  if (bad(n, fibers, m)) return cudaErrorInvalidValue;
  if (dtype == 0) return stats<float>(x, lse, n, fibers, m, stream);
  if (dtype == 1) return stats<__nv_bfloat16>(x, lse, n, fibers, m, stream);
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t tf_softmax_norm(const void* x, const float* lse,
                                       void* out, int n, int fibers, int m,
                                       int dtype, cudaStream_t stream) {
  if (bad(n, fibers, m)) return cudaErrorInvalidValue;
  if (dtype == 0) return norm<float>(x, lse, out, n, fibers, m, stream);
  if (dtype == 1) return norm<__nv_bfloat16>(x, lse, out, n, fibers, m, stream);
  return cudaErrorInvalidValue;
}
