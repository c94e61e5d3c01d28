// B14: matrix products for Hopper, sm_90a.
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
// the matrix read once (16384² bf16: 537 MB, 0.16 ms at 3.35 TB/s).
//
// Four routes; the wrapper (ops/matmul.py:_matmul_route) picks one by shape
// and dtype alone, and this entry point refuses a route the shape does not
// fit:
// - wgmma (bf16, k and n multiples of 8: the 16-byte row pitches a TMA
//   tensor map needs). One CTA of three warpgroups per 128 × 256 output
//   tile. Warpgroup 2 produces: one thread issues TMA loads of 64-deep
//   k-slabs of a (K-major) and b (MN-major, four 64-column panels), 128-byte
//   swizzled, into a 4-stage ring of full/empty mbarriers, and gives its
//   registers to the consumers (setmaxnreg 40 / 232). Warpgroups 0 and 1
//   consume 64 rows each: wgmma m64n256k16 with both operands in shared
//   memory, b read MN-major through the transpose bit (no transpose in
//   shared memory), the float32 accumulators in registers over the whole
//   k, one slab's products kept in flight while the next slab's are issued.
//   TMA zero-fills the ragged m, n and k edges; the epilogue rounds each
//   sum once and stores only real rows and columns. Tiles go in a linear
//   index (no grid-dimension limit), GROUP_M m-tiles side by side along n
//   so that neighbouring CTAs share a's and b's slabs in L2.
// - wmma (other bf16 shapes): 64 × 64 output tiles, 4 warps each owning
//   32 × 32 (2 × 2 WMMA 16×16×16 fragments with float32 accumulators);
//   64 × 32 and 32 × 64 slabs staged in shared memory, 16-byte vector loads
//   where k (for a) or n (for b) is a multiple of 8 and the base is aligned,
//   element loads otherwise.
// - gemv (n == 1, either dtype): bytes-bound. A warp per row of a, 16-byte
//   streaming loads of the row (a scalar head and tail where the row does
//   not start or end on 16 bytes), x staged once per block in shared memory
//   as float32 (in chunks of 8192) and read back as float4 where the row
//   is 16-byte aligned (scalar reads of it, eight lanes to a bank, held the
//   first version at 55% of the byte bound), a float32 sum and a warp
//   reduction, one write per row.
// - fma (float32): exact float32 FMA (no TF32: the reference's float32 dot
//   is full precision). 128 × 128 output tiles of 256 threads, each summing
//   an 8 × 8 register tile over 16-deep k-slabs that cp.async double-buffers
//   (a's slab transposed on the way in, four-byte copies; b's in 16-byte
//   copies where n is a multiple of 4); float4 shared-memory reads.
// k = 0 writes zeros on every route.
// Persistent CTAs, thread block clusters and TMA multicast are later work
// (ROADMAP B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

enum Route { R_WMMA = 0, R_WGMMA = 1, R_GEMV = 2, R_FMA = 3 };
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may use

template <typename O> __device__ O to_out(float x);
template <> __device__ float to_out<float>(float x) { return x; }
template <> __device__ bf16 to_out<bf16>(float x) { return __float2bfloat16_rn(x); }

int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------------ wmma

constexpr int BM = 64, BN = 64;
constexpr int BK16 = 32;  // k-slab of the bf16 kernel
constexpr int LDA = BK16 + 8, LDB = BN + 8, LDC = BN + 4;

template <bool VA, bool VB, typename O>
__global__ void __launch_bounds__(128)
mm_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
        O* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(32) bf16 as[BM * LDA];
  __shared__ __align__(32) bf16 bs[BK16 * LDB];
  __shared__ __align__(32) float cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const bf16 zero = __float2bfloat16_rn(0.0f);
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
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
cudaError_t launch_wmma(const void* a, const void* b, void* out, int m, int n,
                        int k, cudaStream_t stream) {
  const bool va = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid(cdiv(n, BN), cdiv(m, BM));
  auto pa = static_cast<const bf16*>(a);
  auto pb = static_cast<const bf16*>(b);
  auto po = static_cast<O*>(out);
  if (va && vb) mm_bf16<true, true, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  else if (va) mm_bf16<true, false, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  else if (vb) mm_bf16<false, true, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  else mm_bf16<false, false, O><<<grid, 128, 0, stream>>>(pa, pb, po, m, n, k);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- wgmma

// the output tile's width (rows of a CTA: two consumer warpgroups of 64);
// 256 measured faster than 128 at 4096³ and at 4000 × 1000 × 3000 (PERF.md §6)
constexpr int WG_BN = 256;

template <int TBN> struct Wg {
  static constexpr int TBM = 128, TBK = 64;        // tile rows, k-slab depth
  static constexpr int A_BYTES = TBM * TBK * 2;    // one 128-byte panel of a
  static constexpr int B_BYTES = TBK * TBN * 2;    // TBN / 64 panels of b
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ST = 4;                     // ring stages
  static constexpr int SMEM = 1024 + ST * STAGE + 2 * ST * 8;
  static constexpr int GROUP_M = 8;                // m-tiles side by side
  static_assert(SMEM <= SMEM_LIMIT, "above the 227 KB a block may use");
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0,
                "swizzled tiles need 1024-byte bases");
};

template <int TBN, typename O>
__global__ void __launch_bounds__(384, 1)
mm_wgmma(const __grid_constant__ CUtensorMap tmap_a,
         const __grid_constant__ CUtensorMap tmap_b, O* __restrict__ out, int m,
         int n, int k) {
  using C = Wg<TBN>;
  constexpr int ST = C::ST, TBK = C::TBK;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(smem + ST * C::STAGE);
  uint64_t* empty_bar = full_bar + ST;

  // the tile of this CTA: GROUP_M m-tiles side by side, walked along n
  const int tiles_m = (m + C::TBM - 1) / C::TBM, tiles_n = (n + TBN - 1) / TBN;
  const int t = blockIdx.x, per_group = C::GROUP_M * tiles_n;
  const int first_m = (t / per_group) * C::GROUP_M;
  const int gm = min(tiles_m - first_m, C::GROUP_M);
  const int m0 = (first_m + (t % per_group) % gm) * C::TBM;
  const int n0 = ((t % per_group) / gm) * TBN;
  const int steps = (k + TBK - 1) / TBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == 2) {
    // ---------------- producer: one TMA thread ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (wtid == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % ST, ph = (i / ST) & 1;
        mbar_wait(&empty_bar[s], ph ^ 1);
        uint8_t* st = smem + s * C::STAGE;
        mbar_expect_tx(&full_bar[s], C::STAGE);
        tma_load_3d(st, &tmap_a, i * TBK * 2, m0, 0, &full_bar[s]);
        for (int pn = 0; pn < TBN / 64; ++pn)
          tma_load_3d(st + C::A_BYTES + pn * TBK * 128, &tmap_b, (n0 + 64 * pn) * 2,
                      i * TBK, 0, &full_bar[s]);
      }
    }
  } else {
    // ---------------- consumers: 64 rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[TBN / 2];
#pragma unroll
    for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.0f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % ST, ph = (i / ST) & 1;
      mbar_wait(&full_bar[s], ph);
      const uint32_t a_addr = smem_u32(smem + s * C::STAGE) + wg * 64 * 128;
      const uint32_t b_addr = smem_u32(smem + s * C::STAGE + C::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk)
        wgmma_bf16_tb<TBN>(acc, desc<128>(a_addr + 32 * kk),
                           desc_mn(b_addr + kk * 16 * 128, TBK * 128));
      wgmma_commit();
      // this slab's products stay in flight; the previous slab's are done,
      // so its stage goes back to the producer
      wgmma_wait1();
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[(i - 1) % ST]);
      }
    }
    wgmma_wait0();
    reg_fence(acc);

    // epilogue: row ra holds columns 8j + 2·t4 (+1) in acc[4j], acc[4j + 1];
    // row ra + 8 in acc[4j + 2], acc[4j + 3]
    const int ra = m0 + wg * 64 + warp * 16 + lane / 4, t4 = lane % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = ra + 8 * half;
      if (row >= m) continue;
      O* orow = out + (size_t)row * n;
#pragma unroll
      for (int j = 0; j < TBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t4;  // n % 8 == 0: col + 1 < n too
        if (col >= n) continue;
        const float x0 = acc[4 * j + 2 * half], x1 = acc[4 * j + 2 * half + 1];
        if constexpr (sizeof(O) == 4)
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename O>
cudaError_t launch_wgmma(const void* a, const void* b, void* out, int m, int n, int k,
                         cudaStream_t stream) {
  using C = Wg<WG_BN>;
  CUtensorMap ma, mb;
  if (!make_row_map(&ma, a, 2ull * k, m, C::TBM) || !make_row_map(&mb, b, 2ull * n, k, C::TBK))
    return cudaErrorInvalidValue;
  auto kern = mm_wgmma<WG_BN, O>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)cdiv(m, C::TBM) * cdiv(n, WG_BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<(unsigned)tiles, 384, C::SMEM, stream>>>(ma, mb, static_cast<O*>(out), m, n, k);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ gemv

constexpr int GEMV_WARPS = 16;     // rows of a block, one a warp
constexpr int GEMV_CHUNK = 8192;   // x elements staged at a time (float32)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// 16 / sizeof(T) staged x values at xv: two or one float4 reads where xv is
// 16-byte aligned (lanes 32 bytes apart then conflict at most two ways),
// else scalar reads
template <int V, bool AL>
__device__ __forceinline__ void load_x(const float* xv, float (&x)[V]) {
  if constexpr (AL) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(xv)[i];
      x[4 * i] = f.x;
      x[4 * i + 1] = f.y;
      x[4 * i + 2] = f.z;
      x[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = xv[i];
  }
}

// Σ of 16 bytes of a row against 16 / sizeof(T) x values
__device__ __forceinline__ float dot16(uint4 u, const float (&x)[4]) {
  return __uint_as_float(u.x) * x[0] + __uint_as_float(u.y) * x[1] +
         __uint_as_float(u.z) * x[2] + __uint_as_float(u.w) * x[3];
}
__device__ __forceinline__ float dot16(uint4 u, const float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)  // bf16 → float32 exactly: the high half of the word
    s += __uint_as_float(w[i] << 16) * x[2 * i] +
         __uint_as_float(w[i] & 0xffff0000u) * x[2 * i + 1];
  return s;
}

// the 16-byte body of a row segment: nv vectors at pv against x at xh
template <typename T, bool AL>
__device__ __forceinline__ float row_body(const uint4* pv, const float* xh, int nv, int lane) {
  constexpr int V = 16 / sizeof(T);
  float s = 0.0f, x0[V], x1[V], x2[V], x3[V];
  int i = lane;
  for (; i + 96 < nv; i += 128) {  // four 16-byte loads in flight a lane
    const uint4 u0 = __ldcs(pv + i), u1 = __ldcs(pv + i + 32);
    const uint4 u2 = __ldcs(pv + i + 64), u3 = __ldcs(pv + i + 96);
    load_x<V, AL>(xh + V * i, x0);
    load_x<V, AL>(xh + V * (i + 32), x1);
    load_x<V, AL>(xh + V * (i + 64), x2);
    load_x<V, AL>(xh + V * (i + 96), x3);
    s += dot16(u0, x0) + dot16(u1, x1) + dot16(u2, x2) + dot16(u3, x3);
  }
  for (; i < nv; i += 32) {
    load_x<V, AL>(xh + V * i, x0);
    s += dot16(__ldcs(pv + i), x0);
  }
  return s;
}

// this lane's share of row segment p[0, len) · xs[0, len)
template <typename T>
__device__ float row_dot(const T* p, const float* xs, int len, int lane) {
  constexpr int V = 16 / sizeof(T);
  // the scalar head up to the first 16-byte boundary
  const int h = min(len, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)));
  float s = lane < h ? to_f(p[lane]) * xs[lane] : 0.0f;
  const uint4* pv = reinterpret_cast<const uint4*>(p + h);
  const int nv = (len - h) / V;
  s += h == 0 ? row_body<T, true>(pv, xs, nv, lane) : row_body<T, false>(pv, xs + h, nv, lane);
  // the scalar tail (fewer than V elements)
  const int t0 = h + nv * V;
  if (t0 + lane < len) s += to_f(p[t0 + lane]) * xs[t0 + lane];
  return s;
}

template <typename T, typename O>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
mm_gemv(const T* __restrict__ a, const T* __restrict__ x, O* __restrict__ out, int m,
        int k) {
  __shared__ __align__(16) float xs[GEMV_CHUNK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * GEMV_WARPS + warp;
  const T* ar = a + (size_t)min(row, m - 1) * k;
  float s = 0.0f;
  for (int c0 = 0; c0 < k; c0 += GEMV_CHUNK) {
    const int len = min(GEMV_CHUNK, k - c0);
    __syncthreads();  // the previous chunk is used up
    for (int i = threadIdx.x; i < len; i += GEMV_WARPS * 32) xs[i] = to_f(x[c0 + i]);
    __syncthreads();
    if (row < m) s += row_dot<T>(ar + c0, xs, len, lane);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (row < m && lane == 0) out[row] = to_out<O>(s);
}

template <typename T, typename O>
cudaError_t launch_gemv(const void* a, const void* x, void* out, int m, int k,
                        cudaStream_t stream) {
  mm_gemv<T, O><<<cdiv(m, GEMV_WARPS), GEMV_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<O*>(out), m, k);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- fma

constexpr int FM = 128, FN = 128, FK = 16;  // tile and k-slab of the float32 kernel

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <bool VB, typename O>
__global__ void __launch_bounds__(256)
mm_f32(const float* __restrict__ a, const float* __restrict__ b, O* __restrict__ out,
       int m, int n, int k) {
  __shared__ __align__(16) float as[2][FK][FM + 4];  // a's slab transposed: [k][m]
  __shared__ __align__(16) float bs[2][FK][FN + 4];
  const int tiles_n = (n + FN - 1) / FN;
  const int m0 = (blockIdx.x / tiles_n) * FM, n0 = (blockIdx.x % tiles_n) * FN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int steps = (k + FK - 1) / FK;

  // slab i into buffer s; zero-filled past m, n and k
  auto load = [&](int i, int s) {
    const int k0 = i * FK;
#pragma unroll
    for (int u = 0; u < FM * FK / 256; ++u) {
      const int c = tid % FK, r = tid / FK + u * (256 / FK);
      const bool ok = m0 + r < m && k0 + c < k;
      cp_async4(&as[s][c][r], ok ? a + (size_t)(m0 + r) * k + k0 + c : a, ok);
    }
    if (VB) {
#pragma unroll
      for (int u = 0; u < FK * FN / 4 / 256; ++u) {
        const int idx = tid + 256 * u, r = idx / (FN / 4), c = (idx % (FN / 4)) * 4;
        const bool ok = k0 + r < k && n0 + c < n;
        cp_async16(&bs[s][r][c], ok ? b + (size_t)(k0 + r) * n + n0 + c : b, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < FK * FN / 256; ++u) {
        const int idx = tid + 256 * u, r = idx / FN, c = idx % FN;
        const bool ok = k0 + r < k && n0 + c < n;
        cp_async4(&bs[s][r][c], ok ? b + (size_t)(k0 + r) * n + n0 + c : b, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if (steps > 0) load(0, 0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      load(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = i & 1;
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[s][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();  // buffer s is free for slab i + 2
  }
  // rows ty·4 + r (+ 64 for r ≥ 4), columns tx·4 + c (+ 64 for c ≥ 4)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + (r & 4 ? 64 : 0) + ty * 4 + (r & 3);
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + (c & 4 ? 64 : 0) + tx * 4 + (c & 3);
      if (col < n) out[(size_t)row * n + col] = to_out<O>(acc[r][c]);
    }
  }
}

template <typename O>
cudaError_t launch_f32(const void* a, const void* b, void* out, int m, int n, int k,
                       cudaStream_t stream) {
  const long long tiles = (long long)cdiv(m, FM) * cdiv(n, FN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto pa = static_cast<const float*>(a);
  auto pb = static_cast<const float*>(b);
  auto po = static_cast<O*>(out);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0)
    mm_f32<true, O><<<(unsigned)tiles, 256, 0, stream>>>(pa, pb, po, m, n, k);
  else
    mm_f32<false, O><<<(unsigned)tiles, 256, 0, stream>>>(pa, pb, po, m, n, k);
  return cudaGetLastError();
}

template <typename O>
cudaError_t dispatch(const void* a, const void* b, void* out, int m, int n, int k,
                     bool bf16_in, int route, cudaStream_t stream) {
  switch (route) {
    case R_WGMMA: return launch_wgmma<O>(a, b, out, m, n, k, stream);
    case R_WMMA: return launch_wmma<O>(a, b, out, m, n, k, stream);
    case R_FMA: return launch_f32<O>(a, b, out, m, n, k, stream);
    case R_GEMV:
      return bf16_in ? launch_gemv<bf16, O>(a, b, out, m, k, stream)
                     : launch_gemv<float, O>(a, b, out, m, k, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a: (m, k), b: (k, n), out: (m, n), all row-major and contiguous, 16-byte
// aligned bases. in_dtype (a and b) and out_dtype: 0 = float32, 1 =
// bfloat16. route: 0 wmma (bf16), 1 wgmma (bf16, k % 8 == 0 and n % 8 ==
// 0), 2 gemv (n == 1, either dtype), 3 fma (float32); a route the shape or
// dtype does not fit returns cudaErrorInvalidValue. k = 0 writes zeros.
extern "C" cudaError_t tf_matmul(const void* a, const void* b, void* out, int m,
                                 int n, int k, int in_dtype, int out_dtype, int route,
                                 cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return cudaErrorInvalidValue;
  const bool bf16_in = in_dtype == 1;
  const bool fits = route == R_GEMV    ? n == 1
                    : route == R_WGMMA ? bf16_in && k % 8 == 0 && n % 8 == 0
                    : route == R_WMMA  ? bf16_in && cdiv(m, BM) <= 65535
                    : route == R_FMA   ? !bf16_in
                                       : false;
  if (!fits) return cudaErrorInvalidValue;
  if (k == 0) return cudaMemsetAsync(out, 0, (size_t)m * n * (out_dtype ? 2 : 4), stream);
  return out_dtype == 1 ? dispatch<bf16>(a, b, out, m, n, k, bf16_in, route, stream)
                        : dispatch<float>(a, b, out, m, n, k, bf16_in, route, stream);
}
