// B4 and B5: flash-attention backward for Hopper, sm_90a.
//
// B4 (tf_flash_bwd_dq) replaces tpu_flash/ops/flash_bwd.py:_dq_kernel and,
// at d = 64, its transposed variant _dq_kernel_t (that layout exists only to
// fill the TPU's 128-lane matrix unit). B5 (tf_flash_bwd_dkv) replaces
// _dkv_kernel and _dkv_kernel_t. Both recompute P from the forward's lse
// (FA-2); neither keeps an O(n²) residual.
//
// Numerics mirror the reference: q arrives prescaled by scale·log2(e), so
// s = Q·Kᵀ is in base-2 units; lse2 = lse·log2(e) with lse = ±inf/NaN rows
// clamped to 3e38 first (the wrapper does both, in float32), so
// p = exp2(s − lse2) underflows to 0 on fully masked rows; dp = dO·Vᵀ;
// ds = p∘(dp − Δ) with Δ = rowsum(dO∘O) − dlse (the wrapper computes it).
// dq = Σ ds·K·ln2 with ds cast to K's dtype; dv = Σ pᵀ·dO with p cast to
// dO's dtype; dk = Σ dsᵀ·Q·ln2 with ds cast to Q's dtype. Products
// accumulate in float32. Masked and padded entries (keys past n_kv, queries
// past n_q, the right-aligned causal triangle) get p = 0 by index, never by
// the zero-filled data in shared memory.
//
// What bounds them on an H100: tensor-core FLOPs. At the training shape
// (64 q rows of n = 1024, d = 128, causal) B4 runs 3 products and B5 4
// over the causal half: 25.8 and 34.4 GFLOP against ~50 MB of operands,
// far right of the ~295 FLOP/B ridge.
//
// Design: blocks run in parallel in no order, so every output tile has one
// writer and a loop inside the block takes the place of the TPU's
// sequential grid axis. B4: one block of 4 warps per (64-row q tile,
// batch·q-head row), looping over kv tiles up to the causal limit (the
// forward's visit). B5: one block per (64-row kv tile, batch·kv-head row),
// looping over the g = hq/hkv query heads of its group in a fixed order and,
// for each, over the q tiles from the first that sees the tile's first key
// (CausalSchedule._first_q_block). GQA thus needs no copy of K/V and no
// atomics: the group's dK/dV sum in float32 in the block and round once.
// Each warp owns 16 rows of the block's output end to end; the float32
// accumulators live in shared memory so the row-wise elementwise pass is
// plain indexing. bf16 products run on the tensor cores through WMMA
// 16×16×16 with float32 accumulators; float32 inputs take FMA loops (the
// reference's f32 dots are full precision), and B5 then steps 32 q rows at a
// time so its tiles fit in shared memory. At d 256 the block's own tile is
// 32 rows of 2 warps (B4's q tile, B5's kv tile) and float32 B4 steps 32
// kv rows: 154-213 KB of shared memory (Cfg below; the 64-row tiles would
// need 241-330 KB). Summation order is fixed, so both
// kernels are bitwise deterministic. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float LN2 = 0.693147180559945309f;

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static constexpr int PAD = 8;   // keeps rows 16 B aligned, shifts banks
  static __device__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Ty<float> {
  static constexpr int PAD = 4;
  static __device__ float t(float x) { return x; }
};

// Tiles. B4: BQ q rows per block, BKV kv rows per step; B5: BKV5 kv rows per
// block, BQD q rows per step. A block has one warp per 16 rows of its own
// tile (BQ or BKV5). At d 256 the own tile is 32 rows (2 warps), and
// float32 also steps 32 rows, so that every variant fits in 227 KB.
template <typename T, int HD> struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BQ = HD == 256 ? 32 : 64;
  static constexpr int BKV = (F32 && HD == 256) ? 32 : 64;
  static constexpr int BKV5 = HD == 256 ? 32 : 64;
  static constexpr int BQD = F32 ? 32 : 64;
};

// Shared memory of one block: two (RA × HD) and two (RB × HD) operand
// tiles, two (RA × RB) float32 score tiles, NP (RA × RB) tiles in T for the
// cast P/dS, NACC (RA × HD) float32 accumulators, and RB floats each of
// lse2 and Δ. B4: RA = q rows, RB = kv rows; B5: RA = kv rows, RB = q rows.
template <typename T, int HD, int RA, int RB, int NP, int NACC> struct Smem {
  static constexpr int LD = HD + Ty<T>::PAD;  // operand rows
  static constexpr int LDS = RB + 4;          // float score rows
  static constexpr int LDP = RB + Ty<T>::PAD; // P / dS rows in T
  static constexpr int LDO = HD + 4;          // accumulator rows
  static constexpr size_t a0 = 0;
  static constexpr size_t a1 = a0 + sizeof(T) * RA * LD;
  static constexpr size_t b0 = a1 + sizeof(T) * RA * LD;
  static constexpr size_t b1 = b0 + sizeof(T) * RB * LD;
  static constexpr size_t s0 = b1 + sizeof(T) * RB * LD;
  static constexpr size_t s1 = s0 + sizeof(float) * RA * LDS;
  static constexpr size_t p0 = s1 + sizeof(float) * RA * LDS;
  static constexpr size_t p1 = p0 + sizeof(T) * RA * LDP;
  static constexpr size_t acc = p0 + sizeof(T) * NP * RA * LDP;
  static constexpr size_t lse = acc + sizeof(float) * NACC * RA * LDO;
  static constexpr size_t delta = lse + sizeof(float) * RB;
  static constexpr size_t bytes = delta + sizeof(float) * RB;
  static_assert(a1 % 32 == 0 && b0 % 32 == 0 && b1 % 32 == 0 && s0 % 32 == 0 &&
                    s1 % 32 == 0 && p0 % 32 == 0 && p1 % 32 == 0 &&
                    acc % 32 == 0 && (sizeof(float) * RA * LDO) % 32 == 0,
                "WMMA tiles need 256-bit aligned bases");
  static_assert(bytes <= 232448, "above the 227 KB a block may use");
};

// rows [row0, row0 + rows) of a (n, HD) matrix into shared memory (pitch
// ld), zero past n; 16-byte vector copies.
template <typename T, int HD, int NTHREADS>
__device__ void load_tile(T* dst, int ld, const T* src, int row0, int n,
                          int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = HD / VEC;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += NTHREADS) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// rows [row0, row0 + rows) of a per-row float vector, zero past n.
template <int NTHREADS>
__device__ void load_rows(float* dst, const float* src, int row0, int n,
                          int rows) {
  for (int i = threadIdx.x; i < rows; i += NTHREADS)
    dst[i] = row0 + i < n ? src[row0 + i] : 0.0f;
}

// One warp: C (16 × N, float, pitch ldc) = A (16 × K) · Bᵀ with B (N × K).
template <typename T, int N, int K>
__device__ void warp_nt(const T* a, int lda, const T* b, int ldb, float* c,
                        int ldc, int lane) {
  if constexpr (sizeof(T) == 2) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
    for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + kk, lda);
      for (int j = 0; j < N / 16; ++j) {
        // Bᵀ as a column-major operand: element (k, n) at b[n·ldb + k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, b + j * 16 * ldb + kk, ldb);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    for (int j = 0; j < N / 16; ++j)
      wmma::store_matrix_sync(c + j * 16, acc[j], ldc, wmma::mem_row_major);
  } else {
    for (int r = 0; r < 16; ++r) {
      for (int col = lane; col < N; col += 32) {
        float s = 0.0f;
        for (int k = 0; k < K; ++k) s = fmaf(a[r * lda + k], b[col * ldb + k], s);
        c[r * ldc + col] = s;
      }
    }
  }
}

// One warp: C (16 × N, float, pitch ldc) += A (16 × K) · B with B (K × N).
template <typename T, int N, int K>
__device__ void warp_nn_acc(const T* a, int lda, const T* b, int ldb, float* c,
                            int ldc, int lane) {
  if constexpr (sizeof(T) == 2) {
    for (int j = 0; j < N / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, c + j * 16, ldc, wmma::mem_row_major);
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + kk, lda);
        wmma::load_matrix_sync(fb, b + kk * ldb + j * 16, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c + j * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      for (int col = lane; col < N; col += 32) {
        float s = c[r * ldc + col];
        for (int k = 0; k < K; ++k) s = fmaf(a[r * lda + k], b[k * ldb + col], s);
        c[r * ldc + col] = s;
      }
    }
  }
}

// B4: dQ for one (BQ-row q tile, batch·q-head row).
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::BQ * 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse2, const float* __restrict__ delta,
                    T* __restrict__ dq, int n_q, int n_kv, int hq, int hkv,
                    int causal, int offset) {
  constexpr int BQ = Cfg<T, HD>::BQ, BKV = Cfg<T, HD>::BKV, NTHREADS = BQ * 2;
  using S = Smem<T, HD, BQ, BKV, 1, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + S::a0);
  T* dos = reinterpret_cast<T*>(smem + S::a1);
  T* ks = reinterpret_cast<T*>(smem + S::b0);
  T* vs = reinterpret_cast<T*>(smem + S::b1);
  float* ss = reinterpret_cast<float*>(smem + S::s0);
  float* dps = reinterpret_cast<float*>(smem + S::s1);
  T* dss = reinterpret_cast<T*>(smem + S::p0);
  float* acc = reinterpret_cast<float*>(smem + S::acc);
  float* lses = reinterpret_cast<float*>(smem + S::lse);
  float* deltas = reinterpret_cast<float*>(smem + S::delta);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int kv_row = (b / hq) * hkv + (b % hq) / (hq / hkv);
  const size_t qoff = (size_t)b * n_q * HD;
  const T* kb = k + (size_t)kv_row * n_kv * HD;
  const T* vb = v + (size_t)kv_row * n_kv * HD;

  load_tile<T, HD, NTHREADS>(qs, S::LD, q + qoff, q0, n_q, BQ);
  load_tile<T, HD, NTHREADS>(dos, S::LD, dout + qoff, q0, n_q, BQ);
  load_rows<NTHREADS>(lses, lse2 + (size_t)b * n_q, q0, n_q, BQ);
  load_rows<NTHREADS>(deltas, delta + (size_t)b * n_q, q0, n_q, BQ);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) acc[i] = 0.0f;

  // kv tiles to visit: all, or up to the last key visible to the tile's
  // last real query (CausalSchedule._last_step, right-aligned).
  int steps = (n_kv + BKV - 1) / BKV;
  if (causal) {
    const int last_k = min(q0 + BQ - 1, n_q - 1) + offset;
    steps = last_k < 0 ? 0 : min(steps, last_k / BKV + 1);
  }
  const int r0 = warp * 16;
  for (int s = 0; s < steps; ++s) {
    const int k0 = s * BKV;
    __syncthreads();  // previous step done with ks/vs; init visible
    load_tile<T, HD, NTHREADS>(ks, S::LD, kb, k0, n_kv, BKV);
    load_tile<T, HD, NTHREADS>(vs, S::LD, vb, k0, n_kv, BKV);
    __syncthreads();
    warp_nt<T, BKV, HD>(qs + r0 * S::LD, S::LD, ks, S::LD, ss + r0 * S::LDS, S::LDS, lane);
    warp_nt<T, BKV, HD>(dos + r0 * S::LD, S::LD, vs, S::LD, dps + r0 * S::LDS, S::LDS, lane);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int qpos = q0 + r;
      for (int c = lane; c < BKV; c += 32) {
        const int kpos = k0 + c;
        const bool seen = qpos < n_q && kpos < n_kv && (!causal || kpos <= qpos + offset);
        const float p = seen ? exp2f(ss[r * S::LDS + c] - lses[r]) : 0.0f;
        dss[r * S::LDP + c] = Ty<T>::t(p * (dps[r * S::LDS + c] - deltas[r]));
      }
    }
    __syncwarp();
    warp_nn_acc<T, HD, BKV>(dss + r0 * S::LDP, S::LDP, ks, S::LD, acc + r0 * S::LDO, S::LDO, lane);
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= n_q) break;
    T* row = dq + qoff + (size_t)qpos * HD;
    for (int c = lane; c < HD; c += 32) row[c] = Ty<T>::t(acc[r * S::LDO + c] * LN2);
  }
}

// B5: dK and dV for one (BKV5-row kv tile, batch·kv-head row), summed over
// the g query heads of its group.
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::BKV5 * 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse2, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n_q, int n_kv,
                     int hq, int hkv, int causal, int offset) {
  constexpr int BQD = Cfg<T, HD>::BQD, BKV = Cfg<T, HD>::BKV5, NTHREADS = BKV * 2;
  using S = Smem<T, HD, BKV, BQD, 2, 2>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + S::a0);
  T* vs = reinterpret_cast<T*>(smem + S::a1);
  T* qs = reinterpret_cast<T*>(smem + S::b0);
  T* dos = reinterpret_cast<T*>(smem + S::b1);
  float* sts = reinterpret_cast<float*>(smem + S::s0);
  float* dpts = reinterpret_cast<float*>(smem + S::s1);
  T* pts = reinterpret_cast<T*>(smem + S::p0);
  T* dsts = reinterpret_cast<T*>(smem + S::p1);
  float* dkacc = reinterpret_cast<float*>(smem + S::acc);
  float* dvacc = dkacc + BKV * S::LDO;
  float* lses = reinterpret_cast<float*>(smem + S::lse);
  float* deltas = reinterpret_cast<float*>(smem + S::delta);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BKV;
  const int kv_row = blockIdx.y;
  const int g = hq / hkv;
  const int q_row0 = (kv_row / hkv) * hq + (kv_row % hkv) * g;
  const size_t kvoff = (size_t)kv_row * n_kv * HD;

  load_tile<T, HD, NTHREADS>(ks, S::LD, k + kvoff, k0, n_kv, BKV);
  load_tile<T, HD, NTHREADS>(vs, S::LD, v + kvoff, k0, n_kv, BKV);
  for (int i = threadIdx.x; i < 2 * BKV * S::LDO; i += NTHREADS) dkacc[i] = 0.0f;

  // q tiles that see a key of this tile: from the one holding query
  // k0 − offset on (CausalSchedule._first_q_block), or all of them.
  const int q_tiles = (n_q + BQD - 1) / BQD;
  const int first = causal && k0 - offset > 0 ? (k0 - offset) / BQD : 0;
  const int r0 = warp * 16;
  for (int h = 0; h < g; ++h) {
    const int b = q_row0 + h;
    const size_t qoff = (size_t)b * n_q * HD;
    for (int t = first; t < q_tiles; ++t) {
      const int q0 = t * BQD;
      __syncthreads();  // previous step done with qs/dos; init visible
      load_tile<T, HD, NTHREADS>(qs, S::LD, q + qoff, q0, n_q, BQD);
      load_tile<T, HD, NTHREADS>(dos, S::LD, dout + qoff, q0, n_q, BQD);
      load_rows<NTHREADS>(lses, lse2 + (size_t)b * n_q, q0, n_q, BQD);
      load_rows<NTHREADS>(deltas, delta + (size_t)b * n_q, q0, n_q, BQD);
      __syncthreads();
      warp_nt<T, BQD, HD>(ks + r0 * S::LD, S::LD, qs, S::LD, sts + r0 * S::LDS, S::LDS, lane);
      warp_nt<T, BQD, HD>(vs + r0 * S::LD, S::LD, dos, S::LD, dpts + r0 * S::LDS, S::LDS, lane);
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        const int kpos = k0 + r;
        for (int c = lane; c < BQD; c += 32) {
          const int qpos = q0 + c;
          const bool seen = qpos < n_q && kpos < n_kv && (!causal || kpos <= qpos + offset);
          const float p = seen ? exp2f(sts[r * S::LDS + c] - lses[c]) : 0.0f;
          pts[r * S::LDP + c] = Ty<T>::t(p);
          dsts[r * S::LDP + c] = Ty<T>::t(p * (dpts[r * S::LDS + c] - deltas[c]));
        }
      }
      __syncwarp();
      warp_nn_acc<T, HD, BQD>(pts + r0 * S::LDP, S::LDP, dos, S::LD, dvacc + r0 * S::LDO, S::LDO, lane);
      warp_nn_acc<T, HD, BQD>(dsts + r0 * S::LDP, S::LDP, qs, S::LD, dkacc + r0 * S::LDO, S::LDO, lane);
    }
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int kpos = k0 + r;
    if (kpos >= n_kv) break;
    T* dkrow = dk + kvoff + (size_t)kpos * HD;
    T* dvrow = dv + kvoff + (size_t)kpos * HD;
    for (int c = lane; c < HD; c += 32) {
      dkrow[c] = Ty<T>::t(dkacc[r * S::LDO + c] * LN2);
      dvrow[c] = Ty<T>::t(dvacc[r * S::LDO + c]);
    }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse2, const float* delta,
                      void* dq, int bh, int n_q, int n_kv, int hq, int hkv,
                      int causal, int offset, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = flash_bwd_dq_kernel<T, HD>;
  const size_t smem = Smem<T, HD, C::BQ, C::BKV, 1, 1>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_q + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, C::BQ * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse2, delta, static_cast<T*>(dq), n_q, n_kv,
      hq, hkv, causal, offset);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse2, const float* delta,
                       void* dk, void* dv, int bh_kv, int n_q, int n_kv, int hq,
                       int hkv, int causal, int offset, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  const size_t smem = Smem<T, HD, C::BKV5, C::BQD, 2, 2>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_kv + C::BKV5 - 1) / C::BKV5, bh_kv);
  kern<<<grid, C::BKV5 * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse2, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), n_q, n_kv, hq, hkv, causal, offset);
  return cudaGetLastError();
}

}  // namespace

// q, dout: (bh, n_q, d), q prescaled; k, v: (bh / hq · hkv, n_kv, d);
// lse2 = clamped lse · log2(e) and delta: (bh, n_q) float32; dq like q.
// All contiguous, 16-byte aligned, one dtype (0 = float32, 1 = bfloat16).
// d ∈ {64, 128, 256} (the wrapper zero-pads other head and value dims).
extern "C" cudaError_t tf_flash_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse2,
                                       const float* delta, void* dq, int bh,
                                       int n_q, int n_kv, int hq, int hkv, int d,
                                       int causal, int offset, int dtype,
                                       cudaStream_t stream) {
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
#define TF_DQ(T, HD) \
  launch_dq<T, HD>(q, k, v, dout, lse2, delta, dq, bh, n_q, n_kv, hq, hkv, causal, offset, stream)
  if (dtype == 1 && d == 256) return TF_DQ(__nv_bfloat16, 256);
  if (dtype == 1 && d == 128) return TF_DQ(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) return TF_DQ(__nv_bfloat16, 64);
  if (dtype == 0 && d == 256) return TF_DQ(float, 256);
  if (dtype == 0 && d == 128) return TF_DQ(float, 128);
  if (dtype == 0 && d == 64) return TF_DQ(float, 64);
#undef TF_DQ
  return cudaErrorInvalidValue;
}

// The same operands; dk, dv: like k, v; bh_kv = batch · hkv.
extern "C" cudaError_t tf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse2,
                                        const float* delta, void* dk, void* dv,
                                        int bh_kv, int n_q, int n_kv, int hq,
                                        int hkv, int d, int causal, int offset,
                                        int dtype, cudaStream_t stream) {
  if (bh_kv <= 0 || n_kv <= 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
#define TF_DKV(T, HD)                                                          \
  launch_dkv<T, HD>(q, k, v, dout, lse2, delta, dk, dv, bh_kv, n_q, n_kv, hq, \
                    hkv, causal, offset, stream)
  if (dtype == 1 && d == 256) return TF_DKV(__nv_bfloat16, 256);
  if (dtype == 1 && d == 128) return TF_DKV(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) return TF_DKV(__nv_bfloat16, 64);
  if (dtype == 0 && d == 256) return TF_DKV(float, 256);
  if (dtype == 0 && d == 128) return TF_DKV(float, 128);
  if (dtype == 0 && d == 64) return TF_DKV(float, 64);
#undef TF_DKV
  return cudaErrorInvalidValue;
}
