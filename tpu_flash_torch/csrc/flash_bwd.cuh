// B4/B5's parameters and their WMMA (bf16) / FMA (float32) kernels, shared
// by flash_bwd.cu (the entry points, the TMA + wgmma kernels and the
// instantiations up to width 256) and flash_bwd_wide.cu (the width-512
// instantiations), which compile side by side. The design is described at
// the top of flash_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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
  int dv_cols;  // B5: the caller's value dim; a half past it takes no dV
};

// B4 and B5 at width 512 (dtype 0 float32, 1 bf16), in flash_bwd_wide.cu
cudaError_t launch_wide_dq(const BwdParams& p, int bh, int dtype, bool dp,
                           cudaStream_t stream);
cudaError_t launch_wide_dkv(const BwdParams& p, int bh_kv, int dtype, bool dp,
                            cudaStream_t stream);

}  // namespace tf_bwd

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using tf_bwd::BwdParams;

constexpr float LN2 = 0.693147180559945309f;

__host__ __device__ __forceinline__ Sched sched_of(const BwdParams& p) {
  return Sched{p.n_q, p.n_kv, p.kind, p.offset, p.radius, p.section};
}

// ----------------------------- WMMA (bf16 d 256, 512) and FMA (float32)

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static constexpr int PAD = 8;   // keeps rows 16 B aligned, shifts banks
  static __device__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Ty<float> {
  static constexpr int PAD = 4;
  static __device__ float t(float x) { return x; }
};

// The output columns a block accumulates: all HD up to width 256; at 512
// one 256-column half, blockIdx.z picking it. The score products still run
// over the full width, so each half recomputes S and dP.
template <int HD> constexpr int OUT_COLS = HD > 256 ? 256 : HD;

// Tiles. B4: BQ q rows per block, BKV kv rows per step; B5: BKV5 kv rows per
// block, BQD q rows per step. A block has one warp per 16 rows of its own
// tile (BQ or BKV5). At d 256 the own tile is 32 rows (2 warps), and
// float32 also steps 32 rows; at 512 bf16 takes 32 rows throughout and
// float32 16 (one warp), so that every variant fits in 227 KB.
template <typename T, int HD> struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int W512 = HD == 512 ? (F32 ? 16 : 32) : 0;
  static constexpr int BQ = W512 ? W512 : HD == 256 ? 32 : 64;
  static constexpr int BKV = W512 ? W512 : (F32 && HD == 256) ? 32 : 64;
  static constexpr int BKV5 = W512 ? W512 : HD == 256 ? 32 : 64;
  static constexpr int BQD = W512 ? W512 : F32 ? 32 : 64;
};

// Shared memory of one block: two (RA × HD) and two (RB × HD) operand
// tiles, two (RA × RB) float32 score tiles, NP (RA × RB) tiles in T for the
// cast P/dS, NACC (RA × OUT_COLS) float32 accumulators, RB floats each of lse2
// and Δ, and X8 (RB × HD) int8 tiles (B5's dÔ under dp). An int8 tile is
// stored in 16-byte column blocks (element (r, c) at (c / 16)·rows·16 +
// r·16 + c % 16), so that every s8 WMMA fragment starts 32-byte aligned;
// under dp B4's dÔ and V̂ and B5's V̂ take the dO and V slots.
template <typename T, int HD, int RA, int RB, int NP, int NACC, int X8 = 0> struct Smem {
  static constexpr int LD = HD + Ty<T>::PAD;  // operand rows
  static constexpr int LDS = RB + 4;          // float score rows
  static constexpr int LDP = RB + Ty<T>::PAD; // P / dS rows in T
  static constexpr int LDO = OUT_COLS<HD> + 4;  // accumulator rows
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
  static constexpr size_t x8 = (delta + sizeof(float) * RB + 31) / 32 * 32;
  static constexpr size_t bytes = x8 + (size_t)X8 * RB * HD;
  static_assert(a1 % 32 == 0 && b0 % 32 == 0 && b1 % 32 == 0 && s0 % 32 == 0 &&
                    s1 % 32 == 0 && p0 % 32 == 0 && p1 % 32 == 0 &&
                    acc % 32 == 0 && (sizeof(float) * RA * LDO) % 32 == 0,
                "WMMA tiles need 256-bit aligned bases");
  static_assert(sizeof(T) * LD >= HD, "an int8 tile outgrows its slot");
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

// the same for an int8 (n, HD) matrix into 16-byte column blocks
template <int HD, int NTHREADS>
__device__ void load_tile8(int8_t* dst, const int8_t* src, int row0, int n, int rows) {
  constexpr int CHUNKS = HD / 16;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += NTHREADS) {
    int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + 16 * c);
    *reinterpret_cast<uint4*>(dst + (c * rows + r) * 16) = val;
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

// One warp: C (16 × N, int32, pitch ldc) = A · Bᵀ on int8 tiles in 16-byte
// column blocks: A is rows [a_row, a_row + 16) of an RA-row tile, B an
// N-row tile, K int8 columns. TC: the s8 WMMA; else __dp4a.
template <bool TC, int RA, int N, int K>
__device__ void warp_nt_s8(const int8_t* a, int a_row, const int8_t* b, int* c, int ldc,
                           int lane) {
  if constexpr (TC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[N / 16];
    for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(acc[j], 0);
    for (int kb = 0; kb < K / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, reinterpret_cast<const signed char*>(a) +
                                     (kb * RA + a_row) * 16, 16);
      for (int j = 0; j < N / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, reinterpret_cast<const signed char*>(b) +
                                       (kb * N + j * 16) * 16, 16);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    for (int j = 0; j < N / 16; ++j)
      wmma::store_matrix_sync(c + j * 16, acc[j], ldc, wmma::mem_row_major);
  } else {
    const int* aw = reinterpret_cast<const int*>(a);
    const int* bw = reinterpret_cast<const int*>(b);
    for (int r = 0; r < 16; ++r) {
      for (int col = lane; col < N; col += 32) {
        int s = 0;
        for (int kb = 0; kb < K / 16; ++kb)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            s = __dp4a(aw[(kb * RA + a_row + r) * 4 + w], bw[(kb * N + col) * 4 + w], s);
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

// B4: dQ for one (BQ-row q tile, batch·q-head row, column half).
template <typename T, int HD, bool DP>
__global__ void __launch_bounds__(Cfg<T, HD>::BQ * 2)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BQ = Cfg<T, HD>::BQ, BKV = Cfg<T, HD>::BKV, NTHREADS = BQ * 2;
  constexpr int HO = OUT_COLS<HD>;
  constexpr bool TC = sizeof(T) == 2;
  using S = Smem<T, HD, BQ, BKV, 1, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + S::a0);
  T* dos = reinterpret_cast<T*>(smem + S::a1);  // dÔ (int8) under dp
  T* ks = reinterpret_cast<T*>(smem + S::b0);
  T* vs = reinterpret_cast<T*>(smem + S::b1);   // V̂ (int8) under dp
  float* ss = reinterpret_cast<float*>(smem + S::s0);
  float* dps = reinterpret_cast<float*>(smem + S::s1);
  T* dss = reinterpret_cast<T*>(smem + S::p0);
  float* acc = reinterpret_cast<float*>(smem + S::acc);
  float* lses = reinterpret_cast<float*>(smem + S::lse);
  float* deltas = reinterpret_cast<float*>(smem + S::delta);
  int8_t* dos8 = reinterpret_cast<int8_t*>(dos);
  int8_t* vs8 = reinterpret_cast<int8_t*>(vs);

  const Sched s = sched_of(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, q_last = min(q0 + BQ - 1, s.n_q - 1);
  const int b = blockIdx.y;
  const int oc = blockIdx.z * HO;  // this block's dQ columns [oc, oc + HO)
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  const size_t qoff = (size_t)b * s.n_q * HD;
  const size_t kvoff = (size_t)kv_row * s.n_kv * HD;
  const T* kb = static_cast<const T*>(p.k) + kvoff;

  load_tile<T, HD, NTHREADS>(qs, S::LD, static_cast<const T*>(p.q) + qoff, q0, s.n_q, BQ);
  if constexpr (DP)
    load_tile8<HD, NTHREADS>(dos8, static_cast<const int8_t*>(p.do8) + qoff, q0, s.n_q, BQ);
  else
    load_tile<T, HD, NTHREADS>(dos, S::LD, static_cast<const T*>(p.dout) + qoff, q0, s.n_q,
                               BQ);
  load_rows<NTHREADS>(lses, p.lse2 + (size_t)b * s.n_q, q0, s.n_q, BQ);
  load_rows<NTHREADS>(deltas, p.delta + (size_t)b * s.n_q, q0, s.n_q, BQ);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) acc[i] = 0.0f;

  int first, last;
  kv_range(s, q0, q_last, BKV, first, last);
  const int r0 = warp * 16;
  for (int st = first; st <= last; ++st) {
    const int k0 = st * BKV;
    const bool full = tile_full(s, k0, k0 + BKV - 1, q0, q_last);
    __syncthreads();  // previous step done with ks/vs; init visible
    load_tile<T, HD, NTHREADS>(ks, S::LD, kb, k0, s.n_kv, BKV);
    if constexpr (DP)
      load_tile8<HD, NTHREADS>(vs8, static_cast<const int8_t*>(p.v8) + kvoff, k0, s.n_kv, BKV);
    else
      load_tile<T, HD, NTHREADS>(vs, S::LD, static_cast<const T*>(p.v) + kvoff, k0, s.n_kv,
                                 BKV);
    __syncthreads();
    warp_nt<T, BKV, HD>(qs + r0 * S::LD, S::LD, ks, S::LD, ss + r0 * S::LDS, S::LDS, lane);
    if constexpr (DP)
      warp_nt_s8<TC, BQ, BKV, HD>(dos8, r0, vs8, reinterpret_cast<int*>(dps + r0 * S::LDS),
                                  S::LDS, lane);
    else
      warp_nt<T, BKV, HD>(dos + r0 * S::LD, S::LD, vs, S::LD, dps + r0 * S::LDS, S::LDS, lane);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int qpos = q0 + r;
      for (int c = lane; c < BKV; c += 32) {
        const bool seen = full || (qpos < s.n_q && visible(s, qpos, k0 + c));
        const float p_ = seen ? exp2f(ss[r * S::LDS + c] - lses[r]) : 0.0f;
        const float dp = DP ? (float)reinterpret_cast<const int*>(dps)[r * S::LDS + c]
                            : dps[r * S::LDS + c];
        dss[r * S::LDP + c] = Ty<T>::t(p_ * (dp - deltas[r]));
      }
    }
    __syncwarp();
    warp_nn_acc<T, HO, BKV>(dss + r0 * S::LDP, S::LDP, ks + oc, S::LD, acc + r0 * S::LDO, S::LDO,
                            lane);
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= s.n_q) break;
    // dp: the rows carry σdo (ds = σdo·ds_raw), one multiply here
    const float scale = DP ? p.sdo[(size_t)b * s.n_q + qpos] * LN2 : LN2;
    T* row = static_cast<T*>(p.dq) + qoff + (size_t)qpos * HD;
    for (int c = lane; c < HO; c += 32) row[oc + c] = Ty<T>::t(acc[r * S::LDO + c] * scale);
  }
}

// B5: dK and dV for one (BKV5-row kv tile, batch·kv-head row, column half),
// summed over the g query heads of its group. A half that holds no value
// column (p.dv_cols at or below its first) takes dK alone.
template <typename T, int HD, bool DP>
__global__ void __launch_bounds__(Cfg<T, HD>::BKV5 * 2)
flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BQD = Cfg<T, HD>::BQD, BKV = Cfg<T, HD>::BKV5, NTHREADS = BKV * 2;
  constexpr int HO = OUT_COLS<HD>;
  constexpr bool TC = sizeof(T) == 2;
  using S = Smem<T, HD, BKV, BQD, 2, 2, DP ? 1 : 0>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + S::a0);
  T* vs = reinterpret_cast<T*>(smem + S::a1);   // V̂ (int8) under dp
  T* qs = reinterpret_cast<T*>(smem + S::b0);   // then qs under dp
  T* dos = reinterpret_cast<T*>(smem + S::b1);
  float* sts = reinterpret_cast<float*>(smem + S::s0);
  float* dpts = reinterpret_cast<float*>(smem + S::s1);
  T* pts = reinterpret_cast<T*>(smem + S::p0);
  T* dsts = reinterpret_cast<T*>(smem + S::p1);
  float* dkacc = reinterpret_cast<float*>(smem + S::acc);
  float* dvacc = dkacc + BKV * S::LDO;
  float* lses = reinterpret_cast<float*>(smem + S::lse);
  float* deltas = reinterpret_cast<float*>(smem + S::delta);
  int8_t* vs8 = reinterpret_cast<int8_t*>(vs);
  int8_t* dos8 = reinterpret_cast<int8_t*>(smem + S::x8);

  const Sched s = sched_of(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BKV, k_hi = min(k0 + BKV - 1, s.n_kv - 1);
  const int kv_row = blockIdx.y;
  const int oc = blockIdx.z * HO;  // this block's dK and dV columns
  const bool with_dv = oc < p.dv_cols;
  const int g = p.hq / p.hkv;
  const int q_row0 = (kv_row / p.hkv) * p.hq + (kv_row % p.hkv) * g;
  const size_t kvoff = (size_t)kv_row * s.n_kv * HD;

  load_tile<T, HD, NTHREADS>(ks, S::LD, static_cast<const T*>(p.k) + kvoff, k0, s.n_kv, BKV);
  if constexpr (DP)
    load_tile8<HD, NTHREADS>(vs8, static_cast<const int8_t*>(p.v8) + kvoff, k0, s.n_kv, BKV);
  else
    load_tile<T, HD, NTHREADS>(vs, S::LD, static_cast<const T*>(p.v) + kvoff, k0, s.n_kv, BKV);
  for (int i = threadIdx.x; i < 2 * BKV * S::LDO; i += NTHREADS) dkacc[i] = 0.0f;

  // the q tiles that see a key of this tile (the transposed visit)
  int first, last;
  q_range(s, k0, k_hi, BQD, first, last);
  const int r0 = warp * 16;
  for (int h = 0; h < g; ++h) {
    const int b = q_row0 + h;
    const size_t qoff = (size_t)b * s.n_q * HD;
    for (int t = first; t <= last; ++t) {
      const int q0 = t * BQD;
      const bool full = q0 + BQD - 1 < s.n_q && tile_full(s, k0, k0 + BKV - 1, q0, q0 + BQD - 1);
      __syncthreads();  // previous step done with qs/dos; init visible
      load_tile<T, HD, NTHREADS>(qs, S::LD, static_cast<const T*>(p.q) + qoff, q0, s.n_q, BQD);
      load_tile<T, HD, NTHREADS>(dos, S::LD, static_cast<const T*>(p.dout) + qoff, q0, s.n_q,
                                 BQD);
      if constexpr (DP)
        load_tile8<HD, NTHREADS>(dos8, static_cast<const int8_t*>(p.do8) + qoff, q0, s.n_q, BQD);
      load_rows<NTHREADS>(lses, p.lse2 + (size_t)b * s.n_q, q0, s.n_q, BQD);
      load_rows<NTHREADS>(deltas, p.delta + (size_t)b * s.n_q, q0, s.n_q, BQD);
      __syncthreads();
      warp_nt<T, BQD, HD>(ks + r0 * S::LD, S::LD, qs, S::LD, sts + r0 * S::LDS, S::LDS, lane);
      if constexpr (DP)
        warp_nt_s8<TC, BKV, BQD, HD>(vs8, r0, dos8, reinterpret_cast<int*>(dpts + r0 * S::LDS),
                                     S::LDS, lane);
      else
        warp_nt<T, BQD, HD>(vs + r0 * S::LD, S::LD, dos, S::LD, dpts + r0 * S::LDS, S::LDS,
                            lane);
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        const int kpos = k0 + r;
        for (int c = lane; c < BQD; c += 32) {
          const int qpos = q0 + c;
          const bool seen = full || (qpos < s.n_q && visible(s, qpos, kpos));
          const float p_ = seen ? exp2f(sts[r * S::LDS + c] - lses[c]) : 0.0f;
          const float dp = DP ? (float)reinterpret_cast<const int*>(dpts)[r * S::LDS + c]
                              : dpts[r * S::LDS + c];
          pts[r * S::LDP + c] = Ty<T>::t(p_);
          dsts[r * S::LDP + c] = Ty<T>::t(p_ * (dp - deltas[c]));
        }
      }
      __syncwarp();
      if (with_dv)
        warp_nn_acc<T, HO, BQD>(pts + r0 * S::LDP, S::LDP, dos + oc, S::LD, dvacc + r0 * S::LDO,
                                S::LDO, lane);
      if constexpr (DP) {  // dK takes qs: it replaces Q, which Sᵀ is done with
        __syncthreads();
        load_tile<T, HD, NTHREADS>(qs, S::LD, static_cast<const T*>(p.qs) + qoff, q0, s.n_q,
                                   BQD);
        __syncthreads();
      }
      warp_nn_acc<T, HO, BQD>(dsts + r0 * S::LDP, S::LDP, qs + oc, S::LD, dkacc + r0 * S::LDO,
                              S::LDO, lane);
    }
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int kpos = k0 + r;
    if (kpos >= s.n_kv) break;
    T* dkrow = static_cast<T*>(p.dk) + kvoff + (size_t)kpos * HD;
    T* dvrow = static_cast<T*>(p.dv) + kvoff + (size_t)kpos * HD;
    for (int c = lane; c < HO; c += 32) {
      dkrow[oc + c] = Ty<T>::t(dkacc[r * S::LDO + c] * LN2);
      if (with_dv) dvrow[oc + c] = Ty<T>::t(dvacc[r * S::LDO + c]);
    }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD, bool DP>
cudaError_t launch_dq(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = flash_bwd_dq_kernel<T, HD, DP>;
  const size_t smem = Smem<T, HD, C::BQ, C::BKV, 1, 1>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n_q + C::BQ - 1) / C::BQ, bh, HD / OUT_COLS<HD>);
  kern<<<grid, C::BQ * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD, bool DP>
cudaError_t launch_dkv(const BwdParams& p, int bh_kv, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = flash_bwd_dkv_kernel<T, HD, DP>;
  const size_t smem = Smem<T, HD, C::BKV5, C::BQD, 2, 2, DP ? 1 : 0>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n_kv + C::BKV5 - 1) / C::BKV5, bh_kv, HD / OUT_COLS<HD>);
  kern<<<grid, C::BKV5 * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
