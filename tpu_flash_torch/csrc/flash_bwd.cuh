// B4/B5's parameters and their float32 FMA kernels, shared by flash_bwd.cu
// (the entry points, the bf16 TMA + wgmma kernels of widths 64 and 128, and
// the FMA instantiation at width 256), flash_bwd_wide.cu (the width-512
// instantiations) and flash_bwd_f32.cu (float32 at widths 64 and 128 on
// 3×TF32 wgmma), which compile side by side. The bf16 kernels of widths 256
// and 512 are in flash_bwd_tc.cuh. The design is described at the top of
// flash_bwd.cu (float32 at 64 and 128: flash_bwd_f32.cu).

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
  int dv_cols;  // B5: the caller's value dim; a half past it takes no dV
  int tf32_passes;  // float32 at widths 64, 128: 3 (3×TF32), or 1 (one TF32
                    // pass: the chip check's planted fault)
};

// B4 and B5 at width 512 (dtype 0 float32, 1 bf16), in flash_bwd_wide.cu
cudaError_t launch_wide_dq(const BwdParams& p, int bh, int dtype, bool dp,
                           cudaStream_t stream);
cudaError_t launch_wide_dkv(const BwdParams& p, int bh_kv, int dtype, bool dp,
                            cudaStream_t stream);

// B4 and B5 in float32 at widths 64 and 128 (3×TF32 on wgmma), in
// flash_bwd_f32.cu
cudaError_t launch_f32_dq(const BwdParams& p, int bh, int d, bool dp, cudaStream_t stream);
cudaError_t launch_f32_dkv(const BwdParams& p, int bh_kv, int d, bool dp, cudaStream_t stream);

}  // namespace tf_bwd

namespace {

using bf16 = __nv_bfloat16;
using tf_bwd::BwdParams;

constexpr float LN2 = 0.693147180559945309f;

__host__ __device__ __forceinline__ Sched sched_of(const BwdParams& p) {
  return Sched{p.n_q, p.n_kv, p.kind, p.offset, p.radius, p.section};
}

// ------------------------------------- float32 at widths 256, 512: FMA

constexpr int PAD = 4;  // float rows 16 B aligned, banks shifted

// The output columns a block accumulates: all HD up to width 256; at 512
// one 256-column half, blockIdx.z picking it. The score products still run
// over the full width, so each half recomputes S and dP.
template <int HD> constexpr int OUT_COLS = HD > 256 ? 256 : HD;

// Tiles (widths 256 and 512). B4: BQ q rows per block, BKV kv rows per
// step; B5: BKV5 kv rows per block, BQD q rows per step. A block has one
// warp per 16 rows of its own tile (BQ or BKV5): 32 at 256 (which also
// steps 32 rows), 16 (one warp) at 512, so that every variant fits in
// 227 KB.
template <int HD> struct Cfg {
  static_assert(HD == 256 || HD == 512, "float32 at 64 and 128: flash_bwd_f32.cu");
  static constexpr int BQ = HD == 512 ? 16 : 32;
  static constexpr int BKV = BQ;
  static constexpr int BKV5 = BQ;
  static constexpr int BQD = HD == 512 ? 16 : 32;
};

// Shared memory of one block: two (RA × HD) and two (RB × HD) operand
// tiles, two (RA × RB) score tiles, NP (RA × RB) P/dS tiles, NACC (RA ×
// OUT_COLS) accumulators, RB floats each of lse2 and Δ, and X8 (RB × HD)
// int8 tiles (B5's dÔ under dp). An int8 tile is stored in 16-byte column
// blocks (element (r, c) at (c / 16)·rows·16 + r·16 + c % 16); under dp
// B4's dÔ and V̂ and B5's V̂ take the dO and V slots.
template <int HD, int RA, int RB, int NP, int NACC, int X8 = 0> struct Smem {
  static constexpr int LD = HD + PAD;           // operand rows
  static constexpr int LDS = RB + 4;            // score rows
  static constexpr int LDP = RB + PAD;          // P / dS rows
  static constexpr int LDO = OUT_COLS<HD> + 4;  // accumulator rows
  static constexpr size_t a0 = 0;
  static constexpr size_t a1 = a0 + sizeof(float) * RA * LD;
  static constexpr size_t b0 = a1 + sizeof(float) * RA * LD;
  static constexpr size_t b1 = b0 + sizeof(float) * RB * LD;
  static constexpr size_t s0 = b1 + sizeof(float) * RB * LD;
  static constexpr size_t s1 = s0 + sizeof(float) * RA * LDS;
  static constexpr size_t p0 = s1 + sizeof(float) * RA * LDS;
  static constexpr size_t p1 = p0 + sizeof(float) * RA * LDP;
  static constexpr size_t acc = p0 + sizeof(float) * NP * RA * LDP;
  static constexpr size_t lse = acc + sizeof(float) * NACC * RA * LDO;
  static constexpr size_t delta = lse + sizeof(float) * RB;
  static constexpr size_t x8 = (delta + sizeof(float) * RB + 15) / 16 * 16;
  static constexpr size_t bytes = x8 + (size_t)X8 * RB * HD;
  static_assert(sizeof(float) * LD >= HD, "an int8 tile outgrows its slot");
  static_assert(bytes <= 232448, "above the 227 KB a block may use");
};

// rows [row0, row0 + rows) of a (n, HD) matrix into shared memory (pitch
// ld), zero past n; 16-byte vector copies.
template <int HD, int NTHREADS>
__device__ void load_tile(float* dst, int ld, const float* src, int row0, int n, int rows) {
  constexpr int CHUNKS = HD / 4;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += NTHREADS) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
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

// One warp: C (16 × N, pitch ldc) = A (16 × K) · Bᵀ with B (N × K).
template <int N, int K>
__device__ void warp_nt(const float* a, int lda, const float* b, int ldb, float* c, int ldc,
                        int lane) {
  for (int r = 0; r < 16; ++r) {
    for (int col = lane; col < N; col += 32) {
      float s = 0.0f;
      for (int k = 0; k < K; ++k) s = fmaf(a[r * lda + k], b[col * ldb + k], s);
      c[r * ldc + col] = s;
    }
  }
}

// One warp: C (16 × N, int32, pitch ldc) = A · Bᵀ on int8 tiles in 16-byte
// column blocks with __dp4a: A is rows [a_row, a_row + 16) of an RA-row
// tile, B an N-row tile, K int8 columns.
template <int RA, int N, int K>
__device__ void warp_nt_s8(const int8_t* a, int a_row, const int8_t* b, int* c, int ldc,
                           int lane) {
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

// One warp: C (16 × N, pitch ldc) += A (16 × K) · B with B (K × N).
template <int N, int K>
__device__ void warp_nn_acc(const float* a, int lda, const float* b, int ldb, float* c,
                            int ldc, int lane) {
  for (int r = 0; r < 16; ++r) {
    for (int col = lane; col < N; col += 32) {
      float s = c[r * ldc + col];
      for (int k = 0; k < K; ++k) s = fmaf(a[r * lda + k], b[k * ldb + col], s);
      c[r * ldc + col] = s;
    }
  }
}

// B4: dQ for one (BQ-row q tile, batch·q-head row, column half).
template <int HD, bool DP>
__global__ void __launch_bounds__(Cfg<HD>::BQ * 2)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BQ = Cfg<HD>::BQ, BKV = Cfg<HD>::BKV, NTHREADS = BQ * 2;
  constexpr int HO = OUT_COLS<HD>;
  using S = Smem<HD, BQ, BKV, 1, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::a0);
  float* dos = reinterpret_cast<float*>(smem + S::a1);  // dÔ (int8) under dp
  float* ks = reinterpret_cast<float*>(smem + S::b0);
  float* vs = reinterpret_cast<float*>(smem + S::b1);   // V̂ (int8) under dp
  float* ss = reinterpret_cast<float*>(smem + S::s0);
  float* dps = reinterpret_cast<float*>(smem + S::s1);
  float* dss = reinterpret_cast<float*>(smem + S::p0);
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
  const float* kb = static_cast<const float*>(p.k) + kvoff;

  load_tile<HD, NTHREADS>(qs, S::LD, static_cast<const float*>(p.q) + qoff, q0, s.n_q, BQ);
  if constexpr (DP)
    load_tile8<HD, NTHREADS>(dos8, static_cast<const int8_t*>(p.do8) + qoff, q0, s.n_q, BQ);
  else
    load_tile<HD, NTHREADS>(dos, S::LD, static_cast<const float*>(p.dout) + qoff, q0, s.n_q,
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
    load_tile<HD, NTHREADS>(ks, S::LD, kb, k0, s.n_kv, BKV);
    if constexpr (DP)
      load_tile8<HD, NTHREADS>(vs8, static_cast<const int8_t*>(p.v8) + kvoff, k0, s.n_kv, BKV);
    else
      load_tile<HD, NTHREADS>(vs, S::LD, static_cast<const float*>(p.v) + kvoff, k0, s.n_kv,
                              BKV);
    __syncthreads();
    warp_nt<BKV, HD>(qs + r0 * S::LD, S::LD, ks, S::LD, ss + r0 * S::LDS, S::LDS, lane);
    if constexpr (DP)
      warp_nt_s8<BQ, BKV, HD>(dos8, r0, vs8, reinterpret_cast<int*>(dps + r0 * S::LDS), S::LDS,
                              lane);
    else
      warp_nt<BKV, HD>(dos + r0 * S::LD, S::LD, vs, S::LD, dps + r0 * S::LDS, S::LDS, lane);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int qpos = q0 + r;
      for (int c = lane; c < BKV; c += 32) {
        const bool seen = full || (qpos < s.n_q && visible(s, qpos, k0 + c));
        const float p_ = seen ? exp2f(ss[r * S::LDS + c] - lses[r]) : 0.0f;
        const float dp = DP ? (float)reinterpret_cast<const int*>(dps)[r * S::LDS + c]
                            : dps[r * S::LDS + c];
        dss[r * S::LDP + c] = p_ * (dp - deltas[r]);
      }
    }
    __syncwarp();
    warp_nn_acc<HO, BKV>(dss + r0 * S::LDP, S::LDP, ks + oc, S::LD, acc + r0 * S::LDO, S::LDO,
                         lane);
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= s.n_q) break;
    // dp: the rows carry σdo (ds = σdo·ds_raw), one multiply here
    const float scale = DP ? p.sdo[(size_t)b * s.n_q + qpos] * LN2 : LN2;
    float* row = static_cast<float*>(p.dq) + qoff + (size_t)qpos * HD;
    for (int c = lane; c < HO; c += 32) row[oc + c] = acc[r * S::LDO + c] * scale;
  }
}

// B5: dK and dV for one (BKV5-row kv tile, batch·kv-head row, column half),
// summed over the g query heads of its group. A half that holds no value
// column (p.dv_cols at or below its first) takes dK alone.
template <int HD, bool DP>
__global__ void __launch_bounds__(Cfg<HD>::BKV5 * 2)
flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BQD = Cfg<HD>::BQD, BKV = Cfg<HD>::BKV5, NTHREADS = BKV * 2;
  constexpr int HO = OUT_COLS<HD>;
  using S = Smem<HD, BKV, BQD, 2, 2, DP ? 1 : 0>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + S::a0);
  float* vs = reinterpret_cast<float*>(smem + S::a1);   // V̂ (int8) under dp
  float* qs = reinterpret_cast<float*>(smem + S::b0);   // then qs under dp
  float* dos = reinterpret_cast<float*>(smem + S::b1);
  float* sts = reinterpret_cast<float*>(smem + S::s0);
  float* dpts = reinterpret_cast<float*>(smem + S::s1);
  float* pts = reinterpret_cast<float*>(smem + S::p0);
  float* dsts = reinterpret_cast<float*>(smem + S::p1);
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

  load_tile<HD, NTHREADS>(ks, S::LD, static_cast<const float*>(p.k) + kvoff, k0, s.n_kv, BKV);
  if constexpr (DP)
    load_tile8<HD, NTHREADS>(vs8, static_cast<const int8_t*>(p.v8) + kvoff, k0, s.n_kv, BKV);
  else
    load_tile<HD, NTHREADS>(vs, S::LD, static_cast<const float*>(p.v) + kvoff, k0, s.n_kv,
                            BKV);
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
      load_tile<HD, NTHREADS>(qs, S::LD, static_cast<const float*>(p.q) + qoff, q0, s.n_q, BQD);
      load_tile<HD, NTHREADS>(dos, S::LD, static_cast<const float*>(p.dout) + qoff, q0, s.n_q,
                              BQD);
      if constexpr (DP)
        load_tile8<HD, NTHREADS>(dos8, static_cast<const int8_t*>(p.do8) + qoff, q0, s.n_q, BQD);
      load_rows<NTHREADS>(lses, p.lse2 + (size_t)b * s.n_q, q0, s.n_q, BQD);
      load_rows<NTHREADS>(deltas, p.delta + (size_t)b * s.n_q, q0, s.n_q, BQD);
      __syncthreads();
      warp_nt<BQD, HD>(ks + r0 * S::LD, S::LD, qs, S::LD, sts + r0 * S::LDS, S::LDS, lane);
      if constexpr (DP)
        warp_nt_s8<BKV, BQD, HD>(vs8, r0, dos8, reinterpret_cast<int*>(dpts + r0 * S::LDS),
                                 S::LDS, lane);
      else
        warp_nt<BQD, HD>(vs + r0 * S::LD, S::LD, dos, S::LD, dpts + r0 * S::LDS, S::LDS, lane);
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        const int kpos = k0 + r;
        for (int c = lane; c < BQD; c += 32) {
          const int qpos = q0 + c;
          const bool seen = full || (qpos < s.n_q && visible(s, qpos, kpos));
          const float p_ = seen ? exp2f(sts[r * S::LDS + c] - lses[c]) : 0.0f;
          const float dp = DP ? (float)reinterpret_cast<const int*>(dpts)[r * S::LDS + c]
                              : dpts[r * S::LDS + c];
          pts[r * S::LDP + c] = p_;
          dsts[r * S::LDP + c] = p_ * (dp - deltas[c]);
        }
      }
      __syncwarp();
      if (with_dv)
        warp_nn_acc<HO, BQD>(pts + r0 * S::LDP, S::LDP, dos + oc, S::LD, dvacc + r0 * S::LDO,
                             S::LDO, lane);
      if constexpr (DP) {  // dK takes qs: it replaces Q, which Sᵀ is done with
        __syncthreads();
        load_tile<HD, NTHREADS>(qs, S::LD, static_cast<const float*>(p.qs) + qoff, q0, s.n_q,
                                BQD);
        __syncthreads();
      }
      warp_nn_acc<HO, BQD>(dsts + r0 * S::LDP, S::LDP, qs + oc, S::LD, dkacc + r0 * S::LDO,
                           S::LDO, lane);
    }
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int kpos = k0 + r;
    if (kpos >= s.n_kv) break;
    float* dkrow = static_cast<float*>(p.dk) + kvoff + (size_t)kpos * HD;
    float* dvrow = static_cast<float*>(p.dv) + kvoff + (size_t)kpos * HD;
    for (int c = lane; c < HO; c += 32) {
      dkrow[oc + c] = dkacc[r * S::LDO + c] * LN2;
      if (with_dv) dvrow[oc + c] = dvacc[r * S::LDO + c];
    }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD, bool DP>
cudaError_t launch_dq(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kern = flash_bwd_dq_kernel<HD, DP>;
  const size_t smem = Smem<HD, C::BQ, C::BKV, 1, 1>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n_q + C::BQ - 1) / C::BQ, bh, HD / OUT_COLS<HD>);
  kern<<<grid, C::BQ * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, bool DP>
cudaError_t launch_dkv(const BwdParams& p, int bh_kv, cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kern = flash_bwd_dkv_kernel<HD, DP>;
  const size_t smem = Smem<HD, C::BKV5, C::BQD, 2, 2, DP ? 1 : 0>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n_kv + C::BKV5 - 1) / C::BKV5, bh_kv, HD / OUT_COLS<HD>);
  kern<<<grid, C::BKV5 * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
