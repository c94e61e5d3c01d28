// B4 and B5: flash-attention backward for Hopper, sm_90a.
//
// B4 (tf_flash_bwd_dq) replaces tpu_flash/ops/flash_bwd.py:_dq_kernel and
// its transposed variant _dq_kernel_t (the d <= 64 layout that exists only
// to fill the TPU's 128-lane matrix unit; here d 64 is B4 at width 64). B5
// (tf_flash_bwd_dkv) replaces _dkv_kernel and _dkv_kernel_t. Both
// recompute P from the forward's lse (FA-2); neither keeps an O(n²)
// residual.
//
// Schedules: every kind of B1 (schedule.cuh, the kind codes of
// ops/flash.py:_KIND): dense, causal (right-aligned), local, local_causal,
// circulant over the halo-extended K/V the wrapper builds (n_kv = n + 2r),
// block-diagonal, and the ring hop's shifted and shifted_causal (offset the
// shift, radius -1 or the band, section the wrap). B4 walks a q tile's kv tiles (kv_range), B5 a kv tile's
// q tiles (q_range, the transposed visit); a tile wholly visible to the
// tile's rows skips the per-element mask (tile_full), as B1 does.
//
// Numerics mirror the reference: q arrives prescaled by scale·log2(e), so
// s = Q·Kᵀ is in base-2 units; lse2 = lse·log2(e) with lse = ±inf/NaN rows
// clamped to 3e38 first (the wrapper does both, in float32), so
// p = exp2(s − lse2) underflows to 0 on fully masked rows; dp = dO·Vᵀ;
// ds = p∘(dp − Δ) with Δ = rowsum(dO∘O) − dlse (the wrapper computes it).
// dq = Σ ds·K·ln2 with ds cast to K's dtype; dv = Σ pᵀ·dO with p cast to
// dO's dtype; dk = Σ dsᵀ·Q·ln2 with ds cast to Q's dtype. Products
// accumulate in float32. Masked and padded entries (keys past n_kv, queries
// past n_q, keys the schedule hides from a query) get p = 0 by index, never
// by the zero-filled data in shared memory. The bf16 kernels take 2^x from
// ex2.approx, as B1 does.
//
// The int8 dP product (quant "dp", the reference's dp_quant): the wrapper
// quantizes once outside the kernels: V̂ per (kv row, channel) with σv, dÔ
// per q row from dO·σv with σdo, Δ divided by σdo, and qs = q·σdo in q's
// dtype. Then dP_raw = dÔ·V̂ᵀ is an exact int8 product with int32 sums (the
// s8 wgmma, the s8 WMMA, or __dp4a); ds_raw = p∘(dP_raw − Δ/σdo); B4 scales
// its dq rows by σdo·ln2 in the epilogue, B5 takes dK += ds_rawᵀ·qs and
// keeps the exact dO for dV = Pᵀ·dO. Only where it applies: widths 128 and
// 256 (the reference ignores it at d, dv <= 64).
//
// What bounds them on an H100: tensor-core FLOPs. At the training shape
// (b 4, 16 q / 8 kv heads, n 1024 causal, d 128) B4 runs 3 products and
// B5 4 over the causal half: 25.8 and 34.4 GFLOP against ~50 MB of
// operands, far right of the ~295 FLOP/B ridge. Blocks run in parallel in
// no order, so every output tile has one writer, and the group's dK/dV sum
// inside one block: no floating-point atomics, a fixed summation order,
// bitwise repeatable. That is why this stays two kernels (7 products)
// where FA-2/FA-3 fuse five with atomics on dQ.
//
// Design, bf16 at compiled widths 64 and 128 (FA-3 shaped, on B1's
// building blocks in hopper.cuh). A producer warpgroup's first warp issues
// TMA (tensor maps over (rows, n, d), 64-column panels with the 128-byte
// swizzle; TMA zero-fills rows past n) into a ring of full/empty mbarriers
// and gives its registers to the consumers (setmaxnreg). A CTA owns 64 rows
// of the output; each consumer warpgroup runs its two score products on SS
// wgmma with both operands K-major, keeps p and ds in registers on the
// accumulator layout (the per-element mask only on tiles not wholly
// visible), packs them to bf16 A fragments, and runs the gradient products
// on RS wgmma with the same shared-memory tiles read MN-major (transpose
// bit, desc_mn). The gradient sums stay in registers until the finish.
// - B4: one CTA per (64-row q tile, bh row), under the causal kind the
//   heaviest q tiles first, and the q heads of a kv head neighbours, as in
//   B1. Q and dO load once, K and V stream through the ring over the q
//   tile's kv range; S = Q·Kᵀ, dP = dO·Vᵀ, dQ += dS·K. lse2 and Δ of a
//   thread's two rows are registers.
// - B5: one CTA per (64-row kv tile, bh_kv row). K and V load once; Q, dO
//   and the lse2/Δ of their rows stream through the ring over the g =
//   hq/hkv heads of the group in a fixed order and, for each, over the kv
//   tile's q range (producer and consumers walk the same range). The
//   producer warp's lanes copy lse2/Δ into the stage (plain loads; a row of
//   them need not be 16-byte aligned for TMA) and arrive on its full
//   barrier beside TMA's bytes. Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO,
//   dK += dSᵀ·Q; each accumulator column's lse2/Δ comes from the stage.
// - Consumers (a plain constant, CONSUMERS; chosen by timing, PERF.md
//   §6): at d 128 one a CTA and two CTAs an SM, so that one CTA's
//   elementwise pass overlaps the other's products (B5's consumer holds
//   dK + dV + Sᵀ + dPᵀ, 192 registers, in its 232); at d 64 two a CTA,
//   sharing its rows and taking the ring's steps in turn, which halves the
//   longest CTA's chain where the grid is one wave (b 1); their float32
//   partial sums meet in the drained ring, consumer 1's added to consumer
//   0's, a fixed order. 64-row K/V steps in B4, 64-row Q/dO steps in B5.
// - dp (width 128): dÔ and V̂ are int8 tiles of one 128-byte panel, dP on
//   the m64n64k32 s8 wgmma (both operands K-major), its s32 accumulator in
//   the float32 layout. B4's resident dO and staged V become dÔ and V̂. B5's
//   resident V becomes V̂ and its stage carries Q, dO, qs and dÔ (57 KB):
//   one stage fits beside the resident tiles in half an SM, so B5 under dp
//   runs a one-stage ring and leans on its second CTA for overlap.
//
// bf16 at width 256 (dK + dV alone would need 256 registers a thread) and
// float32 at every width (no tensor core takes exact float32; the
// reference's f32 dots are full precision) keep the earlier kernels below
// the TMA section: one block of warps per 64-row (32 at d 256) output tile,
// looping in the same order, WMMA 16×16×16 (bf16) or FMA loops (float32)
// with the float32 accumulators and score tiles in shared memory; float32
// B5 steps 32 q rows. Under dp their int8 tiles sit in the V (and B4's dO)
// slots in 16-byte column blocks, dP on the s8 WMMA (bf16) or __dp4a
// (float32), and B5 loads qs over Q once Sᵀ is taken. Cfg below: 154–227
// KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "schedule.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float LN2 = 0.693147180559945309f;

// What both families take: operands, the dp operands (null without dp),
// outputs, the schedule and the GQA heads.
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
  Sched s;
  int hq, hkv;
};

// ------------------------------------ WMMA (bf16 d 256) and FMA (float32)

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
// cast P/dS, NACC (RA × HD) float32 accumulators, RB floats each of lse2
// and Δ, and X8 (RB × HD) int8 tiles (B5's dÔ under dp). An int8 tile is
// stored in 16-byte column blocks (element (r, c) at (c / 16)·rows·16 +
// r·16 + c % 16), so that every s8 WMMA fragment starts 32-byte aligned;
// under dp B4's dÔ and V̂ and B5's V̂ take the dO and V slots.
template <typename T, int HD, int RA, int RB, int NP, int NACC, int X8 = 0> struct Smem {
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

// B4: dQ for one (BQ-row q tile, batch·q-head row).
template <typename T, int HD, bool DP>
__global__ void __launch_bounds__(Cfg<T, HD>::BQ * 2)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BQ = Cfg<T, HD>::BQ, BKV = Cfg<T, HD>::BKV, NTHREADS = BQ * 2;
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

  const Sched s = p.s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, q_last = min(q0 + BQ - 1, s.n_q - 1);
  const int b = blockIdx.y;
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
    warp_nn_acc<T, HD, BKV>(dss + r0 * S::LDP, S::LDP, ks, S::LD, acc + r0 * S::LDO, S::LDO, lane);
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= s.n_q) break;
    // dp: the rows carry σdo (ds = σdo·ds_raw), one multiply here
    const float scale = DP ? p.sdo[(size_t)b * s.n_q + qpos] * LN2 : LN2;
    T* row = static_cast<T*>(p.dq) + qoff + (size_t)qpos * HD;
    for (int c = lane; c < HD; c += 32) row[c] = Ty<T>::t(acc[r * S::LDO + c] * scale);
  }
}

// B5: dK and dV for one (BKV5-row kv tile, batch·kv-head row), summed over
// the g query heads of its group.
template <typename T, int HD, bool DP>
__global__ void __launch_bounds__(Cfg<T, HD>::BKV5 * 2)
flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BQD = Cfg<T, HD>::BQD, BKV = Cfg<T, HD>::BKV5, NTHREADS = BKV * 2;
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

  const Sched s = p.s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BKV, k_hi = min(k0 + BKV - 1, s.n_kv - 1);
  const int kv_row = blockIdx.y;
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
      warp_nn_acc<T, HD, BQD>(pts + r0 * S::LDP, S::LDP, dos, S::LD, dvacc + r0 * S::LDO, S::LDO, lane);
      if constexpr (DP) {  // dK takes qs: it replaces Q, which Sᵀ is done with
        __syncthreads();
        load_tile<T, HD, NTHREADS>(qs, S::LD, static_cast<const T*>(p.qs) + qoff, q0, s.n_q,
                                   BQD);
        __syncthreads();
      }
      warp_nn_acc<T, HD, BQD>(dsts + r0 * S::LDP, S::LDP, qs, S::LD, dkacc + r0 * S::LDO, S::LDO, lane);
    }
  }
  __syncthreads();
  for (int r = r0; r < r0 + 16; ++r) {
    const int kpos = k0 + r;
    if (kpos >= s.n_kv) break;
    T* dkrow = static_cast<T*>(p.dk) + kvoff + (size_t)kpos * HD;
    T* dvrow = static_cast<T*>(p.dv) + kvoff + (size_t)kpos * HD;
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

template <typename T, int HD, bool DP>
cudaError_t launch_dq(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = flash_bwd_dq_kernel<T, HD, DP>;
  const size_t smem = Smem<T, HD, C::BQ, C::BKV, 1, 1>::bytes;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.s.n_q + C::BQ - 1) / C::BQ, bh);
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
  dim3 grid((p.s.n_kv + C::BKV5 - 1) / C::BKV5, bh_kv);
  kern<<<grid, C::BKV5 * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16: TMA + wgmma

constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may use
constexpr int SM_SMEM = 233472;     // shared memory of an SM (228 KB)

// Consumer warpgroups a CTA at compiled width HD. A CTA owns 64 output
// rows (B4's q rows, B5's kv rows); its consumers share them and take the
// ring's steps in turn, and two consumers' float32 partial sums are added
// in a fixed order at the finish. One consumer runs two CTAs an SM. Two
// measured faster at d 64 and slower at d 128 (PERF.md §6).
template <int HD> constexpr int CONSUMERS = HD == 64 ? 2 : 1;

// Shared memory of a CTA of NC consumers: RESIDENT bytes loaded once, as
// many ring stages of STAGE bytes as fit (up to 3), a barrier for the
// resident tiles and two a stage, 1024 bytes of alignment slack. One
// consumer: two CTAs an SM share its 228 KB.
template <int NC, int RESIDENT, int STAGE>
struct Plan {
  static constexpr int MINB = NC == 1 ? 2 : 1;
  static constexpr int BUDGET = MINB == 2 ? SM_SMEM / 2 - 1024 : SMEM_LIMIT;
  static constexpr int bytes(int st) { return 1024 + RESIDENT + st * STAGE + (2 * st + 1) * 8; }
  static constexpr int ST = bytes(3) <= BUDGET ? 3 : bytes(2) <= BUDGET ? 2 : 1;
  static constexpr int SMEM = bytes(ST);
  static_assert(SMEM <= BUDGET, "above the shared memory a block may use");
  static_assert(RESIDENT % 1024 == 0 && STAGE % 1024 == 0,
                "swizzled tiles need 1024-byte bases");
};

// B4: 64 q rows of Q and dO (dÔ under dp) resident; a stage holds a K and
// a V (V̂) tile.
template <int HD, int NC, bool DP> struct DqCfg {
  static_assert(NC == 1 || NC == 2, "partial sums meet pairwise");
  static_assert(!DP || (NC == 1 && HD == 128), "dp runs at width 128");
  static constexpr int BQ = 64, BKV = 64;
  static constexpr int QBYTES = BQ * HD * 2;
  static constexpr int DOBYTES = BQ * HD * (DP ? 1 : 2);
  static constexpr int KTILE = BKV * HD * 2;
  static constexpr int VTILE = BKV * HD * (DP ? 1 : 2);
  using P = Plan<NC, QBYTES + DOBYTES, KTILE + VTILE>;
  static_assert(NC == 1 || P::ST * (KTILE + VTILE) >= 128 * HD / 2 * 4,
                "the partial sums outgrow the ring");
  // registers a thread after setmaxnreg: 128·(PRODUCER + NC·CONSUMER)
  // within the launch's 65536 / MINB
  static constexpr int PRODUCER = 40, CONSUMER = NC == 1 ? 216 : 232;
};

// B5: 64 kv rows of K and V (V̂ under dp) resident; a stage holds a Q and a
// dO tile (and under dp a qs and a dÔ tile) and the lse2 and Δ of their BQ
// rows (2·BQ floats in a 1024-byte slot).
template <int HD, int NC, bool DP> struct DkvCfg {
  static_assert(NC == 1 || NC == 2, "partial sums meet pairwise");
  static_assert(!DP || (NC == 1 && HD == 128), "dp runs at width 128");
  static constexpr int BKV = 64, BQ = 64;
  static constexpr int KBYTES = BKV * HD * 2;
  static constexpr int VBYTES = BKV * HD * (DP ? 1 : 2);
  static constexpr int TILE = BQ * HD * 2;
  static constexpr int TILE8 = BQ * HD;
  static constexpr int ROWS = 1024;
  static_assert(2 * BQ * 4 <= ROWS, "lse2 and Δ outgrow their slot");
  static constexpr int QS_OFF = 2 * TILE, DO8_OFF = 3 * TILE;  // dp only
  static constexpr int TX = DP ? 3 * TILE + TILE8 : 2 * TILE;  // TMA bytes a stage
  static constexpr int STAGE = TX + ROWS;
  using P = Plan<NC, KBYTES + VBYTES, STAGE>;
  static_assert(NC == 1 || P::ST * STAGE >= 128 * HD * 4, "the partial sums outgrow the ring");
  // as DqCfg; dK + dV + Sᵀ + dPᵀ take 192 registers at d 128
  static constexpr int PRODUCER = 24, CONSUMER = NC == 1 ? 232 : 240;
};

template <int N> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ uint8_t* align1024(unsigned char* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// acc (64 × N) = A · Bᵀ over HD: A a 64-row tile, B an N-row tile, both
// K-major in 64-column swizzled panels (panel p of a ROWS-row tile at
// p·ROWS·128 bytes)
template <int N, int HD>
__device__ __forceinline__ void ss_gemm(float (&acc)[N / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int colb = 32 * kk;
    wgmma_bf16_bf16<N>(acc, desc<128>(a_addr + (colb / 128) * 64 * 128 + colb % 128),
                       desc<128>(b_addr + (colb / 128) * N * 128 + colb % 128), kk);
  }
}

// the same on int8 tiles of HD columns (128-column panels), s32 sums
template <int N, int HD>
__device__ __forceinline__ void ss_gemm_s8(int (&acc)[N / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk) {
    const int colb = 32 * kk;
    wgmma_s8_s8<N>(acc, desc<128>(a_addr + (colb / 128) * 64 * 128 + colb % 128),
                   desc<128>(b_addr + (colb / 128) * N * 128 + colb % 128), kk);
  }
}

// acc (64 × HD) += A · B: A (64 × K) as bf16 register fragments, B the
// K-row tile at b_addr read MN-major (its rows run along K)
template <int K, int HD>
__device__ __forceinline__ void rs_gemm(float (&acc)[HD / 2], const uint32_t (&a)[K / 16][4],
                                        uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs_bf16<HD, 1>(acc, a[kk], desc_mn(b_addr + kk * 16 * 128, K * 128));
}

// a (64 × N) accumulator as the bf16 A fragments of a k16 step each: the
// accumulator's column pairs are the fragment's, so packing is in place
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// S and dP of one step: S = A·Bᵀ in bf16, dP = C·Dᵀ in bf16 or, under dp,
// on the int8 tiles (s32 sums, converted); one commit group
template <int N, int HD, bool DP>
__device__ __forceinline__ void score_products(float (&sc)[N / 2], float (&dp)[N / 2],
                                               uint32_t a, uint32_t b, uint32_t c,
                                               uint32_t d) {
  if constexpr (DP) {
    int dpi[N / 2];
    wgmma_fence();
    ss_gemm<N, HD>(sc, a, b);
    ss_gemm_s8<N, HD>(dpi, c, d);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);
    reg_fence(dpi);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dp[e] = (float)dpi[e];
  } else {
    wgmma_fence();
    ss_gemm<N, HD>(sc, a, b);
    ss_gemm<N, HD>(dp, c, d);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);
    reg_fence(dp);
  }
}

// Two consumers' partial sums meet in the drained ring: consumer 1 puts
// its accumulators into shared memory, consumer 0 adds them to its own.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void put_part(const float (&a)[N], float* at) {
#pragma unroll
  for (int e = 0; e < N; ++e) at[e * 128] = a[e];
}
template <int N>
__device__ __forceinline__ void add_part(float (&a)[N], const float* at) {
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] += at[e * 128];
}

// rows ra, rb of a 64 × HD accumulator, times their scales, into bf16 rows
// of out
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 2], int t4,
                                           long row_a, long row_b, float scale_a,
                                           float scale_b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long row = half ? row_b : row_a;
    const float scale = half ? scale_b : scale_a;
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + row * HD + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// The tensor maps of both kernels: q, dO and qs over (bh, n_q, HD) bf16,
// k and v over (bh_kv, n_kv, HD), and under dp dÔ over (bh, n_q) and v (V̂)
// over (bh_kv, n_kv) rows of HD int8.
struct Maps {
  CUtensorMap q, dout, k, v, qs, do8;
};

// B4: dQ of one (64-row q tile, bh row).
template <int HD, int NC, bool DP>
__global__ void __launch_bounds__(128 * (NC + 1), DqCfg<HD, NC, DP>::P::MINB)
    flash_bwd_dq_tc(const __grid_constant__ Maps m, const BwdParams p) {
  using C = DqCfg<HD, NC, DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::P::ST, PANELS = HD / 64;
  constexpr int STAGE = C::KTILE + C::VTILE;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                      // 64 rows of Q, PANELS panels
  uint8_t* dos = smem + C::QBYTES;         // the same rows of dO (dÔ)
  uint8_t* stages = dos + C::DOBYTES;      // ST × (K, V)
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(stages + ST * STAGE);
  uint64_t* full_bar = q_bar + 1;
  uint64_t* empty_bar = full_bar + ST;

  const Sched s = p.s;
  const int n_tiles = (s.n_q + BQ - 1) / BQ;
  // the heaviest causal q tiles first
  const int qt = s.kind == CAUSAL ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qt * BQ, q_last = min(q0 + BQ - 1, s.n_q - 1);
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  int first, last;
  kv_range(s, q0, q_last, BKV, first, last);
  const int steps = max(0, last - first + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], 1);
      mbar_init(&empty_bar[i], 4);  // lane 0 of the step's consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == NC) {
    // ---------------- producer: one TMA thread ----------------
    reg_dealloc<C::PRODUCER>();
    if (wtid == 0) {
      mbar_expect_tx(q_bar, C::QBYTES + C::DOBYTES);
      for (int pn = 0; pn < PANELS; ++pn)
        tma_load_3d(qs + pn * 64 * 128, &m.q, pn * 128, q0, b, q_bar);
      if constexpr (DP)
        for (int pn = 0; pn < HD / 128; ++pn)
          tma_load_3d(dos + pn * 64 * 128, &m.do8, pn * 128, q0, b, q_bar);
      else
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(dos + pn * 64 * 128, &m.dout, pn * 128, q0, b, q_bar);
      for (int t = 0; t < steps; ++t) {
        const int i = t % ST, ph = (t / ST) & 1;
        const int k0 = (first + t) * BKV;
        mbar_wait(&empty_bar[i], ph ^ 1);
        uint8_t* st = stages + i * STAGE;
        mbar_expect_tx(&full_bar[i], STAGE);
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(st + pn * BKV * 128, &m.k, pn * 128, k0, kv_row, &full_bar[i]);
        for (int pn = 0; pn < C::VTILE / (BKV * 128); ++pn)
          tma_load_3d(st + C::KTILE + pn * BKV * 128, &m.v, pn * 128, k0, kv_row,
                      &full_bar[i]);
      }
    }
  } else {
    // ---------------- consumers: the 64 q rows, steps in turn ----------------
    reg_alloc<C::CONSUMER>();
    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int qa = q0 + ra, qb = q0 + rb;
    const size_t base = (size_t)b * s.n_q;
    const float lse_a = qa < s.n_q ? p.lse2[base + qa] : 0.0f;
    const float lse_b = qb < s.n_q ? p.lse2[base + qb] : 0.0f;
    const float dl_a = qa < s.n_q ? p.delta[base + qa] : 0.0f;
    const float dl_b = qb < s.n_q ? p.delta[base + qb] : 0.0f;
    // the keys each of the two rows sees (empty past n_q)
    const Span span_a = key_span(s, qa), span_b = key_span(s, qb);
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
    const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);
    mbar_wait(q_bar, 0);

    for (int t = wg; t < steps; t += NC) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int k0 = (first + t) * BKV;
      uint8_t* st = stages + i * STAGE;
      const uint32_t k_addr = smem_u32(st), v_addr = smem_u32(st + C::KTILE);
      mbar_wait(&full_bar[i], ph);
      // S = Q·Kᵀ and dP = dO·Vᵀ (dÔ·V̂ᵀ), operands in shared memory
      float sc[BKV / 2], dp[BKV / 2];
      score_products<BKV, HD, DP>(sc, dp, q_addr, k_addr, do_addr, v_addr);
      // p and ds in registers; the mask only on a tile not wholly visible
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) sc[e] = fast_exp2(sc[e] - ((e & 2) ? lse_b : lse_a));
      if (!tile_full(s, k0, k0 + BKV - 1, q0, q_last)) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
          if (!in_span((e & 2) ? span_b : span_a, kpos)) sc[e] = 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) sc[e] *= dp[e] - ((e & 2) ? dl_b : dl_a);
      // dQ += dS·K: dS (bf16) as the register A operand, K read MN-major
      uint32_t ds[BKV / 16][4];
      to_frags<BKV>(sc, ds);
      reg_fence(dq);
      wgmma_fence();
      rs_gemm<BKV, HD>(dq, ds, k_addr);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[i]);
    }
    if constexpr (NC == 2) {
      float* part = reinterpret_cast<float*>(stages) + wtid;
      consumers_sync();  // both done with the ring
      if (wg == 1) {
        fence_async_smem();
        put_part(dq, part);
      }
      consumers_sync();
      if (wg == 1) return;
      add_part(dq, part);
    }
    // dp: the rows carry σdo (ds = σdo·ds_raw), one multiply here
    const float sc_a = DP && qa < s.n_q ? p.sdo[base + qa] * LN2 : LN2;
    const float sc_b = DP && qb < s.n_q ? p.sdo[base + qb] * LN2 : LN2;
    store_rows<HD>(static_cast<bf16*>(p.dq), dq, t4, qa < s.n_q ? (long)(base + qa) : -1,
                   qb < s.n_q ? (long)(base + qb) : -1, sc_a, sc_b);
  }
}

// B5: dK and dV of one (64-row kv tile, bh_kv row), summed over the g
// query heads of its group.
template <int HD, int NC, bool DP>
__global__ void __launch_bounds__(128 * (NC + 1), DkvCfg<HD, NC, DP>::P::MINB)
    flash_bwd_dkv_tc(const __grid_constant__ Maps m, const BwdParams p) {
  using C = DkvCfg<HD, NC, DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::P::ST, PANELS = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem;                      // 64 rows of K, PANELS panels
  uint8_t* vs = smem + C::KBYTES;          // the same rows of V (V̂)
  uint8_t* stages = vs + C::VBYTES;        // ST × (Q, dO[, qs, dÔ], lse2 and Δ)
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(stages + ST * C::STAGE);
  uint64_t* full_bar = kv_bar + 1;
  uint64_t* empty_bar = full_bar + ST;

  const Sched s = p.s;
  const int kv_row = blockIdx.x;
  const int k0 = blockIdx.y * BKV, k_hi = min(k0 + BKV - 1, s.n_kv - 1);
  const int g = p.hq / p.hkv;
  const int q_row0 = (kv_row / p.hkv) * p.hq + (kv_row % p.hkv) * g;
  // the q tiles that see a key of this tile (the transposed visit); the
  // producer and the consumers walk the same range
  int first, last;
  q_range(s, k0, k_hi, BQ, first, last);
  const int per_head = max(0, last - first + 1);
  const int steps = g * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], 1 + 32);   // TMA's bytes and the producer warp's lanes
      mbar_init(&empty_bar[i], 4);       // lane 0 of the step's consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == NC) {
    // ---------------- producer: one warp ----------------
    reg_dealloc<C::PRODUCER>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, C::KBYTES + C::VBYTES);
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(ks + pn * 64 * 128, &m.k, pn * 128, k0, kv_row, kv_bar);
        for (int pn = 0; pn < C::VBYTES / (BKV * 128); ++pn)
          tma_load_3d(vs + pn * 64 * 128, &m.v, pn * 128, k0, kv_row, kv_bar);
      }
      for (int t = 0; t < steps; ++t) {
        const int i = t % ST, ph = (t / ST) & 1;
        const int bq = q_row0 + t / per_head, q0 = (first + t % per_head) * BQ;
        uint8_t* st = stages + i * C::STAGE;
        mbar_wait(&empty_bar[i], ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full_bar[i], C::TX);
          for (int pn = 0; pn < PANELS; ++pn) {
            tma_load_3d(st + pn * BQ * 128, &m.q, pn * 128, q0, bq, &full_bar[i]);
            tma_load_3d(st + C::TILE + pn * BQ * 128, &m.dout, pn * 128, q0, bq, &full_bar[i]);
            if constexpr (DP)
              tma_load_3d(st + C::QS_OFF + pn * BQ * 128, &m.qs, pn * 128, q0, bq,
                          &full_bar[i]);
          }
          if constexpr (DP)
            for (int pn = 0; pn < HD / 128; ++pn)
              tma_load_3d(st + C::DO8_OFF + pn * BQ * 128, &m.do8, pn * 128, q0, bq,
                          &full_bar[i]);
        }
        float* rows = reinterpret_cast<float*>(st + C::TX);
        const size_t base = (size_t)bq * s.n_q + q0;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < s.n_q;
          rows[r] = in ? p.lse2[base + r] : 0.0f;
          rows[BQ + r] = in ? p.delta[base + r] : 0.0f;
        }
        mbar_arrive(&full_bar[i]);
      }
    }
  } else {
    // ---------------- consumers: the 64 kv rows, steps in turn ----------------
    reg_alloc<C::CONSUMER>();
    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int ka = k0 + ra, kb = k0 + rb;
    // the queries that see each of the two rows (empty past n_kv)
    const Span span_a = query_span(s, ka), span_b = query_span(s, kb);
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk[i] = 0.0f;
      dv[i] = 0.0f;
    }
    const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
    mbar_wait(kv_bar, 0);

    for (int t = wg; t < steps; t += NC) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int q0 = (first + t % per_head) * BQ;
      uint8_t* st = stages + i * C::STAGE;
      mbar_wait(&full_bar[i], ph);
      const uint32_t q_addr = smem_u32(st), do_addr = smem_u32(st + C::TILE);
      const float* rows = reinterpret_cast<const float*>(st + C::TX);
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (V̂·dÔᵀ), operands in shared memory
      float sc[BQ / 2], dp[BQ / 2];
      score_products<BQ, HD, DP>(sc, dp, k_addr, q_addr, v_addr,
                                 DP ? smem_u32(st + C::DO8_OFF) : do_addr);
      // pᵀ and dsᵀ in registers, each column's lse2 and Δ from the stage;
      // the mask only on a tile not wholly visible
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[4 * j + c] = fast_exp2(sc[4 * j + c] - ((c & 1) ? l.y : l.x));
      }
      if (!(q0 + BQ - 1 < s.n_q && tile_full(s, k0, k0 + BKV - 1, q0, q0 + BQ - 1))) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int qpos = q0 + 8 * (e / 4) + 2 * t4 + (e & 1);
          if (!in_span((e & 2) ? span_b : span_a, qpos)) sc[e] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * t4);
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[4 * j + c] = sc[4 * j + c] * (dp[4 * j + c] - ((c & 1) ? dl.y : dl.x));
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q (qs under dp): register A operands,
      // dO and Q read MN-major
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_frags<BQ>(sc, pa);
      to_frags<BQ>(dp, da);
      reg_fence(dv);
      reg_fence(dk);
      wgmma_fence();
      rs_gemm<BQ, HD>(dv, pa, do_addr);
      rs_gemm<BQ, HD>(dk, da, DP ? smem_u32(st + C::QS_OFF) : q_addr);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dv);
      reg_fence(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[i]);
    }
    if constexpr (NC == 2) {
      float* part = reinterpret_cast<float*>(stages) + wtid;
      consumers_sync();  // both done with the ring
      if (wg == 1) {
        fence_async_smem();
        put_part(dk, part);
        put_part(dv, part + HD / 2 * 128);
      }
      consumers_sync();
      if (wg == 1) return;
      add_part(dk, part);
      add_part(dv, part + HD / 2 * 128);
    }
    const long base = (long)kv_row * s.n_kv;
    const long row_a = ka < s.n_kv ? base + ka : -1, row_b = kb < s.n_kv ? base + kb : -1;
    store_rows<HD>(static_cast<bf16*>(p.dk), dk, t4, row_a, row_b, LN2, LN2);
    store_rows<HD>(static_cast<bf16*>(p.dv), dv, t4, row_a, row_b, 1.0f, 1.0f);
  }
}

template <typename Kern>
cudaError_t launch_tc(Kern kern, dim3 grid, int threads, int smem, cudaStream_t stream,
                      const Maps& m, const BwdParams& p) {
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(m, p);
  return cudaGetLastError();
}

// the maps of p's operands with 64-row boxes (128-byte panels); a map over
// an empty sequence or of an operand the variant does not read is never
// read and takes another's place
template <int HD>
bool make_maps(Maps* m, const BwdParams& p, int bh) {
  const int bh_kv = bh / p.hq * p.hkv;
  const bool dp = p.v8 != nullptr;
  bool ok = true;
  if (p.s.n_q > 0) {
    ok = make_map<2 * HD, 64, 128>(&m->q, p.q, p.s.n_q, bh);
    m->dout = m->qs = m->do8 = m->q;
    if (ok && p.dout != nullptr) ok = make_map<2 * HD, 64, 128>(&m->dout, p.dout, p.s.n_q, bh);
    if (ok && p.qs != nullptr) ok = make_map<2 * HD, 64, 128>(&m->qs, p.qs, p.s.n_q, bh);
    if (ok && dp) ok = make_map<HD, 64, 128>(&m->do8, p.do8, p.s.n_q, bh);
  }
  if (ok && p.s.n_kv > 0) {
    ok = make_map<2 * HD, 64, 128>(&m->k, p.k, p.s.n_kv, bh_kv);
    if (ok)
      ok = dp ? make_map<HD, 64, 128>(&m->v, p.v8, p.s.n_kv, bh_kv)
              : make_map<2 * HD, 64, 128>(&m->v, p.v, p.s.n_kv, bh_kv);
  }
  if (p.s.n_q == 0) m->q = m->dout = m->qs = m->do8 = m->k;
  if (p.s.n_kv == 0) m->k = m->v = m->q;
  return ok;
}

template <int HD, bool DP>
cudaError_t launch_dq_tc(const BwdParams& p, int bh, cudaStream_t stream) {
  constexpr int NC = CONSUMERS<HD>;
  using C = DqCfg<HD, NC, DP>;
  Maps m;
  if (!make_maps<HD>(&m, p, bh)) return cudaErrorInvalidValue;
  const dim3 grid(bh, (p.s.n_q + C::BQ - 1) / C::BQ);
  return launch_tc(flash_bwd_dq_tc<HD, NC, DP>, grid, 128 * (NC + 1), C::P::SMEM, stream, m,
                   p);
}

template <int HD, bool DP>
cudaError_t launch_dkv_tc(const BwdParams& p, int bh_kv, cudaStream_t stream) {
  constexpr int NC = CONSUMERS<HD>;
  using C = DkvCfg<HD, NC, DP>;
  Maps m;
  if (!make_maps<HD>(&m, p, bh_kv / p.hkv * p.hq)) return cudaErrorInvalidValue;
  const dim3 grid(bh_kv, (p.s.n_kv + C::BKV - 1) / C::BKV);
  return launch_tc(flash_bwd_dkv_tc<HD, NC, DP>, grid, 128 * (NC + 1), C::P::SMEM, stream, m,
                   p);
}

// the schedule's arguments as B1 takes them (flash_fwd.cu:tf_flash_fwd)
bool bad_sched(int hq, int hkv, const Sched& s) {
  return hkv <= 0 || hq % hkv != 0 || !sched_ok(s);
}

// one entry's dispatch over dtype (0 = float32, 1 = bfloat16), width and dp
template <template <typename, int, bool> class Gen, template <int, bool> class Tc>
cudaError_t dispatch(const BwdParams& p, int rows, int d, int dtype, bool dp,
                     cudaStream_t stream) {
  if (dtype == 1 && d == 128)
    return dp ? Tc<128, true>::run(p, rows, stream) : Tc<128, false>::run(p, rows, stream);
  if (dp && d == 64) return cudaErrorInvalidValue;  // the reference ignores dp there
  if (dtype == 1 && d == 64) return Tc<64, false>::run(p, rows, stream);
  if (dtype == 1 && d == 256)
    return dp ? Gen<bf16, 256, true>::run(p, rows, stream)
              : Gen<bf16, 256, false>::run(p, rows, stream);
  if (dtype == 0 && d == 256)
    return dp ? Gen<float, 256, true>::run(p, rows, stream)
              : Gen<float, 256, false>::run(p, rows, stream);
  if (dtype == 0 && d == 128)
    return dp ? Gen<float, 128, true>::run(p, rows, stream)
              : Gen<float, 128, false>::run(p, rows, stream);
  if (dtype == 0 && d == 64) return Gen<float, 64, false>::run(p, rows, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int HD, bool DP> struct DqGen {
  static cudaError_t run(const BwdParams& p, int bh, cudaStream_t s) {
    return launch_dq<T, HD, DP>(p, bh, s);
  }
};
template <int HD, bool DP> struct DqTc {
  static cudaError_t run(const BwdParams& p, int bh, cudaStream_t s) {
    return launch_dq_tc<HD, DP>(p, bh, s);
  }
};
template <typename T, int HD, bool DP> struct DkvGen {
  static cudaError_t run(const BwdParams& p, int bh_kv, cudaStream_t s) {
    return launch_dkv<T, HD, DP>(p, bh_kv, s);
  }
};
template <int HD, bool DP> struct DkvTc {
  static cudaError_t run(const BwdParams& p, int bh_kv, cudaStream_t s) {
    return launch_dkv_tc<HD, DP>(p, bh_kv, s);
  }
};

}  // namespace

// q, dout: (bh, n_q, d), q prescaled; k, v: (bh / hq · hkv, n_kv, d);
// lse2 = clamped lse · log2(e) and delta: (bh, n_q) float32; dq like q.
// All contiguous, 16-byte aligned, one dtype (0 = float32, 1 = bfloat16).
// d ∈ {64, 128, 256} (the wrapper zero-pads other head and value dims).
// kind, offset, radius, section: the schedule (schedule.cuh; offset is the
// causal kind's n_kv − n_q or the shifted kinds' shift, section their wrap;
// circulant k/v are the halo-extended ones).
// dp: v8 (V̂, like v, int8), do8 (dÔ, like dout, int8) and sdo (σdo, like
// lse2) non-null, delta divided by σdo; v and dout are then not read; not
// at d 64. bf16 at 64 and 128 takes the TMA + wgmma kernel, the rest the
// WMMA/FMA one.
extern "C" cudaError_t tf_flash_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse2,
                                       const float* delta, void* dq, const void* v8,
                                       const void* do8, const float* sdo, int bh, int n_q,
                                       int n_kv, int hq, int hkv, int d, int kind, int offset,
                                       int radius, int section, int dtype,
                                       cudaStream_t stream) {
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  if (bad_sched(hq, hkv, Sched{n_q, n_kv, kind, offset, radius, section}) || bh % hq != 0 ||
      n_kv < 0)
    return cudaErrorInvalidValue;
  const bool dp = v8 != nullptr;
  if (dp && (do8 == nullptr || sdo == nullptr)) return cudaErrorInvalidValue;
  const BwdParams p{q,     k,     v,  dp ? nullptr : dout, v8,      do8,     nullptr,
                    sdo,   lse2,  delta, dq, nullptr, nullptr,
                    Sched{n_q, n_kv, kind, offset, radius, section}, hq, hkv};
  return dispatch<DqGen, DqTc>(p, bh, d, dtype, dp, stream);
}

// The same operands; dk, dv: like k, v; bh_kv = batch · hkv. dp: v8, do8
// and qs (q·σdo, like q) non-null, delta divided by σdo; v is then not
// read, dout still is (dV takes the exact dO).
extern "C" cudaError_t tf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse2,
                                        const float* delta, void* dk, void* dv, const void* v8,
                                        const void* do8, const void* qs, int bh_kv, int n_q,
                                        int n_kv, int hq, int hkv, int d, int kind, int offset,
                                        int radius, int section, int dtype,
                                        cudaStream_t stream) {
  if (bh_kv <= 0 || n_kv <= 0) return cudaSuccess;
  if (bad_sched(hq, hkv, Sched{n_q, n_kv, kind, offset, radius, section}) ||
      bh_kv % hkv != 0 || n_q < 0)
    return cudaErrorInvalidValue;
  const bool dp = v8 != nullptr;
  if (dp && (do8 == nullptr || qs == nullptr)) return cudaErrorInvalidValue;
  const BwdParams p{q,     k,       v,  dout,  v8, do8, qs,
                    nullptr, lse2, delta, nullptr, dk, dv,
                    Sched{n_q, n_kv, kind, offset, radius, section}, hq, hkv};
  return dispatch<DkvGen, DkvTc>(p, bh_kv, d, dtype, dp, stream);
}
