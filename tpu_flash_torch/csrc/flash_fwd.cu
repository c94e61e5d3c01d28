// B1: fused attention forward for Hopper, sm_90a.
//
// Replaces tpu_flash/ops/flash.py:_fwd_kernel (launched by _flash_fwd), the
// TPU kernel behind prefill: for each (batch·head row, q block) an online
// base-2 softmax over the visited kv blocks, GQA through the kv-row map
// (b // hq)·hkv + (b % hq) // g, o = 0 and lse = -inf for fully masked
// rows, lse in natural-log units. Two more TPU kernels fold into it:
// _fwd_kernel_band (flash.py:380, the local band with its kv slab streamed
// by a manual DMA) is the same band online softmax, kinds 2 and 3 below,
// and its circulant half is kind 4; _fwd_kernel_t (flash.py:711, the d <= 64
// transposed forward whose max IS the norm bound) is the bound mode below at
// d 64. The reference's block-diagonal schedule on _fwd_kernel is kind 5.
//
// Schedules (kind): 0 dense; 1 causal, right-aligned (key j visible to
// query i when j <= i + offset); 2 local, |i - j| <= radius, left-aligned;
// 3 local_causal, the band and j <= i; 4 circulant, over the halo-extended
// K/V cat(k[-r:], k, k[:r]) the wrapper builds: 0 <= j - i <= 2·radius (the
// wraparound band as a contiguous one, CirculantSchedule's _first_step and
// _last_block); 5 block-diagonal, i / section == j / section; 6 and 7 the
// ring hop (ShiftedMaskSchedule: query i at i + shift, an optional band,
// wrapped mod the ring's length, and under 7 j <= i + shift), masked per
// element by visible, its tiles the hull of the band. A q tile walks
// the kv tiles from max(0, q0 - radius) / BKV to min(last tile, (q_last +
// radius) / BKV) under the local kinds, stopping at q_last / BKV under
// local_causal (and at (q_last + offset) / BKV under causal); from q0 / BKV
// to (q_last + 2·radius) / BKV under the circulant; over the sections its
// rows fall in under the block-diagonal (tiles of other sections are never
// visited: the block skip; a section that is not a multiple of BKV, or a
// tile that spans two sections, masks per element). A tile wholly inside
// the visible region skips the per-element mask, as the reference's
// block_unmasked does; kv positions past n_kv (TMA's zero fill, the
// circulant's halo end) are never visible.
//
// Running max: exact, or (kmax != null) the constant norm bound
// m_i = ||q~_i|| * (max_j ||k_j|| * 1.0001), set once per row: no max pass,
// alpha = 1, no rescale (the reference's bound_max). kmax holds max_j
// ||k_j|| per kv row, one torch reduction in the wrapper, as the reference
// computes it in XLA outside its kernel.
//
// Numerics mirror the reference: q arrives prescaled by scale·log2(e) in
// float32 and cast back to its dtype (the wrapper does it); S = Q·Kᵀ
// accumulates in float32; the update is exp2; P is cast to V's dtype before
// P·V; l sums the float32 p; masked scores take DEFAULT_MASK_VALUE
// (-0.7·FLT_MAX), not -inf; the finish is o = acc·(1/l), lse = m·ln2 +
// log(l), and a row is valid only when l > 0 and m > DEFAULT_MASK_VALUE/2.
// The bf16 kernel takes 2^x from ex2.approx (relative error below 2^-22,
// results under 2^-126 flushed to 0), as B6/B7 do: the SFU instruction
// keeps the softmax off the FMA pipe, and o and lse stay within their
// kernel-vs-plain limits (lse 1e-4); the float32 kernel keeps exp2f.
//
// What bounds it on an H100: at the serving prefill (n = 1024, d = 128,
// 16 q heads) it is tensor-core FLOPs, 4·n²·d/2·heads ≈ 4.3 GFLOP causal
// against ~33 MB of q/k/v/o traffic, far right of the ~295 FLOP/B ridge;
// a band of radius 512 at n 2048 keeps about half of the causal work; the
// circulant (n 8192, w 1025) and block-diagonal (section 512) kinds visit
// about (2r + BKV)/BKV and section/BKV kv tiles a q tile, the same loop.
//
// Design, bf16 (FA-3 shaped, the B6/B7 layout of quant_attention.cu
// without the decode). One CTA per (q tile, bh row), q tiles the slow grid
// axis so that under the causal schedule the heaviest q tiles of every head
// launch first; the q heads of a kv head are neighbours in blockIdx.x.
// - The producer warpgroup's first thread issues TMA (tensor maps over
//   (bh, n, d) for q and (bh_kv, n_kv, d) for k and v, 64-column panels
//   with the 128-byte swizzle): the Q tile once, then K and V tiles into a
//   2–3 stage ring of full/empty mbarriers; TMA zero-fills rows past n. It
//   gives its registers to the consumers (setmaxnreg).
// - Each consumer warpgroup owns 64 q rows. S = Q·Kᵀ on wgmma
//   m64n64k16 with both operands in shared memory; the masks, the row
//   max and sum (quad shuffles on the accumulator layout) and the rescale
//   of O in registers; P (bf16) is the register A operand of P·V, V read
//   MN-major through wgmma's transpose bit; O stays in registers until
//   the finish. The per-element mask runs only on a tile that is not
//   wholly visible to the warpgroup's own rows.
// - Tiles: at d <= 128 one consumer (BQ 64) and BKV 64, two CTAs an SM, so
//   that one CTA's softmax overlaps the other's products; at d 256 two
//   consumers (BQ 128; two CTAs would not fit) and BKV 64; at d 512 one
//   consumer, BKV 32 and O split over the grid in 256-column halves, each
//   half recomputing S over the full width (O for 64 rows × 512 columns
//   would take 256 float32 registers a thread): twice the QK products, one
//   CTA an SM; as many ring stages as fit (TcCfg). BQ 64 measured faster than 128 (two consumers,
//   BKV 128) at the serving and the training shape (PERF.md §6).
// float32 inputs run flash_fwd_f32.cuh's kernel (flash_fwd_f32.cu, widths
// 64 and 128; flash_fwd_f32_wide.cu, 256 and 512): every product in three
// TF32 passes on wgmma behind a TMA ring, at 256 and 512 the head dim split
// across a 2- or 4-CTA cluster; p stays float32 and comes from exact exp2f.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"
#include "hopper.cuh"
#include "schedule.cuh"

namespace {

using bf16 = __nv_bfloat16;

// DEFAULT_MASK_VALUE = -0.7 * float32 max, rounded to float32.
constexpr float MASK = -0x1.666664p+127f;
constexpr float LN2 = 0.693147180559945309f;
constexpr float BOUND_SLACK = 1.0001f;  // the reference's factor
constexpr int SMEM_LIMIT = 232448;      // the 227 KB a block may use
constexpr int SM_SMEM = 233472;         // shared memory of an SM (228 KB)

// ------------------------------------------------------- bf16: TMA + wgmma

// Tiles and the shared-memory plan of one head width: NC consumer
// warpgroups of 64 q rows (one at d <= 128 and at 512, two at d 256, where
// two CTAs an SM would not fit) and BKV-row K/V tiles. A CTA owns HV of
// O's columns: all of them, or at width 512 one 256-column half (the grid's
// z axis), since 64 rows × 512 float32 columns would take 256 registers a
// thread; each half recomputes S = Q·Kᵀ over the full 512 and loads only
// its half of V. At 512 the 64 KB Q tile leaves room for three stages of
// 32-row K (32 KB) and V-half (16 KB) tiles, one CTA an SM, whose 256
// threads may hold 255 registers each: no setmaxnreg (ptxas needs more than
// the 128 a thread of two CTAs an SM would start with for the 256-column
// P·V).
template <int HD> struct TcCfg {
  static constexpr int NC = HD == 256 ? 2 : 1;
  static constexpr int BQ = 64 * NC;
  static constexpr int HV = HD == 512 ? 256 : HD;
  static constexpr int BKV = HD == 512 ? 32 : 64;
  static constexpr int MINB = NC == 1 && HD != 512 ? 2 : 1;  // CTAs an SM
  static constexpr int QBYTES = BQ * HD * 2;
  static constexpr int KTILE = BKV * HD * 2;    // one K tile
  static constexpr int VTILE = BKV * HV * 2;    // one V tile (this CTA's columns)
  static constexpr int STAGE = KTILE + VTILE;
  static constexpr int BUDGET = MINB == 2 ? SM_SMEM / 2 - 1024 : SMEM_LIMIT;
  static constexpr int bytes(int st) {
    // 1024 of alignment slack, Q, the stages, the Q barrier and two a stage
    return 1024 + QBYTES + st * STAGE + (2 * st + 1) * 8;
  }
  static constexpr int ST = bytes(3) <= BUDGET ? 3 : 2;
  static constexpr int SMEM = bytes(ST);
  static_assert(SMEM <= BUDGET, "above the shared memory a block may use");
  static_assert(QBYTES % 1024 == 0 && KTILE % 1024 == 0 && VTILE % 1024 == 0,
                "swizzled tiles need 1024-byte bases");
};

struct TcParams {
  bf16* o;            // (bh, n_q, HD)
  float* lse;         // (bh, n_q) or null
  const float* kmax;  // (bh_kv) or null
  Sched s;
  int hq, hkv;
};

// Σ x² of the 8 bf16 in 16 bytes
__device__ __forceinline__ float sumsq8(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
    s = fmaf(lo, lo, s);
    s = fmaf(hi, hi, s);
  }
  return s;
}

template <int HD>
__global__ void __launch_bounds__(128 * (TcCfg<HD>::NC + 1), TcCfg<HD>::MINB)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tmap_q,
                 const __grid_constant__ CUtensorMap tmap_k,
                 const __grid_constant__ CUtensorMap tmap_v, const TcParams p) {
  using C = TcCfg<HD>;
  constexpr int NC = C::NC, BQ = C::BQ, BKV = C::BKV, ST = C::ST, PANELS = HD / 64;
  constexpr int HV = C::HV;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = smem;                   // NC × 64 rows of Q, PANELS panels each
  uint8_t* stages = smem + C::QBYTES;   // ST × (K, V)
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(stages + ST * C::STAGE);
  uint64_t* full_bar = q_bar + 1;
  uint64_t* empty_bar = full_bar + ST;

  const Sched s = p.s;
  const int n_tiles = (s.n_q + BQ - 1) / BQ;
  // the heaviest causal q tiles first
  const int qt = s.kind == CAUSAL ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x, half = blockIdx.z;  // half: O's columns [half·HV, +HV)
  const int q0 = qt * BQ, q_last = min(q0 + BQ - 1, s.n_q - 1);
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  int first, last;
  kv_range(s, q0, q_last, BKV, first, last);
  const int steps = max(0, last - first + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], 1);
      mbar_init(&empty_bar[i], 4 * NC);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == NC) {
    // ---------------- producer: one TMA thread ----------------
    if constexpr (HD != 512) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (wtid == 0) {
      mbar_expect_tx(q_bar, C::QBYTES);
      for (int w = 0; w < NC; ++w)
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(qs + w * 64 * HD * 2 + pn * 64 * 128, &tmap_q, pn * 128, q0 + 64 * w,
                      b, q_bar);
      for (int t = 0; t < steps; ++t) {
        const int i = t % ST, ph = (t / ST) & 1;
        mbar_wait(&empty_bar[i], ph ^ 1);
        uint8_t* st = stages + i * C::STAGE;
        const int k0 = (first + t) * BKV;
        mbar_expect_tx(&full_bar[i], C::STAGE);
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(st + pn * BKV * 128, &tmap_k, pn * 128, k0, kv_row, &full_bar[i]);
        for (int pn = 0; pn < HV / 64; ++pn)
          tma_load_3d(st + C::KTILE + pn * BKV * 128, &tmap_v, (half * HV / 64 + pn) * 128,
                      k0, kv_row, &full_bar[i]);
      }
    }
  } else {
    // ---------------- consumers: 64 q rows each ----------------
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    else if constexpr (HD != 512) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;");
    const int qw0 = q0 + 64 * wg, qw_last = min(qw0 + 63, s.n_q - 1);
    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int qa = qw0 + ra, qb = qw0 + rb;
    uint8_t* qw = qs + wg * 64 * HD * 2;
    mbar_wait(q_bar, 0);

    const bool bound = p.kmax != nullptr;
    float ma = MASK, mb = MASK;
    if (bound) {
      // ‖q̃‖ of rows ra, rb from the staged tile (16-byte chunks stay whole
      // under the swizzle), times max‖k‖·1.0001: the constant max
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int c = t4; c < HD / 8; c += 4) {
        sa += sumsq8(*reinterpret_cast<const uint4*>(qw + tile_off<128, 64>(ra, 16 * c)));
        sb += sumsq8(*reinterpret_cast<const uint4*>(qw + tile_off<128, 64>(rb, 16 * c)));
      }
      const float kb = p.kmax[kv_row] * BOUND_SLACK;
      ma = sqrtf(quad_sum(sa)) * kb;
      mb = sqrtf(quad_sum(sb)) * kb;
    }
    float la = 0.0f, lb = 0.0f;
    float o[HV / 2];
#pragma unroll
    for (int i = 0; i < HV / 2; ++i) o[i] = 0.0f;
    const uint32_t q_addr = smem_u32(qw);

    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int k0 = (first + t) * BKV;
      uint8_t* st = stages + i * C::STAGE;
      mbar_wait(&full_bar[i], ph);

      // S = Q·Kᵀ on the tensor cores, operands in shared memory
      float sc[BKV / 2];
      {
        const uint32_t k_addr = smem_u32(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int colb = 32 * kk;
          const uint64_t da = desc<128>(q_addr + (colb / 128) * 64 * 128 + colb % 128);
          const uint64_t db = desc<128>(k_addr + (colb / 128) * BKV * 128 + colb % 128);
          wgmma_bf16_bf16<BKV>(sc, da, db, kk);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(sc);
      }

      // masks and the online softmax, in registers
      if (!tile_full(s, k0, k0 + BKV - 1, qw0, qw_last)) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
          if (!visible(s, (e & 2) ? qb : qa, kpos)) sc[e] = MASK;
        }
      }
      float alpha_a = 1.0f, alpha_b = 1.0f;
      if (!bound) {  // the exact running max; the bound needs no rescale
        float mxa = MASK, mxb = MASK;
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          if (e & 2) mxb = fmaxf(mxb, sc[e]);
          else mxa = fmaxf(mxa, sc[e]);
        }
        const float na = fmaxf(ma, quad_max(mxa)), nb = fmaxf(mb, quad_max(mxb));
        alpha_a = fast_exp2(ma - na);
        alpha_b = fast_exp2(mb - nb);
        ma = na;
        mb = nb;
#pragma unroll
        for (int j = 0; j < HV / 8; ++j) {
          o[4 * j] *= alpha_a;
          o[4 * j + 1] *= alpha_a;
          o[4 * j + 2] *= alpha_b;
          o[4 * j + 3] *= alpha_b;
        }
      }
      float psa = 0.0f, psb = 0.0f;
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const float pr = fast_exp2(sc[e] - ((e & 2) ? mb : ma));
        if (e & 2) psb += pr;
        else psa += pr;
        sc[e] = pr;
      }
      la = alpha_a * la + quad_sum(psa);
      lb = alpha_b * lb + quad_sum(psb);

      // O += P·V: P (bf16) as the register A operand, V in shared memory
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      const uint32_t v_addr = smem_u32(st + C::KTILE);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs_bf16<HV, 1>(o, pa[kk], desc_mn(v_addr + kk * 16 * 128, BKV * 128));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[i]);
    }

    // finish: o = acc / l, lse = m·ln2 + log(l); dead rows give 0, -inf
    const bool va = la > 0.0f && ma > MASK * 0.5f, vb = lb > 0.0f && mb > MASK * 0.5f;
    const float ia = va ? 1.0f / la : 0.0f, ib = vb ? 1.0f / lb : 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // the thread's rows ra, rb
      const int qpos = hr ? qb : qa;
      if (qpos >= s.n_q) continue;
      const float inv = hr ? ib : ia;
      const size_t row = (size_t)b * s.n_q + qpos;
#pragma unroll
      for (int j = 0; j < HV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(p.o + row * HD + half * HV + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      if (p.lse != nullptr && t4 == 0 && half == 0) {
        const float l = hr ? lb : la, m = hr ? mb : ma;
        p.lse[row] = (hr ? vb : va) ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
      }
    }
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const TcParams& p, int bh,
                      int dv, cudaStream_t stream) {
  using C = TcCfg<HD>;
  const int bh_kv = bh / p.hq * p.hkv;
  CUtensorMap mq, mk, mv;
  if (!make_map<2 * HD, 64, 128>(&mq, q, p.s.n_q, bh)) return cudaErrorInvalidValue;
  if (p.s.n_kv == 0) {  // no kv tile is visited: the maps are never read
    mk = mq;
    mv = mq;
  } else if (!make_map<2 * HD, C::BKV, 128>(&mk, k, p.s.n_kv, bh_kv) ||
             !make_map<2 * HD, C::BKV, 128>(&mv, v, p.s.n_kv, bh_kv)) {
    return cudaErrorInvalidValue;
  }
  auto kern = flash_fwd_tc<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.s.n_q + C::BQ - 1) / C::BQ;
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  const int halves = (dv + C::HV - 1) / C::HV;  // O's column blocks that hold the dv
  kern<<<dim3(bh, n_tiles, halves), 128 * (C::NC + 1), C::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, n_q, d) prescaled; k, v: (bh / hq · hkv, n_kv, d); o like q;
// lse: (bh, n_q) float32 or null; kmax: (bh / hq · hkv,) float32 max key
// norm per kv row for the norm-bound max, or null for the exact max. All
// contiguous, 16-byte aligned. kind: 0 dense, 1 causal (offset), 2 local,
// 3 local_causal (radius), 4 circulant (radius; k, v halo-extended, n_kv =
// n + 2·radius), 5 block-diagonal (section), 6 shifted and 7
// shifted_causal (offset the shift, radius -1 or the band, section the
// wrap, 0 or at least n_q and n_kv). dtype: 0 = float32, 1 = bfloat16,
// 2 = float32 on one TF32 pass (hi·hi alone: the checks' planted fault,
// which no user path takes). d ∈ {64, 128, 256, 512}, the width of q, k, v
// and o (the wrapper zero-pads other head and value dims up to the next of
// these); dv <= d, the value dim the caller reads: at 512 the bf16 kernel
// computes only the 256-column halves of o that hold it, and in float32 at
// 256 and 512 a CTA whose 128 columns lie past it writes none of o.
extern "C" cudaError_t tf_flash_fwd(const void* q, const void* k, const void* v,
                                    void* o, float* lse, const float* kmax,
                                    int bh, int n_q, int n_kv, int hq, int hkv,
                                    int d, int dv, int kind, int offset, int radius,
                                    int section, int dtype, cudaStream_t stream) {
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  const Sched sc{n_q, n_kv, kind, offset, radius, section};
  if (hkv <= 0 || hq % hkv != 0 || bh % hq != 0 || n_kv < 0 || dv < 1 || dv > d ||
      !sched_ok(sc))
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    const TcParams p{static_cast<bf16*>(o), lse, kmax, sc, hq, hkv};
    if (d == 128) return launch_tc<128>(q, k, v, p, bh, dv, stream);
    if (d == 64) return launch_tc<64>(q, k, v, p, bh, dv, stream);
    if (d == 256) return launch_tc<256>(q, k, v, p, bh, dv, stream);
    if (d == 512) return launch_tc<512>(q, k, v, p, bh, dv, stream);
  } else if (dtype == 0 || dtype == 2) {
    const tf_fwd::F32Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), static_cast<float*>(o), lse, kmax,
                              bh, n_q, n_kv, kind, offset, radius, section, hq, hkv, dv,
                              dtype == 0 ? 3 : 1};
    return tf_fwd::launch_f32(p, d, stream);
  }
  return cudaErrorInvalidValue;
}
