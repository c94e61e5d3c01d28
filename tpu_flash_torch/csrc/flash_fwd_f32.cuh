// B1 in float32 for Hopper (sm_90a): 3×TF32 on wgmma behind a TMA ring, at
// every compiled width. flash_fwd_f32.cu instantiates widths 64 and 128,
// flash_fwd_f32_wide.cu widths 256 and 512 (the head dim split across a
// thread-block cluster); flash_fwd.cu's entry point dispatches to them
// (tf_fwd::launch_f32). Schedules, masks, GQA, the norm-bound max and the
// finish are those described at the top of flash_fwd.cu; p comes from exact
// exp2f and stays float32 (the reference casts P to V's dtype).
//
// Replaces, in float32, tpu_flash/ops/flash.py:_fwd_kernel, its band half
// _fwd_kernel_band and its norm-bound d <= 64 kernel _fwd_kernel_t, which
// an FMA kernel held before (deleted).
//
// What bounds it: two products of 2·d FLOP a visible (query, key) pair,
// each taken in three TF32 passes at the tf32 peak (495 TFLOP/s); at the
// training shapes that is ~25× the bytes' time.
//
// Products (tf32.cuh, as flash_bwd_f32.cuh describes them): each operand
// split into hi (the tensor cores read a float32 word's top 19 bits) and
// lo = x − hi, hi·hi + hi·lo + lo·hi on wgmma m64nNk8 with float32 sums, the
// hi·hi chain and the small products' chain summed apart, each step's
// product in a fresh accumulator added to the running sum in registers.
//
// Layout. tf32 wgmma has no transpose bit: both operands K-major in shared
// memory, or A in registers. S = Q·Kᵀ takes Q as A, loaded from the
// resident Q tile into registers and split there, and K as B, staged
// K-major as TMA writes it, with a lo tile beside it that the producer
// warpgroup writes. The output runs transposed, Oᵀ += Vᵀ·Pᵀ: Vᵀ is A, its
// fragments read transposed from the staged V tile and split in registers
// (V needs no lo tile); P is B, written by the softmax as a [q][key] tile,
// raw and lo (B4's dQᵀ += Kᵀ·dS). A row's rescale α is then a column scale
// of Oᵀ, handed over through shared memory, as 1/l is at the finish; O is
// stored transposed.
//
// A CTA takes 128 q rows: a producer warpgroup whose first thread issues
// TMA (Q once, then K and V into a ring of stages on full/empty mbarriers)
// and whose 128 threads then write the stage's K lo tile and arrive on its
// ready barrier; two consumer warpgroups (setmaxnreg), each with 64 q rows
// of its own: S, the masks, the online softmax, P and α into its own tiles,
// a warpgroup barrier, its Oᵀ. The two share the stages and nothing else,
// so one's products run beside the other's softmax. A consumer skips the kv
// tiles its rows do not see (the diagonal half of a causal q tile). Timed
// beside it on the card (PERF.md §6): one consumer taking S, the
// softmax and P and the other Oᵀ a step behind, on 64-row q tiles, ran
// 17–32% faster where the grid is one wave (b 1 at d 64, 128 and 512) but
// 12–18% slower at d 256 and at both training shapes, and went. Of the
// tiles timed the same way, 32-key steps at 256 (16 before) took 31% off
// there, Oᵀ's chunks of four k8 steps (two before) 5% at d 64, and a
// fourth or fifth stage under a cluster under 1%.
// Shared memory sets the tiles (every B operand carries its lo tile): at
// d 128 steps of 32 keys, two stages (K, V, K lo: 48 KB) beside 64 KB of Q
// and 32 KB of P; at d 64 steps of 64 keys, two stages. Oᵀ's fragments load
// in chunks of four k8 steps (two at 16 keys).
//
// Widths 256 and 512: a CTA holds one 128-column slice of the head dim, CL
// = d / 128 CTAs a cluster along x (2 at 256, 4 at 512), each a width-128
// CTA of the layout above on its slice. The score product over a slice is
// a partial sum; each consumer pushes its partial by st.async into its slot
// in every peer and adds the CL partials in rank order (tf32.cuh's
// cluster_sum): every CTA holds the same S bit for bit and computes the
// same m, l and P itself, and sums only its own Oᵀ slice. A CTA whose slice
// lies past the caller's dv loads no V and writes no O; rank 0 writes lse.
// Under the norm bound each CTA reads the q rows' whole width from device
// memory for ‖q̃‖, the same sum in every CTA. At 256 (CL 2) steps of 32
// keys, two stages, the slots 32 KB; at 512 (CL 4) the slots of 32-key
// steps (96 KB) would not fit beside a stage: steps of 16 keys, three
// stages, P's lo part in the right half of its 128-byte rows. Every CTA
// starts after a cluster barrier and ends at one (no CTA exits while a peer
// may still store into it); the launch names the cluster and is refused
// unless cudaOccupancyMaxActiveClusters finds room for one.
//
// No atomics: one writer an output element, a fixed summation order,
// bitwise repeatable.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"
#include "hopper.cuh"
#include "schedule.cuh"
#include "tf32.cuh"

namespace {

using tf_fwd::F32Params;

// DEFAULT_MASK_VALUE = -0.7 * float32 max, rounded to float32.
constexpr float MASK = -0x1.666664p+127f;
constexpr float LN2 = 0.693147180559945309f;
constexpr float BOUND_SLACK = 1.0001f;  // the reference's factor
constexpr int SMEM_LIMIT = 232448;      // the 227 KB a block may use

// Tiles and the shared-memory plan of a CTA of HD columns (the width, or a
// 128-column slice of CL): two consumers × 64 q rows of Q, their P tiles
// ([q][key], raw and lo; at 16 keys lo fills the right half of raw's
// 128-byte rows, LO_COL bytes right), their row vectors (α by step parity,
// then 1/l), under a cluster the partials' slots, and as many stages of
// K, V and K lo as fit (up to 3), with a barrier for Q, three a stage and
// under a cluster the partials' four.
template <int HD, int CL> struct FwdCfg {
  static_assert(CL == 1 || HD == 128, "a cluster splits the head dim into 128-column slices");
  static constexpr int BQ = 128;  // two consumers of 64 rows
  static constexpr int BKV = HD == 64 ? 64 : CL == 4 ? 16 : 32;
  static constexpr int QT = 64 * HD * 4;   // one consumer's Q tile
  static constexpr int KT = BKV * HD * 4;  // a K (V, K lo) tile
  static constexpr int TX = 2 * KT;        // TMA bytes a stage: K, V
  static constexpr int STAGE = 3 * KT;
  static constexpr bool PACK = BKV < 32;
  static constexpr int PT = 64 * (PACK ? 32 : BKV) * 4;  // P raw (with lo when packed)
  static constexpr int P_LO = PACK ? 0 : PT, LO_COL = PACK ? 64 : 0;
  static constexpr int PBYTES = 2 * (PT + P_LO);
  static constexpr int ROWV = 2 * 2 * 64 * 4;  // [consumer][parity][row]
  static constexpr int CH = 4, CHG = BKV >= 32 ? 4 : 2;  // fragment chunks: S, Oᵀ
  using X = Xch<CL, BKV>;
  static constexpr int FIXED = 1024 + 2 * QT + PBYTES + ROWV + X::SLOTS;
  static constexpr int bytes(int st) {
    return FIXED + st * STAGE + (3 * st + 1 + (CL > 1 ? 4 : 0)) * 8;
  }
  static constexpr int ST = bytes(3) <= SMEM_LIMIT ? 3 : 2;
  static constexpr int SMEM = bytes(ST);
  static_assert(SMEM <= SMEM_LIMIT, "above the shared memory a block may use");
  static_assert(QT % 1024 == 0 && KT % 1024 == 0 && PT % 1024 == 0,
                "swizzled tiles need 1024-byte bases");
};

// the tensor maps: q over (bh, n_q) rows, k and v over (bh_kv, n_kv) rows,
// boxes of 128 bytes (a panel of 32 columns) × 64 q rows or × BKV keys
struct FwdMaps {
  CUtensorMap q, k, v;
};

// B1 on one (128-row q tile, bh row), or on its 128-column slice (rank)
// under a cluster of CL.
template <int HD, int CL>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_tf32(const __grid_constant__ FwdMaps m, const F32Params p) {
  using C = FwdCfg<HD, CL>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::ST, PANELS = HD / 32, MT = HD / 64;
  constexpr int D = HD * CL;  // the head dim, the rows' pitch
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                                    // 2 × 64 rows of Q
  uint8_t* ps = qs + 2 * C::QT;                          // 2 × P [q][key]
  float* rowv = reinterpret_cast<float*>(ps + C::PBYTES);  // 2 × 2 × 64
  float* xch = reinterpret_cast<float*>(ps + C::PBYTES + C::ROWV);  // CL > 1: partials
  uint8_t* stages = ps + C::PBYTES + C::ROWV + C::X::SLOTS;  // ST × (K, V, K lo)
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(stages + ST * C::STAGE);
  uint64_t* full_bar = q_bar + 1;
  uint64_t* ready_bar = full_bar + ST;
  uint64_t* empty_bar = ready_bar + ST;
  uint64_t* x_bar = empty_bar + ST;  // CL > 1: the partials' four barriers

  const Sched s{p.n_q, p.n_kv, p.kind, p.offset, p.radius, p.section};
  const int n_tiles = (s.n_q + BQ - 1) / BQ;
  // the heaviest causal q tiles first
  const int qt = s.kind == CAUSAL ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x / CL;
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int col0 = HD * rank;  // this CTA's columns [col0, col0 + HD)
  const bool with_v = col0 < p.dv;
  const int q0 = qt * BQ, q_last = min(q0 + BQ - 1, s.n_q - 1);
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  int first, last;
  kv_range(s, q0, q_last, BKV, first, last);
  const int steps = max(0, last - first + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], 1);
      mbar_init(&ready_bar[i], 128);  // the producer warpgroup's threads
      mbar_init(&empty_bar[i], 8);    // lane 0 of both consumers' warps
    }
    if constexpr (CL > 1)
      for (int i = 0; i < 4; ++i) {  // armed for steps 0 and 1: the peers' partials' bytes
        mbar_init(&x_bar[i], 1);
        mbar_expect_tx(&x_bar[i], C::X::BUF * (CL - 1));
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (CL > 1)
    cluster_sync();  // the peers' barriers initialised before any remote arrival
  else
    __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == 2) {
    // ---------------- producer: TMA, then K's lo tile ----------------
    reg_dealloc<PRODUCER>();
    if (wtid == 0) {
      mbar_expect_tx(q_bar, 2 * C::QT);
      for (int w = 0; w < 2; ++w)
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(qs + w * C::QT + pn * 64 * 128, &m.q, (PANELS * rank + pn) * 128,
                      q0 + 64 * w, b, q_bar);
    }
    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      uint8_t* st = stages + i * C::STAGE;
      if (wtid == 0) {
        const int k0 = (first + t) * BKV;
        mbar_wait(&empty_bar[i], ph ^ 1);
        mbar_expect_tx(&full_bar[i], with_v ? C::TX : C::KT);
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(st + pn * BKV * 128, &m.k, (PANELS * rank + pn) * 128, k0, kv_row,
                      &full_bar[i]);
        if (with_v)
          for (int pn = 0; pn < PANELS; ++pn)
            tma_load_3d(st + C::KT + pn * BKV * 128, &m.v, (PANELS * rank + pn) * 128, k0,
                        kv_row, &full_bar[i]);
      }
      mbar_wait(&full_bar[i], ph);
      split_pass<C::KT>(st, st + C::TX, wtid);
      fence_async_smem();
      mbar_arrive(&ready_bar[i]);
    }
  } else {
    // ---------------- consumers: 64 q rows each ----------------
    reg_alloc<CONSUMER>();
    // this thread's two rows of S (ra, rb; Oᵀ's head-dim rows alike)
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int qw0 = q0 + 64 * wg, qw_last = min(qw0 + 63, s.n_q - 1);
    const int qa = qw0 + ra, qb = qw0 + rb;
    // the kv tiles this consumer's rows see (none past n_q)
    int wfirst, wlast;
    kv_range(s, qw0, qw_last, BKV, wfirst, wlast);
    if (qw0 >= s.n_q) wlast = wfirst - 1;
    uint8_t* p_raw = ps + wg * (C::PT + C::P_LO);
    const uint32_t p_raw_a = smem_u32(p_raw), p_lo_a = smem_u32(p_raw + C::P_LO) + C::LO_COL;
    float* rv = rowv + wg * 128;  // [parity][row]
    const FragRows<64> fq(qs + wg * C::QT, ra, t4);
    // this consumer's slots and barriers of the cluster's partials
    float* slots = xch + 2 * wg * (CL - 1) * (C::X::BUF / 4);
    uint64_t* bars = &x_bar[2 * wg];

    const bool bound = p.kmax != nullptr;
    float ma = MASK, mb = MASK;
    if (bound) {
      // ‖q̃‖ of rows qa, qb over the whole head dim from device memory (the
      // same sum in every CTA of a cluster), times max‖k‖·1.0001: the
      // constant max
      const float* ya = p.q + ((size_t)b * s.n_q + min(qa, s.n_q - 1)) * D;
      const float* yb = p.q + ((size_t)b * s.n_q + min(qb, s.n_q - 1)) * D;
      float sa = 0.0f, sb = 0.0f;
      for (int c = t4; c < D / 4; c += 4) {
        const float4 x = reinterpret_cast<const float4*>(ya)[c];
        const float4 y = reinterpret_cast<const float4*>(yb)[c];
        sa = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, sa))));
        sb = fmaf(y.x, y.x, fmaf(y.y, y.y, fmaf(y.z, y.z, fmaf(y.w, y.w, sb))));
      }
      const float kb = p.kmax[kv_row] * BOUND_SLACK;
      ma = sqrtf(quad_sum(sa)) * kb;
      mb = sqrtf(quad_sum(sb)) * kb;
    }
    float la = 0.0f, lb = 0.0f;
    float o[MT][32];  // Oᵀ: head-dim slices of 64 × the 64 q rows
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[mt][e] = 0.0f;
    mbar_wait(q_bar, 0);

    int u = 0;  // the steps this consumer has taken (the tiles its rows see)
    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int kt = first + t, k0 = kt * BKV;
      const uint8_t* st = stages + i * C::STAGE;
      mbar_wait(&full_bar[i], ph);
      mbar_wait(&ready_bar[i], ph);
      if (kt >= wfirst && kt <= wlast) {
        // S = Q·Kᵀ (the cluster's sum of its slices' partials)
        float x[BKV / 2];
        {
          float part[BKV / 2];
          float (&sc)[BKV / 2] = CL > 1 ? part : x;
          gemm3<BKV, HD / 8, C::CH>(sc, fq, smem_u32(st), smem_u32(st + C::TX), p.tf32_passes);
          if constexpr (CL > 1) cluster_sum<CL, BKV>(part, x, u, slots, bars, rank, wtid, wg);
        }
        // masks and the online softmax, in registers; masked scores at
        // MASK, the mask only on a tile not wholly visible to the rows
        if (!tile_full(s, k0, k0 + BKV - 1, qw0, qw_last)) {
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) {
            const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
            if (!visible(s, (e & 2) ? qb : qa, kpos)) x[e] = MASK;
          }
        }
        float alpha_a = 1.0f, alpha_b = 1.0f;
        if (!bound) {  // the exact running max; the bound needs no rescale
          float mxa = MASK, mxb = MASK;
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) {
            if (e & 2) mxb = fmaxf(mxb, x[e]);
            else mxa = fmaxf(mxa, x[e]);
          }
          const float na = fmaxf(ma, quad_max(mxa)), nb = fmaxf(mb, quad_max(mxb));
          alpha_a = exp2f(ma - na);
          alpha_b = exp2f(mb - nb);
          ma = na;
          mb = nb;
        }
        float psa = 0.0f, psb = 0.0f;
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const float pr = exp2f(x[e] - ((e & 2) ? mb : ma));
          if (e & 2) psb += pr;
          else psa += pr;
          x[e] = pr;
        }
        la = alpha_a * la + quad_sum(psa);
        lb = alpha_b * lb + quad_sum(psb);
        if (with_v) {
          // P (raw and lo) and the rows' α into this consumer's tiles; α by
          // the step's parity, so that a row's α of this step does not
          // overwrite the last step's before every thread has read it
          put_tile<BKV>(x, p_raw, p_raw + C::P_LO, ra, rb, t4, C::LO_COL);
          float* al = rv + (u & 1) * 64;
          if (t4 == 0) {
            al[ra] = alpha_a;
            al[rb] = alpha_b;
          }
          fence_async_smem();
          consumer_sync(wg);
          // Oᵀ = α∘Oᵀ + Vᵀ·Pᵀ, each head-dim slice's product fresh, the sum
          // taken in registers (a column scale: Oᵀ's columns are q rows)
          const FragCols<BKV> fv(st + C::KT, ra, t4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float part[32];
            gemm3<64, BKV / 8, C::CHG>(part, FragColsAt<BKV>{fv, 64 * mt}, p_raw_a, p_lo_a,
                                       p.tf32_passes);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 a2 = *reinterpret_cast<const float2*>(al + 8 * j + 2 * t4);
              o[mt][4 * j] = o[mt][4 * j] * a2.x + part[4 * j];
              o[mt][4 * j + 1] = o[mt][4 * j + 1] * a2.y + part[4 * j + 1];
              o[mt][4 * j + 2] = o[mt][4 * j + 2] * a2.x + part[4 * j + 2];
              o[mt][4 * j + 3] = o[mt][4 * j + 3] * a2.y + part[4 * j + 3];
            }
          }
        }
        ++u;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[i]);
    }

    // finish: o = Oᵀ transposed times 1/l (0 on a dead row: l = 0, or no
    // key seen under the exact max), lse = m·ln2 + log(l) or −inf
    const bool va = la > 0.0f && ma > MASK * 0.5f, vb = lb > 0.0f && mb > MASK * 0.5f;
    if (with_v) {
      float* il = rv + (u & 1) * 64;  // the parity no thread still reads
      if (t4 == 0) {
        il[ra] = va ? 1.0f / la : 0.0f;
        il[rb] = vb ? 1.0f / lb : 0.0f;
      }
      consumer_sync(wg);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int n = 8 * (e / 4) + 2 * t4 + (e & 1), qpos = qw0 + n;
        if (qpos >= s.n_q) continue;
        const float inv = il[n];
        float* orow = p.o + ((size_t)b * s.n_q + qpos) * D + col0 + ((e & 2) ? rb : ra);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) orow[64 * mt] = o[mt][e] * inv;
      }
    }
    if (p.lse != nullptr && rank == 0 && t4 == 0) {
      const size_t row = (size_t)b * s.n_q;
      if (qa < s.n_q) p.lse[row + qa] = va ? ma * LN2 + logf(la) : -__int_as_float(0x7f800000);
      if (qb < s.n_q) p.lse[row + qb] = vb ? mb * LN2 + logf(lb) : -__int_as_float(0x7f800000);
    }
  }
  if constexpr (CL > 1) cluster_sync();  // no peer stores into this CTA any more
}

// HD: the CTA's columns; CL: CTAs a cluster (the head dim HD·CL)
template <int HD, int CL>
cudaError_t launch_fwd_f32(const F32Params& p, cudaStream_t stream) {
  using C = FwdCfg<HD, CL>;
  constexpr int D = HD * CL;
  const int bh_kv = p.bh / p.hq * p.hkv;
  FwdMaps m;
  if (!make_map<4 * D, 64, 128>(&m.q, p.q, p.n_q, p.bh)) return cudaErrorInvalidValue;
  if (p.n_kv == 0) {  // no kv tile is visited: the maps are never read
    m.k = m.v = m.q;
  } else if (!make_map<4 * D, C::BKV, 128>(&m.k, p.k, p.n_kv, bh_kv) ||
             !make_map<4 * D, C::BKV, 128>(&m.v, p.v, p.n_kv, bh_kv)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(p.bh * CL, (p.n_q + C::BQ - 1) / C::BQ);
  static int clusters = -1;
  return launch_cluster<CL>(flash_fwd_tf32<HD, CL>, grid, 384, C::SMEM, stream, clusters, m, p);
}

}  // namespace
