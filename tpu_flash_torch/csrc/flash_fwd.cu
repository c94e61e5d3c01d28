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
//   consumers (BQ 128; two CTAs would not fit) and BKV 64; as many ring
//   stages as fit (TcCfg). BQ 64 measured faster than 128 (two consumers,
//   BKV 128) at the serving and the training shape (PERF.md §6).
// float32 inputs keep the FMA kernel below (no tensor core takes exact
// float32: the reference's f32 dots are full precision): one block of 4
// warps per (64-row q tile, bh row), Q/K/V tiles, scores, P and the float32
// accumulator in shared memory, each warp owning 16 q rows; at d 256 a
// 32-row q tile of 2 warps (217 KB), since 64-row tiles would need 301 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// warpgroups of 64 q rows (one at d <= 128, two at d 256, where two CTAs
// an SM would not fit) and 64-row K/V tiles.
template <int HD> struct TcCfg {
  static constexpr int NC = HD == 256 ? 2 : 1;
  static constexpr int BQ = 64 * NC;
  static constexpr int BKV = 64;
  static constexpr int MINB = NC == 1 ? 2 : 1;  // CTAs an SM
  static constexpr int QBYTES = BQ * HD * 2;
  static constexpr int TILE = BKV * HD * 2;     // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BUDGET = MINB == 2 ? SM_SMEM / 2 - 1024 : SMEM_LIMIT;
  static constexpr int bytes(int st) {
    // 1024 of alignment slack, Q, the stages, the Q barrier and two a stage
    return 1024 + QBYTES + st * STAGE + (2 * st + 1) * 8;
  }
  static constexpr int ST = bytes(3) <= BUDGET ? 3 : 2;
  static constexpr int SMEM = bytes(ST);
  static_assert(SMEM <= BUDGET, "above the shared memory a block may use");
  static_assert(QBYTES % 1024 == 0 && TILE % 1024 == 0,
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
      mbar_init(&empty_bar[i], 4 * NC);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == NC) {
    // ---------------- producer: one TMA thread ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
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
        for (int pn = 0; pn < PANELS; ++pn) {
          tma_load_3d(st + pn * BKV * 128, &tmap_k, pn * 128, k0, kv_row, &full_bar[i]);
          tma_load_3d(st + C::TILE + pn * BKV * 128, &tmap_v, pn * 128, k0, kv_row,
                      &full_bar[i]);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows each ----------------
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 216;");
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
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
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
        for (int j = 0; j < HD / 8; ++j) {
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
      const uint32_t v_addr = smem_u32(st + C::TILE);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs_bf16<HD, 1>(o, pa[kk], desc_mn(v_addr + kk * 16 * 128, BKV * 128));
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
    for (int half = 0; half < 2; ++half) {
      const int qpos = half ? qb : qa;
      if (qpos >= s.n_q) continue;
      const float inv = half ? ib : ia;
      const size_t row = (size_t)b * s.n_q + qpos;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(p.o + row * HD + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      if (p.lse != nullptr && t4 == 0) {
        const float l = half ? lb : la, m = half ? mb : ma;
        p.lse[row] = (half ? vb : va) ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
      }
    }
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const TcParams& p, int bh,
                      cudaStream_t stream) {
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
  kern<<<dim3(bh, n_tiles), 128 * (C::NC + 1), C::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// ------------------------------------------------------ float32: FMA

constexpr int BKV32 = 64;  // kv rows per step

// q rows per block: 64 (4 warps, each owning 16 q rows), or 32 (2 warps)
// at d 256, whose 64-row tiles would not fit in 227 KB.
template <int HD> struct Cfg32 {
  static constexpr int BQ = HD == 256 ? 32 : 64;
  static constexpr int NTHREADS = BQ / 16 * 32;
  static constexpr int LDQ = HD + 4;      // Q, K, V rows
  static constexpr int LDS = BKV32 + 4;   // scores
  static constexpr int LDO = HD + 4;      // accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(float) * BKV32 * LDQ;
  static constexpr size_t s_off = v_off + sizeof(float) * BKV32 * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(float) * BQ * LDS;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
  static_assert(bytes <= SMEM_LIMIT, "above the 227 KB a block may use");
};

// rows [row0, row0 + rows) of a (n, HD) matrix into shared memory (pitch
// ld), zero past n; 16-byte vector copies.
template <int HD>
__device__ void load_tile(float* dst, int ld, const float* src, int row0, int n, int rows) {
  constexpr int CHUNKS = HD / 4;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += Cfg32<HD>::NTHREADS) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(Cfg32<HD>::NTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              const float* __restrict__ kmax, Sched sc, int hq, int hkv) {
  using S = Cfg32<HD>;
  constexpr int BQ = S::BQ, NTHREADS = S::NTHREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::q_off);
  float* ks = reinterpret_cast<float*>(smem + S::k_off);
  float* vs = reinterpret_cast<float*>(smem + S::v_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  float* ps = reinterpret_cast<float*>(smem + S::p_off);
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* ms = reinterpret_cast<float*>(smem + S::m_off);
  float* ls = reinterpret_cast<float*>(smem + S::l_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ - 1, sc.n_q - 1);
  const int b = blockIdx.y;
  const int kv_row = (b / hq) * hkv + (b % hq) / (hq / hkv);
  const float* qb = q + (size_t)b * sc.n_q * HD;
  const float* kb = k + (size_t)kv_row * sc.n_kv * HD;
  const float* vb = v + (size_t)kv_row * sc.n_kv * HD;
  const bool bound = kmax != nullptr;

  load_tile<HD>(qs, S::LDQ, qb, q0, sc.n_q, BQ);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = MASK;
    ls[i] = 0.0f;
  }
  if (bound) {
    // each warp sets its own rows' constant max from the staged q tile
    __syncthreads();
    const float kbound = kmax[kv_row] * BOUND_SLACK;
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float sq = 0.0f;
      for (int c = lane; c < HD; c += 32) sq = fmaf(qs[r * S::LDQ + c], qs[r * S::LDQ + c], sq);
      sq = warp_sum(sq);
      if (lane == 0) ms[r] = sqrtf(sq) * kbound;
    }
  }

  int first, last;
  kv_range(sc, q0, q_last, BKV32, first, last);
  for (int st = first; st <= last; ++st) {
    const int k0 = st * BKV32;
    const bool full = tile_full(sc, k0, k0 + BKV32 - 1, q0, q_last);
    __syncthreads();  // previous step done with ks/vs (and init visible)
    load_tile<HD>(ks, S::LDQ, kb, k0, sc.n_kv, BKV32);
    load_tile<HD>(vs, S::LDQ, vb, k0, sc.n_kv, BKV32);
    __syncthreads();
    // S[16 rows of this warp][BKV32] = Q·Kᵀ
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float* qr = qs + r * S::LDQ;
      for (int c = lane; c < BKV32; c += 32) {
        const float* kr = ks + c * S::LDQ;
        float acc = 0.0f;
        for (int kk = 0; kk < HD; ++kk) acc = fmaf(qr[kk], kr[kk], acc);
        ss[r * S::LDS + c] = acc;
      }
    }
    __syncwarp();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int qpos = q0 + r;
      float sv[BKV32 / 32];
      float mx = MASK;
      for (int j = 0; j < BKV32 / 32; ++j) {
        const int c = lane + 32 * j;
        sv[j] = (full || visible(sc, qpos, k0 + c)) ? ss[r * S::LDS + c] : MASK;
        mx = fmaxf(mx, sv[j]);
      }
      const float m_prev = ms[r];
      // the norm bound is constant: no max pass, alpha = 1, no rescale
      const float m_next = bound ? m_prev : fmaxf(m_prev, warp_max(mx));
      const float alpha = bound ? 1.0f : exp2f(m_prev - m_next);
      float psum = 0.0f;
      for (int j = 0; j < BKV32 / 32; ++j) {
        const float pr = exp2f(sv[j] - m_next);
        psum += pr;
        ps[r * S::LDS + lane + 32 * j] = pr;
      }
      psum = warp_sum(psum);
      if (!bound)
        for (int c = lane; c < HD; c += 32) os[r * S::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_next;
        ls[r] = alpha * ls[r] + psum;
      }
    }
    __syncwarp();
    // O[16 rows of this warp][HD] += P·V (O already rescaled by alpha)
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float* pr = ps + r * S::LDS;
      float* orow = os + r * S::LDO;
      for (int c = lane; c < HD; c += 32) {
        float acc = orow[c];
        for (int kk = 0; kk < BKV32; ++kk) acc = fmaf(pr[kk], vs[kk * S::LDQ + c], acc);
        orow[c] = acc;
      }
    }
    __syncwarp();
  }

  __syncthreads();  // init visible to every warp also when no tile ran
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= sc.n_q) break;
    const float l = ls[r], m = ms[r];
    const bool valid = l > 0.0f && m > MASK * 0.5f;
    const float l_inv = valid ? 1.0f / l : 0.0f;
    float* orow = o + ((size_t)b * sc.n_q + qpos) * HD;
    for (int c = lane; c < HD; c += 32) orow[c] = os[r * S::LDO + c] * l_inv;
    if (lse != nullptr && lane == 0)
      lse[(size_t)b * sc.n_q + qpos] = valid ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       const float* kmax, const Sched& sc, int bh, int hq, int hkv,
                       cudaStream_t stream) {
  auto kern = flash_fwd_f32<HD>;
  const size_t smem = Cfg32<HD>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sc.n_q + Cfg32<HD>::BQ - 1) / Cfg32<HD>::BQ, bh);
  kern<<<grid, Cfg32<HD>::NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, kmax, sc, hq, hkv);
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
// wrap, 0 or at least n_q and n_kv). dtype: 0 = float32,
// 1 = bfloat16. d ∈ {64, 128, 256} (the wrapper zero-pads other head and
// value dims up to the next of these).
extern "C" cudaError_t tf_flash_fwd(const void* q, const void* k, const void* v,
                                    void* o, float* lse, const float* kmax,
                                    int bh, int n_q, int n_kv, int hq, int hkv,
                                    int d, int kind, int offset, int radius,
                                    int section, int dtype, cudaStream_t stream) {
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  const Sched sc{n_q, n_kv, kind, offset, radius, section};
  if (hkv <= 0 || hq % hkv != 0 || bh % hq != 0 || n_kv < 0 || !sched_ok(sc))
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    const TcParams p{static_cast<bf16*>(o), lse, kmax, sc, hq, hkv};
    if (d == 128) return launch_tc<128>(q, k, v, p, bh, stream);
    if (d == 64) return launch_tc<64>(q, k, v, p, bh, stream);
    if (d == 256) return launch_tc<256>(q, k, v, p, bh, stream);
  } else if (dtype == 0) {
    if (d == 128) return launch_f32<128>(q, k, v, o, lse, kmax, sc, bh, hq, hkv, stream);
    if (d == 64) return launch_f32<64>(q, k, v, o, lse, kmax, sc, bh, hq, hkv, stream);
    if (d == 256) return launch_f32<256>(q, k, v, o, lse, kmax, sc, bh, hq, hkv, stream);
  }
  return cudaErrorInvalidValue;
}
