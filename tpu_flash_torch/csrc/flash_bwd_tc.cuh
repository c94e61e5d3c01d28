// B4/B5's TMA + wgmma building blocks (the score and gradient products,
// the operand tensor maps, the epilogue) and their kernels for bf16 at the
// compiled widths 256 and 512, shared by flash_bwd.cu (which also holds the
// kernels of widths 64 and 128, and instantiates 256) and flash_bwd_wide.cu
// (which instantiates 512). The design is described at the top of
// flash_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "hopper.cuh"
#include "schedule.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may use
constexpr int SM_SMEM = 233472;     // shared memory of an SM (228 KB)

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
// p·ROWS·128 bytes). B's columns 0–255 are at b_lo, its columns 256–511
// (width 512) at b_hi: the two 256-column halves of a tile may sit in
// different ring slots.
template <int N, int HD>
__device__ __forceinline__ void ss_gemm2(float (&acc)[N / 2], uint32_t a_addr, uint32_t b_lo,
                                         uint32_t b_hi) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int colb = 32 * kk, pn = colb / 128;
    const uint32_t b = (pn < 4 ? b_lo : b_hi) + (pn % 4) * N * 128 + colb % 128;
    wgmma_bf16_bf16<N>(acc, desc<128>(a_addr + pn * 64 * 128 + colb % 128), desc<128>(b), kk);
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

// acc (64 × N) += A · B: A (64 × K) as bf16 register fragments, B the
// K-row tile at b_addr read MN-major (its rows run along K), N columns in
// 64-column panels K·128 bytes apart
template <int K, int N>
__device__ __forceinline__ void rs_gemm(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4],
                                        uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs_bf16<N, 1>(acc, a[kk], desc_mn(b_addr + kk * 16 * 128, K * 128));
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
// on the int8 tiles (s32 sums, converted); one commit group. B's and D's
// 256-column halves at b_lo/b_hi and d_lo/d_hi (an int8 D: d_lo, whole).
template <int N, int HD, bool DP>
__device__ __forceinline__ void score_products2(float (&sc)[N / 2], float (&dp)[N / 2],
                                                uint32_t a, uint32_t b_lo, uint32_t b_hi,
                                                uint32_t c, uint32_t d_lo, uint32_t d_hi) {
  if constexpr (DP) {
    int dpi[N / 2];
    wgmma_fence();
    ss_gemm2<N, HD>(sc, a, b_lo, b_hi);
    ss_gemm_s8<N, HD>(dpi, c, d_lo);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);
    reg_fence(dpi);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dp[e] = (float)dpi[e];
  } else {
    wgmma_fence();
    ss_gemm2<N, HD>(sc, a, b_lo, b_hi);
    ss_gemm2<N, HD>(dp, c, d_lo, d_hi);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(sc);
    reg_fence(dp);
  }
}

// the same with B's and D's panels contiguous
template <int N, int HD, bool DP>
__device__ __forceinline__ void score_products(float (&sc)[N / 2], float (&dp)[N / 2],
                                               uint32_t a, uint32_t b, uint32_t c,
                                               uint32_t d) {
  score_products2<N, HD, DP>(sc, dp, a, b, b + 4 * N * 128, c, d, d + 4 * N * 128);
}

// A consumer's wait on a full barrier of its own for stage (slot) i. Where
// consumers take the steps in turn, each has its own full barrier a stage:
// a shared one would also complete the other consumer's phases, and a
// consumer that runs a lap ahead could take the parity of a load still in
// flight for the other as its own. Bit i of phases holds the parity of its
// next wait on stage i.
__device__ __forceinline__ void wait_own(uint64_t* bar, uint32_t& phases, int i) {
  mbar_wait(bar, (phases >> i) & 1);
  phases ^= 1u << i;
}

// A hand-off between a kernel's two consumers through shared memory (B4's
// p and ds at 512, B5's pᵀ and dsᵀ; flash_bwd_f32.cu's P and dS): the giver
// arrives on named barrier `id` once its writes are done, the taker waits
// there before reading (256 threads: both consumer warpgroups).
__device__ __forceinline__ void handoff_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void handoff_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
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

// rows ra, rb of a 64 × N accumulator, times their scales, into bf16 rows
// of out (pitch ld elements)
template <int N>
__device__ __forceinline__ void store_rows(bf16* out, int ld, const float (&acc)[N / 2], int t4,
                                           long row_a, long row_b, float scale_a,
                                           float scale_b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long row = half ? row_b : row_a;
    const float scale = half ? scale_b : scale_a;
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + row * ld + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// The tensor maps of both kernels: q, dO and qs over (bh, n_q, HD) of EB-byte
// elements (bf16, or float32 in flash_bwd_f32.cu), k and v over
// (bh_kv, n_kv, HD), and under dp dÔ over (bh, n_q) and v (V̂) over
// (bh_kv, n_kv) rows of HD int8.
struct Maps {
  CUtensorMap q, dout, k, v, qs, do8;
};

template <typename Kern>
cudaError_t launch_tc(Kern kern, dim3 grid, int threads, int smem, cudaStream_t stream,
                      const Maps& m, const BwdParams& p) {
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(m, p);
  return cudaGetLastError();
}

// the maps of p's operands with boxes of 128 bytes (a panel) × QROWS rows
// on the q side and × KVROWS on the kv side; a map over an empty sequence
// or of an operand the variant does not read is never read and takes
// another's place
template <int HD, int QROWS, int KVROWS, int EB = 2>
bool make_maps(Maps* m, const BwdParams& p, int bh) {
  const int bh_kv = bh / p.hq * p.hkv;
  const bool dp = p.v8 != nullptr;
  bool ok = true;
  if (p.n_q > 0) {
    ok = make_map<EB * HD, QROWS, 128>(&m->q, p.q, p.n_q, bh);
    m->dout = m->qs = m->do8 = m->q;
    if (ok && p.dout != nullptr) ok = make_map<EB * HD, QROWS, 128>(&m->dout, p.dout, p.n_q, bh);
    if (ok && p.qs != nullptr) ok = make_map<EB * HD, QROWS, 128>(&m->qs, p.qs, p.n_q, bh);
    if (ok && dp) ok = make_map<HD, QROWS, 128>(&m->do8, p.do8, p.n_q, bh);
  }
  if (ok && p.n_kv > 0) {
    ok = make_map<EB * HD, KVROWS, 128>(&m->k, p.k, p.n_kv, bh_kv);
    if (ok)
      ok = dp ? make_map<HD, KVROWS, 128>(&m->v, p.v8, p.n_kv, bh_kv)
              : make_map<EB * HD, KVROWS, 128>(&m->v, p.v, p.n_kv, bh_kv);
  }
  if (p.n_q == 0) m->q = m->dout = m->qs = m->do8 = m->k;
  if (p.n_kv == 0) m->k = m->v = m->q;
  return ok;
}

// ------------------------------------------- bf16 at widths 256 and 512

// A CTA's ring holds items: 256-column halves of an operand tile (ITEM
// bytes) or a whole int8 tile, in the order the consumers first read them.
// Item j of the CTA's walk sits in slot j % NS. Items that only the score
// products read (early) go back to the producer once those products are
// done; the rest (late) at the end of the step. As long as a step's items
// fit in the ring (NS >= NI), the producer runs ahead by whole and partial
// steps.

// the slot and the phase parity of item i of step t
struct Slot {
  int slot, ph;
};
template <int NI, int NS>
__device__ __forceinline__ Slot slot_of(int t, int i) {
  const int j = t * NI + i;
  return Slot{j % NS, (j / NS) & 1};
}

// B4 at width HD (256 or 512): one CTA per (64-row q tile, bh row), two
// consumers. Q and dO (dÔ) resident; a step's items: V's halves or V̂
// (early: dP alone reads them), then K's halves (late: S, then dQ += dS·K).
// - 256: the consumers take the steps in turn, each summing all of dQ's 256
//   columns, the two sums added at the finish (measured faster here than
//   the split below, whose hand-off serialises the elementwise passes).
// - 512 (SPLIT): both take every step, consumer c summing dQ's columns
//   [256c, +256) (the 512 columns of 64 rows would take 256 registers a
//   thread). Consumer 0 takes S, consumer 1 dP, each over the full width;
//   consumer 0 hands its float32 p to consumer 1 (XP, named barrier 1),
//   which returns ds as bf16 fragments (XDS, named barrier 2).
template <int HD, bool DP> struct WideDqCfg {
  static constexpr bool SPLIT = HD == 512;
  static constexpr int HALVES = HD / 256;
  static constexpr int BQ = 64, BKV = SPLIT ? 32 : 64;
  static constexpr int QBYTES = BQ * HD * 2;
  static constexpr int DOBYTES = BQ * HD * (DP ? 1 : 2);
  static constexpr int ITEM = BKV * 256 * 2;
  static constexpr int V8BYTES = BKV * HD;
  static constexpr int NV = DP ? 1 : HALVES;   // V's items, early
  static constexpr int NI = NV + HALVES;       // then K's, late
  static constexpr int XP = SPLIT ? 128 * (BKV / 2) * 4 : 0;
  static constexpr int XDS = SPLIT ? 128 * (BKV / 4) * 4 : 0;
  static constexpr int RESIDENT = QBYTES + DOBYTES + XP + XDS;
  // barriers: Q's, a full one a slot for each consumer, an empty one a slot
  static constexpr int NS = (SMEM_LIMIT - 1024 - RESIDENT - 8) / (ITEM + 24);
  static constexpr int SMEM = 1024 + RESIDENT + NS * ITEM + (3 * NS + 1) * 8;
  static_assert(NS >= NI, "a step's items outgrow the ring");
  static_assert(V8BYTES <= ITEM, "V̂ outgrows its slot");
  static_assert(SPLIT || NS * ITEM >= 128 * 128 * 4, "the partial sums outgrow the ring");
  static_assert(SMEM <= SMEM_LIMIT && RESIDENT % 1024 == 0 && ITEM % 1024 == 0,
                "the plan outgrows shared memory or breaks the swizzle's alignment");
  // registers a thread after setmaxnreg: 128·(PRODUCER + 2·CONSUMER) <= 65536
  static constexpr int PRODUCER = 40, CONSUMER = 232;
};

template <int HD, bool DP>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wide(const __grid_constant__ Maps m, const BwdParams p) {
  using C = WideDqCfg<HD, DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NI = C::NI, NV = C::NV, NS = C::NS;
  constexpr int PANELS = HD / 64;
  constexpr bool SPLIT = C::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                      // 64 rows of Q, PANELS panels
  uint8_t* dos = smem + C::QBYTES;         // the same rows of dO (dÔ)
  float* xp = reinterpret_cast<float*>(dos + C::DOBYTES);                  // SPLIT: p
  uint32_t* xds = reinterpret_cast<uint32_t*>(dos + C::DOBYTES + C::XP);   // SPLIT: ds
  uint8_t* ring = dos + C::DOBYTES + C::XP + C::XDS;  // NS items
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + NS * C::ITEM);
  uint64_t* full_bar = q_bar + 1;          // 2 × NS: each consumer's own (wait_own)
  uint64_t* empty_bar = full_bar + 2 * NS;

  const Sched s = sched_of(p);
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
    for (int i = 0; i < 2 * NS; ++i) mbar_init(&full_bar[i], 1);
    // lane 0 of the step's consumer's warps (SPLIT: of both consumers')
    for (int i = 0; i < NS; ++i) mbar_init(&empty_bar[i], SPLIT ? 8 : 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == 2) {
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
        const int k0 = (first + t) * BKV;
        for (int i = 0; i < NI; ++i) {
          const Slot sl = slot_of<NI, NS>(t, i);
          mbar_wait(&empty_bar[sl.slot], sl.ph ^ 1);
          uint8_t* dst = ring + sl.slot * C::ITEM;
          // SPLIT: both consumers wait every item on consumer 0's barriers
          uint64_t* bar = &full_bar[(SPLIT ? 0 : (t & 1) * NS) + sl.slot];
          if (DP && i == 0) {  // V̂, whole
            mbar_expect_tx(bar, C::V8BYTES);
            for (int pn = 0; pn < HD / 128; ++pn)
              tma_load_3d(dst + pn * BKV * 128, &m.v, pn * 128, k0, kv_row, bar);
          } else {  // a V or a K half
            const bool is_v = i < NV;
            const int half = is_v ? i : i - NV;
            mbar_expect_tx(bar, C::ITEM);
            for (int pn = 0; pn < 4; ++pn)
              tma_load_3d(dst + pn * BKV * 128, is_v ? &m.v : &m.k, (4 * half + pn) * 128, k0,
                          kv_row, bar);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: the 64 q rows ----------------
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
    float dq[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) dq[i] = 0.0f;
    const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);
    mbar_wait(q_bar, 0);

    uint32_t phases = 0;  // wait_own's parities, a bit a slot
    for (int t = SPLIT ? 0 : wg; t < steps; t += SPLIT ? 1 : 2) {
      const int k0 = (first + t) * BKV;
      uint32_t item[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int slot = slot_of<NI, NS>(t, i).slot;
        item[i] = smem_u32(ring + slot * C::ITEM);
        wait_own(&full_bar[(SPLIT ? 0 : wg * NS) + slot], phases, slot);
      }
      const uint32_t v_lo = item[0], v_hi = item[NV - 1];     // V̂: item 0, whole
      const uint32_t k_lo = item[NV], k_hi = item[NI - 1];    // K's halves
      uint32_t ds[BKV / 16][4];
      if constexpr (SPLIT) {
        // consumer 0: S = Q·Kᵀ, consumer 1: dP = dO·Vᵀ (dÔ·V̂ᵀ), full width
        float acc[BKV / 2];
        if (wg == 0) {
          wgmma_fence();
          ss_gemm2<BKV, HD>(acc, q_addr, k_lo, k_hi);
          wgmma_commit();
          wgmma_wait0();
          reg_fence(acc);
        } else if constexpr (DP) {
          int dpi[BKV / 2];
          wgmma_fence();
          ss_gemm_s8<BKV, HD>(dpi, do_addr, v_lo);
          wgmma_commit();
          wgmma_wait0();
          reg_fence(dpi);
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) acc[e] = (float)dpi[e];
        } else {
          wgmma_fence();
          ss_gemm2<BKV, HD>(acc, do_addr, v_lo, v_hi);
          wgmma_commit();
          wgmma_wait0();
          reg_fence(acc);
        }
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < NV; ++i) mbar_arrive(&empty_bar[slot_of<NI, NS>(t, i).slot]);
        }
        if (wg == 0) {
          // p in registers, the mask only on a tile not wholly visible;
          // handed over, and ds taken back as fragments
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) acc[e] = fast_exp2(acc[e] - ((e & 2) ? lse_b : lse_a));
          if (!tile_full(s, k0, k0 + BKV - 1, q0, q_last)) {
#pragma unroll
            for (int e = 0; e < BKV / 2; ++e) {
              const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
              if (!in_span((e & 2) ? span_b : span_a, kpos)) acc[e] = 0.0f;
            }
          }
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) xp[e * 128 + wtid] = acc[e];
          handoff_arrive(1);  // p is in XP
          handoff_sync(2);    // ds is in XDS
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) ds[kk][e] = xds[(4 * kk + e) * 128 + wtid];
        } else {
          handoff_sync(1);
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e)
            acc[e] = xp[e * 128 + wtid] * (acc[e] - ((e & 2) ? dl_b : dl_a));
          to_frags<BKV>(acc, ds);
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) xds[(4 * kk + e) * 128 + wtid] = ds[kk][e];
          handoff_arrive(2);
        }
      } else {
        // S = Q·Kᵀ and dP = dO·Vᵀ (dÔ·V̂ᵀ), both here
        float sc[BKV / 2], dp[BKV / 2];
        score_products2<BKV, HD, DP>(sc, dp, q_addr, k_lo, k_hi, do_addr, v_lo, v_hi);
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < NV; ++i) mbar_arrive(&empty_bar[slot_of<NI, NS>(t, i).slot]);
        }
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
        to_frags<BKV>(sc, ds);
      }
      // dQ += dS·K over this consumer's 256 columns: dS (bf16) as the
      // register A operand, the K half read MN-major
      reg_fence(dq);
      wgmma_fence();
      rs_gemm<BKV, 256>(dq, ds, SPLIT && wg == 1 ? k_hi : k_lo);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dq);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int i = NV; i < NI; ++i) mbar_arrive(&empty_bar[slot_of<NI, NS>(t, i).slot]);
      }
    }
    if constexpr (!SPLIT) {
      float* part = reinterpret_cast<float*>(ring) + wtid;
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
    store_rows<256>(static_cast<bf16*>(p.dq) + 256 * wg, HD, dq, t4,
                    qa < s.n_q ? (long)(base + qa) : -1, qb < s.n_q ? (long)(base + qb) : -1,
                    sc_a, sc_b);
  }
}

// B5 at width HD (256 or 512): one CTA per (64-row kv tile, bh_kv row,
// output half), summed over the g query heads of its group. K and V (V̂)
// resident; a step's items (BQ q rows each): bf16, Q and dO, at 512 as
// their halves, the ones outside this CTA's columns first (early: the
// score products alone read them); dp, Q's halves and dÔ (early), then
// this CTA's half of dO (dV) and of qs (dK), late. The lse2 and Δ of the
// step's rows ride with its first late item. Two consumers take every
// step, each owning 128 of the CTA's 256 dK and dV columns. Consumer 0
// takes Sᵀ, consumer 1 dPᵀ, each over the full width: consumer 0 hands its
// float32 pᵀ to consumer 1 through shared memory (XP, named barrier 1),
// which returns dsᵀ as bf16 fragments (XDS, named barrier 2), and each runs
// its columns' dV and dK products on both.
template <int HD, bool DP> struct WideDkvCfg {
  static constexpr bool W512 = HD == 512;
  static constexpr int HALVES = HD / 256;
  static constexpr int BKV = 64, BQ = W512 ? 32 : 64;
  static constexpr int KBYTES = BKV * HD * 2;
  static constexpr int VBYTES = BKV * HD * (DP ? 1 : 2);
  static constexpr int ITEM = BQ * 256 * 2;
  static constexpr int DO8BYTES = BQ * HD;
  static constexpr int ROWS = 2 * BQ * 4;                           // lse2 and Δ
  static constexpr int NI = DP ? HALVES + 3 : 2 * HALVES;           // items a step
  static constexpr int EARLY = DP ? NI - 2 : 2 * (HALVES - 1);      // early items
  static constexpr int ROWS_ITEM = EARLY;  // the first late item
  // pᵀ (float32) and dsᵀ (bf16) of a step between the consumers, a
  // thread's elements at a stride of 128 words
  static constexpr int XP = 128 * (BQ / 2) * 4, XDS = 128 * (BQ / 4) * 4;
  static constexpr int RESIDENT = KBYTES + VBYTES + XP + XDS;
  static constexpr int NS = (SMEM_LIMIT - 1024 - RESIDENT - 8) / (ITEM + ROWS + 16);
  static constexpr int SMEM = 1024 + RESIDENT + NS * (ITEM + ROWS) + (2 * NS + 1) * 8;
  static_assert(NS >= NI, "a step's items outgrow the ring");
  static_assert(DO8BYTES <= ITEM, "dÔ outgrows its slot");
  static_assert(SMEM <= SMEM_LIMIT && RESIDENT % 1024 == 0 && ITEM % 1024 == 0,
                "the plan outgrows shared memory or breaks the swizzle's alignment");
  // as WideDqCfg; dK + dV + pᵀ + dPᵀ take 192 registers at 256
  static constexpr int PRODUCER = 24, CONSUMER = 240;
};

template <int HD, bool DP>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_wide(const __grid_constant__ Maps m, const BwdParams p) {
  using C = WideDkvCfg<HD, DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NI = C::NI, NS = C::NS, PANELS = HD / 64;
  constexpr bool W512 = C::W512;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem;                      // 64 rows of K, PANELS panels
  uint8_t* vs = smem + C::KBYTES;          // the same rows of V (V̂)
  float* xp = reinterpret_cast<float*>(vs + C::VBYTES);             // pᵀ
  uint32_t* xds = reinterpret_cast<uint32_t*>(vs + C::VBYTES + C::XP);  // dsᵀ
  uint8_t* ring = vs + C::VBYTES + C::XP + C::XDS;  // NS items
  float* ring_rows = reinterpret_cast<float*>(ring + NS * C::ITEM);  // NS × (lse2, Δ)
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(ring_rows + NS * 2 * BQ);
  uint64_t* full_bar = kv_bar + 1;
  uint64_t* empty_bar = full_bar + NS;

  const Sched s = sched_of(p);
  const int kv_row = blockIdx.x / C::HALVES, z = blockIdx.x % C::HALVES;  // columns [256z, +256)
  const int k0 = blockIdx.y * BKV, k_hi = min(k0 + BKV - 1, s.n_kv - 1);
  const int g = p.hq / p.hkv;
  const int q_row0 = (kv_row / p.hkv) * p.hq + (kv_row % p.hkv) * g;
  const bool with_dv = 256 * z < p.dv_cols;
  // the q tiles that see a key of this tile (the transposed visit); the
  // producer and the consumers walk the same range
  int first, last;
  q_range(s, k0, k_hi, BQ, first, last);
  const int per_head = max(0, last - first + 1);
  const int steps = g * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full_bar[i], 1 + 32);   // TMA's bytes and the producer warp's lanes
      mbar_init(&empty_bar[i], 8);       // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == 2) {
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
        const int bq = q_row0 + t / per_head, q0 = (first + t % per_head) * BQ;
        for (int i = 0; i < NI; ++i) {
          const Slot sl = slot_of<NI, NS>(t, i);
          mbar_wait(&empty_bar[sl.slot], sl.ph ^ 1);
          uint8_t* dst = ring + sl.slot * C::ITEM;
          uint64_t* bar = &full_bar[sl.slot];
          if (lane == 0) {
            const CUtensorMap* map;
            int half = z;  // the 256-column half of a bf16 item
            if constexpr (DP) {
              map = i < C::HALVES ? &m.q : i == C::HALVES ? &m.do8 : i == NI - 2 ? &m.dout : &m.qs;
              if (i < C::HALVES) half = i;
            } else {
              map = i % 2 == 0 ? &m.q : &m.dout;
              if (i < C::EARLY) half = 1 - z;
            }
            if (DP && i == C::HALVES) {  // dÔ, whole
              mbar_expect_tx(bar, C::DO8BYTES);
              for (int pn = 0; pn < HD / 128; ++pn)
                tma_load_3d(dst + pn * BQ * 128, map, pn * 128, q0, bq, bar);
            } else {
              mbar_expect_tx(bar, C::ITEM);
              for (int pn = 0; pn < 4; ++pn)
                tma_load_3d(dst + pn * BQ * 128, map, (4 * half + pn) * 128, q0, bq, bar);
            }
          }
          if (i == C::ROWS_ITEM) {
            float* rows = ring_rows + sl.slot * 2 * BQ;
            const size_t base = (size_t)bq * s.n_q + q0;
            for (int r = lane; r < BQ; r += 32) {
              const bool in = q0 + r < s.n_q;
              rows[r] = in ? p.lse2[base + r] : 0.0f;
              rows[BQ + r] = in ? p.delta[base + r] : 0.0f;
            }
          }
          mbar_arrive(bar);
        }
      }
    }
  } else {
    // ---------------- consumers: the 64 kv rows, 128 columns each ----------------
    reg_alloc<C::CONSUMER>();
    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int ka = k0 + ra, kb = k0 + rb;
    // the queries that see each of the two rows (empty past n_kv)
    const Span span_a = query_span(s, ka), span_b = query_span(s, kb);
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk[i] = 0.0f;
      dv[i] = 0.0f;
    }
    const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
    const uint32_t cols = 2 * wg * BQ * 128;  // this consumer's two panels of an item
    mbar_wait(kv_bar, 0);

    for (int t = 0; t < steps; ++t) {
      const int q0 = (first + t % per_head) * BQ;
      uint32_t item[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) item[i] = smem_u32(ring + slot_of<NI, NS>(t, i).slot * C::ITEM);
      // the items the score products read
#pragma unroll
      for (int i = 0; i < (DP ? NI - 2 : NI); ++i) {
        const Slot sl = slot_of<NI, NS>(t, i);
        mbar_wait(&full_bar[sl.slot], sl.ph);
      }
      // consumer 0: Sᵀ = K·Qᵀ, consumer 1: dPᵀ = V·dOᵀ (V̂·dÔᵀ), over the
      // full width; the gradient products' B operands: this CTA's halves of
      // dO and Q (qs)
      float acc[BQ / 2];
      uint32_t do_h, q_h, q_lo, q_hi, do_lo, do_hi;
      if constexpr (DP) {
        q_lo = item[0];
        q_hi = item[W512 ? 1 : 0];
        do_lo = do_hi = item[C::HALVES];  // dÔ, whole
        do_h = item[NI - 2];
        q_h = item[NI - 1];
      } else {
        q_h = item[NI - 2];
        do_h = item[NI - 1];
        const uint32_t q_o = item[0], do_o = item[1];  // at 512 only
        q_lo = z == 0 ? q_h : q_o;
        q_hi = z == 0 ? q_o : q_h;
        do_lo = z == 0 ? do_h : do_o;
        do_hi = z == 0 ? do_o : do_h;
      }
      if (wg == 0) {
        wgmma_fence();
        ss_gemm2<BQ, HD>(acc, k_addr, q_lo, q_hi);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(acc);
      } else if constexpr (DP) {
        int dpi[BQ / 2];
        wgmma_fence();
        ss_gemm_s8<BQ, HD>(dpi, v_addr, do_lo);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dpi);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) acc[e] = (float)dpi[e];
      } else {
        wgmma_fence();
        ss_gemm2<BQ, HD>(acc, v_addr, do_lo, do_hi);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < C::EARLY; ++i) mbar_arrive(&empty_bar[slot_of<NI, NS>(t, i).slot]);
      }
      // the late items (their first carries the rows' lse2 and Δ)
#pragma unroll
      for (int i = DP ? NI - 2 : NI; i < NI; ++i) {
        const Slot sl = slot_of<NI, NS>(t, i);
        mbar_wait(&full_bar[sl.slot], sl.ph);
      }
      const float* rows = ring_rows + slot_of<NI, NS>(t, C::ROWS_ITEM).slot * 2 * BQ;
      // pᵀ and dsᵀ in registers, each column's lse2 and Δ from the ring;
      // the mask only on a tile not wholly visible. Consumer 0 makes pᵀ and
      // hands it over, consumer 1 makes dsᵀ and hands it back.
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * j + c] = fast_exp2(acc[4 * j + c] - ((c & 1) ? l.y : l.x));
        }
        if (!(q0 + BQ - 1 < s.n_q && tile_full(s, k0, k0 + BKV - 1, q0, q0 + BQ - 1))) {
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {
            const int qpos = q0 + 8 * (e / 4) + 2 * t4 + (e & 1);
            if (!in_span((e & 2) ? span_b : span_a, qpos)) acc[e] = 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) xp[e * 128 + wtid] = acc[e];
        handoff_arrive(1);  // pᵀ is in XP
        to_frags<BQ>(acc, pa);
        handoff_sync(2);    // dsᵀ is in XDS
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[kk][e] = xds[(4 * kk + e) * 128 + wtid];
      } else {
        float pt[BQ / 2];
        handoff_sync(1);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) pt[e] = xp[e * 128 + wtid];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * t4);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * j + c] = pt[4 * j + c] * (acc[4 * j + c] - ((c & 1) ? dl.y : dl.x));
        }
        to_frags<BQ>(acc, da);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) xds[(4 * kk + e) * 128 + wtid] = da[kk][e];
        handoff_arrive(2);
        to_frags<BQ>(pt, pa);
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q (qs under dp) over this consumer's 128
      // columns: register A operands, dO and Q read MN-major
      reg_fence(dv);
      reg_fence(dk);
      wgmma_fence();
      if (with_dv) rs_gemm<BQ, 128>(dv, pa, do_h + cols);
      rs_gemm<BQ, 128>(dk, da, q_h + cols);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dv);
      reg_fence(dk);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int i = C::EARLY; i < NI; ++i) mbar_arrive(&empty_bar[slot_of<NI, NS>(t, i).slot]);
      }
    }
    const long base = (long)kv_row * s.n_kv;
    const long row_a = ka < s.n_kv ? base + ka : -1, row_b = kb < s.n_kv ? base + kb : -1;
    const int col = 256 * z + 128 * wg;
    store_rows<128>(static_cast<bf16*>(p.dk) + col, HD, dk, t4, row_a, row_b, LN2, LN2);
    if (with_dv)
      store_rows<128>(static_cast<bf16*>(p.dv) + col, HD, dv, t4, row_a, row_b, 1.0f, 1.0f);
  }
}

template <int HD, bool DP>
cudaError_t launch_dq_wide(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = WideDqCfg<HD, DP>;
  Maps m;
  if (!make_maps<HD, C::BQ, C::BKV>(&m, p, bh)) return cudaErrorInvalidValue;
  const dim3 grid(bh, (p.n_q + C::BQ - 1) / C::BQ);
  return launch_tc(flash_bwd_dq_wide<HD, DP>, grid, 384, C::SMEM, stream, m, p);
}

template <int HD, bool DP>
cudaError_t launch_dkv_wide(const BwdParams& p, int bh_kv, cudaStream_t stream) {
  using C = WideDkvCfg<HD, DP>;
  Maps m;
  if (!make_maps<HD, C::BQ, C::BKV>(&m, p, bh_kv / p.hkv * p.hq)) return cudaErrorInvalidValue;
  const dim3 grid(bh_kv * C::HALVES, (p.n_kv + C::BKV - 1) / C::BKV);
  return launch_tc(flash_bwd_dkv_wide<HD, DP>, grid, 384, C::SMEM, stream, m, p);
}

}  // namespace
