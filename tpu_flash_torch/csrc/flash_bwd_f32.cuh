// B4 and B5 in float32 for Hopper (sm_90a): 3×TF32 on wgmma behind a TMA
// ring, at every compiled width. flash_bwd_f32.cu instantiates widths 64 and
// 128 and flash_bwd_f32_wide.cu widths 256 and 512, side by side in the
// build; flash_bwd.cu's entry points dispatch to them (tf_bwd::launch_f32_dq,
// launch_f32_dkv). Schedules, numerics and the int8 dp product are those
// described at the top of flash_bwd.cu, with p from exact exp2f and p, ds
// kept in float32.
//
// Replaces, in float32, tpu_flash/ops/flash_bwd.py:_dq_kernel and
// _dq_kernel_t (B4), _dkv_kernel and _dkv_kernel_t (B5), which FMA kernels
// held before (at every width, later at 256 and 512 only; deleted).
//
// Products. No tensor core takes float32, and tf32 keeps 10 of its 23
// mantissa bits. Each float32 operand x splits into hi, x with its low 13
// bits cleared, and lo = x − hi (exact in float32); then
// A·B = A_hi·B_hi + A_hi·B_lo + A_lo·B_hi (3×TF32) on wgmma m64nNk8 with
// float32 sums, the products of the two lo parts left out. The tensor cores
// read a float32 word's top 19 bits and drop the rest (they truncate:
// bench/tf32_probe.py), so a raw tile is its own hi, only lo needs a pass,
// and lo is read truncated too. ops/flash_bwd.py:tf32x3 is the plain model
// of this product. What bounds the kernels is then 3 × the products' FLOPs
// at the tf32 peak (495 TFLOP/s), ~2.5× the float32 FMA peak.
//
// Layout. tf32 wgmma has no transpose bit: both operands K-major in shared
// memory, or A in registers. Every product here takes A from registers,
// loaded from shared memory by ld.shared in whatever order the product
// wants (a transposed A costs nothing) and split there, and B from shared
// memory, K-major, with a lo tile beside the raw one. So the gradient
// products run transposed, M over the head dim:
// - B4, one CTA per (64-row q tile, bh row), kv steps of BKV keys:
//   S = Q·Kᵀ and dP = dO·Vᵀ with Q and dO resident (A) and K, V staged (B);
//   dQᵀ += Kᵀ·dS, Kᵀ's fragments read from the staged K, dS written by the
//   consumer, raw and lo, as a [q][key] tile (the K-major B). dQ is summed
//   transposed and stored transposed.
// - B5, one CTA per (64-row kv tile, bh_kv row), q steps of BQ rows over the
//   group's q heads in a fixed order: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with K and V
//   resident (A) and Q, dO staged (B); dVᵀ += dOᵀ·P and dKᵀ += Qᵀ·dS (qs
//   under dp), P and dS written as [key][q] tiles, raw and lo.
// A producer warpgroup's first thread issues TMA into a ring of stages
// (full/empty mbarriers); then all 128 of its threads write the stage's lo
// tiles (and B5's lse2 and Δ of the stage's rows) and arrive on the stage's
// ready barrier. Two consumer warpgroups (setmaxnreg) load A's fragments in
// chunks, a chunk's products in flight while the next loads, and split a
// step: consumer 0 takes S (Sᵀ) and P, consumer 1 dP (dPᵀ) and dS, P
// handed from 0 to 1 through shared memory under named barriers; B4's dQᵀ
// slices are summed in turns, B5's consumer 0 sums dVᵀ and 1 dKᵀ. At b 1
// B5's grid is one wave, so the longest CTA's chain is what counts, and one
// consumer holding dKᵀ + dVᵀ (128 registers at d 128) spilled.
// Sums. The tensor cores' float32 sums drop the bits that an add shifts
// out, so a long chain of wgmmas into one accumulator drifts (with a whole
// kv walk in one chain, dK and dV sat an order of magnitude further from the
// exact path than the split's own error): each step's product goes into a
// fresh accumulator and is added to the running sum in registers, a
// rounding float32 add, and within a product the hi·hi chain and the two
// small products' chain are summed apart and added once (PERF.md §6).
// No atomics: one writer a output tile, a fixed summation order, bitwise
// repeatable.
// dp (widths 128 and up): dP (dPᵀ) on the s8 wgmma with both int8 operands
// K-major in shared memory, exact int32 sums, as the bf16 kernels take it.
//
// Widths 256 and 512: the head dim split across a thread-block cluster.
// A CTA holds one 128-column slice of the head dim, CL = d / 128 CTAs a
// cluster (2 at 256, 4 at 512), each a width-128 CTA of the layout above
// on its slice: B4's CTA c holds Q[:, c] and dO[:, c] and stages K[:, c],
// V[:, c]; B5's holds K[:, c], V[:, c] and stages Q[:, c], dO[:, c]. The
// score products over a slice are partial sums: S_c = Q_c·K_cᵀ, dP_c =
// dO_c·V_cᵀ. Each consumer stores its partial into its slot in every peer
// (st.async into distributed shared memory, each store completing its
// bytes on that CTA's full barrier: no fence, no remote load), keeps its
// own in registers, waits on its own barrier and adds the CL partials in
// rank order: every CTA holds the same S and dP bit for bit, and computes
// P and dS itself. The gradient products need nothing from the peers:
// dQᵀ_c += K_cᵀ·dS, dVᵀ_c += dO_cᵀ·P, dKᵀ_c += Q_cᵀ·dS, each CTA writing
// its own 128 columns (B5's CTA past the caller's dv, dv_cols, takes no
// dV). The slots are
// double-buffered by step parity: a peer stores its partial of step t + 2
// only after this CTA's partial of step t + 1 has reached it, which this
// CTA stores after reading step t's slots (a warpgroup barrier between,
// so that the reads are performed); each full barrier is armed
// (expect_tx) for its next phase once its phase is read. Under dp the
// int32 partials of a 128-column slice (at most 128·127²) and their sum
// (at most 512·127² < 2²⁴) are integers that float32 holds exactly: the
// sum is the one product's. Every CTA starts after a cluster barrier (its
// peers' mbarriers initialised) and ends at one (no CTA exits while a peer
// may still store into it). The launch names the cluster
// (cudaLaunchKernelEx) and is refused unless
// cudaOccupancyMaxActiveClusters finds room for one. Under a cluster the
// consumers take steps of 16 keys (B4) and 16 q rows (B5): the slots do
// not fit beside 32-row stages; a 16-column P or dS tile keeps 128-byte
// rows and its lo part in their right half. Variant builds timed on the
// card (PERF.md §6) chose this: an exchange by remote loads after a fence
// cost more than the stores; the third stage, made room for by the packed
// lo halves and the own partial kept in registers, paid at 512; computing
// the next step's partial ahead of the exchange did not pay on balance.
//
// Shared memory sets the tiles: a float32 tile is twice a bf16 one, and
// every B operand carries its lo tile. At d 128 B4 steps 32 keys (a stage
// K, K lo, V, V lo: 64 KB beside 64 KB of resident Q and dO) and B5 32 q
// rows (a stage Q, Q lo, dO, dO lo: 64 KB beside 64 KB of resident K and V
// and 32 KB of P and dS, raw and lo); at d 64 both step 64. Two stages
// (three for B4 under dp), one CTA an SM. A CTA of a cluster (a 128-column
// slice), three stages throughout: B4 64 KB of Q_c and dO_c (40 KB under
// dp), 16 KB of dS (raw and lo) and P, the peers' partials' slots (two
// consumers × two parities × CL − 1 peers × 4 KB: 16 KB at CL 2, 48 KB at
// 4) and their barriers, and stages of 32 KB (K_c, V_c, their lo tiles;
// 18 KB under dp): 194 KB at CL 2, 226 KB at CL 4 (128 and 160 KB under
// dp); B5 64 KB of K_c and V_c (40 KB under dp), 16 KB of P and dS (raw
// and lo), the slots, and stages of 32 KB (Q_c, dO_c, their lo tiles;
// under dp Q_c, dO_c, qs_c, dÔ_c and Q_c's lo tile, 34 KB) with their lse2
// and Δ: 194 KB at CL 2, 226 KB at CL 4 (176 and 208 KB under dp).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_bwd_tc.cuh"
#include "hopper.cuh"
#include "schedule.cuh"

namespace {

// the bits of a float32 word that tf32 keeps
constexpr uint32_t TF32_MASK = 0xffffe000u;

__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & TF32_MASK);
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// A's fragment of k8 step kk at the thread's two rows, ma and ma + 8 (wgmma's
// tf32 A layout: columns t4 and t4 + 4 of the step), from a ROWS-row
// float32 tile T in 128-byte swizzled panels (32 columns a panel, the layout
// TMA writes). The thread's swizzled addresses are taken once, so that every
// load is one of them plus a constant.
// FragRows: A = T (T's columns run along K).
template <int ROWS>
struct FragRows {
  uint32_t p[8];  // row ma, 16-byte chunk c of a panel, + 4·t4
  __device__ __forceinline__ FragRows(const uint8_t* t, int ma, int t4) {
#pragma unroll
    for (int c = 0; c < 8; ++c) p[c] = smem_u32(t) + ma * 128 + ((c ^ (ma & 7)) << 4) + 4 * t4;
  }
  __device__ __forceinline__ void operator()(int kk, float (&a)[4]) const {
    const int c = 2 * (kk % 4), pn = (kk / 4) * ROWS * 128;
    a[0] = lds(p[c] + pn);
    a[1] = lds(p[c] + pn + 1024);  // row ma + 8: the same swizzle
    a[2] = lds(p[c + 1] + pn);
    a[3] = lds(p[c + 1] + pn + 1024);
  }
};
// FragCols: A = Tᵀ (T's rows run along K) at A rows m0 + ml and m0 + ml + 8
// (T's columns; m0 a multiple of 64, the operator's argument).
template <int ROWS>
struct FragCols {
  uint32_t p[2][2];  // [k row t4 or t4 + 4][column ml or ml + 8]
  __device__ __forceinline__ FragCols(const uint8_t* t, int ml, int t4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = ml + 8 * j, r = t4 + 4 * h;
        p[h][j] = smem_u32(t) + (m / 32) * ROWS * 128 + r * 128 +
                  ((((m % 32) / 4) ^ r) << 4) + 4 * (m % 4);
      }
  }
  __device__ __forceinline__ void operator()(int m0, int kk, float (&a)[4]) const {
    const int off = (m0 / 32) * ROWS * 128 + kk * 1024;  // 8 rows a step
    a[0] = lds(p[0][0] + off);
    a[1] = lds(p[0][1] + off);
    a[2] = lds(p[1][0] + off);
    a[3] = lds(p[1][1] + off);
  }
};
// FragCols at one 64-row slice of A
template <int ROWS>
struct FragColsAt {
  const FragCols<ROWS>& f;
  int m0;
  __device__ __forceinline__ void operator()(int kk, float (&a)[4]) const { f(m0, kk, a); }
};

// keep registers live up to this point (past a wgmma wait): the wgmmas
// that read them run asynchronously
template <int N>
__device__ __forceinline__ void keep(const uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(r[i][e]) : "memory");
}

// acc (64 × N) = A·B over KS k8 steps, 3×TF32; one TF32 pass (hi·hi alone)
// when passes is 1, a planted fault. A's fragments come from `frag` and
// split in registers; B is K-major, N rows in 128-byte swizzled panels
// N·128 bytes apart, raw at b_raw and its lo part at b_lo. Chunks of CH
// steps; a chunk's wgmmas run while the next chunk's fragments load.
// The tensor cores' float32 sums drop the bits that an add shifts out, so
// every wgmma into an accumulator costs up to an ulp of it: hi·hi goes into
// acc and the two small products (hi·lo, lo·hi) into an accumulator of
// their own, added to acc at the end by a rounding add; acc is
// overwritten, and sums across steps are taken outside, in registers.
template <int N, int KS, int CH, class Frag>
__device__ __forceinline__ void gemm3(float (&acc)[N / 2], const Frag& frag, uint32_t b_raw,
                                      uint32_t b_lo, int passes) {
  static_assert(KS % CH == 0, "whole chunks");
  constexpr int NCH = KS / CH;
  uint32_t hi[2][CH][4], lo[2][CH][4];
  // acc and cor take no value in: their first wgmmas overwrite them (an
  // instruction that set them here could land inside the wgmma pipeline,
  // and ptxas would serialize it)
  float cor[N / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int s = c & 1;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float a[4];
      frag(c * CH + j, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[s][j][e] = __float_as_uint(a[e]) & TF32_MASK;
        lo[s][j][e] = __float_as_uint(a[e] - __uint_as_float(hi[s][j][e]));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int kk = c * CH + j;
      const uint32_t off = (kk / 4) * N * 128 + (kk % 4) * 32;
      const int add = kk > 0;
      if (passes == 3) {
        wgmma_rs_tf32<N>(cor, hi[s][j], desc<128>(b_lo + off), add);
        wgmma_rs_tf32<N>(cor, lo[s][j], desc<128>(b_raw + off), 1);
      }
      wgmma_rs_tf32<N>(acc, hi[s][j], desc<128>(b_raw + off), add);
    }
    wgmma_commit();
    if (c + 1 < NCH) {
      wgmma_wait1();
      if (c > 0) {
        keep(hi[s ^ 1]);
        keep(lo[s ^ 1]);
      }
    } else {
      wgmma_wait0();
      keep(hi[s]);
      keep(lo[s]);
      if (c > 0) {
        keep(hi[s ^ 1]);
        keep(lo[s ^ 1]);
      }
    }
  }
  reg_fence(acc);
  reg_fence(cor);
  if (passes == 3) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] += cor[e];
  }
}

// dP (dPᵀ) on int8 tiles (dp): s32 sums, converted
template <int N, int HD>
__device__ __forceinline__ void dp_s8(float (&dp)[N / 2], uint32_t a, uint32_t b) {
  int dpi[N / 2];
  wgmma_fence();
  ss_gemm_s8<N, HD>(dpi, a, b);
  wgmma_commit();
  wgmma_wait0();
  reg_fence(dpi);
#pragma unroll
  for (int e = 0; e < N / 2; ++e) dp[e] = (float)dpi[e];
}

// the lo parts of BYTES of float32 words at raw into lo (same layout), by
// the producer warpgroup's 128 threads
template <int BYTES>
__device__ __forceinline__ void split_pass(const uint8_t* raw, uint8_t* lo, int tid) {
  static_assert(BYTES % (16 * 128) == 0, "whole float4 rounds");
#pragma unroll 4
  for (int i = tid; i < BYTES / 16; i += 128) {
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    reinterpret_cast<float4*>(lo)[i] =
        make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
  }
}

// a 64 × N accumulator (rows ra, rb) into a 64-row float32 tile of N
// columns (the K-major B of a later product), raw and lo; lo_col: lo's
// place in its tile, bytes right of raw's (64 where 16 columns leave a
// 128-byte row's right half to lo, in raw's own tile)
template <int N>
__device__ __forceinline__ void put_tile(const float (&x)[N / 2], uint8_t* raw, uint8_t* lo,
                                         int ra, int rb, int t4, int lo_col) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra, col = 4 * (8 * j + 2 * t4);
      const float a = x[4 * j + 2 * half], b = x[4 * j + 2 * half + 1];
      *reinterpret_cast<float2*>(raw + tile_off<128, 64>(row, col)) = make_float2(a, b);
      *reinterpret_cast<float2*>(lo + tile_off<128, 64>(row, col + lo_col)) =
          make_float2(tf32_lo(a), tf32_lo(b));
    }
}

// consumer warpgroup wg's own barrier (its 128 threads)
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// ------------------------------------------------ a cluster's partial sums

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
// every thread of every CTA of the cluster, release then acquire at
// cluster scope
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}
// a shared-memory address of this CTA as the same place in CTA `rank`'s
// shared memory (the cluster window)
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// mbar_wait, acquiring at cluster scope what the peers' stores brought
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}
// 16 bytes into the cluster window address `to` (this CTA's shared memory
// or a peer's), completing 16 bytes of the transaction count of the
// barrier at the window address `bar` in the same CTA
__device__ __forceinline__ void st_async4(uint32_t to, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(to), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// The cluster's sum of a 64 × N product over the head dim, taken by one
// consumer warpgroup (wtid its thread) in each CTA, in two halves. Each
// CTA's `slots` (for
// the step's parity) hold the CL − 1 peers' partials, N / 8 float4 a
// thread (thread-major), the partial of rank r in slot r, or r − 1 past
// this CTA's own rank; `bar` is their full barrier, armed for their bytes
// (one arrival with expect_tx) and completed by the stores. cluster_put:
// x, this CTA's partial (its slice's), stored into its slot in every peer
// by st.async, each store completing its bytes on that CTA's barrier: no
// fence, no remote load. cluster_get: once the barrier's phase for the
// step (`phase`) has completed, x becomes the CL partials added in rank
// order, own (this CTA's, in registers) at its rank: the same sum bit for
// bit in every CTA. Then the barrier is armed for the step two ahead (its
// next phase, which no store can reach before every thread here has
// passed this wait: a peer stores that step's partial only after this
// CTA's next one has reached it).
template <int CL, int N>
__device__ __forceinline__ void cluster_put(const float (&x)[N / 2], float* slots, uint64_t* bar,
                                            int rank, int wtid) {
  static_assert(N % 8 == 0, "whole float4s");
#pragma unroll
  for (int r = 0; r < CL; ++r) {
    if (r == rank) continue;
    const int slot = rank - (rank > r);  // this CTA's slot in CTA r
    const float4* mine = reinterpret_cast<float4*>(slots + slot * N * 64) + wtid;
    const uint32_t to = mapa(smem_u32(mine), r);
    const uint32_t at = mapa(smem_u32(bar), r);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      st_async4(to + j * 128 * 16,
                make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]), at);
  }
}
template <int CL, int N>
__device__ __forceinline__ void cluster_get(float (&x)[N / 2], const float (&own)[N / 2],
                                            const float* slots, uint64_t* bar, int phase, int rank,
                                            int wtid) {
  mbar_wait_cluster(bar, phase);
  const float4* got = reinterpret_cast<const float4*>(slots) + wtid;
#pragma unroll
  for (int r = 0; r < CL; ++r)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float4 v = r == rank ? make_float4(own[4 * j], own[4 * j + 1], own[4 * j + 2],
                                               own[4 * j + 3])
                                 : got[(r - (r > rank)) * N * 16 + j * 128];
      if (r == 0) {
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
      } else {
        x[4 * j] += v.x;
        x[4 * j + 1] += v.y;
        x[4 * j + 2] += v.z;
        x[4 * j + 3] += v.w;
      }
    }
  if (wtid == 0) mbar_expect_tx(bar, (CL - 1) * N * 64 * 4);
}

// The cluster's sum x of a consumer's score product of step t: part, this
// CTA's partial, put into the peers' slots, then the CL partials added
// (`xch`, `x_bar`: this consumer's slots for the two step parities and
// their barriers). part is the product's accumulator, x another array: an
// accumulator that other instructions write makes ptxas serialize the
// wgmmas (C7515). The warpgroup barrier after the reads makes them
// performed before this CTA's next partial can lead a peer to overwrite
// them (a peer stores its partial of step t + 2 only after this CTA's of
// step t + 1 has reached it).
template <int CL, int N>
__device__ __forceinline__ void cluster_sum(const float (&part)[N / 2], float (&x)[N / 2], int t,
                                            float* xch, uint64_t* x_bar, int rank, int wtid,
                                            int wg) {
  constexpr int SLOTS = (CL - 1) * N * 64;  // floats of a parity's slots
  cluster_put<CL, N>(part, xch + (t & 1) * SLOTS, &x_bar[t & 1], rank, wtid);
  cluster_get<CL, N>(x, part, xch + (t & 1) * SLOTS, &x_bar[t & 1], (t >> 1) & 1, rank, wtid);
  consumer_sync(wg);
}

// Shared memory: RESIDENT bytes loaded once, EXTRA bytes of the consumer's
// own tiles, as many ring stages of STAGE bytes (plus ROWS bytes of row
// vectors each) as fit (up to 3), a barrier for the resident tiles and three
// a stage, 1024 bytes of alignment slack. One CTA an SM.
template <int RESIDENT, int EXTRA, int STAGE, int ROWS>
struct F32Plan {
  static constexpr int bytes(int st) {
    return 1024 + RESIDENT + EXTRA + st * (STAGE + ROWS) + (3 * st + 1) * 8;
  }
  static constexpr int ST = bytes(3) <= SMEM_LIMIT ? 3 : bytes(2) <= SMEM_LIMIT ? 2 : 1;
  static constexpr int SMEM = bytes(ST);
  static_assert(SMEM <= SMEM_LIMIT, "above the shared memory a block may use");
  static_assert(RESIDENT % 1024 == 0 && EXTRA % 1024 == 0 && STAGE % 1024 == 0,
                "swizzled tiles need 1024-byte bases");
};

// registers a thread after setmaxnreg (a producer warpgroup and one or two
// consumer ones, one CTA an SM): 128·(PRODUCER + 2·CONSUMER) <= 65536
constexpr int PRODUCER = 40, CONSUMER = 232;

// The partial-sum slots of a cluster's CTA: for each consumer's score
// product and step parity, CL − 1 slots of a 64 × N float32 partial (BUF
// bytes), one for each peer; then their four full barriers in a
// 1024-byte slot; none without a cluster.
template <int CL, int N> struct Xch {
  static constexpr int BUF = 64 * N * 4;
  static constexpr int SLOTS = 4 * (CL - 1) * BUF;  // the barriers' offset
  static constexpr int BYTES = CL > 1 ? SLOTS + 1024 : 0;
};

// B4: 64 q rows of Q and dO (dÔ under dp) resident; a stage holds K, V (V̂)
// as TMA wrote them, then the lo tiles of K (and V); the consumers' own
// tiles are dS, its lo part and P, [q][key], and under a cluster the
// partial sums. HD: the CTA's columns (the width, or a 128-column slice
// of CL).
template <int HD, bool DP, int CL> struct F32DqCfg {
  static_assert(!DP || HD == 128, "dp only at 128 columns a CTA");
  static_assert(CL == 1 || HD == 128, "a cluster splits the head dim into 128-column slices");
  static constexpr int BQ = 64, BKV = HD == 64 ? 64 : CL > 1 ? 16 : 32;
  static constexpr int QBYTES = BQ * HD * 4;
  static constexpr int DOBYTES = BQ * HD * (DP ? 1 : 4);
  static constexpr int KT = BKV * HD * 4;
  static constexpr int VT = BKV * HD * (DP ? 1 : 4);
  static constexpr int TX = KT + VT;                  // TMA bytes a stage
  static constexpr int SPLIT = DP ? KT : KT + VT;     // bytes whose lo is written
  static constexpr int STAGE = TX + SPLIT;
  // dS and P [q][key] in 128-byte rows; at 16 keys dS's lo fills the
  // right half of its raw tile's rows (LO_COL bytes right), else a tile
  static constexpr bool PACK = BKV < 32;
  static constexpr int DS = BQ * (PACK ? 32 : BKV) * 4;
  static constexpr int DS_LO = PACK ? 0 : DS, LO_COL = PACK ? 64 : 0;
  static constexpr int CH = 4, CHG = BKV / 8 >= 4 ? 4 : BKV / 8;  // fragment chunks
  using X = Xch<CL, BKV>;
  using P = F32Plan<QBYTES + DOBYTES, 2 * DS + DS_LO + X::BYTES, STAGE, 0>;
};

// B5: 64 kv rows of K and V (V̂) resident; a stage holds Q, dO (and under dp
// qs, dÔ) as TMA wrote them, then the lo tiles of Q (and dO), and lse2 and
// Δ of the step's rows; the consumer's own tiles are P, its lo part, dS and
// its lo part, [key][q], and under a cluster the partial sums.
template <int HD, bool DP, int CL> struct F32DkvCfg {
  static_assert(!DP || HD == 128, "dp only at 128 columns a CTA");
  static_assert(CL == 1 || HD == 128, "a cluster splits the head dim into 128-column slices");
  static constexpr int BKV = 64, BQ = HD == 64 ? 64 : CL > 1 ? 16 : 32;
  static constexpr int KBYTES = BKV * HD * 4;
  static constexpr int VBYTES = BKV * HD * (DP ? 1 : 4);
  static constexpr int T = BQ * HD * 4;
  static constexpr int QS_OFF = 2 * T, DO8_OFF = 3 * T;  // dp only
  static constexpr int TX = DP ? 3 * T + BQ * HD : 2 * T;
  static_assert(!DP || DO8_OFF + BQ * HD == TX, "dÔ ends the TMA bytes");
  static constexpr int SPLIT = DP ? T : 2 * T;
  static constexpr int STAGE = TX + SPLIT;
  // P and dS [key][q] in 128-byte rows; at 16 q rows each lo fills the
  // right half of its raw tile's rows (LO_COL bytes right), else a tile:
  // NT tiles, P's then dS's
  static constexpr bool PACK = BQ < 32;
  static constexpr int PT = BKV * (PACK ? 32 : BQ) * 4;
  static constexpr int NT = PACK ? 2 : 4, LO_COL = PACK ? 64 : 0;
  static constexpr int ROWS = 2 * BQ * 4;
  static constexpr int CH = 4, CHG = BQ / 8 >= 4 ? 4 : BQ / 8;  // fragment chunks
  using X = Xch<CL, BQ>;
  using P = F32Plan<KBYTES + VBYTES, NT * PT + X::BYTES, STAGE, ROWS>;
};

// B4: dQ of one (64-row q tile, bh row), or of its 128-column slice
// (rank) under a cluster of CL. Two consumer warpgroups share each step:
// consumer 0 takes S and P, consumer 1 dP and dS, P going from 0 to 1 and
// dS back through shared memory under named barriers (P_READY, P_FREE,
// DS_READY, DS_FREE); dQᵀ's 64-row slices of the CTA's columns are summed
// in turns (at width 64, its one slice by consumer 0).
template <int HD, bool DP, int CL>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_f32(const __grid_constant__ Maps m, const BwdParams p) {
  using C = F32DqCfg<HD, DP, CL>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::P::ST, PANELS = HD / 32;
  constexpr int STAGE = C::STAGE, MT = HD / 64, OWN = MT > 1 ? MT / 2 : 1;
  constexpr int D = HD * CL;  // the head dim, the rows' pitch
  constexpr int P_READY = 4, P_FREE = 5, DS_READY = 6, DS_FREE = 7;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                       // 64 rows of Q, PANELS panels
  uint8_t* dos = qs + C::QBYTES;            // the same rows of dO (dÔ)
  uint8_t* ds_raw = dos + C::DOBYTES;       // dS [q][key], raw and lo
  uint8_t* ds_lo = ds_raw + C::DS_LO;
  uint8_t* pt = ds_raw + C::DS + C::DS_LO;  // P [q][key]
  float* xch = reinterpret_cast<float*>(pt + C::DS);  // CL > 1: [S, dP][parity][rank] partials
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(pt + C::DS + C::X::SLOTS);
  uint8_t* stages = pt + C::DS + C::X::BYTES;  // ST × (K, V, K lo, V lo)
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(stages + ST * STAGE);
  uint64_t* full_bar = q_bar + 1;
  uint64_t* ready_bar = full_bar + ST;
  uint64_t* empty_bar = ready_bar + ST;

  const Sched s = sched_of(p);
  const int n_tiles = (s.n_q + BQ - 1) / BQ;
  // the heaviest causal q tiles first
  const int qt = s.kind == CAUSAL ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x / CL;
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int col0 = HD * rank;  // this CTA's columns [col0, col0 + HD)
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
    // ---------------- producer: TMA, then the lo tiles ----------------
    reg_dealloc<PRODUCER>();
    if (wtid == 0) {
      mbar_expect_tx(q_bar, C::QBYTES + C::DOBYTES);
      for (int pn = 0; pn < PANELS; ++pn)
        tma_load_3d(qs + pn * BQ * 128, &m.q, (PANELS * rank + pn) * 128, q0, b, q_bar);
      if constexpr (DP)
        tma_load_3d(dos, &m.do8, 128 * rank, q0, b, q_bar);
      else
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(dos + pn * BQ * 128, &m.dout, (PANELS * rank + pn) * 128, q0, b, q_bar);
    }
    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      uint8_t* st = stages + i * STAGE;
      if (wtid == 0) {
        const int k0 = (first + t) * BKV;
        mbar_wait(&empty_bar[i], ph ^ 1);
        mbar_expect_tx(&full_bar[i], C::TX);
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(st + pn * BKV * 128, &m.k, (PANELS * rank + pn) * 128, k0, kv_row,
                      &full_bar[i]);
        if constexpr (DP)
          tma_load_3d(st + C::KT, &m.v, 128 * rank, k0, kv_row, &full_bar[i]);
        else
          for (int pn = 0; pn < PANELS; ++pn)
            tma_load_3d(st + C::KT + pn * BKV * 128, &m.v, (PANELS * rank + pn) * 128, k0,
                        kv_row, &full_bar[i]);
      }
      mbar_wait(&full_bar[i], ph);
      split_pass<C::SPLIT>(st, st + C::TX, wtid);
      fence_async_smem();
      mbar_arrive(&ready_bar[i]);
    }
  } else {
    // ---------------- consumers: the 64 q rows ----------------
    reg_alloc<CONSUMER>();
    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int qa = q0 + ra, qb = q0 + rb;
    const size_t base = (size_t)b * s.n_q;
    // consumer 0: lse2, the keys each of the two rows sees (empty past
    // n_q); consumer 1: Δ
    const float* rowv = wg == 0 ? p.lse2 : p.delta;
    const float va = qa < s.n_q ? rowv[base + qa] : 0.0f;
    const float vb = qb < s.n_q ? rowv[base + qb] : 0.0f;
    const Span span_a = key_span(s, qa), span_b = key_span(s, qb);
    const bool sums = MT > 1 || wg == 0;  // this consumer sums dQᵀ slices
    float dqt[OWN][32];  // dQᵀ: slices mt = 2·o + wg (mt 0 at width 64) × 64 q
#pragma unroll
    for (int o = 0; o < OWN; ++o)
#pragma unroll
      for (int e = 0; e < 32; ++e) dqt[o][e] = 0.0f;
    const uint32_t ds_raw_a = smem_u32(ds_raw), ds_lo_a = smem_u32(ds_lo) + C::LO_COL;
    // A of the score product: Q (S, consumer 0) or dO (dP, 1)
    const FragRows<BQ> fa(wg == 0 ? qs : dos, ra, t4);
    mbar_wait(q_bar, 0);

    // this consumer's slots and barriers of the cluster's partials
    float* slots = xch + 2 * wg * (CL - 1) * (C::X::BUF / 4);
    uint64_t* bars = &x_bar[2 * wg];

    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int k0 = (first + t) * BKV;
      const uint8_t* st = stages + i * STAGE;
      mbar_wait(&full_bar[i], ph);
      mbar_wait(&ready_bar[i], ph);
      float x[BKV / 2];
      if (wg == 0) {
        // S = Q·Kᵀ (the cluster's sum of its slices' partials); p =
        // exp2(s − lse2), the mask only on a tile not wholly visible; P to
        // consumer 1 once it has read the last
        {
          float part[BKV / 2];
          float (&sc)[BKV / 2] = CL > 1 ? part : x;
          gemm3<BKV, HD / 8, C::CH>(sc, fa, smem_u32(st), smem_u32(st + C::TX), p.tf32_passes);
          if constexpr (CL > 1) cluster_sum<CL, BKV>(part, x, t, slots, bars, rank, wtid, wg);
        }
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) x[e] = exp2f(x[e] - ((e & 2) ? vb : va));
        if (!tile_full(s, k0, k0 + BKV - 1, q0, q_last)) {
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) {
            const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
            if (!in_span((e & 2) ? span_b : span_a, kpos)) x[e] = 0.0f;
          }
        }
        if (t > 0) handoff_sync(P_FREE);
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(pt + tile_off<128, 64>(half ? rb : ra, 4 * (8 * j + 2 * t4))) =
                make_float2(x[4 * j + 2 * half], x[4 * j + 2 * half + 1]);
        handoff_arrive(P_READY);
        handoff_sync(DS_READY);
      } else {
        // dP = dO·Vᵀ (dÔ·V̂ᵀ; the cluster's sum); ds = p∘(dp − Δ) in
        // float32, p read back at this thread's own places; dS, raw and lo,
        // as the B operand of dQᵀ += Kᵀ·dS once consumer 0's last dQᵀ
        // products are done
        {
          float part[BKV / 2];
          float (&dp)[BKV / 2] = CL > 1 ? part : x;
          if constexpr (DP)
            dp_s8<BKV, HD>(dp, smem_u32(dos), smem_u32(st + C::KT));
          else
            gemm3<BKV, HD / 8, C::CH>(dp, fa, smem_u32(st + C::KT), smem_u32(st + C::TX + C::KT),
                                      p.tf32_passes);
          if constexpr (CL > 1) cluster_sum<CL, BKV>(part, x, t, slots, bars, rank, wtid, wg);
        }
        handoff_sync(P_READY);
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 pv = *reinterpret_cast<const float2*>(
                pt + tile_off<128, 64>(half ? rb : ra, 4 * (8 * j + 2 * t4)));
            const float dl = half ? vb : va;
            x[4 * j + 2 * half] = pv.x * (x[4 * j + 2 * half] - dl);
            x[4 * j + 2 * half + 1] = pv.y * (x[4 * j + 2 * half + 1] - dl);
          }
        if (t + 1 < steps) handoff_arrive(P_FREE);
        if (t > 0) handoff_sync(DS_FREE);
        put_tile<BKV>(x, ds_raw, ds_lo, ra, rb, t4, C::LO_COL);
        fence_async_smem();
        consumer_sync(1);
        handoff_arrive(DS_READY);
      }
      // dQᵀ += Kᵀ·dS on this consumer's slices, the step's sum taken in
      // registers (a rounding add)
      if (sums) {
        const FragCols<BKV> fk(st, ra, t4);
#pragma unroll
        for (int o = 0; o < OWN; ++o) {
          float part[32];
          gemm3<64, BKV / 8, C::CHG>(part, FragColsAt<BKV>{fk, 64 * (MT > 1 ? 2 * o + wg : 0)},
                                     ds_raw_a, ds_lo_a, p.tf32_passes);
#pragma unroll
          for (int e = 0; e < 32; ++e) dqt[o][e] += part[e];
        }
      }
      if (wg == 0 && t + 1 < steps) handoff_arrive(DS_FREE);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[i]);
    }
    // dQ = dQᵀ transposed, times ln2 (σdo·ln2 under dp: ds = σdo·ds_raw)
    if (sums) {
      float* dq = static_cast<float*>(p.dq);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qpos = q0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        if (qpos >= s.n_q) continue;
        const float scale = DP ? p.sdo[base + qpos] * LN2 : LN2;
#pragma unroll
        for (int o = 0; o < OWN; ++o)
          dq[(base + qpos) * D + col0 + 64 * (MT > 1 ? 2 * o + wg : 0) + ((e & 2) ? rb : ra)] =
              dqt[o][e] * scale;
      }
    }
  }
  if constexpr (CL > 1) cluster_sync();  // no peer reads this CTA's partials any more
}

// B5: dK and dV of one (64-row kv tile, bh_kv row), or of its 128-column
// slice (rank) under a cluster of CL, summed over the g query heads of its
// group. Two consumer warpgroups share each step: consumer 0 takes Sᵀ, P
// and dVᵀ += dOᵀ·P, consumer 1 dPᵀ, dS and dKᵀ += Qᵀ·dS (qs under dp), the
// output's halves each its own; P goes from 0 to 1 through the P tile under
// named barriers (P_READY after 0 wrote it, P_FREE after 1 read it), dS
// stays 1's. A slice at or past the caller's value dim (p.dv_cols) takes no
// dV.
template <int HD, bool DP, int CL>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_f32(const __grid_constant__ Maps m, const BwdParams p) {
  using C = F32DkvCfg<HD, DP, CL>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::P::ST, PANELS = HD / 32;
  constexpr int STAGE = C::STAGE, PT = C::PT;
  constexpr int D = HD * CL;  // the head dim, the rows' pitch
  constexpr int P_READY = 4, P_FREE = 5;  // named barriers of both consumers
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem;                       // 64 rows of K, PANELS panels
  uint8_t* vs = ks + C::KBYTES;             // the same rows of V (V̂)
  uint8_t* pt = vs + C::VBYTES;             // P raw[, P lo], dS raw[, dS lo]: [key][q]
  float* xch = reinterpret_cast<float*>(pt + C::NT * PT);  // CL > 1: [Sᵀ, dPᵀ][parity][peer]
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(pt + C::NT * PT + C::X::SLOTS);
  uint8_t* stages = pt + C::NT * PT + C::X::BYTES;  // ST × (Q, dO[, qs, dÔ], Q lo[, dO lo])
  float* rows_all = reinterpret_cast<float*>(stages + ST * STAGE);  // ST × (lse2, Δ)
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(stages + ST * (STAGE + C::ROWS));
  uint64_t* full_bar = kv_bar + 1;
  uint64_t* ready_bar = full_bar + ST;
  uint64_t* empty_bar = ready_bar + ST;

  const Sched s = sched_of(p);
  const int kv_row = blockIdx.x / CL;
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int col0 = HD * rank;  // this CTA's columns [col0, col0 + HD)
  const bool with_dv = CL == 1 || col0 < p.dv_cols;  // a padded v's columns: zeros
  const int k0 = blockIdx.y * BKV, k_hi = min(k0 + BKV - 1, s.n_kv - 1);
  const int g = p.hq / p.hkv;
  const int q_row0 = (kv_row / p.hkv) * p.hq + (kv_row % p.hkv) * g;
  // the q tiles that see a key of this tile (the transposed visit)
  int first, last;
  q_range(s, k0, k_hi, BQ, first, last);
  const int per_head = max(0, last - first + 1);
  const int steps = g * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], 1);
      mbar_init(&ready_bar[i], 128);
      mbar_init(&empty_bar[i], 8);  // lane 0 of both consumers' warps
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
    // ---------------- producer: TMA, then the lo tiles and rows ----------------
    reg_dealloc<PRODUCER>();
    if (wtid == 0) {
      mbar_expect_tx(kv_bar, C::KBYTES + C::VBYTES);
      for (int pn = 0; pn < PANELS; ++pn)
        tma_load_3d(ks + pn * BKV * 128, &m.k, (PANELS * rank + pn) * 128, k0, kv_row, kv_bar);
      if constexpr (DP)
        tma_load_3d(vs, &m.v, 128 * rank, k0, kv_row, kv_bar);
      else
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(vs + pn * BKV * 128, &m.v, (PANELS * rank + pn) * 128, k0, kv_row, kv_bar);
    }
    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int bq = q_row0 + t / per_head, q0 = (first + t % per_head) * BQ;
      uint8_t* st = stages + i * STAGE;
      if (wtid == 0) {
        mbar_wait(&empty_bar[i], ph ^ 1);
        mbar_expect_tx(&full_bar[i], C::TX);
        for (int pn = 0; pn < PANELS; ++pn) {
          const int c0 = (PANELS * rank + pn) * 128;
          tma_load_3d(st + pn * BQ * 128, &m.q, c0, q0, bq, &full_bar[i]);
          tma_load_3d(st + C::T + pn * BQ * 128, &m.dout, c0, q0, bq, &full_bar[i]);
          if constexpr (DP)
            tma_load_3d(st + C::QS_OFF + pn * BQ * 128, &m.qs, c0, q0, bq, &full_bar[i]);
        }
        if constexpr (DP) tma_load_3d(st + C::DO8_OFF, &m.do8, 128 * rank, q0, bq, &full_bar[i]);
      }
      mbar_wait(&full_bar[i], ph);
      float* rows = rows_all + i * 2 * BQ;
      const size_t base = (size_t)bq * s.n_q + q0;
      for (int r = wtid; r < BQ; r += 128) {
        const bool in = q0 + r < s.n_q;
        rows[r] = in ? p.lse2[base + r] : 0.0f;
        rows[BQ + r] = in ? p.delta[base + r] : 0.0f;
      }
      split_pass<C::SPLIT>(st, st + C::TX, wtid);
      fence_async_smem();
      mbar_arrive(&ready_bar[i]);
    }
  } else {
    // ---------------- consumers: the 64 kv rows ----------------
    reg_alloc<CONSUMER>();
    const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
    const int ka = k0 + ra, kb = k0 + rb;
    // consumer 0: the queries that see each of the two rows (empty past n_kv)
    const Span span_a = query_span(s, ka), span_b = query_span(s, kb);
    float acc[HD / 64][32];  // dVᵀ (consumer 0) or dKᵀ (1): head-dim slices × 64 keys
#pragma unroll
    for (int mt = 0; mt < HD / 64; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mt][e] = 0.0f;
    uint8_t* p_raw = pt;
    uint8_t* p_lo = C::PACK ? pt : pt + PT;
    uint8_t* ds_raw = pt + C::NT / 2 * PT;
    uint8_t* ds_lo = C::PACK ? ds_raw : ds_raw + PT;
    // A of the score product: K (Sᵀ, consumer 0) or V (dPᵀ, 1)
    const FragRows<BKV> fa(wg == 0 ? ks : vs, ra, t4);
    mbar_wait(kv_bar, 0);

    // this consumer's slots and barriers of the cluster's partials
    float* slots = xch + 2 * wg * (CL - 1) * (C::X::BUF / 4);
    uint64_t* bars = &x_bar[2 * wg];

    for (int t = 0; t < steps; ++t) {
      const int i = t % ST, ph = (t / ST) & 1;
      const int q0 = (first + t % per_head) * BQ;
      const uint8_t* st = stages + i * STAGE;
      const float* rows = rows_all + i * 2 * BQ;
      mbar_wait(&full_bar[i], ph);
      mbar_wait(&ready_bar[i], ph);
      float x[BQ / 2];
      if (wg == 0) {
        // Sᵀ = K·Qᵀ (the cluster's sum); pᵀ = exp2(sᵀ − lse2), each
        // column's lse2 from the stage; the mask only on a tile not wholly
        // visible
        {
          float part[BQ / 2];
          float (&sc)[BQ / 2] = CL > 1 ? part : x;
          gemm3<BQ, HD / 8, C::CH>(sc, fa, smem_u32(st), smem_u32(st + C::TX), p.tf32_passes);
          if constexpr (CL > 1) cluster_sum<CL, BQ>(part, x, t, slots, bars, rank, wtid, wg);
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
          for (int c = 0; c < 4; ++c) x[4 * j + c] = exp2f(x[4 * j + c] - ((c & 1) ? l.y : l.x));
        }
        if (!(q0 + BQ - 1 < s.n_q && tile_full(s, k0, k0 + BKV - 1, q0, q0 + BQ - 1))) {
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {
            const int qpos = q0 + 8 * (e / 4) + 2 * t4 + (e & 1);
            if (!in_span((e & 2) ? span_b : span_a, qpos)) x[e] = 0.0f;
          }
        }
        // P into its tile, raw and lo, once consumer 1 has read the last
        if (t > 0) handoff_sync(P_FREE);
        put_tile<BQ>(x, p_raw, p_lo, ra, rb, t4, C::LO_COL);
        fence_async_smem();
        handoff_arrive(P_READY);
        consumer_sync(wg);
        // dVᵀ += dOᵀ·P, the step's sum taken in registers
        if (with_dv) {
          const FragCols<BQ> fdo(st + C::T, ra, t4);
#pragma unroll
          for (int mt = 0; mt < HD / 64; ++mt) {
            float part[32];
            gemm3<64, BQ / 8, C::CHG>(part, FragColsAt<BQ>{fdo, 64 * mt}, smem_u32(p_raw),
                                      smem_u32(p_lo) + C::LO_COL, p.tf32_passes);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[mt][e] += part[e];
          }
        }
      } else {
        // dPᵀ = V·dOᵀ (V̂·dÔᵀ; the cluster's sum); dsᵀ = pᵀ∘(dpᵀ − Δ), pᵀ
        // read back from consumer 0's tile at this thread's own places
        {
          float part[BQ / 2];
          float (&dp)[BQ / 2] = CL > 1 ? part : x;
          if constexpr (DP)
            dp_s8<BQ, HD>(dp, smem_u32(vs), smem_u32(st + C::DO8_OFF));
          else
            gemm3<BQ, HD / 8, C::CH>(dp, fa, smem_u32(st + C::T), smem_u32(st + C::TX + C::T),
                                     p.tf32_passes);
          if constexpr (CL > 1) cluster_sum<CL, BQ>(part, x, t, slots, bars, rank, wtid, wg);
        }
        handoff_sync(P_READY);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * t4);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 pv = *reinterpret_cast<const float2*>(
                p_raw + tile_off<128, 64>(half ? rb : ra, 4 * (8 * j + 2 * t4)));
            x[4 * j + 2 * half] = pv.x * (x[4 * j + 2 * half] - dl.x);
            x[4 * j + 2 * half + 1] = pv.y * (x[4 * j + 2 * half + 1] - dl.y);
          }
        }
        if (t + 1 < steps) handoff_arrive(P_FREE);
        put_tile<BQ>(x, ds_raw, ds_lo, ra, rb, t4, C::LO_COL);
        fence_async_smem();
        consumer_sync(wg);
        // dKᵀ += Qᵀ·dS (qsᵀ under dp), the step's sum taken in registers
        const FragCols<BQ> fq(DP ? st + C::QS_OFF : st, ra, t4);
#pragma unroll
        for (int mt = 0; mt < HD / 64; ++mt) {
          float part[32];
          gemm3<64, BQ / 8, C::CHG>(part, FragColsAt<BQ>{fq, 64 * mt}, smem_u32(ds_raw),
                                    smem_u32(ds_lo) + C::LO_COL, p.tf32_passes);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[mt][e] += part[e];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[i]);
    }
    // dV = dVᵀ transposed (consumer 0), dK = dKᵀ transposed times ln2 (1)
    if (wg == 1 || with_dv) {
      float* out = static_cast<float*>(wg == 0 ? p.dv : p.dk);
      const float scale = wg == 0 ? 1.0f : LN2;
      const size_t base = (size_t)kv_row * s.n_kv;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        if (kpos >= s.n_kv) continue;
#pragma unroll
        for (int mt = 0; mt < HD / 64; ++mt)
          out[(base + kpos) * D + col0 + 64 * mt + ((e & 2) ? rb : ra)] = acc[mt][e] * scale;
      }
    }
  }
  if constexpr (CL > 1) cluster_sync();  // no peer reads this CTA's partials any more
}

// a launch of CL-CTA clusters (CL 1: a plain launch); refused, as an
// error the wrapper raises, where the card cannot hold one such cluster.
// clusters: the kernel's own cache of how many the card holds at once
// (asked once; -1 before)
template <int CL, typename Kern>
cudaError_t launch_f32(Kern kern, dim3 grid, int smem, cudaStream_t stream, const Maps& m,
                       const BwdParams& p, int& clusters) {
  if constexpr (CL == 1) {
    (void)clusters;
    return launch_tc(kern, grid, 384, smem, stream, m, p);
  } else {
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(384);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (clusters < 0) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (err != cudaSuccess) {
        clusters = -1;
        return err;
      }
    }
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&cfg, kern, m, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
}

// HD: the CTA's columns; CL: CTAs a cluster (the head dim HD·CL)
template <int HD, bool DP, int CL>
cudaError_t launch_dq_f32(const BwdParams& p, int bh, cudaStream_t stream) {
  using C = F32DqCfg<HD, DP, CL>;
  Maps m;
  if (!make_maps<HD * CL, C::BQ, C::BKV, 4>(&m, p, bh)) return cudaErrorInvalidValue;
  const dim3 grid(bh * CL, (p.n_q + C::BQ - 1) / C::BQ);
  static int clusters = -1;
  return launch_f32<CL>(flash_bwd_dq_f32<HD, DP, CL>, grid, C::P::SMEM, stream, m, p, clusters);
}

template <int HD, bool DP, int CL>
cudaError_t launch_dkv_f32(const BwdParams& p, int bh_kv, cudaStream_t stream) {
  using C = F32DkvCfg<HD, DP, CL>;
  Maps m;
  if (!make_maps<HD * CL, C::BQ, C::BKV, 4>(&m, p, bh_kv / p.hkv * p.hq))
    return cudaErrorInvalidValue;
  const dim3 grid(bh_kv * CL, (p.n_kv + C::BKV - 1) / C::BKV);
  static int clusters = -1;
  return launch_f32<CL>(flash_bwd_dkv_f32<HD, DP, CL>, grid, C::P::SMEM, stream, m, p,
                        clusters);
}

}  // namespace
