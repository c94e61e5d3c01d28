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
// s8 wgmma, or __dp4a in float32); ds_raw = p∘(dP_raw − Δ/σdo); B4 scales
// its dq rows by σdo·ln2 in the epilogue, B5 takes dK += ds_rawᵀ·qs and
// keeps the exact dO for dV = Pᵀ·dO. Only where it applies: widths 128, 256
// and 512 (the reference ignores it at d, dv <= 64).
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
// bf16 at widths 256 and 512 (flash_bwd_tc.cuh, flash_bwd_wide.cu for
// 512), on the same blocks: 227 KB a CTA, one CTA an SM, two consumer
// warpgroups and a producer warp (setmaxnreg). A consumer's float32 sums
// cover at most 256 output columns (128 registers a thread). The ring holds
// items, a 256-column half of an operand tile or a whole int8 tile, in the
// order the consumers first read them, item j in slot j % NS; an item only
// the score products read (early) goes back to the producer once they are
// done, the rest (late) at the end of the step, so the next step's early
// items load during this step's elementwise pass and gradient products.
// Where the two consumers both take a step, one takes S (Sᵀ) and the other
// dP (dPᵀ), each over the full width: the first hands its float32 p to the
// second through shared memory under a named barrier, the second returns
// ds as bf16 fragments under another, and each runs the gradient products
// of its own columns (ds = p∘(dP − Δ) in float32, as the reference casts).
// - B4: 64 q rows of Q and dO (dÔ) resident; a step's items V's halves or
//   V̂ (early), then K's halves (late). At 256, kv steps of 64 rows (32 KB
//   items); the consumers take the steps in turn, each summing all 256 dQ
//   columns, the two sums added in the drained ring (consumer 1's to
//   consumer 0's, a fixed order). At 512, kv steps of 32 rows (16 KB
//   items), both consumers on every step, consumer c summing dQ's columns
//   [256c, +256): S and dP are computed once, and K and V read once a q
//   tile.
// - B5: 64 kv rows of K and V (V̂) resident; q steps of 64 rows at 256
//   (items Q, dO), 32 at 512. dK + dV of 64 rows × 256 columns would take
//   256 registers a thread, so at 512 the output's 256-column halves go on
//   the grid (folded into blockIdx.x beside the bh_kv row, so that the
//   heaviest causal tiles still launch first), each half's CTA taking the
//   score products over the full width (its items: the other halves of Q
//   and dO, early, then its own); both consumers take every step, each
//   owning 128 of the CTA's 256 dK and dV columns, consumer 0 Sᵀ and
//   consumer 1 dPᵀ. The recomputation across the halves caps B5 at 512 at
//   67% of the bound. lse2 and Δ of a step's rows ride with its first late
//   item (the producer warp's lanes copy them, as at 64 and 128).
// - dp: B4's resident dO becomes dÔ and V's items one V̂ item; B5's resident
//   V becomes V̂ and a step's items become Q's halves and dÔ (early), then
//   this CTA's half of dO (dV) and of qs (dK), late.
// - Ordering the two consumers' products in turns under named barriers (so
//   that one's elementwise pass runs under the other's products) measured
//   no faster (PERF.md §6).
//
// float32 at every width (no tensor core takes exact float32; the
// reference's f32 dots are full precision) runs the FMA kernels of
// flash_bwd.cuh: one block of warps per 64-row (32 at d 256, 16 at 512)
// output tile, looping in the same order, with the accumulators and score
// tiles in shared memory; B5 steps 32 q rows (16 at 512). Under dp their
// int8 tiles sit in the V (and B4's dO) slots in 16-byte column blocks, dP
// on __dp4a, and B5 loads qs over Q once Sᵀ is taken. At 512 the output's
// halves go on the grid (blockIdx.z), each recomputing S and dP; B5's
// upper half takes no dV where the caller's value dim ends at or below 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_bwd_tc.cuh"
#include "hopper.cuh"
#include "schedule.cuh"

namespace {

// ------------------------------------------------------- bf16: TMA + wgmma

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
  static constexpr int bytes(int st) {
    return 1024 + RESIDENT + st * STAGE + ((NC + 1) * st + 1) * 8;
  }
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
  static_assert(!DP || (NC == 1 && HD == 128), "dp at 64 is refused, at 256 and 512 wide");
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
  static_assert(!DP || (NC == 1 && HD == 128), "dp at 64 is refused, at 256 and 512 wide");
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
  uint64_t* full_bar = q_bar + 1;          // NC × ST: each consumer's own
  uint64_t* empty_bar = full_bar + NC * ST;

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
    for (int i = 0; i < NC * ST; ++i) mbar_init(&full_bar[i], 1);
    for (int i = 0; i < ST; ++i) mbar_init(&empty_bar[i], 4);  // the step's consumer's warps
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
        uint64_t* full = &full_bar[(t % NC) * ST + i];
        mbar_expect_tx(full, STAGE);
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_3d(st + pn * BKV * 128, &m.k, pn * 128, k0, kv_row, full);
        for (int pn = 0; pn < C::VTILE / (BKV * 128); ++pn)
          tma_load_3d(st + C::KTILE + pn * BKV * 128, &m.v, pn * 128, k0, kv_row, full);
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

    uint32_t phases = 0;  // bit i: the parity of this consumer's next wait on stage i
    for (int t = wg; t < steps; t += NC) {
      const int i = t % ST;
      const int k0 = (first + t) * BKV;
      uint8_t* st = stages + i * STAGE;
      const uint32_t k_addr = smem_u32(st), v_addr = smem_u32(st + C::KTILE);
      wait_own(&full_bar[wg * ST + i], phases, i);
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
    store_rows<HD>(static_cast<bf16*>(p.dq), HD, dq, t4, qa < s.n_q ? (long)(base + qa) : -1,
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
  uint64_t* full_bar = kv_bar + 1;         // NC × ST: each consumer's own
  uint64_t* empty_bar = full_bar + NC * ST;

  const Sched s = sched_of(p);
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
    // full: TMA's bytes and the producer warp's lanes; empty: lane 0 of the
    // step's consumer's warps
    for (int i = 0; i < NC * ST; ++i) mbar_init(&full_bar[i], 1 + 32);
    for (int i = 0; i < ST; ++i) mbar_init(&empty_bar[i], 4);
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
        uint64_t* full = &full_bar[(t % NC) * ST + i];
        mbar_wait(&empty_bar[i], ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, C::TX);
          for (int pn = 0; pn < PANELS; ++pn) {
            tma_load_3d(st + pn * BQ * 128, &m.q, pn * 128, q0, bq, full);
            tma_load_3d(st + C::TILE + pn * BQ * 128, &m.dout, pn * 128, q0, bq, full);
            if constexpr (DP)
              tma_load_3d(st + C::QS_OFF + pn * BQ * 128, &m.qs, pn * 128, q0, bq, full);
          }
          if constexpr (DP)
            for (int pn = 0; pn < HD / 128; ++pn)
              tma_load_3d(st + C::DO8_OFF + pn * BQ * 128, &m.do8, pn * 128, q0, bq, full);
        }
        float* rows = reinterpret_cast<float*>(st + C::TX);
        const size_t base = (size_t)bq * s.n_q + q0;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < s.n_q;
          rows[r] = in ? p.lse2[base + r] : 0.0f;
          rows[BQ + r] = in ? p.delta[base + r] : 0.0f;
        }
        mbar_arrive(full);
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

    uint32_t phases = 0;  // bit i: the parity of this consumer's next wait on stage i
    for (int t = wg; t < steps; t += NC) {
      const int i = t % ST;
      const int q0 = (first + t % per_head) * BQ;
      uint8_t* st = stages + i * C::STAGE;
      wait_own(&full_bar[wg * ST + i], phases, i);
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
    store_rows<HD>(static_cast<bf16*>(p.dk), HD, dk, t4, row_a, row_b, LN2, LN2);
    store_rows<HD>(static_cast<bf16*>(p.dv), HD, dv, t4, row_a, row_b, 1.0f, 1.0f);
  }
}

template <int HD, bool DP>
cudaError_t launch_dq_tc(const BwdParams& p, int bh, cudaStream_t stream) {
  constexpr int NC = CONSUMERS<HD>;
  using C = DqCfg<HD, NC, DP>;
  Maps m;
  if (!make_maps<HD, 64, 64>(&m, p, bh)) return cudaErrorInvalidValue;
  const dim3 grid(bh, (p.n_q + C::BQ - 1) / C::BQ);
  return launch_tc(flash_bwd_dq_tc<HD, NC, DP>, grid, 128 * (NC + 1), C::P::SMEM, stream, m,
                   p);
}

template <int HD, bool DP>
cudaError_t launch_dkv_tc(const BwdParams& p, int bh_kv, cudaStream_t stream) {
  constexpr int NC = CONSUMERS<HD>;
  using C = DkvCfg<HD, NC, DP>;
  Maps m;
  if (!make_maps<HD, 64, 64>(&m, p, bh_kv / p.hkv * p.hq)) return cudaErrorInvalidValue;
  const dim3 grid(bh_kv, (p.n_kv + C::BKV - 1) / C::BKV);
  return launch_tc(flash_bwd_dkv_tc<HD, NC, DP>, grid, 128 * (NC + 1), C::P::SMEM, stream, m,
                   p);
}

// the schedule's arguments as B1 takes them (flash_fwd.cu:tf_flash_fwd)
bool bad_sched(int hq, int hkv, const Sched& s) {
  return hkv <= 0 || hq % hkv != 0 || !sched_ok(s);
}

// one entry's dispatch over dtype (0 = float32, 1 = bfloat16), width (64,
// 128, 256) and dp: F's fma (float32), tc (bf16 at 64 and 128) and wide
// (bf16 at 256) launchers
template <class F>
cudaError_t dispatch(const BwdParams& p, int rows, int d, int dtype, bool dp,
                     cudaStream_t stream) {
  if (dp && d == 64) return cudaErrorInvalidValue;  // the reference ignores dp there
  if (dtype == 1) {
    if (d == 64) return F::template tc<64, false>(p, rows, stream);
    if (d == 128)
      return dp ? F::template tc<128, true>(p, rows, stream)
                : F::template tc<128, false>(p, rows, stream);
    if (d == 256)
      return dp ? F::template wide<256, true>(p, rows, stream)
                : F::template wide<256, false>(p, rows, stream);
  } else if (dtype == 0) {
    if (d == 64) return F::template fma<64, false>(p, rows, stream);
    if (d == 128)
      return dp ? F::template fma<128, true>(p, rows, stream)
                : F::template fma<128, false>(p, rows, stream);
    if (d == 256)
      return dp ? F::template fma<256, true>(p, rows, stream)
                : F::template fma<256, false>(p, rows, stream);
  }
  return cudaErrorInvalidValue;
}

struct Dq {
  template <int HD, bool DP>
  static cudaError_t fma(const BwdParams& p, int bh, cudaStream_t s) {
    return launch_dq<HD, DP>(p, bh, s);
  }
  template <int HD, bool DP>
  static cudaError_t tc(const BwdParams& p, int bh, cudaStream_t s) {
    return launch_dq_tc<HD, DP>(p, bh, s);
  }
  template <int HD, bool DP>
  static cudaError_t wide(const BwdParams& p, int bh, cudaStream_t s) {
    return launch_dq_wide<HD, DP>(p, bh, s);
  }
};
struct Dkv {
  template <int HD, bool DP>
  static cudaError_t fma(const BwdParams& p, int bh_kv, cudaStream_t s) {
    return launch_dkv<HD, DP>(p, bh_kv, s);
  }
  template <int HD, bool DP>
  static cudaError_t tc(const BwdParams& p, int bh_kv, cudaStream_t s) {
    return launch_dkv_tc<HD, DP>(p, bh_kv, s);
  }
  template <int HD, bool DP>
  static cudaError_t wide(const BwdParams& p, int bh_kv, cudaStream_t s) {
    return launch_dkv_wide<HD, DP>(p, bh_kv, s);
  }
};

}  // namespace

// q, dout: (bh, n_q, d), q prescaled; k, v: (bh / hq · hkv, n_kv, d);
// lse2 = clamped lse · log2(e) and delta: (bh, n_q) float32; dq like q.
// All contiguous, 16-byte aligned, one dtype (0 = float32, 1 = bfloat16).
// d ∈ {64, 128, 256, 512} (the wrapper zero-pads other head and value
// dims).
// kind, offset, radius, section: the schedule (schedule.cuh; offset is the
// causal kind's n_kv − n_q or the shifted kinds' shift, section their wrap;
// circulant k/v are the halo-extended ones).
// dp: v8 (V̂, like v, int8), do8 (dÔ, like dout, int8) and sdo (σdo, like
// lse2) non-null, delta divided by σdo; v and dout are then not read; not
// at d 64. bf16 takes a TMA + wgmma kernel (widths 256 and 512 those of
// flash_bwd_tc.cuh), float32 the FMA one (width 512 in flash_bwd_wide.cu).
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
  const BwdParams p{q,    k,     v,  dp ? nullptr : dout, v8,     do8,     nullptr,
                    sdo,  lse2,  delta, dq, nullptr, nullptr, n_q, n_kv, kind,
                    offset, radius, section, hq, hkv, d};
  if (d == 512) return tf_bwd::launch_wide_dq(p, bh, dtype, dp, stream);
  return dispatch<Dq>(p, bh, d, dtype, dp, stream);
}

// The same operands; dk, dv: like k, v; bh_kv = batch · hkv; dv_cols: the
// caller's value dim (1 to d), past which a 512 launch's upper half writes
// no dv column. dp: v8, do8 and qs (q·σdo, like q) non-null, delta divided
// by σdo; v is then not read, dout still is (dV takes the exact dO).
extern "C" cudaError_t tf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse2,
                                        const float* delta, void* dk, void* dv, const void* v8,
                                        const void* do8, const void* qs, int bh_kv, int n_q,
                                        int n_kv, int hq, int hkv, int d, int dv_cols, int kind,
                                        int offset, int radius, int section, int dtype,
                                        cudaStream_t stream) {
  if (bh_kv <= 0 || n_kv <= 0) return cudaSuccess;
  if (bad_sched(hq, hkv, Sched{n_q, n_kv, kind, offset, radius, section}) ||
      bh_kv % hkv != 0 || n_q < 0 || dv_cols < 1 || dv_cols > d)
    return cudaErrorInvalidValue;
  const bool dp = v8 != nullptr;
  if (dp && (do8 == nullptr || qs == nullptr)) return cudaErrorInvalidValue;
  const BwdParams p{q,       k,    v,     dout,    v8, do8, qs,
                    nullptr, lse2, delta, nullptr, dk, dv,  n_q, n_kv, kind,
                    offset,  radius, section, hq, hkv, dv_cols};
  if (d == 512) return tf_bwd::launch_wide_dkv(p, bh_kv, dtype, dp, stream);
  return dispatch<Dkv>(p, bh_kv, d, dtype, dp, stream);
}
