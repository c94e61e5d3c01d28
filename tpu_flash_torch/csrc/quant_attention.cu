// B6/B8 and B7: quantized attention forward for Hopper, sm_90a.
//
// Replaces three TPU kernels with one tile loop:
// - tpu_flash/quant/serving_attn.py:_sv_kernel (B6, pallas_call at :847)
//   and _sv_kernel_t (B8, its d <= 64 K-major layout, :736): serving
//   attention over a pre-quantized cache, Q quantized inside the kernel;
//   entry point tf_serving_attention.
// - tpu_flash/quant/flash_q.py:_q_fwd_kernel (B7, :376): the quantized
//   forward, Q already quantized on the host; entry point tf_quant_attention.
//
// Schedules: the kinds of schedule.cuh (dense, causal, local, local_causal,
// circulant over halo-extended K/V, block-diagonal, and the ring hop's
// shifted and shifted_causal, whose wrapped band may reach a row's keys in
// two runs), the kind a runtime argument as in B1 and B4/B5. A work item's
// producer and consumers walk the same kv tiles, kv_range's [first, last]
// for its 128 q rows (carried by the work list); a consumer masks a tile
// only where tile_full says its 64 rows do not see all of it, by each
// row's key_span.
//
// What it computes. B6's Q staging, once per row in a pass before the
// attention kernel (the reference's s == 0 init, serving_attn.py:155-198):
// the row amax, sq = max(amax, 1e-12) / qmax (an IEEE divide), q / sq
// rounded to nearest even onto e4m3 (__NV_SATFINITE) or int8 (rintf,
// clipped to ±127), and the row factor f = (sq · scale·log2e) · sk_fold in
// float32; weight-only Q is q · (scale·log2e · sk_fold) cast to bf16, f = 1. sk_fold is the per-(batch,
// kv head) K scale of kv_scale="tensor", else 1. The host quantizer
// (quant/serving_attn.py:_stage_q_plain) does the same arithmetic and agrees
// on every staged byte and factor. B7 loads a bf16 operand, or int8 / e4m3
// q̂ with host row factors (times c in here). Scores: s = (Σ q̂·k̂)·f·σk_j
// with σk_j the per-token K scale (or 1); the fp8 and int8 products run on
// the card's 8-bit units, int8 exactly (s32). The max is the constant norm
// bound m = (‖q̂_row‖·f)·(max_j ‖k̂_j‖·σk_j)·1.0001 when gk is given (the host
// computes the per-kv-row max on the values the kernel dots; any upper bound
// keeps the online softmax exact, and no rescale runs), else the exact
// running max. Base-2 softmax; P rounded to bf16 against V̂ decoded exactly
// to bf16, or under pv_quant P → clip(rint(p·127), 0, 127) against int8 V̂
// (s32 per tile, then × 1/127). l sums the float32 p. The finish mirrors
// serving_attn.py:332-346: rows with l = 0 or m <= MASK/2 give o = 0 and
// lse = -inf, then o × σv per channel. Head widths 64, 128, 256 and 512
// are compiled; the wrappers zero-pad other d and dv (K̂/V̂ with byte 0, σv
// with 1).
//
// What bounds it on an H100: at the headline shape (b 4, h 8, n 8192,
// d 128) tensor-core operations, 1.10 TFLOP against ~40 MB of q, K̂, V̂ and
// o, far right of the ridge: Q·Kᵀ at the fp8/int8 peak (1979 TFLOP/s) plus
// P·V at the bf16 peak (989) gives ~0.83 ms. On the band, circulant and
// block kinds a 128-row q tile walks 3-10 kv tiles, so what each tile costs
// outside its steps (its Q, its first stage, its epilogue) weighs as much
// as the steps unless it overlaps another tile's.
//
// Design (FA-3 shaped, persistent). One CTA of three warpgroups on each SM
// (as many as there are work items, at most the SM count) walks a list of
// work items, item i, i + gridDim.x, ...: (128-row q tile, batch·q head,
// O half). The host builds the list once per schedule and shape
// (quant/flash_q.py:work_order), each row with the kv tiles its q tile
// visits (ops/schedule.py:kv_tile_range, schedule.cuh's kv_range),
// heaviest first, then by batch·head and tile, so that equal tiles of one
// head run side by side and share its K̂/V̂ in L2 (the q heads of a kv head
// are neighbours); the list stays on the device, so a CUDA graph of calls
// replays with no host work. Stage and phase counters run on across items.
// - Q comes by TMA. B7's is a finished operand in device memory; B6 first
//   quantizes it in a pass of its own (quant_stage_q, one warp a row, the
//   row-wise staging's arithmetic), into buffers that the wrapper allocates
//   and that the checks read back. Staged in the attention kernel, 16 rows
//   a warp, it cost each item ~40 µs, as long as the steps of a band tile.
// - Warpgroup 2 produces. Its first warp issues TMA (cp.async.bulk.tensor,
//   tensor maps from cuTensorMapEncodeTiled, 128-byte swizzle, 64-byte at
//   d 64): each item's Q tile into the one Q buffer, as soon as the
//   consumers have released it after the last Q·Kᵀ of the item before,
//   then its K̂ and V̂ tiles into a ring of 1-3 stages with full/empty
//   mbarriers; TMA zero-fills ragged n. So the next item's Q and first
//   stages arrive while the consumers finish this one. Its other three
//   warps decode V̂ exactly to bf16 in place of layout (the P·V product
//   reads it MN-major, through wgmma's transpose bit: no transpose in
//   shared memory), decode K̂ in the weight-only mode, and load the σk
//   tile. It gives its registers to the consumers (setmaxnreg 40 / 232:
//   what the 384-thread launch frees covers exactly that).
// - Warpgroups 0 and 1 consume, 64 q rows each. Each warp takes its 16
//   rows' factors with one load a lane and, under the norm bound, each
//   row's norm from the operand in shared memory in the staging's order.
//   Q·Kᵀ: wgmma with both operands in shared memory, e4m3 × e4m3|e5m2 (f32
//   accumulators) or s8 × s8 (s32, exact), straight from the TMA'd K̂
//   bytes, or bf16 × bf16 against the decoded K̂ in the weight-only mode.
//   fp8 sums each k32 step on a fresh accumulator and adds the steps in
//   float32 in order (promotion): inside a step the fp8 units truncate
//   each product to 2^(E-14), E the step's largest exponent-field sum + 1,
//   and the sum to 14 significant bits (measured: bench/fp8_sums.py; the
//   plain version models it, quant/flash_q.py:fp8_scores). Chained steps
//   would truncate the running sum too. A step begins the next stage's
//   Q·Kᵀ (the int8 / bf16 chain, or the first fp8 k32 step) while its own
//   P·V runs, then waits for both and releases its stage: nothing is in
//   flight across a step, since ptxas serializes every wgmma of the kernel
//   (C7514, C7515) when an accumulator is read or written while a group
//   it cannot tell apart is pending (a wait_group 1, a loop back-edge).
//   S, P and the O accumulator stay in registers: the row max and sum use
//   quad shuffles, P (bf16) is the register A operand of the P·V wgmma.
//   The bound mode skips the rescale. pv_quant's int8 P·V runs on
//   mma.sync m16n8k32 with the kv order permuted so that P's accumulator
//   registers are its A fragment (V̂'s bytes are gathered to match). The
//   epilogue stores o and lse from registers, σv loaded before the first
//   store, after the producer has issued the next item's Q and first
//   stages.
// - Tiles: BKV 128 kv rows at d <= 128, 64 at d 256, 32 at d 512; as many
//   ring stages as fit in 227 KB (Cfg below). One Q buffer: a second (16 KB
//   at d 128 in 8 bits) does not fit beside three stages at d 128, and
//   releasing the one buffer after an item's last Q·Kᵀ lets its successor's
//   Q load overlap that item's last softmax, P·V and epilogue.
// - Width 512 (the reference tiles any d): O alone would take 256 float32
//   registers a thread of a 64-row warpgroup, and in the weight-only mode Q
//   (128 KB) and one stage of 64 kv rows (192 KB) outgrow shared memory.
//   So O's 256-column halves are separate work items, as in B1: each runs
//   Q·Kᵀ and the softmax over the full width, loads and decodes only its
//   half of V̂, and accumulates only that half of O; the kv tile shrinks to
//   32 rows (flash_q.kernel_block_kv, which the plain version walks too).
//   Half 0 writes lse.
// - Registers and spills of every instantiation: python -m
//   tpu_flash_torch.kernels._build quant_attention.cu (PERF.md §6).
//
// Where it stands: PERF.md §6 (chip_smoke.py and bench/quant_bench.py on an
// NVIDIA H100). A step still runs its Q·Kᵀ, softmax and P·V one after
// another; taking the two consumers' tensor-core phases in turns on named
// barriers (FA-3's ping-pong) made every row slower, and every 128-row q
// tile streams its head's whole K̂/V̂ from L2 (4.3 GB at the headline); TMA
// multicast of K̂/V̂ to a cluster of q tiles is untried.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "schedule.cuh"

namespace {

using bf16 = __nv_bfloat16;

// DEFAULT_MASK_VALUE = -0.7 * float32 max, rounded to float32.
constexpr float MASK = -0x1.666664p+127f;
constexpr float LN2 = 0.693147180559945309f;
constexpr float INV127 = (float)(1.0 / 127.0);
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may use

// Q staging modes (the wrappers pass them).
enum { Q_RAW = 0, Q_FP8 = 1, Q_INT8 = 2, Q_LOAD_BF16 = 3, Q_LOAD_INT8 = 4, Q_LOAD_FP8 = 5 };
// Cache storage codes.
enum { KV_INT8 = 0, KV_E4M3 = 1, KV_E5M2 = 2 };
// Score products: bf16 Q · decoded K̂, e4m3 q̂ · e4m3 | e5m2 K̂, int8 · int8.
enum { S_BF16 = 0, S_E4M3 = 1, S_E5M2 = 2, S_INT8 = 3 };

struct Params {
  const void* q;          // (bh, n_q, d): raw f32/bf16 (modes 0-2), bf16
                          // operand (3), int8 (4) or e4m3 (5) q̂
  const float* sq;        // (bh, n_q) q̂ row factors (modes 4, 5), times c
  const uint8_t* k;       // (bh_kv, n_kv, d) int8 / e4m3 / e5m2
  const uint8_t* v;       // (bh_kv, n_kv, d)
  const float* sk_token;  // (bh_kv, n_kv) per-token K scales, or null
  const float* sk_tensor; // (bh_kv) K scale folded into the Q staging, or null
  const float* sv;        // (bh_kv, d) per-channel V scales
  const float* gk;        // (bh_kv) max_j ‖k̂_j‖·σk_j (norm bound), or null
  void* o;                // (bh, n_q, d) f32 or bf16
  float* lse;             // (bh, n_q) or null
  const int* order;       // (bh · q tiles, 3) work entries (b · q tiles + q
                          // tile, its first kv tile, its kv tiles), in the
                          // order the CTAs take them
  Sched s;  // n_q, n_kv (the halo-extended length for the circulant), kind
  int bh, hq, hkv;
  int q_mode, q_f32, kv_dtype, o_f32;
  float c;  // staging: float32(scale·log2e); modes 4, 5: the factor's multiplier
};

// Tiles and the shared-memory plan of one instantiation. A stage holds K̂
// (raw), the item's columns of V̂ (raw), K̂ decoded to bf16 (weight-only) and
// those columns of V̂ decoded (not under pv_quant), in that order.
template <int HD, int SP, bool PVQ> struct Cfg {
  static constexpr int BQ = 128;                    // two consumer warpgroups
  static constexpr int BKV = HD == 512 ? 32 : HD == 256 ? 64 : 128;  // kv rows a stage
  static constexpr int HO = HD > 256 ? 256 : HD;    // O's columns an item
  static constexpr int HALVES = HD / HO;            // work items a (q tile, head)
  static constexpr bool Q8 = SP != S_BF16;          // 8-bit score operands
  static constexpr bool FP8 = SP == S_E4M3 || SP == S_E5M2;
  static constexpr int RPB = HD >= 128 ? 128 : 64;  // panel bytes, 8-bit tiles
  static constexpr int QPB = Q8 ? RPB : 128;        // panel bytes, Q operand
  static constexpr int QROW = HD * (Q8 ? 1 : 2);    // bytes of a Q row
  static constexpr int QBYTES = BQ * QROW;
  static constexpr int KSTEPS = Q8 ? HD / 32 : HD / 16;  // 32 bytes a step
  static constexpr int RAW = BKV * HD;              // one 8-bit K̂ tile
  static constexpr int RAWV = BKV * HO;             // the item's columns of V̂
  static constexpr int KB = Q8 ? 0 : BKV * HD * 2;  // decoded K̂ (bf16)
  static constexpr int VT = PVQ ? 0 : BKV * HO * 2; // decoded V̂ᵀ (bf16)
  static constexpr int KB_OFF = RAW + RAWV, VT_OFF = KB_OFF + KB;
  static constexpr int STAGE = VT_OFF + VT;
  static constexpr int bytes(int st) {
    // 1024 of alignment slack, Q, the stages, σk tiles, row factors and
    // bounds, three barriers a stage, Q's two
    return 1024 + QBYTES + st * STAGE + st * BKV * 4 + BQ * 8 + st * 24 + 16;
  }
  static constexpr int ST = bytes(3) <= SMEM_LIMIT ? 3 : bytes(2) <= SMEM_LIMIT ? 2 : 1;
  static constexpr int SMEM = bytes(ST);
  static_assert(SMEM <= SMEM_LIMIT, "above the 227 KB a block may use");
  static_assert(QBYTES % 1024 == 0 && STAGE % 1024 == 0 && RAW % 1024 == 0 &&
                    RAWV % 1024 == 0 && KB % 1024 == 0,
                "swizzled tiles need 1024-byte bases");
};


__device__ __forceinline__ float fp8_to_float(uint8_t b, int kv_dtype) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      (__nv_fp8_storage_t)b, kv_dtype == KV_E4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half2float(__half(h));
}


// int8 byte i of w as a float, exactly, on the integer and FMA units:
// 2^23 + (x + 128) built in float32's bits, less 2^23 + 128 (the conversion
// unit runs at a quarter of the rate; for fp8 the one cvt per pair below
// was the faster of the two)
template <int I>
__device__ __forceinline__ float int8_to_float(uint32_t w) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | I)) -
         8388736.0f;
}

// two fp8 bytes (the low 16 bits of x) through one cvt to f16x2
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t x, int kv_dtype) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(x & 0xffff), kv_dtype == KV_E4M3 ? __NV_E4M3 : __NV_E5M2);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16(f.x, f.y);
}

// exact decode of four cache bytes to two bf16 pairs (bytes 0, 1 and 2, 3):
// every int8 / e4m3 / e5m2 value is a bf16
__device__ __forceinline__ void decode4(uint32_t w, int kv_dtype, uint32_t& lo, uint32_t& hi) {
  if (kv_dtype == KV_INT8) {
    lo = pack_bf16(int8_to_float<0>(w), int8_to_float<1>(w));
    hi = pack_bf16(int8_to_float<2>(w), int8_to_float<3>(w));
  } else {
    lo = fp8x2_to_bf16x2(w, kv_dtype);
    hi = fp8x2_to_bf16x2(w >> 16, kv_dtype);
  }
}

// 16 cache bytes at src decoded to 16 bf16: the first 8 to lo, the rest to
// hi (16 bytes each), half at a time
__device__ __forceinline__ void decode16(const uint8_t* src, uint8_t* lo, uint8_t* hi,
                                         int kv_dtype) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  uint32_t w0, w1, w2, w3;
  decode4(raw.x, kv_dtype, w0, w1);
  decode4(raw.y, kv_dtype, w2, w3);
  *reinterpret_cast<uint4*>(lo) = make_uint4(w0, w1, w2, w3);
  decode4(raw.z, kv_dtype, w0, w1);
  decode4(raw.w, kv_dtype, w2, w3);
  *reinterpret_cast<uint4*>(hi) = make_uint4(w0, w1, w2, w3);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float load_q(const Params& p, size_t row, int col, int hd) {
  if (p.q_f32) return static_cast<const float*>(p.q)[row * hd + col];
  return __bfloat162float(static_cast<const bf16*>(p.q)[row * hd + col]);
}

// One work item: a 128-row q tile of batch·q head b, the O half it
// accumulates (width 512), its kv row and the kv tiles it visits (the
// list's: kv_range of its rows, computed on the host with the list).
struct Item {
  int q0, b, half, kv_row, first, steps;
};

template <int HD, int SP, bool PVQ>
__device__ __forceinline__ Item item_at(const Params& p, int i, int n_tiles) {
  using C = Cfg<HD, SP, PVQ>;
  const int* e = p.order + 3 * (i / C::HALVES);
  Item it;
  it.half = i % C::HALVES;
  it.b = e[0] / n_tiles;
  it.q0 = (e[0] % n_tiles) * C::BQ;
  it.kv_row = (it.b / p.hq) * p.hkv + (it.b % p.hq) / (p.hq / p.hkv);
  it.first = e[1];
  it.steps = e[2];
  return it;
}

// B6's Q staging, a pass of its own before the attention kernel: one warp
// a q row (lane l takes columns l + 32i), the row amax, the quantized
// score operand (e4m3 / int8 bytes, or the weight-only bf16 q·fold) into
// q_st (bh, n_q, HD) and its factor f into f_st (bh, n_q; not for the
// weight-only operand, whose f is 1). The attention kernel then takes it
// as B7 takes a host-staged Q: by TMA, f times 1.
template <int HD>
__global__ void __launch_bounds__(256)
    quant_stage_q(const Params p, void* q_st, float* f_st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * 8 + warp;  // b · n_q + position
  if (row >= (size_t)p.bh * p.s.n_q) return;
  const int b = (int)(row / p.s.n_q);
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  const float skf = p.sk_tensor != nullptr ? p.sk_tensor[kv_row] : 1.0f;
  float x[HD / 32];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
    x[i] = load_q(p, row, lane + 32 * i, HD);
    amax = fmaxf(amax, fabsf(x[i]));
  }
  if (p.q_mode == Q_FP8 || p.q_mode == Q_INT8) {
    const float qmax = p.q_mode == Q_FP8 ? 448.0f : 127.0f;
    const float sq = fmaxf(warp_max(amax), 1e-12f) / qmax;
    uint8_t* out = static_cast<uint8_t*>(q_st) + row * HD;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      uint8_t byte;
      if (p.q_mode == Q_FP8)
        byte = (uint8_t)__nv_cvt_float_to_fp8(x[i] / sq, __NV_SATFINITE, __NV_E4M3);
      else
        byte = (uint8_t)(int8_t)fminf(fmaxf(rintf(x[i] / sq), -127.0f), 127.0f);
      out[lane + 32 * i] = byte;
    }
    if (lane == 0) f_st[row] = (sq * p.c) * skf;
  } else {  // weight-only: the bf16 operand
    const float fold = p.c * skf;
    bf16* out = static_cast<bf16*>(q_st) + row * HD;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) out[lane + 32 * i] = __float2bfloat16_rn(x[i] * fold);
  }
}

// An item's rows, once TMA has brought its Q operand: each warp's 16 row
// factors f (the staged factors times c, taken by the caller with one load
// a lane; 1 for a bf16 operand, 0 past n_q) and softmax starts m: under the
// norm bound (‖q̂_row‖·f)·gk·1.0001, the norm summed from shared memory in
// the order of a warp's row-wise staging (lane l takes columns l + 32i);
// else MASK.
template <int HD, int SP, bool PVQ>
__device__ void q_rows(const Params& p, const uint8_t* qs, float* rowf, float* rowm,
                       int kv_row, int warp, int lane, float f) {
  using C = Cfg<HD, SP, PVQ>;
  float m = MASK;
  if (p.gk != nullptr) {
    float ss[16];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      float sumsq = 0.0f;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) {
        const int col = lane + 32 * i;
        float x;
        if constexpr (C::Q8) {
          const uint8_t byte = qs[tile_off<C::QPB, 64>(r, col)];
          x = SP == S_INT8 ? (float)(int8_t)byte : fp8_to_float(byte, KV_E4M3);
        } else {
          x = __bfloat162float(*reinterpret_cast<const bf16*>(qs + tile_off<128, 64>(r, 2 * col)));
        }
        sumsq += x * x;
      }
      ss[rr] = warp_sum(sumsq);
    }
    float mine = ss[0];
#pragma unroll
    for (int rr = 1; rr < 16; ++rr)
      if ((lane & 15) == rr) mine = ss[rr];
    const float qn = sqrtf(mine) * f;
    m = qn * (p.gk[kv_row] * 1.0001f);
  }
  if (lane < 16) {
    rowf[warp * 16 + lane] = f;
    rowm[warp * 16 + lane] = m;
  }
}

// Producer side: decode stage tiles for the consumers. `tid` in [0, 96).
template <int HD, int SP, bool PVQ>
__device__ void decode_stage(const Params& p, const uint8_t* kraw, const uint8_t* vraw,
                             uint8_t* kb, uint8_t* vt, float* skt, int k0, int kv_row,
                             int tid) {
  using C = Cfg<HD, SP, PVQ>;
  constexpr int BKV = C::BKV, RPB = C::RPB, NT = 96;
  // the cache type, known at compile time except in the weight-only mode
  const int kv = SP == S_E4M3 ? KV_E4M3 : SP == S_E5M2 ? KV_E5M2 : SP == S_INT8 ? KV_INT8
                                                                                : p.kv_dtype;
  if constexpr (!C::Q8) {
    // K̂ → bf16 K, same rows: 16 bytes in, 32 out (the loops stay rolled:
    // the producer has 40 registers)
#pragma unroll 1
    for (int u = tid; u < BKV * HD / 16; u += NT) {
      const int r = u % BKV, cb = (u / BKV) * 16;
      decode16(kraw + tile_off<RPB, BKV>(r, cb), kb + tile_off<128, BKV>(r, 2 * cb),
               kb + tile_off<128, BKV>(r, 2 * cb + 16), kv);
    }
  }
  if constexpr (!PVQ) {
    // V̂ → bf16 V̂ (the item's columns), same rows: the P·V product reads it
    // MN-major
#pragma unroll 1
    for (int u = tid; u < BKV * C::HO / 16; u += NT) {
      const int r = u % BKV, cb = (u / BKV) * 16;
      decode16(vraw + tile_off<RPB, BKV>(r, cb), vt + tile_off<128, BKV>(r, 2 * cb),
               vt + tile_off<128, BKV>(r, 2 * cb + 16), kv);
    }
  }
  if (p.sk_token != nullptr)
    for (int j = tid; j < BKV; j += NT)
      skt[j] = k0 + j < p.s.n_kv ? p.sk_token[(size_t)kv_row * p.s.n_kv + k0 + j] : 0.0f;
}

// One fp8 k32 step of Q·Kᵀ into d, overwriting it.
template <int HD, int SP, bool PVQ>
__device__ __forceinline__ void fp8_step(float (&d)[Cfg<HD, SP, PVQ>::BKV / 2],
                                         uint32_t q_addr, uint32_t k_addr, int kk) {
  using C = Cfg<HD, SP, PVQ>;
  constexpr int QPB = C::QPB;
  const int colb = 32 * kk;
  const uint64_t da = desc<QPB>(q_addr + (colb / QPB) * 64 * QPB + colb % QPB);
  const uint64_t db = desc<QPB>(k_addr + (colb / QPB) * C::BKV * QPB + colb % QPB);
  if constexpr (SP == S_E4M3) wgmma_e4m3_e4m3<C::BKV>(d, da, db, 0);
  else wgmma_e4m3_e5m2<C::BKV>(d, da, db, 0);
}

// S = Q·Kᵀ of one stage, begun, as one wgmma group: the whole chain (int8,
// weight-only bf16), or the fp8 product's first k32 step, into s.
template <int HD, int SP, bool PVQ, typename Acc>
__device__ __forceinline__ void qk_begin(Acc (&s)[Cfg<HD, SP, PVQ>::BKV / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  using C = Cfg<HD, SP, PVQ>;
  constexpr int QPB = C::QPB, BKV = C::BKV;
  wgmma_fence();
  if constexpr (C::FP8) {
    fp8_step<HD, SP, PVQ>(s, q_addr, k_addr, 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const int colb = 32 * kk;
      const uint64_t da = desc<QPB>(q_addr + (colb / QPB) * 64 * QPB + colb % QPB);
      const uint64_t db = desc<QPB>(k_addr + (colb / QPB) * BKV * QPB + colb % QPB);
      if constexpr (SP == S_INT8) wgmma_s8_s8<BKV>(s, da, db, kk);
      else wgmma_bf16_bf16<BKV>(s, da, db, kk);
    }
  }
  wgmma_commit();
}

// S = Q·Kᵀ of one stage, finished (the fp8 product; its first step, begun
// with the stage, is done): each further k32 step into part, waited for
// and added into s in k order. No accumulator is read or written while a
// wgmma that the compiler cannot tell apart is in flight: ptxas would
// serialize every wgmma of the kernel (C7514, C7515).
template <int HD, int SP, bool PVQ>
__device__ __forceinline__ void qk_finish(float (&s)[Cfg<HD, SP, PVQ>::BKV / 2],
                                          uint32_t q_addr, uint32_t k_addr) {
  using C = Cfg<HD, SP, PVQ>;
  float part[C::BKV / 2];
#pragma unroll
  for (int kk = 1; kk < C::KSTEPS; ++kk) {
    wgmma_fence();
    fp8_step<HD, SP, PVQ>(part, q_addr, k_addr, kk);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < C::BKV / 2; ++i) s[i] = s[i] + part[i];
  }
}

// the score operand of stage s: K̂ as TMA wrote it, or decoded (weight-only)
template <class C>
__device__ __forceinline__ uint32_t k_operand(const uint8_t* stages, int s) {
  return smem_u32(stages + s * C::STAGE + (C::Q8 ? 0 : C::KB_OFF));
}

// Wait for ring step g's stage and begin its Q·Kᵀ (one group; the caller
// waits for it before its step ends).
template <int HD, int SP, bool PVQ, typename Acc>
__device__ __forceinline__ void begin_stage(
    Acc (&s)[Cfg<HD, SP, PVQ>::BKV / 2], uint32_t q_addr,
    const uint8_t* stages, uint64_t* tma_bar, uint64_t* full_bar, int g) {
  using C = Cfg<HD, SP, PVQ>;
  const int st = g % C::ST, ph = (g / C::ST) & 1;
  mbar_wait(&tma_bar[st], ph);
  mbar_wait(&full_bar[st], ph);
  qk_begin<HD, SP, PVQ>(s, q_addr, k_operand<C>(stages, st));
}

template <int HD, int SP, bool PVQ>
__global__ void __launch_bounds__(384, 1)
    quant_attention_persistent(const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               const __grid_constant__ CUtensorMap tmap_q, const Params p) {
  using C = Cfg<HD, SP, PVQ>;
  constexpr int BKV = C::BKV, ST = C::ST, RPB = C::RPB, QPB = C::QPB, HO = C::HO;
  using Acc = typename std::conditional<SP == S_INT8, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = smem;                         // BQ rows of the score operand
  uint8_t* stages = smem + C::QBYTES;         // ST × (K̂, V̂, K bf16, V̂ᵀ bf16)
  float* skt = reinterpret_cast<float*>(stages + ST * C::STAGE);  // ST × BKV
  float* rowf = skt + ST * BKV;               // BQ row factors
  float* rowm = rowf + C::BQ;                 // BQ softmax starts
  uint64_t* tma_bar = reinterpret_cast<uint64_t*>(rowm + C::BQ);
  uint64_t* full_bar = tma_bar + ST;
  uint64_t* empty_bar = full_bar + ST;
  uint64_t* q_full = empty_bar + ST;          // the item's Q tile landed
  uint64_t* q_empty = q_full + 1;             // its last Q·Kᵀ done

  const Sched sd = p.s;
  const int n_tiles = (sd.n_q + C::BQ - 1) / C::BQ;
  const int n_items = p.bh * n_tiles * C::HALVES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&tma_bar[s], 1);
      mbar_init(&full_bar[s], 96);  // the three decoding warps
      mbar_init(&empty_bar[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      if (lane == 0) {
        int g = 0, j = 0;
        for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++j) {
          const Item it = item_at<HD, SP, PVQ>(p, i, n_tiles);
          // the item's Q, once the last one's Q·Kᵀ is done
          mbar_wait(q_empty, (j & 1) ^ 1);
          mbar_expect_tx(q_full, C::QBYTES);
          for (int w = 0; w < 2; ++w)
            for (int pn = 0; pn < C::QROW / QPB; ++pn)
              tma_load_3d(qs + w * (C::QBYTES / 2) + pn * 64 * QPB, &tmap_q, pn * QPB,
                          it.q0 + 64 * w, it.b, q_full);
          for (int t = 0; t < it.steps; ++t, ++g) {
            const int s = g % ST, ph = (g / ST) & 1;
            mbar_wait(&empty_bar[s], ph ^ 1);
            uint8_t* st = stages + s * C::STAGE;
            const int k0 = (it.first + t) * BKV;
            mbar_expect_tx(&tma_bar[s], C::RAW + C::RAWV);
            for (int pn = 0; pn < HD / RPB; ++pn)
              tma_load_3d(st + pn * BKV * RPB, &tmap_k, pn * RPB, k0, it.kv_row, &tma_bar[s]);
            for (int pn = 0; pn < HO / RPB; ++pn)
              tma_load_3d(st + C::RAW + pn * BKV * RPB, &tmap_v, it.half * HO + pn * RPB, k0,
                          it.kv_row, &tma_bar[s]);
          }
        }
      }
    } else {
      const int tid = wtid - 32;
      int g = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const int* e = p.order + 3 * (i / C::HALVES);
        const int b = e[0] / n_tiles, first = e[1], steps = e[2];
        const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
        for (int t = 0; t < steps; ++t, ++g) {
          const int s = g % ST, ph = (g / ST) & 1;
          uint8_t* st = stages + s * C::STAGE;
          mbar_wait(&tma_bar[s], ph);
          decode_stage<HD, SP, PVQ>(p, st, st + C::RAW, st + C::KB_OFF, st + C::VT_OFF,
                                    skt + s * BKV, (first + t) * BKV, kv_row, tid);
          fence_async_smem();
          mbar_arrive(&full_bar[s]);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    uint8_t* qw = qs + wg * 64 * C::QROW;
    const uint32_t q_addr = smem_u32(qw);
    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8;
    const int t4 = lane % 4;
    const bool bound = p.gk != nullptr;
    int g = 0, j = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
      const Item it = item_at<HD, SP, PVQ>(p, item, n_tiles);
      const int qw0 = it.q0 + 64 * wg;  // this warpgroup's rows
      // the item's Q, the rows' factors and norms (while its first stage
      // is decoded), then its first Q·Kᵀ
      const int qr = qw0 + warp * 16 + (lane & 15);
      const float f = p.q_mode == Q_LOAD_BF16 ? 1.0f
                      : qr < sd.n_q          ? p.sq[(size_t)it.b * sd.n_q + qr] * p.c
                                             : 0.0f;
      mbar_wait(q_full, j & 1);
      q_rows<HD, SP, PVQ>(p, qw, rowf + 64 * wg, rowm + 64 * wg, it.kv_row, warp, lane, f);
      __syncwarp();
      Acc sacc[BKV / 2];
      if (it.steps > 0) {
        begin_stage<HD, SP, PVQ>(sacc, q_addr, stages, tma_bar, full_bar, g);
        wgmma_wait0();
        reg_fence(sacc);
      } else if (lane == 0) {
        mbar_arrive(q_empty);
      }

      const int qa = qw0 + ra, qb = qw0 + rb;
      const float fa = rowf[64 * wg + ra], fb = rowf[64 * wg + rb];
      float ma = rowm[64 * wg + ra], mb = rowm[64 * wg + rb];
      float la = 0.0f, lb = 0.0f;
      float o[HO / 2];
#pragma unroll
      for (int i = 0; i < HO / 2; ++i) o[i] = 0.0f;

      for (int t = 0; t < it.steps; ++t) {
        const int gt = g + t, s = gt % ST;
        const int k0 = (it.first + t) * BKV;
        uint8_t* st = stages + s * C::STAGE;
        const bool ahead = t + 1 < it.steps;

        if constexpr (C::FP8) qk_finish<HD, SP, PVQ>(sacc, q_addr, k_operand<C>(stages, s));
        if (!ahead) {  // the item's Q is read: the next one may land
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);
        }

        // scores, masks and the online softmax, in registers
        float sc[BKV / 2];
        float alpha_a = 1.0f, alpha_b = 1.0f;
        if (p.sk_token != nullptr) {  // per-token K scales: the row's two columns at once
          const float* sk = skt + s * BKV;
#pragma unroll
          for (int jj = 0; jj < BKV / 8; ++jj) {
            const float2 skj = *reinterpret_cast<const float2*>(sk + 8 * jj + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * jj + e;
              sc[i] = ((float)sacc[i] * (e < 2 ? fa : fb)) * (e & 1 ? skj.y : skj.x);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) sc[i] = (float)sacc[i] * ((i & 2) ? fb : fa);
        }
        if (!tile_full(sd, k0, k0 + BKV - 1, qw0, min(qw0 + 63, sd.n_q - 1))) {
          // the keys each of the two rows sees (computed here, not held
          // across the steps: the consumers' registers are full)
          const Span span_a = key_span(sd, qa), span_b = key_span(sd, qb);
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
            if (!in_span((i & 2) ? span_b : span_a, kpos)) sc[i] = MASK;
          }
        }
        if (!bound) {  // the exact running max; the bound needs no rescale
          float mxa = MASK, mxb = MASK;
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            if (i & 2) mxb = fmaxf(mxb, sc[i]);
            else mxa = fmaxf(mxa, sc[i]);
          }
          const float na = fmaxf(ma, quad_max(mxa)), nb = fmaxf(mb, quad_max(mxb));
          alpha_a = fast_exp2(ma - na);
          alpha_b = fast_exp2(mb - nb);
          ma = na;
          mb = nb;
#pragma unroll
          for (int jj = 0; jj < HO / 8; ++jj) {
            o[4 * jj] *= alpha_a;
            o[4 * jj + 1] *= alpha_a;
            o[4 * jj + 2] *= alpha_b;
            o[4 * jj + 3] *= alpha_b;
          }
        }
        float psa = 0.0f, psb = 0.0f;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const float pr = fast_exp2(sc[i] - ((i & 2) ? mb : ma));
          if (i & 2) psb += pr;
          else psa += pr;
          sc[i] = pr;
        }
        la = alpha_a * la + quad_sum(psa);
        lb = alpha_b * lb + quad_sum(psb);

        if constexpr (!PVQ) {
          // O += P·V̂: P (bf16) as the register A operand, V̂ in shared
          // memory; the next stage's Q·Kᵀ goes out before it is waited for
          uint32_t pa[BKV / 16][4];
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
          const uint32_t v_addr = smem_u32(st + C::VT_OFF);
          reg_fence(o);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk)
            wgmma_rs_bf16<HO, 1>(o, pa[kk], desc_mn(v_addr + kk * 16 * 128, BKV * 128));
          wgmma_commit();
          // the next stage's Q·Kᵀ begins while P·V runs; both done here
          if (ahead && ST > 1)
            begin_stage<HD, SP, PVQ>(sacc, q_addr, stages, tma_bar, full_bar, gt + 1);
          wgmma_wait0();
          reg_fence(o);
          reg_fence(sacc);
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) reg_fence(pa[kk]);
        } else {
          // O += (P8·V̂)/127 on mma.sync m16n8k32. A's k slots 4t..4t+3 and
          // 16+4t.. hold kv columns {2t, 2t+1, 8+2t, 9+2t} (+16) of the
          // 32-column chunk: exactly this thread's accumulator columns, so V̂'s
          // bytes are gathered in that order.
          const uint8_t* vraw = st + C::RAW;
          uint32_t pa[BKV / 32][4];
#pragma unroll
          for (int kc = 0; kc < BKV / 32; ++kc) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              // i: 0 row a, tiles 4kc/4kc+1; 1 row b; 2, 3 tiles 4kc+2/4kc+3
              const int t0 = 4 * kc + 2 * (i >> 1), e = 2 * (i & 1);
              uint32_t w = 0;
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float pr = sc[4 * (t0 + (u >> 1)) + e + (u & 1)];
                const uint32_t q8 = (uint32_t)fminf(fmaxf(rintf(pr * 127.0f), 0.0f), 127.0f);
                w |= q8 << (8 * u);
              }
              pa[kc][i] = w;
            }
          }
          // Byte (kv, 8nt + g) of the swizzled tile, kv = 32kc + 16h + 8j +
          // 2t4 + e: the row's swizzle bits depend on t4 and e alone, so each
          // address is a per-thread base, a constant and one XOR.
          const int gq = lane / 4;
          const uint8_t* vrow[2] = {vraw + (2 * t4) * RPB + gq, vraw + (2 * t4 + 1) * RPB + gq};
          const int vx[2] = {(RPB == 128 ? 2 * t4 : t4) << 4, (RPB == 128 ? 2 * t4 + 1 : t4) << 4};
#pragma unroll
          for (int nt = 0; nt < HO / 8; ++nt) {
            int cacc[4] = {0, 0, 0, 0};
            constexpr int PANEL_ROWS = BKV * RPB;
            const int at = (8 * nt / RPB) * PANEL_ROWS + 8 * (nt & 1);
            const int c16 = ((8 * nt) % RPB) & ~15;
#pragma unroll
            for (int kc = 0; kc < BKV / 32; ++kc) {
              uint32_t bw[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t w = 0;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int e = u & 1, row = 32 * kc + 16 * h + 8 * (u >> 1);
                  w |= (uint32_t)vrow[e][at + row * RPB + (c16 ^ vx[e])] << (8 * u);
                }
                bw[h] = w;
              }
              asm volatile(
                  "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                  "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                  : "+r"(cacc[0]), "+r"(cacc[1]), "+r"(cacc[2]), "+r"(cacc[3])
                  : "r"(pa[kc][0]), "r"(pa[kc][1]), "r"(pa[kc][2]), "r"(pa[kc][3]),
                    "r"(bw[0]), "r"(bw[1]));
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * nt + e] += (float)cacc[e] * INV127;
          }
          if (ahead && ST > 1) {
            begin_stage<HD, SP, PVQ>(sacc, q_addr, stages, tma_bar, full_bar, gt + 1);
            wgmma_wait0();
            reg_fence(sacc);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[s]);
        if (ahead && ST == 1) {  // one stage: the one just released
          begin_stage<HD, SP, PVQ>(sacc, q_addr, stages, tma_bar, full_bar, gt + 1);
          wgmma_wait0();
          reg_fence(sacc);
        }
      }
      g += it.steps;

      // finish: o = acc / l × σv, lse = m·ln2 + log(l); dead rows give 0, -inf.
      // σv in chunks of 8 pairs, each loaded before its stores (a store to
      // o could alias σv for the compiler: each load would wait for it).
      const bool va = la > 0.0f && ma > MASK * 0.5f, vb = lb > 0.0f && mb > MASK * 0.5f;
      const float ia = va ? 1.0f / la : 0.0f, ib = vb ? 1.0f / lb : 0.0f;
      // the item's head, kv row and O columns, again from the list (not
      // held across the steps)
      Item fin;
      fin.half = item % C::HALVES;
      fin.b = __ldcv(p.order + 3 * (item / C::HALVES)) / n_tiles;  // a fresh load
      fin.kv_row = (fin.b / p.hq) * p.hkv + (fin.b % p.hq) / (p.hq / p.hkv);
      const int oc = fin.half * HO;
      const float* svr = p.sv + (size_t)fin.kv_row * HD + oc + 2 * t4;
#pragma unroll
      for (int j0 = 0; j0 < HO / 8; j0 += 8) {
        float2 sv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) sv[u] = *reinterpret_cast<const float2*>(svr + 8 * (j0 + u));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qpos = half ? qb : qa;
          if (qpos >= sd.n_q) continue;
          const float inv = half ? ib : ia;
          const size_t at = ((size_t)fin.b * sd.n_q + qpos) * HD + oc;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int jj = j0 + u, col = 8 * jj + 2 * t4;
            const float x0 = (o[4 * jj + 2 * half] * inv) * sv[u].x;
            const float x1 = (o[4 * jj + 2 * half + 1] * inv) * sv[u].y;
            if (p.o_f32)
              *reinterpret_cast<float2*>(static_cast<float*>(p.o) + at + col) = make_float2(x0, x1);
            else
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.o) + at + col) =
                  __floats2bfloat162_rn(x0, x1);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qpos = half ? qb : qa;
        if (qpos < sd.n_q && p.lse != nullptr && t4 == 0 && fin.half == 0) {
          const float l = half ? lb : la, m = half ? mb : ma;
          const size_t row = (size_t)fin.b * sd.n_q + qpos;
          p.lse[row] = (half ? vb : va) ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
        }
      }
    }
  }
}


// the SMs of the current device: one persistent CTA each
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <int HD, int SP, bool PVQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<HD, SP, PVQ>;
  const int bh_kv = p.bh / p.hq * p.hkv;
  CUtensorMap mk, mv, mq;
  if (!make_map<HD, C::BKV, C::RPB>(&mk, p.k, p.s.n_kv, bh_kv) ||
      !make_map<HD, C::BKV, C::RPB>(&mv, p.v, p.s.n_kv, bh_kv))
    return cudaErrorInvalidValue;
  // the Q operand: (bh, n_q, QROW) bytes in boxes of one panel × 64 rows
  if (p.q_mode < Q_LOAD_BF16 || !make_box_map(&mq, p.q, C::QROW, p.s.n_q, p.bh, C::QPB, 64))
    return cudaErrorInvalidValue;
  auto kern = quant_attention_persistent<HD, SP, PVQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const long items = (long)p.bh * ((p.s.n_q + C::BQ - 1) / C::BQ) * C::HALVES;
  const int sms = sm_count();
  if (sms <= 0 || items > 0x7fffffffL) return cudaErrorInvalidValue;
  kern<<<(int)(items < sms ? items : sms), 384, C::SMEM, stream>>>(mk, mv, mq, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_d(const Params& p, int sp, bool pvq, cudaStream_t stream) {
  if (pvq) {
    if (sp == S_INT8) return launch<HD, S_INT8, true>(p, stream);
    if (sp == S_BF16) return launch<HD, S_BF16, true>(p, stream);
    return cudaErrorInvalidValue;
  }
  switch (sp) {
    case S_BF16: return launch<HD, S_BF16, false>(p, stream);
    case S_E4M3: return launch<HD, S_E4M3, false>(p, stream);
    case S_E5M2: return launch<HD, S_E5M2, false>(p, stream);
    case S_INT8: return launch<HD, S_INT8, false>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// what a launch takes (p.bh, p.s.n_q > 0): its score product, or -1
int score_product(const Params& p, int d, int pv_quant) {
  if (p.hkv <= 0 || p.hq % p.hkv != 0 || p.bh % p.hq != 0 || p.s.n_kv <= 0 ||
      p.order == nullptr || !sched_ok(p.s) || p.kv_dtype < KV_INT8 || p.kv_dtype > KV_E5M2 ||
      (d != 64 && d != 128 && d != 256 && d != 512))
    return -1;
  const bool qi8 = p.q_mode == Q_INT8 || p.q_mode == Q_LOAD_INT8;
  const bool qf8 = p.q_mode == Q_FP8 || p.q_mode == Q_LOAD_FP8;
  // 8-bit products need a cache of the same family; pv_quant an int8 one
  if ((qi8 || pv_quant) && p.kv_dtype != KV_INT8) return -1;
  if (qf8 && p.kv_dtype == KV_INT8) return -1;
  return qi8 ? S_INT8 : !qf8 ? S_BF16 : p.kv_dtype == KV_E4M3 ? S_E4M3 : S_E5M2;
}

cudaError_t dispatch(const Params& p, int d, int pv_quant, cudaStream_t stream) {
  if (p.bh <= 0 || p.s.n_q <= 0) return cudaSuccess;
  const int sp = score_product(p, d, pv_quant);
  if (sp < 0) return cudaErrorInvalidValue;
  if (d == 128) return dispatch_d<128>(p, sp, pv_quant != 0, stream);
  if (d == 64) return dispatch_d<64>(p, sp, pv_quant != 0, stream);
  if (d == 256) return dispatch_d<256>(p, sp, pv_quant != 0, stream);
  if (d == 512) return dispatch_d<512>(p, sp, pv_quant != 0, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// B6/B8. q: (bh, n_q, d) float32 (q_f32 = 1) or bf16, unscaled; k, v:
// (bh / hq · hkv, n_kv, d) int8 / e4m3 / e5m2 (kv_dtype 0 / 1 / 2);
// sk_token (bh_kv, n_kv) or sk_tensor (bh_kv), one of them null; sv
// (bh_kv, d); gk (bh_kv) or null for the exact running max; o like q; lse
// (bh, n_q) or null; q_out (bh, n_q, d) and qs_out (bh, n_q; null in the
// weight-only mode): the staged operand (bytes, or bf16 in weight-only
// mode) and its row factors, written by the staging pass and read by the
// attention kernel; order: the work list, (bh · ceil(n_q / 128), 3) int32
// rows (b · ceil(n_q / 128) + q tile, first kv tile, kv tiles), each
// (batch·head, q tile) once (quant/flash_q.py:work_order). kind, offset,
// radius, section: the schedule (schedule.cuh; n_kv is the halo-extended
// length for the circulant). q_mode 0 weight-only, 1 fp8 (e4m3 Q), 2 int8
// Q. c is float32(scale·log2e). All contiguous, 16-byte aligned; d ∈ {64,
// 128, 256, 512}.
extern "C" cudaError_t tf_serving_attention(
    const void* q, const void* k, const void* v, const float* sk_token,
    const float* sk_tensor, const float* sv, const float* gk, void* o, float* lse,
    void* q_out, float* qs_out, const int* order, int bh, int n_q, int n_kv, int hq,
    int hkv, int d, int kind, int offset, int radius, int section, int q_mode, int q_f32,
    int kv_dtype, int pv_quant, float c, cudaStream_t stream) {
  if (q_mode < Q_RAW || q_mode > Q_INT8 || q_out == nullptr ||
      (q_mode != Q_RAW && qs_out == nullptr))
    return cudaErrorInvalidValue;
  Params p{q, nullptr, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
           sk_token, sk_tensor, sv, gk, o, lse, order,
           Sched{n_q, n_kv, kind, offset, radius, section}, bh, hq, hkv, q_mode, q_f32,
           kv_dtype, q_f32, c};
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  if (score_product(p, d, pv_quant) < 0) return cudaErrorInvalidValue;
  const long rows = (long)bh * n_q;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  switch (d) {
    case 64: quant_stage_q<64><<<blocks, 256, 0, stream>>>(p, q_out, qs_out); break;
    case 128: quant_stage_q<128><<<blocks, 256, 0, stream>>>(p, q_out, qs_out); break;
    case 256: quant_stage_q<256><<<blocks, 256, 0, stream>>>(p, q_out, qs_out); break;
    case 512: quant_stage_q<512><<<blocks, 256, 0, stream>>>(p, q_out, qs_out); break;
    default: return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the attention over the staged operand, its factors times 1
  p.q = q_out;
  p.sq = qs_out;
  p.q_mode = q_mode == Q_RAW ? Q_LOAD_BF16 : q_mode == Q_FP8 ? Q_LOAD_FP8 : Q_LOAD_INT8;
  p.q_f32 = 0;
  p.c = 1.0f;
  return dispatch(p, d, pv_quant, stream);
}

// B7. q: (bh, n_q, d) bf16 score operand (q_kind 0, sq null), or int8
// (q_kind 1) / e4m3 (q_kind 2) q̂ with sq (bh, n_q) its row factors, which
// the kernel multiplies by c; k, v, sk_token (or null), sv, gk, lse and
// order as above; o (bh, n_q, d) float32 (o_f32 = 1) or bf16.
extern "C" cudaError_t tf_quant_attention(
    const void* q, const float* sq, const void* k, const void* v,
    const float* sk_token, const float* sv, const float* gk, void* o, float* lse,
    const int* order, int bh, int n_q, int n_kv, int hq, int hkv, int d, int kind,
    int offset, int radius, int section, int q_kind, int kv_dtype, int o_f32, float c,
    cudaStream_t stream) {
  if (q_kind < 0 || q_kind > 2) return cudaErrorInvalidValue;
  const int q_mode = q_kind == 0 ? Q_LOAD_BF16 : q_kind == 1 ? Q_LOAD_INT8 : Q_LOAD_FP8;
  const Params p{q, sq, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
                 sk_token, nullptr, sv, gk, o, lse, order,
                 Sched{n_q, n_kv, kind, offset, radius, section}, bh, hq, hkv, q_mode, 0,
                 kv_dtype, o_f32, c};
  return dispatch(p, d, 0, stream);
}
