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
// two runs), the kind a runtime
// argument as in B1 and B4/B5. A CTA's producer and consumers walk the same
// kv tiles, kv_range's [first, last] for its 128 q rows; a consumer masks a
// tile only where tile_full says its 64 rows do not see all of it, by each
// row's key_span.
//
// What it computes. Q staging, once per CTA before the kv loop (the
// reference's s == 0 init, serving_attn.py:155-198): the row amax,
// sq = max(amax, 1e-12) / qmax (an IEEE divide), q / sq rounded to nearest
// even onto e4m3 (__NV_SATFINITE) or int8 (rintf, clipped to ±127), and the
// row factor f = (sq · scale·log2e) · sk_fold in float32; weight-only Q is
// q · (scale·log2e · sk_fold) cast to bf16, f = 1. sk_fold is the per-(batch,
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
// P·V at the bf16 peak (989) gives ~0.83 ms.
//
// Design (FA-3 shaped). One CTA of three warpgroups per (128-row q tile,
// q head); the q heads of a kv head are neighbours in blockIdx.y, and under
// the causal schedule the heaviest q tiles are launched first.
// - Warpgroup 2 produces. Its first warp issues TMA (cp.async.bulk.tensor,
//   tensor maps from cuTensorMapEncodeTiled, 128-byte swizzle, 64-byte at
//   d 64) for the K̂ and V̂ tiles into a ring of 1-3 stages with full/empty
//   mbarriers; TMA zero-fills ragged n. Its other three warps decode V̂
//   exactly to bf16 in place of layout (the P·V product reads it MN-major,
//   through wgmma's transpose bit: no transpose in shared memory), decode
//   K̂ in the weight-only mode, and load the σk tile. It gives its
//   registers to the consumers (setmaxnreg 40 / 232).
// - Warpgroups 0 and 1 consume, 64 q rows each. Q·Kᵀ: wgmma with both
//   operands in shared memory, e4m3 × e4m3|e5m2 (f32 accumulators) or
//   s8 × s8 (s32, exact), straight from the TMA'd K̂ bytes, or bf16 × bf16
//   against the decoded K̂ in the weight-only mode. fp8 sums each k32 step
//   on a fresh accumulator and adds the steps in float32 (promotion):
//   inside a step the fp8 units truncate each product to 2^(E-14), E the
//   step's largest exponent-field sum + 1, and the sum to 14 significant
//   bits (measured: bench/fp8_sums.py; the plain version models it,
//   quant/flash_q.py:fp8_scores). Chained steps would truncate the running
//   sum too. S, P and the O accumulator stay in registers: the row max and
//   sum use quad shuffles,
//   P (bf16) is the register A operand of the P·V wgmma. The bound mode
//   skips the rescale. pv_quant's int8 P·V runs on mma.sync m16n8k32 with
//   the kv order permuted so that P's accumulator registers are its A
//   fragment (V̂'s bytes are gathered to match).
// - Tiles: BKV 128 kv rows at d <= 128, 64 at d 256, 32 at d 512; as many
//   ring stages as fit in 227 KB (Cfg below).
// - Width 512 (the reference tiles any d): O alone would take 256 float32
//   registers a thread of a 64-row warpgroup, and in the weight-only mode Q
//   (128 KB) and one stage of 64 kv rows (192 KB) outgrow shared memory.
//   So O's 256-column halves go on the grid (blockIdx.z), as in B1: each
//   CTA runs Q·Kᵀ and the softmax over the full width, loads and decodes
//   only its half of V̂, and accumulates only that half of O; the kv tile
//   shrinks to 32 rows (flash_q.kernel_block_kv, which the plain version
//   walks too). Half 0 writes lse and the staged Q.
// - Registers (python -m
//   tpu_flash_torch.kernels._build quant_attention.cu, CUDA 12.8): every
//   instantiation reports 168; none of the score-product ones spills, d
//   256 included; the pv_quant ones spill a little in their mma.sync V̂
//   gather (PERF.md §6 lists the bytes).
//
// Where it stands: PERF.md §6 (chip_smoke.py on an NVIDIA H100): about a
// quarter of the bound at the headline, and still behind bf16 SDPA; on the
// band kinds, where a CTA walks 3-10 kv tiles, 4-11%: its prologue (Q
// staged row by row, the first stage) and epilogue cost about as much as
// the steps, with one CTA an SM. In one
// CTA the V̂ decode, Q·Kᵀ, the softmax and P·V still run mostly one after
// another (each wgmma is waited for before the next step; a ping-pong of
// the two consumer warpgroups, tried, gained nothing), and every 128-row q
// tile streams its head's whole K̂/V̂ from L2 (4.3 GB at the headline). The
// next steps: TMA multicast of K̂/V̂ to a cluster of q tiles, and Q·Kᵀ of
// tile t+1 overlapped with the softmax of tile t.

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
  void* q_out;            // (bh, n_q, d) staged Q operand, or null
  float* qs_out;          // (bh, n_q) staged row factors, or null
  Sched s;  // n_q, n_kv (the halo-extended length for the circulant), kind
  int hq, hkv;
  int q_mode, q_f32, kv_dtype, o_f32;
  float c;  // staging: float32(scale·log2e); modes 4, 5: the factor's multiplier
};

// Tiles and the shared-memory plan of one instantiation. A stage holds K̂
// (raw), the CTA's columns of V̂ (raw), K̂ decoded to bf16 (weight-only) and
// those columns of V̂ decoded (not under pv_quant), in that order.
template <int HD, int SP, bool PVQ> struct Cfg {
  static constexpr int BQ = 128;                    // two consumer warpgroups
  static constexpr int BKV = HD == 512 ? 32 : HD == 256 ? 64 : 128;  // kv rows a stage
  static constexpr int HO = HD > 256 ? 256 : HD;    // O's columns a CTA
  static constexpr bool Q8 = SP != S_BF16;          // 8-bit score operands
  static constexpr int RPB = HD >= 128 ? 128 : 64;  // panel bytes, 8-bit tiles
  static constexpr int QPB = Q8 ? RPB : 128;        // panel bytes, Q operand
  static constexpr int QBYTES = BQ * HD * (Q8 ? 1 : 2);
  static constexpr int RAW = BKV * HD;              // one 8-bit K̂ tile
  static constexpr int RAWV = BKV * HO;             // the CTA's columns of V̂
  static constexpr int KB = Q8 ? 0 : BKV * HD * 2;  // decoded K̂ (bf16)
  static constexpr int VT = PVQ ? 0 : BKV * HO * 2; // decoded V̂ᵀ (bf16)
  static constexpr int KB_OFF = RAW + RAWV, VT_OFF = KB_OFF + KB;
  static constexpr int STAGE = VT_OFF + VT;
  static constexpr int bytes(int st) {
    // 1024 of alignment slack, Q, the stages, σk tiles, row factors and
    // bounds, three barriers a stage
    return 1024 + QBYTES + st * STAGE + st * BKV * 4 + BQ * 8 + st * 24;
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

// One consumer warpgroup's 64 Q rows into shared memory as the score
// operand (swizzled, K-major), with each row's factor f and softmax start
// m (the norm bound, or MASK). Each warp stages 16 rows, one at a time.
template <int HD, int SP, bool PVQ>
__device__ void stage_q(const Params& p, uint8_t* qs, float* rowf, float* rowm, int b,
                        int q0, int kv_row, int warp, int lane) {
  using C = Cfg<HD, SP, PVQ>;
  constexpr int QPB = C::QPB;
  const float skf = p.sk_tensor != nullptr ? p.sk_tensor[kv_row] : 1.0f;
  const float gk1 = p.gk != nullptr ? p.gk[kv_row] * 1.0001f : 0.0f;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qpos = q0 + r;
    const bool real = qpos < p.s.n_q;
    const size_t row = (size_t)b * p.s.n_q + (real ? qpos : 0);
    float x[HD / 32];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      const int col = lane + 32 * i;
      float v = 0.0f;
      if (real) {
        if (p.q_mode == Q_LOAD_BF16)
          v = __bfloat162float(static_cast<const bf16*>(p.q)[row * HD + col]);
        else if (p.q_mode == Q_LOAD_INT8)
          v = (float)static_cast<const int8_t*>(p.q)[row * HD + col];
        else if (p.q_mode == Q_LOAD_FP8)
          v = fp8_to_float(static_cast<const uint8_t*>(p.q)[row * HD + col], KV_E4M3);
        else
          v = load_q(p, row, col, HD);
      }
      x[i] = v;
      amax = fmaxf(amax, fabsf(v));
    }
    // the operand (exact as a float) into x, its bytes into shared memory
    float f = 1.0f;
    if (p.q_mode == Q_FP8 || p.q_mode == Q_INT8) {
      const float qmax = p.q_mode == Q_FP8 ? 448.0f : 127.0f;
      const float sq = fmaxf(warp_max(amax), 1e-12f) / qmax;
      f = (sq * p.c) * skf;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) {
        uint8_t byte;
        if (p.q_mode == Q_FP8) {
          byte = (uint8_t)__nv_cvt_float_to_fp8(x[i] / sq, __NV_SATFINITE, __NV_E4M3);
          x[i] = fp8_to_float(byte, KV_E4M3);
        } else {
          x[i] = fminf(fmaxf(rintf(x[i] / sq), -127.0f), 127.0f);
          byte = (uint8_t)(int8_t)x[i];
        }
        qs[tile_off<QPB, 64>(r, lane + 32 * i)] = byte;
      }
    } else if (p.q_mode == Q_LOAD_INT8 || p.q_mode == Q_LOAD_FP8) {
      f = real ? p.sq[row] * p.c : 0.0f;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i)
        qs[tile_off<QPB, 64>(r, lane + 32 * i)] =
            real ? static_cast<const uint8_t*>(p.q)[row * HD + lane + 32 * i] : 0;
    } else {  // bf16 operand: weight-only staging (Q_RAW) or loaded
      const float fold = p.c * skf;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) {
        const bf16 h = __float2bfloat16_rn(p.q_mode == Q_RAW ? x[i] * fold : x[i]);
        x[i] = __bfloat162float(h);
        *reinterpret_cast<bf16*>(qs + tile_off<128, 64>(r, 2 * (lane + 32 * i))) = h;
      }
    }
    float sumsq = 0.0f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) sumsq += x[i] * x[i];
    const float qn = sqrtf(warp_sum(sumsq)) * f;
    if (lane == 0) {
      rowf[r] = f;
      rowm[r] = p.gk != nullptr ? qn * gk1 : MASK;
    }
    if (p.q_out != nullptr && real && blockIdx.z == 0) {  // the staged operand, for checking
      const size_t at = row * HD;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) {
        const int col = lane + 32 * i;
        if (C::Q8)
          static_cast<uint8_t*>(p.q_out)[at + col] = qs[tile_off<QPB, 64>(r, col)];
        else
          static_cast<bf16*>(p.q_out)[at + col] = __float2bfloat16_rn(x[i]);
      }
      if (lane == 0 && p.qs_out != nullptr) p.qs_out[row] = f;
    }
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
    // K̂ → bf16 K, same rows: 16 bytes in, 32 out
    for (int u = tid; u < BKV * HD / 16; u += NT) {
      const int r = u % BKV, cb = (u / BKV) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(kraw + tile_off<RPB, BKV>(r, cb));
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) decode4(in[i], kv, w[2 * i], w[2 * i + 1]);
      *reinterpret_cast<uint4*>(kb + tile_off<128, BKV>(r, 2 * cb)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(kb + tile_off<128, BKV>(r, 2 * cb + 16)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  if constexpr (!PVQ) {
    // V̂ → bf16 V̂ (the CTA's columns), same rows: the P·V product reads it
    // MN-major
    for (int u = tid; u < BKV * C::HO / 16; u += NT) {
      const int r = u % BKV, cb = (u / BKV) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(vraw + tile_off<RPB, BKV>(r, cb));
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) decode4(in[i], kv, w[2 * i], w[2 * i + 1]);
      *reinterpret_cast<uint4*>(vt + tile_off<128, BKV>(r, 2 * cb)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(vt + tile_off<128, BKV>(r, 2 * cb + 16)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  if (p.sk_token != nullptr)
    for (int j = tid; j < BKV; j += NT)
      skt[j] = k0 + j < p.s.n_kv ? p.sk_token[(size_t)kv_row * p.s.n_kv + k0 + j] : 0.0f;
}


template <int HD, int SP, bool PVQ>
__global__ void __launch_bounds__(384, 1)
    quant_attention_kernel(const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v, const Params p) {
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

  const Sched sd = p.s;
  const int n_tiles = (sd.n_q + C::BQ - 1) / C::BQ;
  // the heaviest causal q tiles first; the other kinds as the grid gives them
  const int qt = sd.kind == CAUSAL ? n_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * C::BQ;
  const int b = blockIdx.y;
  const int oc = blockIdx.z * HO;  // this CTA's columns of V̂ and O
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  // the kv tiles this CTA visits: the producer loads exactly these and the
  // consumers wait for exactly these
  int first, last;
  kv_range(sd, q0, min(q0 + C::BQ - 1, sd.n_q - 1), BKV, first, last);
  const int steps = max(0, last - first + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&tma_bar[s], 1);
      mbar_init(&full_bar[s], 96);  // the three decoding warps
      mbar_init(&empty_bar[s], 8);  // lane 0 of each consumer warp
    }
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
        for (int t = 0; t < steps; ++t) {
          const int s = t % ST, ph = (t / ST) & 1;
          mbar_wait(&empty_bar[s], ph ^ 1);
          uint8_t* st = stages + s * C::STAGE;
          const int k0 = (first + t) * BKV;
          mbar_expect_tx(&tma_bar[s], C::RAW + C::RAWV);
          for (int pn = 0; pn < HD / RPB; ++pn)
            tma_load_3d(st + pn * BKV * RPB, &tmap_k, pn * RPB, k0, kv_row, &tma_bar[s]);
          for (int pn = 0; pn < HO / RPB; ++pn)
            tma_load_3d(st + C::RAW + pn * BKV * RPB, &tmap_v, oc + pn * RPB, k0, kv_row,
                        &tma_bar[s]);
        }
      }
    } else {
      const int tid = wtid - 32;
      for (int t = 0; t < steps; ++t) {
        const int s = t % ST, ph = (t / ST) & 1;
        uint8_t* st = stages + s * C::STAGE;
        mbar_wait(&tma_bar[s], ph);
        decode_stage<HD, SP, PVQ>(p, st, st + C::RAW, st + C::KB_OFF, st + C::VT_OFF,
                                  skt + s * BKV, (first + t) * BKV, kv_row, tid);
        fence_async_smem();
        mbar_arrive(&full_bar[s]);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    uint8_t* qw = qs + wg * 64 * HD * (C::Q8 ? 1 : 2);
    const int qw0 = q0 + 64 * wg, qw_last = min(qw0 + 63, sd.n_q - 1);  // this warpgroup's rows
    stage_q<HD, SP, PVQ>(p, qw, rowf + 64 * wg, rowm + 64 * wg, b, qw0, kv_row, warp, lane);
    fence_async_smem();
    wg_barrier(1 + wg);

    // this thread's two accumulator rows
    const int ra = warp * 16 + lane / 4, rb = ra + 8;
    const int qa = qw0 + ra, qb = qw0 + rb;
    const int t4 = lane % 4;
    // the keys each of the two rows sees
    const Span span_a = key_span(sd, qa), span_b = key_span(sd, qb);
    const float fa = rowf[64 * wg + ra], fb = rowf[64 * wg + rb];
    float ma = rowm[64 * wg + ra], mb = rowm[64 * wg + rb];
    float la = 0.0f, lb = 0.0f;
    const bool bound = p.gk != nullptr;
    float o[HO / 2];
#pragma unroll
    for (int i = 0; i < HO / 2; ++i) o[i] = 0.0f;
    const uint32_t q_addr = smem_u32(qw);

    for (int t = 0; t < steps; ++t) {
      const int s = t % ST, ph = (t / ST) & 1;
      const int k0 = (first + t) * BKV;
      uint8_t* st = stages + s * C::STAGE;
      mbar_wait(&tma_bar[s], ph);
      mbar_wait(&full_bar[s], ph);

      // S = Q·Kᵀ on the tensor cores, operands in shared memory
      Acc sacc[BKV / 2];
      {
        const uint32_t k_addr = smem_u32(C::Q8 ? st : st + C::KB_OFF);
        constexpr int KSTEPS = C::Q8 ? HD / 32 : HD / 16;  // 32 bytes a step
        constexpr bool FP8 = SP == S_E4M3 || SP == S_E5M2;
        if constexpr (FP8) {
          // each k32 step into its own accumulator, the steps summed in
          // float32 (promotion): the fp8 units truncate inside a step
          // (flash_q.fp8_scores), and chained steps would carry that into
          // the running sum
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const int colb = 32 * kk;
            const uint64_t da = desc<QPB>(q_addr + (colb / QPB) * 64 * QPB + colb % QPB);
            const uint64_t db = desc<QPB>(k_addr + (colb / QPB) * BKV * QPB + colb % QPB);
            float part[BKV / 2];
            wgmma_fence();
            if constexpr (SP == S_E4M3) wgmma_e4m3_e4m3<BKV>(part, da, db, 0);
            else if constexpr (SP == S_E5M2) wgmma_e4m3_e5m2<BKV>(part, da, db, 0);
            wgmma_commit();
            wgmma_wait0();
            reg_fence(part);
#pragma unroll
            for (int i = 0; i < BKV / 2; ++i) sacc[i] = kk ? sacc[i] + part[i] : part[i];
          }
        } else {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const int colb = 32 * kk;
            const uint64_t da = desc<QPB>(q_addr + (colb / QPB) * 64 * QPB + colb % QPB);
            const uint64_t db = desc<QPB>(k_addr + (colb / QPB) * BKV * QPB + colb % QPB);
            if constexpr (SP == S_INT8) wgmma_s8_s8<BKV>(sacc, da, db, kk);
            else wgmma_bf16_bf16<BKV>(sacc, da, db, kk);
          }
          wgmma_commit();
          wgmma_wait0();
          reg_fence(sacc);
        }
      }

      // scores, masks and the online softmax, in registers
      float sc[BKV / 2];
      float alpha_a = 1.0f, alpha_b = 1.0f;
      if (p.sk_token != nullptr) {  // per-token K scales: the row's two columns at once
        const float* sk = skt + s * BKV;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          const float2 skj = *reinterpret_cast<const float2*>(sk + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = ((float)sacc[4 * j + e] * (e < 2 ? fa : fb)) * (e & 1 ? skj.y : skj.x);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) sc[i] = (float)sacc[i] * ((i & 2) ? fb : fa);
      }
      if (!tile_full(sd, k0, k0 + BKV - 1, qw0, qw_last)) {
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
        for (int j = 0; j < HO / 8; ++j) {
          o[4 * j] *= alpha_a;
          o[4 * j + 1] *= alpha_a;
          o[4 * j + 2] *= alpha_b;
          o[4 * j + 3] *= alpha_b;
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
        // O += P·V̂: P (bf16) as the register A operand, V̂ in shared memory
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
        wgmma_wait0();
        reg_fence(o);
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
        const int g = lane / 4;
        const uint8_t* vrow[2] = {vraw + (2 * t4) * RPB + g, vraw + (2 * t4 + 1) * RPB + g};
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
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[s]);
    }

    // finish: o = acc / l × σv, lse = m·ln2 + log(l); dead rows give 0, -inf
    const bool va = la > 0.0f && ma > MASK * 0.5f, vb = lb > 0.0f && mb > MASK * 0.5f;
    const float ia = va ? 1.0f / la : 0.0f, ib = vb ? 1.0f / lb : 0.0f;
    const float* sv = p.sv + (size_t)kv_row * HD + oc;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = half ? qb : qa;
      if (qpos >= p.s.n_q) continue;
      const float inv = half ? ib : ia;
      const size_t row = (size_t)b * p.s.n_q + qpos;
      const size_t at = row * HD + oc;
#pragma unroll
      for (int j = 0; j < HO / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        const float x0 = (o[4 * j + 2 * half] * inv) * sv[col];
        const float x1 = (o[4 * j + 2 * half + 1] * inv) * sv[col + 1];
        if (p.o_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.o) + at + col) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.o) + at + col) =
              __floats2bfloat162_rn(x0, x1);
      }
      if (p.lse != nullptr && t4 == 0 && blockIdx.z == 0) {
        const float l = half ? lb : la, m = half ? mb : ma;
        p.lse[row] = (half ? vb : va) ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
      }
    }
  }
}


template <int HD, int SP, bool PVQ>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  using C = Cfg<HD, SP, PVQ>;
  const int bh_kv = bh / p.hq * p.hkv;
  CUtensorMap mk, mv;
  if (!make_map<HD, C::BKV, C::RPB>(&mk, p.k, p.s.n_kv, bh_kv) ||
      !make_map<HD, C::BKV, C::RPB>(&mv, p.v, p.s.n_kv, bh_kv))
    return cudaErrorInvalidValue;
  auto kern = quant_attention_kernel<HD, SP, PVQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.s.n_q + C::BQ - 1) / C::BQ, bh, HD / C::HO);
  kern<<<grid, 384, C::SMEM, stream>>>(mk, mv, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_d(const Params& p, int bh, int sp, bool pvq, cudaStream_t stream) {
  if (pvq) {
    if (sp == S_INT8) return launch<HD, S_INT8, true>(p, bh, stream);
    if (sp == S_BF16) return launch<HD, S_BF16, true>(p, bh, stream);
    return cudaErrorInvalidValue;
  }
  switch (sp) {
    case S_BF16: return launch<HD, S_BF16, false>(p, bh, stream);
    case S_E4M3: return launch<HD, S_E4M3, false>(p, bh, stream);
    case S_E5M2: return launch<HD, S_E5M2, false>(p, bh, stream);
    case S_INT8: return launch<HD, S_INT8, false>(p, bh, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const Params& p, int bh, int d, int pv_quant, cudaStream_t stream) {
  if (bh <= 0 || p.s.n_q <= 0) return cudaSuccess;
  if (p.hkv <= 0 || p.hq % p.hkv != 0 || bh % p.hq != 0 || p.s.n_kv <= 0)
    return cudaErrorInvalidValue;
  if (!sched_ok(p.s)) return cudaErrorInvalidValue;
  if (p.kv_dtype < KV_INT8 || p.kv_dtype > KV_E5M2) return cudaErrorInvalidValue;
  const bool qi8 = p.q_mode == Q_INT8 || p.q_mode == Q_LOAD_INT8;
  const bool qf8 = p.q_mode == Q_FP8 || p.q_mode == Q_LOAD_FP8;
  // 8-bit products need a cache of the same family; pv_quant an int8 one
  if ((qi8 || pv_quant) && p.kv_dtype != KV_INT8) return cudaErrorInvalidValue;
  if (qf8 && p.kv_dtype == KV_INT8) return cudaErrorInvalidValue;
  const int sp = qi8 ? S_INT8 : !qf8 ? S_BF16 : p.kv_dtype == KV_E4M3 ? S_E4M3 : S_E5M2;
  if (d == 128) return dispatch_d<128>(p, bh, sp, pv_quant != 0, stream);
  if (d == 64) return dispatch_d<64>(p, bh, sp, pv_quant != 0, stream);
  if (d == 256) return dispatch_d<256>(p, bh, sp, pv_quant != 0, stream);
  if (d == 512) return dispatch_d<512>(p, bh, sp, pv_quant != 0, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// B6/B8. q: (bh, n_q, d) float32 (q_f32 = 1) or bf16, unscaled; k, v:
// (bh / hq · hkv, n_kv, d) int8 / e4m3 / e5m2 (kv_dtype 0 / 1 / 2);
// sk_token (bh_kv, n_kv) or sk_tensor (bh_kv), one of them null; sv
// (bh_kv, d); gk (bh_kv) or null for the exact running max; o like q; lse
// (bh, n_q) or null; q_out/qs_out null or (bh, n_q, d) / (bh, n_q) for the
// staged operand (bytes, or bf16 in weight-only mode) and its row factors.
// kind, offset, radius, section: the schedule (schedule.cuh; n_kv is the
// halo-extended length for the circulant). q_mode 0 weight-only, 1 fp8
// (e4m3 Q), 2 int8 Q. c is float32(scale·log2e). All contiguous, 16-byte
// aligned; d ∈ {64, 128, 256, 512}.
extern "C" cudaError_t tf_serving_attention(
    const void* q, const void* k, const void* v, const float* sk_token,
    const float* sk_tensor, const float* sv, const float* gk, void* o, float* lse,
    void* q_out, float* qs_out, int bh, int n_q, int n_kv, int hq, int hkv, int d,
    int kind, int offset, int radius, int section, int q_mode, int q_f32, int kv_dtype,
    int pv_quant, float c, cudaStream_t stream) {
  if (q_mode < Q_RAW || q_mode > Q_INT8) return cudaErrorInvalidValue;
  const Params p{q, nullptr, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
                 sk_token, sk_tensor, sv, gk, o, lse, q_out, qs_out,
                 Sched{n_q, n_kv, kind, offset, radius, section}, hq, hkv, q_mode, q_f32,
                 kv_dtype, q_f32, c};
  return dispatch(p, bh, d, pv_quant, stream);
}

// B7. q: (bh, n_q, d) bf16 score operand (q_kind 0, sq null), or int8
// (q_kind 1) / e4m3 (q_kind 2) q̂ with sq (bh, n_q) its row factors, which
// the kernel multiplies by c; k, v, sk_token (or null), sv, gk, lse as
// above; o (bh, n_q, d) float32 (o_f32 = 1) or bf16.
extern "C" cudaError_t tf_quant_attention(
    const void* q, const float* sq, const void* k, const void* v,
    const float* sk_token, const float* sv, const float* gk, void* o, float* lse,
    int bh, int n_q, int n_kv, int hq, int hkv, int d, int kind, int offset, int radius,
    int section, int q_kind, int kv_dtype, int o_f32, float c, cudaStream_t stream) {
  if (q_kind < 0 || q_kind > 2) return cudaErrorInvalidValue;
  const int q_mode = q_kind == 0 ? Q_LOAD_BF16 : q_kind == 1 ? Q_LOAD_INT8 : Q_LOAD_FP8;
  const Params p{q, sq, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
                 sk_token, nullptr, sv, gk, o, lse, nullptr, nullptr,
                 Sched{n_q, n_kv, kind, offset, radius, section}, hq, hkv, q_mode, 0, kv_dtype,
                 o_f32, c};
  return dispatch(p, bh, d, 0, stream);
}
