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
// The two entry points differ only in how Q reaches shared memory. B6 stages
// it once per block, before the kv loop (the reference's s == 0 init,
// serving_attn.py:155-198): the row amax, sq = max(amax, 1e-12) / qmax (an
// IEEE divide), q / sq rounded to nearest even onto e4m3
// (__nv_cvt_float_to_fp8) or onto int8 (rintf, clipped to ±127); in fp8
// mode the e4m3 values are decoded again (exactly) and multiplied by
// (sq · scale·log2e) · sk_fold, in the reference's float32 order, then cast
// to bf16; in weight-only mode q · (scale·log2e · sk_fold) is cast to bf16.
// sk_fold is the per-(batch, kv head) K scale of kv_scale="tensor", else 1.
// The host quantizer (quant/serving_attn.py:_stage_q_plain) does the same
// arithmetic, and the two agree on every staged byte. B7 loads a bf16 Q
// operand, or int8 q̂ with its row scales (times log2e here).
//
// The loop: one block of 4 warps per (64-row q tile, bh row), GQA through
// the kv-row map, kv tiles of 64 up to B1's causal limit. Q·Kᵀ: int8 q̂
// against int8 K̂ on WMMA signed-char fragments with int32 accumulators
// (exact: d·127² < 2²⁴), then × the row's q scale; otherwise bf16 WMMA
// against K̂ decoded exactly to bf16 in shared memory (int8 and both fp8
// formats are subsets of bf16). A per-token K scale multiplies the float32
// score columns. The max is the constant norm bound
// m = ‖q_row‖·(max_j ‖k̂_j‖·σk_j)·1.0001 when gk is given (the host computes
// the per-kv-row max on the values the kernel dots; any upper bound keeps
// the online softmax exact, and no rescale runs), else the exact running
// max. Base-2 softmax; P in bf16 against V̂ decoded to bf16 on bf16 WMMA, or
// under pv_quant P → clip(rint(p·127), 0, 127) against int8 V̂ on int8 WMMA,
// scaled by 1/127. l sums the float32 p (B8 summed bf16 p through a ones
// row of V̂ᵀ; the card needs no transposed layout, so d 64 runs this loop
// too). The finish mirrors serving_attn.py:332-346: rows with l = 0 or
// m <= MASK/2 give o = 0 and lse = -inf, then o × σv per channel.
//
// int8 WMMA tiles need 256-bit aligned fragment bases, so int8 tiles are
// kept k-chunked in shared memory: element (row, col) at
// ((col / 16) · ROWS + row) · 16 + col % 16, a leading dimension of 16.
//
// What bounds it on an H100: at the headline shape (b 4, h 8, n 8192,
// d 128) it is tensor-core operations, 1.10 TFLOP against ~40 MB of q, K̂, V̂
// and o, far right of the ridge: Q·Kᵀ at the fp8/int8 peak (1979 TFLOP/s)
// plus P·V at the bf16 peak (989; 1979 under pv_quant) gives ~0.83 ms. This
// first version uses the pre-Hopper WMMA path at 64×64 tiles with ~114 KB of
// shared memory a block (one block per SM) and no pipelining; fp8 runs on
// bf16 tensor cores after an in-shared-memory decode. Native fp8
// wgmma / mma.sync, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;     // q rows per block
constexpr int BKV = 64;    // kv rows per step
constexpr int NWARPS = 4;  // each warp owns 16 q rows
constexpr int NTHREADS = NWARPS * 32;
// DEFAULT_MASK_VALUE = -0.7 * float32 max, rounded to float32.
constexpr float MASK = -0x1.666664p+127f;
constexpr float LN2 = 0.693147180559945309f;
constexpr float INV127 = (float)(1.0 / 127.0);

// Q staging modes (the wrappers pass them).
enum { Q_RAW = 0, Q_FP8 = 1, Q_INT8 = 2, Q_LOAD_BF16 = 3, Q_LOAD_INT8 = 4 };
// Cache storage codes.
enum { KV_INT8 = 0, KV_E4M3 = 1, KV_E5M2 = 2 };

struct Params {
  const void* q;          // (bh, n_q, d): raw f32/bf16 (modes 0-2), bf16
                          // operand (3) or int8 q̂ (4)
  const float* sq;        // (bh, n_q) q̂ scales (mode 4)
  const uint8_t* k;       // (bh_kv, n_kv, d) int8 / e4m3 / e5m2
  const uint8_t* v;       // (bh_kv, n_kv, d)
  const float* sk_token;  // (bh_kv, n_kv) per-token K scales, or null
  const float* sk_tensor; // (bh_kv) K scale folded into the Q staging, or null
  const float* sv;        // (bh_kv, d) per-channel V scales
  const float* gk;        // (bh_kv) max_j ‖k̂_j‖·σk_j (norm bound), or null
  void* o;                // (bh, n_q, d) f32 or bf16
  float* lse;             // (bh, n_q) or null
  void* q_out;            // (bh, n_q, d) staged Q operand, or null
  float* qs_out;          // (bh, n_q) staged q̂ row scales, or null
  int n_q, n_kv, hq, hkv, causal, offset;
  int q_mode, q_f32, kv_dtype, o_f32;
  float c;  // staging: float32(scale·log2e); mode 4: float32(log2e)
};

template <int HD, bool QI8, bool PVQ> struct Smem {
  static constexpr int LDQ = HD + 8;   // bf16 rows of Q, K, V
  static constexpr int LDS = BKV + 4;  // float / int32 scores
  static constexpr int LDP = BKV + 8;  // bf16 P
  static constexpr int LDO = HD + 4;   // float accumulator
  static constexpr size_t q_bytes = QI8 ? BQ * HD : sizeof(bf16) * BQ * LDQ;
  static constexpr size_t k_bytes = QI8 ? BKV * HD : sizeof(bf16) * BKV * LDQ;
  static constexpr size_t v_bytes = PVQ ? BKV * HD : sizeof(bf16) * BKV * LDQ;
  static constexpr size_t p_bytes = PVQ ? BQ * BKV : sizeof(bf16) * BQ * LDP;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + q_bytes;
  static constexpr size_t v_off = k_off + k_bytes;
  static constexpr size_t s_off = v_off + v_bytes;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + p_bytes;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t qs_off = l_off + sizeof(float) * BQ;
  static constexpr size_t sk_off = qs_off + sizeof(float) * BQ;
  static constexpr size_t bytes = sk_off + sizeof(float) * BKV;
  static_assert(k_off % 32 == 0 && v_off % 32 == 0 && s_off % 32 == 0 &&
                    p_off % 32 == 0 && o_off % 32 == 0,
                "WMMA tiles need 256-bit aligned bases");
  static_assert(bytes <= 227 * 1024, "above the 227 KB a block may use");
};

// index of (row, col) in a k-chunked int8 tile of `rows` rows
__device__ __forceinline__ int chunked(int row, int col, int rows) {
  return ((col >> 4) * rows + row) * 16 + (col & 15);
}

__device__ __forceinline__ float fp8_to_float(uint8_t b, int kv_dtype) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      (__nv_fp8_storage_t)b, kv_dtype == KV_E4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half2float(__half(h));
}

// exact decode of one cache byte (every int8 / e4m3 / e5m2 value is a bf16)
__device__ __forceinline__ bf16 decode(uint8_t b, int kv_dtype) {
  if (kv_dtype == KV_INT8) return __float2bfloat16_rn((float)(int8_t)b);
  return __float2bfloat16_rn(fp8_to_float(b, kv_dtype));
}

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + BKV) of a (n, HD) byte matrix into shared memory, zero
// past n: kept as int8 in the k-chunked layout (RAW8), else decoded to bf16
// rows of pitch HD + 8.
template <int HD, bool RAW8>
__device__ void load_kv(void* dst, const uint8_t* src, int row0, int n, int kv_dtype) {
  constexpr int CH = HD / 16;  // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < BKV * CH; idx += NTHREADS) {
    // RAW8: neighbouring threads take neighbouring rows, so their 16-byte
    // stores into the chunked tile are contiguous
    const int r = RAW8 ? idx % BKV : idx / CH;
    const int c = (RAW8 ? idx / BKV : idx % CH) * 16;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    if constexpr (RAW8) {
      *reinterpret_cast<uint4*>(static_cast<uint8_t*>(dst) + chunked(r, c, BKV)) = raw;
    } else {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      __align__(16) bf16 out[16];
      for (int i = 0; i < 16; ++i) out[i] = decode(b[i], kv_dtype);
      bf16* d = static_cast<bf16*>(dst) + r * (HD + 8) + c;
      reinterpret_cast<uint4*>(d)[0] = reinterpret_cast<const uint4*>(out)[0];
      reinterpret_cast<uint4*>(d)[1] = reinterpret_cast<const uint4*>(out)[1];
    }
  }
}

__device__ __forceinline__ float load_q(const Params& p, size_t row, int col, int hd) {
  if (p.q_f32) return static_cast<const float*>(p.q)[row * hd + col];
  return __bfloat162float(static_cast<const bf16*>(p.q)[row * hd + col]);
}

// Q tile of bh row b into shared memory as the score operand (bf16 rows or
// chunked int8) plus, for int8, its row scales.
template <int HD, bool QI8>
__device__ void stage_q(const Params& p, uint8_t* qbuf, float* qs, int b, int q0,
                        int kv_row, int warp, int lane) {
  constexpr int LDQ = HD + 8;
  if (p.q_mode == Q_LOAD_BF16 || p.q_mode == Q_LOAD_INT8) {
    constexpr int ESZ = QI8 ? 1 : 2;
    constexpr int CH = HD * ESZ / 16;
    const uint8_t* src = static_cast<const uint8_t*>(p.q) + (size_t)b * p.n_q * HD * ESZ;
    for (int idx = threadIdx.x; idx < BQ * CH; idx += NTHREADS) {
      const int r = QI8 ? idx % BQ : idx / CH;
      const int c = (QI8 ? idx / BQ : idx % CH) * 16;  // bytes
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (q0 + r < p.n_q)
        raw = *reinterpret_cast<const uint4*>(src + (size_t)(q0 + r) * HD * ESZ + c);
      uint8_t* d = QI8 ? qbuf + chunked(r, c, BQ) : qbuf + (r * LDQ) * 2 + c;
      *reinterpret_cast<uint4*>(d) = raw;
    }
    if constexpr (QI8)
      for (int r = threadIdx.x; r < BQ; r += NTHREADS)
        qs[r] = q0 + r < p.n_q ? p.sq[(size_t)b * p.n_q + q0 + r] * p.c : 0.0f;
    return;
  }
  const float skf = p.sk_tensor != nullptr ? p.sk_tensor[kv_row] : 1.0f;
  bf16* qb = reinterpret_cast<bf16*>(qbuf);
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qpos = q0 + r;
    const size_t row = (size_t)b * p.n_q + qpos;
    float x[HD / 32];
    float amax = 0.0f;
    for (int i = 0; i < HD / 32; ++i) {
      x[i] = qpos < p.n_q ? load_q(p, row, lane + 32 * i, HD) : 0.0f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    if constexpr (QI8) {  // Q_INT8
      const float sq = fmaxf(warp_max(amax), 1e-12f) / 127.0f;
      for (int i = 0; i < HD / 32; ++i) {
        const float v = fminf(fmaxf(rintf(x[i] / sq), -127.0f), 127.0f);
        qbuf[chunked(r, lane + 32 * i, BQ)] = (uint8_t)(int8_t)v;
      }
      if (lane == 0) qs[r] = (sq * p.c) * skf;
    } else if (p.q_mode == Q_FP8) {
      const float sq = fmaxf(warp_max(amax), 1e-12f) / 448.0f;
      const float f = (sq * p.c) * skf;
      for (int i = 0; i < HD / 32; ++i) {
        const __nv_fp8_storage_t q8 =
            __nv_cvt_float_to_fp8(x[i] / sq, __NV_SATFINITE, __NV_E4M3);
        qb[r * LDQ + lane + 32 * i] = __float2bfloat16_rn(fp8_to_float(q8, KV_E4M3) * f);
      }
    } else {  // Q_RAW: weight-only
      const float f = p.c * skf;
      for (int i = 0; i < HD / 32; ++i)
        qb[r * LDQ + lane + 32 * i] = __float2bfloat16_rn(x[i] * f);
    }
  }
}

template <int HD, bool QI8, bool PVQ>
__global__ void __launch_bounds__(NTHREADS) quant_attention_kernel(const Params p) {
  using S = Smem<HD, QI8, PVQ>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* qbuf = smem + S::q_off;
  uint8_t* kbuf = smem + S::k_off;
  uint8_t* vbuf = smem + S::v_off;
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  int* si = reinterpret_cast<int*>(smem + S::s_off);
  uint8_t* pbuf = smem + S::p_off;
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* ms = reinterpret_cast<float*>(smem + S::m_off);
  float* ls = reinterpret_cast<float*>(smem + S::l_off);
  float* qs = reinterpret_cast<float*>(smem + S::qs_off);
  float* skt = reinterpret_cast<float*>(smem + S::sk_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int kv_row = (b / p.hq) * p.hkv + (b % p.hq) / (p.hq / p.hkv);
  const uint8_t* kb = p.k + (size_t)kv_row * p.n_kv * HD;
  const uint8_t* vb = p.v + (size_t)kv_row * p.n_kv * HD;

  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = MASK;
    ls[i] = 0.0f;
  }
  stage_q<HD, QI8>(p, qbuf, qs, b, q0, kv_row, warp, lane);
  __syncthreads();

  const bf16* qb = reinterpret_cast<const bf16*>(qbuf);
  const int8_t* q8 = reinterpret_cast<const int8_t*>(qbuf);
  if (p.gk != nullptr) {  // constant bound: m = ‖q‖·(gk·1.0001), set once
    const float gk1 = p.gk[kv_row] * 1.0001f;
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float acc = 0.0f;
      for (int c = lane; c < HD; c += 32) {
        const float x = QI8 ? (float)q8[chunked(r, c, BQ)]
                            : __bfloat162float(qb[r * S::LDQ + c]);
        acc += x * x;
      }
      float qn = sqrtf(warp_sum(acc));
      if (QI8) qn = qn * qs[r];
      if (lane == 0) ms[r] = qn * gk1;
    }
  }
  if (p.q_out != nullptr) {  // the staged operand, for checking the staging
    for (int idx = threadIdx.x; idx < BQ * HD; idx += NTHREADS) {
      const int r = idx / HD, c = idx % HD;
      if (q0 + r >= p.n_q) continue;
      const size_t at = ((size_t)b * p.n_q + q0 + r) * HD + c;
      if (QI8) {
        static_cast<int8_t*>(p.q_out)[at] = q8[chunked(r, c, BQ)];
        if (c == 0 && p.qs_out != nullptr) p.qs_out[(size_t)b * p.n_q + q0 + r] = qs[r];
      } else {
        static_cast<bf16*>(p.q_out)[at] = qb[r * S::LDQ + c];
      }
    }
  }

  int steps = (p.n_kv + BKV - 1) / BKV;
  if (p.causal) {
    const int last_k = min(q0 + BQ - 1, p.n_q - 1) + p.offset;
    steps = last_k < 0 ? 0 : min(steps, last_k / BKV + 1);
  }
  const bool bound = p.gk != nullptr;

  for (int s = 0; s < steps; ++s) {
    const int k0 = s * BKV;
    __syncthreads();  // previous step done with the K/V tiles
    load_kv<HD, QI8>(kbuf, kb, k0, p.n_kv, p.kv_dtype);
    load_kv<HD, PVQ>(vbuf, vb, k0, p.n_kv, p.kv_dtype);
    if (p.sk_token != nullptr)
      for (int i = threadIdx.x; i < BKV; i += NTHREADS)
        skt[i] = k0 + i < p.n_kv ? p.sk_token[(size_t)kv_row * p.n_kv + k0 + i] : 0.0f;
    __syncthreads();

    // S[16 rows of this warp][BKV] = Q·Kᵀ
    if constexpr (QI8) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[BKV / 16];
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(acc[j], 0);
      for (int kc = 0; kc < HD / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::load_matrix_sync(
            a, reinterpret_cast<const signed char*>(qbuf) + (kc * BQ + warp * 16) * 16, 16);
        for (int j = 0; j < BKV / 16; ++j) {
          // K̂ᵀ as a column-major B: (k, key) at chunk base + key·16 + k
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bm;
          wmma::load_matrix_sync(
              bm, reinterpret_cast<const signed char*>(kbuf) + (kc * BKV + j * 16) * 16, 16);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
      }
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(si + warp * 16 * S::LDS + j * 16, acc[j], S::LDS,
                                wmma::mem_row_major);
    } else {
      const bf16* kt = reinterpret_cast<const bf16*>(kbuf);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKV / 16];
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qb + warp * 16 * S::LDQ + kk, S::LDQ);
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(bm, kt + j * 16 * S::LDQ + kk, S::LDQ);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
      }
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(ss + warp * 16 * S::LDS + j * 16, acc[j], S::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int qpos = q0 + r;
      float sv[BKV / 32];
      float mx = MASK;
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j, kpos = k0 + c;
        float x = QI8 ? (float)si[r * S::LDS + c] * qs[r] : ss[r * S::LDS + c];
        if (p.sk_token != nullptr) x = x * skt[c];
        const bool seen = kpos < p.n_kv && (!p.causal || kpos <= qpos + p.offset);
        sv[j] = seen ? x : MASK;
        mx = fmaxf(mx, sv[j]);
      }
      const float m_prev = ms[r];
      const float m_next = bound ? m_prev : fmaxf(m_prev, warp_max(mx));
      const float alpha = bound ? 1.0f : exp2f(m_prev - m_next);
      float psum = 0.0f;
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        const float pr = exp2f(sv[j] - m_next);
        psum += pr;
        if constexpr (PVQ)
          pbuf[chunked(r, c, BQ)] =
              (uint8_t)(int8_t)fminf(fmaxf(rintf(pr * 127.0f), 0.0f), 127.0f);
        else
          reinterpret_cast<bf16*>(pbuf)[r * S::LDP + c] = __float2bfloat16_rn(pr);
      }
      psum = warp_sum(psum);
      if (!bound)
        for (int c = lane; c < HD; c += 32) os[r * S::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_next;
        ls[r] = bound ? ls[r] + psum : alpha * ls[r] + psum;
      }
    }
    __syncwarp();

    // O[16 rows of this warp][HD] += P·V (O already rescaled by alpha)
    if constexpr (PVQ) {
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
        wmma::fill_fragment(acc, 0);
        for (int kc = 0; kc < BKV / 16; ++kc) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bm;
          wmma::load_matrix_sync(
              a, reinterpret_cast<const signed char*>(pbuf) + (kc * BQ + warp * 16) * 16, 16);
          // V̂ chunked by channel: (key, ch) at chunk j base + key·16 + ch
          wmma::load_matrix_sync(
              bm, reinterpret_cast<const signed char*>(vbuf) + (j * BKV + kc * 16) * 16, 16);
          wmma::mma_sync(acc, a, bm, acc);
        }
        // the warp's scores are spent: its rows of S hold the int32 tile
        wmma::store_matrix_sync(si + warp * 16 * S::LDS, acc, S::LDS, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = warp * 16 + e / 16, c = e % 16;
          os[r * S::LDO + j * 16 + c] += (float)si[r * S::LDS + c] * INV127;
        }
        __syncwarp();
      }
    } else {
      const bf16* pt = reinterpret_cast<const bf16*>(pbuf);
      const bf16* vt = reinterpret_cast<const bf16*>(vbuf);
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* optr = os + warp * 16 * S::LDO + j * 16;
        wmma::load_matrix_sync(acc, optr, S::LDO, wmma::mem_row_major);
        for (int kk = 0; kk < BKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, pt + warp * 16 * S::LDP + kk, S::LDP);
          wmma::load_matrix_sync(bm, vt + kk * S::LDQ + j * 16, S::LDQ);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(optr, acc, S::LDO, wmma::mem_row_major);
      }
    }
    __syncwarp();
  }

  __syncwarp();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= p.n_q) break;
    const float l = ls[r], m = ms[r];
    const bool valid = l > 0.0f && m > MASK * 0.5f;
    const float l_inv = valid ? 1.0f / l : 0.0f;
    const size_t row = (size_t)b * p.n_q + qpos;
    for (int c = lane; c < HD; c += 32) {
      const float x = (os[r * S::LDO + c] * l_inv) * p.sv[(size_t)kv_row * HD + c];
      if (p.o_f32)
        static_cast<float*>(p.o)[row * HD + c] = x;
      else
        static_cast<bf16*>(p.o)[row * HD + c] = __float2bfloat16_rn(x);
    }
    if (p.lse != nullptr && lane == 0)
      p.lse[row] = valid ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
  }
}

template <int HD, bool QI8, bool PVQ>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  auto kern = quant_attention_kernel<HD, QI8, PVQ>;
  const size_t smem = Smem<HD, QI8, PVQ>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n_q + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_d(const Params& p, int bh, bool qi8, bool pvq, cudaStream_t stream) {
  if (qi8) return pvq ? launch<HD, true, true>(p, bh, stream) : launch<HD, true, false>(p, bh, stream);
  return pvq ? launch<HD, false, true>(p, bh, stream) : launch<HD, false, false>(p, bh, stream);
}

cudaError_t dispatch(const Params& p, int bh, int d, int pv_quant, cudaStream_t stream) {
  if (bh <= 0 || p.n_q <= 0) return cudaSuccess;
  if (p.hkv <= 0 || p.hq % p.hkv != 0 || p.n_kv <= 0) return cudaErrorInvalidValue;
  if (p.kv_dtype < KV_INT8 || p.kv_dtype > KV_E5M2) return cudaErrorInvalidValue;
  const bool qi8 = p.q_mode == Q_INT8 || p.q_mode == Q_LOAD_INT8;
  // int8 products need an int8 cache on both sides
  if ((qi8 || pv_quant) && p.kv_dtype != KV_INT8) return cudaErrorInvalidValue;
  if (d == 128) return dispatch_d<128>(p, bh, qi8, pv_quant != 0, stream);
  if (d == 64) return dispatch_d<64>(p, bh, qi8, pv_quant != 0, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// B6/B8. q: (bh, n_q, d) float32 (q_f32 = 1) or bf16, unscaled; k, v:
// (bh / hq · hkv, n_kv, d) int8 / e4m3 / e5m2 (kv_dtype 0 / 1 / 2);
// sk_token (bh_kv, n_kv) or sk_tensor (bh_kv), one of them null; sv
// (bh_kv, d); gk (bh_kv) or null for the exact running max; o like q; lse
// (bh, n_q) or null; q_out/qs_out null or (bh, n_q, d) / (bh, n_q) for the
// staged operand. q_mode 0 weight-only, 1 fp8 (e4m3 Q), 2 int8 Q. c is
// float32(scale·log2e). All contiguous, 16-byte aligned; d ∈ {64, 128}.
extern "C" cudaError_t tf_serving_attention(
    const void* q, const void* k, const void* v, const float* sk_token,
    const float* sk_tensor, const float* sv, const float* gk, void* o, float* lse,
    void* q_out, float* qs_out, int bh, int n_q, int n_kv, int hq, int hkv, int d,
    int causal, int offset, int q_mode, int q_f32, int kv_dtype, int pv_quant,
    float c, cudaStream_t stream) {
  if (q_mode < Q_RAW || q_mode > Q_INT8) return cudaErrorInvalidValue;
  const Params p{q, nullptr, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
                 sk_token, sk_tensor, sv, gk, o, lse, q_out, qs_out,
                 n_q, n_kv, hq, hkv, causal, offset, q_mode, q_f32, kv_dtype, q_f32, c};
  return dispatch(p, bh, d, pv_quant, stream);
}

// B7. q: (bh, n_q, d) int8 q̂ with sq (bh, n_q) its scales (q_int8 = 1, c =
// float32(log2e)), or the bf16 score operand (q_int8 = 0, sq null); k, v,
// sk_token (or null), sv, gk, lse as above; o (bh, n_q, d) float32
// (o_f32 = 1) or bf16.
extern "C" cudaError_t tf_quant_attention(
    const void* q, const float* sq, const void* k, const void* v,
    const float* sk_token, const float* sv, const float* gk, void* o, float* lse,
    int bh, int n_q, int n_kv, int hq, int hkv, int d, int causal, int offset,
    int q_int8, int kv_dtype, int o_f32, float c, cudaStream_t stream) {
  const Params p{q, sq, static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
                 sk_token, nullptr, sv, gk, o, lse, nullptr, nullptr,
                 n_q, n_kv, hq, hkv, causal, offset,
                 q_int8 ? Q_LOAD_INT8 : Q_LOAD_BF16, 0, kv_dtype, o_f32, c};
  return dispatch(p, bh, d, 0, stream);
}
