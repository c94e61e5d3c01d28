// B1: fused attention forward (FA-2 style) for Hopper, sm_90a.
//
// Replaces tpu_flash/ops/flash.py:_fwd_kernel (launched by _flash_fwd), the
// TPU kernel behind prefill: for each (batch·head row, q block) an online
// base-2 softmax over the visited kv blocks, GQA through the kv-row map
// (b // hq)·hkv + (b % hq) // g, the exact running max, o = 0 and
// lse = -inf for fully masked rows, lse in natural-log units.
//
// Numerics mirror the reference: q arrives prescaled by scale·log2(e) in
// float32 and cast back to its dtype (the wrapper does it); S = Q·Kᵀ
// accumulates in float32; the update is exp2; P is cast to V's dtype before
// P·V; masked scores take DEFAULT_MASK_VALUE (-0.7·FLT_MAX), not -inf; the
// finish is o = acc·(1/l), lse = m·ln2 + log(l), and a row is valid only
// when l > 0 and m > DEFAULT_MASK_VALUE/2.
//
// What bounds it on an H100: at the serving prefill (n = 1024, d = 128,
// 16 q heads) it is tensor-core FLOPs, 4·n²·d/2·heads ≈ 4.3 GFLOP causal
// against ~33 MB of q/k/v/o traffic, far right of the ~295 FLOP/B ridge.
// Design: one block of 4 warps per (64-row q tile, bh row); a loop inside
// the block walks the kv tiles up to the causal limit (the TPU's sequential
// grid axis). Q, K, V tiles sit in shared memory; bf16 Q·Kᵀ and P·V run on
// the tensor cores through WMMA 16×16×16 with float32 accumulators. Each
// warp owns 16 q rows end to end (scores, softmax, accumulator), so the
// softmax needs no block-wide barrier; the float32 accumulator lives in
// shared memory so the per-row rescale is plain indexing. float32 inputs
// take the same structure with FMA loops (no tensor cores: the reference's
// f32 dots are full precision). wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per step
constexpr int NWARPS = 4;     // each warp owns 16 q rows
constexpr int NTHREADS = NWARPS * 32;
// DEFAULT_MASK_VALUE = -0.7 * float32 max, rounded to float32.
constexpr float MASK = -0x1.666664p+127f;
constexpr float LN2 = 0.693147180559945309f;

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static constexpr int PAD = 8;  // keeps rows 16 B aligned, shifts banks
  static __device__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Ty<float> {
  static constexpr int PAD = 4;
  static __device__ float t(float x) { return x; }
};

template <typename T, int HD> struct Smem {
  static constexpr int LDQ = HD + Ty<T>::PAD;  // Q, K, V rows
  static constexpr int LDS = BKV + 4;          // float scores
  static constexpr int LDP = BKV + Ty<T>::PAD; // P in V's dtype
  static constexpr int LDO = HD + 4;           // float accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(T) * BKV * LDQ;
  static constexpr size_t s_off = v_off + sizeof(T) * BKV * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(T) * BQ * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
  static_assert(k_off % 32 == 0 && v_off % 32 == 0 && s_off % 32 == 0 &&
                    p_off % 32 == 0 && o_off % 32 == 0,
                "WMMA tiles need 256-bit aligned bases");
};

// rows [row0, row0 + rows) of a (n, HD) matrix into shared memory (pitch
// ld), zero past n; 16-byte vector copies.
template <typename T, int HD>
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

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// S[16 rows of this warp][BKV] = Q·Kᵀ, float32 accumulation.
template <typename T, int HD>
__device__ void scores(const T* qs, const T* ks, float* ss, int warp, int lane) {
  using S = Smem<T, HD>;
  if constexpr (sizeof(T) == 2) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKV / 16];
    for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + warp * 16 * S::LDQ + kk, S::LDQ);
      for (int j = 0; j < BKV / 16; ++j) {
        // Kᵀ as a column-major B: element (k, n) at ks[n·LDQ + k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ks + j * 16 * S::LDQ + kk, S::LDQ);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    for (int j = 0; j < BKV / 16; ++j)
      wmma::store_matrix_sync(ss + warp * 16 * S::LDS + j * 16, acc[j], S::LDS,
                              wmma::mem_row_major);
  } else {
    for (int r = 0; r < 16; ++r) {
      const T* qr = qs + (warp * 16 + r) * S::LDQ;
      for (int c = lane; c < BKV; c += 32) {
        const T* kr = ks + c * S::LDQ;
        float acc = 0.0f;
        for (int k = 0; k < HD; ++k) acc = fmaf(qr[k], kr[k], acc);
        ss[(warp * 16 + r) * S::LDS + c] = acc;
      }
    }
  }
}

// O[16 rows of this warp][HD] += P·V (O already rescaled by alpha).
template <typename T, int HD>
__device__ void accumulate_pv(const T* ps, const T* vs, float* os, int warp,
                              int lane) {
  using S = Smem<T, HD>;
  if constexpr (sizeof(T) == 2) {
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = os + warp * 16 * S::LDO + j * 16;
      wmma::load_matrix_sync(acc, optr, S::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + warp * 16 * S::LDP + kk, S::LDP);
        wmma::load_matrix_sync(b, vs + kk * S::LDQ + j * 16, S::LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(optr, acc, S::LDO, wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const T* pr = ps + (warp * 16 + r) * S::LDP;
      float* orow = os + (warp * 16 + r) * S::LDO;
      for (int c = lane; c < HD; c += 32) {
        float acc = orow[c];
        for (int k = 0; k < BKV; ++k) acc = fmaf(pr[k], vs[k * S::LDQ + c], acc);
        orow[c] = acc;
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_q, int n_kv, int hq, int hkv,
                 int causal, int offset) {
  using S = Smem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + S::q_off);
  T* ks = reinterpret_cast<T*>(smem + S::k_off);
  T* vs = reinterpret_cast<T*>(smem + S::v_off);
  float* ss = reinterpret_cast<float*>(smem + S::s_off);
  T* ps = reinterpret_cast<T*>(smem + S::p_off);
  float* os = reinterpret_cast<float*>(smem + S::o_off);
  float* ms = reinterpret_cast<float*>(smem + S::m_off);
  float* ls = reinterpret_cast<float*>(smem + S::l_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int kv_row = (b / hq) * hkv + (b % hq) / (hq / hkv);
  const T* qb = q + (size_t)b * n_q * HD;
  const T* kb = k + (size_t)kv_row * n_kv * HD;
  const T* vb = v + (size_t)kv_row * n_kv * HD;

  load_tile<T, HD>(qs, S::LDQ, qb, q0, n_q, BQ);
  for (int i = threadIdx.x; i < BQ * S::LDO; i += NTHREADS) os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = MASK;
    ls[i] = 0.0f;
  }

  // kv tiles to visit: all of them, or up to the last key visible to the
  // tile's last real query (CausalSchedule._last_step, right-aligned).
  int steps = (n_kv + BKV - 1) / BKV;
  if (causal) {
    int last_q = min(q0 + BQ - 1, n_q - 1);
    int last_k = last_q + offset;
    steps = last_k < 0 ? 0 : min(steps, last_k / BKV + 1);
  }

  for (int s = 0; s < steps; ++s) {
    const int k0 = s * BKV;
    __syncthreads();  // previous step done with ks/vs (and init visible)
    load_tile<T, HD>(ks, S::LDQ, kb, k0, n_kv, BKV);
    load_tile<T, HD>(vs, S::LDQ, vb, k0, n_kv, BKV);
    __syncthreads();
    scores<T, HD>(qs, ks, ss, warp, lane);
    __syncwarp();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int qpos = q0 + r;
      float sv[BKV / 32];
      float mx = MASK;
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j, kpos = k0 + c;
        const bool seen = kpos < n_kv && (!causal || kpos <= qpos + offset);
        sv[j] = seen ? ss[r * S::LDS + c] : MASK;
        mx = fmaxf(mx, sv[j]);
      }
      const float m_prev = ms[r];
      const float m_next = fmaxf(m_prev, warp_max(mx));
      const float alpha = exp2f(m_prev - m_next);
      float psum = 0.0f;
      for (int j = 0; j < BKV / 32; ++j) {
        const float p = exp2f(sv[j] - m_next);
        psum += p;
        ps[r * S::LDP + lane + 32 * j] = Ty<T>::t(p);
      }
      psum = warp_sum(psum);
      for (int c = lane; c < HD; c += 32) os[r * S::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_next;
        ls[r] = alpha * ls[r] + psum;
      }
    }
    __syncwarp();
    accumulate_pv<T, HD>(ps, vs, os, warp, lane);
    __syncwarp();
  }

  __syncwarp();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= n_q) break;
    const float l = ls[r], m = ms[r];
    const bool valid = l > 0.0f && m > MASK * 0.5f;
    const float l_inv = valid ? 1.0f / l : 0.0f;
    T* orow = o + ((size_t)b * n_q + qpos) * HD;
    for (int c = lane; c < HD; c += 32) orow[c] = Ty<T>::t(os[r * S::LDO + c] * l_inv);
    if (lse != nullptr && lane == 0)
      lse[(size_t)b * n_q + qpos] = valid ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int n_q, int n_kv, int hq, int hkv,
                   int causal, int offset, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = Smem<T, HD>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_q + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, n_q, n_kv, hq, hkv, causal, offset);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, n_q, d) prescaled; k, v: (bh / hq · hkv, n_kv, d); o like q;
// lse: (bh, n_q) float32 or null. All contiguous, 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. d ∈ {64, 128}.
extern "C" cudaError_t tf_flash_fwd(const void* q, const void* k, const void* v,
                                    void* o, float* lse, int bh, int n_q,
                                    int n_kv, int hq, int hkv, int d, int causal,
                                    int offset, int dtype, cudaStream_t stream) {
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, n_q, n_kv, hq, hkv, causal, offset, stream);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, n_q, n_kv, hq, hkv, causal, offset, stream);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, n_q, n_kv, hq, hkv, causal, offset, stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, lse, bh, n_q, n_kv, hq, hkv, causal, offset, stream);
  return cudaErrorInvalidValue;
}
