// B1: fused attention forward (FA-2 style) for Hopper, sm_90a.
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
// _last_block); 5 block-diagonal, i / section == j / section. A q tile walks
// the kv tiles from max(0, q0 - radius) / BKV to min(last tile, (q_last +
// radius) / BKV) under the local kinds, stopping at q_last / BKV under
// local_causal (and at (q_last + offset) / BKV under causal); from q0 / BKV
// to (q_last + 2·radius) / BKV under the circulant; over the sections its
// rows fall in under the block-diagonal (tiles of other sections are never
// visited: the block skip, where a section that is not a multiple of 64 or a
// tile spanning two sections masks per element). A tile wholly inside the
// visible region skips the per-element mask, as the reference's
// block_unmasked does.
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
// P·V; masked scores take DEFAULT_MASK_VALUE (-0.7·FLT_MAX), not -inf; the
// finish is o = acc·(1/l), lse = m·ln2 + log(l), and a row is valid only
// when l > 0 and m > DEFAULT_MASK_VALUE/2.
//
// What bounds it on an H100: at the serving prefill (n = 1024, d = 128,
// 16 q heads) it is tensor-core FLOPs, 4·n²·d/2·heads ≈ 4.3 GFLOP causal
// against ~33 MB of q/k/v/o traffic, far right of the ~295 FLOP/B ridge;
// a band of radius 512 at n 2048 keeps about half of the causal work; the
// circulant (n 8192, w 1025) and block-diagonal (section 512) kinds visit
// about (2r + 64)/64 and section/64 kv tiles a q tile, the same loop.
// Design: one block of 4 warps per (64-row q tile, bh row); a loop inside
// the block walks the kv tiles of its range (the TPU's sequential grid
// axis). Q, K, V tiles sit in shared memory; bf16 Q·Kᵀ and P·V run on
// the tensor cores through WMMA 16×16×16 with float32 accumulators. Each
// warp owns 16 q rows end to end (scores, softmax, accumulator), so the
// softmax needs no block-wide barrier; the float32 accumulator lives in
// shared memory so the per-row rescale is plain indexing. float32 inputs
// take the same structure with FMA loops (no tensor cores: the reference's
// f32 dots are full precision). Head widths 64, 128 and 256 are compiled; at
// d 256 the bf16 tiles take 195 KB of shared memory and float32 takes a
// 32-row q tile of 2 warps (217 KB), since its 64-row tiles would need
// 301 KB. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BKV = 64;       // kv rows per step
// DEFAULT_MASK_VALUE = -0.7 * float32 max, rounded to float32.
constexpr float MASK = -0x1.666664p+127f;
constexpr float LN2 = 0.693147180559945309f;
constexpr float BOUND_SLACK = 1.0001f;  // the reference's factor
enum Kind { DENSE = 0, CAUSAL = 1, LOCAL = 2, LOCAL_CAUSAL = 3, CIRCULANT = 4,
            BLOCK = 5 };

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static constexpr int PAD = 8;  // keeps rows 16 B aligned, shifts banks
  static __device__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
  static __device__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
};
template <> struct Ty<float> {
  static constexpr int PAD = 4;
  static __device__ float t(float x) { return x; }
  static __device__ float f(float x) { return x; }
};

// q rows per block: 64 (4 warps, each owning 16 q rows), or 32 (2 warps)
// for float32 at d 256, whose 64-row tiles would not fit in 227 KB.
template <typename T, int HD> struct Cfg {
  static constexpr int BQ = (sizeof(T) == 4 && HD == 256) ? 32 : 64;
  static constexpr int NTHREADS = BQ / 16 * 32;
};

template <typename T, int HD> struct Smem {
  static constexpr int BQ = Cfg<T, HD>::BQ;
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
  static_assert(bytes <= 232448, "above the 227 KB a block may use");
};

// rows [row0, row0 + rows) of a (n, HD) matrix into shared memory (pitch
// ld), zero past n; 16-byte vector copies.
template <typename T, int HD>
__device__ void load_tile(T* dst, int ld, const T* src, int row0, int n,
                          int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = HD / VEC;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += Cfg<T, HD>::NTHREADS) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// key kpos visible to query qpos under the schedule
__device__ bool visible(int kind, int qpos, int kpos, int n_kv, int offset,
                        int radius, int section) {
  if (kpos >= n_kv) return false;
  if (kind == CAUSAL) return kpos <= qpos + offset;
  if (kind == CIRCULANT) return kpos >= qpos && kpos - qpos <= 2 * radius;
  if (kind == BLOCK) return kpos / section == qpos / section;
  if (kind == LOCAL || kind == LOCAL_CAUSAL) {
    const int dist = qpos - kpos;
    if (dist > radius || -dist > radius) return false;
    if (kind == LOCAL_CAUSAL) return kpos <= qpos;
  }
  return true;
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
__global__ void __launch_bounds__(Cfg<T, HD>::NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ kmax,
                 int n_q, int n_kv, int hq, int hkv, int kind, int offset,
                 int radius, int section) {
  using S = Smem<T, HD>;
  constexpr int BQ = Cfg<T, HD>::BQ, NTHREADS = Cfg<T, HD>::NTHREADS;
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
  const int q_last = min(q0 + BQ - 1, n_q - 1);
  const int b = blockIdx.y;
  const int kv_row = (b / hq) * hkv + (b % hq) / (hq / hkv);
  const T* qb = q + (size_t)b * n_q * HD;
  const T* kb = k + (size_t)kv_row * n_kv * HD;
  const T* vb = v + (size_t)kv_row * n_kv * HD;
  const bool bound = kmax != nullptr;

  load_tile<T, HD>(qs, S::LDQ, qb, q0, n_q, BQ);
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
      for (int c = lane; c < HD; c += 32) {
        const float x = Ty<T>::f(qs[r * S::LDQ + c]);
        sq = fmaf(x, x, sq);
      }
      sq = warp_sum(sq);
      if (lane == 0) ms[r] = sqrtf(sq) * kbound;
    }
  }

  // kv tiles [first, last] of this q tile (inclusive; last < first: none)
  int first = 0, last = (n_kv + BKV - 1) / BKV - 1;
  if (kind == CAUSAL) {
    const int last_k = q_last + offset;
    last = last_k < 0 ? -1 : min(last, last_k / BKV);
  } else if (kind == LOCAL || kind == LOCAL_CAUSAL) {
    first = max(0, q0 - radius) / BKV;
    last = min(last, (q_last + radius) / BKV);
    if (kind == LOCAL_CAUSAL) last = min(last, q_last / BKV);
  } else if (kind == CIRCULANT) {
    first = q0 / BKV;
    last = min(last, (q_last + 2 * radius) / BKV);
  } else if (kind == BLOCK) {
    first = (q0 / section) * section / BKV;
    last = min(last, ((q_last / section + 1) * section - 1) / BKV);
  }

  for (int s = first; s <= last; ++s) {
    const int k0 = s * BKV, k_hi = k0 + BKV - 1;
    // tile wholly visible to every real query row: no per-element mask
    bool full = k_hi < n_kv;
    if (kind == CAUSAL) {
      full = full && k_hi <= q0 + offset;
    } else if (kind == LOCAL || kind == LOCAL_CAUSAL) {
      full = full && k_hi - q0 <= radius && q_last - k0 <= radius;
      if (kind == LOCAL_CAUSAL) full = full && k_hi <= q0;
    } else if (kind == CIRCULANT) {
      full = full && k0 >= q_last && k_hi - q0 <= 2 * radius;
    } else if (kind == BLOCK) {
      const int sec = q0 / section;
      full = full && q_last / section == sec && k0 / section == sec &&
             k_hi / section == sec;
    }
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
        const int c = lane + 32 * j;
        const bool seen =
            full || visible(kind, qpos, k0 + c, n_kv, offset, radius, section);
        sv[j] = seen ? ss[r * S::LDS + c] : MASK;
        mx = fmaxf(mx, sv[j]);
      }
      const float m_prev = ms[r];
      // the norm bound is constant: no max pass, alpha = 1, no rescale
      const float m_next = bound ? m_prev : fmaxf(m_prev, warp_max(mx));
      const float alpha = bound ? 1.0f : exp2f(m_prev - m_next);
      float psum = 0.0f;
      for (int j = 0; j < BKV / 32; ++j) {
        const float p = exp2f(sv[j] - m_next);
        psum += p;
        ps[r * S::LDP + lane + 32 * j] = Ty<T>::t(p);
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
    accumulate_pv<T, HD>(ps, vs, os, warp, lane);
    __syncwarp();
  }

  __syncthreads();  // init visible to every warp also when no tile ran
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
                   float* lse, const float* kmax, int bh, int n_q, int n_kv,
                   int hq, int hkv, int kind, int offset, int radius,
                   int section, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = Smem<T, HD>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_q + Cfg<T, HD>::BQ - 1) / Cfg<T, HD>::BQ, bh);
  kern<<<grid, Cfg<T, HD>::NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, kmax, n_q, n_kv, hq, hkv, kind, offset, radius,
      section);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, n_q, d) prescaled; k, v: (bh / hq · hkv, n_kv, d); o like q;
// lse: (bh, n_q) float32 or null; kmax: (bh / hq · hkv,) float32 max key
// norm per kv row for the norm-bound max, or null for the exact max. All
// contiguous, 16-byte aligned. kind: 0 dense, 1 causal (offset), 2 local,
// 3 local_causal (radius), 4 circulant (radius; k, v halo-extended, n_kv =
// n + 2·radius), 5 block-diagonal (section). dtype: 0 = float32,
// 1 = bfloat16. d ∈ {64, 128, 256} (the wrapper zero-pads other head and
// value dims up to the next of these).
extern "C" cudaError_t tf_flash_fwd(const void* q, const void* k, const void* v,
                                    void* o, float* lse, const float* kmax,
                                    int bh, int n_q, int n_kv, int hq, int hkv,
                                    int d, int kind, int offset, int radius,
                                    int section, int dtype, cudaStream_t stream) {
  if (bh <= 0 || n_q <= 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || kind < DENSE || kind > BLOCK || radius < 0 ||
      (kind == BLOCK && section <= 0))
    return cudaErrorInvalidValue;
#define TF_FWD(T, HD)                                                          \
  launch<T, HD>(q, k, v, o, lse, kmax, bh, n_q, n_kv, hq, hkv, kind, offset, \
                radius, section, stream)
  if (dtype == 1 && d == 256) return TF_FWD(__nv_bfloat16, 256);
  if (dtype == 1 && d == 128) return TF_FWD(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) return TF_FWD(__nv_bfloat16, 64);
  if (dtype == 0 && d == 256) return TF_FWD(float, 256);
  if (dtype == 0 && d == 128) return TF_FWD(float, 128);
  if (dtype == 0 && d == 64) return TF_FWD(float, 64);
#undef TF_FWD
  return cudaErrorInvalidValue;
}
