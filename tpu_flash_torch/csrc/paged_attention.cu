// B2: paged decode attention for Hopper, sm_90a.
//
// Replaces tpu_flash/ops/paged.py:_paged_kernel (launched by
// paged_attention): one query token per lane attends its slot's pages,
// walked through the page table with an online base-2 softmax. The
// reference's fused append of the new token runs as the separate B3 launch
// (paged_append.cu) just before this one on the same stream; len_add = 1
// then makes the new token part of the view, as in the fused kernel.
// Also replaces tpu_flash/ops/paged.py:_pipe_kernel (launched by
// paged_attention_pipelined): its hand-pipelined DMA loop walks exactly
// the lane's own pages, which this walk does when pages_bound does not
// cap it, and its rank-1 append is the same function as B3 then B2.
//
// Each lane sees keys [start, len): len is lengths_override[lane] when
// given, else lengths[slot] + len_add; start is 0, or under a band
// (radius >= 0) max(qpos - radius, 0) with qpos = positions[lane] when
// given, else len - 1. The walk starts at page start / page and covers at
// most pages_bound pages (the wrapper caps it at the band's page count);
// a lane with no visible key (an empty chunk prefix, start >= len) gives
// o = 0 and lse = -inf, the weight-0 partial that merge_partials expects.
//
// Numerics mirror the reference: q arrives prescaled by scale·log2(e) and
// cast to bf16 whatever the model dtype; K/V page values are cast to bf16
// before the dots (exact for int8; rounds float32 pages); scores accumulate
// in float32; int8 pages multiply the score column by the K scale and P by
// the V scale; P is rounded to bf16 before P·V; l sums the unscaled P;
// masked keys take DEFAULT_MASK_VALUE; o = acc·(1/l) only for rows with
// l > 0 and m > DEFAULT_MASK_VALUE/2, else 0 (lse = -inf).
//
// What bounds it on an H100: HBM bytes. Decode reads every visible K/V
// page once (at 16 lanes × ~540 tokens × 8 kv heads × d 128 that is ~17 MB
// per layer for an int8 cache, ~35 MB for bf16) for ~2 FLOP per byte, so
// the ceiling is 3.35 TB/s and the tensor cores have nothing to do.
// Design: one block per (lane, kv head) — 128 blocks at the serving batch
// of 16 and 8 kv heads, about one per SM; 4096 blocks when a 512-token
// prefill chunk rides the lanes — so all G = hq/hkv query rows of a kv
// head share one read of each page. Each page step first stages the
// page's visible K and V rows in shared memory as bf16, every thread
// issuing 16-byte loads at once, so a page costs one memory round trip
// (a first version that let each warp load its own rows serially spent
// ~0.17 ms on the serving shape). Then one thread per (row, query row)
// takes a dot product, one warp per query row does the online softmax,
// and each thread owns one output column of P·V (two at d 256). Overlapping the next
// page's loads with this page's math (cp.async or a TMA ring) is later
// work.
//
// Head dims: rows hold d elements, any multiple of 8 up to 256, read under a
// compiled width HD of 64, 128 or 256 whose columns past d stay zero in
// shared memory (8-byte loads for int8 pages, 16-byte ones otherwise).
// Groups: the G = hq/hkv query rows of a kv head are walked in chunks of at
// most 8 inside the block, each chunk walking the lane's pages once. A
// chunk after the first reads the pages again, from L2 at decode sizes (a
// lane's pages of one kv head are ~140 KB at 540 int8 tokens); launching
// once per chunk would read them again just the same and add launches, and
// keeping more than 8 rows' accumulators in registers would cost every
// G <= 8 model occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_G = 8;
constexpr int MAX_PAGE = 128;
constexpr float MASK = -0x1.666664p+127f;  // -0.7 * float32 max
constexpr float LN2 = 0.693147180559945309f;

// Page value as the reference's kernel sees it: cast to bf16, then float.
__device__ float as_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ float page_val(float x) { return as_bf16(x); }
__device__ float page_val(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ float page_val(int8_t x) { return static_cast<float>(x); }

__device__ void store(float* p, float x) { *p = x; }
__device__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// bf16 row pitch of the staged pages: HD + 2 puts the rows of one column
// in different shared-memory banks (the score loop reads down a column).
__host__ __device__ constexpr int pitch(int hd) { return hd + 2; }

size_t smem_bytes(int hd, int page, int g) {
  return sizeof(__nv_bfloat16) * 2 * page * pitch(hd) +
         sizeof(float) * (g < MAX_G ? g : MAX_G) * (hd + page);
}

// the launch's operands, passed down the dtype dispatch in one piece
struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* slots;
  const int* lengths;
  const int* lengths_override;
  const int* positions;
  const int* tables;
  void* out;
  float* lse;
  int b, kvh, g, d, page, total, maxp, bound, len_add, radius;
};

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TC, typename TO, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const TC* __restrict__ k_pages,
                       const TC* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ slots,
                       const int* __restrict__ lengths,
                       const int* __restrict__ lengths_override,
                       const int* __restrict__ positions,
                       const int* __restrict__ page_tables, TO* __restrict__ out,
                       float* __restrict__ lse, int kvh, int g_all, int d,
                       int page, int total_pages, int max_pages,
                       int pages_bound, int len_add, int radius) {
  constexpr int KP = pitch(HD);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // page × KP
  __nv_bfloat16* vs = ks + page * KP;                           // page × KP
  float* qs = reinterpret_cast<float*>(vs + page * KP);  // min(G, 8) × HD
  float* ss = qs + min(g_all, MAX_G) * HD;               // min(G, 8) × page
  __shared__ float ms[MAX_G], ls[MAX_G], als[MAX_G];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = slots[b];
  const int len = lengths_override != nullptr ? lengths_override[b]
                                              : lengths[slot] + len_add;
  const int qpos = positions != nullptr ? positions[b] : len - 1;
  const int start = radius >= 0 ? max(qpos - radius, 0) : 0;
  const int start_pg = start / page;
  const int n_pages = (len + page - 1) / page;
  const int steps = min(n_pages - start_pg, pages_bound);  // <= 0: no key
  const int last = min(max(n_pages, 1) - 1, max_pages - 1);
  const int* table = page_tables + (size_t)slot * max_pages;

  // columns [d, HD) of the staged K/V rows stay zero for every page
  for (int i = tid; i < 2 * page * (HD - d); i += NTHREADS) {
    const int r = i / (HD - d), c = d + i % (HD - d);
    ks[r * KP + c] = __float2bfloat16_rn(0.0f);
  }
  // 8 elements a load (one d is a multiple of 8: rows stay aligned)
  constexpr int VEC = sizeof(TC) == 4 ? 4 : 8;
  using Load = typename std::conditional<sizeof(TC) == 1, uint2, uint4>::type;
  const int CH = d / VEC;  // loads per row
  for (int g0 = 0; g0 < g_all; g0 += MAX_G) {
    const int g_rows = min(g_all - g0, MAX_G);
    const size_t qrow = ((size_t)b * kvh + h) * g_all + g0;

    __syncthreads();  // the previous chunk is done with qs, ms, ls
    for (int i = tid; i < g_rows * HD; i += NTHREADS) {
      const int g = i / HD, c = i % HD;
      qs[i] = c < d ? __bfloat162float(q[(qrow + g) * d + c]) : 0.0f;
    }
    if (tid < g_rows) {
      ms[tid] = MASK;
      ls[tid] = 0.0f;
    }
    constexpr int CPT = (HD + NTHREADS - 1) / NTHREADS;  // columns a thread
    float acc[CPT][MAX_G];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) acc[j][g] = 0.0f;

    for (int i = 0; i < steps; ++i) {
      const int logical = start_pg + i;
      const int phys = table[min(logical, last)];
      const size_t row0 = ((size_t)h * total_pages + phys) * page;
      // visible rows [lo, hi) of this page: after the band start, before len
      const int lo = max(0, start - logical * page);
      const int hi = min(page, len - logical * page);
      const int n_rows = max(hi - lo, 0);
      __syncthreads();  // previous step done with ks/vs/ss (and q visible)
      // stage the page's visible K and V rows in shared memory as bf16: every
      // thread issues its 16-byte loads at once, one memory round trip a page
      for (int idx = tid; idx < 2 * n_rows * CH; idx += NTHREADS) {
        const bool is_v = idx >= n_rows * CH;
        const int j = is_v ? idx - n_rows * CH : idx;
        const int r = lo + j / CH, c = (j % CH) * VEC;
        const Load raw = *reinterpret_cast<const Load*>(
            (is_v ? v_pages : k_pages) + (row0 + r) * d + c);
        const TC* e = reinterpret_cast<const TC*>(&raw);
        __nv_bfloat16* dst = (is_v ? vs : ks) + r * KP + c;
#pragma unroll
        for (int u = 0; u < VEC; u += 2)
          *reinterpret_cast<__nv_bfloat162*>(dst + u) =
              __floats2bfloat162_rn(page_val(e[u]), page_val(e[u + 1]));
      }
      __syncthreads();
      // scores: one (row, query row) pair per thread
      for (int w = tid; w < page * g_rows; w += NTHREADS) {
        const int r = w % page, g = w / page;
        float sv = MASK;
        if (r >= lo && r < hi) {
          const __nv_bfloat16* kr = ks + r * KP;
          const float* qg = qs + g * HD;
          float dot = 0.0f;
#pragma unroll 8
          for (int c = 0; c < HD; c += 2) {
            const float2 kf =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + c));
            dot = fmaf(qg[c], kf.x, dot);
            dot = fmaf(qg[c + 1], kf.y, dot);
          }
          sv = k_scales != nullptr ? dot * k_scales[row0 + r] : dot;
        }
        ss[g * page + r] = sv;
      }
      __syncthreads();
      // online softmax, one warp per query row; P (V-scaled, bf16-rounded)
      // overwrites the scores
      for (int g = warp; g < g_rows; g += NWARPS) {
        float* sg = ss + g * page;
        float mx = MASK;
        for (int r = lane; r < page; r += 32) mx = fmaxf(mx, sg[r]);
        const float m_prev = ms[g];
        const float m_next = fmaxf(m_prev, warp_max(mx));
        float psum = 0.0f;
        for (int r = lane; r < page; r += 32) {
          const float p = exp2f(sg[r] - m_next);
          psum += p;
          const float vsc = (v_scales != nullptr && r >= lo && r < hi)
                                ? v_scales[row0 + r] : 1.0f;
          sg[r] = as_bf16(p * vsc);
        }
        psum = warp_sum(psum);
        if (lane == 0) {
          const float alpha = exp2f(m_prev - m_next);
          als[g] = alpha;
          ms[g] = m_next;
          ls[g] = alpha * ls[g] + psum;
        }
      }
      __syncthreads();
      // P·V: thread t owns output columns t and t + 128 for every query row
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + j * NTHREADS;
        if (c >= d) break;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < g_rows) acc[j][g] *= als[g];
        for (int r = lo; r < hi; ++r) {
          const float vv = __bfloat162float(vs[r * KP + c]);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < g_rows) acc[j][g] = fmaf(ss[g * page + r], vv, acc[j][g]);
        }
      }
    }

    __syncthreads();  // m, l visible to every thread (also when no step ran)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * NTHREADS;
      if (c >= d) break;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= g_rows) break;
        const float l = ls[g], m = ms[g];
        const bool valid = l > 0.0f && m > MASK * 0.5f;
        store(out + (qrow + g) * d + c, acc[j][g] * (valid ? 1.0f / l : 0.0f));
      }
    }
    if (lse != nullptr && tid < g_rows) {
      const float l = ls[tid], m = ms[tid];
      const bool valid = l > 0.0f && m > MASK * 0.5f;
      lse[qrow + tid] = valid ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
    }
  }
}

template <typename TC, typename TO, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = paged_attention_kernel<TC, TO, HD>;
  const size_t smem = smem_bytes(HD, a.page, a.g);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.b, a.kvh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TC*>(a.kp),
      static_cast<const TC*>(a.vp), a.ks, a.vs, a.slots, a.lengths,
      a.lengths_override, a.positions, a.tables, static_cast<TO*>(a.out),
      a.lse, a.kvh, a.g, a.d, a.page, a.total, a.maxp, a.bound, a.len_add,
      a.radius);
  return cudaGetLastError();
}

template <typename TC, typename TO>
cudaError_t by_dim(int d, const Args& a, cudaStream_t stream) {
  if (d <= 64) return launch<TC, TO, 64>(a, stream);
  if (d <= 128) return launch<TC, TO, 128>(a, stream);
  return launch<TC, TO, 256>(a, stream);
}

template <typename TO>
cudaError_t by_cache(int cache_dtype, int d, const Args& a,
                     cudaStream_t stream) {
  switch (cache_dtype) {
    case 0: return by_dim<float, TO>(d, a, stream);
    case 1: return by_dim<__nv_bfloat16, TO>(d, a, stream);
    case 2: return by_dim<int8_t, TO>(d, a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (b, kvh, g, d) bf16 prescaled; k/v pages: (kvh, total, page, d) of
// cache_dtype (0 float32, 1 bf16, 2 int8); scales: (kvh, total, page) f32
// for int8, else null; slots (b,), lengths (max_seqs,), page_tables
// (max_seqs, max_pages) int32; lengths_override and positions: (b,) int32
// or null; radius: the band radius, or -1 for none; d: a multiple of 8 up
// to 256; g: any group size; out: (b, kvh, g, d) of
// out_dtype (0 float32, 1 bf16); lse: (b, kvh, g) float32 or null. Lane i
// sees keys [start_i, len_i) as the kernel's note says. All contiguous.
extern "C" cudaError_t tf_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* slots,
    const int* lengths, const int* lengths_override, const int* positions,
    const int* page_tables, void* out, float* lse, int b, int kvh, int g,
    int d, int page, int total_pages, int max_pages, int pages_bound,
    int len_add, int radius, int cache_dtype, int out_dtype,
    cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  if (g < 1 || d < 8 || d > 256 || d % 8 != 0 || page < 1 || page > MAX_PAGE ||
      max_pages < 1 ||
      radius < -1 ||
      (cache_dtype == 2) != (k_scales != nullptr && v_scales != nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, slots, lengths,
               lengths_override, positions, page_tables, out, lse, b, kvh, g, d,
               page, total_pages, max_pages, pages_bound, len_add, radius};
  if (out_dtype == 0) return by_cache<float>(cache_dtype, d, a, stream);
  if (out_dtype == 1) return by_cache<__nv_bfloat16>(cache_dtype, d, a, stream);
  return cudaErrorInvalidValue;
}
