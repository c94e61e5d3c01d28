// B2: paged decode attention for Hopper, sm_90a, with B3's append fused
// into its decode launch.
//
// Replaces tpu_flash/ops/paged.py:_paged_kernel (launched by
// paged_attention): one query token per lane attends its slot's pages,
// walked through the page table with an online base-2 softmax; with the
// new token's K/V (new_k, new_v) the walk first quantizes and writes them
// into the slot's tail page and attends them from registers, as the
// reference's fused append does. Also replaces
// tpu_flash/ops/paged.py:_pipe_kernel (launched by
// paged_attention_pipelined): its hand-pipelined DMA loop walks exactly the
// lane's own pages, which this walk does when pages_bound does not cap it,
// and its rank-1 append is the same function as the fused append.
//
// Each lane sees keys [start, len): len is lengths_override[lane] when
// given, else lengths[slot] + len_add; start is 0, or under a band
// (radius >= 0) max(qpos - radius, 0) with qpos = positions[lane] when
// given, else len - 1. The walk starts at page start / page and covers at
// most pages_bound pages (the wrapper caps it at the band's page count);
// a lane with no visible key (an empty chunk prefix, start >= len) gives
// o = 0 and lse = -inf, the weight-0 partial that merge_partials expects.
//
// Page types (paged_page.cuh, a code from the host, never read off the
// storage's byte width): float32, bf16, int8, int4 packed in halves (d/2
// bytes a row) and e4m3, the last three with a float32 scale a row.
//
// Numerics mirror the reference: q is prescaled by scale·log2(e) in
// float32 (q·qscale) and rounded to bf16 as it is loaded; K/V page values
// are cast to bf16 before the dots (exact for int8, int4 and e4m3 codes,
// which decode exactly; rounds float32 pages); scores accumulate in
// float32; quantized pages multiply the score column by the K scale and P
// by the V scale; P is rounded to bf16 against the running max after each
// page, before P·V; l sums the unscaled P; masked keys take
// DEFAULT_MASK_VALUE; o = acc·(1/l) only for rows with l > 0 and m >
// DEFAULT_MASK_VALUE/2, else 0 (lse = -inf). The fused append encodes the
// row with paged_page.cuh:encode_row, as paged_append.cu does. (The
// reference's kernel decodes e4m3 subnormals approximately, through
// tpu_flash/quant/flash_q.py:_fp8_upcast; here they decode exactly.)
//
// What bounds it on an H100: HBM bytes. Decode reads every visible K/V
// page once (16 lanes × ~540 tokens × 8 kv heads × d 128 is ~17 MB a layer
// for an int8 or fp8 cache, ~9 MB for int4, ~35 MB for bf16) at ~2 FLOP a
// byte: the ceiling is 3.35 TB/s and the tensor cores have nothing to do. The chunk prefix of
// chunked prefill is the exception: 512 lanes of ONE slot read the same
// ≤ 9 pages, so there the work is 512 q rows × the prefix, a small GEMM.
//
// Two routes (ops/paged.py:paged_route picks one from static shapes):
//
// - split (route 0), the decode route, any slots, with or without a band:
//   one CTA of 4 warps per (split, kv head, lane). A split is a run of at
//   most S consecutive pages of the lane's walk (S from the host's plan,
//   ops/paged.py:split_plan, which the plain version takes too); all of a
//   split's pages are in flight at once. Where the 1-D bulk copy takes a
//   page (each K and V page one contiguous run of (kvh, total, page, row)
//   storage whose page·row_bytes are a multiple of 16, scale rows of
//   4·page bytes likewise), two or four bulk copies a page fill an S-stage
//   shared ring; otherwise (float32 pages, which are staged as the bf16 the
//   dots read, so that a page of 128 at d 256 fits; quantized pages off
//   the 16-byte grid) every thread copies the split's pages with 8-byte
//   loads (4-byte ones where an int4 page is not a multiple of 8 bytes)
//   and the scale rows with 4-byte ones. int4 and e4m3 codes are decoded
//   where the dots load them (8 values at once, from the staged page). The launch refuses a plan
//   whose stages do not fit in shared memory (split_smem, the one account
//   of the layout). The dots run on the CUDA cores (decode has ~2 FLOP a
//   byte): LK lanes per key row, each holding 8 columns of the G query rows
//   of a chunk of at most 8 (the rows of a kv head share every page read),
//   a shuffle sum per key; one warp per query row does the page's softmax;
//   P·V runs key row per lane group, and the groups' partial sums add in a
//   fixed order. A split writes float32 (m, l, acc) partials to the call's
//   workspace; the last CTA of a (lane, head) to finish, found by an atomic
//   ticket in that workspace (zeroed on the call's stream before the
//   launch, so two calls on two streams, or a captured graph beside an
//   eager call, never share one), combines them in split order, so one
//   launch does the call and two calls are bitwise equal. A (lane, head)
//   with one split writes o and lse itself. With new_k/new_v the CTA whose
//   split holds the tail page (or the walk's last split, when pages_bound
//   stops the walk before it) encodes the new row in registers, writes it
//   to the cache, and overwrites the stale row (and scale) of its staged
//   page once the copy has landed: each CTA merges its own registers, so
//   idle lanes that share the trash slot never read each other's row.
// - shared (route 1), the chunk prefix (shared_page_table: every lane on
//   one slot, one table row): a CTA takes 64 (lane, g) rows, lane-major, of
//   one kv head and walks the union of their visible pages, one 64-key page
//   a step, with per-row masks [start_r, end_r). Raw pages come in by bulk
//   copy into a 1–3 stage ring; the 4 warps decode them to bf16 in the
//   128-byte swizzled layout wgmma reads; S = Q·Kᵀ and O += P·V are bf16
//   wgmma (V read MN-major, P from registers), S/P/O in registers. The
//   running max advances one page a step and a row's keys outside its own
//   range take p = 0, so every row rounds P where its one-split walk does.
//   Page 64 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "paged_page.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;         // threads of every route's CTA
constexpr int MAX_PAGE = 128;
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may use
constexpr float MASK = -0x1.666664p+127f;  // -0.7 * float32 max
constexpr float LN2 = 0.693147180559945309f;
enum Route { SPLIT = 0, SHARED = 1 };

// the launch's operands, passed down the dtype dispatch in one piece
struct Args {
  const void* q;      // (b, kvh, g, d), float32 or bf16, unscaled
  const void* new_k;  // (b, kvh, d) or null: the fused append's row
  const void* new_v;
  void* kp;
  void* vp;
  float* ks;
  float* vs;
  const int* slots;
  const int* lengths;
  const int* lengths_override;
  const int* positions;
  const int* tables;
  void* out;
  float* lse;
  float* ws_acc;  // (b, kvh, n_splits, g, d): the split route's partials
  float* ws_ml;   // (b, kvh, n_splits, g, 2): their m and l
  int* tickets;   // (b, kvh), zeroed before the launch
  int b, kvh, g, d, page, total, maxp, bound, len_add, radius;
  int q_f32, in_f32, split_pages, n_splits;
  int bulk;  // the split route's pages come in by bulk copy
  float qscale;
};

// x rounded to bf16, as a float
__device__ __forceinline__ float as_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// q element i, prescaled in float32 and rounded to bf16 (the reference's
// (q.float() * scale·log2e).astype(bf16))
__device__ __forceinline__ float load_q(const Args& a, size_t i) {
  const float x = a.q_f32 ? static_cast<const float*>(a.q)[i]
                          : __bfloat162float(static_cast<const bf16*>(a.q)[i]);
  return as_bf16(x * a.qscale);
}

// values 8·c8 … 8·c8 + 7 of row r of a page as the split route stages it
// (float32 pages as bf16, the others as they are in the cache), as floats;
// every decode is exact
template <int PT>
__device__ __forceinline__ void load8(const unsigned char* pg, int r, int c8, int d,
                                      float (&v)[8]) {
  if constexpr (PT == PT_F32 || PT == PT_BF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(pg + ((size_t)r * d + 8 * c8) * 2);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  } else if constexpr (PT == PT_I8) {
    // the float with bits 0x4B000000 | (x ^ 0x80) is 2^23 + 128 + x
    const uint2 raw = *reinterpret_cast<const uint2*>(pg + (size_t)r * d + 8 * c8);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t w = (i < 4 ? raw.x : raw.y) ^ 0x80808080u;
      v[i] = __uint_as_float(0x4B000000u | ((w >> (8 * (i % 4))) & 0xffu)) - 8388736.0f;
    }
  } else if constexpr (PT == PT_E4M3) {
    // e4m3 → f16 pairs (cvt.rn.f16x2.e4m3x2), then to float: exact
    const uint2 raw = *reinterpret_cast<const uint2*>(pg + (size_t)r * d + 8 * c8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = i < 2 ? raw.x : raw.y;
      const __half2 h2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * (i % 2))), __NV_E4M3));
      const float2 f = __half22float2(h2);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    // int4 in halves: element e < d/2 is the low nibble of byte e, element
    // e >= d/2 the high nibble of byte e - d/2; sign-extended by int32
    // shifts. With d/2 a multiple of 8 the 8 values are one aligned word
    // pair of one half; otherwise byte by byte.
    const int h = d / 2, e0 = 8 * c8;
    const unsigned char* row = pg + (size_t)r * h;
    if (h % 8 == 0) {
      const bool hi = e0 >= h;
      const uint2 raw = *reinterpret_cast<const uint2*>(row + (hi ? e0 - h : e0));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = i < 4 ? raw.x : raw.y;
        const int sh = 8 * (i % 4);
        v[i] = static_cast<float>(hi ? static_cast<int>(w << (24 - sh)) >> 28
                                     : static_cast<int>(w << (28 - sh)) >> 28);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = e0 + i;
        const int x = static_cast<int8_t>(row[e < h ? e : e - h]);
        v[i] = static_cast<float>(e < h ? (x << 28) >> 28 : x >> 4);
      }
    }
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

// ------------------------------------------------------------ split

// lanes a key row takes in the split route: the power of two that covers
// its d / 8 chunks of 8 columns
__host__ __device__ inline int lanes_per_key(int d) {
  int lk = 1;
  while (lk < d / 8) lk <<= 1;
  return lk;
}

// the type a split stage holds a storage unit in: float32 pages as the
// bf16 the dots read (the same rounding), the others as they are; and a
// staged row's bytes
template <int PT>
using Staged = typename std::conditional<PT == PT_F32, bf16, typename Page<PT>::T>::type;
__host__ __device__ inline int staged_row_bytes(int pt, int d) {
  return pt == PT_F32 ? 2 * d : row_bytes(pt, d);
}
template <int PT>
__device__ __forceinline__ Staged<PT> to_staged(typename Page<PT>::T u) {
  if constexpr (PT == PT_F32) return __float2bfloat16_rn(u);
  else return u;
}

// the split route's shared memory, its one account: S stages of a staged
// K page and V page (srb bytes a row, each padded to 16 bytes) and the K
// and V scale rows, the stages' barriers, P/scores (GC × page), the lane
// groups' P·V sums (NG × GC × d), m/l/alpha and the last-CTA flag
__host__ __device__ inline size_t split_kv(int page, int srb) {
  return ((size_t)page * srb + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t split_stage(int page, int srb, bool quant) {
  return 2 * split_kv(page, srb) + (quant ? 8 * (size_t)page : 0);
}
__host__ __device__ inline size_t split_smem(int s, int page, int d, int srb, bool quant,
                                             int gc) {
  const int ng = NT / lanes_per_key(d);
  const size_t stage = (split_stage(page, srb, quant) + 15) & ~(size_t)15;
  return s * stage + 8 * (size_t)s + 4 * (size_t)gc * page + 4 * (size_t)ng * gc * d +
         12 * (size_t)gc + 16;
}

template <int PT, typename TO, int GC>
__global__ void __launch_bounds__(NT) paged_split_kernel(const Args a) {
  using TC = typename Page<PT>::T;
  using SC = Staged<PT>;
  constexpr int KPI = 4;  // key rows a lane group takes at once
  constexpr bool QUANT = Page<PT>::QUANT;
  const bool bulk = PT != PT_F32 && a.bulk;
  extern __shared__ __align__(128) unsigned char smem[];
  const int sidx = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int page = a.page, d = a.d, S = a.split_pages, G = a.g;
  const int slot = a.slots[b];
  const int base_len = a.lengths[slot];
  const int len = a.lengths_override != nullptr ? a.lengths_override[b]
                                                : base_len + a.len_add;
  const int qpos = a.positions != nullptr ? a.positions[b] : len - 1;
  const int start = a.radius >= 0 ? max(qpos - a.radius, 0) : 0;
  const int start_pg = start / page;
  const int n_pages = (len + page - 1) / page;
  const int n_walk = max(0, min(n_pages - start_pg, a.bound));
  const int n_work = (n_walk + S - 1) / S;  // splits that walk a page
  if (sidx >= max(n_work, 1)) return;  // (split 0 of an empty lane writes 0)
  const int* table = a.tables + (size_t)slot * a.maxp;
  const int last = min(max(n_pages, 1) - 1, a.maxp - 1);
  const int first = sidx * S;
  const int my_n = max(0, min(S, n_walk - first));
  // the fused append: the split that walks the tail page owns it, or the
  // walk's last split when pages_bound stops the walk before the tail
  const bool append = a.new_k != nullptr;
  const int tail = base_len / page;
  bool owner = false;
  if (append) {
    const int idx = tail - start_pg;
    owner = sidx == ((idx >= 0 && idx < n_walk) ? idx / S : max(n_work - 1, 0));
  }

  const int units = row_units(PT, d), rb = row_bytes(PT, d), srb = staged_row_bytes(PT, d);
  const size_t kvb = (size_t)page * rb;    // a K (or V) page in the cache
  const size_t kvs = split_kv(page, srb);  // and in its stage
  const size_t stage = (split_stage(page, srb, QUANT) + 15) & ~(size_t)15;
  const int C = d / 8, LK = lanes_per_key(d), NG = NT / LK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * stage);
  float* ss = reinterpret_cast<float*>(full + S);  // GC × page
  float* red = ss + GC * page;                     // NG × GC × d
  float* ms = red + (size_t)NG * GC * d;
  float* ls = ms + GC;
  float* als = ls + GC;
  int* flag = reinterpret_cast<int*>(als + GC);

  if (bulk) {
    if (tid == 0) {
      for (int j = 0; j < my_n; ++j) mbar_init(&full[j], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    // every page of the split in flight at once: lane j of warp 0 reads
    // page j's table entry and issues its copies
    if (tid < my_n) {
      const int phys = table[min(start_pg + first + tid, last)];
      const size_t row0 = ((size_t)h * a.total + phys) * page;
      unsigned char* st = smem + tid * stage;
      uint64_t* bar = &full[tid];
      mbar_expect_tx(bar, (uint32_t)(2 * kvb + (QUANT ? 8 * page : 0)));
      bulk_load(st, static_cast<const unsigned char*>(a.kp) + row0 * rb, (uint32_t)kvb, bar);
      bulk_load(st + kvs, static_cast<const unsigned char*>(a.vp) + row0 * rb, (uint32_t)kvb,
                bar);
      if constexpr (QUANT) {
        bulk_load(st + 2 * kvs, a.ks + row0, 4 * page, bar);
        bulk_load(st + 2 * kvs + 4 * page, a.vs + row0, 4 * page, bar);
      }
    }
  } else {
    // pages the bulk copy does not take: every thread copies the split's
    // pages in 8-byte words (a float32 pair rounded to a bf16 pair), or
    // 4-byte ones where the page is not a multiple of 8 bytes (an int4 page
    // of an odd row count at d/2 ≡ 4 mod 8), and the scale rows a float at
    // a time
    const bool w8 = kvb % 8 == 0;
    const int words = (int)(kvb / (w8 ? 8 : 4));
    for (int j = 0; j < my_n; ++j) {
      const int phys = table[min(start_pg + first + j, last)];
      const size_t row0 = ((size_t)h * a.total + phys) * page;
      unsigned char* st = smem + j * stage;
      for (int i = tid; i < 2 * words; i += NT) {
        const int is_v = i >= words, w = i - is_v * words;
        const unsigned char* src =
            static_cast<const unsigned char*>(is_v ? a.vp : a.kp) + row0 * rb;
        if constexpr (PT == PT_F32) {
          const uint2 x = reinterpret_cast<const uint2*>(src)[w];
          reinterpret_cast<__nv_bfloat162*>(st + is_v * kvs)[w] =
              __floats2bfloat162_rn(__uint_as_float(x.x), __uint_as_float(x.y));
        } else if (w8) {
          reinterpret_cast<uint2*>(st + is_v * kvs)[w] = reinterpret_cast<const uint2*>(src)[w];
        } else {
          reinterpret_cast<uint32_t*>(st + is_v * kvs)[w] =
              reinterpret_cast<const uint32_t*>(src)[w];
        }
      }
      if constexpr (QUANT)
        for (int i = tid; i < 2 * page; i += NT)
          reinterpret_cast<float*>(st + 2 * kvs)[i] = (i < page ? a.ks : a.vs)[row0 + i % page];
    }
    __syncthreads();  // staged before the append's row overwrites its own
  }

  // the new row (warp 0: K, warp 1: V), encoded in registers as
  // paged_append.cu encodes it (paged_page.cuh:encode_row), and written to
  // the cache
  TC au[ROW_J];
  float asc = 1.0f;
  if (owner && warp < 2) {
    const bool is_v = warp == 1;
    const size_t src = ((size_t)b * a.kvh + h) * d;
    const void* nv = is_v ? a.new_v : a.new_k;
    asc = encode_row<PT>(
        [&](int c) {
          return a.in_f32 ? static_cast<const float*>(nv)[src + c]
                          : __bfloat162float(static_cast<const bf16*>(nv)[src + c]);
        },
        d, lane, au);
    const int phys = table[min(tail, a.maxp - 1)];
    const size_t arow = ((size_t)h * a.total + phys) * page + base_len % page;
    TC* dst = static_cast<TC*>(is_v ? a.vp : a.kp) + arow * units;
#pragma unroll
    for (int j = 0; j < ROW_J; ++j)
      if (lane + 32 * j < units) dst[lane + 32 * j] = au[j];
    if (QUANT && lane == 0) (is_v ? a.vs : a.ks)[arow] = asc;
  }

  const int grp = tid / LK, c = tid % LK;
  TO* out = static_cast<TO*>(a.out);
  const bool direct = n_work <= 1;
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gr = min(GC, G - g0);
    const size_t qrow = ((size_t)b * a.kvh + h) * G + g0;
    float qr[GC][8], acc[GC][8];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qr[g][e] = (g < gr && c < C) ? load_q(a, (qrow + g) * d + c * 8 + e) : 0.0f;
        acc[g][e] = 0.0f;
      }
    if (tid < GC) {
      ms[tid] = MASK;
      ls[tid] = 0.0f;
    }
    for (int j = 0; j < my_n; ++j) {
      const int logical = start_pg + first + j;
      const int lo = max(0, start - logical * page);
      const int hi = min(page, len - logical * page);
      unsigned char* st = smem + j * stage;
      const unsigned char* kr = st;
      const unsigned char* vr = st + kvs;
      float* sc_row = reinterpret_cast<float*>(st + 2 * kvs);  // K scales, then V's
      if (bulk) mbar_wait(&full[j], 0);
      if (g0 == 0 && owner && logical == tail && warp < 2) {
        // the stale tail row the copy brought: this CTA's own new row
        const int off = base_len % page;
        SC* dst = reinterpret_cast<SC*>(st + (warp ? kvs : 0)) + (size_t)off * units;
#pragma unroll
        for (int jj = 0; jj < ROW_J; ++jj)
          if (lane + 32 * jj < units) dst[lane + 32 * jj] = to_staged<PT>(au[jj]);
        if (QUANT && lane == 0) sc_row[(warp ? page : 0) + off] = asc;
      }
      __syncthreads();  // the page (and its merged row) staged; ss free
      // scores: LK lanes a key row, 8 columns a lane, a shuffle sum; KPI
      // key rows a lane group at once, so that their loads and shuffle
      // chains overlap
      for (int base = 0; base < page; base += NG * KPI) {
        float dot[KPI][GC];
#pragma unroll
        for (int k = 0; k < KPI; ++k) {
          const int r = base + grp + k * NG;
#pragma unroll
          for (int g = 0; g < GC; ++g) dot[k][g] = 0.0f;
          if (r >= lo && r < hi && c < C) {
            float kv[8];
            load8<PT>(kr, r, c, d, kv);
#pragma unroll
            for (int g = 0; g < GC; ++g)
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[k][g] = fmaf(qr[g][e], kv[e], dot[k][g]);
          }
        }
        for (int o = LK >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int k = 0; k < KPI; ++k)
#pragma unroll
            for (int g = 0; g < GC; ++g)
              dot[k][g] += __shfl_xor_sync(0xffffffffu, dot[k][g], o);
        if (c == 0) {
#pragma unroll
          for (int k = 0; k < KPI; ++k) {
            const int r = base + grp + k * NG;
            if (r >= page) break;
            const bool vis = r >= lo && r < hi;
#pragma unroll
            for (int g = 0; g < GC; ++g)
              if (g < gr)
                ss[g * page + r] = vis ? (QUANT ? dot[k][g] * sc_row[r] : dot[k][g]) : MASK;
          }
        }
      }
      __syncthreads();
      // the page's softmax, one warp a query row; P (V-scaled, bf16)
      // overwrites the scores
      for (int g = warp; g < gr; g += NT / 32) {
        float* sg = ss + g * page;
        float mx = MASK;
        for (int r = lane; r < page; r += 32) mx = fmaxf(mx, sg[r]);
        const float m_prev = ms[g];
        const float m_next = fmaxf(m_prev, warp_max(mx));
        float psum = 0.0f;
        for (int r = lane; r < page; r += 32) {
          const float p = exp2f(sg[r] - m_next);
          psum += p;
          const float vsc = (QUANT && r >= lo && r < hi) ? sc_row[page + r] : 1.0f;
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
      // P·V: a lane group a key row, 8 columns a lane
#pragma unroll
      for (int g = 0; g < GC; ++g)
        if (g < gr) {
          const float al = als[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= al;
        }
      if (c < C) {
        for (int r0 = lo + grp; r0 < hi; r0 += NG * KPI) {
          float vv[KPI][8];
#pragma unroll
          for (int k = 0; k < KPI; ++k) {
            const int r = r0 + k * NG;
#pragma unroll
            for (int e = 0; e < 8; ++e) vv[k][e] = 0.0f;
            if (r < hi) load8<PT>(vr, r, c, d, vv[k]);
          }
#pragma unroll
          for (int k = 0; k < KPI; ++k) {
            const int r = r0 + k * NG;
            if (r >= hi) break;
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              const float p = g < gr ? ss[g * page + r] : 0.0f;
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vv[k][e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // every group's P·V done; m, l visible
    if (c < C) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[((size_t)grp * GC + g) * d + c * 8 + e] = acc[g][e];
    }
    __syncthreads();
    const size_t part = ((size_t)(b * a.kvh + h) * a.n_splits + sidx) * G + g0;
    for (int idx = tid; idx < gr * d; idx += NT) {
      const int g = idx / d, col = idx % d;
      float t = 0.0f;
      for (int gi = 0; gi < NG; ++gi) t += red[((size_t)gi * GC + g) * d + col];
      if (direct) {
        const float l = ls[g], m = ms[g];
        const bool valid = l > 0.0f && m > MASK * 0.5f;
        store(out + (qrow + g) * d + col, t * (valid ? 1.0f / l : 0.0f));
      } else {
        a.ws_acc[(part + g) * d + col] = t;
      }
    }
    if (tid < gr) {
      const float l = ls[tid], m = ms[tid];
      if (direct) {
        if (a.lse != nullptr)
          a.lse[qrow + tid] = l > 0.0f && m > MASK * 0.5f ? m * LN2 + logf(l)
                                                          : -__int_as_float(0x7f800000);
      } else {
        a.ws_ml[(part + tid) * 2] = m;
        a.ws_ml[(part + tid) * 2 + 1] = l;
      }
    }
    __syncthreads();  // the next chunk reuses ms, ls and red
  }
  if (direct) return;

  // the last CTA of this (lane, head) combines the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&a.tickets[b * a.kvh + h], 1);
    *flag = ticket == n_work - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // every split's (m, l) of this (lane, head) is one contiguous run of
  // ws_ml: copied at once into the free shared memory (the scores
  // onward), then one thread a row turns each m into the split's weight
  // exp2(m_s - m) and sums l; the outputs sum the partials in split order
  const size_t base = (size_t)(b * a.kvh + h) * a.n_splits * G;
  const size_t orow = ((size_t)b * a.kvh + h) * G;
  const int pairs = n_work * G;
  float* cw = ss;
  float* cl = reinterpret_cast<float*>(flag) - 2 * G;  // rows' l and m
  if (2 * (pairs + G) * sizeof(float) <=
      (size_t)(reinterpret_cast<unsigned char*>(flag) - reinterpret_cast<unsigned char*>(ss))) {
    for (int i = tid; i < 2 * pairs; i += NT) cw[i] = __ldcg(&a.ws_ml[base * 2 + i]);
    __syncthreads();
    for (int g = tid; g < G; g += NT) {
      float m = MASK;
      for (int s = 0; s < n_work; ++s) m = fmaxf(m, cw[2 * (s * G + g)]);
      float l = 0.0f;
      for (int s = 0; s < n_work; ++s) {
        const float w = exp2f(cw[2 * (s * G + g)] - m);
        l += cw[2 * (s * G + g) + 1] * w;
        cw[2 * (s * G + g)] = w;
      }
      cl[g] = l;
      cl[G + g] = m;
    }
    __syncthreads();
    for (int idx = tid; idx < G * d; idx += NT) {
      const int g = idx / d, col = idx % d;
      float t = 0.0f;
#pragma unroll 4
      for (int s = 0; s < n_work; ++s)
        t += __ldcg(&a.ws_acc[(base + s * G + g) * d + col]) * cw[2 * (s * G + g)];
      const float l = cl[g], m = cl[G + g];
      const bool valid = l > 0.0f && m > MASK * 0.5f;
      store(out + (orow + g) * d + col, t * (valid ? 1.0f / l : 0.0f));
    }
    if (a.lse != nullptr)
      for (int g = tid; g < G; g += NT)
        a.lse[orow + g] = cl[g] > 0.0f && cl[G + g] > MASK * 0.5f
                              ? cl[G + g] * LN2 + logf(cl[g])
                              : -__int_as_float(0x7f800000);
    return;
  }
  // (more partials than shared memory holds: read them where they are)
  for (int idx = tid; idx < G * d; idx += NT) {
    const int g = idx / d, col = idx % d;
    float m = MASK;
    for (int s = 0; s < n_work; ++s) m = fmaxf(m, __ldcg(&a.ws_ml[(base + s * G + g) * 2]));
    float l = 0.0f, t = 0.0f;
    for (int s = 0; s < n_work; ++s) {
      const size_t pr = base + s * G + g;
      const float w = exp2f(__ldcg(&a.ws_ml[pr * 2]) - m);
      l += __ldcg(&a.ws_ml[pr * 2 + 1]) * w;
      t += __ldcg(&a.ws_acc[pr * d + col]) * w;
    }
    const bool valid = l > 0.0f && m > MASK * 0.5f;
    store(out + (orow + g) * d + col, t * (valid ? 1.0f / l : 0.0f));
  }
  if (a.lse != nullptr) {
    for (int g = tid; g < G; g += NT) {
      float m = MASK;
      for (int s = 0; s < n_work; ++s) m = fmaxf(m, __ldcg(&a.ws_ml[(base + s * G + g) * 2]));
      float l = 0.0f;
      for (int s = 0; s < n_work; ++s) {
        const size_t pr = base + s * G + g;
        l += __ldcg(&a.ws_ml[pr * 2 + 1]) * exp2f(__ldcg(&a.ws_ml[pr * 2]) - m);
      }
      a.lse[orow + g] = l > 0.0f && m > MASK * 0.5f ? m * LN2 + logf(l)
                                                    : -__int_as_float(0x7f800000);
    }
  }
}

// ------------------------------------------------------------ shared

constexpr int SH_PAGE = 64;  // keys a step: one page

// shared bytes of the shared-table route: 1024 of alignment slack, the Q
// tile and NB pairs of K and V bf16 tiles (64 × HD each), ST raw stages
// (rb bytes a page row), their barriers, the rows' ranges, two pages'
// scales and the walk's range
__host__ __device__ inline size_t shared_stage(int rb, bool quant) {
  return 2 * (size_t)SH_PAGE * rb + (quant ? 8 * SH_PAGE : 0);
}
__host__ __device__ inline size_t shared_smem(int hd, int nb, int st, int rb, bool quant) {
  return 1024 + (1 + 2 * (size_t)nb) * SH_PAGE * hd * 2 + st * shared_stage(rb, quant) +
         8 * st + 4 * 6 * SH_PAGE + 16;
}

// values 8·c8 … 8·c8 + 7 of row r of a raw page as 8 bf16 (the kernel's
// view of them): bf16 as they are, float32 rounded, the codes of the
// quantized types decoded exactly (load8) and packed, which is exact
__device__ __forceinline__ uint32_t pack_hi(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
template <int PT>
__device__ __forceinline__ uint4 bf16x8(const uint8_t* pg, int r, int c8, int d) {
  if constexpr (PT == PT_BF16) {
    return *reinterpret_cast<const uint4*>(pg + ((size_t)r * d + 8 * c8) * 2);
  } else if constexpr (PT == PT_F32) {
    const float4* p = reinterpret_cast<const float4*>(pg + ((size_t)r * d + 8 * c8) * 4);
    const float4 x = p[0], y = p[1];
    return make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                      pack_bf16(y.z, y.w));
  } else {
    float v[8];
    load8<PT>(pg, r, c8, d, v);
    return make_uint4(pack_hi(v[0], v[1]), pack_hi(v[2], v[3]), pack_hi(v[4], v[5]),
                      pack_hi(v[6], v[7]));
  }
}

template <int PT, typename TO, int HD>
__global__ void __launch_bounds__(NT) paged_shared_kernel(const Args a, int NB, int ST) {
  constexpr bool QUANT = Page<PT>::QUANT;
  constexpr int TILE = SH_PAGE * HD * 2, CH = HD / 8;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = smem;
  uint8_t* tiles = smem + TILE;  // NB × (K, V)
  uint8_t* raw = tiles + 2 * NB * TILE;
  const int d = a.d, G = a.g;
  const int rowb = row_bytes(PT, d);
  const size_t kvb = (size_t)SH_PAGE * rowb;
  const size_t rstage = shared_stage(rowb, QUANT);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + ST * rstage);
  int* rs = reinterpret_cast<int*>(full + ST);  // row key ranges [rs, re)
  int* re = rs + SH_PAGE;
  float* ksc = reinterpret_cast<float*>(re + SH_PAGE);  // by step parity
  float* vsc = ksc + 2 * SH_PAGE;
  int* range = reinterpret_cast<int*>(vsc + 2 * SH_PAGE);

  const int tile = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int* table = a.tables + (size_t)a.slots[0] * a.maxp;
  if (tid == 0) {
    range[0] = INT_MAX;
    range[1] = 0;
    for (int i = 0; i < ST; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid < SH_PAGE) {  // row tid: (lane, g) = divmod(tile·64 + tid, G)
    const int row = tile * SH_PAGE + tid, ln = row / G;
    int s0 = 0, e0 = 0;
    if (ln < a.b) {
      const int len = a.lengths_override != nullptr ? a.lengths_override[ln]
                                                    : a.lengths[a.slots[ln]] + a.len_add;
      const int qpos = a.positions != nullptr ? a.positions[ln] : len - 1;
      s0 = a.radius >= 0 ? max(qpos - a.radius, 0) : 0;
      // the lane's walk covers at most pages_bound pages from its start
      e0 = min(len, (s0 / SH_PAGE + a.bound) * SH_PAGE);
      if (s0 < e0) {
        atomicMin(&range[0], s0 / SH_PAGE);
        atomicMax(&range[1], (e0 + SH_PAGE - 1) / SH_PAGE);
      }
    }
    rs[tid] = s0;
    re[tid] = e0;
  }
  // the Q tile: prescaled, bf16, 128-byte swizzled panels; zero past d
  for (int idx = tid; idx < SH_PAGE * CH; idx += NT) {
    const int r = idx / CH, c8 = idx % CH;
    const int row = tile * SH_PAGE + r, ln = row / G, g = row % G;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (ln < a.b && c8 * 8 < d) {
      const size_t i = (((size_t)ln * a.kvh + h) * G + g) * d + c8 * 8;
      w.x = pack_bf16(load_q(a, i), load_q(a, i + 1));
      w.y = pack_bf16(load_q(a, i + 2), load_q(a, i + 3));
      w.z = pack_bf16(load_q(a, i + 4), load_q(a, i + 5));
      w.w = pack_bf16(load_q(a, i + 6), load_q(a, i + 7));
    }
    *reinterpret_cast<uint4*>(qs + tile_off<128, 64>(r, 16 * c8)) = w;
  }
  __syncthreads();
  const int first = range[0], steps = max(0, range[1] - range[0]);

  auto issue = [&](int t) {
    const int phys = table[min(first + t, a.maxp - 1)];
    const size_t row0 = ((size_t)h * a.total + phys) * SH_PAGE;
    uint8_t* st = raw + (t % ST) * rstage;
    uint64_t* bar = &full[t % ST];
    mbar_expect_tx(bar, (uint32_t)rstage);
    bulk_load(st, static_cast<const uint8_t*>(a.kp) + row0 * rowb, (uint32_t)kvb, bar);
    bulk_load(st + kvb, static_cast<const uint8_t*>(a.vp) + row0 * rowb, (uint32_t)kvb, bar);
    if constexpr (QUANT) {
      bulk_load(st + 2 * kvb, a.ks + row0, 4 * SH_PAGE, bar);
      bulk_load(st + 2 * kvb + 4 * SH_PAGE, a.vs + row0, 4 * SH_PAGE, bar);
    }
  };
  if (tid == 0)
    for (int t = 0; t < min(ST, steps); ++t) issue(t);
  // decode step t's raw page into tile pair t % NB (zero past d), and its
  // scales into ksc/vsc by the step's parity
  auto decode = [&](int t) {
    const uint8_t* st = raw + (t % ST) * rstage;
    uint8_t* kt = tiles + (t % NB) * 2 * TILE;
    mbar_wait(&full[t % ST], (t / ST) & 1);
#pragma unroll 4
    for (int it = 0; it < SH_PAGE * CH / NT; ++it) {
      const int idx = tid + it * NT, r = idx / CH, c8 = idx % CH;
      uint4 wk = make_uint4(0, 0, 0, 0), wv = wk;
      if (c8 * 8 < d) {
        wk = bf16x8<PT>(st, r, c8, d);
        wv = bf16x8<PT>(st + kvb, r, c8, d);
      }
      *reinterpret_cast<uint4*>(kt + tile_off<128, 64>(r, 16 * c8)) = wk;
      *reinterpret_cast<uint4*>(kt + TILE + tile_off<128, 64>(r, 16 * c8)) = wv;
    }
    if (QUANT && tid < SH_PAGE) {
      const float* scl = reinterpret_cast<const float*>(st + 2 * kvb);
      ksc[(t & 1) * SH_PAGE + tid] = scl[tid];
      vsc[(t & 1) * SH_PAGE + tid] = scl[SH_PAGE + tid];
    }
  };
  const int warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, rb = ra + 8, t4 = lane % 4;
  const int sa = rs[ra], ea = re[ra], sb = rs[rb], eb = re[rb];
  float ma = MASK, mb = MASK, la = 0.0f, lb = 0.0f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  const uint32_t q_addr = smem_u32(qs);

  if (steps > 0) decode(0);
  fence_async_smem();
  __syncthreads();  // Q and the first tiles staged
  if (tid == 0 && ST < steps) issue(ST);
  for (int t = 0; t < steps; ++t) {
    const uint32_t k_addr = smem_u32(tiles + (t % NB) * 2 * TILE), v_addr = k_addr + TILE;
    const float* ks_t = ksc + (t & 1) * SH_PAGE;
    const float* vs_t = vsc + (t & 1) * SH_PAGE;
    // S = Q·Kᵀ on the tensor cores, both operands in shared memory; the
    // next page decodes into the other tile pair while it runs
    float sc[SH_PAGE / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int colb = 32 * kk;
      const uint64_t da = desc<128>(q_addr + (colb / 128) * 64 * 128 + colb % 128);
      const uint64_t db = desc<128>(k_addr + (colb / 128) * SH_PAGE * 128 + colb % 128);
      wgmma_bf16_bf16<SH_PAGE>(sc, da, db, kk);
    }
    wgmma_commit();
    const bool ahead = NB == 2 && t + 1 < steps;
    if (ahead) decode(t + 1);
    wgmma_wait0();
    reg_fence(sc);

    // per-row masks, the K scale, the page's online softmax in registers
    const int k0 = (first + t) * SH_PAGE;
    uint32_t vis = 0;
    float mxa = MASK, mxb = MASK;
#pragma unroll
    for (int e = 0; e < SH_PAGE / 2; ++e) {
      const int kpos = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      const bool v = (e & 2) ? (kpos >= sb && kpos < eb) : (kpos >= sa && kpos < ea);
      vis |= (uint32_t)v << e;
      sc[e] = v ? (QUANT ? sc[e] * ks_t[kpos - k0] : sc[e]) : MASK;
      if (e & 2) mxb = fmaxf(mxb, sc[e]);
      else mxa = fmaxf(mxa, sc[e]);
    }
    const float na = fmaxf(ma, quad_max(mxa)), nb = fmaxf(mb, quad_max(mxb));
    const float alpha_a = exp2f(ma - na), alpha_b = exp2f(mb - nb);
    ma = na;
    mb = nb;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
    float psa = 0.0f, psb = 0.0f;
#pragma unroll
    for (int e = 0; e < SH_PAGE / 2; ++e) {
      const float p = (vis >> e) & 1 ? exp2f(sc[e] - ((e & 2) ? mb : ma)) : 0.0f;
      if (e & 2) psb += p;
      else psa += p;
      sc[e] = QUANT ? p * vs_t[8 * (e / 4) + 2 * t4 + (e & 1)] : p;
    }
    la = alpha_a * la + quad_sum(psa);
    lb = alpha_b * lb + quad_sum(psb);

    // O += P·V: P (bf16) the register A operand, V read MN-major
    uint32_t pa[SH_PAGE / 16][4];
#pragma unroll
    for (int kk = 0; kk < SH_PAGE / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SH_PAGE / 16; ++kk)
      wgmma_rs_bf16<HD, 1>(o, pa[kk], desc_mn(v_addr + kk * 16 * 128, SH_PAGE * 128));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(o);
    if (!ahead && t + 1 < steps) {  // one tile pair: decode after the products
      __syncthreads();
      decode(t + 1);
    }
    fence_async_smem();
    __syncthreads();  // the next tiles staged; this raw stage and tile pair free
    if (tid == 0 && t + 1 + ST < steps) issue(t + 1 + ST);
  }

  // finish: o = acc·(1/l), lse = m·ln2 + log(l); dead rows give 0, -inf
  TO* out = static_cast<TO*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = tile * SH_PAGE + (half ? rb : ra), ln = row / G, g = row % G;
    if (ln >= a.b) continue;
    const float l = half ? lb : la, m = half ? mb : ma;
    const bool valid = l > 0.0f && m > MASK * 0.5f;
    const float inv = valid ? 1.0f / l : 0.0f;
    const size_t orow = ((size_t)ln * a.kvh + h) * G + g;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < d) {
        store(out + orow * d + col, o[4 * j + 2 * half] * inv);
        store(out + orow * d + col + 1, o[4 * j + 2 * half + 1] * inv);
      }
    }
    if (a.lse != nullptr && t4 == 0)
      a.lse[orow] = valid ? m * LN2 + logf(l) : -__int_as_float(0x7f800000);
  }
}

// ------------------------------------------------------------ launch

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int PT, typename TO, int GC>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  auto kern = paged_split_kernel<PT, TO, GC>;
  const size_t smem = split_smem(a.split_pages, a.page, a.d, staged_row_bytes(PT, a.d),
                                 Page<PT>::QUANT, GC);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.n_splits, a.kvh, a.b), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int PT, typename TO, int HD>
cudaError_t launch_shared(const Args& a, cudaStream_t stream) {
  const int rb = row_bytes(PT, a.d);
  constexpr bool QUANT = Page<PT>::QUANT;
  // two tile pairs (the next page decodes under this one's products) when
  // two raw stages fit beside them, else one
  int nb = 2, st = 3;
  while (st > 0 && shared_smem(HD, nb, st, rb, QUANT) > SMEM_LIMIT) {
    if (--st < 2 && nb == 2) {
      nb = 1;
      st = 3;
    }
  }
  if (st == 0) return cudaErrorInvalidValue;
  auto kern = paged_shared_kernel<PT, TO, HD>;
  const size_t smem = shared_smem(HD, nb, st, rb, QUANT);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)a.b * a.g + SH_PAGE - 1) / SH_PAGE;
  kern<<<dim3((unsigned)tiles, a.kvh), NT, smem, stream>>>(a, nb, st);
  return cudaGetLastError();
}

template <int PT, typename TO>
cudaError_t by_route(int route, const Args& a, cudaStream_t stream) {
  const int d = a.d;
  if (route == SPLIT) {
    if (a.g <= 1) return launch_split<PT, TO, 1>(a, stream);
    if (a.g <= 2) return launch_split<PT, TO, 2>(a, stream);
    if (a.g <= 4) return launch_split<PT, TO, 4>(a, stream);
    return launch_split<PT, TO, 8>(a, stream);
  }
  if (d <= 64) return launch_shared<PT, TO, 64>(a, stream);
  if (d <= 128) return launch_shared<PT, TO, 128>(a, stream);
  return launch_shared<PT, TO, 256>(a, stream);
}

template <typename TO>
cudaError_t by_page(int page_type, int route, const Args& a, cudaStream_t stream) {
  switch (page_type) {
    case PT_F32: return by_route<PT_F32, TO>(route, a, stream);
    case PT_BF16: return by_route<PT_BF16, TO>(route, a, stream);
    case PT_I8: return by_route<PT_I8, TO>(route, a, stream);
    case PT_I4: return by_route<PT_I4, TO>(route, a, stream);
    case PT_E4M3: return by_route<PT_E4M3, TO>(route, a, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// q: (b, kvh, g, d) of q_dtype (0 float32, 1 bf16), unscaled: the kernel
// rounds q·qscale to bf16; new_k/new_v: (b, kvh, d) of in_dtype (0, 1) for
// the split route's fused append, else null; k/v pages: (kvh, total, page,
// row_units) of page_type (paged_page.cuh: 0 float32, 1 bf16, 2 int8, 3
// int4 in halves of d/2 bytes, 4 e4m3), written by the append, 8-byte
// aligned (16 on the shared route); scales: (kvh, total, page) f32 for the
// quantized types (2-4), else null; slots (b,), lengths (max_seqs,), page_tables
// (max_seqs, max_pages) int32; lengths_override and positions: (b,) int32
// or null; radius: the band radius, or -1 for none; d: a multiple of 8 up
// to 256; g: any group size; out: (b, kvh, g, d) of out_dtype (0 float32,
// 1 bf16); lse: (b, kvh, g) float32 or null. route: 0 split (split_pages
// pages a split, n_splits = the grid's splits; when n_splits > 1, ws_acc
// (b, kvh, n_splits, g, d) and ws_ml (b, kvh, n_splits, g, 2) float32 and
// tickets (b, kvh) int32, which this call zeroes on `stream` before its
// launch), 1 shared (page 64; every lane on slots[0]'s table row). All
// contiguous. A route that does not take the shape, or a split plan whose
// stages do not fit in shared memory, returns cudaErrorInvalidValue.
extern "C" cudaError_t tf_paged_attention(
    const void* q, const void* new_k, const void* new_v, void* k_pages, void* v_pages,
    float* k_scales, float* v_scales, const int* slots, const int* lengths,
    const int* lengths_override, const int* positions, const int* page_tables, void* out,
    float* lse, float* ws_acc, float* ws_ml, int* tickets, int b, int kvh, int g, int d,
    int page, int total_pages, int max_pages, int pages_bound, int len_add, int radius,
    int q_dtype, int in_dtype, int page_type, int out_dtype, int route, int split_pages,
    int n_splits, float qscale, cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  const bool quant = page_quantized(page_type);
  if (g < 1 || d < 8 || d > 256 || d % 8 != 0 || page < 1 || page > MAX_PAGE ||
      max_pages < 1 || pages_bound < 1 || radius < -1 || q_dtype < 0 || q_dtype > 1 ||
      !page_type_ok(page_type) || route < SPLIT || route > SHARED ||
      quant != (k_scales != nullptr && v_scales != nullptr) ||
      (new_k != nullptr) != (new_v != nullptr) || (new_k != nullptr && route != SPLIT) ||
      (new_k != nullptr && (in_dtype < 0 || in_dtype > 1)) || b > 65535 || kvh > 65535 ||
      !aligned(k_pages, 8) || !aligned(v_pages, 8))
    return cudaErrorInvalidValue;
  // the bulk copies' rules: 16-byte sizes and addresses
  const bool bulk_ok = aligned(k_pages, 16) && aligned(v_pages, 16) &&
                       (!quant || (aligned(k_scales, 16) && aligned(v_scales, 16)));
  const bool bulk = page_type != PT_F32 && bulk_ok &&
                    ((size_t)page * row_bytes(page_type, d)) % 16 == 0 &&
                    (!quant || page % 4 == 0);
  if (route == SHARED && (page != SH_PAGE || !bulk_ok)) return cudaErrorInvalidValue;
  if (route == SPLIT &&
      (split_pages < 1 || n_splits < 1 || n_splits > 65535 ||
       (long)n_splits * split_pages < pages_bound ||
       (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || tickets == nullptr))))
    return cudaErrorInvalidValue;
  if (route == SPLIT && n_splits > 1) {
    const cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(int) * (size_t)b * kvh, stream);
    if (err != cudaSuccess) return err;
  }
  const Args a{q, new_k, new_v, k_pages, v_pages, k_scales, v_scales, slots, lengths,
               lengths_override, positions, page_tables, out, lse, ws_acc, ws_ml, tickets,
               b, kvh, g, d, page, total_pages, max_pages, pages_bound, len_add, radius,
               q_dtype == 0, in_dtype == 0, split_pages, n_splits, bulk, qscale};
  if (out_dtype == 0) return by_page<float>(page_type, route, a, stream);
  if (out_dtype == 1) return by_page<bf16>(page_type, route, a, stream);
  return cudaErrorInvalidValue;
}
