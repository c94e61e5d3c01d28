// The float32 kernels' building blocks on Hopper (sm_90a): products in
// three TF32 passes on wgmma (3×TF32), operands split into hi and lo parts,
// A's fragments loaded from shared memory into registers, and the partial
// sums that the CTAs of a thread-block cluster push into each other's
// shared memory. B4/B5 (flash_bwd_f32.cuh) and B1 (flash_fwd_f32.cuh) take
// their float32 products from here; flash_bwd_f32.cuh describes the split,
// the sums and the exchange.
//
// Everything sits in an anonymous namespace, as in hopper.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// A launch of CL-CTA clusters along x (CL 1: a plain launch) of `threads`
// threads and `smem` bytes of dynamic shared memory; refused, as an error
// the wrapper raises, where the card cannot hold one such cluster.
// clusters: the kernel's own cache of how many the card holds at once
// (asked once; -1 before).
template <int CL, typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kern)(Params...), dim3 grid, int threads, int smem,
                           cudaStream_t stream, int& clusters, Args&&... args) {
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if constexpr (CL == 1) {
    (void)clusters;
    kern<<<grid, threads, smem, stream>>>(args...);
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
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
    err = cudaLaunchKernelEx(&cfg, kern, args...);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace
