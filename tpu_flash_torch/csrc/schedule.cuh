// The attention schedules that B1 (flash_fwd.cu) and B4/B5 (flash_bwd.cu)
// walk, on the global positions of a (q row, kv row) pair: the kind codes
// of ops/flash.py:_KIND, which keys a query sees (visible, and as an
// interval key_span; the queries a key is seen by, query_span), the kv
// tiles a q tile visits (kv_range), the q tiles that see a kv tile
// (q_range, the transposed visit that B5 walks), and the test that lets a
// tile skip the per-element mask (tile_full). Kinds: 0 dense; 1 causal, right-aligned
// (key j visible to query i when j <= i + offset); 2 local, |i - j| <=
// radius; 3 local_causal, the band and j <= i; 4 circulant over the
// halo-extended K/V (0 <= j - i <= 2·radius); 5 block-diagonal, i / section
// == j / section. Positions past n_kv are never visible.
//
// Everything sits in an anonymous namespace, as in hopper.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

enum Kind { DENSE = 0, CAUSAL = 1, LOCAL = 2, LOCAL_CAUSAL = 3, CIRCULANT = 4,
            BLOCK = 5 };

struct Sched {
  int n_q, n_kv, kind, offset, radius, section;
};

// key kpos visible to query qpos under the schedule
__device__ __forceinline__ bool visible(const Sched& s, int qpos, int kpos) {
  if (kpos >= s.n_kv) return false;
  if (s.kind == CAUSAL) return kpos <= qpos + s.offset;
  if (s.kind == CIRCULANT) return kpos >= qpos && kpos - qpos <= 2 * s.radius;
  if (s.kind == BLOCK) return kpos / s.section == qpos / s.section;
  if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    const int dist = qpos - kpos;
    if (dist > s.radius || -dist > s.radius) return false;
    if (s.kind == LOCAL_CAUSAL) return kpos <= qpos;
  }
  return true;
}

// kv tiles [first, last] (of bkv rows) that q rows [q0, q_last] visit
// (inclusive; last < first: none)
__device__ __forceinline__ void kv_range(const Sched& s, int q0, int q_last, int bkv,
                                         int& first, int& last) {
  first = 0;
  last = (s.n_kv + bkv - 1) / bkv - 1;
  if (s.kind == CAUSAL) {
    const int last_k = q_last + s.offset;
    last = last_k < 0 ? -1 : min(last, last_k / bkv);
  } else if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    first = max(0, q0 - s.radius) / bkv;
    last = min(last, (q_last + s.radius) / bkv);
    if (s.kind == LOCAL_CAUSAL) last = min(last, q_last / bkv);
  } else if (s.kind == CIRCULANT) {
    first = q0 / bkv;
    last = min(last, (q_last + 2 * s.radius) / bkv);
  } else if (s.kind == BLOCK) {
    first = (q0 / s.section) * s.section / bkv;
    last = min(last, ((q_last / s.section + 1) * s.section - 1) / bkv);
  }
}

// kv rows [k0, k_hi] wholly visible to every query row of [q0, q_last]:
// no per-element mask
__device__ __forceinline__ bool tile_full(const Sched& s, int k0, int k_hi, int q0,
                                          int q_last) {
  bool full = k_hi < s.n_kv;
  if (s.kind == CAUSAL) {
    full = full && k_hi <= q0 + s.offset;
  } else if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    full = full && k_hi - q0 <= s.radius && q_last - k0 <= s.radius;
    if (s.kind == LOCAL_CAUSAL) full = full && k_hi <= q0;
  } else if (s.kind == CIRCULANT) {
    full = full && k0 >= q_last && k_hi - q0 <= 2 * s.radius;
  } else if (s.kind == BLOCK) {
    const int sec = q0 / s.section;
    full = full && q_last / s.section == sec && k0 / s.section == sec &&
           k_hi / s.section == sec;
  }
  return full;
}

// the keys [lo, hi] that query qpos sees (every kind's visible set is an
// interval; empty, hi < lo, for a query outside [0, n_q)): visible(s, qpos,
// k) holds exactly for lo <= k <= hi
__device__ __forceinline__ void key_span(const Sched& s, int qpos, int& lo, int& hi) {
  lo = 0;
  hi = qpos < 0 || qpos >= s.n_q ? -1 : s.n_kv - 1;
  if (s.kind == CAUSAL) {
    hi = min(hi, qpos + s.offset);
  } else if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    lo = max(lo, qpos - s.radius);
    hi = min(hi, s.kind == LOCAL ? qpos + s.radius : qpos);
  } else if (s.kind == CIRCULANT) {
    lo = max(lo, qpos);
    hi = min(hi, qpos + 2 * s.radius);
  } else if (s.kind == BLOCK) {
    lo = max(lo, qpos / s.section * s.section);
    hi = min(hi, (qpos / s.section + 1) * s.section - 1);
  }
}

// the queries [lo, hi] that see key kpos, clipped to [0, n_q) (empty for a
// key outside [0, n_kv)): the transposed visit of one key
__device__ __forceinline__ void query_span(const Sched& s, int kpos, int& lo, int& hi) {
  lo = 0;
  hi = kpos < 0 || kpos >= s.n_kv ? -1 : s.n_q - 1;
  if (s.kind == CAUSAL) {
    lo = max(lo, kpos - s.offset);
  } else if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    lo = max(lo, s.kind == LOCAL ? kpos - s.radius : kpos);
    hi = min(hi, kpos + s.radius);
  } else if (s.kind == CIRCULANT) {
    lo = max(lo, kpos - 2 * s.radius);
    hi = min(hi, kpos);
  } else if (s.kind == BLOCK) {
    lo = max(lo, kpos / s.section * s.section);
    hi = min(hi, (kpos / s.section + 1) * s.section - 1);
  }
}

// q tiles [first, last] (of bq rows) holding a query that sees a key of
// [k0, k_hi], k_hi < n_kv (inclusive; last < first: none): B5's transposed
// visit, the q_block_index/q_step_needed of ops/schedule.py's schedules.
// Both ends of query_span grow with the key and the spans of neighbouring
// keys meet, so the tile's queries are [lo of k0, hi of k_hi]: dense all;
// causal q >= k0 - offset; local [k0 - r, k_hi + r]; local_causal [k0,
// k_hi + r]; circulant (halo coordinates) [k0 - 2r, k_hi]; block the
// sections of k0 and k_hi.
__device__ __forceinline__ void q_range(const Sched& s, int k0, int k_hi, int bq, int& first,
                                        int& last) {
  int lo, hi, lo_hi, hi_hi;
  query_span(s, k0, lo, hi);
  query_span(s, k_hi, lo_hi, hi_hi);
  first = lo / bq;
  last = lo > hi_hi ? first - 1 : hi_hi / bq;
}

}  // namespace
