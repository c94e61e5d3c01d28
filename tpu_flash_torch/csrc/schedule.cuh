// The attention schedules that B1 (flash_fwd.cu), B4/B5 (flash_bwd.cu) and
// B6/B7 (quant_attention.cu) walk, on the global positions of a (q row, kv
// row) pair: the kind codes of ops/flash.py:_KIND, which keys a query sees
// (visible, and as at most two intervals key_span; the queries a key is
// seen by, query_span), the kv tiles a q tile visits (kv_range), the q
// tiles that see a kv tile (q_range, the transposed visit that B5 walks),
// and the test that lets a tile skip the per-element mask (tile_full).
// Kinds: 0 dense; 1 causal, right-aligned (key j visible to query i when j
// <= i + offset); 2 local, |i - j| <= radius; 3 local_causal, the band and
// j <= i; 4 circulant over the halo-extended K/V (0 <= j - i <= 2·radius);
// 5 block-diagonal, i / section == j / section; 6 shifted, the ring hop:
// query i sits at qg = i + offset, and radius >= 0 keeps |qg - j| <= radius
// (radius -1: no band), taken mod section when section > 0 (the circulant
// ring's wrap_n, which is then at least n_q and n_kv); 7 shifted_causal,
// kind 6 and j <= qg. Positions past n_kv are never visible. A wrapped band
// reaches a shard at both ends of the circle, so its keys are two runs:
// every span here is two intervals, the second empty for the other kinds.
// Shifts and band ends may be negative: the wrap uses a floor modulo, and
// no negative position is divided.
//
// Everything sits in an anonymous namespace, as in hopper.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

enum Kind { DENSE = 0, CAUSAL = 1, LOCAL = 2, LOCAL_CAUSAL = 3, CIRCULANT = 4,
            BLOCK = 5, SHIFTED = 6, SHIFTED_CAUSAL = 7 };

struct Sched {
  int n_q, n_kv, kind, offset, radius, section;
};

__host__ __device__ __forceinline__ bool shifted(const Sched& s) {
  return s.kind == SHIFTED || s.kind == SHIFTED_CAUSAL;
}

// the arguments a launch takes: a known kind, a band radius >= 0 (>= -1
// under the shifted kinds), a block section > 0, a wrap at least as long as
// the q and kv lengths
__host__ __device__ __forceinline__ bool sched_ok(const Sched& s) {
  if (shifted(s))
    return s.radius >= -1 && s.section >= 0 &&
           (s.section == 0 || (s.n_q <= s.section && s.n_kv <= s.section));
  return s.kind >= DENSE && s.kind <= BLOCK && s.radius >= 0 &&
         (s.kind != BLOCK || s.section > 0);
}

__device__ __forceinline__ int floor_mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// positions x in [lo, hi] or in [lo2, hi2] (the second empty but for a
// wrapped band)
struct Span {
  int lo, hi, lo2, hi2;
};

__device__ __forceinline__ bool in_span(const Span& sp, int x) {
  return (x >= sp.lo && x <= sp.hi) || (x >= sp.lo2 && x <= sp.hi2);
}

// the positions of [0, len) congruent (mod wrap, or equal when wrap is 0)
// to one of [lo, lo + width): at most two intervals, the one that starts
// at 0 first
__device__ __forceinline__ Span band_arcs(int lo, int width, int wrap, int len) {
  Span sp{max(0, lo), min(len - 1, lo + width - 1), 1, 0};
  if (wrap <= 0) return sp;
  if (width >= wrap) return Span{0, len - 1, 1, 0};
  const int c = floor_mod(lo, wrap), end = c + width - 1;
  if (end < wrap) return Span{c, min(end, len - 1), 1, 0};
  return Span{0, min(end - wrap, len - 1), c, len - 1};
}

// a span's hull [lo, hi] (hi < lo: empty)
__device__ __forceinline__ void hull(const Span& sp, int& lo, int& hi) {
  const bool a = sp.hi >= sp.lo, b = sp.hi2 >= sp.lo2;
  lo = a ? sp.lo : sp.lo2;
  hi = b ? sp.hi2 : sp.hi;
  if (!a && !b) hi = lo - 1;
}

// key kpos visible to query qpos under the schedule
__device__ __forceinline__ bool visible(const Sched& s, int qpos, int kpos) {
  if (kpos >= s.n_kv) return false;
  if (shifted(s)) {
    const int qg = qpos + s.offset;
    if (s.kind == SHIFTED_CAUSAL && kpos > qg) return false;
    if (s.radius < 0) return true;
    if (s.section > 0) {
      const int delta = floor_mod(qg - kpos, s.section);
      return delta <= s.radius || delta >= s.section - s.radius;
    }
    return qg - kpos <= s.radius && kpos - qg <= s.radius;
  }
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
  if (shifted(s)) {
    // the hull of the keys the rows see: the band of [q0, q_last] widened
    // by the tile's height (visiting all of a shard is the reference's own
    // dense visit); the causal kind stops at q_last + shift
    int lo = 0, hi = s.n_kv - 1;
    if (s.radius >= 0)
      hull(band_arcs(q0 + s.offset - s.radius, 2 * s.radius + 1 + q_last - q0, s.section,
                     s.n_kv),
           lo, hi);
    if (s.kind == SHIFTED_CAUSAL) hi = min(hi, q_last + s.offset);
    if (hi < lo) {
      last = -1;
    } else {
      first = lo / bkv;
      last = min(last, hi / bkv);
    }
  } else if (s.kind == CAUSAL) {
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
  if (shifted(s)) {
    const int qg0 = q0 + s.offset, qg_last = q_last + s.offset;
    if (s.radius >= 0 && s.section > 0) {
      // the tile's deltas k - qg fill [k0 - qg_last, that + width]: inside
      // the wrapped band [-r, r] iff the run moved to the band's start
      // stays in it (the reference's block_unmasked)
      const int width = (k_hi - k0) + (q_last - q0);
      full = full && floor_mod(k0 - qg_last + s.radius, s.section) + width <= 2 * s.radius;
    } else if (s.radius >= 0) {
      full = full && k_hi - qg0 <= s.radius && qg_last - k0 <= s.radius;
    }
    if (s.kind == SHIFTED_CAUSAL) full = full && k_hi <= qg0;
  } else if (s.kind == CAUSAL) {
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

// the keys that query qpos sees (empty for a query outside [0, n_q)):
// visible(s, qpos, k) holds exactly for k in the span. One interval for
// every kind but a wrapped shifted band, which may take two.
__device__ __forceinline__ Span key_span(const Sched& s, int qpos) {
  Span sp{0, qpos < 0 || qpos >= s.n_q ? -1 : s.n_kv - 1, 1, 0};
  if (sp.hi < 0) return sp;
  if (shifted(s)) {
    const int qg = qpos + s.offset;
    if (s.radius >= 0) sp = band_arcs(qg - s.radius, 2 * s.radius + 1, s.section, s.n_kv);
    if (s.kind == SHIFTED_CAUSAL) {
      sp.hi = min(sp.hi, qg);
      sp.hi2 = min(sp.hi2, qg);
    }
  } else if (s.kind == CAUSAL) {
    sp.hi = min(sp.hi, qpos + s.offset);
  } else if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    sp.lo = max(sp.lo, qpos - s.radius);
    sp.hi = min(sp.hi, s.kind == LOCAL ? qpos + s.radius : qpos);
  } else if (s.kind == CIRCULANT) {
    sp.lo = max(sp.lo, qpos);
    sp.hi = min(sp.hi, qpos + 2 * s.radius);
  } else if (s.kind == BLOCK) {
    sp.lo = max(sp.lo, qpos / s.section * s.section);
    sp.hi = min(sp.hi, (qpos / s.section + 1) * s.section - 1);
  }
  return sp;
}

// the queries that see key kpos, within [0, n_q) (empty for a key outside
// [0, n_kv)): the transposed visit of one key, two intervals as key_span
__device__ __forceinline__ Span query_span(const Sched& s, int kpos) {
  Span sp{0, kpos < 0 || kpos >= s.n_kv ? -1 : s.n_q - 1, 1, 0};
  if (sp.hi < 0) return sp;
  if (shifted(s)) {
    // q + shift - kpos in the band: q in kpos - shift + [-r, r]
    if (s.radius >= 0)
      sp = band_arcs(kpos - s.offset - s.radius, 2 * s.radius + 1, s.section, s.n_q);
    if (s.kind == SHIFTED_CAUSAL) {
      sp.lo = max(sp.lo, kpos - s.offset);
      sp.lo2 = max(sp.lo2, kpos - s.offset);
    }
  } else if (s.kind == CAUSAL) {
    sp.lo = max(sp.lo, kpos - s.offset);
  } else if (s.kind == LOCAL || s.kind == LOCAL_CAUSAL) {
    sp.lo = max(sp.lo, s.kind == LOCAL ? kpos - s.radius : kpos);
    sp.hi = min(sp.hi, kpos + s.radius);
  } else if (s.kind == CIRCULANT) {
    sp.lo = max(sp.lo, kpos - 2 * s.radius);
    sp.hi = min(sp.hi, kpos);
  } else if (s.kind == BLOCK) {
    sp.lo = max(sp.lo, kpos / s.section * s.section);
    sp.hi = min(sp.hi, (kpos / s.section + 1) * s.section - 1);
  }
  return sp;
}

// q tiles [first, last] (of bq rows) holding a query that sees a key of
// [k0, k_hi], k_hi < n_kv (inclusive; last < first: none): B5's transposed
// visit, the q_block_index/q_step_needed of ops/schedule.py's schedules.
// But for the shifted kinds both ends of query_span grow with the key and
// the spans of neighbouring keys meet, so the tile's queries are [lo of k0,
// hi of k_hi]: dense all; causal q >= k0 - offset; local [k0 - r, k_hi +
// r]; local_causal [k0, k_hi + r]; circulant (halo coordinates) [k0 - 2r,
// k_hi]; block the sections of k0 and k_hi. The shifted kinds take the hull
// of the band of [k0, k_hi] widened by the tile (from k0 - shift under the
// causal one).
__device__ __forceinline__ void q_range(const Sched& s, int k0, int k_hi, int bq, int& first,
                                        int& last) {
  int lo, hi;
  if (shifted(s)) {
    lo = 0;
    hi = s.n_q - 1;
    if (s.radius >= 0)
      hull(band_arcs(k0 - s.offset - s.radius, 2 * s.radius + 1 + k_hi - k0, s.section, s.n_q),
           lo, hi);
    if (s.kind == SHIFTED_CAUSAL) lo = max(lo, k0 - s.offset);
  } else {
    lo = query_span(s, k0).lo;
    hi = query_span(s, k_hi).hi;
  }
  first = max(lo, 0) / bq;
  last = lo > hi ? first - 1 : hi / bq;
}

}  // namespace
