"""Block schedules: which KV blocks each Q block visits, and in-block masks.

Port of ``tpu_flash/ops/schedule.py``: the dense, causal, local
(sliding-band), block-diagonal, circulant and ring-hop (shifted)
schedules. The block-visit math is host-side
Python on ints; :meth:`Schedule.mask` takes torch tensors of global
positions. The CUDA forward kernel's launcher takes its kind, causal
offset, band radius and section from the schedule, and the plain path
takes its mask from the same object (:meth:`Schedule.visible`), so the two
cannot disagree on which keys a query sees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base: dense (every Q block visits every KV block).

    ``n_q``/``n_kv`` are the real (unpadded) lengths; ``n_q_pad``/
    ``n_kv_pad`` the lengths rounded up to whole blocks. Positions passed to
    :meth:`mask` are global coordinates.
    """

    n_q: int
    n_kv: int
    block_q: int
    block_kv: int

    @property
    def n_q_pad(self) -> int:
        return cdiv(self.n_q, self.block_q) * self.block_q

    @property
    def n_kv_pad(self) -> int:
        return cdiv(self.kv_len, self.block_kv) * self.block_kv

    @property
    def kv_len(self) -> int:
        return self.n_kv

    @property
    def num_q_blocks(self) -> int:
        return cdiv(self.n_q, self.block_q)

    @property
    def num_kv_blocks(self) -> int:
        return cdiv(self.kv_len, self.block_kv)

    @property
    def max_kv_steps(self) -> int:
        return self.num_kv_blocks

    def kv_block_index(self, i: int, s: int) -> int:
        return s

    def step_needed(self, i: int, s: int) -> bool:
        return True

    @property
    def max_q_steps(self) -> int:
        return self.num_q_blocks

    def q_block_index(self, j: int, s: int) -> int:
        return s

    def q_step_needed(self, j: int, s: int) -> bool:
        return True

    @property
    def has_mask(self) -> bool:
        return self.kv_len % self.block_kv != 0

    def mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.has_mask:
            return None
        return k_pos < self.kv_len

    def visible(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        """Which keys each query sees over the whole score matrix (None: all
        of them). The mask, except where the schedule leaves unvisited tiles
        unmasked (block-diagonal)."""
        return self.mask(q_pos, k_pos)

    def block_unmasked(self, i: int, s: int) -> Optional[bool]:
        """True when tile (i, s) has no masked element; None when the
        schedule has no mask at all."""
        if not self.has_mask:
            return None
        return self._kv_pad_ok(self.kv_block_index(i, s))

    def _kv_pad_ok(self, kv_idx: int) -> bool:
        if self.kv_len % self.block_kv == 0:
            return True
        return (kv_idx + 1) * self.block_kv <= self.kv_len

    def _and_kv_pad(self, m: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        if self.kv_len % self.block_kv != 0:
            m = m & (k_pos < self.kv_len)
        return m


DenseSchedule = Schedule


@dataclasses.dataclass(frozen=True)
class CausalSchedule(Schedule):
    """Lower-triangular attention; trailing KV blocks are skipped entirely.

    With ``n_q < n_kv`` the triangle is right-aligned (query ``i`` sees keys
    ``j ≤ i + n_kv - n_q``), the convention used for decode steps.
    """

    @property
    def _offset(self) -> int:
        return self.n_kv - self.n_q

    def _last_step(self, i: int) -> int:
        # Last KV block index holding a key visible to Q block i (negative
        # when n_q > n_kv and the block sees no key at all).
        last_q = min((i + 1) * self.block_q - 1, self.n_q - 1)
        return (last_q + self._offset) // self.block_kv

    def kv_block_index(self, i: int, s: int) -> int:
        return max(0, min(min(s, self._last_step(i)), self.num_kv_blocks - 1))

    def step_needed(self, i: int, s: int) -> bool:
        return s <= self._last_step(i)

    def _first_q_block(self, j: int) -> int:
        first = (j * self.block_kv - self._offset) // self.block_q
        return max(0, min(first, self.num_q_blocks - 1))

    def q_block_index(self, j: int, s: int) -> int:
        return min(self._first_q_block(j) + s, self.num_q_blocks - 1)

    def q_step_needed(self, j: int, s: int) -> bool:
        return self._first_q_block(j) + s <= self.num_q_blocks - 1

    @property
    def has_mask(self) -> bool:
        return True

    def mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        return self._and_kv_pad(k_pos <= q_pos + self._offset, k_pos)

    def block_unmasked(self, i: int, s: int) -> bool:
        j = self.kv_block_index(i, s)
        full = (j + 1) * self.block_kv - 1 <= i * self.block_q + self._offset
        return full and self._kv_pad_ok(j)


@dataclasses.dataclass(frozen=True)
class LocalSchedule(Schedule):
    """Sliding-window band: query ``i`` sees keys ``|i - j| ≤ radius``
    (clamped at the sequence edges, no wraparound; left-aligned, so no
    offset when ``n_q ≠ n_kv``). ``causal=True`` also restricts to
    ``j ≤ i``."""

    radius: int = 0
    causal: bool = False

    def __post_init__(self):
        if self.radius < 0:
            raise ValueError("radius must be ≥ 0")

    def _first_step(self, i: int) -> int:
        return max(0, (i * self.block_q - self.radius) // self.block_kv)

    def _last_block(self, i: int) -> int:
        last_q = min((i + 1) * self.block_q - 1, self.n_q - 1)
        return min(self.num_kv_blocks - 1,
                   (last_q + self.radius) // self.block_kv)

    @property
    def max_kv_steps(self) -> int:
        # exact: the widest per-block visit, not a cdiv(span) + 1 bound
        return max([1] + [self._last_block(i) - self._first_step(i) + 1
                          for i in range(self.num_q_blocks)])

    def kv_block_index(self, i: int, s: int) -> int:
        return min(self._first_step(i) + s, self._last_block(i))

    def step_needed(self, i: int, s: int) -> bool:
        return self._first_step(i) + s <= self._last_block(i)

    def _first_q_block(self, j: int) -> int:
        lo = j * self.block_kv - (0 if self.causal else self.radius)
        return min(max(lo // self.block_q, 0), self.num_q_blocks - 1)

    def _last_q_block(self, j: int) -> int:
        hi = (j + 1) * self.block_kv - 1 + self.radius
        return min(self.num_q_blocks - 1, hi // self.block_q)

    @property
    def max_q_steps(self) -> int:
        return max([1] + [self._last_q_block(j) - self._first_q_block(j) + 1
                          for j in range(self.num_kv_blocks)])

    def q_block_index(self, j: int, s: int) -> int:
        return min(self._first_q_block(j) + s, self._last_q_block(j))

    def q_step_needed(self, j: int, s: int) -> bool:
        return self._first_q_block(j) + s <= self._last_q_block(j)

    @property
    def has_mask(self) -> bool:
        return True

    def mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        m = (q_pos - k_pos).abs() <= self.radius
        if self.causal:
            m = m & (k_pos <= q_pos)
        return self._and_kv_pad(m, k_pos)

    def block_unmasked(self, i: int, s: int) -> bool:
        # every key of the tile within the band of every real query row
        j = self.kv_block_index(i, s)
        q_lo = i * self.block_q
        q_hi = min((i + 1) * self.block_q - 1, self.n_q - 1)
        k_lo, k_hi = j * self.block_kv, (j + 1) * self.block_kv - 1
        full = k_hi - q_lo <= self.radius and q_hi - k_lo <= self.radius
        if self.causal:
            full = full and k_hi <= q_lo
        return full and self._kv_pad_ok(j)


@dataclasses.dataclass(frozen=True)
class BlockDiagonalSchedule(Schedule):
    """Disjoint block-diagonal attention: query ``i`` sees the keys of its
    own ``section``-sized chunk. Only the diagonal blocks are visited, so
    the in-tile :meth:`mask` is needed only for a partial trailing section
    or kv padding; :meth:`visible` always holds the section rule.

    Requires ``section % block_q == 0 and section % block_kv == 0`` (the
    wrapper picks conforming block sizes).
    """

    section: int = 0

    def __post_init__(self):
        if self.section <= 0:
            raise ValueError("section must be positive")
        if self.section % self.block_q or self.section % self.block_kv:
            raise ValueError(
                f"section {self.section} must be a multiple of block_q "
                f"{self.block_q} and block_kv {self.block_kv}")

    @property
    def max_kv_steps(self) -> int:
        return self.section // self.block_kv

    def _kv_raw(self, i: int, s: int) -> int:
        section_idx = (i * self.block_q) // self.section
        return section_idx * (self.section // self.block_kv) + s

    def kv_block_index(self, i: int, s: int) -> int:
        return min(self._kv_raw(i, s), self.num_kv_blocks - 1)

    def step_needed(self, i: int, s: int) -> bool:
        return self._kv_raw(i, s) < self.num_kv_blocks

    @property
    def max_q_steps(self) -> int:
        return self.section // self.block_q

    def _q_raw(self, j: int, s: int) -> int:
        section_idx = (j * self.block_kv) // self.section
        return section_idx * (self.section // self.block_q) + s

    def q_block_index(self, j: int, s: int) -> int:
        return min(self._q_raw(j, s), self.num_q_blocks - 1)

    def q_step_needed(self, j: int, s: int) -> bool:
        return self._q_raw(j, s) < self.num_q_blocks

    @property
    def has_mask(self) -> bool:
        # a partial trailing section needs the padding mask
        return self.kv_len % self.block_kv != 0 or self.n_q % self.section != 0

    def _same_section(self, q_pos, k_pos):
        return self._and_kv_pad((q_pos // self.section) == (k_pos // self.section),
                                k_pos)

    def mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.has_mask:
            return None
        return self._same_section(q_pos, k_pos)

    def visible(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        return self._same_section(q_pos, k_pos)


@dataclasses.dataclass(frozen=True)
class CirculantSchedule(Schedule):
    """Wraparound band over halo-extended K/V: the kernel runs against
    ``k_ext = cat([k[-radius:], k, k[:radius]])`` (length ``n_kv + 2·radius``)
    and query ``i`` attends extended positions ``[i, i + 2·radius]``, a
    contiguous band, so the mod-n seam never appears inside the kernel."""

    radius: int = 0

    def __post_init__(self):
        if self.radius < 0:
            raise ValueError("radius must be ≥ 0")
        if 2 * self.radius + 1 > self.n_kv:
            raise ValueError("circulant window larger than sequence")

    @property
    def kv_len(self) -> int:
        return self.n_kv + 2 * self.radius

    def _first_step(self, i: int) -> int:
        return (i * self.block_q) // self.block_kv

    def _last_block(self, i: int) -> int:
        last_q = min((i + 1) * self.block_q - 1, self.n_q - 1)
        return min(self.num_kv_blocks - 1,
                   (last_q + 2 * self.radius) // self.block_kv)

    @property
    def max_kv_steps(self) -> int:
        # exact: the widest per-block visit
        return max([1] + [self._last_block(i) - self._first_step(i) + 1
                          for i in range(self.num_q_blocks)])

    def kv_block_index(self, i: int, s: int) -> int:
        return min(self._first_step(i) + s, self._last_block(i))

    def step_needed(self, i: int, s: int) -> bool:
        return self._first_step(i) + s <= self._last_block(i)

    def _first_q_block(self, j: int) -> int:
        # extended kv position j is seen by queries i ∈ [j − 2r, j]
        lo = (j * self.block_kv - 2 * self.radius) // self.block_q
        return min(max(lo, 0), self.num_q_blocks - 1)

    def _last_q_block(self, j: int) -> int:
        hi = ((j + 1) * self.block_kv - 1) // self.block_q
        return min(max(hi, 0), self.num_q_blocks - 1)

    @property
    def max_q_steps(self) -> int:
        return max([1] + [self._last_q_block(j) - self._first_q_block(j) + 1
                          for j in range(self.num_kv_blocks)])

    def q_block_index(self, j: int, s: int) -> int:
        return min(self._first_q_block(j) + s, self._last_q_block(j))

    def q_step_needed(self, j: int, s: int) -> bool:
        return self._first_q_block(j) + s <= self._last_q_block(j)

    @property
    def has_mask(self) -> bool:
        return True

    def mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        delta = k_pos - q_pos
        return self._and_kv_pad((delta >= 0) & (delta <= 2 * self.radius),
                                k_pos)

    def block_unmasked(self, i: int, s: int) -> bool:
        # delta = k − q ∈ [0, 2r] over the whole tile (real q rows only)
        j = self.kv_block_index(i, s)
        q_lo = i * self.block_q
        q_hi = min((i + 1) * self.block_q - 1, self.n_q - 1)
        k_lo, k_hi = j * self.block_kv, (j + 1) * self.block_kv - 1
        full = k_lo >= q_hi and k_hi - q_lo <= 2 * self.radius
        return full and self._kv_pad_ok(j)


@dataclasses.dataclass(frozen=True)
class ShiftedMaskSchedule(Schedule):
    """Dense iteration with a mask over globally shifted coordinates: the
    ring-attention hop schedule. Query ``i`` sits at ``qg = i + shift``,
    key ``j`` at ``j``; ``radius ≥ 0`` keeps the band ``|qg − j| ≤ radius``
    (mod ``wrap_n`` when ``wrap_n > 0``, the circulant ring), ``radius`` −1
    no band; ``causal`` also requires ``j ≤ qg``. With ``wrap_n`` the band
    a query sees in a shard may be two runs of keys (both ends of the
    circle)."""

    shift: int = 0
    radius: int = -1
    wrap_n: int = 0
    causal: bool = False

    @property
    def has_mask(self) -> bool:
        return True

    def mask(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        qg = q_pos + self.shift
        m = None
        if self.radius >= 0:
            if self.wrap_n > 0:
                delta = torch.remainder(qg - k_pos, self.wrap_n)
                m = (delta <= self.radius) | (delta >= self.wrap_n - self.radius)
            else:
                m = (qg - k_pos).abs() <= self.radius
        if self.causal:
            c = k_pos <= qg
            m = c if m is None else m & c
        if m is None:
            m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                           dtype=torch.bool, device=q_pos.device)
        return self._and_kv_pad(m, k_pos)

    def block_unmasked(self, i: int, s: int) -> bool:
        j = self.kv_block_index(i, s)
        q_lo = i * self.block_q + self.shift
        q_hi = min((i + 1) * self.block_q - 1, self.n_q - 1) + self.shift
        k_lo, k_hi = j * self.block_kv, (j + 1) * self.block_kv - 1
        full = self._kv_pad_ok(j)
        if self.radius >= 0:
            if self.wrap_n > 0:
                # the tile's deltas k − qg fill [k_lo − q_hi, that + width];
                # all inside the wrapped band [−r, r] iff the run shifted to
                # the band's start stays within it
                lo = k_lo - q_hi
                width = (k_hi - k_lo) + (q_hi - q_lo)
                full = full and (lo + self.radius) % self.wrap_n + width \
                    <= 2 * self.radius
            else:
                full = (full and k_hi - q_lo <= self.radius
                        and q_hi - k_lo <= self.radius)
        if self.causal:
            full = full and k_hi <= q_lo
        return full


def band_hull(lo: int, width: int, wrap_n: int, length: int) -> tuple[int, int]:
    """Positions of ``[0, length)`` congruent (mod ``wrap_n``; none: equal)
    to one of ``[lo, lo + width)``, as their hull ``(first, last)``;
    ``last < first``: none (``csrc/schedule.cuh:band_arcs``)."""
    if wrap_n <= 0:
        return max(0, lo), min(length - 1, lo + width - 1)
    if width >= wrap_n:
        return 0, length - 1
    c = lo % wrap_n
    end = c + width - 1
    if end < wrap_n:
        return c, min(end, length - 1)
    return 0, length - 1 if c < length else min(end - wrap_n, length - 1)


def kv_tile_range(sched: Schedule, n_kv: int, q0: int, q_last: int,
                  bkv: int) -> tuple[int, int]:
    """The kv tiles ``[first, last]`` (of ``bkv`` rows over ``n_kv`` keys,
    the kv tensor's length: the halo-extended one for the circulant) that
    the CUDA kernels visit for q rows ``[q0, q_last]``
    (``csrc/schedule.cuh:kv_range``); ``last < first``: none. Plain
    versions that walk the kernels' tiles take their visits from here."""
    first, last = 0, cdiv(n_kv, bkv) - 1
    if isinstance(sched, CausalSchedule):
        last_k = q_last + sched._offset
        last = -1 if last_k < 0 else min(last, last_k // bkv)
    elif isinstance(sched, LocalSchedule):
        first = max(0, q0 - sched.radius) // bkv
        last = min(last, (q_last + sched.radius) // bkv)
        if sched.causal:
            last = min(last, q_last // bkv)
    elif isinstance(sched, CirculantSchedule):
        first = q0 // bkv
        last = min(last, (q_last + 2 * sched.radius) // bkv)
    elif isinstance(sched, BlockDiagonalSchedule):
        first = q0 // sched.section * sched.section // bkv
        last = min(last, ((q_last // sched.section + 1) * sched.section - 1)
                   // bkv)
    elif isinstance(sched, ShiftedMaskSchedule):
        lo, hi = 0, n_kv - 1
        if sched.radius >= 0:
            lo, hi = band_hull(q0 + sched.shift - sched.radius,
                               2 * sched.radius + 1 + q_last - q0,
                               sched.wrap_n, n_kv)
        if sched.causal:
            hi = min(hi, q_last + sched.shift)
        if hi < lo:
            return 0, -1
        first, last = lo // bkv, min(last, hi // bkv)
    elif type(sched) is not Schedule:
        raise NotImplementedError(f"no kernel visit for {type(sched).__name__}")
    return first, last
