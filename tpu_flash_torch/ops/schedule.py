"""Block schedules: which KV blocks each Q block visits, and in-block masks.

Port of ``tpu_flash/ops/schedule.py`` for the dense and causal schedules.
The block-visit math is host-side Python on ints; :meth:`Schedule.mask`
takes torch tensors of global positions. The CUDA forward kernel's launcher
takes its grid and its causal offset from a schedule built at the kernel's
own tile sizes, and the plain path takes its mask from the same object, so
the two cannot disagree on which keys a query sees.
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
