"""Paged KV-cache: port of ``tpu_flash/cache/paged_cache.py``.

Pages are stored ``(kv_heads, total_pages, page_size, head_dim)``; quantized
(int8) pages carry per-token scales ``(kv_heads, total_pages, page_size)``.
Page allocation is host-side (``cache/allocator.py``); this module does the
device-side reads and writes.

Unlike the reference, whose updates are functional, every write here
updates the cache's tensors IN PLACE: ``write_chunk`` and ``append`` mutate
``self`` (and return it, so call sites read like the reference's). int4
and fp8 pages are not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_flash_torch.quant.qarray import quantize


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_kv_heads: int
    head_dim: int
    page_size: int = 64
    total_pages: int = 1024
    max_seqs: int = 64
    max_pages_per_seq: int = 128
    dtype: str = "bfloat16"  # bfloat16 | float32 | int8 (int4, fp8: A4)

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def storage_dtype(self) -> torch.dtype:
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int8": torch.int8}.get(self.dtype)
        if dt is None:
            raise NotImplementedError(
                f"cache dtype {self.dtype!r} is not ported yet (ROADMAP A4)")
        return dt


@dataclasses.dataclass
class PagedKVCache:
    """Device state of the paged cache, updated in place.

    ``page_tables[s, i]`` = physical page id of logical page ``i`` of
    sequence-slot ``s``; ``lengths[s]`` = tokens currently stored.
    """

    k_pages: torch.Tensor  # (kv_heads, total_pages, page, stor_dim)
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]  # (kv_heads, total_pages, page) or None
    v_scales: Optional[torch.Tensor]
    page_tables: torch.Tensor  # (max_seqs, max_pages_per_seq) int32
    lengths: torch.Tensor  # (max_seqs,) int32
    config: CacheConfig

    @classmethod
    def create(cls, config: CacheConfig, device="cpu") -> "PagedKVCache":
        shape = (config.num_kv_heads, config.total_pages, config.page_size,
                 config.head_dim)
        sc_shape = shape[:3]
        dt = config.storage_dtype
        quant = config.quantized

        def ones():
            return torch.ones(sc_shape, dtype=torch.float32, device=device)

        return cls(
            k_pages=torch.zeros(shape, dtype=dt, device=device),
            v_pages=torch.zeros(shape, dtype=dt, device=device),
            k_scales=ones() if quant else None,
            v_scales=ones() if quant else None,
            page_tables=torch.zeros(
                (config.max_seqs, config.max_pages_per_seq), dtype=torch.int32,
                device=device),
            lengths=torch.zeros(config.max_seqs, dtype=torch.int32,
                                device=device),
            config=config,
        )

    # -- encoding -----------------------------------------------------------

    def _encode(self, x: torch.Tensor):
        """(…, head_dim) → (values (…, stor_dim), scales (…,) | None).

        Shares the quantizer in quant/qarray.py; the append kernel's copy
        (csrc/paged_append.cu, ops/paged.py:_encode_row) must stay
        bit-identical to it.
        """
        if self.config.dtype == "int8":
            qa = quantize(x, torch.int8, axis=-1)
            return qa.values, qa.scales[..., 0]
        return x.to(self.k_pages.dtype), None

    # -- writes -------------------------------------------------------------

    def write_prompt(self, slot: int, k: torch.Tensor, v: torch.Tensor
                     ) -> "PagedKVCache":
        """Write a full prompt's K/V ``(kv_heads, prompt_len, head_dim)`` into
        sequence-slot ``slot`` and set its length to ``prompt_len``. The
        slot's page table must already cover ``ceil(prompt_len/page)``
        pages."""
        return self.write_chunk(slot, k, v, 0)

    def write_chunk(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                    offset: int, valid_n: Optional[int] = None
                    ) -> "PagedKVCache":
        """Write a page-aligned chunk ``(kv_heads, chunk_len, head_dim)`` at
        token ``offset`` and set the slot length to ``offset + valid_n``
        (default: the whole chunk). The padded tail is page-covered and
        masked by length."""
        page = self.config.page_size
        if offset % page:
            raise ValueError("chunk offset must be page-aligned")
        kh, n, _ = k.shape
        n_pad = -(-n // page) * page
        if n_pad != n:
            k = F.pad(k, (0, 0, 0, n_pad - n))
            v = F.pad(v, (0, 0, 0, n_pad - n))
        num_pages = n_pad // page
        kv_vals, k_sc = self._encode(k)
        vv_vals, v_sc = self._encode(v)
        # Pad the table row so a final chunk whose padded tail runs past the
        # slot's allocation (or past max_pages_per_seq) resolves to entry 0
        # = the trash page, never onto earlier real pages.
        row = torch.cat([self.page_tables[slot],
                         self.page_tables.new_zeros(num_pages)])
        ids = row[offset // page: offset // page + num_pages].long()
        self.k_pages[:, ids] = kv_vals.reshape(kh, num_pages, page, -1)
        self.v_pages[:, ids] = vv_vals.reshape(kh, num_pages, page, -1)
        if k_sc is not None:
            self.k_scales[:, ids] = k_sc.reshape(kh, num_pages, page)
            self.v_scales[:, ids] = v_sc.reshape(kh, num_pages, page)
        self.lengths[slot].fill_(offset + (n if valid_n is None else valid_n))
        return self

    def append(self, slots: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> "PagedKVCache":
        """Append ONE token per sequence for a batch of slots (B3).

        slots: ``(B,)`` int32; k, v: ``(B, kv_heads, head_dim)``. The
        target page must already be allocated in each slot's table.
        Increments lengths (repeated slot ids add once per lane).
        """
        from tpu_flash_torch.ops.paged import fused_append

        fused_append(self, slots, k, v)
        self.lengths.index_add_(
            0, slots.long(), torch.ones_like(slots, dtype=self.lengths.dtype))
        return self

    # -- reads (oracle path) --------------------------------------------------

    def gather_kv(self, slot: int, max_len: int):
        """Reassemble a slot's K/V as f32 ``(kv_heads, max_len, head_dim)``
        (dequantized) — the oracle-side read used in tests."""
        cfg = self.config
        num_pages = -(-max_len // cfg.page_size)
        ids = self.page_tables[slot, :num_pages].long()
        k = self.k_pages[:, ids].float()  # (kh, np, page, stor)
        v = self.v_pages[:, ids].float()
        if cfg.quantized:
            k = k * self.k_scales[:, ids][..., None]
            v = v * self.v_scales[:, ids][..., None]
        kh = cfg.num_kv_heads
        k = k.reshape(kh, -1, cfg.head_dim)[:, :max_len]
        v = v.reshape(kh, -1, cfg.head_dim)[:, :max_len]
        return k, v
