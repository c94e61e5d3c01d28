"""Paged KV-cache: port of ``tpu_flash/cache/paged_cache.py``.

Pages are stored ``(kv_heads, total_pages, page_size, storage_head_dim)``.
Page types: bfloat16 and float32 pages hold the values; quantized pages
hold int8 (``"int8"``), float8_e4m3fn (``"fp8"`` ≡ ``"float8_e4m3fn"``) or
int4 codes packed in halves into int8 of width d/2 (``"int4"``: byte j
holds elements j and j + d/2), with per-token float32 scales
``(kv_heads, total_pages, page_size)``. Page allocation is host-side
(``cache/allocator.py``); this module does the device-side reads and
writes.

An int4 page and an int8 page of twice the head dim have the same shape
and dtype, so nothing reads the page type off the tensors: the kernels
and the plain versions take ``CacheConfig.page_type`` explicitly.

Unlike the reference, whose updates are functional, every write here
updates the cache's tensors IN PLACE: ``write_chunk`` and ``append`` mutate
``self`` (and return it, so call sites read like the reference's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_flash_torch.quant.qarray import (
    quantize,
    quantize_int4_halves,
    unpack_int4_halves,
)

# page types: their storage dtype, and whether they carry scales
PAGE_TYPES = {"float32": (torch.float32, False),
              "bfloat16": (torch.bfloat16, False),
              "int8": (torch.int8, True), "int4": (torch.int8, True),
              "fp8": (torch.float8_e4m3fn, True)}
_ALIASES = {"float8_e4m3fn": "fp8"}


def storage_width(page_type: str, head_dim: int) -> int:
    """Last dim of a page: d, or d/2 for int4 (two codes a byte)."""
    return head_dim // 2 if page_type == "int4" else head_dim


def encode(x: torch.Tensor, page_type: str):
    """(…, head_dim) → (values (…, storage width), scales (…,) | None):
    the one encode of the cache's writes and of B3's plain version, shared
    with the quantizers in quant/qarray.py; the append kernels
    (csrc/paged_page.cuh) must stay bit-identical to it."""
    if page_type == "int8":
        qa = quantize(x, torch.int8, axis=-1)
    elif page_type == "fp8":
        qa = quantize(x, torch.float8_e4m3fn, axis=-1)
    elif page_type == "int4":
        qa = quantize_int4_halves(x, axis=-1)
    else:
        return x.to(PAGE_TYPES[page_type][0]), None
    return qa.values, qa.scales[..., 0]


def decode(pages: torch.Tensor, page_type: str) -> torch.Tensor:
    """Stored values → one value an element (int4 unpacked; others as
    they are), unscaled."""
    return unpack_int4_halves(pages) if page_type == "int4" else pages


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_kv_heads: int
    head_dim: int
    page_size: int = 64
    total_pages: int = 1024
    max_seqs: int = 64
    max_pages_per_seq: int = 128
    # bfloat16 | float32 | int8 | int4 | fp8 (≡ float8_e4m3fn)
    dtype: str = "bfloat16"

    @property
    def page_type(self) -> str:
        """The page type the kernels and plain versions take: ``dtype``
        with ``float8_e4m3fn`` named ``fp8``. Other dtypes raise (the
        reference casts any other dtype string unscaled, float8_e5m2
        included; that is not a page type it quantizes, and the port does
        not take it)."""
        pt = _ALIASES.get(self.dtype, self.dtype)
        if pt not in PAGE_TYPES:
            raise ValueError(
                f"cache dtype {self.dtype!r} is not a page type: one of "
                f"{sorted(PAGE_TYPES) + sorted(_ALIASES)} (float8_e5m2 and "
                "other dtypes are not taken: the reference casts them "
                "unscaled, an accident of its storage_dtype)")
        return pt

    @property
    def quantized(self) -> bool:
        return PAGE_TYPES[self.page_type][1]

    @property
    def fp8(self) -> bool:
        return self.page_type == "fp8"

    @property
    def storage_head_dim(self) -> int:
        return storage_width(self.page_type, self.head_dim)

    @property
    def storage_dtype(self) -> torch.dtype:
        return PAGE_TYPES[self.page_type][0]


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
    def create(cls, config: CacheConfig, device="cuda") -> "PagedKVCache":
        shape = (config.num_kv_heads, config.total_pages, config.page_size,
                 config.storage_head_dim)
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
        kv_vals, k_sc = encode(k, self.config.page_type)
        vv_vals, v_sc = encode(v, self.config.page_type)
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
        k = decode(self.k_pages[:, ids], cfg.page_type).float()
        v = decode(self.v_pages[:, ids], cfg.page_type).float()
        if cfg.quantized:
            k = k * self.k_scales[:, ids][..., None]
            v = v * self.v_scales[:, ids][..., None]
        kh = cfg.num_kv_heads
        k = k.reshape(kh, -1, cfg.head_dim)[:, :max_len]
        v = v.reshape(kh, -1, cfg.head_dim)[:, :max_len]
        return k, v
