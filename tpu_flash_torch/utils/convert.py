"""Convert the reference package's state into the port's.

The reference's parameter trees and caches are handed over as numpy arrays
(``np.asarray`` of each leaf), so this module needs nothing from the
reference's framework. bfloat16 arrays (ml_dtypes) go through a ``uint16``
view, because ``torch.from_numpy`` rejects them. Every converter puts its
tensors on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.quant.qarray import QArray


# ml_dtypes arrays that torch.from_numpy rejects: (unsigned view, torch type)
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def to_torch(a, device="cuda") -> torch.Tensor:
    """numpy (or array-like) → torch tensor, bit for bit; bfloat16 and fp8
    go through an unsigned view."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name in _VIEWS:
        view, dtype = _VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(view).copy()).view(dtype).to(device)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor → numpy; bfloat16 and fp8 come back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()
    return t.numpy()


def params_from_tree(tree, device="cuda"):
    """The reference's parameter tree (dicts/lists of arrays) → the port's
    parameter dict, same keys and layouts; int8 weight-only matrices
    (``quantize_weights``' ``{"q", "s"}`` leaves) come across as int8 and
    float32."""
    if isinstance(tree, dict):
        return {k: params_from_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_tree(v, device) for v in tree]
    return to_torch(tree, device)


def qarray_from_reference(qa, device="cuda") -> QArray:
    """A reference ``QArray`` (leaves read with ``np.asarray``) → the
    port's, bit for bit, with the same ``axis``."""
    return QArray(values=to_torch(qa.values, device),
                  scales=to_torch(qa.scales, device), axis=qa.axis)


def cache_from_reference(cache, device="cuda") -> PagedKVCache:
    """A reference ``PagedKVCache`` (any object with its fields; leaves are
    read with ``np.asarray``) → the port's cache, bit for bit: every page
    type (int4 pages are the same halves-packed int8; fp8 pages go through
    their bytes, as :func:`to_torch` takes them)."""
    cfg = CacheConfig(**dataclasses.asdict(cache.config))

    def conv(x):
        return None if x is None else to_torch(np.asarray(x), device)

    return PagedKVCache(
        k_pages=conv(cache.k_pages), v_pages=conv(cache.v_pages),
        k_scales=conv(cache.k_scales), v_scales=conv(cache.v_scales),
        page_tables=conv(cache.page_tables), lengths=conv(cache.lengths),
        config=cfg,
    )
