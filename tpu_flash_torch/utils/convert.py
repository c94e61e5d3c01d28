"""Convert the reference package's state into the port's.

The reference's parameter trees and caches are handed over as numpy arrays
(``np.asarray`` of each leaf), so this module needs nothing from the
reference's framework. bfloat16 arrays (ml_dtypes) go through a ``uint16``
view, because ``torch.from_numpy`` rejects them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy (or array-like) → torch tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor → numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_tree(tree, device="cpu"):
    """The reference's parameter tree (dicts/lists of arrays) → the port's
    parameter dict, same keys and layouts."""
    if isinstance(tree, dict):
        return {k: params_from_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_tree(v, device) for v in tree]
    return to_torch(tree, device)


def cache_from_reference(cache, device="cpu") -> PagedKVCache:
    """A reference ``PagedKVCache`` (any object with its fields; leaves are
    read with ``np.asarray``) → the port's cache, bit for bit."""
    cfg = CacheConfig(**dataclasses.asdict(cache.config))

    def conv(x):
        return None if x is None else to_torch(np.asarray(x), device)

    return PagedKVCache(
        k_pages=conv(cache.k_pages), v_pages=conv(cache.v_pages),
        k_scales=conv(cache.k_scales), v_scales=conv(cache.v_scales),
        page_tables=conv(cache.page_tables), lengths=conv(cache.lengths),
        config=cfg,
    )
