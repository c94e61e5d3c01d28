"""Tensor-parallel slices of the model and the paged cache over a mesh
``model`` axis: port of ``tpu_flash/parallel/shardings.py``.

Megatron-style, as the reference: attention heads and the MLP hidden dim
split over the axis (column-parallel ``wq``/``wk``/``wv``/``w_gate``/
``w_up``, row-parallel ``wo``/``w_down``), one sum over the axis after
each row-parallel product (``models/transformer.py``, ``tp=``), and the
paged cache split over its kv heads so each rank stores and attends only
its own heads' pages. The reference's ``PartitionSpec`` trees become
functions that give rank ``r`` of ``R`` its slices: what its
``NamedSharding`` puts on device ``r``. int8 weight-only entries
(``{"q", "s"}``) split their per-column scales with the columns; a
row-parallel entry's scales index the unsplit output dim and are
replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_flash_torch.cache.paged_cache import PagedKVCache

COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")


def _part(n: int, rank: int, size: int, what: str) -> slice:
    if n % size:
        raise ValueError(f"{what} of {n} does not split over {size} ranks")
    c = n // size
    return slice(rank * c, (rank + 1) * c)


def _slice(w, rank: int, size: int, dim: int, name: str, device):
    if isinstance(w, dict):
        q = w["q"]
        sl = _part(q.shape[dim], rank, size, name)
        vals = q[:, sl] if dim == 1 else q[sl]
        # column scales follow their columns; row scales are replicated
        scales = w["s"][sl] if dim == 1 else w["s"]
        return {"q": vals.contiguous().to(device),
                "s": scales.contiguous().to(device)}
    sl = _part(w.shape[dim], rank, size, name)
    return (w[:, sl] if dim == 1 else w[sl]).contiguous().to(device)


def param_slices(params, rank: int, size: int, device=None):
    """Rank ``rank`` of ``size``'s tensor-parallel slices of a parameter
    tree: column-parallel matrices split along their outputs, row-parallel
    ones along their inputs, embeddings and norms replicated (the same
    tensors where ``device`` is theirs). ``device``: where the slices go
    (default: where the weights are)."""
    device = params["embed"].device if device is None else torch.device(
        device)

    def layer(lp):
        out = {}
        for name, w in lp.items():
            if name in COLUMN:
                out[name] = _slice(w, rank, size, 1, name, device)
            elif name in ROW:
                out[name] = _slice(w, rank, size, 0, name, device)
            else:
                out[name] = w.to(device)
        return out

    return dict(embed=params["embed"].to(device),
                ln_f=params["ln_f"].to(device),
                layers=[layer(lp) for lp in params["layers"]])


def shard_params(params, tp):
    """The slices of each of this process's ranks on the tensor-parallel
    axis ``tp`` (``parallel/mesh.py:AxisGroup``), on its device: the
    ``params`` list the model functions take under ``tp=``."""
    return [param_slices(params, r, tp.size, dev)
            for r, dev in zip(tp.indices, tp.devices)]


def cache_slice(cache: PagedKVCache, rank: int, size: int,
                device=None) -> PagedKVCache:
    """Rank ``rank`` of ``size``'s slice of a paged cache: its kv heads'
    pages and scales, the page tables and lengths replicated (copied)."""
    sl = _part(cache.k_pages.shape[0], rank, size, "kv heads")
    device = cache.k_pages.device if device is None else torch.device(device)

    def cut(t):
        return None if t is None else t[sl].contiguous().to(device)

    return PagedKVCache(
        k_pages=cut(cache.k_pages), v_pages=cut(cache.v_pages),
        k_scales=cut(cache.k_scales), v_scales=cut(cache.v_scales),
        page_tables=cache.page_tables.clone().to(device),
        lengths=cache.lengths.clone().to(device),
        config=dataclasses.replace(cache.config,
                                   num_kv_heads=sl.stop - sl.start))


def rank_cache_config(cache_cfg, size: int):
    """The cache configuration of one rank of ``size``: kv heads / size."""
    return dataclasses.replace(
        cache_cfg, num_kv_heads=_part(cache_cfg.num_kv_heads, 0, size,
                                      "kv heads").stop)


def check_divisible(model_cfg, size: int) -> None:
    """Tensor parallelism needs q heads, kv heads and the MLP hidden dim
    divisible by the axis size (the reference's ``shard_engine_state``
    requirement)."""
    for what, n in (("q heads", model_cfg.num_q_heads),
                    ("kv heads", model_cfg.num_kv_heads),
                    ("mlp hidden", model_cfg.hidden)):
        _part(n, 0, size, what)
