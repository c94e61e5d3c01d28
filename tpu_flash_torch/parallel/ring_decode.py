"""Sequence-sharded decode: the paged KV split over a mesh axis, merged
with the (o, lse) algebra; port of ``tpu_flash/parallel/ring_decode.py``.

Each rank of the axis holds a contiguous slice of every sequence's history
in its own paged cache and attends it through the paged kernel (B2, with
lse); the partials merge with the rule ring prefill uses per hop::

    o = Σ_shard o_s · exp(lse_s − lse_total),   lse_total = log Σ exp(lse_s)

as one max and one pair of sums over the axis (``parallel/mesh.py:
AxisGroup``: the ranks inside this process in rank order, then the
processes' sub-group). An empty shard gives lse = −inf, weight 0. The new
token's K/V go only to the rank that owns the append (by default the last
rank, through B2's fused append); every other rank attends its frozen
slice. The reference's ``lax.cond`` on each rank is a branch on the host
rank here.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from tpu_flash_torch.ops.paged import paged_attention


def merge_shard_partials(o, lse, axis, return_lse: bool = False):
    """Merge the local ranks' partials over ``axis`` (an ``AxisGroup``).

    o: one ``(B, H, D)`` tensor a local rank; lse: one ``(B, H)`` a rank,
    natural-log units, −inf for an empty shard. Float32 throughout: the max
    over the axis, then each rank's weight ``exp(lse − max)`` and the sums
    of the weights and the weighted outputs. A row that every shard leaves
    empty gives o = 0 (and lse = −inf). Returns o in the first part's dtype
    on the first rank's device (and the merged lse)."""
    dev = axis.device
    o32 = [x.to(dev).float() for x in o]
    lses = [x.to(dev).float() for x in lse]
    m = axis.max(lses)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = [torch.where(torch.isneginf(x), 0.0, torch.exp(x - m_safe))
         for x in lses]
    denom = axis.sum(w)
    num = axis.sum([x * wi[..., None] for x, wi in zip(o32, w)])
    out = (num / torch.clamp_min(denom, 1e-30)[..., None]).to(o[0].dtype)
    if not return_lse:
        return out
    return out, torch.where(denom > 0, m_safe + torch.log(denom), -math.inf)


def sharded_paged_attention(
    q: torch.Tensor,
    caches: List,
    slots: torch.Tensor,
    axis,
    *,
    new_kv=None,
    owns_append: Optional[int] = None,
    radius: Optional[int] = None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    return_lse: bool = False,
):
    """Decode attention over a sequence-sharded paged cache.

    ``caches``: this process's ranks' caches on ``axis`` (an
    ``AxisGroup``), one a rank, each holding a contiguous slice of every
    sequence's history (its ``lengths`` count local tokens only); ``q``
    ``(B, H, D)`` and ``slots`` on the first rank's device. ``new_kv``,
    when given, is appended ONLY on the rank at position ``owns_append`` of
    the axis (default the last); other ranks attend their frozen slice.
    Returns ``out`` (``(out, lse)`` with ``return_lse``), and the caches,
    updated in place, when appending."""
    owner = axis.size - 1 if owns_append is None else owns_append
    kw = dict(radius=radius, scale=scale, pages_bound=pages_bound,
              return_lse=True)
    qs, ss = axis.broadcast(q), axis.broadcast(slots)
    news = (None if new_kv is None
            else list(zip(*(axis.broadcast(t) for t in new_kv))))

    def rank(i, cache, qr, sr, new):
        if new is not None and axis.first + i == owner:
            o, lse, _ = paged_attention(qr, cache, sr, new_kv=new, **kw)
            return o, lse
        return paged_attention(qr, cache, sr, **kw)

    parts = axis.map(rank, caches, qs, ss, news or [None] * axis.local)
    out = merge_shard_partials([o for o, _ in parts], [x for _, x in parts],
                               axis, return_lse=return_lse)
    if new_kv is None:
        return out
    return (*out, caches) if return_lse else (out, caches)
