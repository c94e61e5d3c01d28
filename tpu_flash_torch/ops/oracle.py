"""Oracle attention: port of ``dense_dpa``, ``sliding_dpa`` and
``blockwise_dpa`` from ``tpu_flash/ops/oracle.py``.

They share no arithmetic with the flash kernels they check: ``dense_dpa``
and ``sliding_dpa`` materialise the full score matrix and run the
natural-log softmax in float64 (rounding once at the end), ``blockwise_dpa``
scans the keys in float32 chunks with the online-softmax merge, so it holds
full-size shapes in O(n·chunk) memory.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _core(q, k, v, scale, mask=None):
    """softmax(scale·QKᵀ, masked) V; returns (o in q's dtype, lse f32).

    The products and the softmax run in float64 and round once at the end.
    The reference pins its oracle's einsums to exact float32 products
    (``precision=HIGHEST``); float64 pins this one the same way, whatever
    float32 mode the backend's products or exp run in."""
    q64, k64, v64 = (x.double() for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q64, k64) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    # Fully-masked rows: output 0, lse = -inf.
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v64) / torch.clamp_min(l, 1e-30)
    lse = (m_safe + torch.log(torch.clamp_min(l, 1e-30))).squeeze(-1)
    lse = torch.where(torch.isfinite(m.squeeze(-1)), lse, float("-inf"))
    o = torch.where(torch.isfinite(m), o, torch.zeros_like(o))
    return o.to(q.dtype), lse.float()


def dense_dpa(q, k, v, *, scale: Optional[float] = None, causal: bool = False):
    """Dense oracle attention on ``(batch, heads, n, d)``; q and k/v must
    have the same head count. ``causal`` masks with the right-aligned lower
    triangle (query ``i`` sees keys ``j ≤ i + n_kv − n_q``).

    Returns ``(o, lse)``: o in q's dtype, lse in natural-log units.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mask = None
    if causal:
        n, nk = q.shape[-2], k.shape[-2]
        mask = torch.ones(n, nk, dtype=torch.bool, device=q.device).tril(nk - n)
    return _core(q, k, v, scale, mask=mask)


def sliding_dpa(q, k, v, window_size: int, *, scale: Optional[float] = None,
                causal: bool = False):
    """Sliding-window oracle on ``(batch, heads, n, d)``: query ``i``
    attends keys ``|i − j| ≤ (window_size − 1)/2`` (clamped at the edges,
    no wraparound), and ``j ≤ i`` too when ``causal``. Returns
    ``(o, lse)``."""
    if window_size % 2 != 1:
        raise ValueError("sliding window must be odd")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    i = torch.arange(q.shape[-2], device=q.device)[:, None]
    j = torch.arange(k.shape[-2], device=q.device)[None, :]
    mask = (i - j).abs() <= (window_size - 1) // 2
    if causal:
        mask = mask & (j <= i)
    return _core(q, k, v, scale, mask=mask)


def blockwise_dpa(q, k, v, *, scale: Optional[float] = None,
                  causal: bool = False, window_size: Optional[int] = None,
                  chunk: int = 2048, q_start: int = 0, **unported):
    """Exact f32 oracle with O(n·chunk) memory on ``(batch, heads, n, d)``;
    q and k/v must have the same head count.

    Scans the keys in chunks of ``chunk`` with the associative online
    softmax merge, so it serves as ground truth where ``dense_dpa``'s
    (n, n) score matrix would not fit. ``causal`` masks key ``j`` for query
    ``i`` when ``j > q_start + i`` (the reference's left-aligned triangle).
    ``window_size`` (odd) keeps the sliding band ``|i − j| ≤
    (window_size − 1)/2`` of :func:`sliding_dpa`.
    ``q_start`` is the global index of q's first row: a row band of q with
    its ``q_start`` gives exactly those rows of the full result.

    Returns ``(o, lse)``: o in q's dtype, lse in natural-log units. The
    circulant and block masks (``wrap``, ``block_size``) are not ported yet
    (ROADMAP A11).
    """
    for name in unported:
        if name not in ("wrap", "block_size"):
            raise TypeError(f"blockwise_dpa() got an unexpected keyword "
                            f"argument {name!r}")
        if unported[name] not in (None, False):
            raise NotImplementedError(
                f"blockwise_dpa({name}=...) is not ported yet (ROADMAP A11)")
    if window_size is not None and window_size % 2 != 1:
        raise ValueError("sliding/circulant window must be odd")
    b, h, n, d = q.shape
    nk = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, nk)
    q32 = q.float()
    qi = q_start + torch.arange(n, device=q.device)[:, None]
    m = torch.full((b, h, n, 1), float("-inf"), device=q.device)
    l = torch.zeros(b, h, n, 1, device=q.device)
    acc = torch.zeros(b, h, n, v.shape[-1], device=q.device)
    for c0 in range(0, nk, chunk):
        kj, vj = k[:, :, c0:c0 + chunk].float(), v[:, :, c0:c0 + chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kj) * scale
        j = c0 + torch.arange(kj.shape[-2], device=q.device)[None, :]
        if causal:
            s = torch.where(j <= qi, s, float("-inf"))
        if window_size is not None:
            s = torch.where((qi - j).abs() <= (window_size - 1) // 2, s,
                            float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, vj)
        m = m_new
    fin = torch.isfinite(m)
    o = torch.where(fin, acc / torch.clamp_min(l, 1e-30), 0.0).to(q.dtype)
    lse = torch.where(fin, m + torch.log(torch.clamp_min(l, 1e-30)),
                      float("-inf")).squeeze(-1)
    return o, lse
