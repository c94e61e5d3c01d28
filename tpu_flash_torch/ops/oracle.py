"""Oracle attention: port of ``tpu_flash/ops/oracle.py`` (``dense_dpa``,
``sliding_dpa``, ``windowed_dpa``, ``block_dpa``, ``circulant_dpa``,
``blockwise_dpa``).

They share no arithmetic with the flash kernels they check: the first five
materialise the full score matrix (or, circulant, the gathered band) and run
the natural-log softmax in float64, rounding once at the end;
``blockwise_dpa`` scans the keys in float32 chunks with the online-softmax
merge, so it holds full-size shapes in O(n·chunk) memory.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from tpu_flash_torch.utils.layout import (
    circulant_neighbors,
    flatten_spatial,
    unflatten_spatial,
    windowed,
)


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
    """Dense oracle attention on ``(batch, heads, n, d)``, or N-d
    ``(batch, *spatial, heads, d)`` with the spatial dims flattened; q and
    k/v must have the same head count. ``causal`` masks with the
    right-aligned lower triangle (query ``i`` sees keys ``j ≤ i + n_kv −
    n_q``).

    Returns ``(o, lse)``: o in q's dtype (and layout), lse in natural-log
    units ``(batch, heads, N)``.
    """
    spatial = None
    if q.ndim > 4:
        q, spatial = flatten_spatial(q)
        k, _ = flatten_spatial(k)
        v, _ = flatten_spatial(v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mask = None
    if causal:
        n, nk = q.shape[-2], k.shape[-2]
        mask = torch.ones(n, nk, dtype=torch.bool, device=q.device).tril(nk - n)
    o, lse = _core(q, k, v, scale, mask=mask)
    if spatial is not None:
        o = unflatten_spatial(o, spatial)
    return o, lse


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


def windowed_dpa(q, k, v, window_size, *, stride=None, pad=0,
                 scale: Optional[float] = None):
    """Windowed oracle over 1-D/2-D/3-D ``(batch, *spatial, heads, d)``:
    dense attention inside each window (``window_size`` per dim, with
    ``stride``/``pad``), outputs at positions that several windows cover
    averaged by their count. Returns o only (lse is per window)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return windowed(q, k, v, window_size, stride=stride, pad=pad,
                    attend=lambda qw, kw, vw: _core(qw, kw, vw, scale)[0])


def block_dpa(q, k, v, block_size, *, scale: Optional[float] = None):
    """Disjoint block-diagonal oracle: windowed with stride = window, no
    padding."""
    return windowed_dpa(q, k, v, block_size, stride=block_size, pad=0,
                        scale=scale)


def circulant_dpa(q, k, v, window_size: int, *, scale: Optional[float] = None):
    """Circulant-band oracle: query ``i`` attends keys ``(i + o) mod n``,
    ``o ∈ [−(w−1)/2, (w−1)/2]``, on ``(batch, heads, n, d)`` or N-d
    ``(batch, *spatial, heads, d)`` (flattened). The gathered band runs in
    float64 and rounds once. Returns ``(o, lse)``."""
    spatial = None
    if q.ndim > 4:
        q, spatial = flatten_spatial(q)
        k, _ = flatten_spatial(k)
        v, _ = flatten_spatial(v)
    n = q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    idx = circulant_neighbors(n, window_size, q.device)
    kg, vg = k.double()[:, :, idx], v.double()[:, :, idx]  # (b, h, n, w, ·)
    s = torch.einsum("bhnd,bhnwd->bhnw", q.double(), kg) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhnw,bhnwd->bhnd", p / l, vg).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1).float()
    if spatial is not None:
        o = unflatten_spatial(o, spatial)
    return o, lse


def blockwise_dpa(q, k, v, *, scale: Optional[float] = None,
                  causal: bool = False, window_size: Optional[int] = None,
                  wrap: bool = False, block_size: Optional[int] = None,
                  chunk: int = 2048, q_start: int = 0):
    """Exact f32 oracle with O(n·chunk) memory on ``(batch, heads, n, d)``;
    q and k/v must have the same head count.

    Scans the keys in chunks of ``chunk`` with the associative online
    softmax merge, so it serves as ground truth where ``dense_dpa``'s
    (n, n) score matrix would not fit. ``causal`` masks key ``j`` for query
    ``i`` when ``j > q_start + i`` (the reference's left-aligned triangle).
    ``window_size`` (odd) keeps the sliding band ``|i − j| ≤
    (window_size − 1)/2`` of :func:`sliding_dpa`, or with ``wrap=True`` the
    circulant band (offsets taken mod n_kv); ``block_size`` keeps the
    block-diagonal ``i // B == j // B``.
    ``q_start`` is the global index of q's first row: a row band of q with
    its ``q_start`` gives exactly those rows of the full result.

    Returns ``(o, lse)``: o in q's dtype, lse in natural-log units.

    Under autograd each chunk's step runs under ``torch.utils.checkpoint``
    (recomputed in the backward), so the backward also holds O(n·chunk)
    and not every chunk's scores, as the reference's checkpointed scan does
    (``tpu_flash/bench/sweep.py:376-379``).
    """
    if window_size is not None and block_size is not None:
        raise ValueError("window_size and block_size are mutually exclusive")
    if window_size is not None and window_size % 2 != 1:
        raise ValueError("sliding/circulant window must be odd")
    b, h, n, d = q.shape
    nk = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, nk)
    q32 = q.float()
    m = torch.full((b, h, n, 1), float("-inf"), device=q.device)
    l = torch.zeros(b, h, n, 1, device=q.device)
    acc = torch.zeros(b, h, n, v.shape[-1], device=q.device)

    def step(c0, q32, kj, vj, m, l, acc):
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kj.float()) * scale
        qi = q_start + torch.arange(n, device=q.device)[:, None]
        j = c0 + torch.arange(kj.shape[-2], device=q.device)[None, :]
        if causal:
            s = torch.where(j <= qi, s, float("-inf"))
        if window_size is not None:
            radius = (window_size - 1) // 2
            if wrap:
                off = torch.remainder(qi - j, nk)
                live = (off <= radius) | (off >= nk - radius)
            else:
                live = (qi - j).abs() <= radius
            s = torch.where(live, s, float("-inf"))
        if block_size is not None:
            s = torch.where((qi // block_size) == (j // block_size), s,
                            float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, vj.float())
        return m_new, l, acc

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for c0 in range(0, nk, chunk):
        args = (c0, q32, k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk],
                m, l, acc)
        m, l, acc = (torch.utils.checkpoint.checkpoint(
            step, *args, use_reentrant=False) if grad else step(*args))
    fin = torch.isfinite(m)
    o = torch.where(fin, acc / torch.clamp_min(l, 1e-30), 0.0).to(q.dtype)
    lse = torch.where(fin, m + torch.log(torch.clamp_min(l, 1e-30)),
                      float("-inf")).squeeze(-1)
    return o, lse
