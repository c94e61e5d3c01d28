"""f32 oracle attention: port of ``dense_dpa`` from ``tpu_flash/ops/oracle.py``.

Materialises the full score matrix in float32 with the natural-log softmax,
so it shares no arithmetic with the flash kernels it checks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _core(q, k, v, scale, mask=None):
    """softmax(scale·QKᵀ, masked) V in f32; returns (o, lse)."""
    q32, k32, v32 = (x.float() for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    # Fully-masked rows: output 0, lse = -inf.
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v32) / torch.clamp_min(l, 1e-30)
    lse = (m_safe + torch.log(torch.clamp_min(l, 1e-30))).squeeze(-1)
    lse = torch.where(torch.isfinite(m.squeeze(-1)), lse, float("-inf"))
    o = torch.where(torch.isfinite(m), o, torch.zeros_like(o))
    return o.to(q.dtype), lse


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
