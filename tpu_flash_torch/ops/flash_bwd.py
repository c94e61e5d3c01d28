"""Flash-attention backward (B4 dQ, B5 dK/dV): port of ``flash_backward``
from ``tpu_flash/ops/flash_bwd.py`` for the dense and causal schedules (the
plain version also takes the local band, the circulant band and the
block-diagonal schedule through their visibility; their CUDA backward is
ROADMAP A8 and raises).

Recompute-from-lse (FA-2) on prescaled ``(B·H, n, d)`` tensors: q carries
the forward's ``scale·log2(e)``, so scores are base-2 and no scale appears
here — the autograd of the prescale outside restores it. The reference's
algebra and cast points are kept:

- Δ = rowsum(dO∘O) in float32, minus the lse cotangent when there is one;
- rows with lse = ±inf/NaN are clamped to 3e38, so p underflows to 0;
- p = exp2(s − lse·log2e), dp = dO·Vᵀ with dO cast to V's dtype,
  ds = p∘(dp − Δ);
- dq = Σ ds·K·ln2 (ds in K's dtype), dv = Σ pᵀ·dO (p in dO's dtype),
  dk = Σ dsᵀ·Q·ln2 (ds in Q's dtype).

GQA: k/v hold ``B·HKV`` rows. The reference expands K/V and sums each
group's per-head dK/dV after rounding them; here the group sums in float32
and rounds once, so the two agree within bf16 rounding, not bit for bit.

:func:`flash_backward` dispatches on the tensors' device: CPU tensors take
the plain PyTorch version :func:`_flash_bwd_plain`; CUDA tensors launch B4
then B5 (``csrc/flash_bwd.cu``) through :func:`_flash_bwd_kernel`, or raise.
``quant="dp"`` (the int8 dp product) and ``split`` are not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import (
    DEFAULT_MASK_VALUE,
    LN2,
    LOG2E,
    _aligned,
    _kv_rows,
    kernel_head_dim,
    pad_head_dims,
    slice_head_dims,
)
from tpu_flash_torch.ops.schedule import CausalSchedule, Schedule

# lse of fully masked rows is clamped here, so p = exp2(s − lse·log2e) = 0
LSE_CLAMP = 3e38


def _delta_lse2(o, lse, do, dlse):
    """Δ = rowsum(dO∘O) − dlse and the clamped lse·log2e, both float32."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    lse2 = torch.where(torch.isfinite(lse), lse, LSE_CLAMP).float() * LOG2E
    return delta, lse2


def _flash_bwd_plain(q, k, v, o, lse, do, dlse, sched: Schedule, hq: int,
                     hkv: int):
    """Plain PyTorch backward with full score matrices → (dq, dk, dv) in
    q's, k's and v's dtypes. Same contract as :func:`_flash_bwd_kernel`."""
    bh, n_q, _ = q.shape
    b = bh // hq
    n_kv = k.shape[1]
    g = hq // hkv
    rows = _kv_rows(bh, hq, hkv, q.device)
    kq, vq = k[rows], v[rows]
    delta, lse2 = _delta_lse2(o, lse, do, dlse)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kq.float())
    mask = sched.visible(torch.arange(n_q, device=q.device)[:, None],
                         torch.arange(n_kv, device=q.device)[None, :])
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.exp2(s - lse2[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.to(v.dtype).float(), vq.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), kq.float()) * LN2
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())

    def group_sum(x):  # (B·HQ, n_kv, ·) → (B·HKV, n_kv, ·), float32
        return x.reshape(b, hkv, g, n_kv, -1).sum(dim=2).reshape(
            b * hkv, n_kv, -1)

    return (dq.to(q.dtype), (group_sum(dk) * LN2).to(k.dtype),
            group_sum(dv).to(v.dtype))


def _kernel_args(q, k, sched: Schedule, hq: int, hkv: int):
    """The scalar arguments both kernels share: sizes, the causal flag and
    the right-aligned offset n_kv − n_q (the kernels pick their own tiles),
    dtype code and stream."""
    causal = isinstance(sched, CausalSchedule)
    return (q.shape[1], k.shape[1], hq, hkv, q.shape[-1], int(causal),
            sched._offset if causal else 0, kernels.dtype_code(q.dtype),
            kernels.stream_handle(q))


def _dq_kernel(q, k, v, do, lse2, delta, sched: Schedule, hq: int, hkv: int):
    """Launch B4 on checked, aligned operands (see
    :func:`_flash_bwd_kernel`) → dq."""
    from tpu_flash_torch.kernels import _build

    dq = torch.empty_like(q)
    err = _build.library().tf_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), q.shape[0],
        *_kernel_args(q, k, sched, hq, hkv))
    _build.check(err, "tf_flash_bwd_dq")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _dkv_kernel(q, k, v, do, lse2, delta, sched: Schedule, hq: int, hkv: int):
    """Launch B5 on checked, aligned operands → (dk, dv)."""
    from tpu_flash_torch.kernels import _build

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.library().tf_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        k.shape[0], *_kernel_args(q, k, sched, hq, hkv))
    _build.check(err, "tf_flash_bwd_dkv")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _kernel_operands(q, k, v, o, lse, do, dlse, sched: Schedule, hq: int,
                     hkv: int):
    """Check what the kernels take (or raise) and return the operands B4
    and B5 read: aligned q, k, v, dO and the float32 lse2 and Δ."""
    if type(sched) not in (Schedule, CausalSchedule):
        raise NotImplementedError(
            f"no CUDA backward kernel for {type(sched).__name__}: the band, "
            "circulant and block-diagonal backward is not ported yet "
            "(ROADMAP A8)")
    ts = (q, k, v, o, lse, do)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash backward kernels: all operands must be on one "
                         "CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not all(
            t.dtype == q.dtype for t in (k, v, o, do)):
        raise NotImplementedError(
            f"flash backward kernels take bf16 or f32 q/k/v/o/do of one "
            f"dtype, got {[str(t.dtype) for t in (q, k, v, o, do)]}")
    bh, _, d = q.shape
    if k.shape[-1] != d or do.shape[-1] != v.shape[-1]:
        raise ValueError(f"bad head dims {q.shape} {k.shape} {v.shape} "
                         f"{do.shape}")
    width = kernel_head_dim(d, v.shape[-1])
    if bh % hq or k.shape[0] != bh // hq * hkv or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"bad GQA shapes {q.shape} {k.shape} {v.shape}")
    delta, lse2 = _delta_lse2(o, lse, do, dlse)
    return tuple(_aligned(t) for t in (*pad_head_dims(width, q, k, v, do),
                                       lse2, delta))


def _flash_bwd_kernel(q, k, v, o, lse, do, dlse, sched: Schedule, hq: int,
                      hkv: int):
    """Launch B4 then B5 (``csrc/flash_bwd.cu``) on CUDA tensors; same
    contract as :func:`_flash_bwd_plain`. Ragged edges are masked in the
    kernels; head and value dims are zero-padded to the compiled width
    (zero columns change no score and no Δ) and the grads sliced back."""
    d, dv_dim = q.shape[-1], v.shape[-1]
    ops = _kernel_operands(q, k, v, o, lse, do, dlse, sched, hq, hkv)
    dq = _dq_kernel(*ops, sched, hq, hkv)
    dk, dv = _dkv_kernel(*ops, sched, hq, hkv)
    return (slice_head_dims(dq, d), slice_head_dims(dk, d),
            slice_head_dims(dv, dv_dim))


def flash_backward(q, k, v, o, lse, do, dlse: Optional[torch.Tensor],
                   sched: Schedule, *, hq: int = 1, hkv: int = 1,
                   split: Optional[int] = None, quant: Optional[str] = None):
    """(dq, dk, dv) on prescaled ``(B·HQ, n_q, d)`` q/o/do, ``(B·HKV, n_kv,
    d)`` k/v and the forward's natural-log lse ``(B·HQ, n_q)``. ``dlse``
    (the lse cotangent, or None) folds into Δ. The plain version for CPU
    tensors, B4 + B5 for CUDA tensors."""
    if split not in (None, 1):
        raise NotImplementedError(
            "flash_backward(split=...) sub-tile staging is not ported yet "
            "(ROADMAP A8)")
    if quant is not None:
        raise NotImplementedError(
            f"flash_backward(quant={quant!r}) (the int8 dp product) is not "
            "ported yet (ROADMAP A8)")
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, o, lse, do, dlse, sched, hq, hkv)
    if q.device.type == "cuda":
        return _flash_bwd_kernel(q, k, v, o, lse, do, dlse, sched, hq, hkv)
    raise NotImplementedError(f"no attention backward for device {q.device}")
