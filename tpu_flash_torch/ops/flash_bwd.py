"""Flash-attention backward (B4 dQ, B5 dK/dV): port of ``flash_backward``
from ``tpu_flash/ops/flash_bwd.py`` for every schedule of the forward
(dense, causal, local, local_causal, circulant over halo-extended K/V,
block-diagonal), with the int8 dp product (``quant="dp"``) and the
``split`` option.

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

``quant="dp"`` (the reference's ``:627-651``) takes dp on int8 operands
quantized once outside the kernels: σv = max over the sequence of |v| per
(kv row, channel), floored at 1e-12, over 127, v̂ = clip(round(v/σv)),
dO_eff = dO·σv, σdo = max |dO_eff| per row, floored at 1e-30, over 127,
dÔ = clip(round(dO_eff/σdo)); then dp_raw = dÔ·v̂ᵀ is exact, Δ is divided
by σdo, dq rows are scaled by σdo·ln2 at the end and dk takes
qs = (q·σdo) in q's dtype; dv keeps the exact dO. The reference expands
K/V to the q heads before it quantizes; the copies of a group are equal,
so σv per kv row is the same. Only where the reference applies it (not
when d ≤ 64 and dv ≤ 64, the caller's widths); elsewhere the flag is
ignored.

float32 on the card: B4/B5 take each product in three TF32 passes
(3×TF32, ``csrc/flash_bwd_f32.cuh``) at every width; at 256 and 512 the
head dim is split across a thread-block cluster, a 128-column slice a CTA.
:func:`tf32x3` models that product; :func:`_flash_bwd_plain` takes it as
``products=`` for the tests and the chip check, and stays exact float32
otherwise.

GQA: k/v hold ``B·HKV`` rows. The reference expands K/V and sums each
group's per-head dK/dV after rounding them; here the group sums in float32
and rounds once, so the two agree within bf16 rounding, not bit for bit.

:func:`flash_backward` dispatches on the tensors' device: CPU tensors take
the plain PyTorch version :func:`_flash_bwd_plain`; CUDA tensors launch B4
then B5 (``csrc/flash_bwd.cu``, float32 ``csrc/flash_bwd_f32.cuh``)
through :func:`_flash_bwd_kernel`, or raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import (
    _KIND,
    DEFAULT_MASK_VALUE,
    LN2,
    LOG2E,
    _aligned,
    _kv_rows,
    kernel_head_dim,
    kernel_schedule,
    pad_head_dims,
    slice_head_dims,
)
from tpu_flash_torch.ops.schedule import (
    CirculantSchedule,
    LocalSchedule,
    Schedule,
)

# lse of fully masked rows is clamped here, so p = exp2(s − lse·log2e) = 0
LSE_CLAMP = 3e38
# the band retile of the reference's backward (tpu_flash/ops/flash_bwd.py:
# 611-620), which split is validated against
_BAND_TILE = 512


def _delta_lse2(o, lse, do, dlse):
    """Δ = rowsum(dO∘O) − dlse and the clamped lse·log2e, both float32."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    lse2 = torch.where(torch.isfinite(lse), lse, LSE_CLAMP).float() * LOG2E
    return delta, lse2


def dp_applies(quant: Optional[str], d: int, dv: int) -> bool:
    """Whether ``quant`` takes the int8 dp product at the caller's head
    and value dims (the reference ignores it when both are ≤ 64); an
    unknown mode raises ``ValueError``."""
    if quant not in (None, "dp"):
        raise ValueError(f"unknown bwd quant mode {quant!r}")
    return quant == "dp" and not (d <= 64 and dv <= 64)


def dp_operands(q, v, do, delta, hq: int, hkv: int):
    """The int8 dp operands (``tpu_flash/ops/flash_bwd.py:639-651``) →
    (v̂, dÔ, qs, σdo, Δ/σdo): v̂ like v and dÔ like dO in int8, qs like q,
    σdo and Δ/σdo float32 ``(B·HQ, n_q)``. Divides by tensors: on CUDA a
    division by a Python number is a multiply by its reciprocal."""
    q127 = torch.full((), 127.0, device=v.device)
    v32 = v.float()
    sv = v32.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / q127
    v8 = torch.clamp(torch.round(v32 / sv), -127, 127).to(torch.int8)
    do_eff = do.float() * sv[_kv_rows(q.shape[0], hq, hkv, q.device)]
    sdo = do_eff.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / q127
    do8 = torch.clamp(torch.round(do_eff / sdo), -127, 127).to(torch.int8)
    qs = (q.float() * sdo).to(q.dtype)
    return v8, do8, qs, sdo[..., 0], delta / sdo[..., 0]


def check_split(split: Optional[int], sched: Schedule) -> None:
    """The reference's validation of ``split`` (``:659-667``) against the
    schedule's blocks after its band retile (``:611-620``): split must
    divide block_q and block_kv into 128-aligned sub-tiles. In the
    reference split only reassociates the per-step sums; the card's
    kernels pick their own tiles, so it changes nothing here or there."""
    bq, bkv = sched.block_q, sched.block_kv
    if isinstance(sched, (LocalSchedule, CirculantSchedule)):
        cand = dataclasses.replace(sched, block_q=min(bq, _BAND_TILE),
                                   block_kv=min(bkv, _BAND_TILE))
        if (cand.n_q_pad == sched.n_q_pad
                and cand.n_kv_pad == sched.n_kv_pad):
            bq, bkv = cand.block_q, cand.block_kv
    split = 1 if split is None else split
    if split < 1 or (split > 1 and (
            bkv % split or bq % split
            or (bkv // split) % 128 or (bq // split) % 128)):
        raise ValueError(
            f"split={split} must divide block_q={bq} and block_kv={bkv} "
            "into 128-aligned sub-tiles")


# the bits of a float32 word that the tensor cores read as tf32: its top 19
# (sign, exponent, 10 mantissa bits); they drop the other 13
# (bench/tf32_probe.py)
_TF32_MASK = -8192  # 0xffffe000 as an int32


def tf32_split(x: torch.Tensor):
    """float32 ``x`` → (hi, lo): hi as the tensor cores read x (its low 13
    bits cleared), lo = x − hi (exact in float32) as they read it in turn."""
    def trunc(t):
        return (t.contiguous().view(torch.int32) & _TF32_MASK).view(
            torch.float32)

    x = x.float()
    hi = trunc(x)
    return hi, trunc(x - hi)


def tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor,
           passes: int = 3) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as the float32 kernels compute it: each
    operand split by :func:`tf32_split`, then hi·hi + hi·lo + lo·hi in
    float32, the lo·lo products left out (3×TF32); ``passes=1``: hi·hi
    alone, one TF32 pass. A model of the card's product for the tests and
    the chip check; no main path calls it."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def _exact(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


def _flash_bwd_plain(q, k, v, o, lse, do, dlse, sched: Schedule, hq: int,
                     hkv: int, quant: Optional[str] = None, products=None):
    """Plain PyTorch backward with full score matrices → (dq, dk, dv) in
    q's, k's and v's dtypes. Same contract as :func:`_flash_bwd_kernel`.
    Under dp, dp_raw is a float32 product of int8-valued tensors: exact
    (|sum| ≤ 256·127² < 2²⁴), as the kernels' integer sums are.
    ``products``: the (eq, a, b) → float32 product of the float operands
    (default exact float32; :func:`tf32x3` models the card's float32
    kernels)."""
    bh, n_q, _ = q.shape
    b = bh // hq
    n_kv = k.shape[1]
    g = hq // hkv
    rows = _kv_rows(bh, hq, hkv, q.device)
    kq = k[rows]
    delta, lse2 = _delta_lse2(o, lse, do, dlse)
    dp_quant = dp_applies(quant, q.shape[-1], v.shape[-1])
    mm = _exact if products is None else products
    s = mm("bqd,bkd->bqk", q.float(), kq.float())
    mask = sched.visible(torch.arange(n_q, device=q.device)[:, None],
                         torch.arange(n_kv, device=q.device)[None, :])
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.exp2(s - lse2[..., None])
    if dp_quant:
        v8, do8, qs, sdo, delta = dp_operands(q, v, do, delta, hq, hkv)
        dp = torch.einsum("bqd,bkd->bqk", do8.float(), v8[rows].float())
        dq_scale, dk_q = (sdo * LN2)[..., None], qs
    else:
        dp = mm("bqd,bkd->bqk", do.to(v.dtype).float(), v[rows].float())
        dq_scale, dk_q = LN2, q
    ds = p * (dp - delta[..., None])
    dq = mm("bqk,bkd->bqd", ds.to(k.dtype).float(), kq.float()) * dq_scale
    dv = mm("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dk = mm("bqk,bqd->bkd", ds.to(q.dtype).float(), dk_q.float())

    def group_sum(x):  # (B·HQ, n_kv, ·) → (B·HKV, n_kv, ·), float32
        return x.reshape(b, hkv, g, n_kv, -1).sum(dim=2).reshape(
            b * hkv, n_kv, -1)

    return (dq.to(q.dtype), (group_sum(dk) * LN2).to(k.dtype),
            group_sum(dv).to(v.dtype))


# dtype code of float32 on one TF32 pass (csrc/flash_bwd.cu:dispatch): the
# chip check's planted fault, reached only through _flash_bwd_kernel's
# tf32_passes
_F32_ONE_PASS = 2


def _kernel_args(q, k, sched: Schedule, hq: int, hkv: int,
                 code: Optional[int] = None):
    """The scalar arguments both kernels share: sizes, the schedule
    (``ops/flash.py:kernel_schedule``; the kernels pick their own tiles),
    dtype code (q's, unless ``code``) and stream."""
    if code is None:
        code = kernels.dtype_code(q.dtype)
    return (q.shape[1], k.shape[1], hq, hkv, q.shape[-1],
            *kernel_schedule(sched), code, kernels.stream_handle(q))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dq_kernel(q, k, v, do, lse2, delta, dp, sched: Schedule, hq: int,
               hkv: int, *, _code: Optional[int] = None):
    """Launch B4 on checked, aligned operands (see
    :func:`_kernel_operands`; ``dp`` is None or (v̂, dÔ, qs, σdo)) → dq.
    ``_code``: set by :func:`_flash_bwd_kernel` alone."""
    from tpu_flash_torch.kernels import _build

    v8, do8, _, sdo = (None,) * 4 if dp is None else dp
    dq = torch.empty_like(q)
    err = _build.library().tf_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(v8),
        _ptr(do8), _ptr(sdo), q.shape[0],
        *_kernel_args(q, k, sched, hq, hkv, _code))
    _build.check(err, "tf_flash_bwd_dq")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _dkv_kernel(q, k, v, do, lse2, delta, dp, sched: Schedule, hq: int,
                hkv: int, dv_cols: Optional[int] = None, *,
                _code: Optional[int] = None):
    """Launch B5 on checked, aligned operands → (dk, dv). ``dv_cols``: the
    caller's value dim (default: all of v's columns); at width 512 a
    256-column half past it computes no dV, and its dv columns are left
    unwritten. ``_code``: set by :func:`_flash_bwd_kernel` alone."""
    from tpu_flash_torch.kernels import _build

    v8, do8, qs, _ = (None,) * 4 if dp is None else dp
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    n_q, n_kv, hq_, hkv_, width, *rest = _kernel_args(q, k, sched, hq, hkv,
                                                      _code)
    err = _build.library().tf_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(v8), _ptr(do8), _ptr(qs), k.shape[0], n_q, n_kv, hq_, hkv_,
        width, v.shape[-1] if dv_cols is None else dv_cols, *rest)
    _build.check(err, "tf_flash_bwd_dkv")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _kernel_operands(q, k, v, o, lse, do, dlse, sched: Schedule, hq: int,
                     hkv: int, quant: Optional[str] = None):
    """Check what the kernels take (or raise) and return the operands B4
    and B5 read: aligned q, k, v, dO, the float32 lse2 and Δ, and under dp
    (v̂, dÔ, qs, σdo) with Δ divided by σdo, else None."""
    if (type(sched), getattr(sched, "causal", False)) not in _KIND:
        raise NotImplementedError(
            f"no CUDA backward kernel for {type(sched).__name__}")
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
    dp = None
    if dp_applies(quant, d, v.shape[-1]):
        v8, do8, qs, sdo, delta = dp_operands(q, v, do, delta, hq, hkv)
        dp = (*(_aligned(t) for t in pad_head_dims(width, v8, do8, qs)),
              _aligned(sdo))
    return (*(_aligned(t) for t in (*pad_head_dims(width, q, k, v, do),
                                    lse2, delta)), dp)


def _flash_bwd_kernel(q, k, v, o, lse, do, dlse, sched: Schedule, hq: int,
                      hkv: int, quant: Optional[str] = None,
                      tf32_passes: int = 3):
    """Launch B4 then B5 (``csrc/flash_bwd.cu``) on CUDA tensors; same
    contract as :func:`_flash_bwd_plain`. Ragged edges are masked in the
    kernels; head and value dims are zero-padded to the compiled width
    (zero columns change no score, no Δ and no σ) and the grads sliced
    back. ``tf32_passes=1`` (float32, at every width) runs the float32
    kernels on one TF32 pass, hi·hi alone: a planted fault for the checks,
    which no user path takes."""
    code = None
    if tf32_passes != 3:
        if tf32_passes != 1 or q.dtype != torch.float32:
            raise ValueError(f"tf32_passes={tf32_passes} on {q.dtype}")
        code = _F32_ONE_PASS
    d, dv_dim = q.shape[-1], v.shape[-1]
    ops = _kernel_operands(q, k, v, o, lse, do, dlse, sched, hq, hkv, quant)
    dq = _dq_kernel(*ops, sched, hq, hkv, _code=code)
    dk, dv = _dkv_kernel(*ops, sched, hq, hkv, dv_dim, _code=code)
    return (slice_head_dims(dq, d), slice_head_dims(dk, d),
            slice_head_dims(dv, dv_dim))


def flash_backward(q, k, v, o, lse, do, dlse: Optional[torch.Tensor],
                   sched: Schedule, *, hq: int = 1, hkv: int = 1,
                   split: Optional[int] = None, quant: Optional[str] = None):
    """(dq, dk, dv) on prescaled ``(B·HQ, n_q, d)`` q/o/do, ``(B·HKV, n_kv,
    d)`` k/v and the forward's natural-log lse ``(B·HQ, n_q)``. ``dlse``
    (the lse cotangent, or None) folds into Δ. The plain version for CPU
    tensors, B4 + B5 for CUDA tensors.

    ``quant="dp"`` takes dp = dO·Vᵀ on int8 operands where the reference
    does (not at d, dv ≤ 64); another mode raises ``ValueError``.
    ``split`` is validated as the reference validates it (``ValueError``
    unless it divides the blocks into 128-aligned sub-tiles) and changes
    nothing else: it only stages the reference's TPU sums."""
    dp_applies(quant, q.shape[-1], v.shape[-1])
    check_split(split, sched)
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, o, lse, do, dlse, sched, hq, hkv,
                                quant)
    if q.device.type == "cuda":
        return _flash_bwd_kernel(q, k, v, o, lse, do, dlse, sched, hq, hkv,
                                 quant)
    raise NotImplementedError(f"no attention backward for device {q.device}")
