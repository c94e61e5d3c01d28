"""Serving-mode quantized attention (B6, B8): port of
``tpu_flash/quant/serving_attn.py`` on the dense, causal, local,
local_causal, circulant, block-diagonal and shifted (ring-hop) schedules.
The circulant runs over the cache as given, with 2·radius
zero rows after it (``flash_q.phantom_rows``): the reference does not
halo-extend a cache, so those padding keys stay visible to it (score 0,
value 0; ROADMAP C), and the port reproduces that.

K/V come pre-quantized (cache residents: int8, e4m3 or e5m2; K per token
or per tensor, V per channel); only Q is fresh, and the kernel quantizes
each q tile once, before its kv loop: int8 (native int8 products), e4m3
(native fp8 products, the row factor applied to the float32 score) or not
at all (weight-only). An e5m2 cache still takes e4m3 Q, as in the
reference. ``kv_scale="tensor"`` folds the K scale
into the Q staging. The reference's d ≤ 64 transposed kernel (B8) exists to
fill the TPU's 128-lane matrix unit; on the card one kernel
(``csrc/quant_attention.cu``, ``tf_serving_attention``) serves every head
dim, and ``transposed`` selects nothing.

:func:`_serving_attn` dispatches on the device: CPU tensors take the plain
version (:func:`_stage_q_plain`, then the shared tile loop
``flash_q._attend_plain``), CUDA tensors launch the kernel through
:func:`_serving_attention_kernel`, or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import (
    LOG2E,
    _aligned,
    _kv_rows,
    build_schedule,
    kernel_head_dim,
    kernel_schedule,
    pad_head_dims,
    slice_head_dims,
)
from tpu_flash_torch.ops.schedule import Schedule
from tpu_flash_torch.quant.flash_q import (
    _attend_plain,
    _ptr,
    check_kernel_operands,
    f32,
    phantom_rows,
    scaled_k_norms,
)
from tpu_flash_torch.quant.qarray import QArray, as_dtype, quantize

_Q_MODES = {"raw": 0, "fp8": 1, "int8": 2}
_STAGED_DTYPES = {"raw": torch.bfloat16, "fp8": torch.float8_e4m3fn,
                  "int8": torch.int8}


def serving_operands(q, kq: QArray, vq: QArray, bound_max: bool):
    """Flatten ``(b, h, n, d)`` q and the cache into the kernel's operands:
    ``(q (b·h, n_q, d), k̂, v̂ (b·hkv, n_kv, d), per-token K scales
    (b·hkv, n_kv) or None, per-tensor K scales (b·hkv,) or None, V scales
    (b·hkv, dv), gk (b·hkv,) or None)``; gk is the max scaled key norm of
    each kv row, the norm bound's key side."""
    b, h, n_q, d = q.shape
    hkv, n_kv, dv = kq.values.shape[1], kq.values.shape[2], vq.values.shape[-1]
    bh_kv = b * hkv
    k_vals = kq.values.reshape(bh_kv, n_kv, d)
    k_scaled = kq.axis == -1 or kq.axis == kq.values.ndim - 1
    sk_token = kq.scales.reshape(bh_kv, n_kv) if k_scaled else None
    sk_tensor = None if k_scaled else kq.scales.reshape(bh_kv)
    gk = (scaled_k_norms(k_vals, sk_token).amax(dim=-1) if bound_max
          else None)
    return (q.reshape(b * h, n_q, d), k_vals,
            vq.values.reshape(bh_kv, n_kv, dv), sk_token, sk_tensor,
            vq.scales.reshape(bh_kv, dv), gk)


def _stage_q_plain(q, q_mode: str, c: float, skf):
    """The kernel's Q staging on ``(bh, n_q, d)`` q → (score operand, row
    factors or None). ``c`` is float32(scale·log2e); ``skf`` 1.0 or the
    ``(bh, 1, 1)`` K scale folded in (kv_scale="tensor"). int8 and e4m3 give
    q̂ and f = (σq·c)·skf, the factor of the float32 score (q̂·k̂)·f;
    weight-only gives the bf16 operand q·(c·skf). The same float32
    operations in the same order: the kernel agrees on every byte and
    factor."""
    if q_mode == "raw":
        return (q.float() * (c * skf)).to(torch.bfloat16), None
    qq = quantize(q, torch.int8 if q_mode == "int8" else torch.float8_e4m3fn,
                  axis=-1)
    return qq.values, ((qq.scales * c) * skf)[..., 0]


def _serving_attention_kernel(q, k_vals, v_vals, sk_token, sk_tensor, sv, gk,
                              sched: Schedule, hq: int, hkv: int, q_mode: str,
                              c: float, pv_quant: bool, need_lse: bool,
                              staged: bool = False):
    """Launch ``tf_serving_attention`` on CUDA tensors → (o, lse), and with
    ``staged`` also the staged Q operand and its row factors (int8, e4m3),
    which the kernel then writes out for checking against
    :func:`_stage_q_plain`. Head and value dims are zero-padded to the
    kernel's width (K̂/V̂ with byte 0, σv with 1) and sliced back.
    """
    from tpu_flash_torch.kernels import _build

    check_kernel_operands("serving_attention kernel", q, k_vals, v_vals, hq,
                          hkv)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"serving_attention kernel takes f32 or bf16 q, got {q.dtype}")
    if (q_mode == "int8" or pv_quant) and k_vals.dtype != torch.int8:
        raise NotImplementedError("int8 products need an int8 cache")
    bh, n_q, d = q.shape
    n_kv, dv = k_vals.shape[1], v_vals.shape[-1]
    width = kernel_head_dim(d, dv)
    q, k_vals, v_vals = pad_head_dims(width, q, k_vals, v_vals)
    (sv,) = pad_head_dims(width, sv.float(), fill=1.0)
    q, k_vals, v_vals, sv = (_aligned(t) for t in (q, k_vals, v_vals, sv))
    sk_token, sk_tensor, gk = (None if t is None else _aligned(t.float())
                               for t in (sk_token, sk_tensor, gk))
    o = torch.empty_like(q)
    lse = (torch.empty(bh, n_q, device=q.device, dtype=torch.float32)
           if need_lse else None)
    q_out = qs_out = None
    if staged:
        q_out = torch.empty(bh, n_q, width, device=q.device,
                            dtype=_STAGED_DTYPES[q_mode])
        if q_mode != "raw":
            qs_out = torch.empty(bh, n_q, device=q.device)
    err = _build.library().tf_serving_attention(
        q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(), _ptr(sk_token),
        _ptr(sk_tensor), sv.data_ptr(), _ptr(gk), o.data_ptr(), _ptr(lse),
        _ptr(q_out), _ptr(qs_out), bh, n_q, n_kv, hq, hkv, width,
        *kernel_schedule(sched), _Q_MODES[q_mode],
        int(q.dtype == torch.float32), kernels.KV_CODES[k_vals.dtype],
        int(pv_quant), c, kernels.stream_handle(q),
    )
    _build.check(err, "tf_serving_attention")
    kernels.LAUNCHES["serving_attention"] += 1
    if lse is None:
        lse = torch.zeros(bh, n_q, device=q.device, dtype=torch.float32)
    o = slice_head_dims(o, dv)
    if staged:
        return o, lse, slice_head_dims(q_out, d), qs_out
    return o, lse


def _serving_plain(q, k_vals, v_vals, sk_token, sk_tensor, sv, gk,
                   sched: Schedule, hq: int, hkv: int, q_mode: str, c: float,
                   pv_quant: bool):
    """Plain PyTorch version of the kernel: stage Q, then the tile loop."""
    skf = 1.0
    if sk_tensor is not None:
        skf = sk_tensor[_kv_rows(q.shape[0], hq, hkv, q.device)][:, None, None]
    q_op, qs = _stage_q_plain(q, q_mode, c, skf)
    return _attend_plain(q_op, qs, k_vals, v_vals, sk_token, sv, gk, sched,
                         hq, hkv, q.dtype, pv_quant)


def _serving_attn(q, k_vals, v_vals, sk_token, sk_tensor, sv, gk,
                  sched: Schedule, hq: int, hkv: int, q_mode: str, c: float,
                  pv_quant: bool, need_lse: bool):
    """(o, lse) on flattened ``(B·H, n, d)`` q and ``(B·HKV, n, d)`` cache
    values: the plain version for CPU tensors, the kernel for CUDA ones."""
    args = (q, k_vals, v_vals, sk_token, sk_tensor, sv, gk, sched, hq, hkv,
            q_mode, c, pv_quant)
    if q.device.type == "cpu":
        return _serving_plain(*args)
    if q.device.type == "cuda":
        return _serving_attention_kernel(*args, need_lse)
    raise NotImplementedError(f"no attention path for device {q.device}")


def serving_flash_attention(
    q: torch.Tensor,
    kq: QArray,
    vq: QArray,
    *,
    q_dtype=None,
    schedule: str = "dense",
    scale: Optional[float] = None,
    radius: int = 0,
    section: int = 0,
    shift: int = 0,
    wrap_n: int = 0,
    shifted_causal: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    pv_quant: bool = False,
    bound_max: Optional[bool] = None,
    kv_split: int = 1,
    bh_block: Optional[int] = None,
    transposed: Optional[bool] = None,
    isolate: str = "",
    kv_resident: Optional[bool] = None,
    return_lse: bool = False,
):
    """Attention over a quantized KV set with fresh Q.

    ``q``: (batch, heads, n, d) bf16/f32; ``kq``: K as a :class:`QArray`
    with per-token scales (axis -1, ``(b, hkv, n, 1)``) or per-tensor
    (axis (-2, -1), ``(b, hkv, 1, 1)``); ``vq``: V per channel (axis -2).
    GQA: kv heads divide q heads. ``q_dtype``: int8, float8_e4m3fn, or
    None (weight-only). ``bound_max`` (default: on unless ``pv_quant``)
    takes the constant norm bound as the softmax max; ``pv_quant`` (int8
    cache only, exclusive with ``bound_max``) runs P·V in int8 with P
    quantized by a static ×127. o has q's dtype; lse natural-log units.

    ``transposed``, ``kv_split``, ``bh_block`` and ``kv_resident`` stage
    work for the TPU's units; they are accepted, and their invalid
    combinations raise the reference's ``ValueError``, but on the card
    they change nothing. ``block_q``/``block_kv`` only shape the
    reference's schedule (and ``kv_split``'s check); the kernel runs its
    own tiles (128 q rows by ``flash_q.kernel_block_kv`` kv rows). Any d
    and dv up to 512 run on the card; wider heads raise there (ROADMAP
    A15c) and run on CPU tensors. ``schedule``: dense, causal, local,
    local_causal (``radius``), circulant (``radius``, over the cache with
    2·radius phantom zero keys after it, as the reference computes it:
    :func:`~tpu_flash_torch.quant.flash_q.phantom_rows`), block
    (``section``) or shifted (``shift``, ``radius``, ``wrap_n``,
    ``shifted_causal``, the ring hop). ``isolate`` (an A/B diagnostic that
    computes wrong outputs by design) raises ``NotImplementedError``.
    """
    if isolate:
        raise NotImplementedError(
            "isolate is the reference's A/B diagnostic (wrong outputs by "
            "design); the port does not carry it (ROADMAP north star)")
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, n, d), got {tuple(q.shape)}")
    b, h, n_q, d = q.shape
    hkv, n_kv = kq.values.shape[1], kq.values.shape[2]
    dv = vq.values.shape[-1]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if q_dtype is not None:
        q_dtype = as_dtype(q_dtype)
    kv_dtype = as_dtype(kq.values.dtype)
    int8_mha_fast = (
        q_dtype == torch.int8 and d > 64 and h == hkv and (b * h) % 8 == 0
        and not pv_quant and kv_split == 1 and kv_resident is not True
        and bound_max is not False)
    if block_q is None and block_kv is None and bh_block is None \
            and int8_mha_fast:
        block_q, block_kv, bh_block = 1024, 1024, 8
    if block_q is None:
        block_q = 4096 if d > 64 else 1024
    if block_kv is None:
        block_kv = 2048
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q_dtype is not None:
        if (q_dtype == torch.int8) != (kv_dtype == torch.int8):
            raise ValueError(
                "q_dtype and the cache dtype must share the input family")
        q_mode = "int8" if q_dtype == torch.int8 else "fp8"
    else:
        q_mode = "raw"
    if pv_quant and kv_dtype != torch.int8:
        raise ValueError("pv_quant requires an int8 cache (int8 V̂ pages)")
    if bound_max and pv_quant:
        # pv_quant's static ×127 P scale needs the true running max
        raise ValueError("bound_max and pv_quant are mutually exclusive")
    if bound_max is None:
        bound_max = not pv_quant

    sched = build_schedule(schedule, n_q, n_kv, block_q, block_kv,
                           radius=radius, section=section, shift=shift,
                           wrap_n=wrap_n, shifted_causal=shifted_causal)
    g = h // hkv
    if bh_block is None:
        bh_block = 1
    if bh_block > 1:
        if g != 1:
            raise ValueError("bh_block > 1 requires MHA (hkv == h)")
        if kv_split != 1:
            raise ValueError("bh_block and kv_split are exclusive stagings")
        if (b * h) % bh_block:
            raise ValueError(f"batch*heads {b * h} not divisible by {bh_block}")
    if transposed is None:
        transposed = (d <= 64 and dv <= 64 and not pv_quant and kv_split == 1
                      and bh_block == 1 and not kv_resident)
    if transposed and bh_block > 1:
        raise ValueError("bh_block is a standard-layout knob")
    if transposed and kv_resident:
        raise ValueError("kv_resident is a standard-layout knob")
    if transposed:
        if pv_quant:
            raise ValueError("pv_quant requires the standard layout")
        if kv_split != 1:
            raise ValueError("kv_split is a standard-layout knob")
    else:
        bkv = sched.block_kv
        if kv_split < 1 or bkv % kv_split or (bkv // kv_split) % 128:
            raise ValueError(
                f"kv_split={kv_split} must divide block_kv={bkv} into "
                "128-aligned sub-tiles")
        if kv_resident and schedule != "dense":
            raise ValueError("kv_resident requires the dense schedule")
        if kv_resident and pv_quant:
            raise ValueError("pv_quant's int8 PV path has no bf16 V staging")

    if schedule == "circulant":
        kq, vq = phantom_rows(kq, vq, 2 * radius)
    o, lse = _serving_attn(
        *serving_operands(q, kq, vq, bound_max), sched, h, hkv, q_mode,
        f32(scale * LOG2E), pv_quant, return_lse)
    o = o.reshape(b, h, n_q, dv)
    if return_lse:
        return o, lse.reshape(b, h, n_q)
    return o


def quantize_kv_cache(k, v, kv_dtype, *, kv_scale: str = "token"):
    """Quantize K/V once for :func:`serving_flash_attention` (the write side
    of the cache). ``kv_scale``: "token" (per key) or "tensor" (per
    batch·head)."""
    kv_dtype = as_dtype(kv_dtype)
    kq = quantize(k, kv_dtype, axis=-1 if kv_scale == "token" else (-2, -1))
    vq = quantize(v, kv_dtype, axis=-2)
    return kq, vq
