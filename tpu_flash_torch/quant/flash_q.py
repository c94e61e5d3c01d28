"""Quantized flash-attention forward (B7): port of ``tpu_flash/quant/flash_q.py``
on the dense, causal, local, local_causal, circulant, block-diagonal and
shifted (ring-hop) schedules.

* **activation-quant** (``q_dtype`` int8): int8 q̂·k̂ with int32
  accumulation, dequantized on the score matrix (``s = (q̂·k̂)·σq·log2e·σk``).
* **fp8 Q** (``q_dtype`` e4m3): Q is quantized per token onto e4m3 on the
  host and handed to the kernel as e4m3 q̂ with its row factors
  f = σq·(log2e·σk_fold); the kernel dots q̂·k̂ on the fp8 units and scales
  the float32 score by f (the plain version sums those products as the
  fp8 units do, :func:`fp8_scores`). The reference folds f into a bf16 Q
  (``flash_q.py:555-566``) only because its TPU has no fp8 unit; e5m2 Q
  keeps that bf16 fold here (a variant: the card's fp8 products take e4m3
  Q).
* **weight-only** (``q_dtype=None``): bf16 Q against K̂ decoded in the
  kernel, the KV-cache compression mode.
* V is per-channel quantized, so its dequant is one multiply of the final
  accumulator. ``kv_scale="tensor"`` folds the per-(batch, kv head) K scale
  into Q (expanded per q head under GQA).

The cache is decoded exactly: int8 and both fp8 formats are subsets of
bf16, so the kernel (``csrc/quant_attention.cu``) and the plain version
decode K̂/V̂ with a type cast. The reference's ``_fp8_upcast`` bit trick,
which decodes e4m3 subnormals approximately, is not ported; the norm bound
is computed on the values the port dots (:func:`scaled_k_norms`).

:func:`_quantized_fwd` dispatches on the device: CPU tensors take the plain
PyTorch version :func:`_quant_plain`, CUDA tensors launch the kernel
through :func:`_quant_attention_kernel`, or raise. The port masks ragged
edges in the kernel, so the reference's ``_pad_scales`` has no counterpart;
on the card head and value dims are zero-padded to the kernel's width
(``ops/flash.py:pad_head_dims``: K̂/V̂ with byte 0, σv with 1) and o is
sliced back. At d ≤ 64 the reference routes every schedule but the
circulant to its transposed serving kernel (B8); the port keeps that
routing to ``quant/serving_attn.py`` (one kernel serves both on the card).
The circulant quantizes halo-extended K/V (``cat([k[-r:], k, k[:r]])``),
as the reference does, and stays on B7 at any d.
"""

from __future__ import annotations

import math
import struct
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import (
    DEFAULT_MASK_VALUE,
    LN2,
    LOG2E,
    _aligned,
    _kv_rows,
    build_schedule,
    halo_extend,
    kernel_head_dim,
    kernel_schedule,
    pad_head_dims,
    slice_head_dims,
)
from tpu_flash_torch.ops.schedule import Schedule, cdiv, kv_tile_range
from tpu_flash_torch.quant.qarray import FP8, QArray, as_dtype, quantize


# the kernel's q tile: two consumer warpgroups of 64 rows
KERNEL_BQ = 128


def kernel_block_kv(d: int, dv: int) -> int:
    """The kernel's kv tile at head dim d, value dim dv: 128 rows at widths
    up to 128, 64 at 256, 32 at 512, where the weight-only mode's Q (128
    KB) and one stage of K̂, half of V̂ and their bf16 decodes fill the
    block's shared memory. The plain version walks the same tiles, so its
    running max (and with it every rounding of P) follows the kernel's; on
    CPU tensors it takes any width, tiles of 32 above 256."""
    w = max(d, dv)
    return 128 if w <= 128 else 64 if w <= 256 else 32


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: the value the reference
    multiplies by where it multiplies a float32 array by a Python number."""
    return struct.unpack("f", struct.pack("f", x))[0]


def scaled_k_norms(k_vals: torch.Tensor, sk_row=None) -> torch.Tensor:
    """Per-token ‖K̂‖·σ_k on ``(bh_kv, n, d)`` int8/fp8/float values (and
    optional ``(bh_kv, n)`` scales) → ``(bh_kv, n)`` float32: the norm
    bound's key side, on the values the kernel dots (exact decode)."""
    kf = k_vals.float()
    kn = torch.sqrt(torch.sum(kf * kf, dim=-1))
    if sk_row is not None:
        kn = kn * sk_row
    return kn


def _attend_plain(q_op, qs, k_vals, v_vals, sk, sv, gk, sched: Schedule,
                  hq: int, hkv: int, out_dtype, pv_quant: bool = False):
    """Plain PyTorch version of the kernel's tile loop → (o, lse).

    ``q_op``: ``(bh, n_q, d)`` bf16 score operand (scale and log2e folded
    in), or int8 / e4m3 q̂ with ``qs`` ``(bh, n_q)`` its row factors (the
    score is (q̂·k̂)·f·σk); ``k_vals``/
    ``v_vals``: ``(bh_kv, n_kv, d)`` int8/fp8 (the circulant's
    halo-extended); ``sk``: ``(bh_kv, n_kv)``
    per-token K scales or None; ``sv``: ``(bh_kv, dv)``; ``gk``: ``(bh_kv,)``
    max scaled key norms (constant bound) or None (exact running max).
    Each of the kernel's 128-row q tiles walks the kv tiles the kernel
    visits for it (:func:`~tpu_flash_torch.ops.schedule.kv_tile_range`)
    with the same arithmetic, masked by ``sched.visible``: the running max,
    and with it every rounding of P, follows the kernel's. e4m3 q̂ dots K̂
    as the card's fp8 units sum (:func:`fp8_scores`); memory is
    O(bh·n_q·(d + tile)), so the headline shape fits in a few GB.
    """
    bh, n_q, d = q_op.shape
    n_kv, dv = k_vals.shape[1], v_vals.shape[-1]
    tile = kernel_block_kv(d, dv)
    dev = q_op.device
    rows = _kv_rows(bh, hq, hkv, dev)
    fp8 = q_op.dtype == torch.float8_e4m3fn
    nqt, nkt = cdiv(n_q, KERNEL_BQ), cdiv(n_kv, tile)

    def tiled(x, n_tiles, size):  # (B, n, ...) → (B, n_tiles, size, ...)
        x = torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 2) + (0, n_tiles * size - x.shape[1]))
        return x.reshape(x.shape[0], n_tiles, size, *x.shape[2:])

    qf = tiled(q_op.float(), nqt, KERNEL_BQ)
    qsf = None if qs is None else tiled(qs, nqt, KERNEL_BQ)
    # exact decode: int8 and fp8 values are exact in float32, so int8
    # products and their sums (< 2²⁴) are exact as well
    kf = tiled(k_vals.float()[rows], nkt, tile)
    vf = tiled(v_vals.float()[rows], nkt, tile)
    skf = None if sk is None else tiled(sk[rows], nkt, tile)
    if gk is None:
        m = torch.full((bh, nqt, KERNEL_BQ, 1), DEFAULT_MASK_VALUE, device=dev)
    else:
        qn = torch.sqrt(torch.sum(qf * qf, dim=-1, keepdim=True))
        if qsf is not None:
            qn = qn * qsf[..., None]
        m = qn * (gk[rows] * f32(1.0001))[:, None, None, None]
    l = torch.zeros(bh, nqt, KERNEL_BQ, 1, device=dev)
    acc = torch.zeros(bh, nqt, KERNEL_BQ, dv, device=dev)
    visits = [kv_tile_range(sched, n_kv, i * KERNEL_BQ,
                            min((i + 1) * KERNEL_BQ, n_q) - 1, tile)
              for i in range(nqt)]
    qpos = torch.arange(nqt * KERNEL_BQ, device=dev).reshape(nqt, -1, 1)
    for step in range(max([last - first + 1 for first, last in visits],
                          default=0)):
        # the q tiles still walking, and the kv tile each visits: one
        # tile for all of them (dense, causal, their early steps) is read
        # once and broadcast
        live = [i for i, (first, last) in enumerate(visits)
                if first + step <= last]
        js = [visits[i][0] + step for i in live]
        sel = (slice(None) if len(live) == nqt
               else torch.tensor(live, device=dev))
        jt = (slice(js[0], js[0] + 1) if js.count(js[0]) == len(js)
              else torch.tensor(js, device=dev))
        q_s, k_s = qf[:, sel], kf[:, jt]
        if fp8:
            b_ = bh * len(live)
            sc = fp8_scores(q_s.reshape(b_, KERNEL_BQ, -1),
                            k_s.expand(bh, len(live), -1, -1).reshape(
                                b_, tile, -1), q_op.dtype,
                            k_vals.dtype).reshape(bh, len(live), KERNEL_BQ,
                                                  tile)
        else:
            sc = q_s @ k_s.transpose(-1, -2)
        if qsf is not None:
            sc = sc * qsf[:, sel, :, None]
        if skf is not None:
            sc = sc * skf[:, jt, None, :]
        kpos = (torch.tensor(js, device=dev)[:, None] * tile
                + torch.arange(tile, device=dev))[:, None]
        vis = sched.visible(qpos[sel], kpos)
        vis = kpos < n_kv if vis is None else vis & (kpos < n_kv)
        sc = torch.where(vis, sc, DEFAULT_MASK_VALUE)
        m_s, l_s, acc_s = m[:, sel], l[:, sel], acc[:, sel]
        if gk is None:
            m_next = torch.maximum(m_s, sc.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m_s - m_next)
            l_s, acc_s, m_s = alpha * l_s, acc_s * alpha, m_next
        p = torch.exp2(sc - m_s)
        l_s = l_s + p.sum(dim=-1, keepdim=True)
        if pv_quant:
            p8 = torch.clamp(torch.round(p * 127.0), 0, 127)
            pv = (p8 @ vf[:, jt]) * f32(1 / 127)
        else:
            pv = p.to(torch.bfloat16).float() @ vf[:, jt]
        m[:, sel], l[:, sel], acc[:, sel] = m_s, l_s, acc_s + pv
    m, l, acc = (x.reshape(bh, nqt * KERNEL_BQ, -1)[:, :n_q]
                 for x in (m, l, acc))
    valid = (l > 0.0) & (m > DEFAULT_MASK_VALUE * 0.5)
    l_safe = torch.where(l > 0.0, l, 1.0)
    l_inv = torch.where(valid, 1.0 / l_safe, 0.0)
    o = ((acc * l_inv) * sv[rows][:, None, :]).to(out_dtype)
    lse = torch.where(valid, m * LN2 + torch.log(l_safe), float("-inf"))
    return o, lse[..., 0]


def check_kernel_operands(name: str, q, k_vals, v_vals, hq: int, hkv: int):
    """Raise on what the quantized-attention kernel does not take."""
    tensors = (q, k_vals, v_vals)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if k_vals.dtype not in kernels.KV_CODES or v_vals.dtype != k_vals.dtype:
        raise NotImplementedError(
            f"{name} takes an int8/e4m3/e5m2 cache, got "
            f"{k_vals.dtype}/{v_vals.dtype}")
    bh, _, d = q.shape
    if k_vals.shape[-1] != d:
        raise ValueError(f"{name}: q and k head dims differ: {d} vs "
                         f"{k_vals.shape[-1]}")
    kernel_head_dim(d, v_vals.shape[-1])  # raises above 512 (A15c)
    if bh % hq or k_vals.shape[0] != bh // hq * hkv or \
            v_vals.shape[:2] != k_vals.shape[:2]:
        raise ValueError(f"bad GQA shapes {q.shape} {k_vals.shape} "
                         f"{v_vals.shape}")


# Least exponent of each fp8 format (its subnormals' exponent field).
FP8_EMIN = {torch.float8_e4m3fn: -6, torch.float8_e5m2: -14}


def _exponents(x: torch.Tensor, emin: int) -> torch.Tensor:
    """Exponent fields of fp8 values held in float32 (subnormals at
    ``emin``); zeros at -1000, below any product's."""
    e = torch.clamp_min(torch.frexp(x).exponent.float() - 1, emin)
    return torch.where(x != 0, e, -1000.0)


def _truncate(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x`` truncated toward zero to a multiple of 2**e (exact)."""
    u = torch.exp2(e)
    return torch.trunc(x / u) * u


def _fp8_step(q, k, eq, ek):
    """One k32 step of :func:`fp8_scores`: q (B, r, 32), k (B, n, 32)."""
    p = q[:, :, None] * k[:, None]  # exact in float32
    e = torch.clamp_min((eq[:, :, None] + ek[:, None]).amax(-1) + 1, -100.0)
    t = _truncate(p, (e - 14)[..., None]).sum(-1)  # exact: < 2^20 units
    return _truncate(t, torch.frexp(t).exponent.float() - 14)


def fp8_scores(q: torch.Tensor, k: torch.Tensor, q_dtype,
               k_dtype) -> torch.Tensor:
    """Σ q̂·k̂ of fp8 values held in float32, q (B, n_q, d) and k (B, n_kv,
    d) → (B, n_q, n_kv) float32, as the kernel sums them on the card's fp8
    tensor cores: each k32 step on its own, the steps then added in float32
    in order. Within a step, with E the largest e(q̂ᵢ) + e(k̂ᵢ) + 1 over the
    nonzero products (e the exponent field), each product is truncated
    toward zero to a multiple of 2^(E−14), the truncated products add
    exactly, and their sum is truncated toward zero to 14 significant bits.
    That reproduces every one of 131072 one-step sums measured on an NVIDIA
    H100 (``bench/fp8_sums.py``, PERF.md §6); float32 sums would move a
    single-key lse by up to 3e-4."""
    eq, ek = _exponents(q, FP8_EMIN[q_dtype]), _exponents(k, FP8_EMIN[k_dtype])
    b, n_q, d = q.shape
    # rows a pass, bounding its (B, rows, n_kv, 32) temporaries
    rows = max(1, (1 << (27 if q.is_cuda else 22)) // (b * k.shape[1] * 32))
    out = None
    for c in range(0, d, 32):
        part = torch.cat([
            _fp8_step(q[:, r:r + rows, c:c + 32], k[..., c:c + 32],
                      eq[:, r:r + rows, c:c + 32], ek[..., c:c + 32])
            for r in range(0, n_q, rows)], dim=1)
        out = part if out is None else out + part
    return out


# B7's Q operand types (codes of tf_quant_attention)
_Q_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def q_factor_multiplier(dtype) -> float:
    """What B7 multiplies a host row factor by: log2e for int8 q̂ (its
    factor is σq), 1 for e4m3 q̂ (log2e already folded in)."""
    return f32(LOG2E) if dtype == torch.int8 else 1.0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _quant_attention_kernel(q_op, sq, k_vals, v_vals, sk, sv, gk,
                            sched: Schedule, hq: int, hkv: int, out_dtype,
                            need_lse: bool):
    """Launch ``tf_quant_attention`` on CUDA tensors. ``q_op``: bf16 score
    operand, or int8 / e4m3 q̂ with ``sq`` ``(bh, n_q)`` its row factors
    (times :func:`q_factor_multiplier` in the kernel); the rest as
    :func:`_attend_plain`. Head and value dims are zero-padded to the
    kernel's width and o sliced back."""
    from tpu_flash_torch.kernels import _build

    check_kernel_operands("quant_attention kernel", q_op, k_vals, v_vals, hq,
                          hkv)
    if q_op.dtype not in _Q_KINDS or (
            (q_op.dtype != torch.bfloat16) != (sq is not None)):
        raise NotImplementedError(
            f"quant_attention kernel takes bf16 Q, or int8 / e4m3 q̂ with row "
            f"factors, got {q_op.dtype}")
    if (q_op.dtype == torch.int8) != (k_vals.dtype == torch.int8) and \
            q_op.dtype != torch.bfloat16:
        raise NotImplementedError("8-bit q̂ needs a cache of its family")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"quant_attention kernel writes f32 or bf16 "
                                  f"o, not {out_dtype}")
    bh, n_q, d = q_op.shape
    n_kv, dv = k_vals.shape[1], v_vals.shape[-1]
    width = kernel_head_dim(d, dv)
    q_op, k_vals, v_vals = pad_head_dims(width, q_op, k_vals, v_vals)
    (sv,) = pad_head_dims(width, sv.float(), fill=1.0)
    q_op, k_vals, v_vals, sv = (_aligned(t) for t in (q_op, k_vals, v_vals,
                                                      sv))
    sq = None if sq is None else _aligned(sq.float())
    sk = None if sk is None else _aligned(sk.float())
    gk = None if gk is None else _aligned(gk.float())
    o = torch.empty(bh, n_q, width, device=q_op.device, dtype=out_dtype)
    lse = (torch.empty(bh, n_q, device=q_op.device, dtype=torch.float32)
           if need_lse else None)
    err = _build.library().tf_quant_attention(
        q_op.data_ptr(), _ptr(sq), k_vals.data_ptr(), v_vals.data_ptr(),
        _ptr(sk), sv.data_ptr(), _ptr(gk), o.data_ptr(), _ptr(lse),
        bh, n_q, n_kv, hq, hkv, width, *kernel_schedule(sched),
        _Q_KINDS[q_op.dtype],
        kernels.KV_CODES[k_vals.dtype], int(out_dtype == torch.float32),
        q_factor_multiplier(q_op.dtype), kernels.stream_handle(q_op),
    )
    _build.check(err, "tf_quant_attention")
    kernels.LAUNCHES["quant_attention"] += 1
    if lse is None:
        lse = torch.zeros(bh, n_q, device=q_op.device, dtype=torch.float32)
    return slice_head_dims(o, dv), lse


def quant_operands(qq: Optional[QArray], q_raw, kq: QArray, vq: QArray,
                   k_scaled: bool, bound_max: bool):
    """Flattened operands → the kernel's: ``(q_op, sq, k̂, v̂, per-token K
    scales (bh_kv, n_kv) or None, V scales (bh_kv, dv), gk (bh_kv,) or
    None)``. ``qq``: int8 q̂ with ``(bh, n_q, 1)`` scales or e4m3 q̂ with
    row factors, or ``q_raw`` the bf16 operand; ``kq`` values ``(bh_kv, n_kv, d)`` with per-token scales
    ``(bh_kv, n_kv, 1)`` when ``k_scaled``; ``vq`` per channel."""
    bh_kv, n_kv = kq.values.shape[:2]
    sk = kq.scales.reshape(bh_kv, n_kv) if k_scaled else None
    gk = scaled_k_norms(kq.values, sk).amax(dim=-1) if bound_max else None
    return (qq.values if qq is not None else q_raw,
            None if qq is None else qq.scales[..., 0], kq.values, vq.values,
            sk, vq.scales.reshape(bh_kv, -1), gk)


def _quant_plain(q_op, sq, k_vals, v_vals, sk, sv, gk, sched: Schedule,
                 hq: int, hkv: int, out_dtype):
    """Plain PyTorch version of the B7 kernel (same contract as
    :func:`_quant_attention_kernel`)."""
    qs = None if sq is None else sq * q_factor_multiplier(q_op.dtype)
    return _attend_plain(q_op, qs, k_vals, v_vals, sk, sv, gk, sched, hq, hkv,
                         out_dtype)


def _quantized_fwd(qq: Optional[QArray], q_raw, kq: QArray, vq: QArray,
                   sched: Schedule, *, out_dtype, hq: int = 1, hkv: int = 1,
                   k_scaled: bool = True, need_lse: bool = True,
                   bound_max: bool = True):
    """(o, lse) on flattened ``(B·H, n, d)`` operands (see
    :func:`quant_operands`): the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    ops = quant_operands(qq, q_raw, kq, vq, k_scaled, bound_max)
    if ops[0].device.type == "cpu":
        return _quant_plain(*ops, sched, hq, hkv, out_dtype)
    if ops[0].device.type == "cuda":
        return _quant_attention_kernel(*ops, sched, hq, hkv, out_dtype,
                                       need_lse)
    raise NotImplementedError(f"no attention path for device {ops[0].device}")


def quantized_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_dtype="int8",
    kv_dtype="int8",
    schedule: str = "dense",
    scale: Optional[float] = None,
    radius: int = 0,
    section: int = 0,
    shift: int = 0,
    wrap_n: int = 0,
    shifted_causal: bool = False,
    block_q: int = 1024,
    block_kv: int = 2048,
    kv_scale: str = "token",
    return_lse: bool = False,
    bound_max: bool = True,
    transposed: Optional[bool] = None,
):
    """Quantize-and-attend on ``(batch, heads, n, d)`` inputs.

    ``q_dtype``: int8 / float8_e4m3fn / float8_e5m2, or None for the
    weight-only mode; ``kv_dtype``: int8 / fp8 (torch dtypes or their
    names). ``kv_scale``: "token" (one K scale per key, applied to the
    score columns in the kernel) or "tensor" (one per (batch, kv head),
    folded into Q; fp8 only). ``bound_max=True`` takes the constant
    Cauchy–Schwarz bound as the softmax max (exact online softmax), False
    the exact running max. ``block_q``/``block_kv`` only shape the
    reference's schedule; the kernel runs its own tiles (128 q rows by
    :func:`kernel_block_kv` kv rows). Any d and dv up to 512 run on the
    card (above 256 with O's 256-column halves on the grid); wider heads
    raise there (ROADMAP A15c) and run on CPU tensors. ``schedule``:
    dense, causal, local, local_causal (``radius``), circulant
    (``radius``; K/V halo-extended before they are quantized, as in the
    reference), block (``section``) or shifted (``shift``,
    ``radius``, ``wrap_n``, ``shifted_causal``: the ring hop of
    ``ops/flash.py:flash_attention``). At d ≤ 64 the dense, causal, local,
    local_causal and block schedules go to :func:`~tpu_flash_torch.quant.
    serving_attn.serving_flash_attention`, as in the reference
    (``transposed``); the circulant and shifted ones stay here.
    """
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, n, d), got {tuple(q.shape)}")
    hq, hkv = q.shape[1], k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    kv_dtype = as_dtype(kv_dtype)
    if q_dtype is not None:
        q_dtype = as_dtype(q_dtype)
        if (q_dtype == torch.int8) != (kv_dtype == torch.int8):
            raise ValueError(
                f"q_dtype {q_dtype} and kv_dtype {kv_dtype} must share the "
                "input family (both int8, or both fp8)")
    b, h, n_q, d = q.shape
    n_kv, dv = k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sched = build_schedule(schedule, n_q, n_kv, block_q, block_kv,
                           radius=radius, section=section, shift=shift,
                           wrap_n=wrap_n, shifted_causal=shifted_causal)
    if kv_scale not in ("token", "tensor"):
        raise ValueError(
            f"kv_scale must be 'token' or 'tensor', got {kv_scale!r}")
    k_scaled = kv_scale == "token"
    if not k_scaled and (kv_dtype not in FP8 or
                         (q_dtype is not None and q_dtype not in FP8)):
        raise ValueError(
            "kv_scale='tensor' is the fp8 scaling mode (int8 keeps the "
            "native int8 path with per-token scales)")
    k_axis = -1 if k_scaled else (-2, -1)
    if transposed is None:
        # the circulant stays here with its halo, as in the reference
        transposed = (d <= 64 and dv <= 64 and schedule in (
            "dense", "causal", "local", "local_causal", "block") and q_dtype in (
            None, torch.int8, torch.float8_e4m3fn))
    if transposed:
        from tpu_flash_torch.quant.serving_attn import serving_flash_attention

        return serving_flash_attention(
            q, quantize(k, kv_dtype, axis=k_axis),
            quantize(v, kv_dtype, axis=-2), q_dtype=q_dtype,
            schedule=schedule, scale=scale, radius=radius, section=section,
            block_q=block_q, block_kv=block_kv, bound_max=bound_max,
            transposed=True, return_lse=return_lse)

    if schedule == "circulant":  # quantized after the halo extension
        k, v = halo_extend(k, radius), halo_extend(v, radius)
    qq, q_raw, kq, vq = prepare_quantized(q, k, v, q_dtype, kv_dtype,
                                          k_scaled, scale)
    o, lse = _quantized_fwd(
        qq, q_raw, kq, vq, sched, out_dtype=q.dtype, hq=h, hkv=hkv,
        k_scaled=k_scaled, need_lse=return_lse, bound_max=bound_max)
    o = o.reshape(b, h, n_q, dv)
    if return_lse:
        return o, lse.reshape(b, h, n_q)
    return o


def prepare_quantized(q, k, v, q_dtype, kv_dtype, k_scaled: bool,
                      scale: float):
    """The host side of :func:`quantized_flash_attention` on
    ``(b, h, n, d)`` inputs → flattened ``(qq, q_raw, kq, vq)`` for
    :func:`quant_operands`: K per token (or per (batch, kv head), folded
    into Q, expanded per q head), V per channel; int8 Q quantized per
    token; e4m3 Q quantized per token, with row factors σq·log2e·σk_fold
    as its scales; e5m2 Q quantized, then handed over dequantized in bf16
    with the scale and log2e folded in (bf16 holds every fp8 value);
    weight-only Q scaled in bf16."""
    b, h, n_q, d = q.shape
    hkv, n_kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    qf = (q.float() * f32(scale)).reshape(b * h, n_q, d)
    kq = quantize(k.reshape(b * hkv, n_kv, d), kv_dtype,
                  axis=-1 if k_scaled else (-2, -1))
    vq = quantize(v.reshape(b * hkv, n_kv, dv), kv_dtype, axis=-2)
    sk_in_q = 1.0 if k_scaled else torch.repeat_interleave(
        kq.scales.reshape(b, hkv, 1, 1), h // hkv, dim=1).reshape(b * h, 1, 1)
    fold = f32(LOG2E) * sk_in_q
    if q_dtype is None:
        return None, (qf * fold).to(torch.bfloat16), kq, vq
    if q_dtype == torch.float8_e4m3fn:
        qv = quantize(qf, q_dtype, axis=-1)
        return QArray(qv.values, qv.scales * fold, axis=-1), None, kq, vq
    return (*_quantized_q(qf, q_dtype, fold), kq, vq)


def _quantized_q(qf, q_dtype, fold):
    """Scaled float32 Q → ``(qq, q_raw)``: int8 Q as a token-scaled
    :class:`QArray` (``q_raw`` None); fp8 Q quantized, then dequantized
    times ``fold`` (log2e, and the K scale under kv_scale="tensor") in
    bf16 (``qq`` None)."""
    if q_dtype == torch.int8:
        return quantize(qf, torch.int8, axis=-1), None
    qv = quantize(qf, q_dtype, axis=-1)
    return None, ((qv.values.float() * qv.scales) * fold).to(torch.bfloat16)


def phantom_rows(kq: QArray, vq: QArray, rows: int):
    """``(b, hkv, n, ·)`` K̂/V̂ with ``rows`` zero rows (byte 0) after
    them, per-token K scales 1.0 there. The reference runs a circulant over
    K/V that were not halo-extended (the cache of
    ``serving_flash_attention``, the operands of
    ``quantized_flash_attention_prequant``) against its padded length
    n + 2·radius: the padding rows stay visible, as keys of score 0 and
    value 0 (ROADMAP C). These rows reproduce that."""
    if rows <= 0:
        return kq, vq

    def pad(x, fill):
        tail = torch.full((*x.shape[:2], rows, x.shape[-1]), fill,
                          dtype=torch.float32, device=x.device).to(x.dtype)
        return torch.cat([x, tail], dim=2)

    per_token = kq.axis in (-1, kq.values.ndim - 1)
    k_scales = pad(kq.scales, 1.0) if per_token else kq.scales
    return (QArray(pad(kq.values, 0.0), k_scales, kq.axis),
            QArray(pad(vq.values, 0.0), vq.scales, vq.axis))


def quantized_dense_fa(q, k, v, **kw):
    """Dense quantized attention (see :func:`quantized_flash_attention`)."""
    return quantized_flash_attention(q, k, v, schedule="dense", **kw)


def prepare_ring_operands(q, k, v, *, q_dtype, kv_dtype, scale=None):
    """Quantize Q, K, V once for :func:`quantized_flash_attention_prequant`.

    Returns ``(q_pre, kq, vq)``: ``kq`` per-token K, ``vq`` per-channel V;
    ``q_pre`` an int8 token-scaled :class:`QArray` (int8), the bf16
    dequantized fp8 values with scale and log2e folded in (fp8), or the bf16
    scaled Q (``q_dtype=None``, weight-only).
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kv_dtype = as_dtype(kv_dtype)
    kq = quantize(k, kv_dtype, axis=-1)
    vq = quantize(v, kv_dtype, axis=-2)
    if q_dtype is None:
        return (q.float() * f32(scale * LOG2E)).to(torch.bfloat16), kq, vq
    q_dtype = as_dtype(q_dtype)
    if (q_dtype == torch.int8) != (kv_dtype == torch.int8):
        raise ValueError("q/kv dtypes must share the input family")
    qq, q_raw = _quantized_q(q.float() * f32(scale), q_dtype, f32(LOG2E))
    return (q_raw if qq is None else qq), kq, vq


def quantized_flash_attention_prequant(
    q_pre,
    kq: QArray,
    vq: QArray,
    *,
    schedule: str = "dense",
    radius: int = 0,
    section: int = 0,
    shift: int = 0,
    wrap_n: int = 0,
    shifted_causal: bool = False,
    block_q: int = 1024,
    block_kv: int = 2048,
    out_dtype=torch.bfloat16,
    return_lse: bool = False,
    bound_max: bool = True,
):
    """Attend with operands from :func:`prepare_ring_operands` — no
    quantize preamble. ``(batch, heads, n, d)`` values; per-token K scales,
    per-channel V scales; GQA (kv heads divide q heads). Schedules as
    :func:`quantized_flash_attention`; the circulant takes the K/V it is
    given, with 2·radius zero rows after them (:func:`phantom_rows`), as
    the reference does. This is the quantized ring's hop: the shifted
    schedule with the norm bound by default, as in the reference."""
    q_vals = q_pre.values if isinstance(q_pre, QArray) else q_pre
    b, h, n_q, d = q_vals.shape
    hkv, n_kv = kq.values.shape[1], kq.values.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    dv = vq.values.shape[-1]
    sched = build_schedule(schedule, n_q, n_kv, block_q, block_kv,
                           radius=radius, section=section, shift=shift,
                           wrap_n=wrap_n, shifted_causal=shifted_causal)
    if schedule == "circulant":
        kq, vq = phantom_rows(kq, vq, 2 * radius)
        n_kv += 2 * radius
    kqf = QArray(kq.values.reshape(b * hkv, n_kv, d),
                 kq.scales.reshape(b * hkv, n_kv, 1), axis=-1)
    vqf = QArray(vq.values.reshape(b * hkv, n_kv, dv),
                 vq.scales.reshape(b * hkv, 1, dv), axis=-2)
    qq = q_raw = None
    if isinstance(q_pre, QArray):
        qq = QArray(q_vals.reshape(b * h, n_q, d),
                    q_pre.scales.reshape(b * h, n_q, 1), axis=-1)
    else:
        q_raw = q_vals.reshape(b * h, n_q, d)
    o, lse = _quantized_fwd(
        qq, q_raw, kqf, vqf, sched, out_dtype=out_dtype, hq=h, hkv=hkv,
        k_scaled=True, need_lse=return_lse, bound_max=bound_max)
    o = o.reshape(b, h, n_q, dv)
    if return_lse:
        return o, lse.reshape(b, h, n_q)
    return o
