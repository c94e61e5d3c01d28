"""Fused attention forward (B1): port of ``flash_attention`` and its public
wrappers (``dense_fa``, ``sliding_fa``, ``circulant_fa``, ``block_fa``,
``windowed_fa``, with N-d ``(batch, *spatial, heads, d)`` inputs) from
``tpu_flash/ops/flash.py`` for the dense, causal, local, local_causal,
block-diagonal, circulant and shifted (ring-hop) schedules.

Public layout ``(batch, heads, n, d)``, GQA through the kv-row map, lse in
natural-log units, and a fully masked row gives o = 0, lse = −inf. The
softmax is base 2: q is prescaled by ``scale·log2(e)`` in float32 and cast
back to its dtype, scores accumulate in float32, P is cast to V's dtype
before the PV product. The running max is exact, or with ``bound_max`` the
constant norm bound ``‖q̃_i‖·max_j‖k_j‖·1.0001`` (no max pass, no rescale):
the reference's B1 bound and its d ≤ 64 transposed kernel B9
(``_fwd_kernel_t``) both compute that function, so B9 folds into B1 here,
as the band kernel B11 (``_fwd_kernel_band``, the same local and circulant
schedules with the kv band streamed by a manual DMA) does. The circulant
band runs over halo-extended K/V (``cat([k[-r:], k, k[:r]])``, built here as
the reference builds it), so query ``i`` sees the contiguous extended keys
``[i, i + 2r]``; the block-diagonal schedule visits only each query tile's
own section.

:func:`_flash_fwd` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version :func:`_flash_fwd_plain`; CUDA tensors launch the
hand-written kernel in ``csrc/flash_fwd.cu`` through
:func:`_flash_fwd_kernel`, or raise: bf16 on its TMA + ``wgmma`` kernel
(64 q rows a consumer warpgroup, S, P and O in registers; at width 512 O's
256-column halves on the grid), float32 on ``csrc/flash_fwd_f32.cuh``'s:
every product in three TF32 passes on ``wgmma`` (3×TF32) behind a TMA
ring, O summed transposed, at 256 and 512 the head dim split across a 2-
or 4-CTA cluster. ``ops/flash_bwd.py:tf32x3`` models that product;
:func:`_flash_fwd_plain` takes it as ``products=`` for the tests and the
chip check, and stays exact float32 otherwise.

:class:`_FlashAttention` makes the core differentiable, the counterpart of
the reference's ``_fa`` custom VJP: its backward is
``ops/flash_bwd.py:flash_backward`` (B4 + B5 on the card for the dense and
every schedule of the forward, with the int8 dp product and ``split``
through ``bwd_quant`` and ``bwd_split``). The prescale of q and its cast,
and the circulant halo, stay outside it, so autograd puts ``scale·log2(e)``
on dq and folds the halo's gradient back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.schedule import (
    BlockDiagonalSchedule,
    CausalSchedule,
    CirculantSchedule,
    LocalSchedule,
    Schedule,
    ShiftedMaskSchedule,
    cdiv,
)
from tpu_flash_torch.utils.layout import (
    flatten_spatial,
    unflatten_spatial,
    windowed,
)

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
_LANES = 128

# the norm bound's slack over ‖q̃_i‖·max_j‖k_j‖ (the reference's factor)
BOUND_SLACK = 1.0001
# schedule kinds of csrc/flash_fwd.cu
_KIND = {(Schedule, False): 0, (CausalSchedule, False): 1,
         (LocalSchedule, False): 2, (LocalSchedule, True): 3,
         (CirculantSchedule, False): 4, (BlockDiagonalSchedule, False): 5,
         (ShiftedMaskSchedule, False): 6, (ShiftedMaskSchedule, True): 7}


def kernel_schedule(sched: Schedule) -> tuple[int, int, int, int]:
    """The schedule as the kernels take it (``csrc/schedule.cuh:Sched``):
    kind, offset (the causal n_kv − n_q, or the shifted kinds' shift),
    band radius and section (the shifted kinds' wrap_n); raises for a
    schedule no kernel walks."""
    kind = _KIND.get((type(sched), getattr(sched, "causal", False)))
    if kind is None:
        raise NotImplementedError(f"no CUDA kernel for {type(sched).__name__}")
    if isinstance(sched, ShiftedMaskSchedule):
        return kind, sched.shift, sched.radius, sched.wrap_n
    return (kind, sched._offset if kind == 1 else 0,
            getattr(sched, "radius", 0), getattr(sched, "section", 0))


def halo_extend(x: torch.Tensor, radius: int, dim: int = 2) -> torch.Tensor:
    """``cat([x[-r:], x, x[:r]])`` along ``dim``: the circulant's K/V."""
    if radius <= 0:
        return x
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, n - radius, radius), x,
                      x.narrow(dim, 0, radius)], dim=dim)


def _round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def _pick_block(n: int, preferred: int) -> int:
    return min(preferred, _round_up(max(n, 1), _LANES))


def build_schedule(schedule: str, n_q: int, n_kv: int, block_q: int,
                   block_kv: int, *, radius: int = 0, section: int = 0,
                   shift: int = 0, wrap_n: int = 0,
                   shifted_causal: bool = False) -> Schedule:
    """Pick blocks and build the Schedule (dense, causal, local,
    local_causal, block, circulant, shifted; ``radius`` bands the local and
    circulant ones and the shifted one, where −1 means no band, ``section``
    sizes the block-diagonal chunks, ``shift``/``wrap_n``/``shifted_causal``
    place the shifted one). ``n_kv`` is the real key length: the
    circulant's kv block is picked against its halo-extended length, and
    the block schedule's blocks shrink until they divide the section, as in
    the reference. A shifted band wraps only around a ring at least as long
    as the q and kv lengths (``ValueError`` otherwise): a ring hop's shard
    never exceeds its ring."""
    bq = _pick_block(n_q, block_q)
    bkv = _pick_block(n_kv + 2 * radius if schedule == "circulant" else n_kv,
                      block_kv)
    if schedule == "block":
        if section <= 0:
            raise ValueError("block schedule requires section > 0")
        bq, bkv = min(bq, section), min(bkv, section)
        while section % bq:
            bq -= 1
        while section % bkv:
            bkv -= 1
    common = dict(n_q=n_q, n_kv=n_kv, block_q=bq, block_kv=bkv)
    if schedule == "dense":
        return Schedule(**common)
    if schedule == "causal":
        return CausalSchedule(**common)
    if schedule in ("local", "local_causal"):
        return LocalSchedule(**common, radius=radius,
                             causal=schedule == "local_causal")
    if schedule == "block":
        return BlockDiagonalSchedule(**common, section=section)
    if schedule == "circulant":
        return CirculantSchedule(**common, radius=radius)
    if schedule == "shifted":
        if wrap_n < 0 or (wrap_n and max(n_q, n_kv) > wrap_n):
            raise ValueError(f"wrap_n={wrap_n} must be 0 or at least the q "
                             f"and kv lengths {n_q}, {n_kv}")
        return ShiftedMaskSchedule(**common, shift=shift, radius=radius,
                                   wrap_n=wrap_n, causal=shifted_causal)
    raise ValueError(f"unknown schedule {schedule!r}")


def auto_bound_max(sched: Schedule) -> bool:
    """The reference's default max policy (``ops/flash.py:1005-1007``): the
    norm bound for mask-free dense and for non-causal bands (local and
    circulant), the exact running max for causal, local_causal,
    block-diagonal (even when aligned sections leave it mask-free), shifted
    (ring hops, held against whole-sequence runs) and ragged dense."""
    band = isinstance(sched, (LocalSchedule, CirculantSchedule))
    return ((not sched.has_mask and not isinstance(sched, BlockDiagonalSchedule))
            or (band and not getattr(sched, "causal", False)))


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """max_j ‖k_j‖ per kv row of ``(B·HKV, n_kv, d)`` k → ``(B·HKV,)``
    float32: the key side of the norm bound, torch reductions outside the
    kernel as the reference computes it outside its kernel (two launches on
    the card: the norms summed in float32 from k's own dtype, then their
    max; sqrt is monotone, so max of norms = sqrt of max of squares)."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=-1)


def _kv_rows(bh: int, hq: int, hkv: int, device) -> torch.Tensor:
    """GQA: q row b (over B·HQ) reads kv row (b // hq)·hkv + (b % hq) // g."""
    rows = torch.arange(bh, device=device)
    return (rows // hq) * hkv + (rows % hq) // (hq // hkv)


def _exact(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


def _flash_fwd_plain(q, k, v, sched: Schedule, hq: int, hkv: int,
                     bound_max: bool = False, products=None):
    """Plain PyTorch forward on prescaled ``(B·HQ, n_q, d)`` q and
    ``(B·HKV, n_kv, d)`` k/v → (o in q's dtype, lse f32 ``(B·HQ, n_q)``).

    One full score matrix with the schedule's visibility (``visible``)
    instead of the kernel's online softmax: the max is the row's exact max either way (or the same
    constant norm bound under ``bound_max``), so the two differ only by
    rounding. ``products``: the (eq, a, b) → float32 product of S = Q·Kᵀ
    and of P·V (default exact float32; ``ops/flash_bwd.py:tf32x3`` models
    the card's float32 kernel, which no main path passes).
    """
    bh, n_q, _ = q.shape
    n_kv = k.shape[1]
    rows = _kv_rows(bh, hq, hkv, q.device)
    kq, vq = k[rows], v[rows]
    mm = _exact if products is None else products
    s = mm("bqd,bkd->bqk", q.float(), kq.float())
    mask = sched.visible(torch.arange(n_q, device=q.device)[:, None],
                         torch.arange(n_kv, device=q.device)[None, :])
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    if bound_max:
        qn = torch.sqrt(torch.sum(q.float() * q.float(), dim=-1, keepdim=True))
        m = qn * (key_norm_max(k) * BOUND_SLACK)[rows][:, None, None]
    else:
        m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = mm("bqk,bkd->bqd", p.to(v.dtype).float(), vq.float())
    valid = (l > 0.0) & (m > DEFAULT_MASK_VALUE * 0.5)
    l_safe = torch.where(l > 0.0, l, 1.0)
    o = (acc * torch.where(valid, 1.0 / l_safe, 0.0)).to(q.dtype)
    lse = torch.where(valid, m * LN2 + torch.log(l_safe), float("-inf"))
    return o, lse[..., 0]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernels load 16 B at once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# Head widths the attention kernels are compiled for: B1, the backward
# (B4/B5) and the quantized attention (B6/B7) alike.
KERNEL_HEAD_DIMS = (64, 128, 256, 512)


def kernel_head_dim(d: int, dv: int) -> int:
    """The compiled width of the attention kernels (B1, B4/B5, B6/B7) for
    head dim ``d`` and value dim ``dv``: the least of
    :data:`KERNEL_HEAD_DIMS` ≥ max(d, dv). Wider heads raise (ROADMAP
    A15c); the plain versions on CPU tensors take any width."""
    for width in KERNEL_HEAD_DIMS:
        if max(d, dv) <= width:
            return width
    raise NotImplementedError(
        f"the attention kernels take head and value dims up to "
        f"{KERNEL_HEAD_DIMS[-1]}, got d={d} dv={dv} (ROADMAP A15c)")


def pad_head_dims(width: int, *ts, fill: float = 0.0):
    """Zero-pad (or ``fill``-pad) the last dim of each tensor to ``width``;
    None passes through. Zero columns change no dot product and no norm, so
    a kernel run at ``width`` gives the caller's o in its first dv columns.
    One-byte float types pad with byte 0 (+0 in e4m3 and e5m2)."""
    out = []
    for t in ts:
        if t is None or t.shape[-1] == width:
            out.append(t)
            continue
        byte_float = t.element_size() == 1 and t.is_floating_point()
        src = t.view(torch.uint8) if byte_float else t
        padded = src.new_full((*t.shape[:-1], width), 0 if byte_float else fill)
        padded[..., : t.shape[-1]] = src
        out.append(padded.view(t.dtype) if byte_float else padded)
    return out


def slice_head_dims(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A kernel's output at its compiled width back to the caller's ``dim``
    columns (the inverse of :func:`pad_head_dims`)."""
    return t if t.shape[-1] == dim else t[..., :dim].contiguous()


# dtype code of float32 on one TF32 pass (csrc/flash_fwd.cu:tf_flash_fwd):
# the checks' planted fault, reached only through _flash_fwd_kernel's
# tf32_passes
_F32_ONE_PASS = 2


def _flash_fwd_kernel(q, k, v, sched: Schedule, hq: int, hkv: int,
                      need_lse: bool, bound_max: bool = False, kmax=None,
                      tf32_passes: int = 3):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (same contract as
    :func:`_flash_fwd_plain`). Ragged edges are masked in the kernel; head
    and value dims are zero-padded to the compiled width
    (:func:`pad_head_dims`) and o is sliced back to dv. The kernel takes the
    schedule's kind, causal offset, band radius and section and walks its
    own tiles (k/v of a circulant schedule are the halo-extended ones).
    Under ``bound_max``, ``kmax`` may hold ``key_norm_max(k)`` computed
    beforehand (so that the kernel can be timed alone). ``tf32_passes=1``
    (float32 only) runs the float32 kernel on one TF32 pass, hi·hi alone: a
    planted fault for the checks, which no user path takes."""
    from tpu_flash_torch.kernels import _build

    if tf32_passes != 3 and (tf32_passes != 1 or q.dtype != torch.float32):
        raise ValueError(f"tf32_passes={tf32_passes} on {q.dtype}")
    sched_args = kernel_schedule(sched)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise NotImplementedError(
            f"flash kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    bh, n_q, d = q.shape
    n_kv, dv = k.shape[1], v.shape[-1]
    if k.shape[-1] != d:
        raise ValueError(f"q and k head dims differ: {d} vs {k.shape[-1]}")
    width = kernel_head_dim(d, dv)
    if bh % hq or k.shape[0] != bh // hq * hkv or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"bad GQA shapes {q.shape} {k.shape} {v.shape}")
    q, k, v = (_aligned(t) for t in pad_head_dims(width, q, k, v))
    if not bound_max:
        kmax = None
    elif kmax is None:
        kmax = key_norm_max(k)
    o = torch.empty_like(q)
    lse = (torch.empty(bh, n_q, device=q.device, dtype=torch.float32)
           if need_lse else None)
    err = _build.library().tf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if kmax is None else kmax.data_ptr(),
        bh, n_q, n_kv, hq, hkv, width, dv, *sched_args,
        _F32_ONE_PASS if tf32_passes == 1 else kernels.dtype_code(q.dtype),
        kernels.stream_handle(q),
    )
    _build.check(err, "tf_flash_fwd")
    kernels.LAUNCHES["flash_fwd"] += 1
    if lse is None:
        lse = torch.zeros(bh, n_q, device=q.device, dtype=torch.float32)
    return slice_head_dims(o, dv), lse


def _flash_fwd(q, k, v, sched: Schedule, *, hq: int = 1, hkv: int = 1,
               need_lse: bool = True, bound_max: bool = False):
    """(o, lse) on prescaled ``(B·H, n, d)`` tensors: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, sched, hq, hkv, bound_max)
    if q.device.type == "cuda":
        return _flash_fwd_kernel(q, k, v, sched, hq, hkv, need_lse, bound_max)
    raise NotImplementedError(f"no attention path for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Differentiable core on prescaled ``(B·H, n, d)`` tensors → (o, lse).

    The forward keeps lse as the backward's residual even when the caller
    asked for none; ``need_lse`` only spares its write when no gradient is
    needed. An unused lse has no cotangent (no Δ term); an unused o gets a
    zero one. ``bwd_split`` and ``bwd_quant`` go to the backward's
    ``split`` and ``quant``, as the reference's ``_fa_bwd`` passes them."""

    @staticmethod
    def forward(ctx, q, k, v, sched, hq, hkv, need_lse, bound_max,
                bwd_split=None, bwd_quant=None):
        ctx.set_materialize_grads(False)
        o, lse = _flash_fwd(q, k, v, sched, hq=hq, hkv=hkv, need_lse=need_lse,
                            bound_max=bound_max)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sched, ctx.hq, ctx.hkv = sched, hq, hkv
        ctx.bwd_split, ctx.bwd_quant = bwd_split, bwd_quant
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        from tpu_flash_torch.ops.flash_bwd import flash_backward

        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else _aligned(do)
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, dlse, ctx.sched,
                                    hq=ctx.hq, hkv=ctx.hkv,
                                    split=ctx.bwd_split, quant=ctx.bwd_quant)
        return dq, dk, dv, None, None, None, None, None, None, None


def _fa(q, k, v, sched: Schedule, hq: int, hkv: int, need_lse: bool,
        bound_max: bool = False, bwd_split=None, bwd_quant=None):
    """(o, lse) through :class:`_FlashAttention`; lse is materialised when
    asked for or when a gradient will need it."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    need_lse = need_lse or grad
    return _FlashAttention.apply(q, k, v, sched, hq, hkv, need_lse, bound_max,
                                 bwd_split, bwd_quant)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    schedule: str = "dense",
    scale: Optional[float] = None,
    radius: int = 0,
    section: int = 0,
    shift: int = 0,
    wrap_n: int = 0,
    shifted_causal: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    return_lse: bool = False,
    bound_max: Optional[bool] = None,
    q_dtype=None,
    kv_dtype=None,
    kv_scale: str = "token",
    bwd_split: Optional[int] = None,
    bwd_quant: Optional[str] = None,
):
    """Schedule-parameterized fused attention on ``(batch, heads, n, d)``.

    ``schedule`` ∈ {"dense", "causal", "local", "local_causal", "block",
    "circulant", "shifted"}; ``radius`` bands the local ones (query ``i``
    sees keys ``|i − j| ≤ radius``) and the circulant (keys ``(i + o) mod
    n``, ``|o| ≤ radius``); ``section`` sizes the block-diagonal chunks
    (query ``i`` sees keys ``j`` with ``i // section == j // section``); the
    shifted schedule is a ring hop: query ``i`` sits at ``i + shift``,
    ``radius`` ≥ 0 bands it (−1: no band), mod ``wrap_n`` when that is > 0
    (at least the q and kv lengths), and ``shifted_causal`` also requires
    ``j ≤ i + shift``; a row that sees no key gives o = 0, lse = −inf. k/v
    may have fewer heads (GQA).
    ``q_dtype``/``kv_dtype`` (int8 / float8 names or torch dtypes;
    ``kv_dtype`` alone is the weight-only mode) route to
    ``quant/flash_q.py:quantized_flash_attention`` (kernel B7, or B6 at
    d ≤ 64) with ``kv_scale``, ``bound_max`` defaulting to True and
    ``block_kv`` capped at 2048; the quantized route has no backward, so
    ``bwd_split``/``bwd_quant`` raise ``ValueError`` there. Elsewhere they
    reach the backward (``ops/flash_bwd.py:flash_backward``): ``bwd_quant=
    "dp"`` takes its dp product on int8 operands (not at d, dv ≤ 64),
    ``bwd_split`` is validated as the reference validates it and stages
    nothing here.
    ``block_q``/``block_kv`` set the schedule's blocks as in the reference
    (its padded lengths and its tile-visit math); the CUDA kernel runs its
    own tiles and masks ragged edges, so no sequence is padded. Any
    head dim d and value dim dv up to 512 runs on the card, its gradient
    too (zero-padded to 64, 128, 256 or 512 there); heads above 512 raise
    (ROADMAP A15c).
    ``bound_max``: True takes the constant norm bound as the softmax max,
    False the exact running max, None the reference's auto policy
    (:func:`auto_bound_max`: the bound for mask-free dense and non-causal
    bands). Both are exact online softmax; the bound depends on the kv span
    a call sees, and rows whose bound exceeds their true max by ≳126 base-2
    units underflow to o = 0, lse = −inf, as in the reference.
    """
    if q_dtype is not None or kv_dtype is not None:
        from tpu_flash_torch.quant.flash_q import quantized_flash_attention

        if bwd_split is not None or bwd_quant is not None:
            raise ValueError(
                "bwd_split/bwd_quant apply to the bf16 backward kernels only; "
                "the quantized path has no backward")
        return quantized_flash_attention(
            q, k, v, q_dtype=q_dtype,
            kv_dtype=kv_dtype if kv_dtype is not None else q_dtype,
            schedule=schedule, scale=scale, radius=radius, section=section,
            block_q=1024 if block_q is None else block_q,
            block_kv=min(2048 if block_kv is None else block_kv, 2048),
            return_lse=return_lse,
            bound_max=True if bound_max is None else bound_max,
            kv_scale=kv_scale, shift=shift, wrap_n=wrap_n,
            shifted_causal=shifted_causal)
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, n, d), got {tuple(q.shape)}")
    b, h, n_q, d = q.shape
    hkv, n_kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    dense = schedule == "dense"
    if block_q is None:
        block_q = 2048 if dense else 1024
    if block_kv is None:
        block_kv = 1024 if dense else 2048
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sched = build_schedule(schedule, n_q, n_kv, block_q, block_kv,
                           radius=radius, section=section, shift=shift,
                           wrap_n=wrap_n, shifted_causal=shifted_causal)
    if bound_max is None:
        bound_max = auto_bound_max(sched)
    qf = (q.float() * (scale * LOG2E)).to(q.dtype).reshape(b * h, n_q, d)
    kf = k.reshape(b * hkv, n_kv, d)
    vf = v.reshape(b * hkv, n_kv, dv)
    if schedule == "circulant":
        kf, vf = halo_extend(kf, radius, dim=1), halo_extend(vf, radius, dim=1)
    o, lse = _fa(qf, kf, vf, sched, h, hkv, return_lse, bool(bound_max),
                 bwd_split, bwd_quant)
    o = o.reshape(b, h, n_q, dv)
    if return_lse:
        return o, lse.reshape(b, h, n_q)
    return o


def _flatten_nd(q, k, v):
    """(b, h, n, d) passes; (b, *spatial, h, d) flattens to (b, h, N, d)."""
    if q.ndim == 4:
        return q, k, v, None
    q2, spatial = flatten_spatial(q)
    return q2, flatten_spatial(k)[0], flatten_spatial(v)[0], spatial


def _unflatten(out, spatial, return_lse: bool):
    if spatial is None:
        return out
    if return_lse:
        return unflatten_spatial(out[0], spatial), out[1]
    return unflatten_spatial(out, spatial)


def dense_fa(q, k, v, *, scale=None, causal=False, return_lse=False, **kw):
    """Dense fused attention on ``(batch, heads, n, d)`` or N-d
    ``(batch, *spatial, heads, d)`` (spatial dims flattened; lse comes back
    as ``(batch, heads, N)``)."""
    q, k, v, spatial = _flatten_nd(q, k, v)
    out = flash_attention(
        q, k, v, schedule="causal" if causal else "dense", scale=scale,
        return_lse=return_lse, **kw,
    )
    return _unflatten(out, spatial, return_lse)


def sliding_fa(q, k, v, window_size: int, *, scale=None, causal=False,
               return_lse=False, **kw):
    """Sliding-window (local band) fused attention on ``(batch, heads, n,
    d)`` or N-d inputs (flattened): query ``i`` sees keys ``|i − j| ≤
    (window_size − 1)/2`` (and ``j ≤ i`` when ``causal``). The window must
    be odd; the reference's band tiles (512 × 1024) are the default
    blocks."""
    if window_size % 2 != 1:
        raise ValueError("sliding window must be odd")
    kw.setdefault("block_q", 512)
    kw.setdefault("block_kv", 1024)
    q, k, v, spatial = _flatten_nd(q, k, v)
    out = flash_attention(
        q, k, v, schedule="local_causal" if causal else "local",
        radius=(window_size - 1) // 2, scale=scale, return_lse=return_lse,
        **kw,
    )
    return _unflatten(out, spatial, return_lse)


def circulant_fa(q, k, v, window_size: int, *, scale=None, return_lse=False,
                 **kw):
    """Circulant-band fused attention: query ``i`` attends keys ``(i + o)
    mod n``, ``|o| ≤ (window_size − 1)/2``, over the flattened sequence of
    ``(batch, heads, n, d)`` or N-d inputs, as a contiguous band over
    halo-extended K/V (no gathers). The window must be odd."""
    if window_size % 2 != 1:
        raise ValueError("circulant window must be odd")
    kw.setdefault("block_q", 512)
    kw.setdefault("block_kv", 1024)
    q, k, v, spatial = _flatten_nd(q, k, v)
    out = flash_attention(
        q, k, v, schedule="circulant", radius=(window_size - 1) // 2,
        scale=scale, return_lse=return_lse, **kw,
    )
    return _unflatten(out, spatial, return_lse)


def _block_major(x, sections):
    """(b, *spatial, h, d) → (b, h, N, d) with each N-d section contiguous."""
    b, *spatial, h, d = x.shape
    nd = len(spatial)
    shape = [b]
    for s, sec in zip(spatial, sections):
        shape += [s // sec, sec]
    xr = x.reshape(shape + [h, d])
    perm = ([0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)]
            + [1 + 2 * nd, 2 + 2 * nd])
    n = math.prod(spatial)
    return xr.permute(perm).reshape(b, n, h, d).movedim(1, 2)


def _unblock_major(x, spatial, sections):
    """Inverse of :func:`_block_major` on (b, h, N, d)."""
    b, h, n, d = x.shape
    nd = len(spatial)
    outer = [s // sec for s, sec in zip(spatial, sections)]
    xr = x.movedim(1, 2).reshape([b] + outer + list(sections) + [h, d])
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    return xr.permute(perm + [1 + 2 * nd, 2 + 2 * nd]).reshape(b, *spatial, h, d)


def block_fa(q, k, v, block_size, *, scale=None, return_lse=False, **kw):
    """Disjoint block-diagonal fused attention (windows with stride =
    window, no padding). 1-D ``(batch, heads, n, d)`` inputs run the
    block-diagonal schedule directly; N-d ``(batch, *spatial, heads, d)``
    inputs are permuted block-major (reshapes and transposes, no patch
    copies) so each N-d block is one contiguous section."""
    if q.ndim == 4:
        if isinstance(block_size, (tuple, list)):
            (block_size,) = block_size
        if q.shape[2] % block_size:
            raise ValueError("block_fa requires seq divisible by block_size")
        return flash_attention(
            q, k, v, schedule="block", section=block_size, scale=scale,
            return_lse=return_lse, **kw,
        )
    b, *spatial, h, d = q.shape
    nd = len(spatial)
    sections = (tuple(block_size) if isinstance(block_size, (tuple, list))
                else (block_size,) * nd)
    if any(s % sec for s, sec in zip(spatial, sections)):
        raise ValueError(f"spatial dims {spatial} must be divisible by {sections}")
    out = flash_attention(
        _block_major(q, sections), _block_major(k, sections),
        _block_major(v, sections), schedule="block",
        section=math.prod(sections), scale=scale, return_lse=return_lse, **kw,
    )
    o = _unblock_major(out[0] if return_lse else out, spatial, sections)
    return (o, out[1]) if return_lse else o


def windowed_fa(q, k, v, window_size, *, stride=None, pad=0, scale=None, **kw):
    """Overlapping windowed fused attention on ``(batch, *spatial, heads,
    d)``: windows extracted (``window_size``, ``stride``, ``pad`` per dim),
    dense flash attention inside each (``**kw`` goes on to
    :func:`flash_attention`, ``q_dtype``/``kv_dtype`` to the quantized
    route), the outputs folded back in float32 and averaged where windows
    overlap. No lse: per-window statistics mean nothing after averaging."""
    if kw.get("return_lse"):
        raise NotImplementedError(
            "windowed_fa cannot return lse: per-window statistics are not "
            "meaningful after overlap averaging")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return windowed(
        q, k, v, window_size, stride=stride, pad=pad, fold_dtype=torch.float32,
        attend=lambda qw, kw_, vw: flash_attention(
            qw, kw_, vw, schedule="dense", scale=scale, **kw))
