"""Fused attention forward (B1): port of ``flash_attention``/``dense_fa`` from
``tpu_flash/ops/flash.py`` for the dense and causal schedules.

Public layout ``(batch, heads, n, d)``, GQA through the kv-row map, lse in
natural-log units, and a fully masked row gives o = 0, lse = −inf. The
softmax is base 2: q is prescaled by ``scale·log2(e)`` in float32 and cast
back to its dtype, scores accumulate in float32, P is cast to V's dtype
before the PV product.

:func:`_flash_fwd` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version :func:`_flash_fwd_plain`; CUDA tensors launch the
hand-written kernel in ``csrc/flash_fwd.cu`` through
:func:`_flash_fwd_kernel`, or raise. Only the exact running max is ported:
``bound_max=True`` raises (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.schedule import CausalSchedule, Schedule, cdiv

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
_LANES = 128

# Tile of the CUDA kernel (rows of q, rows of k/v per block step).
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_KV = 64

# Options of the reference's flash_attention that are not ported yet, with
# the ROADMAP item that adds them.
_UNPORTED = {
    "radius": "A3", "section": "A11", "shift": "A13", "wrap_n": "A13",
    "shifted_causal": "A13", "q_dtype": "A10", "kv_dtype": "A10",
    "kv_scale": "A10", "bwd_split": "A8", "bwd_quant": "A8",
}


def _round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def _pick_block(n: int, preferred: int) -> int:
    return min(preferred, _round_up(max(n, 1), _LANES))


def build_schedule(schedule: str, n_q: int, n_kv: int, block_q: int,
                   block_kv: int) -> Schedule:
    """Pick blocks and build the Schedule (dense and causal only)."""
    common = dict(n_q=n_q, n_kv=n_kv, block_q=_pick_block(n_q, block_q),
                  block_kv=_pick_block(n_kv, block_kv))
    if schedule == "dense":
        return Schedule(**common)
    if schedule == "causal":
        return CausalSchedule(**common)
    raise NotImplementedError(
        f"schedule {schedule!r} is not ported yet (ROADMAP A3 local/"
        "local_causal, A11 block/circulant, A13 shifted)")


def _kv_rows(bh: int, hq: int, hkv: int, device) -> torch.Tensor:
    """GQA: q row b (over B·HQ) reads kv row (b // hq)·hkv + (b % hq) // g."""
    rows = torch.arange(bh, device=device)
    return (rows // hq) * hkv + (rows % hq) // (hq // hkv)


def _flash_fwd_plain(q, k, v, sched: Schedule, hq: int, hkv: int):
    """Plain PyTorch forward on prescaled ``(B·HQ, n_q, d)`` q and
    ``(B·HKV, n_kv, d)`` k/v → (o in q's dtype, lse f32 ``(B·HQ, n_q)``).

    One full score matrix with the schedule's mask instead of the kernel's
    online softmax: the max is the row's exact max either way, so the two
    differ only by rounding.
    """
    bh, n_q, _ = q.shape
    n_kv = k.shape[1]
    rows = _kv_rows(bh, hq, hkv, q.device)
    kq, vq = k[rows], v[rows]
    s = torch.einsum("bqd,bkd->bqk", q.float(), kq.float())
    mask = sched.mask(torch.arange(n_q, device=q.device)[:, None],
                      torch.arange(n_kv, device=q.device)[None, :])
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), vq.float())
    valid = (l > 0.0) & (m > DEFAULT_MASK_VALUE * 0.5)
    l_safe = torch.where(l > 0.0, l, 1.0)
    o = (acc * torch.where(valid, 1.0 / l_safe, 0.0)).to(q.dtype)
    lse = torch.where(valid, m * LN2 + torch.log(l_safe), float("-inf"))
    return o, lse[..., 0]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernels load 16 B at once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash_fwd_kernel(q, k, v, sched: Schedule, hq: int, hkv: int,
                      need_lse: bool):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (same contract as
    :func:`_flash_fwd_plain`). Ragged edges are masked in the kernel, so
    nothing is padded."""
    from tpu_flash_torch.kernels import _build

    if type(sched) not in (Schedule, CausalSchedule):
        raise NotImplementedError(f"no CUDA kernel for {type(sched).__name__}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise NotImplementedError(
            f"flash kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    if d not in (64, 128) or v.shape[-1] != d or k.shape[-1] != d:
        raise NotImplementedError(f"flash kernel takes d = dv ∈ {{64, 128}}, "
                                  f"got {d}/{v.shape[-1]}")
    if bh % hq or k.shape[0] != bh // hq * hkv or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"bad GQA shapes {q.shape} {k.shape} {v.shape}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # the kernel's grid and causal offset come from the schedule at its tile
    ksched = dataclasses.replace(sched, block_q=KERNEL_BLOCK_Q,
                                 block_kv=KERNEL_BLOCK_KV)
    causal = isinstance(ksched, CausalSchedule)
    o = torch.empty_like(q)
    lse = (torch.empty(bh, n_q, device=q.device, dtype=torch.float32)
           if need_lse else None)
    err = _build.library().tf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        bh, n_q, n_kv, hq, hkv, d, int(causal),
        ksched._offset if causal else 0, kernels.dtype_code(q.dtype),
        kernels.stream_handle(q),
    )
    _build.check(err, "tf_flash_fwd")
    kernels.LAUNCHES["flash_fwd"] += 1
    if lse is None:
        lse = torch.zeros(bh, n_q, device=q.device, dtype=torch.float32)
    return o, lse


def _flash_fwd(q, k, v, sched: Schedule, *, hq: int = 1, hkv: int = 1,
               need_lse: bool = True):
    """(o, lse) on prescaled ``(B·H, n, d)`` tensors: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, sched, hq, hkv)
    if q.device.type == "cuda":
        return _flash_fwd_kernel(q, k, v, sched, hq, hkv, need_lse)
    raise NotImplementedError(f"no attention path for device {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    schedule: str = "dense",
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    return_lse: bool = False,
    bound_max: Optional[bool] = None,
    **unported,
):
    """Schedule-parameterized fused attention on ``(batch, heads, n, d)``.

    ``schedule`` ∈ {"dense", "causal"}; k/v may have fewer heads (GQA).
    ``block_q``/``block_kv`` set the schedule's blocks as in the reference
    (its padded lengths and its tile-visit math); the CUDA kernel runs its
    own 64×64 tiles and masks ragged edges, so no input is padded.
    ``bound_max``: only the exact running max is ported; True raises
    (ROADMAP A3). None takes the exact max where the reference's auto
    policy would take the norm bound for mask-free dense — both are exact
    softmax and differ only by rounding.
    """
    for name in unported:
        if name not in _UNPORTED:
            raise TypeError(f"flash_attention() got an unexpected keyword "
                            f"argument {name!r}")
        raise NotImplementedError(
            f"flash_attention({name}=...) is not ported yet "
            f"(ROADMAP {_UNPORTED[name]})")
    if bound_max:
        raise NotImplementedError(
            "bound_max=True (norm-bound running max) is not ported yet "
            "(ROADMAP A3)")
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
    sched = build_schedule(schedule, n_q, n_kv, block_q, block_kv)
    qf = (q.float() * (scale * LOG2E)).to(q.dtype).reshape(b * h, n_q, d)
    kf = k.reshape(b * hkv, n_kv, d)
    vf = v.reshape(b * hkv, n_kv, dv)
    o, lse = _flash_fwd(qf, kf, vf, sched, hq=h, hkv=hkv, need_lse=return_lse)
    o = o.reshape(b, h, n_q, dv)
    if return_lse:
        return o, lse.reshape(b, h, n_q)
    return o


def dense_fa(q, k, v, *, scale=None, causal=False, return_lse=False, **kw):
    """Dense fused attention on ``(batch, heads, n, d)``; N-d inputs are
    not ported yet (ROADMAP A11)."""
    if q.ndim != 4:
        raise NotImplementedError(
            "N-d (batch, *spatial, heads, d) inputs are not ported yet "
            "(ROADMAP A11)")
    return flash_attention(
        q, k, v, schedule="causal" if causal else "dense", scale=scale,
        return_lse=return_lse, **kw,
    )
