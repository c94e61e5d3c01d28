"""Ulysses sequence parallelism: all-to-all head ↔ sequence re-sharding;
port of ``tpu_flash/parallel/ulysses.py``.

Instead of rotating K/V around the ring for P hops, one all-to-all
re-shards the activations from sequence shards ``(B, H, N/P, D)`` to head
shards ``(B, H/P, N, D)``, each rank runs ONE public flash call
(``ops/flash.py:flash_attention``: B1 and B4/B5, or B6/B7 on the quantized
route) over the full sequence with every schedule intact, and the inverse
all-to-all restores sequence sharding. The all-to-all runs over the mesh
axis's line (``parallel/mesh.py:AxisGroup``): between the ranks inside
this process it concatenates their pieces in rank order; across processes
it is one ``torch.distributed.all_to_all_single`` on the axis's sub-group.
Each direction is a ``torch.autograd.Function`` whose backward is the
other direction, as autodiff transposes the reference's ``all_to_all``:
the backward is ring-free too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from tpu_flash_torch.ops import flash


@dataclasses.dataclass
class _Spec:
    local: int            # ranks in this process (L)
    world: int            # processes on the line (W)
    group: Optional[object]
    devices: List[torch.device]


def _seq_to_heads(x: torch.Tensor, spec: _Spec) -> List[torch.Tensor]:
    """This process's sequence shards ``(B, H, L·nl, D)`` → each local
    rank's head group over the whole sequence, ``(B, H/P, W·L·nl, D)``,
    on its device."""
    b, h, ln, d = x.shape
    lw, w = spec.local, spec.world
    hp = h // (lw * w)
    if w == 1:
        full = x
    else:
        send = x.reshape(b, w, lw * hp, ln, d).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=spec.group)
        # chunk w' came from process w', which holds positions w'·ln …
        full = recv.permute(1, 2, 0, 3, 4).reshape(b, lw * hp, w * ln, d)
    return [full[:, j * hp:(j + 1) * hp].contiguous().to(dev)
            for j, dev in enumerate(spec.devices)]


def _heads_to_seq(parts: List[torch.Tensor], spec: _Spec) -> torch.Tensor:
    """The inverse: each local rank's ``(B, H/P, N, D)`` → this process's
    sequence shards with every head, ``(B, H, N/W, D)``, on the first
    rank's device; the heads concatenated in rank order."""
    dev = spec.devices[0]
    full = torch.cat([p.to(dev) for p in parts], dim=1)
    w = spec.world
    if w == 1:
        return full
    b, lh, n, d = full.shape
    ln = n // w
    send = full.reshape(b, lh, w, ln, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=spec.group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, w * lh, ln, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        return tuple(_seq_to_heads(x, spec))

    @staticmethod
    def backward(ctx, *grads):
        return _heads_to_seq(list(grads), ctx.spec), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *parts):
        ctx.spec = spec
        return _heads_to_seq(list(parts), spec)

    @staticmethod
    def backward(ctx, grad):
        return (None, *_seq_to_heads(grad.contiguous(), ctx.spec))


def _spec(axis) -> _Spec:
    world = 1 if axis.group is None else dist.get_world_size(axis.group)
    return _Spec(local=axis.local, world=world, group=axis.group,
                 devices=list(axis.devices))


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis,
    *,
    schedule: str = "causal",
    radius: int = 0,
    section: int = 0,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    q_dtype=None,
    kv_dtype=None,
):
    """Exact attention on sequence shards via the head ↔ sequence
    all-to-all.

    ``q``, ``k``, ``v``: this process's consecutive shards of a global
    sequence of ``P·nl`` positions on the mesh axis ``axis`` (an
    ``AxisGroup`` of size P), ``(B, H, L·nl, D)`` for its L ranks, on the
    first rank's device. Q heads must be divisible by P; K/V heads are
    repeated up to the Q head count first when they are not (GQA ratios
    that survive the split stay sharded). Every flash schedule is
    available: the kernel sees the full sequence. ``q_dtype``/``kv_dtype``
    route to the quantized kernels (inference only, as the quantized
    ring). Returns this process's output shards, in q's dtype."""
    p = axis.size
    hq, hkv = q.shape[1], k.shape[1]
    if hq % p:
        raise ValueError(f"q heads {hq} not divisible by axis size {p}")
    if hkv % p:
        # the GQA group is too coarse for the head split: repeat K/V heads
        # up to the Q head count (the kernel then runs MHA a rank)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    spec = _spec(axis)
    qs, ks, vs = (_SeqToHeads.apply(x.contiguous(), spec) for x in (q, k, v))
    outs = axis.map(lambda i, qg, kg, vg: flash.flash_attention(
        qg, kg, vg, schedule=schedule, radius=radius, section=section,
        scale=scale, block_q=block_q, block_kv=block_kv, q_dtype=q_dtype,
        kv_dtype=kv_dtype), qs, ks, vs)
    return _HeadsToSeq.apply(spec, *outs).to(q.dtype)


def ulysses_fa(
    mesh,
    *,
    schedule: str = "causal",
    radius: int = 0,
    section: int = 0,
    axis_name: str = "seq",
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    q_dtype=None,
    kv_dtype=None,
):
    """Ulysses attention over ``mesh``'s ``axis_name`` line (the
    counterpart of the reference's ``ulysses_fa``).

    Returns ``fn(q, k, v)`` taking GLOBAL ``(B, H, N, D)`` tensors: each
    process runs its consecutive shards of the sequence and returns its
    part of the output (the whole output with one process). Batch and
    heads stay whole on each ``(data, model)`` line."""
    axis = mesh.axis(axis_name)

    def fn(q, k, v):
        n = q.shape[2]
        if n % axis.size:
            raise ValueError(f"sequence {n} does not split into {axis.size}"
                             " ranks")
        nl = n // axis.size
        part = slice(axis.first * nl, (axis.first + axis.local) * nl)
        return ulysses_attention(
            q[:, :, part], k[:, :, part], v[:, :, part], axis,
            schedule=schedule, radius=radius, section=section, scale=scale,
            block_q=block_q, block_kv=block_kv, q_dtype=q_dtype,
            kv_dtype=kv_dtype)

    return fn
