"""Ring attention: sequence-sharded exact attention, port of
``tpu_flash/parallel/ring.py``.

The global sequence of ``N = P·nl`` positions is cut into ``P`` rank shards
of ``nl``. K/V shards rotate one rank a hop while each rank folds the
arriving shard into its ``(o, lse)`` with :func:`merge_partials`, the
cross-shard form of the online softmax: after ``P`` hops every rank holds
its exact output, with O(N/P) memory a rank.

Ranks live in processes: a process of a ``torch.distributed`` group of
``W`` processes (the default group, or a mesh axis's sub-group) holds ``L`` consecutive ranks (``P = W·L``) and steps them
through a hop together. Between hops the list of K/V shards moves one rank
along; the shard that leaves the process goes to the next process by P2P
(``batch_isend_irecv``), issued before the hop's attention, as the
reference issues its ``ppermute``. With one process nothing leaves it, so
``P`` virtual ranks run on one device. The rotation is differentiable: its
backward sends the cotangent the other way (the ppermute's transpose).

Each hop is one call of the port's kernels on the rank's shards: B1 (and
B4/B5 in the backward) through ``ops/flash.py:flash_attention``, or B7
through ``quant/flash_q.py:quantized_flash_attention_prequant`` on the
quantized ring. The hop's mask is static: the offset of hop ``t``'s K/V
shard from the rank's queries is ``t·nl`` (``(t − P)·nl`` across the start
of the sequence), so causal, local and circulant hops are dense, causal or
shifted schedules, and hops whose shard lies outside the band for every
rank are skipped (``⌈radius/nl⌉ + 1`` hops a band rank instead of ``P``).
The reference's per-rank ``lax.cond`` is a branch on the rank here, a host
integer.

The quantized ring quantizes each shard's K (per token) and V (per
channel) once, before the hop loop; int8 or e4m3 values and their scales
rotate, and int4 rotates its packed bytes and unpacks them to int8 each
hop. It is inference only (no gradient).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpu_flash_torch.ops import flash

PATTERNS = ("dense", "causal", "local", "circulant")


def merge_partials(o1, lse1, o2, lse2):
    """Merge two attention partials over disjoint key sets.

    o: ``(..., n, d)``; lse: ``(..., n)`` in natural-log units. A fully
    masked partial carries lse = −inf and weight 0, so two empty partials
    merge to o = 0, lse = −inf. Returns ``(o, lse)``.
    """
    lse = torch.logaddexp(lse1, lse2)

    def weight(x):
        return torch.where(torch.isneginf(x), 0.0, torch.exp(x - lse))

    return o1 * weight(lse1)[..., None] + o2 * weight(lse2)[..., None], lse


def hop_needed(pattern: str, radius: int, p: int, nl: int, t: int) -> bool:
    """Can hop ``t``'s shard meet the band of any rank (the reference's
    ``hop_needed_static``)? Dense and causal need every hop; a circulant
    hop covers global offsets ``t·nl ± (nl − 1)`` mod N, a local one ``t·nl``
    forward or ``(p − t)·nl`` backward."""
    if pattern in ("dense", "causal"):
        return True
    span = radius + nl - 1
    if pattern == "circulant":
        return min(t * nl, p * nl - t * nl) <= span
    return t * nl <= span or (t != 0 and (p - t) * nl <= span)


def hop_schedule(pattern: str, radius: int, p: int, nl: int, t: int,
                 rank: int) -> Optional[dict]:
    """The schedule keywords of hop ``t`` at ``rank`` (whose K/V shard then
    comes from rank ``(rank − t) mod p``), or None when the hop is skipped:
    dense everywhere; causal at t = 0, dense from an earlier rank, skipped
    from a later one; local a shifted band, ``t·nl`` forward or ``(t −
    p)·nl`` from a later rank; circulant a band shifted by ``t·nl mod N``
    and wrapped mod N."""
    if pattern not in PATTERNS:
        raise ValueError(f"unknown ring pattern {pattern!r}")
    if not hop_needed(pattern, radius, p, nl, t):
        return None
    if pattern == "dense":
        return dict(schedule="dense")
    if pattern == "circulant":
        return dict(schedule="shifted", shift=t * nl % (p * nl),
                    radius=radius, wrap_n=p * nl)
    if pattern == "causal":
        if t == 0:
            return dict(schedule="causal")
        return dict(schedule="dense") if rank >= t else None
    span = radius + nl - 1
    if t == 0:
        return dict(schedule="shifted", shift=0, radius=radius)
    if rank >= t:
        shift = t * nl
    else:
        shift = (t - p) * nl
    if abs(shift) > span:
        return None
    return dict(schedule="shifted", shift=shift, radius=radius)


class RingTransport:
    """Moves the K/V shard that leaves this process to the next process of
    a ``torch.distributed`` group (``group``, default the default group
    when it is initialised) and takes the previous process's. With one
    process nothing moves: the shard goes to this process's first rank.
    :meth:`of` gives the transport of a mesh axis (its sub-group)."""

    def __init__(self, *, single: bool = False, group=None):
        on = not single and dist.is_available() and dist.is_initialized()
        self.group = group if on else None
        self.world = dist.get_world_size(group) if on else 1
        self.rank = dist.get_rank(group) if on else 0

    @classmethod
    def local(cls) -> "RingTransport":
        """One process, whether or not ``torch.distributed`` is running."""
        return cls(single=True)

    @classmethod
    def of(cls, axis) -> "RingTransport":
        """The ring over a mesh axis line (``parallel/mesh.py:AxisGroup``):
        its processes' sub-group, or one process when the line lies in
        this one."""
        if axis.group is None:
            return cls.local()
        return cls(group=axis.group)

    def _peer(self, step: int) -> int:
        peer = (self.rank + step) % self.world
        if self.group is None:
            return peer
        return dist.get_global_rank(self.group, peer)

    def start(self, tensors, direction: int = 1):
        """Send ``tensors`` ``direction`` processes along the ring and
        receive as many from the other side → ``(received, wait)``: the
        received tensors hold their data once ``wait()`` returns. One-byte
        float tensors travel as bytes."""
        if self.world == 1:
            return [t.view_as(t) for t in tensors], lambda: None
        ops, recv = [], []
        for t in tensors:
            t = t.contiguous()
            byte_float = t.is_floating_point() and t.element_size() == 1
            send = t.view(torch.uint8) if byte_float else t
            buf = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send, self._peer(direction),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(-direction),
                                  self.group))
            recv.append(buf.view(t.dtype) if byte_float else buf)
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()

        return recv, wait


class _Rotate(torch.autograd.Function):
    """One step of the ring for tensors that need a gradient: forward sends
    to the next process, backward returns the cotangent to the previous
    one. The forward's outputs hold their data after ``pending[0]()``."""

    @staticmethod
    def forward(ctx, transport, pending, *tensors):
        ctx.transport = transport
        out, pending[0] = transport.start(tensors, 1)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out, wait = ctx.transport.start(grads, -1)
        wait()
        return (None, None, *out)


class _Join(torch.autograd.Function):
    """The ring's output, also taking every shard a rotation received:
    autograd then runs every rotation's backward in every process, even for
    a shard that no hop of this process used (each backward is an exchange
    that both neighbours wait for), and the shards get a zero cotangent
    where nothing else gives them one."""

    @staticmethod
    def forward(ctx, out, *received):
        ctx.like = [(t.shape, t.dtype, t.device) for t in received]
        return out.clone()

    @staticmethod
    def backward(ctx, grad, *_):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.like))


def _rotate(transport: RingTransport, tensors):
    """Start moving ``tensors`` one process along → (received, wait)."""
    if transport.world == 1 or not any(t.requires_grad for t in tensors):
        return transport.start(tensors)
    pending = [None]
    out = _Rotate.apply(transport, pending, *tensors)
    return list(out), lambda: pending[0]()


def _quantized_hop(q_dtype, kv_dtype, scale, out_dtype, block_q, block_kv):
    """(prepare(q, k, v) → (q operand, rotating K/V tuple), attend(q, kv,
    **schedule) → (o, lse)) of the quantized ring."""
    from tpu_flash_torch.quant import qarray
    from tpu_flash_torch.quant.flash_q import (
        QArray,
        prepare_ring_operands,
        quantized_flash_attention_prequant,
    )

    int4 = kv_dtype == "int4"
    if int4 and q_dtype not in (None, "int8"):
        raise ValueError("int4 ring pairs with q_dtype=None or 'int8'")

    def prepare(q, k, v):
        q_in, kq, vq = prepare_ring_operands(
            q, k, v, q_dtype=q_dtype, kv_dtype="int8" if int4 else kv_dtype,
            scale=scale)
        if int4:
            kq = qarray.quantize_int4(k.float(), axis=-1)
            vq = qarray.quantize_int4(v.float(), axis=-2)
        return q_in, (kq.values, kq.scales, vq.values, vq.scales)

    def attend(q_in, kv, **sched):
        kvals, ks, vvals, vs = kv
        if int4:
            kvals, vvals = qarray.unpack_int4(kvals), qarray.unpack_int4(vvals)
        return quantized_flash_attention_prequant(
            q_in, QArray(kvals, ks, axis=-1), QArray(vvals, vs, axis=-2),
            block_q=block_q, block_kv=block_kv, return_lse=True,
            out_dtype=out_dtype, **sched)

    return prepare, attend


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   pattern: str = "causal", radius: int = 0,
                   scale: Optional[float] = None, local_ranks: int = 1,
                   block_q: int = 512, block_kv: int = 512,
                   q_dtype=None, kv_dtype=None,
                   transport: Optional[RingTransport] = None) -> torch.Tensor:
    """Exact attention with K/V rotating around the ring.

    ``q``, ``k``, ``v``: ``(B, H, L·nl, D)``, this process's ``L =
    local_ranks`` consecutive rank shards of a global sequence of ``N =
    W·L·nl`` positions, ``W`` the size of the transport's group (1
    without one); process ``r`` holds positions ``[r·L·nl, (r +
    1)·L·nl)``. Returns this process's output, in q's dtype. ``pattern``:
    dense, causal, local (``|i − j| ≤ radius``) or circulant (the same band
    mod N). ``kv_dtype`` (int8, fp8 names or dtypes, or "int4") turns on the
    quantized ring, ``q_dtype`` (int8 or e4m3; int4 takes int8 or None)
    quantizes Q too; it has no gradient. ``transport`` moves the shards
    between processes (default: :class:`RingTransport` over the default
    group; a mesh's sequence line: ``RingTransport.of(mesh.axis("seq"))``).
    """
    if pattern in ("local", "circulant") and radius < 0:
        raise ValueError("radius must be ≥ 0")
    if q_dtype is not None and kv_dtype is None:
        raise ValueError("q_dtype requires kv_dtype (quantized ring mode)")
    transport = RingTransport() if transport is None else transport
    b, h, n_local, d = q.shape
    if n_local % local_ranks:
        raise ValueError(f"{n_local} positions do not split into "
                         f"{local_ranks} ranks")
    nl = n_local // local_ranks
    p = transport.world * local_ranks
    base = transport.rank * local_ranks
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # contiguous shards, as a shard that arrives from another process is
    qs, ks, vs = ([s.contiguous() for s in x.split(nl, dim=2)]
                  for x in (q, k, v))
    kvs = list(zip(ks, vs))
    grad = kv_dtype is None and torch.is_grad_enabled()
    with torch.set_grad_enabled(grad):
        if kv_dtype is None:
            def attend(qh, kv, **sched):
                return flash.flash_attention(
                    qh, kv[0], kv[1], scale=scale, block_q=block_q,
                    block_kv=block_kv, return_lse=True, **sched)
        else:
            prepare, attend = _quantized_hop(q_dtype, kv_dtype, scale,
                                             q.dtype, block_q, block_kv)
            prepared = [prepare(qh, *kv) for qh, kv in zip(qs, kvs)]
            qs = [pq for pq, _ in prepared]
            kvs = [kv for _, kv in prepared]
        return _hop_loop(qs, kvs, attend, pattern, radius, p, nl, base,
                         transport).to(q.dtype)


def _hop_loop(qs, kvs, attend: Callable, pattern: str, radius: int, p: int,
              nl: int, base: int, transport: RingTransport) -> torch.Tensor:
    """The ring on this process's ranks ``base …``: P hops, each the
    rotation started, then every local rank's hop attention merged into its
    float32 partial, then the rotation finished; → the ranks' outputs along
    the sequence, float32."""
    acc = [None] * len(qs)
    joined = []
    for t in range(p):
        recv = None
        if t < p - 1:
            recv, wait = _rotate(transport, kvs[-1])
            if transport.world > 1 and recv[0].requires_grad:
                joined += recv
        for j, (qh, kv) in enumerate(zip(qs, kvs)):
            sched = hop_schedule(pattern, radius, p, nl, t, base + j)
            if sched is None:
                continue
            o, lse = attend(qh, kv, **sched)
            part = (o.float(), lse)
            acc[j] = part if acc[j] is None else merge_partials(*acc[j], *part)
        if recv is not None:
            wait()
            kvs = [tuple(recv)] + [tuple(x.view_as(x) for x in kv)
                                   for kv in kvs[:-1]]
    # hop 0 (a rank's own shard) runs under every pattern
    out = torch.cat([o for o, _ in acc], dim=2)
    return _Join.apply(out, *joined) if joined else out


def ring_dense_fa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ranks: int, **kw) -> torch.Tensor:
    """Ring attention over ``ranks`` virtual ranks in this process on global
    ``(B, H, N, D)`` tensors → the global output: the counterpart of the
    reference's ``ring_dense_fa`` on a sequence mesh of ``ranks`` devices.
    ``kw`` as :func:`ring_attention`."""
    if q.shape[2] % ranks:
        raise ValueError(f"sequence {q.shape[2]} does not split into "
                         f"{ranks} ranks")
    return ring_attention(q, k, v, local_ranks=ranks,
                          transport=RingTransport.local(), **kw)


def ring_attn_fn(ranks: int, **kw) -> Callable:
    """``attn_fn(q, k, v)`` for ``models/transformer.py``: :func:`ring_dense_fa`
    over ``ranks`` virtual ranks (``kw``: pattern, radius, …)."""
    return lambda q, k, v: ring_dense_fa(q, k, v, ranks, **kw)
