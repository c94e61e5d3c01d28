"""Mixture-of-Experts MLP with expert parallelism: port of
``tpu_flash/models/moe.py``.

Top-k routing, k ∈ {1, 2}, as the reference routes: a softmax router in
float32, iterative argmax choices, each choice's tokens counted into
per-expert positions along the token axis of each batch row (choice j
fills only after all of choice j − 1's tokens, GShard priority order, and
offset by the post-truncation count of the earlier choices); a token whose
position reaches the capacity ``ceil(k·N/E · capacity_factor)`` is dropped
(contributes zero, the residual stream carries it). Kept gates renormalize
to sum 1. The Switch balance loss ``E · Σ_e f_e · p̄_e`` is returned for the
trainer to weight.

The reference dispatches with dense one-hot ``(B, N, E, C)`` einsums. Here
the same choices, positions, drops and gates index a ``(E, B·C, d)`` slot
buffer instead: kept tokens are copied into their slots, the three expert
products run as batched matrix products over the expert axis (every slot,
as the reference computes them), and each token gathers its slots' outputs
back, weighted. Shapes are static and nothing syncs with the host, so a
decode round captures as one CUDA graph.

Expert parallelism (``ep``, an ``AxisGroup`` of the mesh's ``expert``
axis): each rank holds ``E / size`` consecutive experts (``expert_slices``;
the router is replicated), computes its experts' slots and its share of
the weighted combine in float32, and the shares are summed over the axis
in rank order, on the first rank's device.

Serving note (the reference's): capacity drops depend on the batch, so a
served MoE model needs the drop-free factor ``capacity_factor ≥ E/top_k``
(``models/transformer.py:_check_serving_moe``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def init_moe_params(dim: int, hidden: int, num_experts: int, dtype,
                    generator: torch.Generator, device="cuda"):
    """Router + expert-major SwiGLU weights for one MoE layer: ``wr``
    float32 ``(dim, E)`` (never rounded through the model dtype: rounded
    logits flip near-tie expert choices), ``w_gate``/``w_up`` ``(E, dim,
    hidden)``, ``w_down`` ``(E, hidden, dim)``, each N(0, 1/fan_in) from
    ``generator``."""

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x / math.sqrt(fan_in)

    return dict(
        wr=normal((dim, num_experts), dim),
        w_gate=normal((num_experts, dim, hidden), dim).to(dtype),
        w_up=normal((num_experts, dim, hidden), dim).to(dtype),
        w_down=normal((num_experts, hidden, dim), hidden).to(dtype),
    )


def expert_pspecs():
    """The dim each tensor of a MoE layer splits along over an ``expert``
    axis (None: replicated): the reference's PartitionSpecs, router
    replicated, expert-major tensors split on the expert dim."""
    return dict(wr=None, w_gate=0, w_up=0, w_down=0)


def expert_slices(layer, rank: int, size: int, device=None):
    """Rank ``rank`` of ``size``'s share of a MoE layer: its ``E / size``
    consecutive experts of each expert-major tensor, the router and every
    other leaf whole. ``device``: where the slices go (default: where the
    layer is)."""
    out = {}
    for name, w in layer.items():
        dev = w.device if device is None else torch.device(device)
        dim = expert_pspecs().get(name)
        if dim is None:
            out[name] = w.to(dev)
            continue
        e = w.shape[dim]
        if e % size:
            raise ValueError(f"{e} experts do not split over {size} ranks")
        c = e // size
        out[name] = w[rank * c:(rank + 1) * c].contiguous().to(dev)
    return out


def shard_experts(params, ep):
    """``params`` with every MoE layer's expert-major tensors replaced by
    the list of this process's ``ep`` ranks' slices (each on its rank's
    device), the router and the rest unchanged: the tree the model
    functions take under ``ep=``."""
    layers = []
    for lp in params["layers"]:
        if "wr" not in lp:
            layers.append(lp)
            continue
        ranks = [expert_slices(lp, r, ep.size, dev)
                 for r, dev in zip(ep.indices, ep.devices)]
        out = dict(lp)
        for name, dim in expert_pspecs().items():
            if dim is not None:
                out[name] = [r[name] for r in ranks]
        layers.append(out)
    return {**params, "layers": layers}


@dataclasses.dataclass
class Routing:
    """Top-k routing of a ``(B, N)`` token grid over E experts, choice j
    along the last axis: ``experts`` its expert (int64), ``positions`` its
    slot in the expert's capacity (int64, ≥ ``capacity`` when dropped),
    ``keep`` whether it was kept (bool), ``weights`` its renormalized gate
    (float32, 0 where dropped)."""

    experts: torch.Tensor
    positions: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    capacity: int


def _route(logits, top_k: int, capacity: int):
    """The reference's ``route_topk`` in index form → (Routing, aux).
    Every quantity is computed as the reference computes it (float32
    softmax, argmax choices, running counts), so choices, positions and
    drops are its own exactly."""
    b, n, e = logits.shape
    if top_k > e:
        raise ValueError(f"top_k={top_k} exceeds num_experts={e}")
    probs = torch.softmax(logits.float(), dim=-1)
    ids = torch.arange(e, device=logits.device)

    masks, gates, experts = [], [], []
    p = probs
    for _ in range(top_k):
        idx = torch.argmax(p, dim=-1)  # (B, N)
        m = (idx[..., None] == ids).float()  # one-hot, no host check
        masks.append(m)
        gates.append(torch.sum(probs * m, dim=-1))
        experts.append(idx)
        p = p * (1.0 - m)

    # later choices offset by the POST-truncation count of earlier ones:
    # a dropped choice-0 token does not waste a slot a choice-1 token fills
    counts = torch.zeros((b, 1, e), dtype=torch.float32,
                         device=logits.device)
    keeps, positions = [], []
    for m in masks:
        pos = torch.cumsum(m, dim=1) - m + counts
        pos_tok = torch.sum(pos * m, dim=-1)  # (B, N)
        keep = pos_tok < capacity
        km = m * keep[..., None].float()
        keeps.append(keep)
        positions.append(pos_tok.long())
        counts = counts + torch.sum(km, dim=1, keepdim=True)

    # renormalize the kept gates to sum 1 per token (0-token rows stay 0)
    kept_gate = [g * k.float() for g, k in zip(gates, keeps)]
    denom = sum(kept_gate)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    weights = [g / denom for g in kept_gate]

    # Switch aux: E · Σ_e (fraction of tokens whose TOP choice is e) · p̄_e
    frac = torch.mean(masks[0], dim=(0, 1))
    pbar = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac * pbar)
    routing = Routing(experts=torch.stack(experts, dim=-1),
                      positions=torch.stack(positions, dim=-1),
                      keep=torch.stack(keeps, dim=-1),
                      weights=torch.stack(weights, dim=-1),
                      capacity=capacity)
    return routing, aux


def route_topk(logits, top_k: int, capacity: int):
    """GShard top-k routing → ``(dispatch, combine, aux_loss)``, the
    reference's dense form: logits ``(B, N, E)`` float32; dispatch ``(B, N,
    E, C)`` one-hot {0, 1}, combine ``(B, N, E, C)`` gate-weighted, and
    the Switch balance loss. :func:`moe_mlp` uses the index form
    (:func:`_route`) of the same routing."""
    r, aux = _route(logits, top_k, capacity)
    e = logits.shape[-1]
    oh_e = (r.experts[..., None] == torch.arange(
        e, device=logits.device)).float()  # (B, N, k, E)
    oh_c = (r.positions[..., None] == torch.arange(
        capacity, device=logits.device)).float()  # (B, N, k, C)
    oh = (oh_e[..., :, None] * oh_c[..., None, :]
          * r.keep[..., None, None].float())  # (B, N, k, E, C)
    dispatch = oh.sum(dim=2)
    combine = (oh * r.weights[..., None, None]).sum(dim=2)
    return dispatch, combine, aux


def _slots(routing: Routing, first: int, local: int, b: int):
    """Each choice's row in a ``(local·B·C + 1, ·)`` slot buffer of the
    experts ``[first, first + local)``: expert-major, then batch row, then
    position; a dropped choice, or one on another rank's expert, goes to
    the last row (a dump, never read back with weight)."""
    c = routing.capacity
    e_loc = routing.experts - first
    mine = routing.keep & (e_loc >= 0) & (e_loc < local)
    rows = torch.arange(b, device=e_loc.device)[:, None, None]
    flat = e_loc * (b * c) + rows * c + routing.positions
    dump = local * b * c
    return torch.where(mine, flat, torch.full_like(flat, dump)), mine


def _experts(h, routing: Routing, w_gate, w_up, w_down, first: int):
    """This rank's share of the MoE output, float32 ``(B, N, d)``: the
    kept tokens of its experts ``[first, first + E_local)`` copied into
    their slots, the SwiGLU expert products over every slot (batched over
    the expert axis), and each token's weighted sum of its slots'
    outputs."""
    b, n, d = h.shape
    local = w_gate.shape[0]
    c = routing.capacity
    k = routing.experts.shape[-1]
    rows, mine = _slots(routing, first, local, b)
    flat_rows = rows.reshape(-1)
    tokens = h[:, :, None, :].expand(b, n, k, d).reshape(-1, d)
    buf = torch.zeros((local * b * c + 1, d), dtype=h.dtype, device=h.device)
    buf = buf.index_copy(0, flat_rows, tokens)
    xe = buf[:-1].reshape(local, b * c, d)
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    act = (F.silu(g.float()) * u.float()).to(h.dtype)
    y = torch.bmm(act, w_down).reshape(local * b * c, d)
    y = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    picked = y.index_select(0, flat_rows).reshape(b, n, k, d).float()
    # the reference weights in the model dtype (combine.astype(h.dtype))
    w = (routing.weights * mine.float()).to(h.dtype).float()
    return sum(w[..., j, None] * picked[:, :, j] for j in range(k))


def moe_mlp(layer, h, *, top_k: int = 2, capacity_factor: float = 1.25,
            ep=None):
    """MoE SwiGLU block: h ``(B, N, dim)`` → ``(out (B, N, dim), aux)``.

    ``ep``: the ``expert`` axis whose ranks hold ``layer``'s expert-major
    tensors as lists of slices (:func:`shard_experts`); the router
    ``wr`` is whole. Without it ``layer`` holds every expert."""
    b, n, d = h.shape
    wr = layer["wr"]
    e = wr.shape[-1]
    capacity = max(1, math.ceil(top_k * n / e * capacity_factor))
    logits = h.float() @ wr  # (B, N, E)
    routing, aux = _route(logits, top_k, capacity)
    if ep is None:
        out = _experts(h, routing, layer["w_gate"], layer["w_up"],
                       layer["w_down"], 0)
        return out.to(h.dtype), aux
    local = e // ep.size

    def share(i, hr, experts, positions, keep, weights, wg, wu, wd):
        r = Routing(experts=experts, positions=positions, keep=keep,
                    weights=weights, capacity=capacity)
        return _experts(hr, r, wg, wu, wd, (ep.first + i) * local)

    per_rank = [ep.broadcast(t) for t in (
        h, routing.experts, routing.positions, routing.keep,
        routing.weights)]
    parts = ep.map(share, *per_rank, layer["w_gate"], layer["w_up"],
                   layer["w_down"])
    return ep.sum(parts).to(h.dtype), aux
