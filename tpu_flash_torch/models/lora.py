"""Multi-LoRA serving: per-request low-rank adapters over one base model;
port of ``tpu_flash/models/lora.py``.

An adapter is a pair of rank-r factors a projection, ``W_eff = W + A @ B``;
the bank for N adapters stacks them, ``a: (N, in, r)`` and ``b: (N, r,
out)`` a projection and layer. In a continuously batched decode each lane
gathers its adapter's factors (``a[ids]``) and adds ``(x @ a_g) @ b_g``,
two skinny batched products with static shapes. ``adapter_id = -1`` is the
base model: the gather clamps to row 0 and the delta is multiplied by 0, so
mixed base/adapter batches are one call (and, on the card, one CUDA graph
whose id buffer a replay reads afresh).

Contracts (the reference's): a zero ``b`` changes nothing; a served
adapter equals the model with ``W + A @ B`` merged offline
(:func:`merge_lora`). Scope: the attention projections wq/wk/wv/wo.
"""

from __future__ import annotations

import torch

TARGETS = ("wq", "wk", "wv", "wo")


def init_lora_bank(cfg, num_adapters: int, rank: int,
                   generator: torch.Generator, device="cuda",
                   targets=TARGETS):
    """Adapter bank: one dict a layer, ``{target: {"a", "b"}}``, in the
    model dtype. ``a`` ~ N(0, 1/rank) (the reference's ``normal / rank``)
    and ``b`` = 0, the standard init, so a fresh bank is an exact no-op.
    ``generator`` must live on ``device``'s type."""
    dt = cfg.torch_dtype
    dims = dict(wq=(cfg.dim, cfg.q_dim), wk=(cfg.dim, cfg.kv_dim),
                wv=(cfg.dim, cfg.kv_dim), wo=(cfg.q_dim, cfg.dim))
    layers = []
    for _ in range(cfg.num_layers):
        layer = {}
        for t in targets:
            fan_in, fan_out = dims[t]
            a = torch.randn((num_adapters, fan_in, rank), generator=generator,
                            device=device, dtype=torch.float32) / rank
            layer[t] = dict(a=a.to(dt),
                            b=torch.zeros((num_adapters, rank, fan_out),
                                          dtype=dt, device=device))
        layers.append(layer)
    return layers


def lora_mm(x, w, entry, adapter_ids):
    """``x @ w`` plus each lane's adapter delta.

    x: ``(B, n, in)``; entry: ``{"a": (N, in, r), "b": (N, r, out)}``;
    adapter_ids: ``(B,)`` int, −1 = the base model (delta multiplied by 0).
    Weight-quantized base matrices compose: the delta adds after the
    dequantized product (``models/transformer.py:_mm``)."""
    from tpu_flash_torch.models.transformer import _mm

    y = _mm(x, w)
    if entry is None:
        return y
    ids = torch.clamp(adapter_ids, 0, entry["a"].shape[0] - 1).long()
    on = (adapter_ids >= 0).to(y.dtype)[:, None, None]
    a_g = entry["a"][ids]  # (B, in, r)
    b_g = entry["b"][ids]  # (B, r, out)
    delta = torch.bmm(torch.bmm(x, a_g), b_g)
    return y + delta * on


def merge_lora(params, bank, adapter: int):
    """The model with adapter ``adapter`` merged into its dense weights,
    ``W + A @ B`` in float32 then the weight's dtype: the exactness oracle
    (serving adapter k must equal serving this model). Refuses int8
    weight-only matrices: merge before quantizing."""
    out_layers = []
    for layer, lora in zip(params["layers"], bank):
        l2 = dict(layer)
        for t, entry in lora.items():
            w = layer[t]
            if isinstance(w, dict):
                raise ValueError("merge onto weight-quantized params is "
                                 "not supported; merge before quantizing")
            delta = entry["a"][adapter].float() @ entry["b"][adapter].float()
            l2[t] = (w.float() + delta).to(w.dtype)
        out_layers.append(l2)
    return {**params, "layers": out_layers}
