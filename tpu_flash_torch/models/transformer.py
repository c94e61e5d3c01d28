"""Llama-style transformer LM: port of ``tpu_flash/models/transformer.py``.

RMSNorm → GQA attention (prefill and training through the flash kernels,
forward B1 and backward B4/B5; decode and the chunk prefix through the
paged kernels) → dense SwiGLU, RoPE positions, tied embeddings. Causal or
sliding-window attention (``attention="sliding"``: the local band of
``window`` tokens in prefill, decode and chunked prefill alike).
Parameters are a plain dict with the reference's tree and layouts
(``x @ w`` with ``w`` shaped ``(in, out)``), so weights convert one to one
(``utils/convert.py``). The reference's cast points are kept: norm, RoPE and
SiLU run in float32 and cast back to ``x``'s dtype; logits are
``(x @ embed.T)`` in float32.

Projections take raw matrices or int8 weight-only ones
(:func:`quantize_weights`: ``{"q": int8, "s": float32}``, per output
channel), computed as the reference computes them, ``(x @ q) · s`` in
``x``'s dtype. :func:`decode_verify` scores K tokens a lane in one pass
over the paged caches.

Tensor parallelism (``tp=``, the reference's ``tp_axis``): ``tp`` is the
mesh's ``model`` line (``parallel/mesh.py:AxisGroup``), ``params`` the list
of this process's ranks' slices (``parallel/shardings.py:shard_params``)
and ``caches`` one list of layer caches a rank. Activations are
replicated; each rank runs its heads and its share of the MLP hidden dim
on its device, one rank after another, and the row-parallel products'
partials are summed over the axis (:func:`_psum`). :func:`decode_step_seq`
shards the caches over the sequence instead
(``parallel/ring_decode.py``).

MoE layers (``moe_experts > 0``, ``models/moe.py``) carry a float32 router
``wr`` and expert-major SwiGLU weights in place of the dense MLP; their
balance losses weight into :func:`loss_fn`. Under ``tp`` the expert bank
is replicated and the MoE output takes no sum (the reference's shardings);
under ``ep`` (the mesh's ``expert`` line) the experts split over its ranks
and the combine is summed over them. Serving a MoE model needs the
drop-free capacity factor (:func:`_check_serving_moe`).

Multi-LoRA (``models/lora.py``): ``prefill_chunk``, ``decode_step`` and
``decode_verify`` take ``lora`` (an adapter bank, one dict a layer) and
``adapter_ids`` (one id a lane, −1 the base model) and add each lane's
adapter delta to the attention projections (:func:`_proj`); ``forward``
takes no adapters, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_flash_torch.models.lora import lora_mm
from tpu_flash_torch.models.moe import init_moe_params, moe_mlp
from tpu_flash_torch.ops import flash
from tpu_flash_torch.ops.paged import paged_attention, paged_attention_pipelined
from tpu_flash_torch.parallel.ring import merge_partials
from tpu_flash_torch.parallel.ring_decode import sharded_paged_attention
from tpu_flash_torch.quant.qarray import quantize

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    dim: int = 1024
    num_layers: int = 8
    num_q_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 128
    mlp_hidden: Optional[int] = None
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    attention: str = "causal"  # causal | sliding
    window: int = 1025  # odd; used when attention == "sliding"
    block_q: int = 256
    block_kv: int = 256
    moe_experts: int = 0  # > 0: MoE MLPs of this many experts
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # Attention max: None = the flash kernels' auto policy (causal and the
    # causal band keep the exact max), True = the norm bound (inference
    # only). The engine pins False: the bound depends on the kv span each
    # call sees, and chunked prefill must equal unchunked.
    attn_bound_max: Optional[bool] = None

    @property
    def hidden(self) -> int:
        if self.mlp_hidden is not None:
            return self.mlp_hidden
        # llama-style 2/3·4d, rounded to 256 lanes
        h = int(8 * self.dim / 3)
        return (h + 255) // 256 * 256

    @property
    def q_dim(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _radius(cfg: ModelConfig) -> Optional[int]:
    """The sliding band's radius, or None for causal attention."""
    return (cfg.window - 1) // 2 if cfg.attention == "sliding" else None


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.attention not in ("causal", "sliding"):
        raise ValueError(f"unknown attention {cfg.attention!r}")


def _check_serving_moe(cfg: ModelConfig) -> None:
    """Serving paths require the drop-free MoE capacity factor.

    Capacity drops depend on the batch (``models/moe.py``): a token that
    overflows in a batched prefill routes alone during decode, so a dropful
    config would decode tokens inconsistent with the teacher-forced
    forward. ``moe_capacity_factor >= E/top_k`` guarantees zero drops."""
    _check_ported(cfg)
    if cfg.moe_experts > 0:
        need = cfg.moe_experts / cfg.moe_top_k
        if cfg.moe_capacity_factor < need:
            raise ValueError(
                f"serving an MoE model needs the drop-free capacity factor "
                f"moe_capacity_factor >= E/top_k = {need} (got "
                f"{cfg.moe_capacity_factor}); dropful routing is not "
                f"prefix-consistent between batched prefill and decode")


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights with the reference's shapes, dtypes and
    distributions: N(0, 1/fan_in) projections, N(0, 0.02²) embeddings,
    float32 ones for the norms. The bits differ from the reference's (a
    torch generator, not its PRNG). The weights land on ``device`` (the
    card unless the caller asks for the CPU); ``generator`` must live on
    the same device type."""
    _check_ported(cfg)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"init_params: generator on {generator.device.type}, weights on "
            f"{device.type}; pass a torch.Generator(device={device.type!r})")
    dt = cfg.torch_dtype

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * std).to(dt)

    def dense(fan_in, shape):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def ones():
        return torch.ones(cfg.dim, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layer = dict(
            wq=dense(cfg.dim, (cfg.dim, cfg.q_dim)),
            wk=dense(cfg.dim, (cfg.dim, cfg.kv_dim)),
            wv=dense(cfg.dim, (cfg.dim, cfg.kv_dim)),
            wo=dense(cfg.q_dim, (cfg.q_dim, cfg.dim)),
            ln_attn=ones(),
            ln_mlp=ones(),
        )
        if cfg.moe_experts > 0:  # a router and experts, no dense MLP
            layer.update(init_moe_params(cfg.dim, cfg.hidden,
                                         cfg.moe_experts, dt, generator,
                                         device))
        else:
            layer.update(
                w_gate=dense(cfg.dim, (cfg.dim, cfg.hidden)),
                w_up=dense(cfg.dim, (cfg.dim, cfg.hidden)),
                w_down=dense(cfg.hidden, (cfg.hidden, cfg.dim)),
            )
        layers.append(layer)
    return dict(
        embed=normal((cfg.vocab_size, cfg.dim), 0.02),
        ln_f=ones(),
        layers=layers,
    )


_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weights(params, dtype: str = "int8"):
    """Per-output-channel symmetric int8 quantization of every 2-D
    projection matrix (wq/wk/wv/wo/w_gate/w_up/w_down) →
    ``{"q": int8 (in, out), "s": float32 (out,)}``; embeddings, norms, a
    MoE layer's router and its 3-D expert tensors stay as they are.
    Bit-identical to the reference's (its eager
    ``quantize`` along axis 0). Returns a new tree; ``params`` is not
    changed."""
    if dtype != "int8":
        raise ValueError("only int8 weight quantization is supported")

    def quant(w):
        qa = quantize(w, torch.int8, axis=0)
        return {"q": qa.values, "s": qa.scales[0].float()}

    layers = []
    for layer in params["layers"]:
        out = dict(layer)
        for name in _PROJECTIONS:
            w = layer.get(name)
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                out[name] = quant(w)
        layers.append(out)
    return {**params, "layers": layers}


def _mm(x, w):
    """x @ w for raw or weight-quantized (``{"q": int8, "s": f32}``)
    matrices: the int8 matrix cast to x's dtype, the product, then the
    per-column scale in x's dtype, rounding where the reference rounds."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _proj(x, w, lora_layer, name, adapter_ids):
    """A projection with each lane's LoRA delta (``models/lora.py``) where
    the layer's bank entry has this projection; else :func:`_mm`."""
    entry = lora_layer.get(name) if lora_layer else None
    if entry is None:
        return _mm(x, w)
    return lora_mm(x, w, entry, adapter_ids)


def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * w).to(x.dtype)


def _rope_angles(positions, head_dim, theta):
    # positions: (..., n) int → cos/sin (..., n, head_dim/2)
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta):
    """x: (..., n, heads, head_dim); positions: (..., n)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attn_full(q, k, v, cfg: ModelConfig, attn_fn=None):
    """Full-sequence attention (training / prefill), causal or the causal
    sliding band. q: (B, N, QH, D).

    ``attn_fn``, when given, replaces the flash kernels with a custom
    function on (B, H, N, D) tensors whose k/v heads are repeated to match
    q's (the reference's contract)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if attn_fn is not None:
        g = qt.shape[1] // kt.shape[1]
        if g > 1:
            kt = kt.repeat_interleave(g, dim=1)
            vt = vt.repeat_interleave(g, dim=1)
        o = attn_fn(qt, kt, vt)
    elif cfg.attention == "sliding":
        o = flash.sliding_fa(qt, kt, vt, cfg.window, causal=True,
                             block_q=cfg.block_q, block_kv=cfg.block_kv,
                             bound_max=cfg.attn_bound_max)
    else:
        o = flash.dense_fa(qt, kt, vt, causal=True, block_q=cfg.block_q,
                           block_kv=cfg.block_kv, bound_max=cfg.attn_bound_max)
    return o.transpose(1, 2)  # (B, N, H, D)


def _mlp(params, h, cfg: ModelConfig, collect_aux=None, ep=None):
    """MLP residual branch: dense SwiGLU, or the MoE expert bank when the
    layer carries a router (``wr``); a MoE layer's balance loss appends to
    ``collect_aux`` when given. ``ep``: see ``models/moe.py:moe_mlp``."""
    if "wr" in params:
        out, aux = moe_mlp(params, h, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor, ep=ep)
        if collect_aux is not None:
            collect_aux.append(aux)
        return out
    gate = F.silu(_mm(h, params["w_gate"]).float()).to(h.dtype)
    return _mm(gate * _mm(h, params["w_up"]), params["w_down"])


def _mlp_out(tp, ranks, x, cfg: ModelConfig, collect_aux=None, ep=None):
    """The MLP branch of the replicated ``x``: under ``tp`` the dense MLP's
    row-parallel partials summed over the axis; a MoE layer's bank is
    replicated, so its output is computed once, from the first rank's
    replica, and takes no sum (the reference's shardings)."""
    if "wr" in ranks[0]:
        return _mlp(ranks[0], rmsnorm(x, ranks[0]["ln_mlp"]), cfg,
                    collect_aux=collect_aux, ep=ep)
    return _psum(tp, lambda i, lp, hr: _mlp(lp, hr, cfg), ranks,
                 _normed(tp, x, ranks, "ln_mlp"))


def _qkv(params, x, positions, cfg: ModelConfig):
    return _qkv_normed(params, rmsnorm(x, params["ln_attn"]), positions, cfg)


def _qkv_normed(params, h, positions, cfg: ModelConfig, lora_layer=None,
                adapter_ids=None):
    """Rotated q, k, v of the normed input ``h`` (B, N, dim); the head
    counts follow the (possibly sliced) projection widths. ``lora_layer``,
    ``adapter_ids``: each lane's adapter delta (:func:`_proj`)."""
    b, n, _ = h.shape

    def proj(name):
        return _proj(h, params[name], lora_layer, name, adapter_ids)

    q = proj("wq").reshape(b, n, -1, cfg.head_dim)
    k = proj("wk").reshape(b, n, -1, cfg.head_dim)
    v = proj("wv").reshape(b, n, -1, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ranks(x, tp):
    """The per-rank list: ``x`` itself under ``tp`` (one entry a local
    rank), else the one rank ``[x]``."""
    return x if tp is not None else [x]


def _bcast(tp, x):
    """A replicated value on each rank's device."""
    return [x] if tp is None else tp.broadcast(x)


def _layer(params, i: int, tp):
    """Layer ``i``'s weights: a tree, or one a rank under ``tp``."""
    if tp is None:
        return params["layers"][i]
    return [p["layers"][i] for p in params]


def _layer_caches(caches, i: int, tp):
    """Layer ``i``'s cache, or one a rank (``caches[rank][layer]``)."""
    return caches[i] if tp is None else [c[i] for c in caches]


def _normed(tp, x, ranks, norm: str):
    """rmsnorm of the replicated ``x`` by the replicated weight ``norm``,
    once, on each rank's device: the column-parallel products' input (its
    cotangent is summed over the axis, so the norm's gradient is whole on
    every process)."""
    return _bcast(tp, rmsnorm(x, ranks[0][norm]))


def _psum(tp, fn, *per_rank):
    """The row-parallel completion, the reference's ``psum`` over
    ``tp_axis``: ``fn(i, *args_i)``, a partial product, on each of this
    process's ranks, summed over the axis in rank order (then over its
    processes). Without ``tp``: one rank, no sum."""
    if tp is None:
        return fn(0, *(a[0] for a in per_rank))
    return tp.sum(tp.map(fn, *per_rank))


def _block(params, x, positions, cfg: ModelConfig, collect_kv=None,
           attn_fn=None, tp=None, collect_aux=None, ep=None,
           lora_layer=None, adapter_ids=None):
    """One layer. Under ``tp``, ``params`` holds a rank's slices each and
    ``collect_kv`` takes the layer's per-rank ``(k, v)`` list;
    ``collect_aux`` takes a MoE layer's balance loss; ``lora_layer`` and
    ``adapter_ids``: each lane's adapter delta (no ``tp``)."""
    b, n, _ = x.shape
    ranks = _ranks(params, tp)
    kvs = []

    def attn(i, lp, hr, pr):
        q, k, v = _qkv_normed(lp, hr, pr, cfg, lora_layer, adapter_ids)
        kvs.append((k, v))
        o = _attn_full(q, k, v, cfg, attn_fn=attn_fn).reshape(b, n, -1)
        return _proj(o, lp["wo"], lora_layer, "wo", adapter_ids)

    x = x + _psum(tp, attn, ranks, _normed(tp, x, ranks, "ln_attn"),
                  _bcast(tp, positions))
    if collect_kv is not None:
        collect_kv.append(kvs if tp is not None else kvs[0])
    return x + _mlp_out(tp, ranks, x, cfg, collect_aux=collect_aux, ep=ep)


def _positions(b: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(b, n)


def forward(params, tokens, cfg: ModelConfig, positions=None, attn_fn=None,
            tp=None, collect_aux=None, ep=None):
    """Full forward: tokens (B, N) int → logits (B, N, vocab) f32.
    ``attn_fn``: see :func:`_attn_full`; ``tp``, ``ep``: see the module
    note; ``collect_aux``: a list that takes each MoE layer's balance
    loss."""
    _check_ported(cfg)
    top = _ranks(params, tp)[0]
    b, n = tokens.shape
    if positions is None:
        positions = _positions(b, n, tokens.device)
    x = top["embed"][tokens]
    for i in range(len(top["layers"])):
        x = _block(_layer(params, i, tp), x, positions, cfg, attn_fn=attn_fn,
                   tp=tp, collect_aux=collect_aux, ep=ep)
    x = rmsnorm(x, top["ln_f"])
    return (x @ top["embed"].T).float()


def loss_fn(params, tokens, cfg: ModelConfig, attn_fn=None,
            moe_aux_coef: float = 0.01, tp=None, ep=None):
    """Next-token cross entropy over tokens (B, N + 1): log_softmax of the
    float32 logits, mean over the B·N targets. A MoE model adds the Switch
    balance loss, the mean over its layers weighted by ``moe_aux_coef``."""
    aux = []
    logits = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn, tp=tp,
                     collect_aux=aux, ep=ep)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())
    loss = nll.mean()
    if aux:
        loss = loss + moe_aux_coef * sum(aux) / len(aux)
    return loss


def prefill(params, tokens, cfg: ModelConfig, tp=None):
    """Forward over the prompt, returning last-position logits and the
    per-layer rotated K/V to seed the paged cache.

    Returns (logits (B, vocab), kv: list of (k, v) each (B, N, KVH, D));
    under ``tp`` each layer's entry is a list of the ranks' (k, v).
    """
    _check_serving_moe(cfg)
    top = _ranks(params, tp)[0]
    b, n = tokens.shape
    positions = _positions(b, n, tokens.device)
    x = top["embed"][tokens]
    kv = []
    for i in range(len(top["layers"])):
        x = _block(_layer(params, i, tp), x, positions, cfg, collect_kv=kv,
                   tp=tp)
    x = rmsnorm(x, top["ln_f"])
    return (x[:, -1] @ top["embed"].T).float(), kv


def prefill_chunk(params, tokens, offset: int, true_len: int, caches,
                  slot: int, cfg: ModelConfig, pages_bound=None, tp=None,
                  lora=None, adapter_ids=None):
    """Process ONE page-aligned chunk of a prompt against the paged cache.

    Per layer, the chunk attends the already-cached prefix through the
    paged kernel (every chunk token rides a lane of the one slot, with its
    own band start under a sliding window) before its K/V are written, and
    itself through the flash kernel (causal, or the causal band); the two
    partials merge with the (o, lse) algebra.

    tokens: ``(1, C)`` ints, padded to the chunk bucket; ``offset`` is the
    chunk's first position (page-aligned); ``true_len`` the number of real
    tokens in it. Padded tail rows only attend earlier real keys, and
    nothing attends them. The caches are updated in place. Returns
    ``(logits (1, C, vocab) f32, greedy_last, caches)``: ``greedy_last``
    is the argmax token after the last real position. ``lora``,
    ``adapter_ids`` (``(1,)``): the adapter bank and the request's id.
    """
    _check_serving_moe(cfg)
    top = _ranks(params, tp)[0]
    loras = lora if lora is not None else [None] * len(top["layers"])
    b, c = tokens.shape
    dev = tokens.device
    positions = offset + torch.arange(c, dtype=torch.int32, device=dev)[None]
    x = top["embed"][tokens]
    radius = _radius(cfg)
    slot_lanes = torch.full((c,), slot, dtype=torch.int32, device=dev)

    def attn(i, lp, cache, hr, pr, lanes):
        le = loras[li]  # the layer the loop below is on
        q, k, v = _qkv_normed(lp, hr, pr, cfg, le, adapter_ids)
        # the prefix before the write: the slot's length is still
        # ``offset``, so the paged kernel sees exactly [start, offset)
        o1, lse1 = paged_attention(
            q[0], cache, lanes, radius=radius,
            positions=None if radius is None else pr[0],
            pages_bound=pages_bound, return_lse=True, shared_page_table=True,
            _shared_slot=slot)
        o2, lse2 = flash.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            schedule="causal" if radius is None else "local_causal",
            radius=radius or 0, block_q=cfg.block_q, block_kv=cfg.block_kv,
            return_lse=True, bound_max=cfg.attn_bound_max)
        o, _ = merge_partials(o1.transpose(0, 1)[None].float(),
                              lse1.transpose(0, 1)[None], o2.float(), lse2)
        o = o.transpose(1, 2).to(hr.dtype)  # (1, C, QH, D)
        cache.write_chunk(slot, k[0].transpose(0, 1), v[0].transpose(0, 1),
                          offset, valid_n=true_len)
        return _proj(o.reshape(b, c, -1), lp["wo"], le, "wo", adapter_ids)

    for li in range(len(top["layers"])):
        ranks = _ranks(_layer(params, li, tp), tp)
        x = x + _psum(tp, attn, ranks,
                      _ranks(_layer_caches(caches, li, tp), tp),
                      _normed(tp, x, ranks, "ln_attn"), _bcast(tp, positions),
                      _bcast(tp, slot_lanes))
        x = x + _mlp_out(tp, ranks, x, cfg)
    x = rmsnorm(x, top["ln_f"])
    logits = (x @ top["embed"].T).float()
    return logits, torch.argmax(logits[0, true_len - 1]), caches


def decode_verify(params, tokens, positions, caches, slots,
                  cfg: ModelConfig, pages_bound=None, tp=None, lora=None,
                  adapter_ids=None):
    """Score K tokens a lane in one pass over the paged caches
    (speculative verification).

    tokens: ``(B, K)`` ints, lane b's pending token then K − 1 proposals;
    positions: ``(B,)`` int32, the position of ``tokens[:, 0]`` (the slot's
    stored length). Per layer the K tokens' K/V append first (K
    ``PagedKVCache.append`` calls: B3 on the card), then one paged
    attention call rides the B·K tokens on the lane axis with visible
    lengths ``position + j + 1`` (B2's split route, ``lengths_override``;
    under a band each lane's own position), so token j sees what K
    sequential decode steps would show it. Returns ``(logits (B, K,
    vocab) f32, caches)``, every slot advanced by K, in place. ``lora``,
    ``adapter_ids`` (``(B,)``): the adapter bank and each lane's id.
    """
    _check_serving_moe(cfg)
    top = _ranks(params, tp)[0]
    loras = lora if lora is not None else [None] * len(top["layers"])
    b, k_len = tokens.shape
    dev = tokens.device
    pos = (positions.to(torch.int32)[:, None]
           + torch.arange(k_len, dtype=torch.int32, device=dev)[None])
    x = top["embed"][tokens]  # (B, K, dim)
    radius = _radius(cfg)
    lane_args = [_bcast(tp, t) for t in (
        pos, slots, slots.repeat_interleave(k_len), (pos + 1).reshape(-1),
        pos.reshape(-1))]

    def attn(i, lp, cache, hr, pr, sl, sl_flat, vis_flat, pos_flat):
        le = loras[li]  # the layer the loop below is on
        q, k, v = _qkv_normed(lp, hr, pr, cfg, le, adapter_ids)
        for j in range(k_len):
            cache.append(sl, k[:, j], v[:, j])
        o = paged_attention(
            q.reshape(b * k_len, -1, cfg.head_dim), cache, sl_flat,
            lengths_override=vis_flat,
            positions=None if radius is None else pos_flat,
            pages_bound=pages_bound, radius=radius)
        return _proj(o.reshape(b, k_len, -1), lp["wo"], le, "wo",
                     adapter_ids)

    for li in range(len(top["layers"])):
        ranks = _ranks(_layer(params, li, tp), tp)
        x = x + _psum(tp, attn, ranks,
                      _ranks(_layer_caches(caches, li, tp), tp),
                      _normed(tp, x, ranks, "ln_attn"), *lane_args)
        x = x + _mlp_out(tp, ranks, x, cfg)
    x = rmsnorm(x, top["ln_f"])
    return (x @ top["embed"].T).float(), caches


def decode_step(params, tokens, positions, caches, slots, cfg: ModelConfig,
                pages_bound=None, pipelined=False, tp=None, lora=None,
                adapter_ids=None):
    """One decode step over the paged caches.

    tokens: (B,) new token ids; positions: (B,) their positions; caches:
    one PagedKVCache per layer (under ``tp``: one such list a rank);
    slots: (B,) int32 slot ids. Each layer
    appends the new token's K/V to its cache (in place; on the card inside
    the paged attention's launch, B2 with B3 fused), so the token attends
    to itself; a sliding model
    attends only its band. ``pipelined=True`` takes the reference's
    pipelined decode (``paged_attention_pipelined``: each lane walks
    exactly its own pages; ``pages_bound`` is then ignored). ``lora``,
    ``adapter_ids`` (``(B,)``): the adapter bank and each lane's id.

    Returns (logits (B, vocab) f32, caches).
    """
    _check_serving_moe(cfg)
    top = _ranks(params, tp)[0]
    loras = lora if lora is not None else [None] * len(top["layers"])
    b = tokens.shape[0]
    x = top["embed"][tokens][:, None, :]  # (B, 1, dim)
    radius = _radius(cfg)
    pos_r, slots_r = _bcast(tp, positions[:, None]), _bcast(tp, slots)

    def attn(i, lp, cache, hr, pr, sl):
        le = loras[li]  # the layer the loop below is on
        q, k, v = _qkv_normed(lp, hr, pr, cfg, le, adapter_ids)
        new_kv = (k[:, 0], v[:, 0])
        if pipelined:
            o, _ = paged_attention_pipelined(q[:, 0], cache, sl,
                                             new_kv=new_kv, radius=radius)
        else:
            o, _ = paged_attention(q[:, 0], cache, sl, new_kv=new_kv,
                                   pages_bound=pages_bound, radius=radius)
        return _proj(o.reshape(b, 1, -1), lp["wo"], le, "wo", adapter_ids)

    for li in range(len(top["layers"])):
        ranks = _ranks(_layer(params, li, tp), tp)
        x = x + _psum(tp, attn, ranks,
                      _ranks(_layer_caches(caches, li, tp), tp),
                      _normed(tp, x, ranks, "ln_attn"), pos_r, slots_r)
        x = x + _mlp_out(tp, ranks, x, cfg)
    x = rmsnorm(x, top["ln_f"])
    return (x[:, 0] @ top["embed"].T).float(), caches


def decode_step_seq(params, tokens, positions, caches, slots,
                    cfg: ModelConfig, seq, pages_bound=None):
    """One decode step with each layer's paged cache SHARDED over the
    sequence axis ``seq`` (``parallel/mesh.py:AxisGroup``).

    The dense path is :func:`decode_step`'s, replicated (one token a lane,
    not worth sharding); attention runs ``parallel/ring_decode.py:
    sharded_paged_attention``: every rank attends its local slice of the
    history, the partials merge over the axis, and the new token's K/V
    land only on the last rank. ``caches``: one list of layer caches a
    local rank, each with its own page tables and lengths (local tokens).
    Sliding-window decode raises (band positions are global).
    """
    _check_serving_moe(cfg)
    if cfg.attention == "sliding":
        raise NotImplementedError("seq-sharded decode is causal-only")
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None, :]
    pos = positions[:, None]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, pos, cfg)
        o, _ = sharded_paged_attention(
            q[:, 0], [c[li] for c in caches], slots, seq,
            new_kv=(k[:, 0], v[:, 0]), pages_bound=pages_bound)
        x = x + _mm(o.reshape(b, 1, -1), layer["wo"])
        x = x + _mlp(layer, rmsnorm(x, layer["ln_mlp"]), cfg)
    x = rmsnorm(x, params["ln_f"])
    return (x[:, 0] @ params["embed"].T).float(), caches
