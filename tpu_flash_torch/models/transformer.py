"""Llama-style transformer LM: port of ``tpu_flash/models/transformer.py``.

RMSNorm → GQA attention (prefill and training through the causal flash
kernels, forward B1 and backward B4/B5; decode through the paged kernels) →
dense SwiGLU, RoPE positions, tied embeddings.
Parameters are a plain dict with the reference's tree and layouts
(``x @ w`` with ``w`` shaped ``(in, out)``), so weights convert one to one
(``utils/convert.py``). The reference's cast points are kept: norm, RoPE and
SiLU run in float32 and cast back to ``x``'s dtype; logits are
``(x @ embed.T)`` in float32.

Not ported yet: sliding attention (ROADMAP A3), MoE (A9), LoRA (A9),
int8 weights (A6), tensor parallelism (A13), ``prefill_chunk`` and
``decode_verify`` (A6), the pipelined decode kernel (A5), the MoE balance
loss in ``loss_fn`` (A9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_flash_torch.ops import flash
from tpu_flash_torch.ops.paged import paged_attention

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
    attention: str = "causal"  # causal (sliding: ROADMAP A3)
    window: int = 1025
    block_q: int = 256
    block_kv: int = 256
    moe_experts: int = 0  # >0: ROADMAP A9
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # Only the exact running max is ported: True raises (ROADMAP A3).
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


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.attention != "causal":
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported yet (ROADMAP A3)")
    if cfg.moe_experts > 0:
        raise NotImplementedError("MoE MLPs are not ported yet (ROADMAP A9)")


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
        layers.append(dict(
            wq=dense(cfg.dim, (cfg.dim, cfg.q_dim)),
            wk=dense(cfg.dim, (cfg.dim, cfg.kv_dim)),
            wv=dense(cfg.dim, (cfg.dim, cfg.kv_dim)),
            wo=dense(cfg.q_dim, (cfg.q_dim, cfg.dim)),
            ln_attn=ones(),
            ln_mlp=ones(),
            w_gate=dense(cfg.dim, (cfg.dim, cfg.hidden)),
            w_up=dense(cfg.dim, (cfg.dim, cfg.hidden)),
            w_down=dense(cfg.hidden, (cfg.hidden, cfg.dim)),
        ))
    return dict(
        embed=normal((cfg.vocab_size, cfg.dim), 0.02),
        ln_f=ones(),
        layers=layers,
    )


def _mm(x, w):
    """x @ w for raw weight matrices (int8 weights: ROADMAP A6)."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "weight-quantized matrices are not ported yet (ROADMAP A6)")
    return x @ w


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
    """Full-sequence causal attention (training / prefill). q: (B, N, QH, D).

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
    else:
        o = flash.dense_fa(qt, kt, vt, causal=True, block_q=cfg.block_q,
                           block_kv=cfg.block_kv, bound_max=cfg.attn_bound_max)
    return o.transpose(1, 2)  # (B, N, H, D)


def _mlp(params, h, cfg: ModelConfig):
    """Dense SwiGLU residual branch."""
    gate = F.silu(_mm(h, params["w_gate"]).float()).to(h.dtype)
    return _mm(gate * _mm(h, params["w_up"]), params["w_down"])


def _qkv(params, x, positions, cfg: ModelConfig):
    b, n, _ = x.shape
    h = rmsnorm(x, params["ln_attn"])
    q = _mm(h, params["wq"]).reshape(b, n, -1, cfg.head_dim)
    k = _mm(h, params["wk"]).reshape(b, n, -1, cfg.head_dim)
    v = _mm(h, params["wv"]).reshape(b, n, -1, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block(params, x, positions, cfg: ModelConfig, collect_kv=None,
           attn_fn=None):
    b, n, _ = x.shape
    q, k, v = _qkv(params, x, positions, cfg)
    if collect_kv is not None:
        collect_kv.append((k, v))
    o = _attn_full(q, k, v, cfg, attn_fn=attn_fn).reshape(b, n, -1)
    x = x + _mm(o, params["wo"])
    return x + _mlp(params, rmsnorm(x, params["ln_mlp"]), cfg)


def _positions(b: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(b, n)


def forward(params, tokens, cfg: ModelConfig, positions=None, attn_fn=None):
    """Full causal forward: tokens (B, N) int → logits (B, N, vocab) f32.
    ``attn_fn``: see :func:`_attn_full`."""
    _check_ported(cfg)
    b, n = tokens.shape
    if positions is None:
        positions = _positions(b, n, tokens.device)
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = _block(layer, x, positions, cfg, attn_fn=attn_fn)
    x = rmsnorm(x, params["ln_f"])
    return (x @ params["embed"].T).float()


def loss_fn(params, tokens, cfg: ModelConfig, attn_fn=None,
            moe_aux_coef: float = 0.01):
    """Next-token cross entropy over tokens (B, N + 1): log_softmax of the
    float32 logits, mean over the B·N targets. ``moe_aux_coef`` weights the
    MoE balance loss of the reference; MoE configs raise (ROADMAP A9)."""
    logits = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())
    return nll.mean()


def prefill(params, tokens, cfg: ModelConfig):
    """Forward over the prompt, returning last-position logits and the
    per-layer rotated K/V to seed the paged cache.

    Returns (logits (B, vocab), kv: list of (k, v) each (B, N, KVH, D)).
    """
    _check_ported(cfg)
    b, n = tokens.shape
    positions = _positions(b, n, tokens.device)
    x = params["embed"][tokens]
    kv = []
    for layer in params["layers"]:
        x = _block(layer, x, positions, cfg, collect_kv=kv)
    x = rmsnorm(x, params["ln_f"])
    return (x[:, -1] @ params["embed"].T).float(), kv


def decode_step(params, tokens, positions, caches, slots, cfg: ModelConfig,
                pages_bound=None, pipelined=False):
    """One decode step over the paged caches.

    tokens: (B,) new token ids; positions: (B,) their positions; caches:
    one PagedKVCache per layer; slots: (B,) int32 slot ids. Each layer
    appends the new token's K/V to its cache (in place, B3) before the
    paged attention (B2), so the token attends to itself.

    Returns (logits (B, vocab) f32, caches).
    """
    _check_ported(cfg)
    if pipelined:
        raise NotImplementedError(
            "the pipelined decode kernel (B12) is not ported yet (ROADMAP A5)")
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None, :]  # (B, 1, dim)
    pos = positions[:, None]
    for layer, cache in zip(params["layers"], caches):
        q, k, v = _qkv(layer, x, pos, cfg)
        o, _ = paged_attention(
            q[:, 0], cache, slots, new_kv=(k[:, 0], v[:, 0]),
            pages_bound=pages_bound,
        )
        x = x + _mm(o.reshape(b, 1, -1), layer["wo"])
        x = x + _mlp(layer, rmsnorm(x, layer["ln_mlp"]), cfg)
    x = rmsnorm(x, params["ln_f"])
    return (x[:, 0] @ params["embed"].T).float(), caches
