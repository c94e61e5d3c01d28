"""Entry points: the counterparts of ``__graft_entry__.py``'s ``entry``
and ``train_step``, and of its multi-chip dry run's sequence-parallel step
without the tensor- and expert-parallel meshes (the dry run itself and
those meshes are ROADMAP A13).

    fn, args = entry()            # the flagship forward on a small config
    logits = fn(*args)
    params, loss = train_step(params, tokens, cfg, lr)
    params, loss = seq_parallel_train_step(params, tokens, cfg, lr, ranks=4)

``entry`` builds the reference's small flagship config (vocab 512, dim 256,
2 layers, 4/2 heads, head_dim 64) with random weights from seed 0 and
tokens (2, 256); ``fn`` is ``models/transformer.py:forward``.

take the gradient of ``models/transformer.py:loss_fn`` with respect to
every parameter leaf (attention backward through B4/B5 on the card) and
apply the reference's update ``p − lr·g.astype(p.dtype)``. The
sequence-parallel step runs attention as the causal ring over ``ranks``
virtual ranks (``parallel/ring.py``), K/V heads repeated to the q heads.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.parallel import ring


ENTRY_CONFIG = dict(vocab_size=512, dim=256, num_layers=2, num_q_heads=4,
                    num_kv_heads=2, head_dim=64, block_q=128, block_kv=128)


def entry(device="cuda"):
    """``(fn, example_args)``: the flagship forward, ``fn(params, tokens)
    → logits (2, 256, 512)`` float32, on :data:`ENTRY_CONFIG` with bf16
    weights from seed 0 and zero tokens, on ``device``."""
    cfg = tfm.ModelConfig(**ENTRY_CONFIG)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.zeros((2, 256), dtype=torch.int64, device=device)

    def fn(params, tokens):
        return tfm.forward(params, tokens, cfg)

    return fn, (params, tokens)


def named_leaves(params, prefix=""):
    """(name, tensor) for each leaf of a parameter tree (dicts and lists),
    in a fixed order; names read like ``layers[3].wq``."""
    if isinstance(params, dict):
        return [leaf for key in params
                for leaf in named_leaves(params[key], f"{prefix}.{key}")]
    if isinstance(params, (list, tuple)):
        return [leaf for i, item in enumerate(params)
                for leaf in named_leaves(item, f"{prefix}[{i}]")]
    return [(prefix.lstrip("."), params)]


def param_leaves(params):
    """The tensors of a parameter tree, in :func:`named_leaves` order."""
    return [t for _, t in named_leaves(params)]


def _with_leaves(params, leaves):
    """``params``' tree with its leaves replaced, in :func:`param_leaves`
    order."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {key: rebuild(node[key]) for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(item) for item in node)
        return next(it)

    return rebuild(params)


def loss_and_grads(params, tokens, cfg: tfm.ModelConfig, attn_fn=None):
    """``loss_fn`` and its gradient with respect to every leaf of
    ``params`` → (detached 0-d loss, grads in :func:`param_leaves` order).
    The caller's tensors keep ``requires_grad`` as they were."""
    with torch.enable_grad():
        tracked = [t.detach().requires_grad_(True)
                   for t in param_leaves(params)]
        loss = tfm.loss_fn(_with_leaves(params, tracked), tokens, cfg,
                           attn_fn=attn_fn)
        grads = torch.autograd.grad(loss, tracked)
    return loss.detach(), list(grads)


def train_step(params, tokens, cfg: tfm.ModelConfig, lr: float,
               attn_fn=None):
    """One SGD step on ``loss_fn(params, tokens, cfg, attn_fn)``; returns
    ``(params, loss)``, the loss before the step as a 0-d float32 tensor.

    Updates the parameter tensors IN PLACE (and returns the same tree): the
    gradient of each leaf is cast to the leaf's dtype, scaled by ``lr`` and
    subtracted, the reference's rule ``p − lr·g.astype(p.dtype)``."""
    loss, grads = loss_and_grads(params, tokens, cfg, attn_fn=attn_fn)
    with torch.no_grad():
        for p, g in zip(param_leaves(params), grads):
            p.sub_(g.to(p.dtype) * lr)
    return params, loss


def seq_parallel_train_step(params, tokens, cfg: tfm.ModelConfig, lr: float,
                            ranks: int):
    """:func:`train_step` with attention as the causal ring over ``ranks``
    virtual ranks (``tokens[:, :-1]`` must split into them): the dry run's
    ``loss_fn(..., attn_fn=ring)`` step on one device."""
    return train_step(params, tokens, cfg, lr, attn_fn=ring.ring_attn_fn(
        ranks, pattern="causal", block_q=cfg.block_q, block_kv=cfg.block_kv))
