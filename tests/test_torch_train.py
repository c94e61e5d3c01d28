"""Port parity of the training path: ``loss_fn``, its gradient through the
flash backward, and one SGD ``train_step``.

The reference's weights (``init_params``) are converted to the port's, and
the same numpy tokens go to ``jax.value_and_grad(loss_fn)`` (Pallas in
interpret mode) and to torch autograd of the port's ``loss_fn`` (plain
forward and backward on the CPU). A float32 model keeps the comparison
about the algorithm: loss within 1e-5 relative, every gradient within 1e-3
of its largest entry (float32 sums in another order through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.models import transformer as jtfm
from tpu_flash_torch import graft_entry
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.ops.oracle import dense_dpa
from tpu_flash_torch.utils.convert import params_from_tree, to_numpy

torch.set_num_threads(2)

_CFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
            num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
            dtype="float32")
JCFG, TCFG = jtfm.ModelConfig(**_CFG), ttfm.ModelConfig(**_CFG)
LR = 0.5  # large enough that the update is far above float32 rounding
_jvg = jax.jit(jax.value_and_grad(lambda p, t: jtfm.loss_fn(p, t, JCFG)))


@pytest.fixture(scope="module")
def ref():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    toks = np.random.default_rng(0).integers(0, 256, (2, 41)).astype(np.int32)
    jloss, jgrads = _jvg(jp, jnp.asarray(toks))
    return jp, toks, float(jloss), jgrads


def _port_params(jp):
    return params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_loss_and_grads_match_reference(ref):
    jp, toks, jloss, jgrads = ref
    tp = _port_params(jp)
    loss, grads = graft_entry.loss_and_grads(tp, torch.as_tensor(toks), TCFG)
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    tflat = _flat(graft_entry._with_leaves(tp, [to_numpy(g) for g in grads]))
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert tflat.keys() == jflat.keys()
    for key, jg in jflat.items():
        assert _rel(tflat[key], jg) <= 1e-3, key


def test_train_step_matches_reference_update(ref):
    """One step against the dry run's rule p − lr·g.astype(p.dtype)
    applied in JAX to the reference's gradient; the returned loss is the
    loss before the step."""
    jp, toks, jloss, jgrads = ref
    jnew = jax.tree.map(lambda p, g: p - LR * g.astype(p.dtype), jp, jgrads)
    tp = _port_params(jp)
    tnew, loss = graft_entry.train_step(tp, torch.as_tensor(toks), TCFG, LR)
    assert tnew is tp and loss.shape == () and loss.dtype == torch.float32
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    assert not any(t.requires_grad for t in graft_entry.param_leaves(tnew))
    tflat, jflat = _flat(jax.tree.map(to_numpy, tnew)), _flat(jnew)
    jold = _flat(jp)
    for key, jv in jflat.items():
        step = np.asarray(jv) - np.asarray(jold[key])
        got = tflat[key] - np.asarray(jold[key])
        assert _rel(got, step) <= 1e-3, key
    # the step lowers the loss on its own batch
    after = float(ttfm.loss_fn(tnew, torch.as_tensor(toks), TCFG))
    assert after < float(loss)


def test_oracle_attn_fn_gives_the_default_loss(ref):
    """``attn_fn`` = the f32 oracle on (B, H, N, D) with k/v heads repeated
    gives the flash path's loss (1e-5 relative)."""
    jp, toks, jloss, _ = ref
    tp = _port_params(jp)
    toks = torch.as_tensor(toks)
    with torch.no_grad():
        base = float(ttfm.loss_fn(tp, toks, TCFG))
        oracle = float(ttfm.loss_fn(
            tp, toks, TCFG,
            attn_fn=lambda q, k, v: dense_dpa(q, k, v, causal=True)[0]))
    assert abs(oracle - base) <= 1e-5 * abs(base)
    assert abs(base - jloss) <= 1e-5 * abs(jloss)


_SLIDING = dict(_CFG, attention="sliding", window=17)
JSCFG, TSCFG = jtfm.ModelConfig(**_SLIDING), ttfm.ModelConfig(**_SLIDING)


def test_sliding_loss_and_grads_match_reference(ref):
    """The sliding model (window 17: a band of radius 8 over 40 positions)
    through the band's forward and backward: loss and every gradient vs
    ``jax.value_and_grad(loss_fn)`` of the reference, with the tolerances
    above. Its loss differs from the causal model's, so the band is seen."""
    jp, toks, causal_loss, _ = ref
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss_fn(p, t, JSCFG)))(jp, jnp.asarray(toks))
    tp = _port_params(jp)
    loss, grads = graft_entry.loss_and_grads(tp, torch.as_tensor(toks), TSCFG)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(loss) - causal_loss) > 1e-5 * abs(causal_loss)
    tflat = _flat(graft_entry._with_leaves(tp, [to_numpy(g) for g in grads]))
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert tflat.keys() == jflat.keys()
    for key, jg in jflat.items():
        assert _rel(tflat[key], jg) <= 1e-3, key


def test_moe_loss_raises():
    """MoE is ported (its loss raised before): loss_fn of a MoE model (4
    experts, top-2) on the reference's weights equals the reference's,
    the Switch balance term included (1e-5 relative), and the term
    weights in by moe_aux_coef."""
    cfg = {**_CFG, "moe_experts": 4}
    jcfg, tcfg = jtfm.ModelConfig(**cfg), ttfm.ModelConfig(**cfg)
    jp = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    toks = np.random.default_rng(2).integers(0, 256, (2, 33)).astype(np.int32)
    jloss = float(jax.jit(lambda p, t: jtfm.loss_fn(p, t, jcfg))(
        jp, jnp.asarray(toks)))
    tp = _port_params(jp)
    with torch.no_grad():
        loss = float(ttfm.loss_fn(tp, torch.as_tensor(toks).long(), tcfg))
        plain = float(ttfm.loss_fn(tp, torch.as_tensor(toks).long(), tcfg,
                                   moe_aux_coef=0.0))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert 1e-3 < loss - plain < 0.1  # 0.01 × the layers' mean aux (≥ 1)
