"""Port parity: int8 weight-only projections (``quantize_weights`` and the
``{"q", "s"}`` matmul) against the reference's, with weights converted from
the reference's ``init_params``.

The quantizer is bit-identical (the reference's eager ``quantize`` along
axis 0). A float32 model keeps the forward comparison about the algorithm
(1e-3, the reference engine tests' own bound for f32 paths); in bf16 the
int8 model stays within the reference's 0.08 relative logit bound of the
bf16 model (``tests/test_wquant.py:31-39``), and the engine's greedy
streams with int8 weights match the reference's token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

_CFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
            num_kv_heads=2, head_dim=32, block_q=128, block_kv=128)
_PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
TOL = 1e-3
_jforward = jax.jit(jtfm.forward, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def models():
    """dtype → (reference params, its int8 tree, the port's converted
    params)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jp = jtfm.init_params(jax.random.PRNGKey(0),
                              jtfm.ModelConfig(**_CFG, dtype=dtype))
        out[dtype] = (jp, jtfm.quantize_weights(jp),
                      params_from_tree(jax.tree.map(np.asarray, jp),
                                       device="cpu"))
    return out


def _tokens():
    return np.random.default_rng(0).integers(1, 255, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_bit_identical(models, dtype):
    """q and s equal bit for bit, int8 and float32; embeddings and norms
    untouched; the original tree is not changed."""
    _, jq, tp = models[dtype]
    tq = ttfm.quantize_weights(tp)
    want = params_from_tree(jax.tree.map(np.asarray, jq), device="cpu")
    for tl, wl, orig in zip(tq["layers"], want["layers"], tp["layers"]):
        for name in _PROJ:
            assert tl[name]["q"].dtype == torch.int8
            assert tl[name]["s"].dtype == torch.float32
            assert torch.equal(tl[name]["q"], wl[name]["q"]), name
            assert torch.equal(tl[name]["s"], wl[name]["s"]), name
            assert isinstance(orig[name], torch.Tensor)
        for name in ("ln_attn", "ln_mlp"):
            assert tl[name] is orig[name]
    assert tq["embed"] is tp["embed"] and tq["ln_f"] is tp["ln_f"]
    with pytest.raises(ValueError, match="int8"):
        ttfm.quantize_weights(tp, "int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_reference(models, dtype):
    """The port's forward on its own int8 tree against the reference's on
    its int8 tree: float32 within 1e-3; bf16 within 2e-2 (the bf16 gate:
    the bf16 models alone differ by 7.8e-3, two ulps of logits near 0.8)
    and within the 0.08 relative logit bound of the reference's bf16
    model, as the reference's int8 model is."""
    jp, jq, tp = models[dtype]
    jcfg = jtfm.ModelConfig(**_CFG, dtype=dtype)
    tcfg = ttfm.ModelConfig(**_CFG, dtype=dtype)
    toks = _tokens()
    want = np.asarray(_jforward(jq, jnp.asarray(toks), cfg=jcfg))
    got = ttfm.forward(ttfm.quantize_weights(tp), torch.as_tensor(toks).long(),
                       tcfg).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 16, 256)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        return
    np.testing.assert_allclose(got, want, atol=2e-2)
    ref = np.asarray(_jforward(jp, jnp.asarray(toks), cfg=jcfg))
    denom = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(want - ref).max()) / denom < 0.08
    assert float(np.abs(got - ref).max()) / denom < 0.08


def test_int8_engine_streams_match_reference(models):
    """Greedy streams of the engine with int8 weights (float32 model and
    cache) equal the reference engine's token for token; logprobs within
    1e-3."""
    dtype = "float32"
    _, jq, tp = models[dtype]
    ccfg = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=64,
                max_seqs=8, max_pages_per_seq=16, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 255, n)] for n in (10, 21)]
    ref = jeng.Engine(jq, jtfm.ModelConfig(**_CFG, dtype=dtype),
                      JCacheConfig(**ccfg), jeng.EngineConfig(max_batch=2))
    port = teng.Engine(ttfm.quantize_weights(tp),
                       ttfm.ModelConfig(**_CFG, dtype=dtype),
                       CacheConfig(**ccfg), teng.EngineConfig(max_batch=2))
    for eng, mod in ((ref, jeng), (port, teng)):
        for rid, p in enumerate(prompts):
            eng.submit(mod.Request(rid=rid, prompt=p, max_new_tokens=6))
    want = {f.rid: f for f in ref.run()}
    got = {f.rid: f for f in port.run()}
    assert sorted(got) == sorted(want) == [0, 1]
    for rid, f in want.items():
        assert got[rid].tokens == f.tokens, rid
        np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=TOL)
