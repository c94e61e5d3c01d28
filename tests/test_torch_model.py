"""Port parity: the transformer (forward, prefill, decode_step) with the
reference's weights converted from ``init_params``.

A float32 model keeps the comparison about the algorithm: both sides run the
same cast points, so logits agree to float32 summation order (1e-3, the
reference engine tests' own bound for f32 paths). The decode step's paged
attention casts q/K/V to bf16 by contract on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.models import transformer as jtfm
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.utils.convert import (
    cache_from_reference,
    params_from_tree,
    to_numpy,
)

torch.set_num_threads(2)

_CFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
            num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
            dtype="float32")
JCFG, TCFG = jtfm.ModelConfig(**_CFG), ttfm.ModelConfig(**_CFG)
TOL = 1e-3
_jdecode = jax.jit(lambda *a: jtfm.decode_step(*a, JCFG, pages_bound=4))
_jforward = jax.jit(lambda p, t: jtfm.forward(p, t, JCFG))
_jprefill = jax.jit(lambda p, t: jtfm.prefill(p, t, JCFG))


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, b, n):
    return np.random.default_rng(seed).integers(1, 255, (b, n)).astype(np.int32)


def test_param_conversion_is_exact(params):
    jp, tp = params
    assert tp["embed"].dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"][1]["w_down"].numpy(),
                                  np.asarray(jp["layers"][1]["w_down"]))


def test_init_params_shapes_and_dtypes():
    """The port's own init has the reference's shapes, dtypes and scales."""
    cfg = ttfm.ModelConfig(**{**_CFG, "dtype": "bfloat16"})
    tp = ttfm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                          device="cpu")
    jp = jax.eval_shape(lambda k: jtfm.init_params(k, jtfm.ModelConfig(
        **{**_CFG, "dtype": "bfloat16"})), jax.random.PRNGKey(0))
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    flat_j = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat_t.keys() == flat_j.keys()
    for key, j in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == j.shape, key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
    std = tp["layers"][0]["wq"].float().std().item()
    assert abs(std - 1 / np.sqrt(cfg.dim)) < 0.1 / np.sqrt(cfg.dim)
    assert abs(tp["embed"].float().std().item() - 0.02) < 0.002


def test_forward_matches_reference(params):
    jp, tp = params
    toks = _tokens(0, 2, 40)
    jl = _jforward(jp, jnp.asarray(toks))
    tl = ttfm.forward(tp, torch.as_tensor(toks).long(), TCFG)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)


def test_prefill_matches_reference(params):
    jp, tp = params
    toks = _tokens(1, 1, 37)
    jl, jkv = _jprefill(jp, jnp.asarray(toks))
    tl, tkv = ttfm.prefill(tp, torch.as_tensor(toks).long(), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)


def _caches(dtype, prompt_kv, n):
    cfg = JCacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                       total_pages=32, max_seqs=4, max_pages_per_seq=8,
                       dtype=dtype)
    table = jnp.zeros((4, 8), jnp.int32).at[0].set(jnp.arange(1, 9))
    table = table.at[1].set(jnp.arange(9, 17))
    out = []
    for k, v in prompt_kv:
        c = JPagedKVCache.create(cfg).assign_pages(table)
        for s in range(2):
            c = c.write_prompt(s, jnp.swapaxes(k[s, :n[s]], 0, 1),
                               jnp.swapaxes(v[s, :n[s]], 0, 1))
        out.append(c)
    return out


@pytest.mark.parametrize("dtype", ["int8"])
def test_decode_step_matches_reference(params, dtype):
    """Three decode steps on two lanes from identical caches: logits within
    1e-3, the same lengths, and the same pages after each step."""
    jp, tp = params
    toks = _tokens(2, 2, 20)
    n = [20, 13]
    _, kv = _jprefill(jp, jnp.asarray(toks))
    jcaches = _caches(dtype, kv, n)
    tcaches = [cache_from_reference(c, device="cpu") for c in jcaches]
    slots = np.array([0, 1], np.int32)
    pos = np.array(n, np.int32)
    new = np.array([7, 9], np.int32)
    for _ in range(3):
        jl, jcaches = _jdecode(jp, jnp.asarray(new), jnp.asarray(pos),
                               jcaches, jnp.asarray(slots))
        tl, tcaches = ttfm.decode_step(
            tp, torch.tensor(new).long(), torch.tensor(pos), tcaches,
            torch.tensor(slots), TCFG, pages_bound=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        for jc, tc in zip(jcaches, tcaches):
            np.testing.assert_array_equal(tc.lengths.numpy(),
                                          np.asarray(jc.lengths))
            # the new K/V come from float32 projections summed in another
            # order: f32 pages agree to TOL, int8 pages to one unit
            np.testing.assert_allclose(
                to_numpy(tc.k_pages).astype(np.float32),
                np.asarray(jc.k_pages, np.float32),
                atol=1 if dtype == "int8" else TOL)
        new = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1


def test_decode_matches_teacher_forced_forward(params):
    """Port only: prefill into a float32 cache, then greedy decode steps; each
    step's logits match a full forward over the same tokens. 1e-2: the
    paged kernel's contract casts q/K/V to bf16 (measured ≤ 2.8e-3 on logits
    of magnitude ~0.7; the reference's engine test bounds the same
    comparison by token equality)."""
    _, tp = params
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache

    toks = _tokens(3, 1, 17)[0].tolist()
    cfg = CacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                      total_pages=16, max_seqs=2, max_pages_per_seq=4,
                      dtype="float32")
    caches = [PagedKVCache.create(cfg, device="cpu")
              for _ in range(TCFG.num_layers)]
    logits, kv = ttfm.prefill(tp, torch.tensor([toks]), TCFG)
    for c, (k, v) in zip(caches, kv):
        c.page_tables[0] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
        c.write_prompt(0, k[0].transpose(0, 1), v[0].transpose(0, 1))
    toks.append(int(logits[0].argmax()))
    slot = torch.zeros(1, dtype=torch.int32)
    for _ in range(6):
        pos = torch.tensor([len(toks) - 1], dtype=torch.int32)
        logits, caches = ttfm.decode_step(tp, torch.tensor([toks[-1]]), pos,
                                          caches, slot, TCFG)
        ref = ttfm.forward(tp, torch.tensor([toks]), TCFG)[0, -1]
        assert float((logits[0] - ref).abs().max()) < 1e-2
        toks.append(int(ref.argmax()))


def test_sliding_forward_and_prefill_match_reference(params):
    """attention="sliding" (window 9): forward logits and prefill's logits
    and K/V within TOL of the reference's."""
    jp, tp = params
    jcfg = jtfm.ModelConfig(**{**_CFG, "attention": "sliding", "window": 9})
    tcfg = ttfm.ModelConfig(**{**_CFG, "attention": "sliding", "window": 9})
    toks = _tokens(4, 2, 30)
    jl = jax.jit(lambda p, t: jtfm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    tl = ttfm.forward(tp, torch.as_tensor(toks).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    jl, jkv = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(
        jp, jnp.asarray(toks[:1]))
    tl, tkv = ttfm.prefill(tp, torch.as_tensor(toks[:1]).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(tkv[1][0].numpy(), np.asarray(jkv[1][0]),
                               atol=TOL)


def test_unported_model_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        ttfm.init_params(ttfm.ModelConfig(**{**_CFG, "moe_experts": 4}),
                         torch.Generator(device="cpu"), device="cpu")
