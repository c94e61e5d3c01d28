"""Port parity: tensor parallelism (``parallel/shardings.py``, ``tp=`` in
``models/transformer.py``, ``Engine(mesh=)``) against the reference.

Rank r's parameter and cache slices equal, bit for bit, what the
reference's ``NamedSharding`` from ``param_pspecs``/``cache_pspecs``
puts on device r (2 and 4 ranks, raw and int8 weight-only matrices). The
port's engine over 2 virtual ranks of a CPU mesh against the reference's
unsharded engine on the reference's weights and ``tests/test_tp.py``'s
prompts: the float32 model over a float32 cache token for token, the
bf16 model (``tests/test_tp.py``'s) over a float32 or an int8 cache at
≥ 0.9 agreement, int8 weights (``quantize_weights``) at ≥ 0.9
(``tests/test_wquant.py:54-75``); chunked prefill and K-step async rounds
under TP equal the port's own one-token TP run. The TP forward against the
reference's, sharded and unsharded, within 5e-2 (``tests/test_tp.py:97``,
bf16); the float32 model's forward and ``decode_verify`` under TP within
1e-4 of the reference's under ``shard_map`` (``tp_axis="model"``)
relative to max |logit|, and one rank's row-parallel partial left out of
the sum misses that by far.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.models import transformer as jtfm
from tpu_flash.parallel.shardings import (
    cache_pspecs,
    param_pspecs,
    shard_engine_state,
)
from tpu_flash.serving import engine as jeng
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.parallel import shardings
from tpu_flash_torch.parallel.mesh import AxisGroup, make_mesh
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import (
    cache_from_reference,
    params_from_tree,
    to_numpy,
)

torch.set_num_threads(2)

_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128)
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=128,
             max_seqs=8, max_pages_per_seq=16)
TOL_F32 = 1e-4


def _jmesh(n):
    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.array(jax.devices()[:n]), ("model",))


def _convert(jp):
    return params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    """The reference's tests/test_tp.py model (bf16), and the port's copy."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, _convert(jp)


def _tp(n=2):
    return make_mesh(model=n, devices="cpu")


def _prompts():
    return [[int(t) for t in np.random.default_rng(i).integers(1, 255, 8 + 5 * i)]
            for i in range(2)]


def _run(mod, eng, prompts, new=8):
    for rid, p in enumerate(prompts):
        eng.submit(mod.Request(rid=rid, prompt=p, max_new_tokens=new))
    return {f.rid: f for f in eng.run()}


def _agreement(a, b):
    assert len(a) == len(b)
    return sum(x == y for x, y in zip(a, b)) / len(a)


@pytest.mark.parametrize("size", [2, 4])
def test_slices_match_named_shardings(size):
    """param_slices and cache_slice give rank r exactly the arrays the
    reference's shard_engine_state puts on device r: raw and int8 weights
    (column scales split with their columns, row scales replicated), and
    an int8 cache's pages, scales, page tables and lengths."""
    cfg = jtfm.ModelConfig(vocab_size=64, dim=64, num_layers=1,
                           num_q_heads=8, num_kv_heads=4, head_dim=16,
                           mlp_hidden=128, block_q=128, block_kv=128)
    jp = jtfm.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(size)
    ccfg = JCacheConfig(num_kv_heads=4, head_dim=16, page_size=8,
                        total_pages=6, max_seqs=3, max_pages_per_seq=2,
                        dtype="int8")
    base = JPagedKVCache.create(ccfg)
    jc = dataclasses.replace(
        base,
        k_pages=jnp.asarray(rng.integers(-127, 128, base.k_pages.shape),
                            jnp.int8),
        v_pages=jnp.asarray(rng.integers(-127, 128, base.v_pages.shape),
                            jnp.int8),
        k_scales=jnp.asarray(rng.random(base.k_scales.shape), jnp.float32),
        v_scales=jnp.asarray(rng.random(base.v_scales.shape), jnp.float32),
        page_tables=jnp.asarray(rng.integers(0, 6, (3, 2)), jnp.int32),
        lengths=jnp.asarray(rng.integers(0, 16, 3), jnp.int32))
    mesh = _jmesh(size)
    devs = list(mesh.devices.flat)
    port_cache = cache_from_reference(jc, device="cpu")
    for tree in (jp, jtfm.quantize_weights(jp)):
        sharded, (sc,) = shard_engine_state(mesh, tree, [jc], "model")
        names = [jax.tree_util.keystr(k) for k, _ in
                 jax.tree_util.tree_flatten_with_path(sharded)[0]]
        leaves = jax.tree_util.tree_leaves(sharded)
        port = _convert(tree)
        for r, dev in enumerate(devs):
            got = jax.tree_util.tree_leaves(jax.tree.map(
                to_numpy, shardings.param_slices(port, r, size)))
            assert len(got) == len(leaves)
            for name, leaf, g in zip(names, leaves, got):
                want = next(s.data for s in leaf.addressable_shards
                            if s.device == dev)
                np.testing.assert_array_equal(
                    g, np.asarray(want, np.float32 if g.dtype == np.float32
                                  else None), err_msg=f"{name} rank {r}")
            pc = shardings.cache_slice(port_cache, r, size)
            for f in ("k_pages", "v_pages", "k_scales", "v_scales",
                      "page_tables", "lengths"):
                want = next(s.data for s in getattr(sc, f).addressable_shards
                            if s.device == dev)
                np.testing.assert_array_equal(to_numpy(getattr(pc, f)),
                                              np.asarray(want), err_msg=f)
            assert pc.config.num_kv_heads == 4 // size


@pytest.mark.parametrize("model_dtype,cache_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "int8")])
def test_tp_engine_matches_reference(params, model_dtype, cache_dtype):
    """Engine(mesh=) over 2 ranks against the reference's unsharded engine
    on tests/test_tp.py's prompts: the float32 model over a float32 cache
    token for token (logprobs within 1e-3, tests/test_torch_engine.py's
    rule); the bf16 model (tests/test_tp.py's) ≥ 0.9 from either cache.
    The bf16 model's logits sit near ties (logprobs near −ln 256): the
    split row-parallel sums move them by bf16 roundings (up to 4e-3 in
    logprob, in the reference's own TP engine too) and one of the 32
    tokens from the float32 cache falls the other way."""
    jp, tp = params
    mcfg = {**_MCFG, "dtype": model_dtype}
    if model_dtype == "float32":
        jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**mcfg))
        tp = _convert(jp)
    want = _run(jeng, jeng.Engine(jp, jtfm.ModelConfig(**mcfg),
                                  JCacheConfig(**_CCFG, dtype=cache_dtype),
                                  jeng.EngineConfig(max_batch=2)), _prompts())
    got = _run(teng, teng.Engine(tp, ttfm.ModelConfig(**mcfg),
                                 CacheConfig(**_CCFG, dtype=cache_dtype),
                                 teng.EngineConfig(max_batch=2), mesh=_tp()),
               _prompts())
    assert sorted(got) == sorted(want)
    for rid in want:
        if model_dtype == "float32":
            assert got[rid].tokens == [int(t) for t in want[rid].tokens]
            np.testing.assert_allclose(got[rid].logprobs,
                                       np.asarray(want[rid].logprobs),
                                       atol=1e-3)
        else:
            assert _agreement(got[rid].tokens, want[rid].tokens) >= 0.9


def test_tp_chunked_and_rounds_equal_one_token(params):
    """Under TP 2: chunked prefill (chunks of 16) commits the unchunked
    streams, and K-step async rounds (decode_steps 4) the one-token
    engine's (tokens equal, logprobs within 1e-6)."""
    _, tp = params
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(1, 255, n)] for n in (20, 37)]

    def run(**kw):
        eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                          CacheConfig(**_CCFG, dtype="float32"),
                          teng.EngineConfig(max_batch=2, **kw), mesh=_tp())
        return _run(teng, eng, prompts, new=10), eng

    base, _ = run()
    chunked, eng = run(chunk_size=16)
    assert eng.tp.size == 2
    rounds, _ = run(decode_steps=4, async_decode=True)
    for rid in base:
        assert chunked[rid].tokens == base[rid].tokens
        assert rounds[rid].tokens == base[rid].tokens
        np.testing.assert_allclose(rounds[rid].logprobs, base[rid].logprobs,
                                   atol=1e-6)


def test_tp_quantized_weights_match_reference(params):
    """int8 weights under TP 2 against the reference's unsharded engine
    on the same quantized weights (tests/test_wquant.py:54-75): ≥ 0.9."""
    jp, _ = params
    jq = jtfm.quantize_weights(jp)
    prompt = [[int(t) for t in np.random.default_rng(2).integers(1, 255, 9)]]
    want = _run(jeng, jeng.Engine(jq, jtfm.ModelConfig(**_MCFG),
                                  JCacheConfig(**_CCFG, dtype="float32"),
                                  jeng.EngineConfig(max_batch=2)), prompt, 6)
    got = _run(teng, teng.Engine(_convert(jq), ttfm.ModelConfig(**_MCFG),
                                 CacheConfig(**_CCFG, dtype="float32"),
                                 teng.EngineConfig(max_batch=2), mesh=_tp()),
               prompt, 6)
    assert _agreement(got[0].tokens, want[0].tokens) >= 0.9


def test_tp_forward_matches_reference(params):
    """The bf16 TP forward against the reference's TP forward under
    shard_map and its unsharded forward: within 5e-2 (tests/test_tp.py)."""
    jp, tp = params
    mcfg = ttfm.ModelConfig(**_MCFG)
    toks = np.random.default_rng(0).integers(1, 255, (2, 24))
    jtoks = jnp.asarray(toks, jnp.int32)
    jcfg = jtfm.ModelConfig(**_MCFG)
    ref = np.asarray(jax.jit(jtfm.forward, static_argnums=2)(jp, jtoks, jcfg))
    jsharded = np.asarray(jax.jit(jax.shard_map(
        lambda p, t: jtfm.forward(p, t, jcfg, tp_axis="model"), mesh=_jmesh(2),
        in_specs=(param_pspecs(jp, "model"), P()), out_specs=P(),
        check_vma=False))(jp, jtoks))
    axis = _tp().axis("model")
    got = ttfm.forward(shardings.shard_params(tp, axis), torch.as_tensor(toks),
                       mcfg, tp=axis).numpy()
    assert float(np.abs(got - ref).max()) < 5e-2
    assert float(np.abs(got - jsharded).max()) < 5e-2


class _DropLast(AxisGroup):
    """A planted fault: the last rank's partial left out of every sum."""

    def sum(self, parts):
        return super().sum(list(parts)[:-1])


def _f32_model():
    """A float32 copy of the model: the reference's parameters and the
    port's."""
    kw = {**_MCFG, "dtype": "float32"}
    jp = jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(4), jtfm.ModelConfig(**kw))
    return jtfm.ModelConfig(**kw), jp, ttfm.ModelConfig(**kw), _convert(jp)


def _rel(got, want):
    """max |got − want| over max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_tp_float32_forward_and_planted_fault():
    """The float32 model's TP forward (2 ranks) against the reference's TP
    forward under shard_map (tp_axis "model"): within 1e-4 of max |logit|;
    leaving one rank's row-parallel partial out of the sum misses by more
    than 1e-2."""
    jcfg, jp, cfg, p = _f32_model()
    toks = np.random.default_rng(1).integers(1, 255, (2, 20))
    want = jax.jit(jax.shard_map(
        lambda w, t: jtfm.forward(w, t, jcfg, tp_axis="model"),
        mesh=_jmesh(2), in_specs=(param_pspecs(jp, "model"), P()),
        out_specs=P(), check_vma=False))(jp, jnp.asarray(toks, jnp.int32))
    axis = _tp().axis("model")
    got = ttfm.forward(shardings.shard_params(p, axis), torch.as_tensor(toks),
                       cfg, tp=axis)
    assert _rel(got, want) < TOL_F32
    bad = _DropLast(**dataclasses.asdict(axis))
    got = ttfm.forward(shardings.shard_params(p, bad), torch.as_tensor(toks),
                       cfg, tp=bad)
    assert _rel(got, want) > 1e-2


def test_tp_decode_verify_matches_unsharded():
    """decode_verify of 3 tokens on 2 lanes (prompts of 11 and 19 tokens)
    under TP 2 against the reference's decode_verify under shard_map
    (tp_axis "model", each cache's kv heads split by cache_pspecs) and
    against the port's unsharded call, on the same caches (the prompts'
    K/V from the port's prefill): logits within 1e-4 of max |logit|, and
    every rank's cache advanced by 3."""
    jcfg, jp, cfg, p = _f32_model()
    ccfg = JCacheConfig(**_CCFG, dtype="float32")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 255, n).tolist() for n in (11, 19)]
    pt = np.zeros((ccfg.max_seqs, ccfg.max_pages_per_seq), np.int32)
    pt[0, :2], pt[1, :2] = (1, 2), (3, 4)
    jcaches = [JPagedKVCache.create(ccfg).assign_pages(jnp.asarray(pt))
               for _ in range(jcfg.num_layers)]
    for slot, prompt in enumerate(prompts):
        _, kv = ttfm.prefill(p, torch.as_tensor([prompt]), cfg)
        jcaches = [c.write_prompt(slot, jnp.asarray(to_numpy(k[0]).swapaxes(
            0, 1)), jnp.asarray(to_numpy(v[0]).swapaxes(0, 1)))
                   for c, (k, v) in zip(jcaches, kv)]
    toks = rng.integers(1, 255, (2, 3))
    base = np.array([11, 19], np.int32)
    slots = np.array([0, 1], np.int32)
    cs = [cache_pspecs(c, "model") for c in jcaches]
    want = jax.jit(jax.shard_map(
        lambda w, c, t, b, s: jtfm.decode_verify(w, t, b, c, s, jcfg,
                                                 tp_axis="model")[0],
        mesh=_jmesh(2), in_specs=(param_pspecs(jp, "model"), cs, P(), P(),
                                  P()),
        out_specs=P(), check_vma=False))(
            jp, jcaches, jnp.asarray(toks, jnp.int32), jnp.asarray(base),
            jnp.asarray(slots))
    axis = _tp().axis("model")
    whole = [cache_from_reference(c, device="cpu") for c in jcaches]
    rcaches = [[shardings.cache_slice(c, r, 2) for c in whole]
               for r in range(2)]
    args = (torch.as_tensor(toks), torch.as_tensor(base))
    got, _ = ttfm.decode_verify(shardings.shard_params(p, axis), *args,
                                rcaches, torch.as_tensor(slots), cfg, tp=axis)
    assert _rel(got, want) < TOL_F32
    unsharded, _ = ttfm.decode_verify(p, *args, whole,
                                      torch.as_tensor(slots), cfg)
    assert _rel(got, unsharded) < TOL_F32
    assert all(c.lengths[:2].tolist() == [14, 22] for r in rcaches for c in r)
