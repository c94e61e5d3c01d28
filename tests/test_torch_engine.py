"""Port parity: the serving engine end to end, against the reference engine
on the same float32 model (weights converted from the reference's
``init_params``), prompts and engine configuration.

Greedy streams must be identical token for token; per-token logprobs agree
to 1e-3 (float32 summation order; the decode kernels' bf16 casts are the
same on both sides). Temperature sampling is keyed, on both sides, by
(engine seed, request id, position) — but the port's counter-based hash
does not reproduce the reference's PRNG bits, so temperature streams are
held by invariance instead: a request sampled alone and co-batched gives
the same stream.
"""

import json

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

_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
             dtype="float32")
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=64,
             max_seqs=8, max_pages_per_seq=16)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _requests(mod):
    rng = np.random.default_rng(5)
    # prompt lengths straddle page boundaries; 22 + 10 tokens crosses into
    # a new page during decode (the engine extends the slot)
    return [mod.Request(rid=i, prompt=[int(t) for t in rng.integers(1, 255, n)],
                        max_new_tokens=10)
            for i, n in enumerate([9, 22, 16, 5])]


def _run_reference(jp, dtype):
    eng = jeng.Engine(jp, jtfm.ModelConfig(**_MCFG),
                      JCacheConfig(**_CCFG, dtype=dtype),
                      jeng.EngineConfig(max_batch=3))
    for r in _requests(jeng):
        eng.submit(r)
    return {f.rid: f for f in eng.run()}


def _run_port(tp, dtype, reqs=None, max_batch=3):
    eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                      CacheConfig(**_CCFG, dtype=dtype),
                      teng.EngineConfig(max_batch=max_batch))
    for r in reqs if reqs is not None else _requests(teng):
        eng.submit(r)
    done = {f.rid: f for f in eng.run()}
    assert eng._alloc.num_free() == _CCFG["total_pages"] - 1  # all released
    return done


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4", "fp8"])
def test_greedy_streams_match_reference(params, dtype):
    """Four greedy requests through three lanes (a queue, a page crossing,
    continuous batching): identical tokens and finish reasons; logprobs
    within 1e-3. On int4 and fp8 caches the codes decode exactly on both
    sides, but for e4m3 zeros and subnormals, which the reference's kernel
    decodes approximately (and re-encodes on the page an append writes):
    values under 2⁻⁶ of a row's scale, far inside 1e-3 here."""
    jp, tp = params
    ref = _run_reference(jp, dtype)
    got = _run_port(tp, dtype)
    assert sorted(got) == sorted(ref) == [0, 1, 2, 3]
    for rid, f in ref.items():
        assert got[rid].tokens == f.tokens, rid
        assert got[rid].reason == f.reason == "length"
        np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=1e-3)


def test_truncated_scores_match_reference():
    """Temperature scaling with top-k and nucleus truncation: the same
    logits give the same surviving scores, exactly."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    samp = np.array([[0.7, 50, 0.9], [1.0, 0, 0.5], [0.3, 5, 1.0],
                     [1.3, 0, 1.0], [0.0, 0, 1.0], [2.0, 300, 0.0]],
                    np.float32)
    want = np.asarray(jeng._truncated_scores(jnp.asarray(logits),
                                             jnp.asarray(samp)))
    got = teng._truncated_scores(torch.as_tensor(logits),
                                 torch.as_tensor(samp)).numpy()
    np.testing.assert_array_equal(got, want)
    # a batch with no truncation keeps the scaled logits on both sides
    plain = samp.copy()
    plain[:, 1:] = (0, 1.0)
    np.testing.assert_array_equal(
        teng._truncated_scores(torch.as_tensor(logits),
                               torch.as_tensor(plain)).numpy(),
        np.asarray(jeng._truncated_scores(jnp.asarray(logits),
                                          jnp.asarray(plain))))


def test_temperature_streams_are_batching_invariant(params):
    """A temperature request gives the same tokens alone and beside two
    greedy neighbours (noise keyed by seed, rid and position only)."""
    _, tp = params

    def hot():
        return teng.Request(rid=7, prompt=[3, 1, 4, 1, 5, 9, 2, 6],
                            max_new_tokens=8, temperature=0.8, top_k=40,
                            top_p=0.95)

    solo = _run_port(tp, "int8", [hot()])[7].tokens
    rng = np.random.default_rng(9)
    mixed = [teng.Request(rid=i, prompt=[int(t) for t in rng.integers(1, 255, 12)],
                          max_new_tokens=6) for i in (1, 2)]
    batched = _run_port(tp, "int8", mixed + [hot()])[7].tokens
    assert batched == solo
    # and the noise does matter: another seed gives another stream
    assert teng.noise_seed(0, 7, 9) != teng.noise_seed(1, 7, 9)


def test_unported_engine_options_raise(params):
    """LoRA, still to port, raises and names its ROADMAP item (A9b); the
    prefix cache, speculation with a draft model, decode_steps and
    async_decode are ported and build, and so is mesh=: tensor
    parallelism, whose LoRA composition raises as in the reference."""
    from tpu_flash_torch.parallel.mesh import make_mesh

    _, tp = params
    mcfg, ccfg = ttfm.ModelConfig(**_MCFG), CacheConfig(**_CCFG)
    eng = teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(
        max_batch=3, prefix_cache=True))
    assert eng.metrics()["prefix_cache"]["entries"] == 0
    # speculate_k without a draft decodes plain, as in the reference
    assert teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(
        max_batch=3, speculate_k=2))._draft is None
    eng = teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(
        max_batch=3, speculate_k=2), draft=(tp, mcfg))
    assert eng.spec_stats() == dict(proposed=0, accepted=0)
    # multi-LoRA is ported (it raised before): the engine takes a bank
    from tpu_flash_torch.models.lora import init_lora_bank

    bank = init_lora_bank(mcfg, 2, 4, torch.Generator().manual_seed(0), "cpu")
    assert teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(max_batch=3),
                       lora=bank).lora is bank
    mesh = make_mesh(model=2, devices="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        teng.Engine(tp, mcfg, ccfg, mesh=mesh, lora=bank)
    teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(
        max_batch=3, decode_steps=4, async_decode=False))
    assert teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(max_batch=3),
                       mesh=mesh).tp.size == 2


def test_pool_pressure_preempts_and_every_request_completes(params, tmp_path):
    """A pool too small for two growing sequences: decode-time page extends
    fail, a sequence is preempted back to the queue, re-prefilled with its
    generated context, and still completes with its full token count; the
    per-step metrics stream records the preemption and every page comes
    back."""
    _, tp = params
    path = tmp_path / "metrics.jsonl"
    eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                      CacheConfig(**{**_CCFG, "total_pages": 11}),
                      teng.EngineConfig(max_batch=2, metrics_path=str(path)))
    rng = np.random.default_rng(11)
    for rid in range(2):  # 40-token prompts grow past 5 pages of 16
        eng.submit(teng.Request(rid=rid, prompt=[int(t) for t in
                                                 rng.integers(1, 255, 40)],
                                max_new_tokens=50))
    done = {f.rid: f for f in eng.run(max_steps=500)}
    eng.close()
    assert sorted(done) == [0, 1]
    for f in done.values():
        assert f.reason == "length" and len(f.tokens) == 90
    m = eng.metrics()
    assert m["preemptions"] >= 1 and m["finished"] == 2
    assert m["free_pages"] == 10
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(rows) == m["steps"] and rows[-1]["preemptions"] == m["preemptions"]
