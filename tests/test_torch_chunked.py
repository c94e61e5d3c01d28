"""Port parity for the sliding-window serving path: ``prefill_chunk``, the
sliding and pipelined ``decode_step``, and the engine's chunked prefill,
pipelined decode and norm-bound prefill.

A float32 model with the reference's weights converted from its
``init_params`` keeps the model comparisons about the algorithm (logits to
1e-3, float32 summation order; the paged kernels cast q/K/V to bf16 by
contract on both sides). The engine tests mirror the reference's own
(``tests/test_engine.py:124-239, 655``): chunked == unchunked and pipelined
== default token for token with a float32 cache, and the norm-bound prefill
within the reference's tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import cache_from_reference, params_from_tree

torch.set_num_threads(2)

_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
             dtype="float32")
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=64,
             max_seqs=8, max_pages_per_seq=16)
TOL = 1e-3
_jchunk = jax.jit(jtfm.prefill_chunk, static_argnames=("cfg", "pages_bound"))
_jdecode = jax.jit(jtfm.decode_step,
                   static_argnames=("cfg", "pages_bound", "pipelined"))


def _cfgs(attention):
    kw = dict(_MCFG, attention=attention, window=33)
    return jtfm.ModelConfig(**kw), ttfm.ModelConfig(**kw)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 255, n)]


def _fresh_caches(dtype="float32"):
    cfg = JCacheConfig(**_CCFG, dtype=dtype)
    table = jnp.zeros((8, 16), jnp.int32).at[1].set(jnp.arange(1, 17))
    j = [JPagedKVCache.create(cfg).assign_pages(table) for _ in range(2)]
    return j, [cache_from_reference(c, device="cpu") for c in j]


@pytest.mark.parametrize("attention,dtype", [
    ("causal", "float32"), ("sliding", "float32"), ("causal", "int4"),
    ("sliding", "fp8")], ids=["causal", "sliding", "causal-int4",
                              "sliding-fp8"])
def test_prefill_chunk_matches_reference(params, attention, dtype):
    """A 70-token prompt in chunks of 32 (offsets 0, 32, 64; the last one
    padded) on slot 1: each chunk's logits over its real rows and the
    greedy token agree, and so do the caches after each chunk (f32 pages
    to TOL, lengths exactly). Under the sliding window (33, radius 16) the
    prefix band starts at each token's own position − 16. On int4 and fp8
    pages (the prefix read through B2's plain version), the same bounds:
    the caches' dequantized K/V to TOL (the reference's jitted scales may
    sit an ulp off its eager ones, and its kernel decodes e4m3 subnormals
    approximately; both move values by far less than TOL)."""
    jp, tp = params
    jcfg, tcfg = _cfgs(attention)
    prompt = _prompt(1, 70)
    jcaches, tcaches = _fresh_caches(dtype)
    for off in (0, 32, 64):
        chunk = prompt[off:off + 32]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(chunk)] = chunk
        pb = max(1, -(-off // 16))
        jl, jg, jcaches = _jchunk(jp, jnp.asarray(toks), off, len(chunk),
                                  jcaches, 1, cfg=jcfg, pages_bound=pb)
        tl, tg, tcaches = ttfm.prefill_chunk(
            tp, torch.as_tensor(toks).long(), off, len(chunk), tcaches, 1,
            tcfg, pages_bound=pb)
        n = len(chunk)
        np.testing.assert_allclose(tl[0, :n].numpy(), np.asarray(jl)[0, :n],
                                   atol=TOL)
        assert int(tg) == int(jg)
        for jc, tc in zip(jcaches, tcaches):
            np.testing.assert_array_equal(tc.lengths.numpy(),
                                          np.asarray(jc.lengths))
            if dtype == "float32":
                np.testing.assert_allclose(tc.k_pages.numpy(),
                                           np.asarray(jc.k_pages), atol=TOL)
                continue
            for t, j in zip(tc.gather_kv(1, off + n),
                            jc.gather_kv(1, off + n)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)


@pytest.mark.parametrize("pipelined", [False, True])
def test_sliding_decode_step_matches_reference(params, pipelined):
    """Three sliding-window decode steps (radius 16) on a 40-token prompt
    and a 9-token one, from identical int8 caches, through the default and
    the pipelined decode: the same lengths, logits within TOL (5e-3 against
    the reference's pipelined kernel, which rounds P to bf16 against a
    four-page chunk's running max where B2 takes a page's)."""
    jp, tp = params
    jcfg, tcfg = _cfgs("sliding")
    toks = np.asarray([_prompt(2, 40), _prompt(3, 9) + [0] * 31], np.int32)
    _, kv = jtfm.prefill(jp, jnp.asarray(toks), jcfg)
    cfg = JCacheConfig(**_CCFG, dtype="int8")
    table = jnp.zeros((8, 16), jnp.int32).at[0].set(jnp.arange(1, 17))
    table = table.at[1].set(jnp.arange(17, 33))
    jcaches = []
    for k, v in kv:
        c = JPagedKVCache.create(cfg).assign_pages(table)
        for s, n in enumerate((40, 9)):
            c = c.write_prompt(s, jnp.swapaxes(k[s, :n], 0, 1),
                               jnp.swapaxes(v[s, :n], 0, 1))
        jcaches.append(c)
    tcaches = [cache_from_reference(c, device="cpu") for c in jcaches]
    slots, pos, new = (np.array([0, 1], np.int32), np.array([40, 9], np.int32),
                       np.array([7, 9], np.int32))
    for _ in range(3):
        jl, jcaches = _jdecode(
            jp, jnp.asarray(new), jnp.asarray(pos), jcaches,
            jnp.asarray(slots), cfg=jcfg, pages_bound=4, pipelined=pipelined)
        tl, tcaches = ttfm.decode_step(
            tp, torch.tensor(new).long(), torch.tensor(pos), tcaches,
            torch.tensor(slots), tcfg, pages_bound=4, pipelined=pipelined)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=5e-3 if pipelined else TOL)
        for jc, tc in zip(jcaches, tcaches):
            np.testing.assert_array_equal(tc.lengths.numpy(),
                                          np.asarray(jc.lengths))
        new = np.asarray(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1


def test_sliding_decode_matches_sliding_forward(params):
    """Port only (the reference's test_engine.py:124): prefill a sliding
    model (window 9) into a float32 cache, then greedy decode steps; each
    step's logits match a full sliding forward over the same tokens within
    1e-2 (the paged kernel's bf16 casts), and a full-history forward is
    further away than that, so the check sees the band."""
    _, tp = params
    _, tcfg = _cfgs("sliding")
    tcfg = dataclasses.replace(tcfg, window=9)
    from tpu_flash_torch.cache.paged_cache import PagedKVCache

    toks = _prompt(4, 12)
    cfg = CacheConfig(**{**_CCFG, "dtype": "float32"})
    caches = [PagedKVCache.create(cfg, device="cpu") for _ in range(2)]
    logits, kv = ttfm.prefill(tp, torch.tensor([toks]), tcfg)
    for c, (k, v) in zip(caches, kv):
        c.page_tables[0, :4] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
        c.write_prompt(0, k[0].transpose(0, 1), v[0].transpose(0, 1))
    toks.append(int(logits[0].argmax()))
    slot = torch.zeros(1, dtype=torch.int32)
    full = dataclasses.replace(tcfg, attention="causal")
    for _ in range(8):
        pos = torch.tensor([len(toks) - 1], dtype=torch.int32)
        logits, caches = ttfm.decode_step(tp, torch.tensor([toks[-1]]), pos,
                                          caches, slot, tcfg)
        ref = ttfm.forward(tp, torch.tensor([toks]), tcfg)[0, -1]
        assert float((logits[0] - ref).abs().max()) < 1e-2
        toks.append(int(ref.argmax()))
    other = ttfm.forward(tp, torch.tensor([toks[:-1]]), full)[0, -1]
    assert float((logits[0] - other).abs().max()) > 1e-2


def _engine_run(tp, mcfg, prompts, dtype="float32", max_tokens=6, **ecfg):
    eng = teng.Engine(tp, mcfg, CacheConfig(**_CCFG, dtype=dtype),
                      teng.EngineConfig(max_batch=2, **ecfg))
    for rid, p in enumerate(prompts):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=max_tokens))
    done = {f.rid: f for f in eng.run()}
    assert eng._alloc.num_free() == _CCFG["total_pages"] - 1
    assert not eng.prefilling and not eng.running
    return done


@pytest.mark.parametrize("attention", ["causal", "sliding"])
def test_chunked_prefill_matches_unchunked(params, attention):
    """A 75-token prompt streamed in chunks of 32 beside a short request
    (interleaved with its decode): the same tokens as the whole-prompt
    prefill (float32 cache, greedy), and as the reference engine's chunked
    run."""
    jp, tp = params
    jcfg, tcfg = _cfgs(attention)
    prompts = [_prompt(11, 75), [5, 6, 7]]
    whole = _engine_run(tp, tcfg, prompts)
    chunked = _engine_run(tp, tcfg, prompts, chunk_size=32)
    assert sorted(chunked) == [0, 1]
    for rid in (0, 1):
        assert chunked[rid].tokens == whole[rid].tokens
    if attention == "sliding":
        eng = jeng.Engine(jp, jcfg, JCacheConfig(**_CCFG, dtype="float32"),
                          jeng.EngineConfig(max_batch=2, chunk_size=32))
        for rid, p in enumerate(prompts):
            eng.submit(jeng.Request(rid=rid, prompt=p, max_new_tokens=6))
        for f in eng.run():
            assert chunked[f.rid].tokens == [int(t) for t in f.tokens]


def test_chunked_prefill_at_page_capacity(params):
    """The final chunk's padded tail runs past the slot's table (121
    tokens, chunks of 48, capacity 8 pages of 16): its writes go to the
    trash page, never back onto real pages (the reference's
    test_engine.py:188)."""
    _, tp = params
    mcfg = ttfm.ModelConfig(**_MCFG)
    prompt = _prompt(13, 121)

    def run(chunk_size):
        eng = teng.Engine(tp, mcfg, CacheConfig(**{**_CCFG, "dtype": "float32",
                                                   "max_pages_per_seq": 8}),
                          teng.EngineConfig(max_batch=2, chunk_size=chunk_size))
        eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=4))
        return [f.tokens for f in eng.run()]

    assert run(48) == run(None)


def test_chunked_prefill_on_recycled_slot():
    """A recycled slot's stale length must not leak into the first chunk's
    prefix attention (the reference's test_engine.py:242): a probe after
    three fillers on one lane gives the tokens it gives alone."""
    cfg = ttfm.ModelConfig(vocab_size=128, dim=64, num_layers=2,
                           num_q_heads=2, num_kv_heads=2, head_dim=32,
                           mlp_hidden=128, block_q=128, block_kv=128,
                           dtype="float32")
    tp = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ccfg = CacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                       total_pages=64, max_seqs=4, max_pages_per_seq=8,
                       dtype="float32")
    rng = np.random.default_rng(0)
    filler = [[int(t) for t in rng.integers(1, 127, 40)] for _ in range(3)]
    probe = [int(t) for t in rng.integers(1, 127, 33)]

    def run(prompts):
        eng = teng.Engine(tp, cfg, ccfg,
                          teng.EngineConfig(max_batch=1, chunk_size=16))
        out = {}
        for rid, p in enumerate(prompts):
            eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=4))
            for f in eng.run():
                out[f.rid] = f.new_tokens
            eng.finished.clear()
        return out

    assert run(filler + [probe])[3] == run([probe])[0]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4", "fp8"])
@pytest.mark.parametrize("attention", ["causal", "sliding"])
def test_pipelined_decode_matches_default(params, dtype, attention):
    """pipelined_decode (each lane walks its own pages) gives the default
    decode's tokens (the reference's test_engine.py:227), chunked prefill
    included. On int4 pages the default decode runs after the same chunked
    prefill: int4's grid turns the chunked prefill's float32 rounding
    differences in K/V into other codes, which moves this stream apart
    from an unchunked prefill's whatever the decode."""
    _, tp = params
    _, tcfg = _cfgs(attention)
    prompts = [_prompt(3, 12), _prompt(5, 50)]
    base = _engine_run(tp, tcfg, prompts, dtype, max_tokens=8,
                       **(dict(chunk_size=32) if dtype == "int4" else {}))
    pipe = _engine_run(tp, tcfg, prompts, dtype, max_tokens=8,
                       chunk_size=32, pipelined_decode=True)
    for rid in (0, 1):
        assert pipe[rid].tokens == base[rid].tokens


def test_prefill_bound_max_tolerance(params):
    """prefill_bound_max is a tolerance contract (the reference's
    test_engine.py:655): greedy tokens equal the exact-max engine's and
    logprobs sit within 5e-3, chunked prefill included."""
    _, tp = params
    mcfg = ttfm.ModelConfig(**_MCFG)
    prompts = [_prompt(23, 75)]
    base = _engine_run(tp, mcfg, prompts)[0]
    for chunk in (None, 32):
        fast = _engine_run(tp, mcfg, prompts, chunk_size=chunk,
                           prefill_bound_max=True)[0]
        assert fast.tokens == base.tokens
        np.testing.assert_allclose(fast.logprobs, base.logprobs, atol=5e-3)


def test_engine_config_checks(params):
    """chunk_size must be a page multiple; the engine still refuses
    attn_bound_max=True (its chunked == unchunked contract)."""
    _, tp = params
    mcfg = ttfm.ModelConfig(**_MCFG)
    with pytest.raises(ValueError, match="multiple of page_size"):
        teng.Engine(tp, mcfg, CacheConfig(**_CCFG),
                    teng.EngineConfig(max_batch=2, chunk_size=24))
    with pytest.raises(ValueError, match="attn_bound_max"):
        teng.Engine(tp, dataclasses.replace(mcfg, attn_bound_max=True),
                    CacheConfig(**_CCFG), teng.EngineConfig(max_batch=2))
