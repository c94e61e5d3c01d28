"""Port parity: the engine's decode modes — K-step rounds
(``EngineConfig.decode_steps``), async rounds, ``Engine.stream`` — with
``decode_verify`` and ``graft_entry.entry``, against the reference.

The engine tests mirror the reference's own (``tests/test_engine.py:
492-652``): a K-step engine commits the streams of the one-token engine
(tokens equal, logprobs within 1e-6), async rounds those of synchronous
ones, finishes mid-round roll back, and ``stream`` yields each token once
across a preemption; greedy streams at K 4 equal the reference engine's
token for token. ``decode_verify`` is held to the reference's and to K
sequential ``decode_step`` s at the reference's atol/rtol 1e-4
(``tests/test_speculative.py:47-73``) on caches converted from the
reference's. Weights are the reference's ``init_params``, converted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash_torch import graft_entry
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import cache_from_reference, params_from_tree

torch.set_num_threads(2)

# the reference's engine tests: a bf16 model over a float32 cache
_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128)
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=128,
             max_seqs=8, max_pages_per_seq=16, dtype="float32")
# the reference's speculative and preemption tests: a small float32 model
_SMALL = dict(vocab_size=128, dim=64, num_layers=2, num_q_heads=2,
              num_kv_heads=2, head_dim=32, mlp_hidden=128, block_q=128,
              block_kv=128, dtype="float32")
_SMALL_CACHE = dict(num_kv_heads=2, head_dim=32, page_size=16,
                    total_pages=64, max_seqs=4, max_pages_per_seq=8,
                    dtype="float32")
TOL = 1e-4


def _convert(jp):
    return params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    """The engine tests' bf16 model, the reference's weights converted."""
    return _convert(jtfm.init_params(jax.random.PRNGKey(0),
                                     jtfm.ModelConfig(**_MCFG)))


@pytest.fixture(scope="module")
def small():
    """(reference params, port params) of the small float32 model."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_SMALL))
    return jp, _convert(jp)


def _engine(params, **kw):
    return teng.Engine(params, ttfm.ModelConfig(**_MCFG),
                       CacheConfig(**_CCFG), teng.EngineConfig(max_batch=2,
                                                               **kw))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 255, n)] for n in lens]


def test_noise_fold_matches_host_form():
    """The device fold of (request key, position) is ``noise_seed``, and
    the uniforms are splitmix64's stream from it, top 23 bits centred."""
    cases = [(0, 7, 9), (1, 7, 9), (3, 2**31 + 5, 2**20), (2**64 - 1, 0, 0)]
    keys = torch.tensor([teng._i64(teng.request_key(s, r))
                         for s, r, _ in cases])
    pos = torch.tensor([p for *_, p in cases], dtype=torch.int32)
    lane = teng._fold(keys, pos)
    want = [teng.noise_seed(*c) for c in cases]
    assert [int(x) & teng._MASK64 for x in lane] == want
    u = teng._uniforms(lane, 6).numpy()
    for row, k in zip(u, want):
        ref = [((teng._mix64((k + i * teng._GAMMA) & teng._MASK64) >> 41)
                + 0.5) / 2**23 for i in range(6)]
        assert row.tolist() == ref
    assert 0.0 < u.min() and u.max() < 1.0


def test_decode_steps_matches_plain(params):
    """decode_steps=4 gives the one-token engine's streams: tokens equal,
    logprobs within 1e-6, the temperature lane too (its noise is keyed
    by position)."""
    prompts = _prompts(7, (9, 13))

    def run(steps):
        eng = _engine(params, decode_steps=steps)
        for i, p in enumerate(prompts):
            eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=11,
                                    temperature=0.7 if i else 0.0))
        return {r.rid: (r.tokens, r.logprobs) for r in eng.run()}

    plain, multi = run(1), run(4)
    assert sorted(plain) == sorted(multi) == [0, 1]
    for rid in plain:
        assert multi[rid][0] == plain[rid][0]
        np.testing.assert_allclose(multi[rid][1], plain[rid][1], atol=1e-6)


def test_decode_steps_early_finish_rollback(params):
    """A lane finishing mid-round discards the overshoot, and its freed
    slot serves a follow-up request as the one-token engine does."""
    p1, p2 = _prompts(11, (10, 8))

    def run(steps):
        eng = _engine(params, decode_steps=steps)
        eng.submit(teng.Request(rid=0, prompt=p1, max_new_tokens=3))
        eng.submit(teng.Request(rid=1, prompt=p2, max_new_tokens=10))
        done = {r.rid: r for r in eng.run()}
        eng.submit(teng.Request(rid=2, prompt=p1, max_new_tokens=5))
        done.update({r.rid: r for r in eng.run()})
        assert eng._alloc.num_free() == _CCFG["total_pages"] - 1
        return done

    plain, multi = run(1), run(4)
    for rid in plain:
        assert multi[rid].tokens == plain[rid].tokens, rid
        assert multi[rid].reason == plain[rid].reason, rid
        assert len(multi[rid].new_tokens) == len(plain[rid].new_tokens)


def test_decode_steps_stop_sequence(params):
    """A stop hit mid-round truncates exactly as in one-token decoding."""
    (prompt,) = _prompts(13, (9,))

    def run(steps, stop):
        eng = _engine(params, decode_steps=steps)
        eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=12,
                                stop_sequences=stop))
        return eng.run()[0]

    base = run(1, ())
    stop = ((base.new_tokens[2],),)
    plain, multi = run(1, stop), run(8, stop)
    assert multi.tokens == plain.tokens
    assert multi.reason == plain.reason == "stop"


def test_async_decode_matches_sync(params):
    """Async rounds (one in flight, chained on the previous round's device
    outputs) commit the synchronous streams; three requests over two lanes
    break the chain mid-stream."""
    prompts = _prompts(17, (9, 14, 6))

    def run(async_decode):
        eng = _engine(params, decode_steps=4, async_decode=async_decode)
        for i, p in enumerate(prompts):
            eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=7 + 3 * i,
                                    temperature=0.5 if i == 1 else 0.0))
        return {r.rid: r for r in eng.run()}

    sync, asy = run(False), run(True)
    assert set(sync) == set(asy) == {0, 1, 2}
    for rid in sync:
        assert asy[rid].tokens == sync[rid].tokens, rid
        assert asy[rid].reason == sync[rid].reason, rid
        np.testing.assert_allclose(asy[rid].logprobs, sync[rid].logprobs,
                                   atol=1e-6)


@pytest.mark.parametrize("new_tokens,rounds", [(13, [4, 4, 4]),
                                               (11, [4, 4, 2])])
def test_async_chain_issues_no_round_of_discards(params, monkeypatch,
                                                 new_tokens, rounds):
    """An async chain counts the round in flight as made: at its tail it
    issues only the rounds the lanes still need (a shorter K chained where
    fewer tokens are left) and drains the last one instead of chaining a
    round whose tokens would all be discarded; the streams are the
    synchronous rounds'."""
    prompts = _prompts(23, (9, 12))

    def run(async_decode):
        eng = _engine(params, decode_steps=4, async_decode=async_decode)
        issued = []
        issue = eng._issue_round

        def counted(K, *a, **kw):
            issued.append(K)
            return issue(K, *a, **kw)

        monkeypatch.setattr(eng, "_issue_round", counted)
        for i, p in enumerate(prompts):
            eng.submit(teng.Request(rid=i, prompt=p,
                                    max_new_tokens=new_tokens))
        return {r.rid: r for r in eng.run()}, issued

    (sync, sync_rounds), (asy, async_rounds) = run(False), run(True)
    assert sync_rounds == async_rounds == rounds
    for rid in sync:
        assert len(asy[rid].new_tokens) == new_tokens
        assert asy[rid].tokens == sync[rid].tokens, rid
        np.testing.assert_allclose(asy[rid].logprobs, sync[rid].logprobs,
                                   atol=1e-6)


@pytest.mark.parametrize("rows", [
    [[0.0, 0, 1.0], [0.0, 0, 1.0]],
    [[0.7, 0, 1.0], [0.0, 0, 1.0]],
    [[0.7, 50, 0.9], [0.0, 0, 1.0]],
], ids=["greedy", "untruncated", "truncated"])
def test_eager_sampling_shortcuts_keep_bits(rows):
    """The one-token step's shortcuts (the host's copy of the sampling rows:
    an all-greedy batch takes the argmax alone, an untruncated one skips
    the sort) give the bits of the captured round's form, which runs
    every part and chooses on the device."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(len(rows), 300, generator=g) * 3
    samp = torch.tensor(rows, dtype=torch.float32)
    keys = torch.tensor([teng._i64(teng.request_key(0, r))
                         for r in range(len(rows))])
    pos = torch.tensor([17, 40], dtype=torch.int32)
    want = teng._sample_packed(logits, samp, keys, pos)
    got = teng._sample_packed(logits, samp, keys, pos, host_samp=rows)
    assert torch.equal(got, want)
    truncate = any(r[1] > 0 or r[2] < 1.0 for r in rows)
    assert torch.equal(teng._truncated_scores(logits, samp, truncate),
                       teng._truncated_scores(logits, samp))


def test_async_decode_eos_mid_round(params):
    """An eos mid-round with a round in flight: the finished lane's stale
    tokens are discarded, the survivor's kept, and a follow-up request
    decodes cleanly."""
    p1, p2 = _prompts(19, (10, 7))

    def run(async_decode):
        eng = _engine(params, decode_steps=4, async_decode=async_decode)
        eng.submit(teng.Request(rid=0, prompt=p1, max_new_tokens=20))
        eos = eng.run()[0].new_tokens[5]
        eng2 = _engine(params, decode_steps=4, async_decode=async_decode)
        eng2.submit(teng.Request(rid=0, prompt=p1, max_new_tokens=20,
                                 eos_id=eos))
        eng2.submit(teng.Request(rid=1, prompt=p2, max_new_tokens=15))
        done = {r.rid: r for r in eng2.run()}
        eng2.submit(teng.Request(rid=2, prompt=p1, max_new_tokens=5))
        done.update({r.rid: r for r in eng2.run()})
        return done

    sync, asy = run(False), run(True)
    assert sync[0].reason == "eos"
    for rid in sync:
        assert asy[rid].tokens == sync[rid].tokens, rid
        assert asy[rid].reason == sync[rid].reason, rid


def test_greedy_multistep_streams_match_reference(small):
    """Greedy streams at decode_steps 4 with async rounds, three requests
    over two lanes (float32 cache): the port's engine and the reference's
    give the same tokens and finish reasons; logprobs within 1e-3 (the
    engine tests' float32 bound)."""
    jp, tp = small
    dtype = "float32"
    prompts = [[int(t) for t in np.random.default_rng(23).integers(1, 127, n)]
               for n in (9, 22, 5)]
    ref = jeng.Engine(jp, jtfm.ModelConfig(**_SMALL),
                      JCacheConfig(**{**_SMALL_CACHE, "dtype": dtype}),
                      jeng.EngineConfig(max_batch=2, decode_steps=4))
    port = teng.Engine(tp, ttfm.ModelConfig(**_SMALL),
                       CacheConfig(**{**_SMALL_CACHE, "dtype": dtype}),
                       teng.EngineConfig(max_batch=2, decode_steps=4))
    for eng, mod in ((ref, jeng), (port, teng)):
        for rid, p in enumerate(prompts):
            eng.submit(mod.Request(rid=rid, prompt=p, max_new_tokens=9))
    want = {f.rid: f for f in ref.run()}
    got = {f.rid: f for f in port.run()}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid, f in want.items():
        assert got[rid].tokens == f.tokens, rid
        assert got[rid].reason == f.reason == "length"
        np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=1e-3)
    assert port._alloc.num_free() == _SMALL_CACHE["total_pages"] - 1


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_stream_across_preemption(small, decode_steps):
    """stream() across a preemption yields every generated token exactly
    once: the yields equal the uninterrupted greedy generation (with a
    round in flight at the preemption when decode_steps is 4)."""
    _, tp = small
    prompt = [int(t) for t in np.random.default_rng(29).integers(1, 127, 11)]

    def engine():
        eng = teng.Engine(tp, ttfm.ModelConfig(**_SMALL),
                          CacheConfig(**_SMALL_CACHE),
                          teng.EngineConfig(max_batch=1,
                                            decode_steps=decode_steps))
        eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=12))
        return eng

    plain = engine().run()[0].new_tokens
    eng = engine()
    orig_step, count = eng.step, {"n": 0}

    def step():
        # preempt before the step's decode, as pool pressure does
        count["n"] += 1
        if count["n"] == 3 and eng.running:
            eng._preempt(next(iter(eng.running)))
        orig_step()

    eng.step = step
    items = list(eng.stream())
    toks = [it[1] for it in items if not isinstance(it, teng.FinishedRequest)]
    done = [it for it in items if isinstance(it, teng.FinishedRequest)]
    assert eng.metrics()["preemptions"] == 1
    assert toks == plain
    assert len(done) == 1 and done[0].tokens[len(prompt):] == plain


_jverify = jax.jit(jtfm.decode_verify, static_argnames=("cfg",))
_jprefill = jax.jit(jtfm.prefill, static_argnames=("cfg",))


def _cfgs(attention):
    """The small model's (reference, port) configs; the sliding one at
    window 9, so the prompts' bands hide most of their keys."""
    kw = {} if attention == "causal" else dict(attention="sliding", window=9)
    return jtfm.ModelConfig(**_SMALL, **kw), ttfm.ModelConfig(**_SMALL, **kw)


@pytest.fixture(scope="module")
def seeded(small):
    """attention → the reference's caches with two prompts (11 and 19
    tokens) prefilled into slots 0 and 1, as ``tests/test_speculative.py:
    _seeded_caches`` builds them."""
    jp, _ = small
    ccfg = JCacheConfig(**_SMALL_CACHE)
    rng = np.random.default_rng(31)
    prompts = [list(rng.integers(1, 127, 11)), list(rng.integers(1, 127, 19))]
    pt = jnp.zeros((ccfg.max_seqs, ccfg.max_pages_per_seq), jnp.int32)
    page = 1
    for slot, p in enumerate(prompts):
        npages = -(-(len(p) + 8) // ccfg.page_size)
        pt = pt.at[slot, :npages].set(
            jnp.arange(page, page + npages, dtype=jnp.int32))
        page += npages
    # one prefill of both prompts, the shorter padded at its end: its
    # first positions' K/V see no padding (causal)
    toks = np.zeros((2, 19), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    out = {}
    for attention in ("causal", "sliding"):
        cfg = _cfgs(attention)[0]
        caches = [JPagedKVCache.create(ccfg).assign_pages(pt)
                  for _ in range(cfg.num_layers)]
        _, kv = _jprefill(jp, jnp.asarray(toks), cfg=cfg)
        for slot, p in enumerate(prompts):
            for i, (k, v) in enumerate(kv):
                caches[i] = caches[i].write_prompt(
                    slot, jnp.swapaxes(k[slot, :len(p)], 0, 1),
                    jnp.swapaxes(v[slot, :len(p)], 0, 1))
        out[attention] = caches
    return np.asarray([len(p) for p in prompts], np.int32), out


def _port_caches(jcaches):
    return [cache_from_reference(c, device="cpu") for c in jcaches]


@pytest.mark.parametrize("attention", ["causal", "sliding"])
@pytest.mark.parametrize("K", [2, 4])
def test_decode_verify_matches_reference_and_steps(small, seeded, attention,
                                                   K):
    """decode_verify of K tokens a lane against the reference's on the same
    caches, and against K sequential decode_steps of the port: logits
    within atol/rtol 1e-4, argmax equal, every slot advanced by K (the
    sliding model at window 9 sees only its band)."""
    jp, tp = small
    jcfg, tcfg = _cfgs(attention)
    base, jcs = seeded
    jcaches = jcs[attention]
    toks = np.random.default_rng(41 + K).integers(1, 127, (2, K)).astype(
        np.int32)
    slots = np.asarray([0, 1], np.int32)
    want, jcaches_v = _jverify(jp, jnp.asarray(toks), jnp.asarray(base),
                               jcaches, jnp.asarray(slots), cfg=jcfg)
    want = np.asarray(want)
    tslots = torch.as_tensor(slots)
    got, caches_v = ttfm.decode_verify(
        tp, torch.as_tensor(toks).long(), torch.as_tensor(base),
        _port_caches(jcaches), tslots, tcfg)
    got = got.numpy()
    assert got.shape == (2, K, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    caches_s, seq = _port_caches(jcaches), []
    for j in range(K):
        lj, caches_s = ttfm.decode_step(
            tp, torch.as_tensor(toks[:, j]).long(),
            torch.as_tensor(base + j), caches_s, tslots, tcfg)
        seq.append(lj.numpy())
    seq = np.stack(seq, axis=1)
    np.testing.assert_allclose(got, seq, atol=TOL, rtol=TOL)
    assert np.array_equal(got.argmax(-1), seq.argmax(-1))
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    for c_v, c_s, c_j in zip(caches_v, caches_s, jcaches_v):
        assert np.array_equal(c_v.lengths.numpy(), c_s.lengths.numpy())
        assert np.array_equal(c_v.lengths.numpy(), np.asarray(c_j.lengths))
        assert c_v.lengths[:2].tolist() == (base + K).tolist()


def test_decode_verify_fault_one_key_too_many(small, seeded, monkeypatch):
    """The planted fault of the smoke's check: visible lengths one too long
    (token j sees j + 1's key) move the logits of tokens 0..K−2 far past
    1e-4."""
    _, tp = small
    cfg = _cfgs("causal")[1]
    base, jcs = seeded
    toks = torch.as_tensor(np.random.default_rng(37).integers(1, 127, (2, 4)))
    slots = torch.tensor([0, 1], dtype=torch.int32)

    def verify():
        return ttfm.decode_verify(tp, toks.long(), torch.as_tensor(base),
                                  _port_caches(jcs["causal"]), slots, cfg)[0]

    good = verify()
    paged = ttfm.paged_attention

    def one_too_many(*a, lengths_override=None, **kw):
        return paged(*a, lengths_override=lengths_override + 1, **kw)

    monkeypatch.setattr(ttfm, "paged_attention", one_too_many)
    bad = verify()
    assert float((good - bad)[:, :-1].abs().max()) > 1e-2


def test_entry_matches_reference():
    """graft_entry.entry(): the flagship forward on the reference's small
    config; fn on the reference entry's weights, converted, gives the
    reference's logits within the bf16 gate 2e-2."""
    import __graft_entry__ as ge

    jfn, (jparams, jtokens) = ge.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    fn, (params, tokens) = graft_entry.entry(device="cpu")
    assert tokens.shape == (2, 256) and params["embed"].shape == (512, 256)
    assert params["embed"].dtype == torch.bfloat16
    got = fn(_convert(jparams), torch.as_tensor(np.array(jtokens)).long())
    assert got.shape == (2, 256, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)
    assert torch.isfinite(fn(params, tokens)).all()
