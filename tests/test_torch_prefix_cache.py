"""Port parity: the prefix cache — the page pool's reference counts and
prefix-chain index (``cache/allocator.py``, the port's own native pool and
its Python twin), ``serving/prefix_cache.py`` and the engine's hooks —
against the reference (``tests/test_prefix_cache.py``'s model and
prompts, weights converted).

Each operation sequence gives the same results, free counts and tables
from the port's native pool, its Python twin and the reference's
allocator and index. A cache-hit serve equals a cold serve and the
reference's, token for token, on a float32 cache: a repeated prompt, a
shared prefix, with chunked prefill, under eviction, through the herd gate
and composed with speculation; on an int8 cache a hit (which reads the
stored pages) equals the reference's hit. A serve never writes a shared
page.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tpu_flash.cache.allocator import PageAllocator as JPageAllocator
from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash.serving.prefix_cache import PrefixCache as JPrefixCache
from tpu_flash_torch.cache import allocator as talloc
from tpu_flash_torch.cache.allocator import PageAllocator
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.serving.prefix_cache import PrefixCache
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

_MCFG = dict(vocab_size=128, dim=64, num_layers=2, num_q_heads=2,
             num_kv_heads=2, head_dim=32, mlp_hidden=128, block_q=128,
             block_kv=128, dtype="float32")
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=64,
             max_seqs=4, max_pages_per_seq=8, dtype="float32")
_NEW = 6


# ---- the page pool and the index ---------------------------------------


def test_native_pool_is_the_ports_own():
    """The port builds its copy of the pool into its build directory,
    never into the reference's csrc/."""
    a = PageAllocator(8, 2, 4)
    assert a.native
    path = talloc.library_path()
    assert "tpu_flash_torch" in path and path.endswith("libpagepool.so")
    with open(talloc._SRC, "rb") as f, open(
            talloc._SRC.replace("tpu_flash_torch/csrc", "csrc"), "rb") as g:
        assert f.read() == g.read()  # a copy, unchanged


def _sides(total, seqs, per_seq, reserve=0):
    """The three allocators under test: the port's native pool, its
    Python twin, the reference's (native) allocator."""
    args = dict(total_pages=total, max_seqs=seqs, max_pages_per_seq=per_seq,
                decode_reserve=reserve)
    return [PageAllocator(**args), PageAllocator(**args, force_python=True),
            JPageAllocator(**args)]


def _same_state(allocs, seqs):
    ref = allocs[-1]
    for a in allocs[:-1]:
        assert a.num_free() == ref.num_free()
        for s in range(seqs):
            assert a.num_pages(s) == ref.num_pages(s)
            np.testing.assert_array_equal(a.table(s), ref.table(s))
        for p in range(ref.total_pages):
            assert a.refcount(p) == ref.refcount(p)


SCRIPTS = {
    # slot 1 shares slot 0's first two pages; frees keep shared pages alive
    "admit_shared": [("admit", 0, 3), ("admit_shared", 1, "t0:2", 1),
                     ("free_seq", 0), ("extend", 1), ("free_seq", 1)],
    # a cache hold survives its sequence; a free page is neither retained
    # nor released
    # (every side grants pages 0, 1, … first)
    "retain_release": [("admit", 0, 2), ("retain", 0), ("free_seq", 0),
                       ("refcount", 0), ("release", 0), ("retain", 0),
                       ("release", 0), ("refcount", 1)],
    # a shared grant of a page that is not live fails, all or nothing
    "shared_dead": [("admit_shared", 0, [3], 1), ("admit", 0, 1),
                    ("admit_shared", 1, "t0:1", 20), ("admit_shared", 1,
                                                      "t0:1", 2)],
    # restore: exact tables, a second slot shares, duplicates rejected,
    # an active slot refuses
    "restore": [("admit", 0, 3), ("restore", 1, "t0:3"), ("free_seq", 0),
                ("restore", 0, "t1:3"), ("restore", 0, "t1:3"),
                ("restore", 2, [5, 5]), ("free_seq", 1), ("free_seq", 0),
                ("restore", 3, [7, 2, 30])],
}


def _arg(a, x):
    """Script arguments: "t<slot>:<n>" is the slot's first n page ids."""
    if isinstance(x, str):
        s, n = x[1:].split(":")
        return [int(p) for p in a.table(int(s))[:int(n)]]
    return x


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_refcount_scripts_match_reference(name):
    """Each step gives the same result and leaves the same free count,
    tables and reference counts on all three allocators."""
    allocs = _sides(32, 4, 8, reserve=1)
    for op, *args in SCRIPTS[name]:
        got = [getattr(a, op)(*[_arg(a, x) for x in args]) for a in allocs]
        assert got[0] == got[1] == got[2], (op, args, got)
        _same_state(allocs, 4)


def _index_sides(total=32, page=16):
    out = []
    for a in _sides(total, 4, 16):
        pc = (JPrefixCache(a) if isinstance(a, JPageAllocator)
              else PrefixCache(a))
        out.append((a, pc))
    return out


def _stats(pc):
    st = pc.stats()
    return {k: st[k] for k in ("hits", "misses", "hit_tokens", "entries")}


def test_match_insert_chain_matches_reference():
    """Full pages only, chains break at a differing page, a page-aligned
    prompt leaves its last page to prefill; the same page ids, entries,
    reference counts and statistics on every side."""
    sides = _index_sides()
    prompt = list(range(40))
    for a, pc in sides:
        assert a.admit(0, 3)
        pc.insert(prompt, a.table(0)[:3], page_size=16)
        assert len(pc) == 2
    queries = [prompt, prompt[:16] + [99] * 24, [7] * 40, prompt[:32],
               prompt + [1] * 30]
    for q in queries:
        got = [[int(p) for p in pc.match(q, 16)] for _, pc in sides]
        assert got[0] == got[1] == got[2], (q, got)
    assert _stats(sides[0][1]) == _stats(sides[1][1]) == _stats(sides[2][1])
    _same_state([a for a, _ in sides], 4)


def test_anchor_scopes_namespaces():
    """Chains anchored at another adapter's root do not match."""
    for a, pc in _index_sides():
        assert a.admit(0, 3)
        pc.insert(list(range(40)), a.table(0)[:3], 16, anchor=-2 - 3)
        assert pc.match(list(range(40)), 16) == []
        assert len(pc.match(list(range(40)), 16, anchor=-5)) == 2


def test_evict_releases_refs_like_reference():
    """LRU eviction frees the pages only the cache held; a later match
    misses; the counts agree with the reference."""
    sides = _index_sides()
    prompt = list(range(32))
    freed = []
    for a, pc in sides:
        assert a.admit(0, 2)
        pc.insert(prompt, a.table(0)[:2], 16)
        a.free_seq(0)
        freed.append(pc.evict(2))
        assert pc.match(prompt, 16) == []
    assert freed == [2, 2, 2]
    _same_state([a for a, _ in sides], 4)


def test_evicted_parent_never_resolves_stale_children():
    """Chains link by a monotonic entry id: after a root's eviction and its
    page's reuse under other content, the orphaned child is unreachable."""
    a_, b_, c_ = list(range(16)), list(range(16, 32)), [99] * 16
    for a, pc in _index_sides(total=8):
        assert a.admit(0, 2)
        pc.insert(a_ + b_, [int(p) for p in a.table(0)[:2]], 16)
        a.free_seq(0)
        pc.evict(1)
        assert a.admit(1, 1)
        pc.insert(c_ + [1], [int(p) for p in a.table(1)[:1]], 16)
        assert len(pc.match(c_ + b_ + [0], 16)) <= 1


def test_index_capacity_evicts_lru():
    """Past max_entries the oldest entries go, on every side alike."""
    sides = []
    for a in _sides(32, 4, 16):
        pc = (JPrefixCache(a, max_entries=3) if isinstance(a, JPageAllocator)
              else PrefixCache(a, max_entries=3))
        sides.append((a, pc))
    for a, pc in sides:
        assert a.admit(0, 5)
        pc.insert(list(range(80)), a.table(0)[:5], 16)
        assert len(pc) == 3
    _same_state([a for a, _ in sides], 4)


def test_top_p_zero_is_safe():
    """top_p = 0 keeps the single most likely token (for any noise)."""
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
    samp = torch.tensor([[0.9, 0.0, 0.0]])
    for i in range(16):
        out = teng._device_sample(logits, samp, torch.tensor([i * 31 + 1]),
                                  torch.tensor([i]))
        assert int(out[0]) == 1


# ---- the engine ---------------------------------------------------------


def _convert(jp):
    return params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, _convert(jp)


def _serve(mod, p, prompts, prefix_cache, max_batch=2, ccfg=None, draft=None,
           new=_NEW, **kw):
    j = mod is jeng
    mcls = jtfm.ModelConfig if j else ttfm.ModelConfig
    ccls = JCacheConfig if j else CacheConfig
    eng = mod.Engine(p, mcls(**_MCFG), ccls(**(ccfg or _CCFG)),
                     mod.EngineConfig(max_batch=max_batch,
                                      prefix_cache=prefix_cache, **kw),
                     draft=None if draft is None else (draft, mcls(**_MCFG)))
    for rid, pr in enumerate(prompts):
        eng.submit(mod.Request(rid=rid, prompt=pr, max_new_tokens=new))
    return {f.rid: f for f in eng.run()}, eng


def _toks(done):
    return {rid: f.new_tokens for rid, f in done.items()}


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(1, 127, 48)]  # three full pages
    return dict(
        repeat=[int(t) for t in rng.integers(1, 127, 40)],
        a=base[:32] + [int(t) for t in rng.integers(1, 127, 9)],
        b=base[:32] + [int(t) for t in rng.integers(1, 127, 13)],
        chunk=[int(t) for t in rng.integers(1, 127, 50)],
        herd=[base + [int(t) for t in rng.integers(1, 127, 7)]
              for _ in range(3)])


@pytest.fixture(scope="module")
def cold(params):
    """The reference's cold streams of every prompt (greedy streams do not
    depend on their neighbours, nor, on a float32 cache, on chunking)."""
    jp = params[0]
    pr = _prompts()
    names = ("repeat", "b", "chunk")
    one = _toks(_serve(jeng, jp, [pr[n] for n in names], False,
                       max_batch=3)[0])
    out = {n: one[i] for i, n in enumerate(names)}
    out["herd"] = _toks(_serve(jeng, jp, pr["herd"], False, max_batch=3,
                               chunk_size=16)[0])
    return out


def test_repeated_prompt_hits_and_matches_cold(params, cold):
    """The second serve of a prompt hits its two full pages and gives the
    cold tokens; the shared pages' bytes are untouched by the hit."""
    prompt = _prompts()["repeat"]
    tp = params[1]
    eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG), CacheConfig(**_CCFG),
                      teng.EngineConfig(max_batch=2, prefix_cache=True))
    eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=_NEW))
    first = eng.run()[0]
    pages = [int(p) + 1 for p in eng._alloc.pc_match(prompt, 16)]
    before = [(c.k_pages[:, pages].clone(), c.v_pages[:, pages].clone())
              for c in eng.caches]
    eng.submit(teng.Request(rid=1, prompt=prompt, max_new_tokens=_NEW))
    second = eng.run()[1]
    assert first.new_tokens == second.new_tokens == cold["repeat"]
    for c, (k, v) in zip(eng.caches, before):
        assert torch.equal(c.k_pages[:, pages], k)
        assert torch.equal(c.v_pages[:, pages], v)
    st = eng.metrics()["prefix_cache"]
    assert st["hits"] >= 2 and st["hit_tokens"] >= 64


def test_shared_prefix_matches_cold(params, cold):
    pr = _prompts()
    warm, eng = _serve(teng, params[1], [pr["a"], pr["b"]], True)
    assert warm[1].new_tokens == cold["b"]
    assert eng._pcache.stats()["hits"] >= 1


def test_chunked_prefill_hit_matches_cold(params, cold):
    """max_batch 1 serializes the requests (pages are indexed when a
    prefill completes); the hit's tail runs in chunks of 16."""
    prompt = _prompts()["chunk"]
    warm, eng = _serve(teng, params[1], [prompt, prompt], True, max_batch=1,
                       chunk_size=16)
    assert warm[0].new_tokens == warm[1].new_tokens == cold["chunk"]
    assert eng._pcache.stats()["hits"] >= 1


def test_eviction_under_pool_pressure(params):
    """A full cache never deadlocks admission: cached pages no table holds
    are evicted, oldest first, when a prompt needs the pool; the streams
    are the reference's. Nine usable pages: the fourth request (four pages
    and one in reserve) finds three free beside six cached."""
    ccfg = dict(_CCFG, total_pages=10)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 127, 40)] for _ in range(4)]
    want = _toks(_serve(jeng, params[0], prompts, True, max_batch=1,
                        ccfg=ccfg, new=4)[0])
    got, eng = _serve(teng, params[1], prompts, True, max_batch=1, ccfg=ccfg,
                      new=4)
    assert _toks(got) == want
    assert all(len(f.new_tokens) == 4 for f in got.values())
    assert eng._pcache.stats()["entries"] < 8  # some were evicted


def test_same_step_herd_gets_full_chain_hits(params, cold):
    """Three same-prefix requests submitted together: the followers wait a
    step for the leader's chunked prefill to publish, then hit its whole
    48-token chain; every stream is the cold one."""
    warm, eng = _serve(teng, params[1], _prompts()["herd"], True,
                       max_batch=3, chunk_size=16)
    assert _toks(warm) == cold["herd"]
    assert eng._pcache.stats()["hit_tokens"] >= 2 * 48


def test_composes_with_speculation(params, cold):
    """Both on: the second request's speculative serve from cached pages
    gives the cold plain tokens (the draft's whole-prompt prefill rewrites
    the shared draft pages with the values they hold)."""
    prompt = _prompts()["repeat"]
    tp = params[1]
    warm, eng = _serve(teng, tp, [prompt, prompt], True, speculate_k=3,
                       draft=tp)
    assert warm[0].new_tokens == warm[1].new_tokens == cold["repeat"]
    assert eng.spec_stats()["proposed"] > 0
    assert eng.spec_stats()["accepted"] == eng.spec_stats()["proposed"]


def test_int8_cache_hit_matches_reference_hit(params):
    """On an int8 cache a hit's tail attends the stored (quantized) prefix
    pages: the port's hit serve equals the reference's hit serve."""
    prompt = _prompts()["repeat"]
    ccfg = dict(_CCFG, dtype="int8")
    want, jeng_ = _serve(jeng, params[0], [prompt, prompt], True, max_batch=1,
                         ccfg=ccfg)
    got, eng = _serve(teng, params[1], [prompt, prompt], True, max_batch=1,
                      ccfg=ccfg)
    assert _toks(got) == _toks(want)
    for rid in want:
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs,
                                   atol=1e-3)
    assert eng._pcache.stats()["hits"] == jeng_._pcache.stats()["hits"] == 1


def test_hit_admitted_while_a_round_is_in_flight(params, cold):
    """Async K-step rounds: a hit admitted while a round is in flight
    flushes the chain first; the streams stand."""
    pr = _prompts()
    prompts = [pr["repeat"], pr["b"], pr["repeat"]]
    warm, eng = _serve(teng, params[1], prompts, True, max_batch=1,
                       decode_steps=4, async_decode=True)
    assert warm[0].new_tokens == warm[2].new_tokens == cold["repeat"]
    assert warm[1].new_tokens == cold["b"]
    assert eng._pcache.stats()["hits"] >= 1


def test_metrics_stream_reports_the_cache(params, tmp_path):
    path = tmp_path / "m.jsonl"
    prompt = _prompts()["repeat"]
    _, eng = _serve(teng, params[1], [prompt, prompt], True, max_batch=1,
                    metrics_path=str(path))
    eng.close()
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert rows[-1]["prefix_cache"] == eng.metrics()["prefix_cache"]
    assert dataclasses.asdict(eng.ecfg)["prefix_cache"] is True
