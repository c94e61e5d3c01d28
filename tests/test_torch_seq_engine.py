"""Port parity: the sequence-sharded engine (``serving/seq_engine.py``)
against the reference's single-cache engine.

``SeqShardedEngine`` over 2 and 4 virtual sequence ranks of a CPU mesh,
on the reference's weights (``tests/test_engine_seq_sharded.py``'s model,
in float32, its prompts and engine sizes), against the reference's
unsharded ``Engine``: a float32 cache token for token; int8 token for
token and int4 through the prompt and the first generated token
(``tests/test_engine_seq_sharded.py:100-113``: int4's coarse grid leaves
argmax margins within the merge's float32 reduction-order noise). The
model is the reference test's in float32: its bf16 weights give logits
near ties (logprobs near −ln 256), and the port's paged partials, which
differ from the reference's by float32 roundings (~2e-7,
``tests/test_torch_ring_decode.py``), round to a bf16 output one ulp
apart often enough to flip one of its 44 tokens. Then the
tail-growth test (``:118-135``: only the last rank's pool grows), and the
refusals: chunked prefill, sliding models, the prefix cache, speculation,
and K-step rounds (``decode_steps > 1``), which the reference never
composed with sequence sharding (its engine crashes there).
"""

import jax
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.serving.seq_engine import SeqShardedEngine
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
             dtype="float32")
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=128,
             max_seqs=8, max_pages_per_seq=16)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _run(mod, engine, prompts, max_new=6):
    for rid, p in enumerate(prompts):
        engine.submit(mod.Request(rid=rid, prompt=p, max_new_tokens=max_new))
    return {r.rid: [int(t) for t in r.tokens] for r in engine.run()}


def _seq(tp, dtype, shards, max_batch, **kw):
    return SeqShardedEngine(tp, ttfm.ModelConfig(**_MCFG),
                            CacheConfig(**_CCFG, dtype=dtype),
                            teng.EngineConfig(max_batch=max_batch, **kw),
                            mesh=make_mesh(seq=shards, devices="cpu"))


def _reference(jp, dtype, prompts, max_batch):
    return _run(jeng, jeng.Engine(jp, jtfm.ModelConfig(**_MCFG),
                                  JCacheConfig(**_CCFG, dtype=dtype),
                                  jeng.EngineConfig(max_batch=max_batch)),
                prompts)


@pytest.fixture(scope="module")
def float32_reference(params):
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 255, n)] for n in (24, 9, 40)]
    return prompts, _reference(params[0], "float32", prompts, 4)


@pytest.mark.parametrize("shards", [2, 4])
def test_seq_sharded_matches_reference(params, float32_reference, shards):
    """Greedy decode over S ranks from a float32 cache: token for token
    the reference's single-cache engine."""
    prompts, want = float32_reference
    got = _run(teng, _seq(params[1], "float32", shards, 4), prompts)
    assert got == want


@pytest.fixture(scope="module")
def quantized_reference(params):
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 255, n)] for n in (20, 33)]
    return prompts, {dt: _reference(params[0], dt, prompts, 3)
                     for dt in ("int8", "int4")}


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("shards", [2, 4])
def test_seq_sharded_quantized(params, quantized_reference, dtype, shards):
    """int8 and int4 sequence-sharded caches against the reference's
    single-cache engine with the same page type: int8 token for token,
    int4 through the prompt and the first generated token."""
    prompts, refs = quantized_reference
    want = refs[dtype]
    got = _run(teng, _seq(params[1], dtype, shards, 3), prompts)
    assert set(got) == set(want)
    for rid in want:
        assert len(got[rid]) == len(want[rid])
        if dtype == "int8":
            assert got[rid] == want[rid], rid
        else:
            n = len(want[rid]) - 6
            assert got[rid][:n + 1] == want[rid][:n + 1], rid


def test_seq_sharded_long_generation_grows_tail(params):
    """Generation past the prompt slice grows only the last rank's pool:
    the other ranks' pages stay as admitted, the tail's grow."""
    eng = _seq(params[1], "int8", 2, 2)
    prompt = [int(t) for t in np.random.default_rng(2).integers(1, 255, 10)]
    eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=40))
    eng.step()
    slot = next(iter(eng.running))
    before = eng.shard_pages(slot)
    grown = []
    while eng.running:
        eng.step()
        if slot in eng.running:
            grown.append(eng.shard_pages(slot))
    done = eng.finished
    assert len(done) == 1 and len(done[0].new_tokens) == 40
    assert before[0] >= 1
    assert all(g[0] == before[0] for g in grown)
    assert max(g[-1] for g in grown) > before[-1]
    assert all(a.num_pages(slot) == 0 for a in eng._allocs)


@pytest.mark.parametrize("kw", [dict(decode_steps=4),
                                dict(decode_steps=2, async_decode=False),
                                dict(chunk_size=16), dict(prefix_cache=True),
                                dict(speculate_k=2)])
def test_seq_sharded_refusals(params, kw):
    """What the reference refuses (chunked prefill, the prefix cache,
    speculation), and K-step rounds, raise NotImplementedError."""
    with pytest.raises(NotImplementedError):
        _seq(params[1], "int8", 2, 2, **kw)
    sliding = ttfm.ModelConfig(**_MCFG, attention="sliding", window=17)
    with pytest.raises(NotImplementedError, match="causal-only"):
        SeqShardedEngine(params[1], sliding, CacheConfig(**_CCFG),
                         teng.EngineConfig(max_batch=2),
                         mesh=make_mesh(seq=2, devices="cpu"))
