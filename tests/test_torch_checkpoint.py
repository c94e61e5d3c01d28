"""Port parity: checkpoint and resume (``serving/checkpoint.py``) against
the reference (``tests/test_checkpoint.py``'s prompts and engine; a
float32 model here, weights converted, so the port's streams can equal the
reference's token for token).

A greedy decode snapshotted part-way, loaded into a fresh engine and run
to the end gives the uninterrupted run's tokens (logprobs equal) and the
reference's resumed tokens, on a float32 and an int8 cache; also from
async K-step rounds, a speculative engine (the draft required), prefix-
shared page tables and a tensor-parallel engine over 2 CPU ranks. The
allocator's table restore is held in ``test_torch_prefix_cache.py`` beside
its other operations. One page-table row swapped in the snapshot must show
in the streams.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash.serving.checkpoint import load_checkpoint as jload
from tpu_flash.serving.checkpoint import save_checkpoint as jsave
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.serving.checkpoint import load_checkpoint, save_checkpoint
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
             dtype="float32")
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=128,
             max_seqs=8, max_pages_per_seq=16)
_PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, 255, 10 + 3 * i)]
            for i in range(3)]
_STEPS = 4  # snapshot part-way through decode


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _fresh(tp, dtype="float32", prompts=_PROMPTS, mesh=None, draft=None,
           **kw):
    eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                      CacheConfig(**_CCFG, dtype=dtype),
                      teng.EngineConfig(max_batch=4, **kw), mesh=mesh,
                      draft=draft)
    for rid, p in enumerate(prompts):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=12))
    return eng


def _done(finished):
    return {f.rid: f for f in finished}


def _same(got, want, exact=True):
    assert sorted(got) == sorted(want)
    for rid, f in want.items():
        assert got[rid].tokens == f.tokens, rid
        if exact:
            assert got[rid].logprobs == f.logprobs, rid


def _resumed(eng, path, steps=_STEPS, **load_kw):
    for _ in range(steps):
        eng.step()
    save_checkpoint(str(path), eng)
    restored = load_checkpoint(str(path), device="cpu", **load_kw)
    assert restored.running, "the snapshot should hold running requests"
    return _done(restored.run()), restored


@pytest.fixture(scope="module")
def reference(params, tmp_path_factory):
    """The reference's uninterrupted and resumed tokens, both caches."""
    jp = params[0]
    out = {}
    for dtype in ("float32", "int8"):
        def fresh():
            eng = jeng.Engine(jp, jtfm.ModelConfig(**_MCFG),
                              JCacheConfig(**_CCFG, dtype=dtype),
                              jeng.EngineConfig(max_batch=4))
            for rid, p in enumerate(_PROMPTS):
                eng.submit(jeng.Request(rid=rid, prompt=p, max_new_tokens=12))
            return eng

        whole = {f.rid: f.tokens for f in fresh().run()}
        eng = fresh()
        for _ in range(_STEPS):
            eng.step()
        path = tmp_path_factory.mktemp(f"ref_{dtype}") / "ckpt"
        jsave(str(path), eng)
        resumed = {f.rid: f.tokens for f in jload(str(path)).run()}
        assert resumed == whole
        out[dtype] = whole
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_resume_matches_uninterrupted_and_reference(params, reference,
                                                    tmp_path, dtype):
    """Snapshot after 4 steps, restore, finish: the uninterrupted port
    run's tokens and logprobs exactly, and the reference's tokens; the
    restored caches hold the snapshot's bytes."""
    tp = params[1]
    whole = _done(_fresh(tp, dtype).run())
    eng = _fresh(tp, dtype)
    for _ in range(_STEPS):
        eng.step()
    save_checkpoint(str(tmp_path / "ckpt"), eng)
    restored = load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    for a, b in zip(eng.caches, restored.caches):
        for f in ("k_pages", "v_pages", "k_scales", "v_scales",
                  "page_tables", "lengths"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or torch.equal(x, y), f
    assert restored.running.keys() == eng.running.keys()
    got = _done(restored.run())
    _same(got, whole)
    assert {rid: f.tokens for rid, f in got.items()} == reference[dtype]
    # every page back (the cache's 127 usable pages)
    assert restored._alloc.num_free() == _CCFG["total_pages"] - 1


def test_resume_from_async_rounds(params, tmp_path):
    """K-step async rounds: the snapshot commits the round in flight, and
    the restored engine runs its own rounds to the one-token streams."""
    tp = params[1]
    whole = _done(_fresh(tp).run())
    eng = _fresh(tp, decode_steps=4, async_decode=True)
    got, restored = _resumed(eng, tmp_path / "ckpt", steps=2)
    assert restored.ecfg.decode_steps == 4 and restored._graphs == {}
    _same(got, whole, exact=False)
    for rid, f in whole.items():
        np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=1e-6)


def test_speculative_resume_needs_the_draft(params, tmp_path):
    """A speculative snapshot refuses to load without a draft; with it the
    restored engine (draft tables re-synced, histories replayed through
    the draft's catch-up) gives the plain streams, every proposal of the
    self-draft accepted."""
    tp = params[1]
    whole = _done(_fresh(tp).run())
    draft = (tp, ttfm.ModelConfig(**_MCFG))
    eng = _fresh(tp, draft=draft, speculate_k=3)
    for _ in range(2):
        eng.step()
    save_checkpoint(str(tmp_path / "ckpt"), eng)
    with pytest.raises(ValueError, match="draft"):
        load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    restored = load_checkpoint(str(tmp_path / "ckpt"), device="cpu",
                               draft=draft)
    for s in restored.running:
        for c in restored._draft["caches"]:
            assert torch.equal(c.page_tables[s], restored.caches[0]
                               .page_tables[s])
    _same(_done(restored.run()), whole, exact=False)
    st = restored.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]


def test_resume_with_prefix_shared_tables(params, tmp_path):
    """Two running requests share cached prompt pages: the snapshot's
    tables restore with the shared pages referenced twice."""
    tp = params[1]
    rng = np.random.default_rng(5)
    base = [int(t) for t in rng.integers(1, 255, 48)]
    prompts = [base + [int(t) for t in rng.integers(1, 255, 5)]
               for _ in range(2)]
    whole = _done(_fresh(tp, prompts=prompts).run())
    eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                      CacheConfig(**_CCFG, dtype="float32"),
                      teng.EngineConfig(max_batch=4, prefix_cache=True))
    eng.submit(teng.Request(rid=0, prompt=prompts[0], max_new_tokens=12))
    eng.step()
    eng.submit(teng.Request(rid=1, prompt=prompts[1], max_new_tokens=12))
    for _ in range(3):
        eng.step()
    assert eng._pcache.stats()["hits"] == 1
    shared = int(eng._alloc.table(0)[0])
    assert int(eng._alloc.table(1)[0]) == shared
    save_checkpoint(str(tmp_path / "ckpt"), eng)
    restored = load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    assert restored._alloc.refcount(shared) == 2
    got = _done(restored.run())
    for rid in (0, 1):
        assert got[rid].tokens == whole[rid].tokens


def test_resume_under_tensor_parallelism(params, tmp_path):
    """A tensor-parallel snapshot holds each rank's slices; it needs a
    mesh of the same size, and resumes to the unsharded streams."""
    tp = params[1]
    whole = _done(_fresh(tp).run())
    mesh = make_mesh(model=2, devices="cpu")
    eng = _fresh(tp, mesh=mesh)
    for _ in range(_STEPS):
        eng.step()
    save_checkpoint(str(tmp_path / "ckpt"), eng)
    with pytest.raises(ValueError, match="mesh"):
        load_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        load_checkpoint(str(tmp_path / "ckpt"),
                        mesh=make_mesh(model=4, devices="cpu"))
    restored = load_checkpoint(str(tmp_path / "ckpt"), mesh=mesh)
    assert restored.tp.size == 2 and len(restored.caches) == 2
    for a, b in zip(eng._all_caches(), restored._all_caches()):
        assert torch.equal(a.k_pages, b.k_pages)
    _same(_done(restored.run()), whole, exact=False)


def test_snapshot_refuses_chunked_prefills(params, tmp_path):
    tp = params[1]
    eng = _fresh(tp, prompts=[[7] * 40], chunk_size=16)
    eng.step()
    assert eng.prefilling
    with pytest.raises(ValueError, match="chunked prefills"):
        save_checkpoint(str(tmp_path / "ckpt"), eng)
    assert not os.path.exists(tmp_path / "ckpt" / "host_state.json")


def test_swapped_page_table_row_shows(params, tmp_path):
    """The planted fault: two running slots' page-table rows swapped in the
    snapshot's arrays; the resumed streams must differ."""
    tp = params[1]
    whole = _done(_fresh(tp).run())
    eng = _fresh(tp)
    for _ in range(_STEPS):
        eng.step()
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), eng)
    arrays = torch.load(path / "arrays.pt", weights_only=True)
    a, b = sorted(eng.running)[:2]
    for c in arrays["caches"]:
        c["page_tables"][[a, b]] = c["page_tables"][[b, a]].clone()
    torch.save(arrays, path / "arrays.pt")
    got = _done(load_checkpoint(str(path), device="cpu").run())
    assert any(got[r].tokens != whole[r].tokens for r in whole)
