"""Port parity: the supervised serving loop (``serving/supervisor.py``):
failure detection and restart from a checkpoint, against the reference
(``tests/test_supervisor.py``'s engine and prompts; a float32 model and
cache, weights converted).

Driven through injected crashes and external kills, every recovered run
gives exactly the tokens of an uninterrupted run, which are the
reference's; a journal replays requests a kill before the first snapshot
would lose; persistent corruption exhausts the restarts; snapshots rotate;
a speculative engine recovers with its draft re-attached and still
accepts every self-draft proposal.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.models import transformer as jtfm
from tpu_flash.serving import engine as jeng
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.serving.supervisor import Supervisor, SupervisorConfig
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

_MCFG = dict(vocab_size=256, dim=128, num_layers=2, num_q_heads=4,
             num_kv_heads=2, head_dim=32, block_q=128, block_kv=128,
             dtype="float32")
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=128,
             max_seqs=8, max_pages_per_seq=16, dtype="float32")
_PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, 255, 10 + 3 * i)]
            for i in range(3)]


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_MCFG))
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def reference(params):
    """The reference engine's uninterrupted tokens."""
    eng = jeng.Engine(params[0], jtfm.ModelConfig(**_MCFG),
                      JCacheConfig(**_CCFG), jeng.EngineConfig(max_batch=4))
    for rid, p in enumerate(_PROMPTS):
        eng.submit(jeng.Request(rid=rid, prompt=p, max_new_tokens=12))
    return sorted((f.rid, tuple(f.tokens)) for f in eng.run())


def _make(tp, **kw):
    return lambda: teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                               CacheConfig(**_CCFG),
                               teng.EngineConfig(max_batch=4, **kw))


def _sup(tp, d, make=None, **cfg):
    return Supervisor(make or _make(tp), SupervisorConfig(dir=str(d), **cfg),
                      device="cpu")


def _submit_all(sup):
    for rid, p in enumerate(_PROMPTS):
        sup.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=12))


def _tokens(done):
    return sorted((f.rid, tuple(f.tokens)) for f in done)


def test_supervised_run_matches_reference(tmp_path, params, reference):
    """No faults: a transparent wrapper; the journal holds every request
    and the heartbeat the last step's deadline."""
    sup = _sup(params[1], tmp_path / "sup", checkpoint_every=4)
    _submit_all(sup)
    assert _tokens(sup.run()) == reference
    with open(tmp_path / "sup" / "journal.jsonl") as f:
        assert [json.loads(x)["rid"] for x in f] == [0, 1, 2]
    with open(tmp_path / "sup" / "HEARTBEAT") as f:
        beat = json.load(f)
    assert beat["step"] == sup.step_index - 1 and beat["deadline"] > 0


@pytest.mark.parametrize("crash_step", [2, 6])
def test_crash_recovery_exact(tmp_path, params, reference, crash_step):
    """A one-shot crash before and after the first snapshot recovers to
    exactly the uninterrupted tokens."""
    fired = []

    def fault(step, engine):
        if step == crash_step and not fired:
            fired.append(step)
            raise RuntimeError("injected device failure")

    sup = _sup(params[1], tmp_path / "sup", checkpoint_every=4,
               fault_hook=fault)
    _submit_all(sup)
    assert _tokens(sup.run()) == reference
    assert fired and sup.restarts == 1


def test_external_kill_resume(tmp_path, params, reference):
    """A kill after a snapshot: a new supervisor on the same directory
    resumes from it (step 4) and finishes exactly."""
    d = tmp_path / "sup"
    sup = _sup(params[1], d, checkpoint_every=4)
    _submit_all(sup)
    sup.run(max_steps=6)
    del sup
    sup2 = _sup(params[1], d, checkpoint_every=4)
    assert sup2.step_index == 4
    assert _tokens(sup2.resume()) == reference


def test_kill_before_first_checkpoint_replays_journal(tmp_path, params,
                                                      reference):
    """No snapshot yet: the journal replays every accepted request into a
    fresh engine."""
    d = tmp_path / "sup"
    sup = _sup(params[1], d, checkpoint_every=1000)
    _submit_all(sup)
    sup.run(max_steps=2)
    del sup
    sup2 = _sup(params[1], d, checkpoint_every=1000)
    assert sup2.step_index == 0 and len(sup2.engine.waiting) == 3
    assert _tokens(sup2.resume()) == reference


def test_health_check_catches_corrupt_tokens(tmp_path, params):
    """An out-of-vocab token is detected and the engine recovers;
    persistent corruption exhausts max_restarts."""
    sup = _sup(params[1], tmp_path / "sup", max_restarts=2)
    _submit_all(sup)
    sup.run(max_steps=3)
    sup.cfg = dataclasses.replace(sup.cfg, fault_hook=None)
    orig = sup._check_health

    def failing_check():
        for r in sup.engine.running.values():
            r.tokens[-1] = _MCFG["vocab_size"] + 7
            break
        orig()

    sup._check_health = failing_check
    with pytest.raises(RuntimeError, match="max_restarts"):
        sup.run()
    assert sup.restarts == 3


def test_checkpoint_rotation(tmp_path, params):
    """Only keep_checkpoints trailing snapshots stay; LATEST names the
    newest."""
    d = tmp_path / "sup"
    sup = _sup(params[1], d, checkpoint_every=2, keep_checkpoints=2)
    _submit_all(sup)
    sup.run()
    snaps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert 1 <= len(snaps) <= 2
    with open(d / "LATEST") as f:
        assert f.read().strip() == snaps[-1]


def test_crash_recovery_with_speculation(tmp_path, params, reference):
    """Recovery re-attaches the draft: the restored speculative engine
    gives the uninterrupted greedy tokens, and its self-draft accepts
    every proposal (the draft tables are re-synced on restore, so the
    replayed draft K/V are real)."""
    tp = params[1]
    fired = []

    def fault(step, engine):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected device failure")

    draft = (tp, ttfm.ModelConfig(**_MCFG))
    sup = Supervisor(
        lambda: teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                            CacheConfig(**_CCFG),
                            teng.EngineConfig(max_batch=4, speculate_k=3),
                            draft=draft),
        SupervisorConfig(dir=str(tmp_path / "sup"), checkpoint_every=2,
                         fault_hook=fault),
        draft=draft, device="cpu")
    _submit_all(sup)
    assert _tokens(sup.run()) == reference
    assert fired and sup.restarts == 1
    st = sup.engine.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]
