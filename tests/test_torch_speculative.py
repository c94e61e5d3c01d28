"""Port parity: speculative decoding (``Engine(draft=...)``,
``speculate_k``), against the reference engine on the reference's weights
(``tests/test_speculative.py``'s float32 model, converted).

Rejection sampling (``_spec_accept``) emits tokens by the target's law for
any draft, and reduces to greedy token matching at one-hot distributions.
Greedy speculative streams equal the reference's plain and speculative
streams token for token, for a self-draft (every proposal accepted) and a
weak draft (another seed's weights), at K 2 and 4, on a float32 and an
int8 cache, with a narrower draft of its own head geometry, with EOS
truncation, and under tensor parallelism over 2 CPU ranks. Temperature
streams are held by the reference's own checks: they complete, repeat per
seed, and a self-draft accepts every proposal. The port's noise is keyed
by (request, stream, position), not the reference's PRNG bits.
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
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

_MCFG = dict(vocab_size=128, dim=64, num_layers=2, num_q_heads=2,
             num_kv_heads=2, head_dim=32, mlp_hidden=128, block_q=128,
             block_kv=128, dtype="float32")
# a narrower draft: one layer, 4 q / 1 kv heads of width 16
_DRAFT = dict(_MCFG, dim=64, num_layers=1, num_q_heads=4, num_kv_heads=1,
              head_dim=16)
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=64,
             max_seqs=4, max_pages_per_seq=8)
_NEW = 8


def _convert(jp):
    return params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    """name → (reference params, port params, config dict)."""
    out = {}
    for name, cfg, seed in (("target", _MCFG, 0), ("weak", _MCFG, 7),
                            ("narrow", _DRAFT, 3)):
        jp = jtfm.init_params(jax.random.PRNGKey(seed),
                              jtfm.ModelConfig(**cfg))
        out[name] = (jp, _convert(jp), cfg)
    return out


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 127, n)] for n in (11, 19)]


def _run(mod, params, draft=None, k=0, dtype="float32", prompts=None,
         eos=None, mesh=None, **kw):
    cache_cls = JCacheConfig if mod is jeng else CacheConfig
    model_cls = jtfm.ModelConfig if mod is jeng else ttfm.ModelConfig
    dr = None if draft is None else (draft[0], model_cls(**draft[1]))
    eng = mod.Engine(params, model_cls(**_MCFG),
                     cache_cls(**_CCFG, dtype=dtype),
                     mod.EngineConfig(max_batch=2, speculate_k=k, **kw),
                     draft=dr, **({} if mesh is None else dict(mesh=mesh)))
    for rid, p in enumerate(prompts or _prompts()):
        eng.submit(mod.Request(rid=rid, prompt=p, max_new_tokens=_NEW,
                               eos_id=eos))
    return {f.rid: f for f in eng.run()}, eng


@pytest.fixture(scope="module")
def reference(models):
    """The reference's plain greedy streams (float32 and int8 caches) and
    its speculative ones with the weak draft at K 4."""
    jp = models["target"][0]
    out = {dt: _run(jeng, jp, dtype=dt)[0] for dt in ("float32", "int8")}
    out["spec_weak"] = _run(jeng, jp, draft=(models["weak"][0], _MCFG),
                            k=4)[0]
    return out


def _tokens(done):
    return {rid: f.tokens for rid, f in done.items()}


# ---- rejection sampling -------------------------------------------------


def test_spec_accept_matches_target_distribution():
    """Over proposals d ~ q and the accept/resample coin, the emitted token
    is distributed per the target p, for a mismatched q (the reference's
    law test: 20000 draws, total variation < 0.02). Each draw is a lane
    with its own noise key."""
    rng = np.random.default_rng(0)
    v, n = 8, 20000
    p = torch.softmax(torch.as_tensor(rng.standard_normal(v),
                                      dtype=torch.float32), 0)
    q = torch.softmax(torch.as_tensor(rng.standard_normal(v),
                                      dtype=torch.float32), 0)
    d = torch.as_tensor(rng.choice(v, n, p=q.double().numpy() / float(
        q.double().sum())))
    toks = torch.stack([torch.zeros(n, dtype=torch.int64), d], dim=1)
    p_all = p.expand(n, 2, v)
    keys = teng._fold(torch.arange(n, dtype=torch.int64) * 7919 + 1,
                      torch.zeros(n, dtype=torch.int32))
    m, final = teng._spec_accept(toks, p_all, q.expand(n, 1, v), keys)
    emitted = torch.where(m >= 1, d, final).numpy()
    emp = np.bincount(emitted, minlength=v) / n
    tv = 0.5 * np.abs(emp - p.numpy()).sum()
    assert tv < 0.02, (tv, emp, p.numpy())
    # and the coin matters: the proposals alone follow q, not p
    tv_q = 0.5 * np.abs(np.bincount(d.numpy(), minlength=v) / n
                        - p.numpy()).sum()
    assert tv_q > 5 * tv


def test_spec_accept_greedy_onehot_limit():
    """With one-hot p (temperature ≤ 0) acceptance is exact greedy
    matching, the final token the argmax at the cut, as the reference's."""
    rng = np.random.default_rng(1)
    v = 8
    p = torch.nn.functional.one_hot(torch.tensor([3]), v).float()
    q = torch.softmax(torch.as_tensor(rng.standard_normal((1, 1, v)),
                                      dtype=torch.float32), -1)
    for d, expect_m in ((3, 1), (5, 0)):
        toks = torch.tensor([[0, d]])
        p_all = torch.stack([p, p], dim=1)
        m, final = teng._spec_accept(toks, p_all, q, torch.tensor([11]))
        jm, jf = jeng._spec_accept(jnp.asarray(toks.numpy(), jnp.int32),
                                   jnp.asarray(p_all.numpy()),
                                   jnp.asarray(q.numpy()),
                                   jax.random.PRNGKey(0))
        assert int(m[0]) == int(jm[0]) == expect_m
        assert int(final[0]) == int(jf[0]) == 3


def test_trunc_dist_matches_reference():
    """The distributions speculation compares, temperature, top-k and
    nucleus truncation and the greedy one-hot, as the reference's."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((5, 64)) * 3).astype(np.float32)
    samp = np.array([[0.7, 10, 0.9], [1.0, 0, 0.5], [0.0, 0, 1.0],
                     [1.3, 0, 1.0], [0.5, 3, 1.0]], np.float32)
    want = np.asarray(jeng._trunc_dist(jnp.asarray(logits),
                                       jnp.asarray(samp)))
    for host in (None, samp):
        got = teng._trunc_dist(torch.as_tensor(logits), torch.as_tensor(samp),
                               host).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    greedy = samp.copy()
    greedy[:, 0] = 0.0
    got = teng._trunc_dist(torch.as_tensor(logits), torch.as_tensor(greedy),
                           greedy).numpy()
    np.testing.assert_array_equal(got, np.asarray(jeng._trunc_dist(
        jnp.asarray(logits), jnp.asarray(greedy))))


# ---- the engine ---------------------------------------------------------


@pytest.mark.parametrize("K", [2, 4])
def test_self_draft_equals_reference_plain(models, reference, K):
    """Draft == target: every proposal accepted, the streams the
    reference's plain greedy streams, in fewer target calls."""
    tp = models["target"][1]
    got, eng = _run(teng, tp, draft=(tp, _MCFG), k=K)
    assert _tokens(got) == _tokens(reference["float32"])
    for rid, f in got.items():
        np.testing.assert_allclose(f.logprobs,
                                   reference["float32"][rid].logprobs,
                                   atol=1e-3)
    st = eng.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]
    assert eng.metrics()["speculative"] == st
    assert eng.metrics()["steps"] < 1 + _NEW


@pytest.mark.parametrize("K", [2, 4])
def test_weak_draft_equals_reference(models, reference, K):
    """Another seed's draft proposes mostly wrong tokens; the streams are
    still the reference's plain ones, and its own speculative ones."""
    got, eng = _run(teng, models["target"][1],
                    draft=(models["weak"][1], _MCFG), k=K)
    assert _tokens(got) == _tokens(reference["float32"])
    assert _tokens(got) == _tokens(reference["spec_weak"])
    st = eng.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] < st["proposed"]


def test_narrow_draft_on_int8_cache_equals_reference(models, reference):
    """A draft of its own head geometry (1 kv head of width 16: its caches
    take the target's page tables at their own shape) over an int8 cache:
    the reference's plain int8 streams."""
    narrow = models["narrow"]
    got, eng = _run(teng, models["target"][1], draft=(narrow[1], _DRAFT),
                    k=3, dtype="int8")
    assert _tokens(got) == _tokens(reference["int8"])
    dc = eng._draft["caches"]
    assert len(dc) == 1 and dc[0].k_pages.shape[0] == 1
    assert dc[0].k_pages.shape[-1] == 16 and dc[0].config.dtype == "int8"
    assert eng.spec_stats()["proposed"] > 0


def test_eos_truncation(models):
    """An accepted proposal equal to eos_id finishes the request at eos,
    as the plain engine does."""
    tp = models["target"][1]
    prompt = _prompts()[:1]
    plain = _run(teng, tp, prompts=prompt)[0][0]
    eos = plain.new_tokens[3]
    base = _run(teng, tp, prompts=prompt, eos=eos)[0][0]
    spec, eng = _run(teng, tp, draft=(tp, _MCFG), k=4, prompts=prompt,
                     eos=eos)
    assert spec[0].new_tokens == base.new_tokens
    assert spec[0].reason == base.reason == "eos"
    assert eng.spec_stats()["accepted"] > 0


def test_temperature_streams(models):
    """temperature > 0 speculates through rejection sampling: the stream
    completes, repeats for the same seed, moves with another, and a
    self-draft accepts every proposal (p == q)."""
    tp = models["target"][1]

    def run(seed):
        eng = teng.Engine(tp, ttfm.ModelConfig(**_MCFG),
                          CacheConfig(**_CCFG, dtype="float32"),
                          teng.EngineConfig(max_batch=1, speculate_k=4,
                                            seed=seed),
                          draft=(tp, ttfm.ModelConfig(**_MCFG)))
        eng.submit(teng.Request(rid=0, prompt=_prompts()[0],
                                max_new_tokens=6, temperature=0.8))
        return eng.run()[0].new_tokens, eng.spec_stats()

    toks, st = run(3)
    assert len(toks) == 6
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]
    assert run(3)[0] == toks
    assert any(run(s)[0] != toks for s in (4, 5))


def test_decode_steps_ignored_with_a_draft(models, reference):
    """decode_steps > 1 is ignored while a draft is attached: every round
    is speculative, none a K-step round, and the streams stand."""
    tp = models["target"][1]
    got, eng = _run(teng, tp, draft=(tp, _MCFG), k=4, decode_steps=4)
    assert _tokens(got) == _tokens(reference["float32"])
    assert eng.graph_stats["captures"] == 0 and eng._inflight is None


def test_speculation_under_tensor_parallelism(models, reference):
    """The target's verify runs over 2 tensor-parallel CPU ranks, the
    draft unsharded: the reference's plain single-device streams."""
    tp = models["target"][1]
    got, eng = _run(teng, tp, draft=(models["weak"][1], _MCFG), k=4,
                    mesh=make_mesh(model=2, devices="cpu"))
    assert eng.tp.size == 2
    assert _tokens(got) == _tokens(reference["float32"])
    assert eng.spec_stats()["proposed"] > 0


def test_bad_configurations_raise(models):
    """speculate_k 1 and a draft of another vocabulary raise, as the
    reference's; speculate_k without a draft decodes plain."""
    tp = models["target"][1]
    mcfg, ccfg = ttfm.ModelConfig(**_MCFG), CacheConfig(**_CCFG)
    with pytest.raises(ValueError, match="speculate_k"):
        teng.Engine(tp, mcfg, ccfg,
                    teng.EngineConfig(max_batch=2, speculate_k=1),
                    draft=(tp, mcfg))
    with pytest.raises(ValueError, match="vocab"):
        teng.Engine(tp, mcfg, ccfg,
                    teng.EngineConfig(max_batch=2, speculate_k=2),
                    draft=(tp, ttfm.ModelConfig(**dict(_MCFG,
                                                       vocab_size=64))))
    assert teng.Engine(tp, mcfg, ccfg, teng.EngineConfig(
        max_batch=2, speculate_k=4))._draft is None
