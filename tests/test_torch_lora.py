"""Port parity: multi-LoRA serving (``tpu_flash_torch/models/lora.py``,
``Engine(lora=bank)``) against the reference's ``tpu_flash/models/lora.py``
on the CPU.

``lora_mm`` against the reference's with ids that mix the base model (−1)
and adapters, over raw and int8 weight-only matrices; ``init_lora_bank``
and ``merge_lora`` against the reference's shapes, dtypes and values (the
reference's bank carried across by ``params_from_tree``). The port's
engine on ``tests/test_lora.py``'s float32 model and bank (``b`` filled
from a seed, a zero ``b`` being a no-op): a zero bank leaves every stream
as the base engine's; a served adapter equals the merged model, whose
teacher-forced logits equal the reference's ``forward`` of the reference's
``merge_lora`` within 1e-4; a mixed batch equals each request served
solo; the prefix cache is scoped by adapter; greedy speculation under an
adapter equals plain decoding; ``decode_steps=4`` rounds equal one-token
steps while lanes change adapters between rounds; refusals (no bank, an
id outside it, tensor parallelism, the seq-sharded engine, a snapshot of
adapter requests). The reference's engine is not driven.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.models import lora as jlora
from tpu_flash.models import transformer as jtfm
from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import lora as tlora
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.serving import checkpoint
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import params_from_tree

torch.set_num_threads(2)

# tests/test_lora.py's model and cache
_MCFG = dict(vocab_size=128, dim=64, num_layers=2, num_q_heads=2,
             num_kv_heads=2, head_dim=32, mlp_hidden=128, block_q=128,
             block_kv=128, dtype="float32")
JCFG, TCFG = jtfm.ModelConfig(**_MCFG), ttfm.ModelConfig(**_MCFG)
_CCFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=64,
             max_seqs=6, max_pages_per_seq=8, dtype="float32")


def _convert(tree):
    return params_from_tree(jax.tree.map(np.asarray, tree), device="cpu")


def _jbank(nonzero=True, n_adapters=3, rank=4):
    """tests/test_lora.py's bank: b filled with N(0, 0.3²) from a seed."""
    bank = jlora.init_lora_bank(jax.random.PRNGKey(7), JCFG, n_adapters,
                                rank)
    if not nonzero:
        return bank
    rng = np.random.default_rng(11)
    return [{t: dict(a=e["a"], b=jnp.asarray(
        rng.standard_normal(e["b"].shape) * 0.3, jnp.float32))
        for t, e in layer.items()} for layer in bank]


@pytest.fixture(scope="module")
def model():
    """The reference's weights and nonzero bank, and the port's copies."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    jb = _jbank()
    return jp, jb, _convert(jp), _convert(jb)


def _serve(params, reqs, lora=None, max_batch=2, draft=None, **kw):
    eng = teng.Engine(params, TCFG, CacheConfig(**_CCFG),
                      teng.EngineConfig(max_batch=max_batch, **kw),
                      lora=lora, draft=draft)
    for r in reqs:
        eng.submit(r)
    return {f.rid: f.new_tokens for f in eng.run()}, eng


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 127, n)]


def test_lora_mm_matches_reference(model):
    """Ids mixing −1 and adapters, over a raw and an int8 weight-only
    base matrix: the port's lora_mm within float32 rounding of the
    reference's; the base lanes equal x @ w exactly."""
    jp, jb, tp, tb = model
    x = np.random.default_rng(1).standard_normal((4, 5, 64)).astype(
        np.float32)
    ids = np.array([-1, 0, 2, 1], np.int32)
    entry_j, entry_t = jb[0]["wq"], tb[0]["wq"]
    jq = jax.jit(jtfm.quantize_weights)(jp)
    tq = ttfm.quantize_weights(tp)
    for jw, tw in ((jp["layers"][0]["wq"], tp["layers"][0]["wq"]),
                   (jq["layers"][0]["wq"], tq["layers"][0]["wq"])):
        want = np.asarray(jax.jit(jlora.lora_mm)(
            jnp.asarray(x), jw, entry_j, jnp.asarray(ids)))
        got = tlora.lora_mm(torch.from_numpy(x), tw, entry_t,
                            torch.from_numpy(ids))
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5
        base = ttfm._mm(torch.from_numpy(x), tw)
        assert torch.equal(got[:1], base[:1])
        assert float((got[1:] - base[1:]).abs().max()) > 1e-2
    assert tlora.lora_mm(torch.from_numpy(x), tp["layers"][0]["wq"], None,
                         torch.from_numpy(ids)).shape == (4, 5, 64)


def test_init_lora_bank_and_merge_match_reference(model):
    """init_lora_bank: the reference's tree, shapes and dtypes (bf16 and
    float32 models), a of std 1/rank (the reference's normal / rank), b
    zero; merge_lora: the reference's merged weights within float32
    rounding; merging onto int8 weights raises, as in the reference."""
    jp, jb, tp, tb = model
    for dtype in ("float32", "bfloat16"):
        jbank = jlora.init_lora_bank(jax.random.PRNGKey(7), jtfm.ModelConfig(
            **dict(_MCFG, dtype=dtype)), 3, 4)
        tbank = tlora.init_lora_bank(ttfm.ModelConfig(
            **dict(_MCFG, dtype=dtype)), 3, 4, torch.Generator().manual_seed(7),
            "cpu")
        assert len(tbank) == len(jbank) == 2
        for jl, tl in zip(jbank, tbank):
            assert set(tl) == set(jl) == set(tlora.TARGETS)
            for t in tlora.TARGETS:
                for f in ("a", "b"):
                    assert tuple(tl[t][f].shape) == tuple(jl[t][f].shape)
                    assert str(tl[t][f].dtype).endswith(str(jl[t][f].dtype))
                assert not tl[t]["b"].any()
        a = tbank[0]["wq"]["a"].float()
        assert abs(float(a.std()) - 0.25) < 0.02
    for aid in (0, 2):
        want = jax.jit(jlora.merge_lora, static_argnums=2)(jp, jb, aid)
        got = tlora.merge_lora(tp, tb, aid)
        for jl, tl in zip(want["layers"], got["layers"]):
            for t in tlora.TARGETS:
                assert float(np.abs(np.asarray(jl[t]) - tl[t].numpy())
                             .max()) <= 1e-5
        assert got["layers"][0]["w_up"] is tp["layers"][0]["w_up"]
    with pytest.raises(ValueError, match="weight-quantized"):
        tlora.merge_lora(ttfm.quantize_weights(tp), tb, 0)


def test_zero_bank_is_noop(model):
    """A zero-b bank: adapters 0 and 1 and the base model give the base
    engine's stream token for token."""
    _, _, tp, _ = model
    prompt = _prompt(1, 11)
    base, _ = _serve(tp, [teng.Request(rid=0, prompt=prompt,
                                       max_new_tokens=6)])
    zero = _convert(_jbank(nonzero=False))
    for aid in (-1, 0, 1):
        got, _ = _serve(tp, [teng.Request(rid=0, prompt=prompt,
                                          max_new_tokens=6, adapter_id=aid)],
                        lora=zero)
        assert got[0] == base[0]


def test_adapter_matches_merged_model(model):
    """Serving adapter k == serving merge_lora(params, bank, k) as base,
    whole-prompt and chunked prefill; the merged model's teacher-forced
    logits over that stream equal the reference's forward of its own
    merge_lora within 1e-4 of max |logit|."""
    jp, jb, tp, tb = model
    prompt = _prompt(2, 23)
    streams = []
    for aid in (0, 2):
        merged = tlora.merge_lora(tp, tb, aid)
        want, _ = _serve(merged, [teng.Request(rid=0, prompt=prompt,
                                               max_new_tokens=6)])
        got, _ = _serve(tp, [teng.Request(rid=0, prompt=prompt,
                                          max_new_tokens=6, adapter_id=aid)],
                        lora=tb)
        chunked, _ = _serve(tp, [teng.Request(
            rid=0, prompt=prompt, max_new_tokens=6, adapter_id=aid)],
            lora=tb, chunk_size=16)
        assert got[0] == want[0] == chunked[0], f"adapter {aid}"
        streams.append(got[0])
        toks = np.asarray([prompt + want[0]], np.int32)
        jlog = np.asarray(jax.jit(lambda p, b, t: jtfm.forward(
            jlora.merge_lora(p, b, aid), t, JCFG))(jp, jb, jnp.asarray(toks)))
        with torch.no_grad():
            tlog = ttfm.forward(merged, torch.from_numpy(toks).long(),
                                TCFG).numpy()
        assert np.abs(tlog - jlog).max() <= 1e-4 * np.abs(jlog).max()
    base, _ = _serve(tp, [teng.Request(rid=0, prompt=prompt,
                                       max_new_tokens=6)])
    assert streams[0] != base[0] or streams[1] != base[0]


def test_mixed_batch_matches_solo(model):
    """Base and two adapters decode together; each lane equals its solo
    run, and the finished requests carry their adapter."""
    _, _, tp, tb = model
    prompts = [_prompt(3 + i, 9 + 4 * i) for i in range(3)]
    aids = [-1, 0, 2]
    solo = {}
    for i, (p, a) in enumerate(zip(prompts, aids)):
        out, _ = _serve(tp, [teng.Request(rid=i, prompt=p, max_new_tokens=6,
                                          adapter_id=a)], lora=tb)
        solo[i] = out[i]
    eng = teng.Engine(tp, TCFG, CacheConfig(**_CCFG),
                      teng.EngineConfig(max_batch=3), lora=tb)
    for i, (p, a) in enumerate(zip(prompts, aids)):
        eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=6,
                                adapter_id=a))
    done = {f.rid: f for f in eng.run()}
    assert {i: f.new_tokens for i, f in done.items()} == solo
    assert [done[i].adapter_id for i in range(3)] == aids


def test_prefix_cache_is_adapter_scoped(model):
    """One prompt under the base model and under adapter 0: no hit across
    the namespaces, one within each; streams equal uncached solo runs."""
    _, _, tp, tb = model
    prompt = _prompt(6, 40)
    reqs = [teng.Request(rid=0, prompt=prompt, max_new_tokens=6),
            teng.Request(rid=1, prompt=prompt, max_new_tokens=6),
            teng.Request(rid=2, prompt=prompt, max_new_tokens=6,
                         adapter_id=0),
            teng.Request(rid=3, prompt=prompt, max_new_tokens=6,
                         adapter_id=0)]
    got, eng = _serve(tp, reqs, lora=tb, prefix_cache=True, max_batch=1)
    base, _ = _serve(tp, reqs[:1], lora=tb)
    adapt, _ = _serve(tp, [reqs[2]], lora=tb)
    assert got[0] == got[1] == base[0]
    assert got[2] == got[3] == adapt[2]
    assert got[2] != got[0]
    assert eng._pcache.stats()["hits"] == 2


def test_speculation_with_adapter_is_exact(model):
    """Greedy speculation (K 3, the base model as draft) on an adapted
    request equals plain adapted decoding."""
    _, _, tp, tb = model
    req = teng.Request(rid=0, prompt=_prompt(7, 11), max_new_tokens=6,
                       adapter_id=1)
    plain, _ = _serve(tp, [req], lora=tb)
    spec, eng = _serve(tp, [req], lora=tb, speculate_k=3, draft=(tp, TCFG))
    assert spec[0] == plain[0] and eng.spec_stats()["proposed"] > 0


def test_rounds_equal_one_token_steps_as_adapters_change(model):
    """Six requests over four lanes, adapters −1, 0, 1, 2 interleaved,
    lengths staggered so lanes finish and are refilled between rounds:
    decode_steps=4 rounds (async and not) give the one-token engine's
    streams and logprobs."""
    _, _, tp, tb = model
    reqs = [teng.Request(rid=i, prompt=_prompt(20 + i, 7 + 3 * i),
                         max_new_tokens=3 + 2 * i, adapter_id=i % 4 - 1)
            for i in range(6)]

    def run(**kw):
        eng = teng.Engine(tp, TCFG, CacheConfig(**_CCFG),
                          teng.EngineConfig(max_batch=4, **kw), lora=tb)
        for r in reqs:
            eng.submit(r)
        return {f.rid: (f.new_tokens, f.logprobs) for f in eng.run()}

    one = run()
    for asy in (True, False):
        got = run(decode_steps=4, async_decode=asy)
        assert sorted(got) == sorted(one)
        for rid, (toks, lps) in one.items():
            assert got[rid][0] == toks
            assert np.abs(np.subtract(got[rid][1], lps)).max() <= 1e-6


def test_adapter_refusals(model, tmp_path):
    """An adapter request without a bank, or naming a row the bank lacks,
    raises at submit; LoRA under tensor parallelism and on the
    seq-sharded engine is refused; load_checkpoint refuses a snapshot
    whose requests name adapters (it takes no bank)."""
    from tpu_flash_torch.serving.seq_engine import SeqShardedEngine

    _, _, tp, tb = model
    eng = teng.Engine(tp, TCFG, CacheConfig(**_CCFG),
                      teng.EngineConfig(max_batch=2))
    with pytest.raises(ValueError, match="LoRA bank"):
        eng.submit(teng.Request(rid=0, prompt=[1, 2, 3], adapter_id=0))
    eng = teng.Engine(tp, TCFG, CacheConfig(**_CCFG),
                      teng.EngineConfig(max_batch=2), lora=tb)
    with pytest.raises(ValueError, match="bank holds 3"):
        eng.submit(teng.Request(rid=0, prompt=[1, 2, 3], adapter_id=3))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        teng.Engine(tp, TCFG, CacheConfig(**_CCFG), lora=tb,
                    mesh=make_mesh(model=2, devices="cpu"))
    seq = SeqShardedEngine(tp, TCFG, CacheConfig(**_CCFG),
                           teng.EngineConfig(max_batch=2),
                           mesh=make_mesh(seq=2, devices="cpu"))
    with pytest.raises(ValueError, match="LoRA bank"):
        seq.submit(teng.Request(rid=0, prompt=[1, 2, 3], adapter_id=0))
    # a snapshot of adapter requests (one running, one waiting)
    eng = teng.Engine(tp, TCFG, CacheConfig(**_CCFG),
                      teng.EngineConfig(max_batch=1), lora=tb)
    eng.submit(teng.Request(rid=0, prompt=_prompt(8, 9), max_new_tokens=4,
                            adapter_id=1))
    eng.submit(teng.Request(rid=1, prompt=_prompt(9, 9), max_new_tokens=4))
    eng.step()
    checkpoint.save_checkpoint(str(tmp_path / "snap"), eng)
    with pytest.raises(ValueError, match=r"requests \[0\] that name LoRA"):
        checkpoint.load_checkpoint(str(tmp_path / "snap"), device="cpu")
