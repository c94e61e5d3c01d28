"""Port parity: the MoE model (``tpu_flash_torch/models/moe.py`` and its
use in ``models/transformer.py``) against the reference's
``tpu_flash/models/moe.py`` on the CPU.

The same numpy logits, activations and the reference's own weights
(``params_from_tree``) go through both. Routing is the reference's
exactly: dispatch (choices, positions, drops) equal, combine weights and
the balance loss within float32 rounding, at capacities that drop tokens,
for top-1 and top-2, and in the case where a dropped first choice frees a
slot for a second one. ``moe_mlp`` within 1e-5 at float32; a 2-layer MoE
model's ``forward``, and ``loss_fn`` with the balance term and its
gradient, against ``jax.value_and_grad`` at 1e-3 relative (as
``tests/test_torch_train.py``); the port's ``decode_step`` equal to its
teacher-forced ``forward`` (the reference test's tolerances); the serving
guard on every serving entry point; ``quantize_weights`` leaving the
router and the experts alone; tensor parallelism over 2 CPU ranks with
the bank replicated within 1e-4 of max |logit| of the unsharded forward,
and a bank split like a dense MLP (no replica of it) missing that; and
the engine's modes on a MoE model agreeing with its one-token steps.
Reference calls run under ``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.models import moe as jmoe
from tpu_flash.models import transformer as jtfm
from tpu_flash_torch import graft_entry
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.models import moe as tmoe
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.parallel import shardings
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.serving import engine as teng
from tpu_flash_torch.utils.convert import params_from_tree, to_numpy

torch.set_num_threads(2)

# tests/test_moe.py's model
_CFG = dict(vocab_size=64, dim=32, num_layers=2, num_q_heads=2,
            num_kv_heads=2, head_dim=16, mlp_hidden=64, block_q=128,
            block_kv=128, dtype="float32", moe_experts=4, moe_top_k=2)
JCFG, TCFG = jtfm.ModelConfig(**_CFG), ttfm.ModelConfig(**_CFG)
_SERVE = dict(_CFG, moe_capacity_factor=2.0)  # drop-free: E / top_k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _convert(tree):
    return params_from_tree(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def layer():
    """One reference MoE layer (d 32, hidden 64, 4 experts) and the
    port's copy."""
    jl = jmoe.init_moe_params(jax.random.PRNGKey(5), 32, 64, 4, jnp.float32)
    return jl, _convert(jl)


_route = jax.jit(jmoe.route_topk, static_argnums=(1, 2))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [5, 40])
def test_route_topk_matches_reference(top_k, capacity):
    """Dispatch bit for bit, combine and aux within float32 rounding; at
    capacity 5 tokens drop (so positions past it matter)."""
    logits = np.random.default_rng(top_k).standard_normal(
        (2, 40, 4)).astype(np.float32)
    jd, jc, ja = _route(jnp.asarray(logits), top_k, capacity)
    td, tc, ta = tmoe.route_topk(_t(logits), top_k, capacity)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert float(np.abs(np.asarray(jc) - tc.numpy()).max()) <= 1e-6
    assert abs(float(ja) - float(ta)) <= 1e-6
    dropped = top_k * 2 * 40 - int(td.sum())
    assert (dropped > 0) == (capacity == 5)
    # each kept token's gates renormalize to 1
    kept = td.sum(dim=(2, 3)) > 0
    np.testing.assert_allclose(tc.sum(dim=(2, 3))[kept].numpy(), 1.0,
                               atol=1e-6)


def test_dropped_first_choice_frees_slot_for_second_choice():
    """The reference's case: 8 tokens all pick expert 0 then expert 1, at
    capacity 4; expert 1's slots start at 0, not after choice 0's drops."""
    logits = np.broadcast_to(np.asarray([10.0, 0.0], np.float32),
                             (1, 8, 2)).copy()
    jd, jc, _ = _route(jnp.asarray(logits), 2, 4)
    td, tc, _ = tmoe.route_topk(_t(logits), 2, 4)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert float(np.abs(np.asarray(jc) - tc.numpy()).max()) <= 1e-6
    assert td[..., 0, :].sum() == 4 and td[..., 1, :].sum() == 4
    np.testing.assert_array_equal(td[0, :, 1, :].sum(dim=0).numpy(), 1.0)
    r, _ = tmoe._route(_t(logits), 2, 4)
    assert r.keep[0, :4, 0].all() and not r.keep[0, 4:, 0].any()


def test_route_topk_rejects_topk_over_experts():
    with pytest.raises(ValueError, match="top_k"):
        tmoe.route_topk(torch.zeros(1, 4, 2), 3, capacity=4)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_reference(layer, top_k):
    """float32 within 1e-5, at capacity factor 1.25 (tokens drop)."""
    jl, tl = layer
    h = np.random.default_rng(3).standard_normal((2, 48, 32)).astype(
        np.float32)
    jo, ja = jax.jit(lambda l, x: jmoe.moe_mlp(l, x, top_k=top_k))(
        jl, jnp.asarray(h))
    to, ta = tmoe.moe_mlp(tl, _t(h), top_k=top_k)
    assert to.dtype == torch.float32 and to.shape == (2, 48, 32)
    assert float(np.abs(np.asarray(jo) - to.numpy()).max()) <= 1e-5
    assert abs(float(ja) - float(ta)) <= 1e-6


def test_init_moe_params_shapes_and_dtypes(jparams):
    """The port's init has the reference's tree, shapes and dtypes: a
    float32 router, expert-major bf16 experts, no dense MLP."""
    cfg = dict(_CFG, dtype="bfloat16")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**cfg))
    tp = ttfm.init_params(ttfm.ModelConfig(**cfg),
                          torch.Generator().manual_seed(0), "cpu")
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert jflat.keys() == tflat.keys()
    for key, jv in jflat.items():
        assert tuple(jv.shape) == tuple(tflat[key].shape), key
        assert str(jv.dtype) == str(tflat[key].dtype).split(".")[-1], key
    lp = tp["layers"][0]
    assert lp["wr"].dtype == torch.float32 and lp["w_gate"].shape == (4, 32,
                                                                      64)
    # the reference's N(0, 1/fan_in): std of the router and the experts
    assert abs(float(lp["w_up"].float().std()) - 32 ** -0.5) < 0.02
    assert abs(float(lp["w_down"].float().std()) - 64 ** -0.5) < 0.02


def test_forward_loss_and_grads_match_reference(jparams):
    """A 2-layer MoE model (capacity factor 1.25): forward logits, and
    loss_fn with the balance term and its gradient w.r.t. every leaf,
    against the reference; the balance term is in the loss."""
    toks = np.random.default_rng(0).integers(0, 64, (2, 65)).astype(np.int32)
    jl = jax.jit(lambda p, t: jtfm.forward(p, t, JCFG))(
        jparams, jnp.asarray(toks[:, :-1]))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss_fn(p, t, JCFG)))(jparams, jnp.asarray(toks))
    tp = _convert(jparams)
    with torch.no_grad():
        tl = ttfm.forward(tp, _t(toks[:, :-1]).long(), TCFG)
        no_aux = float(ttfm.loss_fn(tp, _t(toks).long(), TCFG,
                                    moe_aux_coef=0.0))
    jl = np.asarray(jl)
    assert float(np.abs(jl - tl.numpy()).max()) <= 1e-4 * np.abs(jl).max()
    loss, grads = graft_entry.loss_and_grads(tp, _t(toks).long(), TCFG)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(loss) - no_aux > 1e-3  # 0.01 · mean aux, aux ≈ 1
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(graft_entry._with_leaves(
                 tp, [to_numpy(g) for g in grads]))[0]}
    jflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert tflat.keys() == jflat.keys()
    for key, jg in jflat.items():
        rel = np.abs(tflat[key] - jg).max() / max(np.abs(jg).max(), 1e-30)
        assert rel <= 1e-3, key
    assert np.abs(tflat["['layers'][0]['wr']"]).max() > 0


def test_decode_step_matches_forward():
    """prefill → paged cache → decode_step on the drop-free MoE model
    equals the teacher-forced forward (the reference test's tolerances),
    greedy token equal; the reference's forward agrees."""
    cfg = ttfm.ModelConfig(**_SERVE)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(**_SERVE))
    tp = _convert(jp)
    prompt = np.random.default_rng(1).integers(0, 64, (1, 8))
    ccfg = CacheConfig(num_kv_heads=2, head_dim=16, page_size=8,
                       total_pages=16, max_seqs=2, max_pages_per_seq=4,
                       dtype="float32")
    caches = [PagedKVCache.create(ccfg, "cpu") for _ in range(2)]
    for c in caches:
        c.page_tables[0, :2] = torch.tensor([1, 2])
    with torch.no_grad():
        full = ttfm.forward(tp, _t(prompt), cfg)
        pre, kv = ttfm.prefill(tp, _t(prompt), cfg)
        for c, (k, v) in zip(caches, kv):
            c.write_prompt(0, k[0].transpose(0, 1), v[0].transpose(0, 1))
        np.testing.assert_allclose(pre[0].numpy(), full[0, -1].numpy(),
                                   atol=2e-4, rtol=1e-3)
        tok = torch.argmax(pre[0])[None]
        ext = torch.cat([_t(prompt), tok[None]], dim=1)
        want = ttfm.forward(tp, ext, cfg)[0, -1]
        step, _ = ttfm.decode_step(tp, tok, torch.tensor([8], dtype=torch.int32),
                                   caches, torch.tensor([0], dtype=torch.int32),
                                   cfg)
    np.testing.assert_allclose(step[0].numpy(), want.numpy(), atol=2e-3,
                               rtol=2e-2)
    assert int(torch.argmax(step[0])) == int(torch.argmax(want))
    jwant = jax.jit(lambda p, t: jtfm.forward(p, t, jtfm.ModelConfig(
        **_SERVE)))(jp, jnp.asarray(ext.numpy().astype(np.int32)))
    np.testing.assert_allclose(np.asarray(jwant)[0, -1], want.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_serving_guard_rejects_dropful_capacity():
    """E 8, top-2 at capacity factor 1.25 < E / top_k: every serving entry
    point raises, as the reference's prefill does; training does not."""
    cfg = ttfm.ModelConfig(**dict(_CFG, num_layers=1, moe_experts=8,
                                  moe_capacity_factor=1.25))
    tp = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jtfm.ModelConfig(
        **dict(_CFG, num_layers=1, moe_experts=8, moe_capacity_factor=1.25)))
    with pytest.raises(ValueError, match="drop-free"):
        jtfm.prefill(jp, jnp.zeros((1, 8), jnp.int32),
                     jtfm.ModelConfig(**dict(_CFG, num_layers=1,
                                             moe_experts=8)))
    ccfg = CacheConfig(num_kv_heads=2, head_dim=16, page_size=8,
                       total_pages=16, max_seqs=4, max_pages_per_seq=4,
                       dtype="float32")
    caches = [PagedKVCache.create(ccfg, "cpu")]
    one = torch.zeros(1, dtype=torch.int32)
    calls = [
        lambda: ttfm.prefill(tp, torch.zeros(1, 8, dtype=torch.long), cfg),
        lambda: ttfm.prefill_chunk(tp, torch.zeros(1, 8, dtype=torch.long),
                                   0, 8, caches, 0, cfg),
        lambda: ttfm.decode_step(tp, one.long(), one, caches, one, cfg),
        lambda: ttfm.decode_verify(tp, torch.zeros(1, 2, dtype=torch.long),
                                   one, caches, one, cfg),
        lambda: ttfm.decode_step_seq(tp, one.long(), one, [caches], one, cfg,
                                     None),
        lambda: teng.Engine(tp, cfg, ccfg, teng.EngineConfig(max_batch=2)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="drop-free"):
            call()
    loss = ttfm.loss_fn(tp, torch.zeros(1, 9, dtype=torch.long), cfg)
    assert torch.isfinite(loss)


def test_quantize_weights_leaves_router_and_experts(jparams):
    """int8 weight-only quantization: the attention projections become
    {q, s}, bit for bit the reference's; the router and the 3-D experts
    stay as they are."""
    tp = _convert(jparams)
    jq = jax.jit(jtfm.quantize_weights)(jparams)
    tq = ttfm.quantize_weights(tp)
    for jl, tl, l0 in zip(jq["layers"], tq["layers"], tp["layers"]):
        for name in ("wr", "w_gate", "w_up", "w_down"):
            assert tl[name] is l0[name]
            assert not isinstance(jl[name], dict)
        assert np.array_equal(np.asarray(jl["wq"]["q"]),
                              tl["wq"]["q"].numpy())


def test_tp_forward_replicates_the_bank(jparams):
    """TP 2 on CPU ranks: every rank's tree holds the whole bank and
    router; the forward within 1e-4 of max |logit| of the unsharded one.
    Planted fault: the bank split over the ranks like a dense MLP
    (column- and row-parallel, so no rank holds a replica) misses that."""
    tp = _convert(jparams)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 64, (2, 24)))
    tpm = make_mesh(model=2, devices="cpu").axis("model")
    shardings.check_divisible(TCFG, 2)
    ranks = shardings.shard_params(tp, tpm)
    for r in ranks:
        for name in ("wr", "w_gate", "w_up", "w_down"):
            assert torch.equal(r["layers"][1][name], tp["layers"][1][name])
        assert r["layers"][0]["wq"].shape == (32, 16)
    with torch.no_grad():
        want = ttfm.forward(tp, toks, TCFG)
        got = ttfm.forward(ranks, toks, TCFG, tp=tpm)
        tol = 1e-4 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol
        split = []
        for r in range(2):
            t = shardings.param_slices(tp, r, 2)
            for lp, full in zip(t["layers"], tp["layers"]):
                h = full["w_gate"].shape[-1] // 2
                part = slice(r * h, (r + 1) * h)
                lp.update(w_gate=full["w_gate"][..., part],
                          w_up=full["w_up"][..., part],
                          w_down=full["w_down"][:, part])
            split.append(t)
        fault = ttfm.forward(split, toks, TCFG, tp=tpm)
    assert float((fault - want).abs().max()) > 10 * tol


def test_engine_modes_agree_on_moe_model():
    """The drop-free MoE model served greedily: K-step async rounds,
    chunked prefill, the prefix cache (a repeated prompt hits) and
    speculation with itself as draft all give the one-token engine's
    streams; the first request's stream is the teacher-forced greedy
    continuation."""
    cfg = ttfm.ModelConfig(**dict(_SERVE, vocab_size=128, dim=64,
                                  head_dim=32, mlp_hidden=128))
    tp = ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    ccfg = CacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                       total_pages=64, max_seqs=6, max_pages_per_seq=8,
                       dtype="float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 127, n).tolist() for n in (23, 40, 9)]
    prompts.append(prompts[1])

    def serve(**kw):
        draft = kw.pop("draft", None)
        eng = teng.Engine(tp, cfg, ccfg, teng.EngineConfig(max_batch=3, **kw),
                          draft=draft)
        for i, p in enumerate(prompts):
            eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=6))
        out = {f.rid: f.new_tokens for f in eng.run()}
        return out, eng

    base, _ = serve()
    with torch.no_grad():
        toks = list(prompts[0])
        for _ in range(6):
            toks.append(int(torch.argmax(ttfm.forward(
                tp, torch.tensor([toks]), cfg)[0, -1])))
    assert base[0] == toks[len(prompts[0]):]
    assert serve(decode_steps=4)[0] == base
    assert serve(chunk_size=16)[0] == base
    got, eng = serve(prefix_cache=True)
    assert got == base and eng._pcache.stats()["hits"] >= 1
    got, eng = serve(speculate_k=3, draft=(tp, cfg))
    assert got == base and eng.spec_stats()["proposed"] > 0


def test_expert_slices_split_on_the_expert_dim(layer):
    """expert_pspecs: the router replicated, the experts split on dim 0;
    rank r of 2 holds experts [2r, 2r + 2)."""
    _, tl = layer
    assert tmoe.expert_pspecs() == dict(wr=None, w_gate=0, w_up=0, w_down=0)
    for r in range(2):
        s = tmoe.expert_slices(tl, r, 2)
        assert s["wr"] is tl["wr"]
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(s[name], tl[name][2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="experts"):
        tmoe.expert_slices(tl, 0, 3)
    # the expert-parallel MLP over 2 CPU ranks: the unsharded output
    ep = make_mesh(expert=2, devices="cpu").axis("expert")
    h = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, 16, 32)).astype(np.float32))
    sharded = tmoe.shard_experts(dict(layers=[tl]), ep)["layers"][0]
    want, aux = tmoe.moe_mlp(tl, h)
    got, aux_ep = tmoe.moe_mlp(sharded, h, ep=ep)
    assert torch.equal(got, want) and torch.equal(aux, aux_ep)


def test_model_config_fields_match_reference():
    """The MoE fields and defaults are the reference's."""
    tf = {f.name: f.default for f in dataclasses.fields(ttfm.ModelConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jtfm.ModelConfig)}
    for name in ("moe_experts", "moe_top_k", "moe_capacity_factor"):
        assert tf[name] == jf[name]
