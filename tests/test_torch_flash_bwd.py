"""Port parity: the flash backward (B4 dQ, B5 dK/dV) on the CPU.

The same numpy inputs go through ``jax.grad`` of the reference's
``dense_fa`` (Pallas in interpret mode, as ``tests/test_grad.py`` runs it;
at d ≤ 64 the reference takes its transposed kernels B10a/B10b, at d 128
B4/B5) and through torch autograd of the port's ``dense_fa``, whose CPU
tensors take the plain backward. The CUDA kernels are held against that
plain backward on the card in ``tests/test_torch_kernels.py``.

The port's ``flash_backward`` is also held against the reference's on
identical prescaled operands: the dense, causal, local, local_causal,
circulant and block-diagonal schedules, and ``quant="dp"`` (the int8 dp
product), with ``split`` and the dp flag validated as the reference
validates them.

Tolerances: float32 atol 3e-4 / rtol 1e-3, ``test_grad.py``'s own against
its oracle (both sides accumulate in float32 in another order). bf16: see
:func:`test_bf16_grads_match_reference`; dp: see
:func:`test_dp_grads_match_oracle` and :data:`TOL_DP_VS_REFERENCE`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import flash as jflash
from tpu_flash.ops import flash_bwd as jflash_bwd
from tpu_flash.ops import schedule as jsched
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import flash_bwd as tflash_bwd
from tpu_flash_torch.ops import oracle as toracle
from tpu_flash_torch.ops import schedule as tsched
from tpu_flash_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)

_BLK = dict(block_q=128, block_kv=128)


def _inputs(seed, hq, hkv, n_q, n_kv, d, dv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, n_q, d))
    k = rng.standard_normal((1, hkv, n_kv, d))
    v = rng.standard_normal((1, hkv, n_kv, dv or d))
    w = rng.standard_normal((1, hq, n_q, dv or d)).astype(np.float32)
    jx = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return jx, [to_torch(np.asarray(x), device="cpu") for x in jx], w


def _grads(jx, tx, w, causal, with_lse=False):
    """(reference grads, port grads) of sum(o·w) [+ 0.3·sum(lse)]."""
    jw = jnp.asarray(w)

    def jloss(q, k, v):
        o, lse = jflash.dense_fa(q, k, v, causal=causal, return_lse=True,
                                 **_BLK)
        loss = jnp.sum(o.astype(jnp.float32) * jw)
        return loss + 0.3 * jnp.sum(lse) if with_lse else loss

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*jx)
    tx = [x.clone().requires_grad_(True) for x in tx]
    o, lse = tflash.dense_fa(*tx, causal=causal, return_lse=True, **_BLK)
    loss = (o.float() * torch.from_numpy(w)).sum()
    if with_lse:
        loss = loss + 0.3 * lse.sum()
    loss.backward()
    return ([np.asarray(g, np.float32) for g in jg],
            [to_numpy(x.grad) for x in tx])


# (name, hq, hkv, n_q, n_kv, d, dv, causal)
_F32_CASES = [
    ("dense_256_d32", 2, 2, 256, 256, 32, None, False),
    ("dense_ragged_200_d32", 2, 2, 200, 200, 32, None, False),
    ("causal_256_d32", 2, 2, 256, 256, 32, None, True),
    ("causal_ragged_200_d32", 2, 2, 200, 200, 32, None, True),
    ("causal_256_d128", 2, 2, 256, 256, 128, None, True),
    ("gqa_4_2_causal", 4, 2, 200, 200, 32, None, True),
    ("causal_nq_lt_nkv", 2, 2, 48, 160, 32, None, True),
    ("causal_nq_gt_nkv", 2, 2, 160, 48, 32, None, True),
    ("dense_dv_neq_d", 2, 2, 256, 256, 32, 64, False),
]


@pytest.mark.parametrize("case", _F32_CASES, ids=[c[0] for c in _F32_CASES])
def test_grads_match_reference(case):
    """dq, dk, dv of sum(o·w) through the Function and the plain backward
    vs jax.grad through the reference's kernels. With n_q > n_kv the first
    rows see no key (o = 0, lse = −inf): their grads are exactly 0."""
    _, hq, hkv, n_q, n_kv, d, dv, causal = case
    jx, tx, w = _inputs(0, hq, hkv, n_q, n_kv, d, dv)
    jg, tg = _grads(jx, tx, w, causal)
    for name, a, b in zip("qkv", tg, jg):
        assert np.isfinite(a).all(), f"d{name} not finite"
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=1e-3,
                                   err_msg=f"d{name} mismatch")
    if n_q > n_kv and causal:
        assert not tg[0][:, :, : n_q - n_kv].any()


def test_lse_cotangent_matches_reference():
    """sum(o) + 0.3·sum(lse) (``test_grad.py:111-128``): the lse cotangent
    folds into Δ on both sides."""
    jx, tx, _ = _inputs(1, 1, 1, 128, 128, 32)
    w = np.ones((1, 1, 128, 32), np.float32)
    jg, tg = _grads(jx, tx, w, causal=False, with_lse=True)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=1e-3,
                                   err_msg=f"d{name} mismatch")


def test_bf16_grads_match_reference():
    """bf16 GQA causal, d 64. Both sides round P, dS and dO at the same
    points, but each rounding sees inputs that differ in the last bits
    (the forward's lse and o come from tiles of another shape), and the
    reference rounds each head's dK/dV to bf16 before the group sum where
    the port sums in float32 and rounds once. So the grads agree within a
    few bf16 ulps, not bit for bit: relative-to-max error ≤ 1e-2 (one bf16
    ulp is 2⁻⁸ ≈ 3.9e-3 of the value)."""
    jx, tx, w = _inputs(2, 4, 2, 192, 192, 64, dtype=jnp.bfloat16)
    jg, tg = _grads(jx, tx, w, causal=True)
    for name, a, b in zip("qkv", tg, jg):
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
        assert rel <= 1e-2, (name, rel)


def _prescaled(seed, n, d, causal, with_dlse):
    """Prescaled (BH, n, d) operands and the port's plain forward's o/lse,
    as numpy, for both backward functions."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((2, n, d)).astype(np.float32)
                   for _ in range(4))
    q = q * (d ** -0.5 * tflash.LOG2E)
    sched = tsched.CausalSchedule(n, n, 128, 128) if causal else \
        tsched.Schedule(n, n, 128, 128)
    o, lse = tflash._flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                     sched, 1, 1)
    dlse = rng.standard_normal((2, n)).astype(np.float32) if with_dlse else None
    return q, k, v, o.numpy(), lse.numpy(), do, dlse, sched


@pytest.mark.parametrize("d,causal,with_dlse", [
    (32, True, False), (128, True, True), (128, False, False)])
def test_flash_backward_matches_reference(d, causal, with_dlse):
    """The port's flash_backward vs the reference's, on identical
    prescaled q, k, v, o, lse, do (and dlse): d 32 takes the reference's
    transposed kernels, d 128 its B4/B5."""
    q, k, v, o, lse, do, dlse, sched = _prescaled(3, 256, d, causal,
                                                  with_dlse)
    jcls = jsched.CausalSchedule if causal else jsched.Schedule
    jout = jflash_bwd.flash_backward(
        *(jnp.asarray(x) for x in (q, k, v, o, lse, do)),
        None if dlse is None else jnp.asarray(dlse), jcls(256, 256, 128, 128),
        interpret=True)
    tout = tflash_bwd.flash_backward(
        *(torch.from_numpy(x) for x in (q, k, v, o, lse, do)),
        None if dlse is None else torch.from_numpy(dlse), sched)
    for name, a, b in zip("qkv", tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4,
                                   rtol=1e-3, err_msg=f"d{name} mismatch")


def _pad_rows(x, n, fill=0.0):
    """numpy (rows, m, ·) → (rows, n, ·), the reference's padded layout."""
    pad = [(0, 0), (0, n - x.shape[1])] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pad, constant_values=fill)


def _ref_backward(args, jsched, hq, hkv, quant=None):
    """The reference's flash_backward (Pallas in interpret mode) on the
    port's unpadded operands: rows padded to its blocks (padded lse rows
    −inf), K/V expanded to the q heads, dK/dV summed over each group."""
    q, k, v, o, lse, do = args
    g, n_q, n_kv = hq // hkv, q.shape[1], k.shape[1]
    nq_pad, nkv_pad = jsched.n_q_pad, jsched.n_kv_pad
    qs = [_pad_rows(x, nq_pad) for x in (q, o, do)]
    kv = [_pad_rows(np.repeat(x, g, axis=0), nkv_pad) for x in (k, v)]
    out = jflash_bwd.flash_backward(
        *(jnp.asarray(x) for x in (qs[0], kv[0], kv[1], qs[1])),
        jnp.asarray(_pad_rows(lse, nq_pad, -np.inf)), jnp.asarray(qs[2]),
        None, jsched, interpret=True, quant=quant)
    dq, dk, dv = (np.asarray(x, np.float32) for x in out)
    return (dq[:, :n_q], dk[:, :n_kv].reshape(hkv, g, n_kv, -1).sum(1),
            dv[:, :n_kv].reshape(hkv, g, n_kv, -1).sum(1))


def _band_inputs(seed, hq, hkv, n_q, n_kv, d, sched):
    """Prescaled float32 operands at GQA hq/hkv, the port's plain forward's
    o/lse under ``sched`` and a random dO, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((hq, n_q, d)).astype(np.float32) * (
        d ** -0.5 * tflash.LOG2E)
    k, v = (rng.standard_normal((hkv, n_kv, d)).astype(np.float32)
            for _ in range(2))
    o, lse = tflash._flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                     sched, hq, hkv)
    do = rng.standard_normal((hq, n_q, d)).astype(np.float32)
    return q, k, v, o.numpy(), lse.numpy(), do


# (name, schedule, n, radius or section, blocks): GQA 4/2 and a ragged n
# (200, padded to 256 on the reference's side) in each; the circulant's K/V
# are the halo-extended n + 2r rows
_BAND_CASES = [
    ("local", "local", 200, 40, 128),
    ("local_causal", "local_causal", 200, 40, 128),
    ("circulant", "circulant", 200, 20, 128),
    ("block", "block", 200, 64, 64),
]


def _schedules(schedule, n, width, blk):
    kw = (dict(section=width) if schedule == "block"
          else dict(radius=width))
    if schedule in ("local", "local_causal"):
        kw["causal"] = schedule == "local_causal"
    cls = {"local": "LocalSchedule", "local_causal": "LocalSchedule",
           "circulant": "CirculantSchedule",
           "block": "BlockDiagonalSchedule"}[schedule]
    return (getattr(tsched, cls)(n, n, blk, blk, **kw),
            getattr(jsched, cls)(n, n, blk, blk, **kw))


@pytest.mark.parametrize("case", _BAND_CASES, ids=[c[0] for c in _BAND_CASES])
def test_band_backward_matches_reference(case):
    """The port's flash_backward vs the reference's for the local,
    local_causal, circulant (halo-extended K/V) and block-diagonal
    schedules, GQA 4/2, ragged n: f32 atol 3e-4 + rtol 1e-3
    (``test_grad.py``'s own tolerance against its oracle)."""
    _, schedule, n, width, blk = case
    tsch, jsch = _schedules(schedule, n, width, blk)
    n_kv = tsch.kv_len
    args = _band_inputs(6, 4, 2, n, n_kv, 32, tsch)
    want = _ref_backward(args, jsch, 4, 2)
    got = tflash_bwd.flash_backward(*(torch.from_numpy(x) for x in args),
                                    None, tsch, hq=4, hkv=2)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=3e-4, rtol=1e-3,
                                   err_msg=f"d{name} mismatch")


def _rel_max(a, b):
    """max |a − b| / max |b|: the reference's dp gate (``test_grad.py``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
def test_dp_grads_match_oracle(causal):
    """``bwd_quant="dp"`` grads of sum(o·w) vs the f32 oracle's, on the
    reference's own ``test_bwd_quant_dp`` inputs (its rng seed 0 draws q, k,
    v, then w) and gate: dq and dk within 2.5e-2 and dv (the exact path)
    within 1e-3 of the largest grad. The band kinds' dp is held against
    the reference's dp grads (:func:`test_dp_matches_reference`)."""
    rng = np.random.default_rng(0)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((1, 2, 256, 128))
                                   .astype(np.float32)) for _ in range(4))

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs) * w).sum().backward()
        return [x.grad.numpy() for x in xs]

    got = grads(lambda a, b, c: tflash.flash_attention(
        a, b, c, schedule="causal" if causal else "dense", bwd_quant="dp",
        **_BLK))
    want = grads(lambda a, b, c: toracle.blockwise_dpa(
        a, b, c, causal=causal)[0])
    for name, a, b, tol in zip("qkv", got, want, (2.5e-2, 2.5e-2, 1e-3)):
        assert _rel_max(a, b) <= tol, (name, _rel_max(a, b))


def _sv_channel_off(dp_operands):
    """dp_operands with σv of channel 0 doubled where dO is scaled but v̂
    kept: dp_raw takes channel 0's products twice."""
    def faulted(q, v, do, delta, hq, hkv):
        off = torch.ones(v.shape[-1])
        off[0] = 2.0
        v8, _, _, _, _ = dp_operands(q, v, do, delta, hq, hkv)
        _, do8, qs, sdo, dl = dp_operands(q, v * off, do, delta, hq, hkv)
        return v8, do8, qs, sdo, dl

    return faulted


# the dp grads of the port and of the reference agree within this share of
# the largest grad (measured 3.5e-7: both quantize the same values, but the
# reference's divide is not IEEE, so a tie may round to the other int8
# value); a σv one channel off moves them by 0.16 or more
TOL_DP_VS_REFERENCE = 1e-4


@pytest.mark.parametrize("schedule", ["causal", "local_causal"])
def test_dp_matches_reference(schedule, monkeypatch):
    """``quant="dp"`` in the port's flash_backward vs the reference's on
    the same prescaled operands (d 128, GQA 4/2, ragged n 200): within
    TOL_DP_VS_REFERENCE of the largest grad, not bit for bit. A planted
    fault (σv of one channel off on the dO side) must miss by more."""
    tsch = tflash.build_schedule(schedule, 200, 200, 128, 128, radius=40)
    jsch = (jsched.CausalSchedule(200, 200, 128, 128) if schedule == "causal"
            else jsched.LocalSchedule(200, 200, 128, 128, radius=40,
                                      causal=True))
    args = _band_inputs(8, 4, 2, 200, 200, 128, tsch)
    want = _ref_backward(args, jsch, 4, 2, quant="dp")
    targs = [torch.from_numpy(x) for x in args]
    got = tflash_bwd.flash_backward(*targs, None, tsch, hq=4, hkv=2,
                                    quant="dp")
    errs = [_rel_max(a.numpy(), b) for a, b in zip(got, want)]
    assert max(errs) <= TOL_DP_VS_REFERENCE, errs
    monkeypatch.setattr(tflash_bwd, "dp_operands",
                        _sv_channel_off(tflash_bwd.dp_operands))
    bad = tflash_bwd.flash_backward(*targs, None, tsch, hq=4, hkv=2,
                                    quant="dp")
    bad_errs = [_rel_max(a.numpy(), b) for a, b in zip(bad, want)]
    assert bad_errs[0] > TOL_DP_VS_REFERENCE, bad_errs
    assert bad_errs[1] > TOL_DP_VS_REFERENCE, bad_errs


@pytest.mark.parametrize("d,dv", [(64, 64), (32, 48)])
def test_dp_ignored_at_small_widths(d, dv):
    """At d, dv ≤ 64 the reference ignores the flag: the grads equal the
    unquantized ones exactly."""
    q, k, v, o, lse, do, _, sched = _prescaled(9, 128, d, True, False)
    if dv != d:
        v, do = v[..., :dv], do[..., :dv]
        o, lse = (x.numpy() for x in tflash._flash_fwd_plain(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)),
            sched, 1, 1))
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (q, k, v, o, lse, do)]
    plain = tflash_bwd.flash_backward(*args, None, sched)
    dp = tflash_bwd.flash_backward(*args, None, sched, quant="dp")
    for a, b in zip(dp, plain):
        assert torch.equal(a, b)


def test_unknown_quant_mode_raises():
    q, k, v, o, lse, do, _, sched = _prescaled(4, 64, 32, True, False)
    args = [torch.from_numpy(x) for x in (q, k, v, o, lse, do)]
    with pytest.raises(ValueError, match="unknown bwd quant mode 'int4'"):
        tflash_bwd.flash_backward(*args, None, sched, quant="int4")


def test_split_changes_nothing():
    """split=2 (sub-tiles of 128 in blocks of 256) gives the split=None
    grads exactly: it only stages the reference's TPU sums."""
    q, k, v, o, lse, do, dlse, _ = _prescaled(10, 256, 32, True, True)
    sched = tsched.CausalSchedule(256, 256, 256, 256)
    args = [torch.from_numpy(x) for x in (q, k, v, o, lse, do, dlse)]
    for a, b in zip(tflash_bwd.flash_backward(*args, sched, split=2),
                    tflash_bwd.flash_backward(*args, sched)):
        assert torch.equal(a, b)


# (schedule class, blocks, n, split): blocks that do not split into
# 128-aligned sub-tiles, split 0, and a band whose 1024 blocks the
# reference retiles to 512 before it checks
_BAD_SPLITS = [
    ("CausalSchedule", 256, 256, 3, {}),
    ("CausalSchedule", 128, 256, 2, {}),
    ("Schedule", 256, 256, 0, {}),
    ("LocalSchedule", 1024, 1024, 8, dict(radius=64)),
]


@pytest.mark.parametrize("case", _BAD_SPLITS,
                         ids=["split3", "subtile64", "split0", "band_retile"])
def test_split_errors_match_reference(case):
    """A split that does not divide the (band-retiled) blocks into
    128-aligned sub-tiles raises the reference's ValueError, word for word."""
    cls, blk, n, split, kw = case
    tsch = getattr(tsched, cls)(n, n, blk, blk, **kw)
    jsch = getattr(jsched, cls)(n, n, blk, blk, **kw)
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((1, n, 32)).astype(np.float32)
          for _ in range(5)]
    lse = np.zeros((1, n), np.float32)
    with pytest.raises(ValueError) as want:
        jflash_bwd.flash_backward(*(jnp.asarray(x) for x in xs[:4]),
                                  jnp.asarray(lse), jnp.asarray(xs[4]), None,
                                  jsch, interpret=True, split=split)
    with pytest.raises(ValueError) as got:
        tflash_bwd.flash_backward(*(torch.from_numpy(x) for x in xs[:4]),
                                  torch.from_numpy(lse),
                                  torch.from_numpy(xs[4]), None, tsch,
                                  split=split)
    assert str(got.value) == str(want.value)


def _slab_fault(sched, axis, start, size=64):
    """``sched`` with the keys (axis "kv") or queries ("q") in [start,
    start + size) seeing nothing: the planted fault that the card's
    kernel-vs-plain check must reject."""
    class SlabFault:
        def visible(self, q_pos, k_pos):
            pos = k_pos if axis == "kv" else q_pos
            m = (pos < start) | (pos >= start + size)
            seen = sched.visible(q_pos, k_pos)
            return m if seen is None else seen & m

    return SlabFault()


@pytest.mark.parametrize("axis,moved", [("kv", "qkv"), ("q", "kv")],
                         ids=["kv_slab_left_out", "q_slab_left_out"])
def test_planted_faults_move_the_plain_backward(axis, moved):
    """The two planted faults of the card's B4/B5 check (one middle slab of
    64 keys, or of 64 queries, hidden from the causal rule) move the plain
    backward's grads by more than that check's 1e-2 of the largest grad:
    the keys' fault dq, dk and dv, the queries' fault dk and dv. So a
    kernel that dropped such a slab would fail the check."""
    hq, hkv, n, d = 4, 2, 256, 32
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, d)).astype(
        np.float32)) for b in (hq, hkv, hkv))
    q = q * (d ** -0.5 * tflash.LOG2E)
    sched = tsched.CausalSchedule(n, n, 128, 128)
    o, lse = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv)
    do = torch.from_numpy(rng.standard_normal((hq, n, d)).astype(np.float32))
    args = (q, k, v, o, lse, do, None)
    want = tflash_bwd._flash_bwd_plain(*args, sched, hq, hkv)
    faulted = tflash_bwd._flash_bwd_plain(
        *args, _slab_fault(sched, axis, n // 2), hq, hkv)
    for name, a, b in zip("qkv", faulted, want):
        rel = float((a - b).abs().max() / max(float(b.abs().max()), 1.0))
        if name in moved:
            assert rel > 1e-2, (name, rel)
