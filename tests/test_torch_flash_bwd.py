"""Port parity: the flash backward (B4 dQ, B5 dK/dV) on the CPU.

The same numpy inputs go through ``jax.grad`` of the reference's
``dense_fa`` (Pallas in interpret mode, as ``tests/test_grad.py`` runs it;
at d ≤ 64 the reference takes its transposed kernels B10a/B10b, at d 128
B4/B5) and through torch autograd of the port's ``dense_fa``, whose CPU
tensors take the plain backward. The CUDA kernels are held against that
plain backward on the card in ``tests/test_torch_kernels.py``.

Tolerances: float32 atol 3e-4 / rtol 1e-3, ``test_grad.py``'s own against
its oracle (both sides accumulate in float32 in another order). bf16: see
:func:`test_bf16_grads_match_reference`.
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


@pytest.mark.parametrize("kw,item", [(dict(quant="dp"), "A8"),
                                     (dict(split=2), "A8")])
def test_unported_backward_options_raise(kw, item):
    q, k, v, o, lse, do, _, sched = _prescaled(4, 64, 32, True, False)
    args = [torch.from_numpy(x) for x in (q, k, v, o, lse, do)]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tflash_bwd.flash_backward(*args, None, sched, **kw)


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
