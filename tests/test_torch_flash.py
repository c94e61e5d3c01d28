"""Port parity: block schedules, the f32 oracle and the flash forward (B1).

The same numpy inputs (made from a seed) go through the reference function
on the CPU (Pallas in interpret mode, as the reference's own tests run it)
and through the port's plain path. The CUDA kernels are held against these
plain paths on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import flash as jflash
from tpu_flash.ops import oracle as joracle
from tpu_flash.ops import schedule as jsched
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import oracle as toracle
from tpu_flash_torch.ops import schedule as tsched
from tpu_flash_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)

# f32: both sides accumulate in float32 in another order (~1e-6 apart);
# bf16: P is rounded to bf16 against the running max (reference tiles) or
# the row max (port), one bf16 ulp of P ≈ 4e-3 relative.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(seed, b, hq, hkv, n_q, n_kv, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, n_q, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, n_kv, d)).astype(np.float32)
    jx = [jnp.asarray(x, dtype) for x in (q, k, v)]
    tx = [to_torch(np.asarray(x)) for x in jx]
    return jx, tx


@pytest.mark.parametrize("kind", ["dense", "causal"])
@pytest.mark.parametrize("n_q,n_kv,bq,bkv", [
    (256, 256, 64, 128), (200, 328, 128, 64), (100, 60, 64, 32)])
def test_schedule_matches_reference(kind, n_q, n_kv, bq, bkv):
    """Block-visit math and masks are identical (exact: integer logic)."""
    jcls = jsched.CausalSchedule if kind == "causal" else jsched.Schedule
    tcls = tsched.CausalSchedule if kind == "causal" else tsched.Schedule
    js, ts = jcls(n_q, n_kv, bq, bkv), tcls(n_q, n_kv, bq, bkv)
    for attr in ("n_q_pad", "n_kv_pad", "num_q_blocks", "num_kv_blocks",
                 "max_kv_steps", "max_q_steps", "has_mask"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    for i in range(ts.num_q_blocks):
        for s in range(ts.max_kv_steps):
            assert ts.kv_block_index(i, s) == int(js.kv_block_index(i, s))
            assert ts.step_needed(i, s) == bool(js.step_needed(i, s))
            ju = js.block_unmasked(i, s)
            assert ts.block_unmasked(i, s) == (None if ju is None else bool(ju))
    for j in range(ts.num_kv_blocks):
        for s in range(ts.max_q_steps):
            assert ts.q_block_index(j, s) == int(js.q_block_index(j, s))
            assert ts.q_step_needed(j, s) == bool(js.q_step_needed(j, s))
    qp, kp = np.arange(ts.n_q_pad)[:, None], np.arange(ts.n_kv_pad)[None, :]
    jm = js.mask(jnp.asarray(qp), jnp.asarray(kp))
    tm = ts.mask(torch.as_tensor(qp), torch.as_tensor(kp))
    assert (jm is None) == (tm is None)
    if tm is not None:
        np.testing.assert_array_equal(
            np.broadcast_to(np.asarray(jm), (ts.n_q_pad, ts.n_kv_pad)),
            np.broadcast_to(tm.numpy(), (ts.n_q_pad, ts.n_kv_pad)))


@pytest.mark.parametrize("causal,n_q,n_kv", [
    (False, 96, 96), (True, 96, 96), (True, 40, 96), (True, 96, 40)])
def test_dense_dpa_matches_reference(causal, n_q, n_kv):
    """f32 oracle vs the reference oracle (HIGHEST-precision einsum): 1e-5."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1, 2, 2, n_q, n_kv, 32,
                                         jnp.float32)
    jo, jl = joracle.dense_dpa(jq, jk, jv, causal=causal)
    to, tl = toracle.dense_dpa(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    finite = np.isfinite(np.asarray(jl))
    np.testing.assert_array_equal(np.isfinite(tl.numpy()), finite)
    np.testing.assert_allclose(tl.numpy()[finite], np.asarray(jl)[finite],
                               atol=1e-5)


# (name, hq, hkv, n_q, n_kv, d, causal, dtype)
_FA_CASES = [
    ("dense", 2, 2, 128, 128, 64, False, "float32"),
    ("causal", 2, 2, 128, 128, 64, True, "float32"),
    ("gqa_causal", 4, 2, 128, 128, 32, True, "float32"),
    ("ragged_dense", 2, 1, 100, 100, 64, False, "float32"),
    ("causal_nq_lt_nkv", 2, 2, 48, 160, 64, True, "float32"),
    ("causal_nq_gt_nkv", 2, 2, 160, 48, 64, True, "float32"),
    ("bf16_gqa_causal", 4, 2, 200, 200, 64, True, "bfloat16"),
    ("bf16_dense", 2, 2, 128, 128, 64, False, "bfloat16"),
]


@pytest.mark.parametrize("case", _FA_CASES, ids=[c[0] for c in _FA_CASES])
def test_flash_plain_matches_reference(case):
    """B1 plain path vs the reference flash_attention (o and natural-log
    lse; fully masked rows o = 0, lse = −inf on both sides)."""
    _, hq, hkv, n_q, n_kv, d, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 1, hq, hkv, n_q, n_kv, d,
                                         jnp.dtype(dtype))
    jo, jl = jflash.dense_fa(jq, jk, jv, causal=causal, return_lse=True,
                             block_q=128, block_kv=128)
    to, tl = tflash.dense_fa(tq, tk, tv, causal=causal, return_lse=True,
                             block_q=128, block_kv=128)
    assert to.dtype == tq.dtype and to.shape == tq.shape
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                               atol=TOL[dtype])
    jl = np.asarray(jl)
    finite = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl.numpy()), finite)
    np.testing.assert_allclose(tl.numpy()[finite], jl[finite], atol=TOL[dtype])


def test_flash_plain_matches_oracle_scale():
    """An explicit ``scale`` reaches the softmax (vs the f32 oracle, which
    takes the same scale): f32 1e-4."""
    _, (tq, tk, tv) = _inputs(3, 1, 2, 2, 64, 64, 32, jnp.float32)
    o = tflash.flash_attention(tq, tk, tv, schedule="causal", scale=0.3)
    ref, _ = toracle.dense_dpa(tq, tk, tv, causal=True, scale=0.3)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(bound_max=True), dict(radius=4),
                                dict(q_dtype="int8"), dict(schedule="local")])
def test_flash_unported_options_raise(kw):
    _, (tq, tk, tv) = _inputs(4, 1, 1, 1, 16, 16, 32, jnp.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tflash.flash_attention(tq, tk, tv, **kw)
