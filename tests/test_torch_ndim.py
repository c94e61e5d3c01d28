"""Port parity: the block-diagonal and circulant schedules, the N-d layout
utilities, the windowed/block/circulant oracles and the attention wrappers
that use them (circulant_fa, block_fa, windowed_fa, N-d dense_fa).

The same numpy inputs (made from a seed) go through the reference (Pallas in
interpret mode on the CPU) and the port's plain paths, at the shapes of the
reference's tests/test_flash.py, with its tolerances (atol 2e-5, rtol 1e-5,
float32). The B1 kernel's circulant and block-diagonal kinds are held
against the plain version on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import flash as jflash
from tpu_flash.ops import oracle as joracle
from tpu_flash.ops import schedule as jsched
from tpu_flash.utils import layout as jlayout
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import oracle as toracle
from tpu_flash_torch.ops import schedule as tsched
from tpu_flash_torch.utils import layout as tlayout

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-5)
_BLK = dict(block_q=128, block_kv=128)


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("kind,n_q,n_kv,bq,bkv,extra", [
    ("block", 256, 256, 64, 64, 128), ("block", 300, 300, 32, 64, 192),
    ("block", 384, 384, 96, 96, 192), ("block", 100, 100, 16, 16, 16),
    ("circulant", 256, 256, 128, 128, 32), ("circulant", 300, 300, 64, 128, 7),
    ("circulant", 256, 256, 128, 128, 127), ("circulant", 100, 100, 32, 16, 0),
])
def test_schedule_matches_reference(kind, n_q, n_kv, bq, bkv, extra):
    """Visit math exact to the integer for every (i, s) and (j, s), and the
    in-tile masks equal."""
    if kind == "block":
        js = jsched.BlockDiagonalSchedule(n_q, n_kv, bq, bkv, section=extra)
        ts = tsched.BlockDiagonalSchedule(n_q, n_kv, bq, bkv, section=extra)
    else:
        js = jsched.CirculantSchedule(n_q, n_kv, bq, bkv, radius=extra)
        ts = tsched.CirculantSchedule(n_q, n_kv, bq, bkv, radius=extra)
    for attr in ("n_q_pad", "n_kv_pad", "kv_len", "num_q_blocks",
                 "num_kv_blocks", "max_kv_steps", "max_q_steps", "has_mask"):
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
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    if kind == "block":  # what the plain path sees: always the section rule
        vis = ts.visible(torch.as_tensor(qp), torch.as_tensor(kp)).numpy()
        np.testing.assert_array_equal(
            vis, (qp // extra == kp // extra) & (kp < ts.kv_len))


@pytest.mark.parametrize("shape,ws,st,pd", [
    ((2, 64, 6), 16, 8, 0), ((1, 12, 12, 3), 4, 2, 1),
    ((1, 5, 6, 7, 2), (2, 3, 2), (1, 2, 3), (0, 1, 1)),
    ((1, 16, 16, 4), 8, None, 0)])
def test_window_unwindow_counts_match_reference(shape, ws, st, pd):
    """window exactly; unwindow (the adjoint, scatter-add) and window_counts
    within float32 summation order (1e-6)."""
    x, p = _r(1, *shape), None
    jw = np.asarray(jlayout.window(jnp.asarray(x), ws, stride=st, pad=pd))
    tw = tlayout.window(torch.from_numpy(x), ws, stride=st, pad=pd).numpy()
    np.testing.assert_array_equal(tw, jw)
    p = _r(2, *jw.shape)
    spatial = shape[1:-1]
    ju = jlayout.unwindow(jnp.asarray(p), spatial, ws, stride=st, pad=pd)
    tu = tlayout.unwindow(torch.from_numpy(p), spatial, ws, stride=st, pad=pd)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    # the adjoint identity <window(x), p> = <x, unwindow(p)>
    np.testing.assert_allclose(float((tw * p).sum()), float((x * tu.numpy()).sum()),
                               rtol=1e-5)
    np.testing.assert_array_equal(
        tlayout.window_counts(spatial, ws, stride=st, pad=pd,
                              device="cpu").numpy(),
        np.asarray(jlayout.window_counts(spatial, ws, stride=st, pad=pd)))


def test_oracles_match_reference():
    """windowed_dpa (1-D overlap, 2-D padded), block_dpa (2-D),
    circulant_dpa (1-D and 2-D) and N-d dense_dpa vs the reference's."""
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, 1, 64, 2, 16) for s in (1, 2, 3)))
    np.testing.assert_allclose(
        toracle.windowed_dpa(tq, tk, tv, 16, stride=8).numpy(),
        np.asarray(joracle.windowed_dpa(jq, jk, jv, 16, stride=8)), **TOL)
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, 1, 12, 12, 2, 8) for s in (4, 5, 6)))
    np.testing.assert_allclose(
        toracle.windowed_dpa(tq, tk, tv, 4, stride=2, pad=1).numpy(),
        np.asarray(joracle.windowed_dpa(jq, jk, jv, 4, stride=2, pad=1)), **TOL)
    np.testing.assert_allclose(
        toracle.block_dpa(tq, tk, tv, (4, 6)).numpy(),
        np.asarray(joracle.block_dpa(jq, jk, jv, (4, 6))), **TOL)
    for shape, w in (((1, 2, 100, 16), 31), ((1, 8, 8, 2, 16), 9)):
        (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, *shape) for s in (7, 8, 9)))
        to, tl = toracle.circulant_dpa(tq, tk, tv, w)
        jo, jl = joracle.circulant_dpa(jq, jk, jv, w)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, 1, 4, 4, 4, 2, 16) for s in (1, 2, 3)))
    to, tl = toracle.dense_dpa(tq, tk, tv)
    jo, jl = joracle.dense_dpa(jq, jk, jv)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kw", [dict(window_size=65, wrap=True),
                                dict(window_size=255, wrap=True),
                                dict(block_size=64), dict(block_size=192)])
def test_blockwise_dpa_wrap_and_block(kw):
    """blockwise_dpa's circulant (wrap) and block masks vs the reference's,
    at chunks that split the bands, and vs the port's own dense oracles."""
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, 1, 2, 384, 32) for s in (1, 2, 3)))
    to, tl = toracle.blockwise_dpa(tq, tk, tv, chunk=128, **kw)
    jo, jl = joracle.blockwise_dpa(jq, jk, jv, chunk=128, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if "wrap" in kw:
        want, _ = toracle.circulant_dpa(tq, tk, tv, kw["window_size"])
    else:
        t = lambda x: x.transpose(1, 2)
        want = t(toracle.block_dpa(t(tq), t(tk), t(tv), kw["block_size"]))
    np.testing.assert_allclose(to.numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="mutually exclusive"):
        toracle.blockwise_dpa(tq, tk, tv, window_size=3, block_size=4)


@pytest.mark.parametrize("n,w", [(256, 65), (512, 127), (256, 255)])
def test_circulant_fa_matches_reference(n, w):
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, 1, 2, n, 32) for s in (1, 2, 3)))
    to, tl = tflash.circulant_fa(tq, tk, tv, w, return_lse=True, **_BLK)
    jo, jl = jflash.circulant_fa(jq, jk, jv, w, return_lse=True, **_BLK)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    oo, ol = toracle.circulant_dpa(tq, tk, tv, w)
    np.testing.assert_allclose(to.numpy(), oo.numpy(), **TOL)
    np.testing.assert_allclose(tl.numpy(), ol.numpy(), **TOL)


@pytest.mark.parametrize("n,s", [(256, 64), (512, 128), (384, 192)])
def test_block_fa_1d_matches_reference(n, s):
    """1-D block_fa vs the reference's and vs block_dpa (whose layout is
    (b, n, h, d): transposed, the layout trap of the verify notes)."""
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(x, 1, 2, n, 32) for x in (1, 2, 3)))
    to, tl = tflash.block_fa(tq, tk, tv, s, return_lse=True, **_BLK)
    jo, jl = jflash.block_fa(jq, jk, jv, s, return_lse=True, **_BLK)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    t = lambda x: x.transpose(1, 2)
    want = t(toracle.block_dpa(t(tq), t(tk), t(tv), s))
    np.testing.assert_allclose(to.numpy(), want.numpy(), **TOL)


def test_block_fa_2d_matches_reference():
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, 1, 16, 16, 2, 16) for s in (1, 2, 3)))
    to, tl = tflash.block_fa(tq, tk, tv, 8, return_lse=True, **_BLK)
    jo, jl = jflash.block_fa(jq, jk, jv, 8, return_lse=True, **_BLK)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(to.numpy(), toracle.block_dpa(tq, tk, tv, 8).numpy(),
                               **TOL)


@pytest.mark.parametrize("case", ["1d_overlap", "2d_padded"])
def test_windowed_fa_matches_reference(case):
    if case == "1d_overlap":
        shape, ws, kw = (1, 64, 2, 16), 16, dict(stride=8, pad=0)
    else:
        shape, ws, kw = (1, 12, 12, 1, 8), 4, dict(stride=2, pad=1)
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, *shape) for s in (1, 2, 3)))
    got = tflash.windowed_fa(tq, tk, tv, ws, **kw, **_BLK)
    assert got.shape == tq.shape
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jflash.windowed_fa(jq, jk, jv, ws, **kw, **_BLK)),
        **TOL)
    np.testing.assert_allclose(
        got.numpy(), toracle.windowed_dpa(tq, tk, tv, ws, **kw).numpy(), **TOL)
    with pytest.raises(NotImplementedError, match="lse"):
        tflash.windowed_fa(tq, tk, tv, ws, return_lse=True, **kw)


@pytest.mark.parametrize("fn", ["dense", "sliding"])
def test_nd_dense_and_sliding_match_reference(fn):
    """dense_fa on a 3-D grid and sliding_fa on a 2-D one, flattened, vs
    the reference (o in the N-d layout, lse (b, h, N))."""
    shape = (1, 4, 4, 4, 2, 16) if fn == "dense" else (1, 8, 16, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, *shape) for s in (1, 2, 3)))
    call = ((lambda m, *a: m.dense_fa(*a, return_lse=True, **_BLK))
            if fn == "dense" else
            (lambda m, *a: m.sliding_fa(*a, 17, return_lse=True, **_BLK)))
    to, tl = call(tflash, tq, tk, tv)
    jo, jl = call(jflash, jq, jk, jv)
    assert to.shape == tq.shape and tl.shape == (1, 2, 64 if fn == "dense" else 128)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if fn == "dense":
        np.testing.assert_allclose(to.numpy(),
                                   toracle.dense_dpa(tq, tk, tv)[0].numpy(), **TOL)


@pytest.mark.parametrize("schedule,kw,want", [
    ("circulant", dict(radius=32), True), ("block", dict(section=128), False),
    ("block", dict(section=96), False), ("dense", {}, True),
    ("local_causal", dict(radius=8), False)])
def test_auto_bound_max_on_the_new_kinds(schedule, kw, want):
    """The reference's max policy: the norm bound for the circulant band
    (a non-causal band), the exact max for block-diagonal even where
    aligned sections leave it mask-free; the built schedule's blocks equal
    the reference's."""
    ts = tflash.build_schedule(schedule, 384, 384, 1024, 2048, **kw)
    js = jflash.build_schedule(schedule, 384, 384, 1024, 2048, **kw)
    assert (type(ts).__name__, ts.block_q, ts.block_kv) == (
        type(js).__name__, js.block_q, js.block_kv)
    assert tflash.auto_bound_max(ts) is want


def test_circulant_and_block_gradients_on_the_cpu():
    """The plain backward takes the new schedules through their visibility
    (the halo's gradient folds back through autograd): grads vs the
    reference's jax.grad within 1e-4."""
    import jax

    shape = (1, 2, 96, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(*(_r(s, *shape) for s in (1, 2, 3)))
    w = _r(4, *shape)
    for call in (lambda m, *a: m.circulant_fa(*a, 17, block_q=32, block_kv=32),
                 lambda m, *a: m.block_fa(*a, 32, block_q=32, block_kv=32)):
        xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        (call(tflash, *xs) * torch.from_numpy(w)).sum().backward()
        want = jax.grad(lambda q, k, v: (call(jflash, q, k, v) * w).sum(),
                        argnums=(0, 1, 2))(jq, jk, jv)
        for x, g in zip(xs, want):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=1e-4)
