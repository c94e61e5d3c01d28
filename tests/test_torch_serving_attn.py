"""Port parity: serving-mode quantized attention (B6, and the d ≤ 64
shapes of the reference's transposed B8) over a pre-quantized cache.

The reference quantizes the cache (``quantize_kv_cache``); the port takes
the same bytes through ``qarray_from_reference`` and both attend with the
same numpy Q, the reference in interpret mode at blocks of 128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.quant import serving_attn as jsa
from tpu_flash_torch import kernels
from tpu_flash_torch.quant import serving_attn as tsa
from tpu_flash_torch.utils.convert import qarray_from_reference, to_numpy, to_torch

torch.set_num_threads(2)

_BLK = dict(block_q=128, block_kv=128)


def _caches(seed, hq, hkv, n, d, kv_dtype, kv_scale="token"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, h, n, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    jkq, jvq = jsa.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), kv_dtype,
                                     kv_scale=kv_scale)
    return (jnp.asarray(q), jkq, jvq), (
        to_torch(q, "cpu"), qarray_from_reference(jkq, "cpu"),
        qarray_from_reference(jvq, "cpu"))


def _run(j, t, jkw=None, **kw):
    jo, jl = jsa.serving_flash_attention(*j, return_lse=True, **kw,
                                         **(jkw or {}), **_BLK)
    to, tl = tsa.serving_flash_attention(*t, return_lse=True, **kw)
    return (np.asarray(jo, np.float32), np.asarray(jl)), (to_numpy(to),
                                                          tl.numpy())


def _assert_close(j, t, atol=5e-3, rtol=1e-2, lse_atol=1e-3):
    (jo, jl), (to, tl) = j, t
    np.testing.assert_allclose(to, jo, atol=atol, rtol=rtol)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), fin)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=lse_atol)


def test_quantize_kv_cache_bit_identical():
    """The cache the port writes is the reference's, byte for byte."""
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((1, 2, 100, 64)).astype(np.float32)
            for _ in range(2))
    for dt, scale in (("int8", "token"), ("float8_e4m3fn", "tensor"),
                      ("float8_e5m2", "token")):
        jkq, jvq = jsa.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), dt,
                                         kv_scale=scale)
        tkq, tvq = tsa.quantize_kv_cache(torch.from_numpy(k),
                                         torch.from_numpy(v), dt,
                                         kv_scale=scale)
        for ja, ta in ((jkq, tkq), (jvq, tvq)):
            assert ta.axis == ja.axis
            np.testing.assert_array_equal(
                ta.values.view(torch.uint8).numpy(),
                np.asarray(ja.values).view(np.uint8))
            np.testing.assert_array_equal(ta.scales.numpy(),
                                          np.asarray(ja.scales))


# The reference test's four modes (tests/test_serving_attn.py:27-32).
_MODES = [("int8", "int8", "token"),
          ("float8_e4m3fn", "float8_e4m3fn", "token"),
          ("float8_e4m3fn", "float8_e4m3fn", "tensor"),
          (None, "int8", "token")]


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("q_dtype,kv_dtype,kv_scale", _MODES)
def test_serving_matches_reference(q_dtype, kv_dtype, kv_scale, d):
    """o within atol 5e-3 + rtol 1e-2, lse within 1e-3 at n 384: the port
    decodes fp8 exactly and sums in another order; at d 64 the reference
    runs B8, whose l sums bf16 P — its own transposed-vs-standard
    tolerance (tests/test_serving_attn.py:207-211)."""
    j, t = _caches(1, 2, 2, 384, d, kv_dtype, kv_scale)
    _assert_close(*_run(j, t, q_dtype=q_dtype))


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              ("float8_e4m3fn", "float8_e5m2")])
def test_serving_causal_gqa_matches_reference(q_dtype, kv_dtype, d):
    """Causal with GQA 4/2 (and an e5m2 cache under e4m3 Q). At d 64 the
    reference is pinned to its standard, float32-l layout: B8's bf16 l
    moves lse by up to 2⁻⁸ on a row with one visible key."""
    j, t = _caches(2, 4, 2, 384, d, kv_dtype)
    _assert_close(*_run(j, t, dict(transposed=False) if d <= 64 else None,
                        q_dtype=q_dtype, schedule="causal"))


def test_serving_pv_quant_matches_reference():
    """int8 P·V (exact max): P's int8 rounding follows the running max,
    which the reference takes per 128-key tile and the port per 64, so
    single P entries round ±1/127 apart: o within 2e-2 (the reference's own
    pv_quant-vs-bf16-PV bound, tests/test_serving_attn.py:103)."""
    j, t = _caches(3, 2, 2, 384, 128, "int8")
    _assert_close(*_run(j, t, q_dtype="int8", pv_quant=True), atol=2e-2,
                  rtol=0)


@pytest.mark.parametrize("q_dtype", ["int8", "float8_e4m3fn", None])
def test_serving_exact_max_matches_reference(q_dtype):
    kv = "int8" if q_dtype in ("int8", None) else q_dtype
    j, t = _caches(4, 2, 2, 256, 128, kv)
    _assert_close(*_run(j, t, q_dtype=q_dtype, bound_max=False))


def test_serving_knobs_change_nothing():
    """The TPU staging knobs are accepted and leave the result unchanged."""
    _, t = _caches(5, 2, 2, 512, 128, "int8")
    base = tsa.serving_flash_attention(*t, q_dtype="int8")
    for kw in (dict(kv_split=2, block_kv=256), dict(bh_block=2),
               dict(transposed=True), dict(kv_resident=True)):
        assert torch.equal(tsa.serving_flash_attention(*t, q_dtype="int8",
                                                       **kw), base), kw


# Invalid combinations raise the reference's ValueError in both.
_INVALID = [
    dict(q_dtype="int8", kv_dtype="float8_e4m3fn"),
    dict(pv_quant=True, kv_dtype="float8_e4m3fn"),
    dict(pv_quant=True, bound_max=True),
    dict(bh_block=2, hkv=1),
    dict(bh_block=2, kv_split=2),
    dict(bh_block=3),
    dict(transposed=True, bh_block=2),
    dict(transposed=True, kv_resident=True),
    dict(transposed=True, pv_quant=True),
    dict(transposed=True, kv_split=2),
    dict(kv_split=3),
    dict(kv_resident=True, schedule="causal"),
    dict(kv_resident=True, pv_quant=True),
]


@pytest.mark.parametrize("kw", _INVALID, ids=[
    "-".join(k for k in kw) for kw in _INVALID])
def test_serving_invalid_knobs_raise(kw):
    kw = dict(kw)
    kv_dtype, hkv = kw.pop("kv_dtype", "int8"), kw.pop("hkv", 2)
    kw.setdefault("q_dtype", "int8" if kv_dtype == "int8" else None)
    j, t = _caches(6, 2, hkv, 256, 128, kv_dtype)
    with pytest.raises(ValueError):
        jsa.serving_flash_attention(*j, **kw, **_BLK)
    with pytest.raises(ValueError):
        tsa.serving_flash_attention(*t, **kw, **_BLK)


@pytest.mark.parametrize("kw,match", [
    (dict(isolate="noexp"), "north star"), (dict(schedule="local"), "A10"),
    (dict(radius=4), "A10"), (dict(shift=2), "A13")])
def test_serving_unported_raise(kw, match):
    _, t = _caches(7, 2, 2, 64, 64, "int8")
    with pytest.raises(NotImplementedError, match=match):
        tsa.serving_flash_attention(*t, q_dtype="int8", **kw)


def test_serving_plain_path_counts_no_launch():
    _, t = _caches(8, 2, 2, 64, 64, "int8")
    kernels.reset_launches()
    tsa.serving_flash_attention(*t, q_dtype="int8", schedule="causal")
    assert all(n == 0 for n in kernels.LAUNCHES.values())
