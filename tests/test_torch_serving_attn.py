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

from tpu_flash.ops import oracle as joracle
from tpu_flash.quant import qarray as jq
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


# With e4m3 Q the port dots q̂·k̂ on the fp8 products and applies the row
# factor to the float32 score; the reference's kernel folds that factor
# into a bf16 Q (its TPU has no fp8 unit), which moves its lse off the
# matched-bit-width oracle by more than the 1e-3 tolerance here, and its o
# by up to 2e-2 on causal rows with few keys. The largest port-vs-reference
# gaps the e4m3 cases of this file show (ROADMAP §C, a known deviation)
# stay under these bounds.
E4M3_O_TOL, E4M3_LSE_GAP = dict(atol=1e-2, rtol=2e-2), 4e-3


def _run(j, t, jkw=None, **kw):
    """(reference, port, matched) outputs: matched is the reference's f32
    oracle on matched-bit-width inputs with e4m3 Q, else None."""
    jo, jl = jsa.serving_flash_attention(*j, return_lse=True, **kw,
                                         **(jkw or {}), **_BLK)
    to, tl = tsa.serving_flash_attention(*t, return_lse=True, **kw)
    matched = (_matched_oracle(j, kw.get("schedule") == "causal")
               if kw.get("q_dtype") == "float8_e4m3fn" else None)
    return (np.asarray(jo, np.float32), np.asarray(jl)), (
        to_numpy(to), tl.numpy()), matched


def _matched_oracle(j, causal):
    """The reference's oracle on Q quantized to e4m3 per token (the
    kernel's staging) and the reference's dequantized cache."""
    q, kq, vq = j
    qf = jq.dequantize(jq.quantize(q * q.shape[-1] ** -0.5, "float8_e4m3fn",
                                   axis=-1))
    g = q.shape[1] // kq.values.shape[1]
    kf, vf = (jnp.repeat(jq.dequantize(a), g, 1) for a in (kq, vq))
    o, lse = joracle.dense_dpa(qf, kf, vf, scale=1.0, causal=causal)
    return np.asarray(o, np.float32), np.asarray(lse)


def _assert_close(j, t, matched=None, atol=5e-3, rtol=1e-2, lse_atol=1e-3):
    """o and lse against the reference's kernel. With e4m3 Q (``matched``)
    o and lse against the oracle at the same tolerances, and within
    :data:`E4M3_O_TOL` / :data:`E4M3_LSE_GAP` of the kernel."""
    (jo, jl), (to, tl) = j, t
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), fin)
    if matched is None:
        np.testing.assert_allclose(to, jo, atol=atol, rtol=rtol)
        np.testing.assert_allclose(tl[fin], jl[fin], atol=lse_atol)
        return
    np.testing.assert_allclose(to, jo, **E4M3_O_TOL)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=E4M3_LSE_GAP)
    mo, ml = matched
    np.testing.assert_allclose(to, mo, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(np.isfinite(ml), fin)
    np.testing.assert_allclose(tl[fin], ml[fin], atol=lse_atol)


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
    dict(kv_resident=True, schedule="local", radius=8),
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
    (dict(isolate="noexp"), "north star")])
def test_serving_unported_raise(kw, match):
    _, t = _caches(7, 2, 2, 64, 64, "int8")
    with pytest.raises(NotImplementedError, match=match):
        tsa.serving_flash_attention(*t, q_dtype="int8", **kw)


@pytest.mark.parametrize("radius", [0, 30])
def test_serving_shift_matches_reference(radius):
    """``shift`` (the shifted schedule, radius 0 and 30), refused before
    the ring, gives the reference's o and lse over the same int8 cache."""
    j, t = _caches(7, 2, 2, 256, 128, "int8")
    _assert_close(*_run(j, t, q_dtype="int8", schedule="shifted", shift=2,
                        radius=radius))


def test_serving_plain_path_counts_no_launch():
    _, t = _caches(8, 2, 2, 64, 64, "int8")
    kernels.reset_launches()
    tsa.serving_flash_attention(*t, q_dtype="int8", schedule="causal")
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.parametrize("q_mode,dtype", [("fp8", "float8_e4m3fn"),
                                          ("int8", "int8")])
@pytest.mark.parametrize("tensor_k_scale", [False, True])
def test_stage_q_plain_bytes_and_factors(q_mode, dtype, tensor_k_scale):
    """The kernel's Q staging as the plain path states it: the bytes of the
    reference's ``quantize(q, dtype, axis=-1)`` and the row factors
    f = (σq·c)·skf in float32, bit for bit (skf: a per-row K scale of
    kv_scale="tensor", else 1); e4m3 Q reaches the fp8 products unfolded."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((4, 50, 96)).astype(np.float32)
    q[1, 3] = 0.0  # the 1e-12 floor
    skf_np = (rng.uniform(0.5, 2.0, (4, 1, 1)).astype(np.float32)
              if tensor_k_scale else np.float32(1.0))
    c = np.float32(96 ** -0.5 * 1.4426950408889634)
    ja = jq.quantize(jnp.asarray(q), dtype, axis=-1)
    want_f = (np.asarray(ja.scales) * c) * skf_np
    skf = torch.from_numpy(skf_np) if tensor_k_scale else 1.0
    op, f = tsa._stage_q_plain(torch.from_numpy(q), q_mode, float(c), skf)
    np.testing.assert_array_equal(op.view(torch.uint8).numpy(),
                                  np.asarray(ja.values).view(np.uint8))
    np.testing.assert_array_equal(f.numpy(), want_f[..., 0])
