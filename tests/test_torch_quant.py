"""Port parity: quantizers, fp8 conversion, blockwise_dpa and the quantized
forward (B7, and its d ≤ 64 route through the serving kernel).

The same numpy inputs (made from a seed) go through the reference on the
CPU (Pallas in interpret mode, blocks of 128, as its own tests run it) and
through the port's plain path. The CUDA kernel is held against the plain
path on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_flash.ops import oracle as joracle
from tpu_flash.quant import flash_q as jfq
from tpu_flash.quant import qarray as jq
from tpu_flash_torch import kernels
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import oracle as toracle
from tpu_flash_torch.quant import flash_q as tfq
from tpu_flash_torch.quant import qarray as tq
from tpu_flash_torch.utils.convert import (
    qarray_from_reference,
    to_numpy,
    to_torch,
)

torch.set_num_threads(2)

_BLK = dict(block_q=128, block_kv=128)
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0, "float8_e5m2": 57344.0,
         "int4": 7.0, "int4_halves": 7.0}
# Exact ties of each grid at scale 1 (round half to even decides them)
# and values in the fp8 subnormal range.
_TIES = {"int8": [0.5, 1.5, 2.5, -2.5, 126.5, -0.5],
         "int4": [0.5, 1.5, 2.5, -2.5, 6.5, -0.5, -6.5],
         "int4_halves": [0.5, 1.5, 2.5, -2.5, 6.5, -0.5, -6.5],
         "float8_e4m3fn": [1.0625, 1.1875, -1.0625, 1.5 * 2 ** -9,
                           2.5 * 2 ** -9, 3e-4, -2 ** -8],
         "float8_e5m2": [1.125, 1.375, -1.125, 1.5 * 2 ** -16,
                         2.5 * 2 ** -16, 3e-6, -2 ** -15]}
# o: the port decodes fp8 exactly (the reference's e4m3 subnormals are
# approximate), sums in another order and, at d ≤ 64, sums l from float32
# P where the reference's transposed kernel sums bf16 P — the reference's
# own transposed-vs-standard tolerance (tests/test_serving_attn.py:207-211);
# lse: the same, in log units.
_ATOL, _RTOL, _LSE_ATOL = 5e-3, 1e-2, 1e-3


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy() if t.element_size() == 1 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.itemsize == 1 else a


def _planted(dtype, seed=0):
    """(3, 12, 12): batch 0 has |x| = qmax on the diagonal, so every row,
    column and matrix has scale 1 and the planted ties are exact; batch 1
    is random with a zero row; batch 2 random at a large scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 12, 12)).astype(np.float32)
    x[0] *= 0.5
    idx = np.arange(12)
    x[0, idx, idx] = _QMAX[dtype] * np.where(idx % 2, -1, 1)
    ties = np.asarray(_TIES[dtype], np.float32)
    x[0, 0, 1:1 + len(ties)] = ties
    x[0, 5, 6:6 + len(ties[:4])] = ties[:4]
    x[1, 3] = 0.0
    x[2] *= 1e3
    return x


# int4 quantizers and their dequantizers (values packed along the last
# axis, in pairs or in halves), by the reference's names
_INT4 = {"int4": ("quantize_int4", "dequantize_int4", "unpack_int4"),
         "int4_halves": ("quantize_int4_halves", None, "unpack_int4_halves")}


@pytest.mark.parametrize("axis", [-1, -2, (-2, -1)], ids=["tok", "chan", "tensor"])
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn", "float8_e5m2",
                                   "int4", "int4_halves"])
def test_quantize_bit_identical(dtype, axis):
    """Values and scales bit-identical to the reference's eager quantize
    (IEEE divide, round to nearest even), ties and subnormals included; the
    int4 quantizers (a zero row, .5 ties, both packings) likewise, their
    packed bytes and the unpacked values too."""
    x = _planted(dtype)
    if dtype in _INT4:
        quant, deq, unpack = _INT4[dtype]
        ja = getattr(jq, quant)(jnp.asarray(x), axis=axis)
        ta = getattr(tq, quant)(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(ta.values.numpy(), np.asarray(ja.values))
        np.testing.assert_array_equal(ta.scales.numpy(), np.asarray(ja.scales))
        np.testing.assert_array_equal(
            getattr(tq, unpack)(ta.values).numpy(),
            np.asarray(getattr(jq, unpack)(ja.values)))
        if deq is not None:
            np.testing.assert_array_equal(getattr(tq, deq)(ta).numpy(),
                                          np.asarray(getattr(jq, deq)(ja)))
        return
    ja = jq.quantize(jnp.asarray(x), dtype, axis=axis)
    ta = tq.quantize(torch.from_numpy(x), dtype, axis=axis)
    np.testing.assert_array_equal(_bits(ta.values), _jbits(ja.values))
    np.testing.assert_array_equal(ta.scales.numpy(), np.asarray(ja.scales))
    np.testing.assert_array_equal(tq.dequantize(ta).numpy(),
                                  np.asarray(jq.dequantize(ja)))


@pytest.mark.parametrize("layout", ["int4", "int4_halves"])
def test_int4_pack_unpack_bit_identical(layout):
    """Every pair of int4 values, −8 … 7, packed as the reference packs
    them (pairwise, or in halves) into the same bytes, and unpacked back
    (sign-extended) to the same values."""
    pack = {"int4": "pack_int4", "int4_halves": "pack_int4_halves"}[layout]
    unpack = _INT4[layout][2]
    a, b = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    x = np.stack([a.ravel(), b.ravel()], -1).reshape(16, 32).astype(np.int8)
    jp = np.asarray(getattr(jq, pack)(jnp.asarray(x)))
    tp = getattr(tq, pack)(torch.from_numpy(x))
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(getattr(tq, unpack)(tp).numpy(), x)
    np.testing.assert_array_equal(np.asarray(getattr(jq, unpack)(jp)), x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_to_torch_round_trip(dtype):
    """Every bit pattern survives to_torch (ml_dtypes → torch through an
    unsigned view); to_numpy returns the same values as float32."""
    np_dt = getattr(ml_dtypes, dtype)
    view = np.uint16 if dtype == "bfloat16" else np.uint8
    raw = np.arange(np.iinfo(view).max + 1, dtype=np.int64).astype(view)
    a = raw.view(np_dt)
    t = to_torch(a, device="cpu")
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        t.view(torch.int16 if view == np.uint16 else torch.uint8).numpy()
        .view(view), raw)
    np.testing.assert_array_equal(to_numpy(t), a.astype(np.float32))


@pytest.mark.parametrize("dtype,axis", [("int8", -1),
                                        ("float8_e4m3fn", (-2, -1)),
                                        ("float8_e5m2", -2)])
def test_qarray_from_reference(dtype, axis):
    x = _planted(dtype, seed=1)
    ja = jq.quantize(jnp.asarray(x), dtype, axis=axis)
    ta = qarray_from_reference(ja, device="cpu")
    tb = tq.quantize(torch.from_numpy(x), dtype, axis=axis)
    assert ta.axis == axis and ta.values.dtype == tb.values.dtype
    np.testing.assert_array_equal(_bits(ta.values), _bits(tb.values))
    np.testing.assert_array_equal(ta.scales.numpy(), tb.scales.numpy())


def _qkv(seed, hq, hkv, n, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, n, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _both(fn_j, fn_t, arrays, jkw=None, **kw):
    jo, jl = fn_j(*(jnp.asarray(a) for a in arrays), return_lse=True, **kw,
                  **(jkw or {}), **_BLK)
    to, tl = fn_t(*(to_torch(a, "cpu") for a in arrays), return_lse=True, **kw)
    return (np.asarray(jo, np.float32), np.asarray(jl)), (to_numpy(to),
                                                          tl.numpy())


# With e4m3 Q the port applies the row factor to the float32 score of the
# fp8 products (summed as the card sums them), where the reference's kernel
# folds it into a bf16 Q (its TPU has no fp8 unit): the two lse then part
# by more than 1e-3, and o by up to 2e-2 on causal rows with few keys. The
# largest gaps the e4m3 cases of this file show (ROADMAP §C, a known
# deviation) stay under these bounds.
E4M3_O_TOL, E4M3_LSE_GAP = dict(atol=1e-2, rtol=2e-2), 4e-3


def _assert_close(j, t, matched=None):
    """o and lse against the reference's kernel. With e4m3 Q (``matched``,
    see :func:`_reference_matched`) o and lse against that oracle at the
    same tolerances, and within :data:`E4M3_O_TOL` / :data:`E4M3_LSE_GAP` of
    the reference's kernel."""
    (jo, jl), (to, tl) = j, t
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), fin)
    if matched is not None:
        np.testing.assert_allclose(to, jo, **E4M3_O_TOL)
        np.testing.assert_allclose(tl[fin], jl[fin], atol=E4M3_LSE_GAP)
        jo, jl = matched
        np.testing.assert_array_equal(np.isfinite(jl), fin)
    np.testing.assert_allclose(to, jo, atol=_ATOL, rtol=_RTOL)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=_LSE_ATOL)


def _reference_matched(arrays, q_dtype, kv_dtype, kv_scale, causal):
    """(o, lse) of the reference's f32 oracle on inputs quantized by the
    reference at the kernel's granularity (the matched-bit-width
    contract)."""
    q, k, v = (jnp.asarray(a) for a in arrays)
    qf = jq.dequantize(jq.quantize(q * q.shape[-1] ** -0.5, q_dtype, axis=-1))
    k_axis = -1 if kv_scale == "token" else (-2, -1)
    kf = jq.dequantize(jq.quantize(k, kv_dtype, axis=k_axis))
    vf = jq.dequantize(jq.quantize(v, kv_dtype, axis=-2))
    g = q.shape[1] // k.shape[1]
    o, lse = joracle.dense_dpa(qf, jnp.repeat(kf, g, 1), jnp.repeat(vf, g, 1),
                               scale=1.0, causal=causal)
    return np.asarray(o, np.float32), np.asarray(lse)


# (q_dtype, kv_dtype, kv_scale, schedule, hq, hkv, d, bound_max): the
# reference test's five modes (tests/test_quant.py:34-40) at d 128 (B7)
# dense and causal with GQA 4/2; d 64 (the serving route); the exact max;
# per-tensor K scales.
_CASES = {
    "int8_dense": ("int8", "int8", "token", "dense", 2, 2, 128, True),
    "int8_causal_gqa": ("int8", "int8", "token", "causal", 4, 2, 128, True),
    "fp8_dense": ("float8_e4m3fn",) * 2 + ("token", "dense", 2, 2, 128, True),
    "fp8_causal_gqa": ("float8_e4m3fn",) * 2 + ("token", "causal", 4, 2, 128,
                                                True),
    "e5m2q_dense": ("float8_e5m2", "float8_e4m3fn", "token", "dense", 2, 2,
                    128, True),
    "wo_int8_causal": (None, "int8", "token", "causal", 2, 2, 128, True),
    "wo_fp8_dense": (None, "float8_e4m3fn", "token", "dense", 2, 2, 128, True),
    "int8_exact_max": ("int8", "int8", "token", "dense", 2, 2, 128, False),
    "fp8_tensor_gqa": ("float8_e4m3fn",) * 2 + ("tensor", "dense", 4, 2, 128,
                                                True),
    "wo_fp8_tensor": (None, "float8_e4m3fn", "tensor", "causal", 2, 2, 128,
                      True),
    "d64_int8": ("int8", "int8", "token", "dense", 2, 2, 64, True),
    "d64_fp8_causal_gqa": ("float8_e4m3fn",) * 2 + ("token", "causal", 4, 2,
                                                    64, True),
    "d64_wo_int8_exact": (None, "int8", "token", "dense", 2, 2, 64, False),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_quantized_flash_attention_matches_reference(name):
    """Port vs reference on the same numpy inputs, n 256 (o within atol
    5e-3 + rtol 1e-2, lse within 1e-3; reasons at _ATOL)."""
    q_dt, kv_dt, kv_scale, sched, hq, hkv, d, bound = _CASES[name]
    # At d ≤ 64 the reference takes its transposed kernel B8, which sums l
    # from bf16 P: on a causal row with one visible key that rounding alone
    # moves lse by up to 2⁻⁸. The causal d 64 case is held against the
    # reference's float32-l kernel (B7) instead; the dense ones against B8.
    jkw = dict(transposed=False) if d <= 64 and sched == "causal" else None
    arrays = _qkv(7, hq, hkv, 256, d)
    j, t = _both(jfq.quantized_flash_attention, tfq.quantized_flash_attention,
                 arrays, jkw, q_dtype=q_dt, kv_dtype=kv_dt,
                 kv_scale=kv_scale, schedule=sched, bound_max=bound)
    matched = (_reference_matched(arrays, q_dt, kv_dt, kv_scale,
                                  sched == "causal")
               if q_dt == "float8_e4m3fn" else None)
    _assert_close(j, t, matched)


def _matched(q, k, v, q_dtype, kv_dtype, kv_scale, scale, causal):
    """The f32 oracle on inputs quantized at the kernel's granularity."""
    qf = q * scale
    if q_dtype is not None:
        qf = tq.dequantize(tq.quantize(qf, q_dtype, axis=-1))
    k_axis = -1 if kv_scale == "token" else (-2, -1)
    kf = tq.dequantize(tq.quantize(k, kv_dtype, axis=k_axis))
    vf = tq.dequantize(tq.quantize(v, kv_dtype, axis=-2))
    g = q.shape[1] // k.shape[1]
    return toracle.dense_dpa(qf, kf.repeat_interleave(g, 1),
                             vf.repeat_interleave(g, 1), scale=1.0,
                             causal=causal)[0]


@pytest.mark.parametrize("q_dtype,kv_dtype,kv_scale", [
    ("int8", "int8", "token"), ("float8_e4m3fn", "float8_e4m3fn", "token"),
    ("float8_e5m2", "float8_e4m3fn", "token"), (None, "int8", "token"),
    (None, "float8_e4m3fn", "token"),
    ("float8_e4m3fn", "float8_e4m3fn", "tensor")])
@pytest.mark.parametrize("d", [128, 64])
def test_matched_oracle_contract(q_dtype, kv_dtype, kv_scale, d):
    """≤ 1e-2 max-abs vs the matched-bit-width f32 oracle (2e-2 for the
    weight-only mode, whose Q is bf16: tests/test_quant.py:49)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 2, 256, d))
    o = tfq.quantized_flash_attention(q, k, v, q_dtype=q_dtype,
                                      kv_dtype=kv_dtype, kv_scale=kv_scale,
                                      schedule="causal")
    ref = _matched(q, k, v, q_dtype, kv_dtype, kv_scale, d ** -0.5, True)
    bound = 1e-2 if q_dtype is not None else 2e-2
    assert float((o - ref).abs().max()) <= bound


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("int8", "int8"), ("float8_e4m3fn", "float8_e4m3fn"), (None, "int8")])
def test_prequant_matches_reference(q_dtype, kv_dtype):
    """prepare_ring_operands (bit-identical operands) then
    quantized_flash_attention_prequant, GQA 4/2, d 128."""
    arrays = _qkv(9, 4, 2, 256, 128)
    jp = jfq.prepare_ring_operands(*(jnp.asarray(a) for a in arrays),
                                   q_dtype=q_dtype, kv_dtype=kv_dtype)
    tp = tfq.prepare_ring_operands(*(torch.from_numpy(a) for a in arrays),
                                   q_dtype=q_dtype, kv_dtype=kv_dtype)
    for ja, ta in zip(jp[1:], tp[1:]):
        np.testing.assert_array_equal(_bits(ta.values), _jbits(ja.values))
        np.testing.assert_array_equal(ta.scales.numpy(), np.asarray(ja.scales))
    jqp, tqp = jp[0], tp[0]
    if isinstance(tqp, tq.QArray):
        np.testing.assert_array_equal(tqp.values.numpy(), np.asarray(jqp.values))
    else:
        np.testing.assert_array_equal(to_numpy(tqp), np.asarray(jqp, np.float32))
    jo, jl = jfq.quantized_flash_attention_prequant(*jp, return_lse=True,
                                                    **_BLK)
    to, tl = tfq.quantized_flash_attention_prequant(*tp, return_lse=True)
    assert to.dtype == torch.bfloat16
    _assert_close((np.asarray(jo, np.float32), np.asarray(jl)),
                  (to_numpy(to), tl.numpy()))


@pytest.mark.parametrize("causal,chunk,q_start,n", [
    (False, 64, 0, 200), (True, 64, 0, 200), (True, 48, 100, 100),
    (False, 512, 0, 130)])
def test_blockwise_dpa(causal, chunk, q_start, n):
    """blockwise_dpa vs dense_dpa (f32, 1e-5) and vs the reference's
    blockwise_dpa on the same inputs, including a q row band with its
    q_start and a chunk that does not divide n."""
    rng = np.random.default_rng(10)
    nk = n + q_start
    q = rng.standard_normal((1, 2, n, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, nk, 32)).astype(np.float32)
            for _ in range(2))
    to, tl = toracle.blockwise_dpa(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, chunk=chunk, q_start=q_start)
    jo, jl = joracle.blockwise_dpa(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, chunk=chunk, q_start=q_start)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    if q_start == 0:
        ro, rl = toracle.dense_dpa(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal)
        np.testing.assert_allclose(to.numpy(), ro.numpy(), atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), rl.numpy(), atol=1e-5)


def test_flash_attention_quantized_route():
    """flash_attention(q_dtype=…) is quantized_flash_attention with the
    reference's defaults (bound on, block_kv ≤ 2048); bwd options refused;
    the plain path counts no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, 2, 2, 128, 128))
    kernels.reset_launches()
    o = tflash.flash_attention(q, k, v, q_dtype="float8_e4m3fn",
                               schedule="causal", block_kv=4096)
    want = tfq.quantized_flash_attention(
        q, k, v, q_dtype="float8_e4m3fn", kv_dtype="float8_e4m3fn",
        schedule="causal")
    assert torch.equal(o, want)
    o_wo = tflash.dense_fa(q, k, v, kv_dtype="int8")
    assert torch.equal(o_wo, tfq.quantized_dense_fa(q, k, v, q_dtype=None,
                                                    kv_dtype="int8"))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="bwd_split"):
        tflash.flash_attention(q, k, v, q_dtype="int8", bwd_split=2)


@pytest.mark.parametrize("kw,err,match", [
    pytest.param(dict(kv_dtype="int4"), ValueError, "int4",
                 id="kw1-ValueError-int4"),
    pytest.param(dict(q_dtype="float8_e4m3fn"), ValueError, "family",
                 id="kw2-ValueError-family"),
    pytest.param(dict(kv_scale="tensor"), ValueError, "fp8 scaling",
                 id="kw3-ValueError-fp8 scaling"),
    pytest.param(dict(kv_scale="channel"), ValueError, "kv_scale",
                 id="kw4-ValueError-kv_scale"),
])
def test_quantized_rejects(kw, err, match):
    """Invalid options raise the reference's ValueError."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(12, 2, 2, 64, 64))
    with pytest.raises(err, match=match):
        tfq.quantized_flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              (None, "float8_e4m3fn")])
def test_quantized_shift_matches_reference(q_dtype, kv_dtype):
    """``shift`` (with the shifted schedule's default radius-0 band and a
    band of radius 20) on the quantized route, which refused it before the
    ring: the reference's o and lse, n 64."""
    arrays = _qkv(12, 2, 2, 64, 128)
    for radius in (0, 20):
        j, t = _both(jfq.quantized_flash_attention,
                     tfq.quantized_flash_attention, arrays, None,
                     q_dtype=q_dtype, kv_dtype=kv_dtype, schedule="shifted",
                     shift=8, radius=radius)
        _assert_close(j, t)


# One k32 step next to 448·1.875 = 840 (exponent fields 8 + 0, so E = 9):
# products truncate toward zero to multiples of 2^(9−14), the sum to 14
# significant bits (multiples of 2^(9−13) near 840).
@pytest.mark.parametrize("small,want", [
    (-0.015625, 840.0),          # −0.0293 → 0
    (-0.017578125, 839.9375),    # −0.0330 → −0.03125; 839.96875 → 839.9375
    (0.03515625, 840.0625),      # 0.0659 → 0.0625
    (1.75, 843.25),              # 3.28125: 843.28125 → 843.25
])
def test_fp8_scores_worked_steps(small, want):
    """``fp8_scores`` (the plain version's model of the card's fp8 sums) on
    hand-checked steps, exact where nothing truncates, odd in q̂, and
    unchanged by zero padding; steps add in float32."""
    q = torch.zeros(1, 1, 32)
    q[0, 0, 0], q[0, 0, 5] = 448.0, small
    k = torch.full((1, 1, 32), 1.875)
    e4 = torch.float8_e4m3fn
    assert float(tfq.fp8_scores(q, k, e4, e4)) == want
    assert float(tfq.fp8_scores(-q, k, e4, e4)) == -want
    wide = torch.cat([q, torch.zeros(1, 1, 40)], -1)
    assert float(tfq.fp8_scores(wide, torch.full((1, 1, 72), 1.875), e4,
                                e4)) == want
    two = torch.cat([q, q], -1)
    assert float(tfq.fp8_scores(two, torch.cat([k, k], -1), e4,
                                e4)) == float(torch.tensor(want) * 2)
    rng = np.random.default_rng(3)
    qs = torch.from_numpy(rng.integers(-15, 16, (2, 7, 64)).astype(np.float32))
    ks = torch.from_numpy(rng.integers(-3, 4, (2, 5, 64)).astype(np.float32))
    torch.testing.assert_close(tfq.fp8_scores(qs, ks, e4, e4), qs @ ks.mT,
                               atol=0, rtol=0)  # ≤ 9 bits: nothing truncates
