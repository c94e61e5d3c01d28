"""Head and value dims other than 64 and 128, and groups above 8.

On the card the attention kernels run at compiled widths 64, 128 and 256:
the wrappers zero-pad d and dv up to one (``ops/flash.py:pad_head_dims``,
K̂/V̂ with byte 0 and σv with 1) and slice o back, B2 reads rows of any d
under its width and walks a group in chunks of 8. Here, on the CPU:

- the padding itself: each plain version gives on the padded operands what
  it gives on the originals (zero columns change no dot product and no
  norm), for B1's and B6/B7's plain paths at d 8, 40, 96, 200 and dv ≠ d;
- the port against the reference at d 96 with dv 64 through
  ``flash_attention``, ``quantized_flash_attention`` and
  ``serving_flash_attention`` (int8, weight-only and e4m3 Q), and
  ``paged_attention`` at G 16 on a small cache, with the same numpy inputs
  and the reference's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.ops import flash as jflash
from tpu_flash.ops import oracle as joracle
from tpu_flash.ops import paged as jpaged
from tpu_flash.quant import qarray as jq
from tpu_flash.quant import flash_q as jfq
from tpu_flash.quant import serving_attn as jsa
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import paged as tpaged
from tpu_flash_torch.quant import flash_q as tfq
from tpu_flash_torch.quant import serving_attn as tsa
from tpu_flash_torch.utils.convert import (
    cache_from_reference,
    qarray_from_reference,
    to_numpy,
    to_torch,
)

torch.set_num_threads(2)

_DIMS = [(8, 8), (40, 40), (96, 96), (200, 200), (96, 64), (40, 200)]


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("d,dv", _DIMS)
def test_kernel_head_dim(d, dv):
    """The width a kernel runs at: the least of 64, 128, 256 that holds
    both dims; wider heads raise, naming the ROADMAP item."""
    width = tflash.kernel_head_dim(d, dv)
    assert width in tflash.KERNEL_HEAD_DIMS and width >= max(d, dv)
    assert width // 2 < max(d, dv) or width == 64
    with pytest.raises(NotImplementedError, match="A15"):
        tflash.kernel_head_dim(d, 264)


def test_pad_head_dims_bytes_and_fill():
    """Zeros (byte 0 for int8, e4m3, e5m2), the fill value for scales, None
    passed through, and the original columns untouched."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 3, 40)
    outs = tflash.pad_head_dims(64, x, None, x.to(torch.int8),
                                x.to(torch.float8_e4m3fn),
                                x.to(torch.float8_e5m2))
    assert outs[1] is None
    for src, out in zip((x, x.to(torch.int8), x.to(torch.float8_e4m3fn),
                         x.to(torch.float8_e5m2)), outs[:1] + outs[2:]):
        assert out.dtype == src.dtype and out.shape == (2, 3, 64)
        bits = out.view(torch.uint8) if out.element_size() == 1 else out
        sbits = src.view(torch.uint8) if src.element_size() == 1 else src
        assert torch.equal(bits[..., :40], sbits)
        assert not bits[..., 40:].any()
    (sv,) = tflash.pad_head_dims(64, x, fill=1.0)
    assert torch.equal(sv[..., 40:], torch.ones(2, 3, 24))
    assert tflash.pad_head_dims(40, x)[0] is x


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("d,dv", _DIMS)
def test_flash_plain_on_padded_operands(d, dv, bound):
    """B1's plain version (causal, GQA 4/2, exact max and the norm bound):
    the padded operands give the original o in the first dv columns, zeros
    after them, and the same lse (float32: summation order only)."""
    rng = np.random.default_rng(d * 1000 + dv)
    n = 40
    q = _rand(rng, 4, n, d) * (d ** -0.5 * tflash.LOG2E)
    k, v = _rand(rng, 2, n, d), _rand(rng, 2, n, dv)
    sched = tflash.build_schedule("causal", n, n, 128, 128)
    o, lse = tflash._flash_fwd_plain(q, k, v, sched, 4, 2, bound)
    width = tflash.kernel_head_dim(d, dv)
    po, plse = tflash._flash_fwd_plain(*tflash.pad_head_dims(width, q, k, v),
                                       sched, 4, 2, bound)
    torch.testing.assert_close(po[..., :dv], o, atol=1e-6, rtol=1e-6)
    assert not po[..., dv:].any()
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              ("float8_e4m3fn", "float8_e5m2"),
                                              (None, "float8_e4m3fn")])
@pytest.mark.parametrize("d,dv", _DIMS)
def test_quant_plain_on_padded_operands(d, dv, q_dtype, kv_dtype):
    """B6/B7's plain tile loop (``_attend_plain``, causal, GQA 4/2, the norm
    bound): q̂ or the bf16 operand, K̂ and V̂ padded with byte 0 and σv
    with 1 give the original o and lse."""
    rng = np.random.default_rng(d * 1000 + dv + 1)
    n = 300
    q, k, v = _rand(rng, 1, 4, n, d), _rand(rng, 1, 2, n, d), _rand(rng, 1, 2, n, dv)
    kq, vq = tsa.quantize_kv_cache(k, v, kv_dtype)
    ops = tsa.serving_operands(q, kq, vq, True)
    mode = {"int8": "int8", None: "raw"}.get(q_dtype, "fp8")
    q_op, qs = tsa._stage_q_plain(ops[0], mode, tfq.f32(d ** -0.5 * tflash.LOG2E),
                                  1.0)
    k_vals, v_vals, sk, sv, gk = ops[1], ops[2], ops[3], ops[5], ops[6]
    sched = tflash.build_schedule("causal", n, n, 1024, 2048)
    o, lse = tfq._attend_plain(q_op, qs, k_vals, v_vals, sk, sv, gk, sched, 4,
                               2, torch.float32)
    width = tflash.kernel_head_dim(d, dv)
    pq, pk, pv = tflash.pad_head_dims(width, q_op, k_vals, v_vals)
    (psv,) = tflash.pad_head_dims(width, sv, fill=1.0)
    po, plse = tfq._attend_plain(pq, qs, pk, pv, sk, psv, gk, sched, 4, 2,
                                 torch.float32)
    torch.testing.assert_close(po[..., :dv], o, atol=1e-6, rtol=1e-6)
    assert not po[..., dv:].any()
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)


def _qkv(seed, hq, hkv, n, d, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, n, dd)).astype(np.float32)
            for h, dd in ((hq, d), (hkv, d), (hkv, dv))]


@pytest.mark.parametrize("schedule", ["dense", "causal"])
def test_flash_attention_d96_dv64_matches_reference(schedule):
    """bf16 ``flash_attention`` at d 96, dv 64, GQA 4/2: the reference's
    bf16 tolerance (2e-2, tests/test_flash.py)."""
    arrays = _qkv(1, 4, 2, 200, 96, 64)
    jo, jl = jflash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), schedule=schedule,
        return_lse=True, block_q=128, block_kv=128)
    to, tl = tflash.flash_attention(
        *(to_torch(a, "cpu").bfloat16() for a in arrays), schedule=schedule,
        return_lse=True)
    assert to.shape == (1, 4, 200, 64)
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                               atol=2e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2)


# With e4m3 Q the port applies the row factor to the float32 score of the
# fp8 products; the reference's kernel folds it into a bf16 Q (its TPU has
# no fp8 unit). Those cases hold o and lse against the reference's oracle
# on matched-bit-width inputs at the tolerances below, and stay within
# these bounds of the reference's kernel: the largest gaps they show
# (ROADMAP §C, a known deviation).
E4M3_O_TOL, E4M3_LSE_GAP = dict(atol=1e-2, rtol=2e-2), 4e-3


def _matched_oracle(q, kf, vf):
    """The reference's oracle on Q quantized to e4m3 per token and the
    dequantized cache ``kf``/``vf`` (b, hkv, n, ·), dense."""
    qf = jq.dequantize(jq.quantize(jnp.asarray(q) * q.shape[-1] ** -0.5,
                                   "float8_e4m3fn", axis=-1))
    g = q.shape[1] // kf.shape[1]
    o, lse = joracle.dense_dpa(qf, jnp.repeat(kf, g, 1), jnp.repeat(vf, g, 1),
                               scale=1.0)
    return np.asarray(o, np.float32), np.asarray(lse)


def _assert_quant_close(t, j, matched=None):
    """o within atol 5e-3 + rtol 1e-2, lse within 1e-3 of the reference's
    kernel; with e4m3 Q of the oracle ``matched``, and within the e4m3
    bounds of the kernel."""
    (to, tl), (jo, jl) = t, j
    want_o, want_l = (jo, jl) if matched is None else matched
    np.testing.assert_allclose(to, want_o, atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(tl, want_l, atol=1e-3)
    if matched is not None:
        np.testing.assert_allclose(to, jo, **E4M3_O_TOL)
        np.testing.assert_allclose(tl, jl, atol=E4M3_LSE_GAP)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              (None, "float8_e4m3fn"),
                                              ("float8_e4m3fn",
                                               "float8_e4m3fn")])
def test_quantized_flash_attention_d96_dv64_matches_reference(q_dtype,
                                                              kv_dtype):
    """B7 at d 96, dv 64: o within atol 5e-3 + rtol 1e-2, lse within 1e-3
    (tests/test_torch_quant.py)."""
    arrays = _qkv(2, 4, 2, 256, 96, 64)
    kw = dict(q_dtype=q_dtype, kv_dtype=kv_dtype, return_lse=True)
    jo, jl = jfq.quantized_flash_attention(
        *(jnp.asarray(a) for a in arrays), block_q=128, block_kv=128, **kw)
    to, tl = tfq.quantized_flash_attention(
        *(to_torch(a, "cpu") for a in arrays), **kw)
    assert to.shape == (1, 4, 256, 64)
    matched = None
    if q_dtype == "float8_e4m3fn":
        kf = jq.dequantize(jq.quantize(jnp.asarray(arrays[1]), kv_dtype,
                                       axis=-1))
        vf = jq.dequantize(jq.quantize(jnp.asarray(arrays[2]), kv_dtype,
                                       axis=-2))
        matched = _matched_oracle(arrays[0], kf, vf)
    _assert_quant_close((to_numpy(to), tl.numpy()),
                        (np.asarray(jo, np.float32), np.asarray(jl)), matched)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              (None, "int8"),
                                              ("float8_e4m3fn",
                                               "float8_e4m3fn")])
def test_serving_flash_attention_d96_dv64_matches_reference(q_dtype, kv_dtype):
    """B6 at d 96, dv 64 over the reference's own cache bytes: o within
    atol 5e-3 + rtol 1e-2, lse within 1e-3 (tests/test_torch_serving_attn.py)."""
    q, k, v = _qkv(3, 4, 2, 256, 96, 64)
    jkq, jvq = jsa.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), kv_dtype)
    jo, jl = jsa.serving_flash_attention(
        jnp.asarray(q), jkq, jvq, q_dtype=q_dtype, return_lse=True,
        block_q=128, block_kv=128)
    to, tl = tsa.serving_flash_attention(
        to_torch(q, "cpu"), qarray_from_reference(jkq, "cpu"),
        qarray_from_reference(jvq, "cpu"), q_dtype=q_dtype, return_lse=True)
    assert to.shape == (1, 4, 256, 64)
    matched = (_matched_oracle(q, jq.dequantize(jkq), jq.dequantize(jvq))
               if q_dtype == "float8_e4m3fn" else None)
    _assert_quant_close((to_numpy(to), tl.numpy()),
                        (np.asarray(jo, np.float32), np.asarray(jl)), matched)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("d", [96, 40])
def test_paged_attention_group16_matches_reference(dtype, d):
    """B3 then B2 at G 16 (32 q heads over 2 kv heads) and head dims 96 and
    40: the appended pages and scales as the reference writes them (its
    jitted int8 quantizer is not an IEEE divide on XLA's CPU: a scale may
    sit one ulp off, and a value then one step off; ROADMAP C), o and lse
    within the reference's 2e-2 (tests/test_torch_paged.py)."""
    rng = np.random.default_rng(d)
    cfg = JCacheConfig(num_kv_heads=2, head_dim=d, page_size=16,
                       total_pages=64, max_seqs=4, max_pages_per_seq=16,
                       dtype=dtype)
    tables = 1 + np.arange(4 * 16).reshape(4, 16) % 63
    jc = JPagedKVCache.create(cfg).assign_pages(jnp.asarray(tables, jnp.int32))
    for s, n in enumerate([37, 47, 5]):
        jc = jc.write_prompt(
            s, jnp.asarray(rng.standard_normal((2, n, d)), jnp.float32),
            jnp.asarray(rng.standard_normal((2, n, d)), jnp.float32))
    tc = cache_from_reference(jc, device="cpu")
    slots = np.array([0, 1, 2], np.int32)
    q = rng.standard_normal((3, 32, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((3, 2, d)).astype(np.float32)
              for _ in range(2))
    jo, jl, jc = jpaged.paged_attention(
        jnp.asarray(q), jc, jnp.asarray(slots),
        new_kv=(jnp.asarray(kn), jnp.asarray(vn)), return_lse=True)
    to, tl, tc = tpaged.paged_attention(
        torch.as_tensor(q), tc, torch.as_tensor(slots),
        new_kv=(torch.as_tensor(kn), torch.as_tensor(vn)), return_lse=True)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        j, t = getattr(jc, name), getattr(tc, name)
        if t is not None:
            tn = to_numpy(t) if t.dtype == torch.bfloat16 else t.numpy()
            jn = np.asarray(j).astype(tn.dtype)
            if name.endswith("scales"):
                np.testing.assert_allclose(tn, jn, rtol=2 ** -23, atol=0,
                                           err_msg=name)
            elif tn.dtype == np.int8:
                assert np.abs(tn.astype(np.int32) - jn).max() <= 1, name
            else:
                np.testing.assert_array_equal(tn, jn, err_msg=name)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2)
