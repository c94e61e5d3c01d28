"""Port parity: the quantized route (B6 serving with B8's d ≤ 64 shapes, B7)
on the local, local_causal, circulant and block-diagonal schedules.

The same numpy inputs (made from a seed) go through the reference on the
CPU (Pallas in interpret mode, blocks of 128, as its own tests run it) and
through the port's plain path, at the tolerances of test_torch_quant.py
(:func:`test_torch_quant._assert_close`): o within atol 5e-3 + rtol 1e-2
and lse within 1e-3 of the reference's kernel. With e4m3 Q
(:func:`_assert_e4m3`) o and lse within that first pair of the reference's
f32 oracle on inputs quantized at the kernel's granularity, and within
E4M3_O_TOL / E4M3_LSE_GAP of the reference's kernel.
The CUDA kernels are held against the plain path on the card in
tests/test_torch_kernels.py.

    python -m pytest tests/test_torch_quant_bands.py -q
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant import (
    _ATOL,
    _LSE_ATOL,
    _RTOL,
    E4M3_LSE_GAP,
    E4M3_O_TOL,
    _assert_close,
)

from tpu_flash.ops import flash as jflash
from tpu_flash.ops import oracle as joracle
from tpu_flash.quant import flash_q as jfq
from tpu_flash.quant import qarray as jq
from tpu_flash.quant import serving_attn as jsa
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops.oracle import circulant_dpa
from tpu_flash_torch.quant import flash_q as tfq
from tpu_flash_torch.quant import serving_attn as tsa
from tpu_flash_torch.quant.qarray import dequantize
from tpu_flash_torch.utils.convert import (
    qarray_from_reference,
    to_numpy,
    to_torch,
)

torch.set_num_threads(2)

_BLK = dict(block_q=128, block_kv=128)
# schedule → its options here, and the reference oracle's mask for them
# (blockwise_dpa's window_size, causal, wrap, block_size)
_KINDS = {
    "local": (dict(radius=40), dict(window_size=81)),
    "local_causal": (dict(radius=40), dict(window_size=81, causal=True)),
    "circulant": (dict(radius=40), dict(window_size=81, wrap=True)),
    "block": (dict(section=64), dict(block_size=64)),
}


def _ref(fn, *args, **kw):
    """A reference call, jitted with its keyword arguments static (a jitted
    interpret-mode call traces once, about half the eager call's cost)."""
    return jax.jit(functools.partial(fn, **kw, **_BLK))(*args)


def _qkv(seed, hq, hkv, n, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, n, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _np(o, lse):
    return np.asarray(o, np.float32), np.asarray(lse)


def _oracle(q, k, v, schedule, section=None, **_):
    """The reference's f32 oracle (``blockwise_dpa``) under the schedule's
    mask (``section`` for another block size), on already scaled q and K/V
    expanded to the q heads."""
    g = q.shape[1] // k.shape[1]
    mask = _KINDS[schedule][1] if section is None else dict(block_size=section)
    return _np(*joracle.blockwise_dpa(q, jnp.repeat(k, g, 1),
                                      jnp.repeat(v, g, 1), scale=1.0, **mask))


def _assert_e4m3(j, t, matched):
    """e4m3 Q: o and lse against the matched oracle at _ATOL/_RTOL and
    _LSE_ATOL, and against the reference's kernel at E4M3_O_TOL and
    E4M3_LSE_GAP. The reference folds the row factor into a bf16 Q (its
    TPU has no fp8 unit), which can move its own lse off that oracle by
    more than E4M3_LSE_GAP on band rows: where the reference's kernel
    misses the oracle by more than E4M3_LSE_GAP − _LSE_ATOL, the lse gap
    allowed is its own miss plus _LSE_ATOL."""
    (jo, jl), (to, tl), (mo, ml) = j, t, matched
    fin = np.isfinite(jl)
    for lse in (tl, ml):
        np.testing.assert_array_equal(np.isfinite(lse), fin)
    np.testing.assert_allclose(to, mo, atol=_ATOL, rtol=_RTOL)
    np.testing.assert_allclose(tl[fin], ml[fin], atol=_LSE_ATOL)
    np.testing.assert_allclose(to, jo, **E4M3_O_TOL)
    gap = np.maximum(E4M3_LSE_GAP, np.abs(jl[fin] - ml[fin]) + _LSE_ATOL)
    assert bool((np.abs(tl[fin] - jl[fin]) <= gap).all())


def _matched(arrays, kv_dtype, kv_scale, schedule):
    """The matched-bit-width oracle of an e4m3 Q call: Q, K, V quantized by
    the reference at the kernel's granularity (K of the circulant per
    token or per tensor, the same values as its halo)."""
    q, k, v = (jnp.asarray(a) for a in arrays)
    qf = jq.dequantize(jq.quantize(q * q.shape[-1] ** -0.5, "float8_e4m3fn",
                                   axis=-1))
    k_axis = -1 if kv_scale == "token" else (-2, -1)
    kf = jq.dequantize(jq.quantize(k, kv_dtype, axis=k_axis))
    vf = jq.dequantize(jq.quantize(v, kv_dtype, axis=-2))
    return _oracle(qf, kf, vf, schedule)


# (schedule, q_dtype, kv_dtype, kv_scale, bound_max, hq, hkv): every kind
# with int8 and e4m3 Q, K scales per token and per tensor, both maxima; the
# weight-only mode on the two kinds whose K/V the wrapper builds (halo) or
# the mask cuts at the causal edge; one head, and GQA 6/2 on two kinds
_FWD_MODES = [("int8", "int8", "token", True),
              ("float8_e4m3fn", "float8_e4m3fn", "token", False),
              ("float8_e4m3fn", "float8_e4m3fn", "tensor", True)]
_FWD_CASES = [(s, *m, 1, 1) for s in _KINDS for m in _FWD_MODES] + [
    ("local_causal", None, "int8", "token", False, 1, 1),
    ("circulant", None, "float8_e4m3fn", "tensor", True, 1, 1),
    ("local_causal", "int8", "int8", "token", False, 6, 2),
    ("circulant", "float8_e4m3fn", "float8_e4m3fn", "tensor", True, 6, 2)]


@pytest.mark.parametrize("case", _FWD_CASES, ids=[
    f"{c[0]}-{c[1] or 'weight_only'}-{c[3]}-{'bound' if c[4] else 'exact'}"
    f"-{c[5]}x{c[6]}" for c in _FWD_CASES])
def test_quantized_bands_match_reference(case):
    """quantized_flash_attention (B7 at d 128; the circulant over
    halo-extended K/V) vs the reference, n 256."""
    schedule, q_dt, kv_dt, kv_scale, bound, hq, hkv = case
    arrays = _qkv(21, hq, hkv, 256, 128)
    kw = dict(q_dtype=q_dt, kv_dtype=kv_dt, kv_scale=kv_scale,
              schedule=schedule, bound_max=bound, return_lse=True,
              **_KINDS[schedule][0])
    j = _np(*_ref(jfq.quantized_flash_attention,
                  *(jnp.asarray(a) for a in arrays), **kw))
    to, tl = tfq.quantized_flash_attention(*(to_torch(a, "cpu")
                                             for a in arrays), **kw)
    t = (to_numpy(to), tl.numpy())
    if q_dt == "float8_e4m3fn":
        _assert_e4m3(j, t, _matched(arrays, kv_dt, kv_scale, schedule))
    else:
        _assert_close(j, t)


def _cache(seed, hq, hkv, n, d, kv_dtype, kv_scale="token"):
    """The same quantized cache for both (the reference's bytes) and q."""
    q, k, v = _qkv(seed, hq, hkv, n, d)
    jkq, jvq = jsa.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), kv_dtype,
                                     kv_scale=kv_scale)
    return (jnp.asarray(q), jkq, jvq), (
        to_torch(q, "cpu"), qarray_from_reference(jkq, "cpu"),
        qarray_from_reference(jvq, "cpu"))


# (schedule, q_dtype, kv_dtype, kv_scale, bound_max, pv_quant)
_SERVING_MODES = [("int8", "int8", "token", True, False),
                  ("float8_e4m3fn", "float8_e4m3fn", "tensor", True, False),
                  (None, "int8", "token", False, False)]
_SERVING_CASES = [(s, *m) for s in _KINDS for m in _SERVING_MODES] + [
    ("local", "int8", "int8", "token", False, True)]


@pytest.mark.parametrize("case", _SERVING_CASES, ids=[
    f"{c[0]}-{c[1] or 'weight_only'}-{c[3]}" + ("-pv_quant" if c[5] else "")
    for c in _SERVING_CASES])
def test_serving_bands_match_reference(case):
    """serving_flash_attention (B6 at d 128) on every kind vs the reference
    over the same cache bytes, n 256; the circulant with the phantom rows
    the reference attends; pv_quant (int8 P·V, exact max) on the band."""
    schedule, q_dt, kv_dt, kv_scale, bound, pvq = case
    j, t = _cache(22, 1, 1, 256, 128, kv_dt, kv_scale)
    # the reference's standard layout takes 128-row multiples of kv blocks
    opts = dict(section=128) if schedule == "block" else _KINDS[schedule][0]
    kw = dict(q_dtype=q_dt, schedule=schedule, bound_max=bound, pv_quant=pvq,
              return_lse=True, **opts)
    jo = _np(*_ref(jsa.serving_flash_attention, *j, **kw))
    to, tl = tsa.serving_flash_attention(*t, **kw)
    t = (to_numpy(to), tl.numpy())
    if q_dt != "float8_e4m3fn":
        _assert_close(jo, t)
        return
    q, kq, vq = j
    qf = jq.dequantize(jq.quantize(q * q.shape[-1] ** -0.5, "float8_e4m3fn",
                                   axis=-1))
    kf, vf = jq.dequantize(kq), jq.dequantize(vq)
    if schedule == "circulant":  # the reference's phantom rows
        _assert_e4m3(jo, t, _phantom_oracle(qf, kf, vf, 40))
    else:
        _assert_e4m3(jo, t, _oracle(qf, kf, vf, schedule, **opts))


def _phantom_oracle(q, k, v, radius):
    """f32 attention of query i over the keys i … i + 2·radius of
    ``cat([k, zeros(2·radius)])`` (values likewise): the circulant as the
    reference computes it over a cache that was not halo-extended."""
    n = k.shape[2]
    pad = ((0, 0), (0, 0), (0, 2 * radius), (0, 0))
    ke, ve = jnp.pad(k, pad), jnp.pad(v, pad)
    i = jnp.arange(n)[:, None]
    j = jnp.arange(n + 2 * radius)[None, :]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, ke)
    s = jnp.where((j >= i) & (j - i <= 2 * radius), s, -jnp.inf)
    lse = jnp.log(jnp.sum(jnp.exp(s - s.max(-1, keepdims=True)), -1)) \
        + s.max(-1)
    o = jnp.einsum("bhqk,bhkd->bhqd", jnp.exp(s - lse[..., None]), ve)
    return _np(o, lse)


def test_serving_circulant_phantom_keys():
    """Serving's circulant attends 2·radius phantom zero keys, as the
    reference does (weight-only int8 cache, exact max, n 128, r 8): the
    port is within a bf16 rounding of the oracle with them and misses the
    true wraparound (circulant_dpa) by far more."""
    j, t = _cache(23, 1, 1, 128, 128, "int8")
    kw = dict(q_dtype=None, schedule="circulant", radius=8, bound_max=False)
    jo = np.asarray(_ref(jsa.serving_flash_attention, *j, **kw), np.float32)
    to = to_numpy(tsa.serving_flash_attention(*t, **kw))
    np.testing.assert_allclose(to, jo, atol=5e-3, rtol=1e-2)
    q, kq, vq = t
    kf, vf = dequantize(kq), dequantize(vq)
    with_phantoms, _ = _phantom_oracle(
        jnp.asarray(to_numpy(q)) * 128 ** -0.5, jnp.asarray(to_numpy(kf)),
        jnp.asarray(to_numpy(vf)), 8)
    true_wrap, _ = circulant_dpa(q, kf, vf, 17)
    err = float(np.abs(to - with_phantoms).max())
    miss = float(np.abs(to - to_numpy(true_wrap)).max())
    assert err <= 2e-2, err
    assert miss >= 10 * max(err, 1e-2), (err, miss)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8")])
def test_prequant_band_matches_reference(q_dtype, kv_dtype):
    """prepare_ring_operands then quantized_flash_attention_prequant on the
    local schedule, GQA 4/2, d 128."""
    arrays = _qkv(24, 4, 2, 256, 128)
    jp = jfq.prepare_ring_operands(*(jnp.asarray(a) for a in arrays),
                                   q_dtype=q_dtype, kv_dtype=kv_dtype)
    tp = tfq.prepare_ring_operands(*(torch.from_numpy(a) for a in arrays),
                                   q_dtype=q_dtype, kv_dtype=kv_dtype)
    kw = dict(schedule="local", radius=40, return_lse=True)
    jo = _np(*_ref(jfq.quantized_flash_attention_prequant, *jp, **kw))
    to, tl = tfq.quantized_flash_attention_prequant(*tp, **kw)
    _assert_close(jo, (to_numpy(to), tl.numpy()))


# the public wrappers with q_dtype: (name, call, d, layout); d 64 sends
# sliding_fa, block_fa and windowed_fa through the serving kernel (B8's
# route) and keeps circulant_fa on B7 in both
_WRAPPERS = {
    "sliding_causal_d128": (lambda m, q, k, v, **kw: m.sliding_fa(
        q, k, v, 65, causal=True, **kw), 128, "bhnd"),
    "sliding_d64": (lambda m, q, k, v, **kw: m.sliding_fa(q, k, v, 65, **kw),
                    64, "bhnd"),
    "circulant_d64": (lambda m, q, k, v, **kw: m.circulant_fa(q, k, v, 65,
                                                               **kw), 64,
                      "bhnd"),
    "block_d128": (lambda m, q, k, v, **kw: m.block_fa(q, k, v, 64, **kw),
                   128, "bhnd"),
    "block2d_d64": (lambda m, q, k, v, **kw: m.block_fa(q, k, v, (4, 8),
                                                         **kw), 64, "2d"),
    "windowed2d_d64": (lambda m, q, k, v, **kw: m.windowed_fa(
        q, k, v, (4, 4), stride=(2, 4), **kw), 64, "2d"),
}


@pytest.mark.parametrize("name", list(_WRAPPERS))
def test_band_wrappers_quantized_match_reference(name):
    """sliding_fa, circulant_fa, block_fa (1-D and 2-D block-major) and 2-D
    windowed_fa with q_dtype="int8" (the reference's one dispatch,
    ``flash_attention(q_dtype=…)``) vs the reference's wrappers."""
    call, d, layout = _WRAPPERS[name]
    rng = np.random.default_rng(25)
    shape = (1, 1, 256, d) if layout == "bhnd" else (1, 8, 16, 1, d)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jo = np.asarray(jax.jit(lambda *a: call(jflash, *a, q_dtype="int8",
                                            **_BLK))(
        *(jnp.asarray(a) for a in arrays)), np.float32)
    to = to_numpy(call(tflash, *(to_torch(a, "cpu") for a in arrays),
                       q_dtype="int8"))
    np.testing.assert_allclose(to, jo, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("schedule", list(_KINDS))
def test_d64_routing(schedule, monkeypatch):
    """At d ≤ 64 quantized_flash_attention takes the serving kernel's plain
    path (B6, B8's shape) on every kind but the circulant, which stays on
    B7 with its halo (the reference's rule, tpu_flash/quant/flash_q.py)."""
    ran = []
    for mod, name in ((tfq, "_quant_plain"), (tsa, "_serving_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _name=name: (
            ran.append(_name), _fn(*a))[1])
    q, k, v = (torch.from_numpy(a) for a in _qkv(26, 2, 2, 128, 64))
    tfq.quantized_flash_attention(q, k, v, schedule=schedule,
                                  **_KINDS[schedule][0])
    assert ran == (["_quant_plain"] if schedule == "circulant"
                   else ["_serving_plain"])


# the persistent kernel's work list (quant/flash_q.py:work_order) on every
# kind the kernels walk: (schedule, options at n, taken as fractions of n so
# that one entry serves n 1000 and n 100); the circulant over its halo, a
# shifted hop inside the shard, a causal one and a wrapped band
_ORDER_KINDS = [
    ("dense", {}), ("causal", {}), ("local", dict(radius=0.2)),
    ("local_causal", dict(radius=0.3)), ("circulant", dict(radius=0.15)),
    ("block", dict(section=0.1)), ("shifted", dict(shift=0.7, radius=0.2)),
    ("shifted", dict(shift=-0.3, radius=0.1, shifted_causal=True)),
    ("shifted", dict(shift=0.9, radius=0.15, wrap_n=1.0))]


@pytest.mark.parametrize("bkv", [128, 64, 32])
@pytest.mark.parametrize("n", [1000, 100])
@pytest.mark.parametrize("kind", _ORDER_KINDS, ids=[
    f"{k[0]}-{i}" for i, k in enumerate(_ORDER_KINDS)])
def test_work_order_covers_every_tile_heaviest_first(kind, n, bkv):
    """Every (batch·head, 128-row q tile) appears once in the work list;
    each carries the kv tiles its q tile visits (ops/schedule.py:
    kv_tile_range, the kernels' kv_range, which the plain version walks
    too), and those are the hull of the kv tiles that hold a key some row
    of the tile sees (Schedule.visible), none where no row sees a key; the
    list runs heaviest first by that count."""
    from tpu_flash_torch.ops.schedule import kv_tile_range

    schedule, fractions = kind
    options = {key: int(round(x * n)) if key != "shifted_causal" else x
               for key, x in fractions.items()}
    sched = tflash.build_schedule(schedule, n, n, 1024, 2048, **options)
    n_kv = n + 2 * options["radius"] if schedule == "circulant" else n
    bh, n_tiles = 3, -(-n // 128)
    order = tfq.work_order(sched, n, n_kv, bkv, bh)
    assert order.dtype == torch.int32 and order.shape == (bh * n_tiles, 3)
    assert sorted(order[:, 0].tolist()) == list(range(bh * n_tiles))
    vis = sched.visible(torch.arange(n)[:, None], torch.arange(n_kv)[None])
    vis = torch.ones(n, n_kv, dtype=torch.bool) if vis is None else \
        torch.broadcast_to(vis, (n, n_kv))
    steps = []
    for t in range(n_tiles):
        first, last = kv_tile_range(sched, n_kv, 128 * t,
                                    min(128 * (t + 1), n) - 1, bkv)
        seen = torch.nonzero(vis[128 * t:128 * (t + 1)].any(0))[:, 0] // bkv
        if seen.numel():
            assert (first, last) == (int(seen.min()), int(seen.max())), t
        else:
            assert last < first, t
        steps.append(max(0, last - first + 1))
        rows = order[order[:, 0] % n_tiles == t]
        assert (rows[:, 2] == steps[-1]).all(), t
        if steps[-1]:
            assert (rows[:, 1] == first).all(), t
    walked = order[:, 2].tolist()
    assert walked == sorted(walked, reverse=True)
    assert sum(walked) == bh * sum(steps)
