"""Port parity: the shifted (ring-hop) schedule.

``ShiftedMaskSchedule``'s visit math against the reference's, the kernels'
kv visit (``kv_tile_range``) covering every visible key, and the shifted
schedule through the port's entry points (``flash_attention`` forward, lse
and gradients with an lse cotangent; ``quantized_flash_attention``,
``quantized_flash_attention_prequant``, ``serving_flash_attention``)
against the reference's functions on the same numpy inputs, Pallas in
interpret mode with blocks of 128, as the reference's own tests run it.
The cases include the wrapped band that reaches a shard at both ends (two
runs of keys) and rows that see no key of the hop (o = 0, lse = −inf).
The CUDA kernels are held against the plain paths on the card in
tests/test_torch_kernels.py.

Tolerances: float32 o and lse 1e-4, grads atol 3e-4 / rtol 1e-3 (the
reference's own, tests/test_grad.py); bf16 o 2e-2; the quantized route
as tests/test_torch_quant.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant import _assert_close
from test_torch_quant_bands import _assert_e4m3

from tpu_flash.ops import flash as jflash
from tpu_flash.ops import schedule as jsched
from tpu_flash.quant import flash_q as jfq
from tpu_flash.quant import qarray as jq
from tpu_flash.quant import serving_attn as jsa
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import schedule as tsched
from tpu_flash_torch.quant import flash_q as tfq
from tpu_flash_torch.quant import serving_attn as tsa
from tpu_flash_torch.utils.convert import (
    qarray_from_reference,
    to_numpy,
    to_torch,
)

torch.set_num_threads(2)

_BLK = dict(block_q=128, block_kv=128)


def _ref(fn, *args, **kw):
    """A reference call, jitted with its keyword arguments static."""
    return jax.jit(functools.partial(fn, **kw, **_BLK))(*args)


# (shift, radius, wrap_n, causal) over shards of n = 256 in a ring of 4:
# a forward band hop (rows past the band see nothing), the hop from a later
# rank (negative shift), the circulant ring's wrapped hop, the wrap within
# one shard (shift 0, wrap_n = n: two runs of keys), shifted_causal with and
# without a band, no band at all
_N = 256
_HOPS = {
    "band_forward": (_N, 100, 0, False),
    "band_backward": (-_N, 100, 0, False),
    "circulant_wrapped": (3 * _N, 100, 4 * _N, False),
    "two_runs": (0, 60, _N, False),
    "causal_nearly_empty": (-200, -1, 0, True),
    "causal_band": (_N // 2, 90, 0, True),
    "no_band": (37, -1, 0, False),
}


def _visible(sched, n_q, n_kv):
    return torch.broadcast_to(
        sched.visible(torch.arange(n_q)[:, None], torch.arange(n_kv)[None, :]),
        (n_q, n_kv)).numpy()


@pytest.mark.parametrize("n_q,n_kv,bq,bkv", [
    (256, 256, 64, 128), (200, 328, 128, 64), (100, 60, 64, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_shifted_schedule_matches_reference(n_q, n_kv, bq, bkv, causal):
    """mask and block_unmasked equal the reference's (exact: integer logic)
    over shifts (negative, past the shard, past the ring), radii (none, 0,
    within and past a tile) and wraps (none, the ring, longer)."""
    ring = max(n_q, n_kv)
    for shift in (0, 5, -n_q, n_q, -37, 130, 3 * ring // 2):
        for radius in (-1, 0, 7, 50, 300):
            for wrap in ((0,) if radius < 0 else (0, ring, ring + 17)):
                kw = dict(shift=shift, radius=radius, wrap_n=wrap,
                          causal=causal)
                js = jsched.ShiftedMaskSchedule(n_q, n_kv, bq, bkv, **kw)
                ts = tsched.ShiftedMaskSchedule(n_q, n_kv, bq, bkv, **kw)
                for attr in ("n_q_pad", "n_kv_pad", "max_kv_steps",
                             "max_q_steps", "has_mask"):
                    assert getattr(ts, attr) == getattr(js, attr), attr
                qp = np.arange(ts.n_q_pad)[:, None]
                kp = np.arange(ts.n_kv_pad)[None, :]
                shape = (ts.n_q_pad, ts.n_kv_pad)
                jm = np.broadcast_to(np.asarray(js.mask(jnp.asarray(qp),
                                                        jnp.asarray(kp))),
                                     shape)
                tm = np.broadcast_to(ts.mask(torch.as_tensor(qp),
                                             torch.as_tensor(kp)).numpy(),
                                     shape)
                np.testing.assert_array_equal(tm, jm, err_msg=str(kw))
                for i in range(ts.num_q_blocks):
                    for s in range(ts.max_kv_steps):
                        assert ts.block_unmasked(i, s) == bool(
                            js.block_unmasked(i, s)), (kw, i, s)


@pytest.mark.parametrize("hop", list(_HOPS))
@pytest.mark.parametrize("tile", [64, 128])
def test_shifted_kernel_visit_covers_visible_keys(hop, tile):
    """The kv tiles the kernels visit for a q tile (kv_tile_range, the
    Python of csrc/schedule.cuh:kv_range) hold every key a row of it sees,
    at ragged n too; tiles seen by no row may be visited."""
    shift, radius, wrap, causal = _HOPS[hop]
    for n_q, n_kv in ((_N, _N), (200, 256), (256, 130)):
        sched = tsched.ShiftedMaskSchedule(
            n_q, n_kv, 128, 128, shift=shift, radius=radius,
            wrap_n=max(wrap, n_q, n_kv) if wrap else 0, causal=causal)
        vis = _visible(sched, n_q, n_kv)
        for q0 in range(0, n_q, tile):
            q_last = min(q0 + tile, n_q) - 1
            first, last = tsched.kv_tile_range(sched, n_kv, q0, q_last, tile)
            keys = np.nonzero(vis[q0:q_last + 1].any(axis=0))[0]
            if keys.size:
                assert first * tile <= keys.min(), (n_q, n_kv, q0)
                assert (last + 1) * tile - 1 >= keys.max(), (n_q, n_kv, q0)


def test_shifted_wrap_shorter_than_shard_raises():
    """A wrap shorter than the q or kv length is refused: a ring hop's shard
    never exceeds its ring, and the kernels' two runs of keys assume so."""
    q = torch.zeros(1, 1, 64, 32)
    with pytest.raises(ValueError, match="wrap_n"):
        tflash.flash_attention(q, q, q, schedule="shifted", radius=4,
                               wrap_n=32)


def _hop_inputs(seed, hq, hkv, n, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((1, h, n, d)) for h in (hq, hkv, hkv)]
    w = rng.standard_normal((1, hq, n, d)).astype(np.float32)
    wl = rng.standard_normal((1, hq, n)).astype(np.float32)
    jx = [jnp.asarray(x, dtype) for x in xs]
    return jx, [to_torch(np.asarray(x), device="cpu") for x in jx], w, wl


def _hop_kw(hop):
    shift, radius, wrap, causal = _HOPS[hop]
    return dict(schedule="shifted", shift=shift, radius=radius, wrap_n=wrap,
                shifted_causal=causal)


@pytest.mark.parametrize("hop", list(_HOPS))
def test_shifted_flash_matches_reference(hop):
    """flash_attention(schedule="shifted") float32, GQA 4/2, d 32: o and
    lse (the same rows −inf, o = 0 there) within 1e-4, and the gradients of
    sum(o·w) + sum(lse·wl over finite rows), lse cotangent included, within
    the reference's grad tolerance."""
    kw = _hop_kw(hop)
    jx, tx, w, wl = _hop_inputs(31, 4, 2, _N, 32)
    jw, jwl = jnp.asarray(w), jnp.asarray(wl)

    def jloss(q, k, v):
        o, lse = jflash.flash_attention(q, k, v, return_lse=True, **kw,
                                        **_BLK)
        return jnp.sum(o * jw) + jnp.sum(
            jnp.where(jnp.isfinite(lse), lse, 0.0) * jwl), (o, lse)

    (_, (jo, jl)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*jx)
    tx = [x.clone().requires_grad_(True) for x in tx]
    to, tl = tflash.flash_attention(*tx, return_lse=True, **kw, **_BLK)
    loss = (to * torch.from_numpy(w)).sum() + (torch.where(
        torch.isfinite(tl), tl, 0.0) * torch.from_numpy(wl)).sum()
    loss.backward()
    jl = np.asarray(jl)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl.detach().numpy()), fin)
    np.testing.assert_allclose(to_numpy(to.detach()), np.asarray(jo),
                               atol=1e-4)
    np.testing.assert_allclose(tl.detach().numpy()[fin], jl[fin], atol=1e-4)
    assert (to_numpy(to.detach())[~fin] == 0).all()
    for name, a, b in zip("qkv", tx, jg):
        np.testing.assert_allclose(to_numpy(a.grad), np.asarray(b),
                                   atol=3e-4, rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("hop", ["two_runs", "band_backward"])
def test_shifted_flash_bf16_and_bound_match_reference(hop):
    """bf16 at d 64 (the reference's B9 shape under an explicit
    bound_max=True; its auto policy keeps the exact max for shifted hops)
    within 2e-2, lse within 2e-2 where finite."""
    kw = _hop_kw(hop)
    jx, tx, _, _ = _hop_inputs(32, 2, 2, _N, 64, jnp.bfloat16)
    for bound in (None, True):
        jo, jl = _ref(jflash.flash_attention, *jx, return_lse=True,
                      bound_max=bound, **kw)
        to, tl = tflash.flash_attention(*tx, return_lse=True,
                                        bound_max=bound, **kw, **_BLK)
        jl = np.asarray(jl)
        fin = np.isfinite(jl)
        np.testing.assert_array_equal(np.isfinite(tl.numpy()), fin)
        np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                                   atol=2e-2)
        np.testing.assert_allclose(tl.numpy()[fin], jl[fin], atol=2e-2)


def test_shifted_whole_ring_equals_circulant():
    """One rank holding the whole ring: shift 0, wrap_n = n, radius r is
    circulant_fa with window 2r + 1 (the port against itself, float32)."""
    _, (q, k, v), _, _ = _hop_inputs(33, 2, 2, 300, 32)
    for r in (0, 20, 149):
        o, lse = tflash.flash_attention(q, k, v, schedule="shifted", shift=0,
                                        radius=r, wrap_n=300, return_lse=True)
        oc, lc = tflash.circulant_fa(q, k, v, 2 * r + 1, return_lse=True)
        np.testing.assert_allclose(o.numpy(), oc.numpy(), atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), lc.numpy(), atol=1e-5)


def _qkv(seed, hq, hkv, n, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, n, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _np(o, lse):
    return np.asarray(o, np.float32), np.asarray(lse)


# (hop, q_dtype, kv_dtype, bound_max): the quantized route's shifted hops
_QUANT_HOPS = [("two_runs", "int8", "int8", True),
               ("band_backward", "int8", "int8", False),
               ("causal_band", None, "int8", True),
               ("circulant_wrapped", None, "float8_e4m3fn", False)]


@pytest.mark.parametrize("case", _QUANT_HOPS, ids=[
    f"{c[0]}-{c[1] or 'weight_only'}-{c[2]}" for c in _QUANT_HOPS])
def test_shifted_quantized_matches_reference(case):
    """quantized_flash_attention on the shifted schedule (B7 at d 128 and
    at d 64, where the reference keeps it on B7) vs the reference."""
    hop, q_dt, kv_dt, bound = case
    kw = dict(q_dtype=q_dt, kv_dtype=kv_dt, bound_max=bound,
              return_lse=True, **_hop_kw(hop))
    for d in (128, 64):
        arrays = _qkv(34, 2, 2, _N, d)
        j = _np(*_ref(jfq.quantized_flash_attention,
                      *(jnp.asarray(a) for a in arrays), **kw))
        to, tl = tfq.quantized_flash_attention(
            *(to_torch(a, "cpu") for a in arrays), **kw, **_BLK)
        _assert_close(j, (to_numpy(to), tl.numpy()))


@pytest.mark.parametrize("hop", ["two_runs", "band_forward"])
@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              (None, "float8_e4m3fn")])
def test_shifted_prequant_matches_reference(hop, q_dtype, kv_dtype):
    """prepare_ring_operands then quantized_flash_attention_prequant (the
    quantized ring's hop, norm bound by default), GQA 4/2, d 128."""
    arrays = _qkv(35, 4, 2, _N, 128)
    jp = jfq.prepare_ring_operands(*(jnp.asarray(a) for a in arrays),
                                   q_dtype=q_dtype, kv_dtype=kv_dtype)
    tp = tfq.prepare_ring_operands(*(torch.from_numpy(a) for a in arrays),
                                   q_dtype=q_dtype, kv_dtype=kv_dtype)
    kw = dict(return_lse=True, **_hop_kw(hop))
    del kw["shifted_causal"]
    jo = _np(*_ref(jfq.quantized_flash_attention_prequant, *jp, **kw))
    to, tl = tfq.quantized_flash_attention_prequant(*tp, **kw, **_BLK)
    _assert_close(jo, (to_numpy(to), tl.numpy()))


@pytest.mark.parametrize("hop", ["two_runs", "causal_nearly_empty",
                                 "band_backward"])
@pytest.mark.parametrize("d", [128, 64])
def test_shifted_serving_matches_reference(hop, d):
    """serving_flash_attention with ``shift`` (B6 at d 128, B8's shape at d
    64) over the same int8 cache bytes: o and lse against the matched
    oracle (Q, K, V quantized as the kernel quantizes them, under the
    reference schedule's mask) as tests/test_torch_quant.py holds them,
    and against the reference's kernel within its own miss of that oracle
    (:func:`test_torch_quant_bands._assert_e4m3`): the reference's d 64
    kernel misses it by 1.06e-3 on a row that sees two runs of keys."""
    q, k, v = _qkv(36, 2, 2, _N, d)
    jkq, jvq = jsa.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), "int8")
    kw = dict(q_dtype="int8", return_lse=True, **_hop_kw(hop))
    jo = _np(*_ref(jsa.serving_flash_attention, jnp.asarray(q), jkq, jvq,
                   **kw))
    to, tl = tsa.serving_flash_attention(
        to_torch(q, "cpu"), qarray_from_reference(jkq, "cpu"),
        qarray_from_reference(jvq, "cpu"), **kw, **_BLK)
    qd = jq.dequantize(jq.quantize(jnp.asarray(q) * d ** -0.5, "int8",
                                   axis=-1))
    shift, radius, wrap, causal = _HOPS[hop]
    sched = jsched.ShiftedMaskSchedule(_N, _N, 128, 128, shift=shift,
                                       radius=radius, wrap_n=wrap,
                                       causal=causal)
    mask = sched.mask(jnp.arange(_N)[:, None], jnp.arange(_N)[None, :])
    s = jnp.einsum("bhqd,bhkd->bhqk", qd, jq.dequantize(jkq))
    s = jnp.where(mask, s, -jnp.inf)
    mx = jnp.max(s, axis=-1, keepdims=True)
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
    lse = jnp.log(jnp.sum(jnp.exp(s - mx), axis=-1)) + mx[..., 0]
    p = jnp.where(jnp.isfinite(lse)[..., None], jnp.exp(s - lse[..., None]),
                  0.0)
    matched = _np(jnp.einsum("bhqk,bhkd->bhqd", p, jq.dequantize(jvq)), lse)
    _assert_e4m3(jo, (to_numpy(to), tl.numpy()), matched)
