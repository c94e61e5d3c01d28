"""Port parity: Ulysses sequence parallelism (``parallel/ulysses.py``).

``ulysses_fa`` over 4 virtual sequence ranks of a CPU mesh against the
reference's ``ulysses_fa`` on its 4-device sequence mesh, every case of
``tests/test_ulysses.py`` (b 1, h 4, n 1024, d 32, blocks of 128): dense,
causal, sliding (radius 64 and 200), circulant, the GQA repeat (2 kv
heads over 4 ranks), GQA that survives the split (4 kv heads), the
agreement with the ring, and the causal gradient; then the int8 quantized
route against the reference's, and a planted fault (the inverse
all-to-all's heads concatenated in reverse rank order) that must miss.

Tolerances: the reference's own (atol 3e-5, rtol 1e-4; gradients atol
5e-4, rtol 1e-3); the quantized route as ``tests/test_torch_quant.py``
holds o (atol 5e-3, rtol 1e-2).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.parallel import make_mesh as jmake_mesh
from tpu_flash.parallel.ulysses import ulysses_fa as julysses_fa
from tpu_flash_torch.ops import flash
from tpu_flash_torch.parallel import make_mesh, ring_dense_fa, ulysses, ulysses_fa
from tpu_flash_torch.parallel.ulysses import ulysses_attention

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(jax.device_count() < 4,
                                reason="needs 4 virtual devices")

_BLK = dict(block_q=128, block_kv=128)
_TOL = dict(atol=3e-5, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmake_mesh(data=1, model=1, seq=4)


def _mesh():
    return make_mesh(seq=4, devices="cpu")


def _qkv(seed, b=1, h=4, n=1024, d=32, hkv=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, hh, n, d)).astype(np.float32)
            for hh in (h, hkv or h, hkv or h)]


def _both(arrays, **kw):
    jo = julysses_fa(_jmesh(), **kw, **_BLK)(*(jnp.asarray(a) for a in arrays))
    to = ulysses_fa(_mesh(), **kw, **_BLK)(*(torch.from_numpy(a)
                                              for a in arrays))
    return to.numpy(), np.asarray(jo)


@pytest.mark.parametrize("schedule,radius", [
    ("dense", 0), ("causal", 0), ("local", 64), ("local", 200),
    ("circulant", 64)])
def test_ulysses_matches_reference(schedule, radius):
    """Every schedule of tests/test_ulysses.py against the reference's."""
    got, want = _both(_qkv(11), schedule=schedule, radius=radius)
    np.testing.assert_allclose(got, want, **_TOL)


@pytest.mark.parametrize("hkv,h", [(2, 4), (4, 8)])
def test_ulysses_gqa_matches_reference(hkv, h):
    """kv heads 2 over 4 ranks (repeated up to the q heads) and 4 (the
    GQA ratio survives the split) against the reference's."""
    got, want = _both(_qkv(12, h=h, n=512, hkv=hkv), schedule="causal")
    np.testing.assert_allclose(got, want, **_TOL)


def test_ulysses_matches_ring():
    """Ulysses and the ring (both the port's) agree (b 2, n 512)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(13, b=2, n=512))
    o_u = ulysses_fa(_mesh(), schedule="causal", **_BLK)(q, k, v)
    o_r = ring_dense_fa(q, k, v, 4, pattern="causal", **_BLK)
    np.testing.assert_allclose(o_u.numpy(), o_r.numpy(), **_TOL)


def test_ulysses_grad_matches_reference():
    """Gradients of sum(o²) through the all-to-alls (each backward the
    other direction) against jax.grad of the reference's."""
    arrays = _qkv(14, n=512)
    fn = julysses_fa(_jmesh(), schedule="causal", **_BLK)
    jg = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    (ulysses_fa(_mesh(), schedule="causal", **_BLK)(*xs) ** 2).sum().backward()
    for name, x, g in zip("qkv", xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=5e-4,
                                   rtol=1e-3, err_msg=f"d{name}")


def test_ulysses_quantized_matches_reference():
    """The int8 route (q and K/V int8, d 32: B6 a rank) against the
    reference's."""
    got, want = _both(_qkv(15, n=512), schedule="causal", q_dtype="int8",
                      kv_dtype="int8")
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=5e-3,
                               rtol=1e-2)


def test_ulysses_reversed_inverse_fails():
    """A planted fault, the inverse's heads in reverse rank order, moves
    the output by far more than the tolerance; the right order equals the
    single-device kernel."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, n=256))
    axis = _mesh().axis("seq")
    good = ulysses_attention(q, k, v, axis, schedule="causal", **_BLK)
    inverse = ulysses._heads_to_seq
    with mock.patch.object(ulysses, "_heads_to_seq",
                           lambda parts, spec: inverse(parts[::-1], spec)):
        bad = ulysses_attention(q, k, v, axis, schedule="causal", **_BLK)
    one = flash.flash_attention(q, k, v, schedule="causal", **_BLK)
    np.testing.assert_allclose(good.numpy(), one.numpy(), **_TOL)
    assert float((bad - one).abs().max()) > 0.1
