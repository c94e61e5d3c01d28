"""Port parity: fused_softmax (B13a–f) against the reference's.

The same numpy inputs (made from a seed) go through the reference's
``fused_softmax`` (Pallas in interpret mode on the CPU, as its own tests run
it) and the port's, whose CPU tensors take the plain versions of the
one-pass, stats and norm kernels. The kernels themselves are held against
these plain versions on the card in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops.softmax import fused_softmax as jfused
from tpu_flash_torch.ops import softmax as tsm
from tpu_flash_torch.utils.convert import to_torch

torch.set_num_threads(2)


def _x(shape, dtype=np.float32, scale=3.0, seed=7):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        dtype)


# the reference's nine cases (tests/test_softmax.py), with the path each
# takes in the port: rows up to 16384 and columns up to 512 take one pass
@pytest.mark.parametrize("shape,axis", [
    ((37, 500), -1),        # row one-pass, ragged rows
    ((3, 5, 300), -1),      # leading dims collapse
    ((8, 70000), -1),       # row two-pass
    ((300, 40), -2),        # column one-pass, ragged lanes
    ((2, 1000, 130), -2),   # column two-pass, 3-d
    ((5000, 260), -2),      # column two-pass
    ((2, 5000, 130), -2),   # column two-pass, 3-d
    ((4, 7, 9), 0),         # moveaxis to -1
    ((10, 11, 12), 1),      # axis -2 of 3-d through the column path
])
def test_fused_softmax_matches_reference(shape, axis):
    """Port vs the reference's fused_softmax: atol 2e-6 (the reference's own
    gate against XLA's softmax; both sides sit ~1e-6 from a float64
    softmax, rounding lse in float32)."""
    x = _x(shape)
    want = np.asarray(jfused(jnp.asarray(x), axis=axis))
    got = tsm.fused_softmax(torch.from_numpy(x), axis=axis)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_bf16_io_f32_compute():
    """bf16 in and out, float32 math: within 1e-2 of the float32 softmax of
    the bf16 input, as the reference's test holds itself."""
    xb = jnp.asarray(_x((64, 3000)), jnp.bfloat16)
    got = tsm.fused_softmax(to_torch(np.asarray(xb), device="cpu"), axis=-1)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax.nn.softmax(xb.astype(jnp.float32), axis=-1))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)
    ref = np.asarray(jfused(xb, axis=-1).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2)


def test_extreme_values_stable():
    """Scale 50 on 70000-long rows (the two-pass path): finite, and each
    row sums to 1 within 1e-5."""
    got = tsm.fused_softmax(torch.from_numpy(_x((16, 70000), scale=50.0)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.double().sum(-1).numpy(), np.ones(16),
                               rtol=1e-5)


def test_column_sums_to_one():
    """axis 0 of (5000, 200): the column two-pass path; columns sum to 1
    within 1e-5."""
    got = tsm.fused_softmax(torch.from_numpy(_x((5000, 200))), axis=0)
    np.testing.assert_allclose(got.double().sum(0).numpy(), np.ones(200),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(12, 700, 1), (3, 40, 50)],
                         ids=["row", "column"])
def test_plain_paths_agree(shape):
    """The one-pass plain version and the stats + norm plain versions,
    called directly on one row and one column case, give the same softmax
    (atol 1e-6: float32 rounding of lse) and both match the reference."""
    x = _x(shape, seed=3)
    t = torch.from_numpy(x)
    one = tsm._onepass_plain(t)
    two = tsm._norm_plain(t, tsm._stats_plain(t))
    np.testing.assert_allclose(one.numpy(), two.numpy(), atol=1e-6)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=1))
    np.testing.assert_allclose(one.numpy(), want, atol=2e-6)
    np.testing.assert_allclose(two.numpy(), want, atol=2e-6)


def test_onepass_threshold():
    """The port's own threshold, from the kernel's 64 KiB of shared memory:
    rows up to 16384 and 32-fiber column groups up to 512 take one pass."""
    assert tsm.onepass_fits(16384, 1) and not tsm.onepass_fits(16385, 1)
    assert tsm.onepass_fits(512, 40) and not tsm.onepass_fits(513, 40)
    with pytest.raises(ValueError, match="block_rows"):
        tsm.fused_softmax(torch.zeros(2, 3), block_rows=0)
