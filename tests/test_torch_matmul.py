"""Port parity: matmul (B14), matvec, circulant_matmul and the sparse
circulant builders against the reference's.

The same numpy inputs go through the reference (Pallas in interpret mode on
the CPU) and the port, whose CPU tensors take matmul's plain version
(k-chunked products summed in float32). Float32 within 1e-4 (the reference's
own test allows 1e-2; both sides sum exact float32 products in another
order). The kernel is held against the plain version on the card in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import matmul as jmm
from tpu_flash.utils import layout as jlayout
from tpu_flash_torch.ops import matmul as tmm
from tpu_flash_torch.utils import layout as tlayout

torch.set_num_threads(2)


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(256, 256, 256), (300, 130, 70),
                                   (1024, 512, 256)])
def test_matmul_matches_reference(shape):
    m, k, n = shape
    a, b = _r(1, m, k), _r(2, k, n)
    want = np.asarray(jmm.matmul(jnp.asarray(a), jnp.asarray(b), block_m=256,
                                 block_n=256, block_k=128))
    got = tmm.matmul(torch.from_numpy(a), torch.from_numpy(b), block_m=256,
                     block_n=256, block_k=128)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_matmul_out_dtype_and_blocks():
    """out_dtype rounds the float32 sum once; block sizes are checked."""
    a, b = _r(3, 64, 96), _r(4, 96, 40)
    got = tmm.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jmm.matmul(jnp.asarray(a), jnp.asarray(b),
                                 out_dtype=jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(ValueError, match="block_k"):
        tmm.matmul(torch.from_numpy(a), torch.from_numpy(b), block_k=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmm.matmul(torch.from_numpy(a), torch.from_numpy(a))


def test_matvec_matches_reference():
    a, x = _r(5, 257, 129), _r(6, 129)
    want = np.asarray(jmm.matvec(jnp.asarray(a), jnp.asarray(x), block_m=128,
                                 block_k=128))
    got = tmm.matvec(torch.from_numpy(a), torch.from_numpy(x), block_m=128,
                     block_k=128)
    assert got.shape == (257,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("m,n,k,dtype,route", [
    (4096, 1, 4096, torch.bfloat16, "gemv"),
    (257, 1, 129, torch.float32, "gemv"),
    (4096, 4096, 4096, torch.bfloat16, "wgmma"),
    (4000, 3000, 1000, torch.bfloat16, "wgmma"),
    (64, 64, 0, torch.bfloat16, "wgmma"),
    (300, 72, 130, torch.bfloat16, "wmma"),
    (300, 70, 128, torch.bfloat16, "wmma"),
    (4096, 4096, 4096, torch.float32, "fma"),
])
def test_matmul_route_by_shape_and_dtype(m, n, k, dtype, route):
    """The kernel route follows shape and dtype alone: one column → gemv;
    bf16 with k and n multiples of 8 (16-byte TMA row pitches) → wgmma,
    other bf16 (k = 130, n = 70) → wmma; float32 → fma."""
    assert tmm._matmul_route(m, n, k, dtype) == route
    assert route in tmm.MATMUL_ROUTES


@pytest.mark.parametrize("cols", [7, None], ids=["matrix", "vector"])
def test_circulant_matmul_matches_reference(cols):
    n, w = 64, 9
    vals = _r(7, n, w)
    x = _r(8, n, cols) if cols else _r(8, n)
    want = np.asarray(jmm.circulant_matmul(jnp.asarray(vals), jnp.asarray(x)))
    got = tmm.circulant_matmul(torch.from_numpy(vals), torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    dense = tlayout.circulant_matrix(torch.from_numpy(vals)).to_dense()
    np.testing.assert_allclose(got.numpy(), (dense @ torch.from_numpy(x)).numpy(),
                               atol=1e-4)


def test_circulant_builders_match_reference():
    """circulant_neighbors, circulant_matrix and batch_circulant equal the
    reference's (the sparse ones densified), exactly."""
    for n, w in ((12, 5), (9, 9), (16, 1)):
        np.testing.assert_array_equal(
            tlayout.circulant_neighbors(n, w, device="cpu").numpy(),
            np.asarray(jlayout.circulant_neighbors(n, w)))
    vals = _r(9, 12, 5)
    np.testing.assert_array_equal(
        tlayout.circulant_matrix(torch.from_numpy(vals)).to_dense().numpy(),
        np.asarray(jlayout.circulant_matrix(jnp.asarray(vals)).todense()))
    bvals = _r(10, 3, 16, 5)
    np.testing.assert_array_equal(
        tlayout.batch_circulant(torch.from_numpy(bvals)).to_dense().numpy(),
        np.asarray(jlayout.batch_circulant(jnp.asarray(bvals)).todense()))
    with pytest.raises(ValueError, match="odd"):
        tlayout.circulant_neighbors(8, 4, device="cpu")
