"""The float32 backward's 3×TF32 product (``ops/flash_bwd.py:tf32x3``) on
the CPU.

On the card B4/B5 take float32 products in three TF32 passes
(``csrc/flash_bwd_f32.cuh``, at widths 256 and 512 the head dim split
across a cluster): each operand split into hi (its low 13 bits
cleared, as the tensor cores read a float32 word) and lo = x − hi, then
hi·hi + hi·lo + lo·hi. Here the plain backward runs with its products
through that model, on the same numpy inputs as the reference's
``flash_backward`` (Pallas in interpret mode under ``jax.jit``, float32):

- it stays within the reference at ``tests/test_grad.py``'s atol 3e-4 /
  rtol 1e-3;
- it stays within 1e-4 of the largest grad of the exact plain backward
  (the card's kernel-vs-plain gate in float32);
- the model with one TF32 pass (hi·hi alone) misses that 1e-4: the gate
  tells 3×TF32 from TF32.

The CUDA kernels are held against both plain paths on the card in
``tests/test_torch_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import flash_bwd as jflash_bwd
from tpu_flash.ops import schedule as jsched
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import flash_bwd as tflash_bwd
from tpu_flash_torch.ops import schedule as tsched

torch.set_num_threads(2)

# the card's float32 kernel-vs-plain gate (chip_smoke.py TOL_BWD_PLAIN)
TOL_PLAIN = 1e-4
BLK = 128

# (name, schedule, hq, hkv, n, d, radius, quant): causal at every compiled
# width (GQA 2, ragged n off the 128 grid), local_causal and the int8 dp
# product at 128 and at the widths whose head dim the card splits across a
# cluster (256, 512)
CASES = [
    ("causal_d64", "causal", 4, 2, 200, 64, 0, None),
    ("causal_d128", "causal", 2, 2, 256, 128, 0, None),
    ("local_causal_d128", "local_causal", 4, 2, 300, 128, 40, None),
    ("dp_causal_d128", "causal", 4, 2, 200, 128, 0, "dp"),
    ("causal_d256", "causal", 4, 2, 200, 256, 0, None),
    ("causal_d512", "causal", 4, 2, 150, 512, 0, None),
    ("local_causal_d256", "local_causal", 4, 2, 300, 256, 40, None),
    ("dp_causal_d256", "causal", 4, 2, 200, 256, 0, "dp"),
    ("dp_causal_d512", "causal", 2, 1, 150, 512, 0, "dp"),
]


def _schedules(schedule, n, radius):
    if schedule == "causal":
        return (tsched.CausalSchedule(n, n, BLK, BLK),
                jsched.CausalSchedule(n, n, BLK, BLK))
    return (tsched.LocalSchedule(n, n, BLK, BLK, radius=radius, causal=True),
            jsched.LocalSchedule(n, n, BLK, BLK, radius=radius, causal=True))


def _pad_rows(x, n, fill=0.0):
    """numpy (rows, m, ·) → (rows, n, ·), the reference's padded layout."""
    pad = [(0, 0), (0, n - x.shape[1])] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pad, constant_values=fill)


def _reference(args, jsch, hq, hkv, quant):
    """The reference's flash_backward (interpret mode, jitted) on the
    port's unpadded operands: rows padded to its blocks (padded lse rows
    −inf), K/V expanded to the q heads, dK/dV summed over each group."""
    q, k, v, o, lse, do = args
    g, n_q, n_kv = hq // hkv, q.shape[1], k.shape[1]
    qs = [_pad_rows(x, jsch.n_q_pad) for x in (q, o, do)]
    kv = [_pad_rows(np.repeat(x, g, axis=0), jsch.n_kv_pad) for x in (k, v)]
    lse = _pad_rows(lse, jsch.n_q_pad, -np.inf)
    fn = jax.jit(lambda q_, k_, v_, o_, l_, do_: jflash_bwd.flash_backward(
        q_, k_, v_, o_, l_, do_, None, jsch, interpret=True, quant=quant))
    out = fn(*(jnp.asarray(x) for x in (qs[0], kv[0], kv[1], qs[1], lse,
                                        qs[2])))
    dq, dk, dv = (np.asarray(x, np.float32) for x in out)
    return (dq[:, :n_q], dk[:, :n_kv].reshape(hkv, g, n_kv, -1).sum(1),
            dv[:, :n_kv].reshape(hkv, g, n_kv, -1).sum(1))


@functools.lru_cache(maxsize=None)
def _run(name):
    """One case's grads: the reference's, and the plain backward's exact,
    through the 3×TF32 model and through one TF32 pass (numpy)."""
    _, schedule, hq, hkv, n, d, radius, quant = next(
        c for c in CASES if c[0] == name)
    tsch, jsch = _schedules(schedule, n, radius)
    rng = np.random.default_rng(22)
    q = (rng.standard_normal((hq, n, d)) * (d ** -0.5 * tflash.LOG2E)).astype(
        np.float32)
    k, v = (rng.standard_normal((hkv, n, d)).astype(np.float32)
            for _ in range(2))
    o, lse = tflash._flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                     tsch, hq, hkv)
    do = rng.standard_normal((hq, n, d)).astype(np.float32)
    args = (q, k, v, o.numpy(), lse.numpy(), do)
    targs = [torch.from_numpy(x) for x in args]

    def plain(products):
        out = tflash_bwd._flash_bwd_plain(*targs, None, tsch, hq, hkv, quant,
                                          products=products)
        return [x.numpy() for x in out]

    return dict(reference=_reference(args, jsch, hq, hkv, quant),
                exact=plain(None), model=plain(tflash_bwd.tf32x3),
                one_pass=plain(functools.partial(tflash_bwd.tf32x3,
                                                 passes=1)))


def _rel_max(a, b):
    """max |a − b| / max |b|: the card's kernel-vs-plain measure."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name", IDS)
def test_tf32x3_backward_matches_reference(name):
    """The plain backward through the 3×TF32 model vs the reference's
    float32 flash_backward: atol 3e-4, rtol 1e-3 (``test_grad.py``)."""
    r = _run(name)
    for x, a, b in zip("qkv", r["model"], r["reference"]):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=1e-3,
                                   err_msg=f"d{x} mismatch")


@pytest.mark.parametrize("name", IDS)
def test_tf32x3_backward_within_plain_gate(name):
    """The 3×TF32 model stays within 1e-4 of the largest grad of the exact
    plain backward, the gate that holds the card's float32 kernels."""
    r = _run(name)
    errs = [_rel_max(a, b) for a, b in zip(r["model"], r["exact"])]
    assert max(errs) <= TOL_PLAIN, errs


@pytest.mark.parametrize("name", IDS)
def test_one_tf32_pass_misses_plain_gate(name):
    """One TF32 pass (hi·hi alone) misses the 1e-4 gate on each grad that
    goes through a TF32 product, so the gate tells 3×TF32 from TF32 (dv
    under dp too: P·dO stays a float product)."""
    r = _run(name)
    errs = [_rel_max(a, b) for a, b in zip(r["one_pass"], r["exact"])]
    assert min(errs) > TOL_PLAIN, errs


def test_tf32_split_is_exact_in_its_parts():
    """hi has its low 13 bits clear; hi + lo differs from x by what
    truncating lo drops (below 2⁻²¹·|x|); lo is below one tf32 ulp of x."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32) * 10.0)
    hi, lo = tflash_bwd.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    assert (lo.abs() < 2.0 ** -10 * x.abs()).all()


@pytest.mark.parametrize("k", [8, 128, 1024])
def test_tf32x3_product_error(k):
    """On randn matrices the 3×TF32 product sits within 1e-5 of the largest
    float64 entry, near float32's own error; one pass lands above 1e-4."""
    rng = np.random.default_rng(k)
    a, b = (torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
            for _ in range(2))
    exact = a.double() @ b.double().T
    scale = float(exact.abs().max())

    def err(passes):
        got = tflash_bwd.tf32x3("ik,jk->ij", a, b, passes=passes)
        return float((got.double() - exact).abs().max()) / scale

    assert err(3) <= 1e-5
    assert err(1) > 1e-4


@pytest.mark.parametrize("d", [64, 128])
def test_tf32_probe_models_part(d):
    """bench/tf32_probe.py tells truncation from rounding by which plain
    model the one-pass kernel follows: on its patterned operands the two
    models part, on every grad, by far more (here 100×) than the 3×TF32
    model sits from the exact backward, the scale of the kernel's own
    float32 error."""
    from tpu_flash_torch.bench import tf32_probe

    args = tf32_probe.operands(d, torch.device("cpu"))
    trunc, rounded = tf32_probe.rounding_models(args)
    exact = tflash_bwd._flash_bwd_plain(*args)
    model = tflash_bwd._flash_bwd_plain(*args, products=tflash_bwd.tf32x3)
    for t, r, e, m in zip(trunc, rounded, exact, model):
        assert tf32_probe.rel(t, r) > 100 * tf32_probe.rel(m, e)
