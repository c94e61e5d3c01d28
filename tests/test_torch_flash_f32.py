"""The float32 forward's 3×TF32 product (``ops/flash_bwd.py:tf32x3``) on
the CPU.

On the card B1 takes its float32 products in three TF32 passes
(``csrc/flash_fwd_f32.cuh``, at widths 256 and 512 the head dim split
across a cluster): each operand split into hi (its low 13 bits cleared, as
the tensor cores read a float32 word) and lo = x − hi, then hi·hi + hi·lo +
lo·hi, for S = Q·Kᵀ and for P·V with P unrounded. Here the plain forward
runs with its products through that model, on the same numpy inputs as the
reference's ``flash_attention`` (Pallas in interpret mode under
``jax.jit``, float32):

- o and lse stay within 1e-4 of the reference;
- they stay within 1e-4 of the exact plain forward (the card's float32
  kernel-vs-plain gate);
- the model with one TF32 pass (hi·hi alone) misses that 1e-4 on o or lse:
  the gate tells 3×TF32 from TF32.

The CUDA kernel is held against both plain paths on the card in
``tests/test_torch_kernels.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import flash as jflash
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import flash_bwd as tflash_bwd

torch.set_num_threads(2)

# the card's float32 kernel-vs-plain gate (chip_smoke.py TOL_F32), and the
# reference's own float32 tolerance against the port (test_torch_flash.py)
TOL = 1e-4

# (name, schedule, hq, hkv, n, d, radius, section, bound_max): causal with
# GQA at a ragged n at every compiled width (d 512 at n ≤ 160), then
# local_causal, the circulant band, the block-diagonal kind and the dense
# norm bound, each at two of the widths (the card splits the head dim of
# 256 and 512 across a cluster)
CASES = [
    ("causal_gqa_d64", "causal", 4, 2, 200, 64, 0, 0, False),
    ("causal_gqa_d128", "causal", 4, 2, 200, 128, 0, 0, False),
    ("causal_gqa_d256", "causal", 4, 2, 150, 256, 0, 0, False),
    ("causal_gqa_d512", "causal", 2, 1, 150, 512, 0, 0, False),
    ("local_causal_d128", "local_causal", 2, 1, 300, 128, 40, 0, False),
    ("local_causal_d512", "local_causal", 2, 1, 160, 512, 24, 0, False),
    ("circulant_d64", "circulant", 2, 1, 256, 64, 20, 0, False),
    ("circulant_d256", "circulant", 2, 1, 150, 256, 12, 0, False),
    ("block_d128", "block", 2, 1, 256, 128, 0, 64, False),
    ("block_d512", "block", 2, 1, 128, 512, 0, 32, False),
    ("dense_bound_d64", "dense", 2, 2, 200, 64, 0, 0, True),
    ("dense_bound_d256", "dense", 2, 1, 150, 256, 0, 0, True),
]


def _inputs(name):
    _, schedule, hq, hkv, n, d, radius, section, bound = next(
        c for c in CASES if c[0] == name)
    rng = np.random.default_rng(24)
    q = rng.standard_normal((1, hq, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, hkv, n, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(schedule=schedule, radius=radius, section=section,
              bound_max=bound)
    return (q, k, v), kw, hq, hkv


def _reference(q, k, v, kw):
    """The reference's flash_attention (interpret mode, jitted) → (o, lse)
    as numpy, (heads, n, ·)."""
    fn = jax.jit(functools.partial(jflash.flash_attention, return_lse=True,
                                   interpret=True, **kw))
    o, lse = fn(*(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o, np.float32)[0], np.asarray(lse, np.float32)[0]


def _plain(q, k, v, kw, hq, hkv, products):
    """The port's plain forward on the operands ``flash_attention`` makes
    (q prescaled by d^-½·log2 e, the circulant's halo-extended K/V, its
    schedule) with ``products`` as its product → (o, lse) as numpy."""
    n, d = q.shape[2], q.shape[3]
    sched = tflash.build_schedule(kw["schedule"], n, n, 1024, 2048,
                                  radius=kw["radius"], section=kw["section"])
    qf = torch.from_numpy(q[0]) * (1.0 / math.sqrt(d) * tflash.LOG2E)
    kf, vf = torch.from_numpy(k[0]), torch.from_numpy(v[0])
    if kw["schedule"] == "circulant":
        kf = tflash.halo_extend(kf, kw["radius"], dim=1)
        vf = tflash.halo_extend(vf, kw["radius"], dim=1)
    o, lse = tflash._flash_fwd_plain(qf, kf, vf, sched, hq, hkv,
                                     kw["bound_max"], products=products)
    return o.numpy(), lse.numpy()


@functools.lru_cache(maxsize=None)
def _run(name):
    """One case's (o, lse): the reference's, and the plain forward's exact,
    through the 3×TF32 model and through one TF32 pass."""
    (q, k, v), kw, hq, hkv = _inputs(name)
    return dict(
        reference=_reference(q, k, v, kw),
        exact=_plain(q, k, v, kw, hq, hkv, None),
        model=_plain(q, k, v, kw, hq, hkv, tflash_bwd.tf32x3),
        one_pass=_plain(q, k, v, kw, hq, hkv,
                        functools.partial(tflash_bwd.tf32x3, passes=1)))


def _errs(got, want):
    """max |Δo| and max |Δlse| over the finite lse entries; the −inf rows
    (none seen) must agree."""
    (go, gl), (wo, wl) = got, want
    fin = np.isfinite(wl)
    np.testing.assert_array_equal(np.isfinite(gl), fin)
    return (float(np.abs(go - wo).max()),
            float(np.abs(gl[fin] - wl[fin]).max()) if fin.any() else 0.0)


IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name", IDS)
def test_tf32x3_forward_matches_reference(name):
    """The plain forward through the 3×TF32 model vs the reference's
    float32 flash_attention: o and lse within 1e-4."""
    r = _run(name)
    assert max(_errs(r["model"], r["reference"])) <= TOL


@pytest.mark.parametrize("name", IDS)
def test_tf32x3_forward_within_plain_gate(name):
    """The 3×TF32 model stays within 1e-4 of the exact plain forward on o
    and lse, the gate that holds the card's float32 kernel."""
    r = _run(name)
    assert max(_errs(r["model"], r["exact"])) <= TOL


@pytest.mark.parametrize("name", IDS)
def test_one_tf32_pass_misses_plain_gate(name):
    """One TF32 pass (hi·hi alone) misses the 1e-4 gate on o or lse, so
    the gate tells 3×TF32 from TF32 in every case."""
    r = _run(name)
    assert max(_errs(r["one_pass"], r["exact"])) > TOL
