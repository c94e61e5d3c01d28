"""Port parity: ring attention (``tpu_flash_torch/parallel/ring.py``).

The port's ring over 8 virtual ranks in one process against the
reference's ``ring_dense_fa`` on its 8-device CPU sequence mesh (Pallas in
interpret mode, blocks of 128), on the reference's test shapes (b 1, h 2,
n 1024, d 32): dense, causal, local and circulant (radius 200), an int8 and
an int4 quantized ring, and the causal ring's gradient against
``jax.grad`` of the reference ring. Then what only the port has: hops
skipped by the band (fewer kernel calls than the dense ring), the
quantized ring handing 8-bit (int4: packed) shards to its transport, two
``torch.distributed`` gloo processes of two ranks each equal bit for bit to
one process of four virtual ranks (forward and gradient), and the
sequence-parallel train step of a tiny model against the plain one.

Tolerances: float32 o 1e-4 against the reference (both sides float32 in
another order); the gradient atol 5e-4 / rtol 1e-3 (the reference's ring
gradient test); the quantized ring as tests/test_torch_quant.py holds o
(atol 5e-3, rtol 1e-2).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.parallel import make_mesh
from tpu_flash.parallel import ring_dense_fa as jring_dense_fa
from tpu_flash_torch import graft_entry
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.parallel import ring as tring
from tpu_flash_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

_BLK = dict(block_q=128, block_kv=128)
_RANKS = 8
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq_mesh():
    return make_mesh(data=1, model=1, seq=_RANKS)


def _qkv(seed, b=1, h=2, n=1024, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("pattern,radius", [
    ("dense", 0), ("causal", 0), ("local", 200), ("circulant", 200)])
def test_ring_matches_reference(seq_mesh, pattern, radius):
    """ring_dense_fa over 8 virtual ranks vs the reference's over its 8
    devices: float32 o within 1e-4."""
    arrays = _qkv(41)
    jo = jring_dense_fa(seq_mesh, pattern=pattern, radius=radius, **_BLK)(
        *(jnp.asarray(a) for a in arrays))
    to = tring.ring_dense_fa(*(to_torch(a, "cpu") for a in arrays), _RANKS,
                             pattern=pattern, radius=radius, **_BLK)
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo), atol=1e-4)


@pytest.mark.parametrize("q_dtype,kv_dtype", [("int8", "int8"),
                                              ("int8", "int4")])
def test_ring_quantized_matches_reference(seq_mesh, q_dtype, kv_dtype):
    """The quantized local ring (radius 200; K/V quantized once per shard,
    int4 unpacked each hop) vs the reference's."""
    arrays = _qkv(42)
    kw = dict(pattern="local", radius=200, q_dtype=q_dtype,
              kv_dtype=kv_dtype, **_BLK)
    jo = jring_dense_fa(seq_mesh, **kw)(*(jnp.asarray(a) for a in arrays))
    to = tring.ring_dense_fa(*(to_torch(a, "cpu") for a in arrays), _RANKS,
                             **kw)
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                               atol=5e-3, rtol=1e-2)


def test_ring_grad_matches_reference(seq_mesh):
    """Gradients of sum(o·w) through the causal ring (b 1, h 1, n 512) vs
    jax.grad of the reference's ring."""
    q, k, v, w = _qkv(43, h=1, n=512) + [
        np.random.default_rng(44).standard_normal((1, 1, 512, 32)).astype(
            np.float32)]
    fn = jring_dense_fa(seq_mesh, pattern="causal", **_BLK)
    jw = jnp.asarray(w)
    jg = jax.grad(lambda *a: jnp.sum(fn(*a) * jw), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tx = [to_torch(a, "cpu").requires_grad_(True) for a in (q, k, v)]
    o = tring.ring_dense_fa(*tx, _RANKS, pattern="causal", **_BLK)
    (o * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip("qkv", tx, jg):
        np.testing.assert_allclose(to_numpy(a.grad), np.asarray(b),
                                   atol=5e-4, rtol=1e-3, err_msg=f"d{name}")


def _count_plain_calls(monkeypatch):
    calls = []
    fn = tflash._flash_fwd_plain
    monkeypatch.setattr(tflash, "_flash_fwd_plain",
                        lambda *a, **kw: (calls.append(1), fn(*a, **kw))[1])
    return calls


def test_ring_hop_skipping(monkeypatch):
    """The banded rings skip whole hops: with nl 128 and radius 64 the
    circulant runs hops 0, 1 and 7 on every rank (24 calls of the plain
    kernel), the local ring hop 0 and the hops from the two neighbours
    (22), the causal ring skips the hops from later ranks (36), the dense
    ring runs all 64; each as ``hop_schedule`` plans it."""
    calls = _count_plain_calls(monkeypatch)
    q, k, v = (to_torch(a, "cpu") for a in _qkv(45, h=1))
    counts = {}
    for pattern in ("dense", "causal", "local", "circulant"):
        calls.clear()
        tring.ring_dense_fa(q, k, v, _RANKS, pattern=pattern, radius=64,
                            **_BLK)
        counts[pattern] = len(calls)
    assert counts == dict(dense=64, causal=36, local=22, circulant=24)
    planned = {p: sum(tring.hop_schedule(p, 64, _RANKS, 128, t, r) is not None
                      for t in range(_RANKS) for r in range(_RANKS))
               for p in counts}
    assert planned == counts


class _Recording(tring.RingTransport):
    """The one-process transport, recording what it is handed."""

    def __init__(self):
        super().__init__(single=True)
        self.sent = []

    def start(self, tensors, direction=1):
        self.sent.append([(t.dtype, tuple(t.shape)) for t in tensors])
        return super().start(tensors, direction)


@pytest.mark.parametrize("kv_dtype,width", [("int8", 32), ("int4", 16),
                                            ("float8_e4m3fn", 32)])
def test_ring_quantized_transport_carries_bytes(kv_dtype, width):
    """The quantized ring hands its transport 8-bit K/V values of shard
    shape (int4: packed, half the width) with their float32 scales, once a
    hop but the last: never bf16 or float32 values."""
    q, k, v = (to_torch(a, "cpu") for a in _qkv(46, h=1))
    transport = _Recording()
    tring.ring_attention(q, k, v, pattern="causal", local_ranks=_RANKS,
                         q_dtype="float8_e4m3fn" if kv_dtype.startswith(
                             "float8") else "int8",
                         kv_dtype=kv_dtype, transport=transport, **_BLK)
    assert len(transport.sent) == _RANKS - 1
    value = torch.float8_e4m3fn if kv_dtype.startswith("float8") else \
        torch.int8
    for sent in transport.sent:
        assert sent == [(value, (1, 1, 128, width)),
                        (torch.float32, (1, 1, 128, 1)),
                        (value, (1, 1, 128, width)),
                        (torch.float32, (1, 1, 1, 32))]


_WORKER = """
import datetime, sys
import torch
import torch.distributed as dist
from tpu_flash_torch.parallel import ring

rank, world, init, inputs, out = sys.argv[1:]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
q, k, v, w = torch.load(inputs)
n = q.shape[2] // world
part = slice(rank * n, (rank + 1) * n)
res = {}
for pattern in ("causal", "local"):
    xs = [x[:, :, part].clone().requires_grad_(True) for x in (q, k, v)]
    o = ring.ring_attention(*xs, pattern=pattern, radius=100, local_ranks=2,
                            block_q=128, block_kv=128)
    (o * w[:, :, part]).sum().backward()
    res[pattern] = [o.detach()] + [x.grad for x in xs]
torch.save(res, out)
dist.destroy_process_group()
"""


def test_ring_gloo_processes_match_virtual_ranks(tmp_path):
    """Two gloo processes of two ranks each (P2P rotation, its transpose in
    the backward) give the same output and gradients, bit for bit, as one
    process of four virtual ranks, on the causal ring and the local one
    (radius 100 over ranks of 128: shifted hops forward and back). The
    processes rendezvous through a file and get 240 s."""
    arrays = _qkv(47, h=2, n=512)
    w = np.random.default_rng(48).standard_normal((1, 2, 512, 32)).astype(
        np.float32)
    q, k, v, wt = (torch.from_numpy(a) for a in (*arrays, w))
    torch.save((q, k, v, wt), tmp_path / "inputs.pt")
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), "2",
         f"file://{tmp_path / 'rendezvous'}", str(tmp_path / "inputs.pt"),
         str(tmp_path / f"out{r}.pt")], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    got = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]
    for pattern in ("causal", "local"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tring.ring_attention(*xs, pattern=pattern, radius=100,
                                 local_ranks=4, **_BLK)
        (o * wt).sum().backward()
        want = [o.detach()] + [x.grad for x in xs]
        for r in range(2):
            part = slice(r * 256, (r + 1) * 256)
            for name, a, b in zip(("o", "dq", "dk", "dv"), got[r][pattern],
                                  want):
                assert torch.equal(a, b[:, :, part]), (pattern, r, name)


def test_seq_parallel_train_step_matches_plain():
    """The causal ring over 4 virtual ranks as a float32 2-layer model's
    attention vs the model's own flash attention: loss within 1e-5
    relative, every gradient within 1e-3 of its largest entry; then one
    seq_parallel_train_step and one train_step (lr 0.5) leave parameters
    within 1e-5 of each other."""
    cfg = ttfm.ModelConfig(vocab_size=256, dim=128, num_layers=2,
                           num_q_heads=4, num_kv_heads=2, head_dim=32,
                           block_q=128, block_kv=128, dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(49).integers(0, 256,
                                                              (2, 65)))
    p_ring = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p_plain = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss_r, grads_r = graft_entry.loss_and_grads(
        p_ring, toks, cfg, attn_fn=tring.ring_attn_fn(4, pattern="causal"))
    loss_p, grads_p = graft_entry.loss_and_grads(p_plain, toks, cfg)
    assert abs(float(loss_r) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for (name, _), a, b in zip(graft_entry.named_leaves(p_ring), grads_r,
                               grads_p):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) / scale <= 1e-3, name
    _, step_r = graft_entry.seq_parallel_train_step(p_ring, toks, cfg, 0.5,
                                                    ranks=4)
    _, step_p = graft_entry.train_step(p_plain, toks, cfg, 0.5)
    assert float(step_r) == pytest.approx(float(loss_r), rel=1e-6)
    for a, b in zip(graft_entry.param_leaves(p_ring),
                    graft_entry.param_leaves(p_plain)):
        assert float((a - b).abs().max()) <= 1e-5


def test_ring_rejects_bad_arguments():
    """Unknown patterns, q_dtype without kv_dtype, int4 with fp8 Q and a
    sequence that does not split into the ranks raise ValueError."""
    q, k, v = (to_torch(a, "cpu") for a in _qkv(50, h=1, n=256))
    for kw in (dict(pattern="strided"), dict(q_dtype="int8"),
               dict(q_dtype="float8_e4m3fn", kv_dtype="int4")):
        with pytest.raises(ValueError):
            tring.ring_dense_fa(q, k, v, 4, **kw)
    with pytest.raises(ValueError):
        tring.ring_dense_fa(q, k, v, 3)

