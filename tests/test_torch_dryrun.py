"""Port parity: the multi-chip dry run (``graft_entry.dryrun_multichip``)
and the parallel modules across ``torch.distributed`` processes.

``dryrun_multichip(8)`` on 8 virtual CPU ranks (data 2 × model 2 × seq 2)
prints the reference's lines, decodes on the seq-sharded engine and runs
the expert-parallel phase (8 experts over 4 expert ranks), whose loss and
updated experts match an unsharded step of the same MoE model; its
DP + TP + SP train step (``dryrun_train_step``) matches the unsharded
``train_step`` on the same float32 parameters: loss within 1e-5 relative,
Δwq within 1e-5 of its largest entry plus the update's own float32
rounding (an ulp of the largest weight; lr 1, so that Δ is the gradient).
``dryrun_multichip(2, processes=2)`` runs the step in two gloo worker
processes. Then one test of two gloo processes (a file rendezvous under
``tmp_path``, 240 s) that run tensor parallelism over 2 (the TP forward
and the dry run's step on a 1 × 2 × 2 mesh, TP across the processes),
sequence sharding over 2 (``sharded_paged_attention`` and the ring on the
mesh's sequence sub-group) and Ulysses over 2 (forward and gradient),
each equal to one process of virtual ranks within float32 rounding.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_flash_torch import graft_entry
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.parallel import make_mesh, ring, shardings
from tpu_flash_torch.parallel.ring_decode import sharded_paged_attention
from tpu_flash_torch.parallel.ulysses import ulysses_attention

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_on_virtual_ranks(capsys):
    """dryrun_multichip(8): the (2, 2, 2) mesh, a finite loss, an update,
    the seq-sharded decode of 4 tokens, and the EP phase (ep 4, 8 experts,
    top-2): its loss within 1e-5 relative and its updated w_gate within
    float32 rounding of one unsharded train_step of the same parameters;
    every rank's slice moved."""
    out = graft_entry.dryrun_multichip(8, devices="cpu")
    text = capsys.readouterr().out
    assert "dryrun mesh: data=2 model=2 seq=2" in text
    assert "dryrun_multichip OK: n=8" in text
    assert "dryrun decode OK: seq=8 shards" in text
    assert "dryrun EP OK: experts=8 over 4 devices, loss=" in text
    assert "skipped" not in text
    assert np.isfinite(out["loss"]) and out["delta_wq"] > 0
    assert len(out["decode_tokens"]) == 4
    ep = out["ep"]
    cfg, params = ep["cfg"], ep["params"]
    assert (ep["ep"], cfg.moe_experts, cfg.moe_top_k) == (4, 8, 2)
    plain, loss = graft_entry.train_step(
        graft_entry._with_leaves(params, [t.clone() for t in
                                          graft_entry.param_leaves(params)]),
        ep["tokens"], cfg, 1e-3)
    assert abs(ep["loss"] - float(loss)) <= 1e-5 * float(loss)
    for li in range(2):
        slices = ep["new"]["layers"][li]["w_gate"]
        assert len(slices) == 4 and slices[0].shape == (2, 128, 256)
        w0 = params["layers"][li]["w_gate"]
        d_ep = torch.cat(slices) - w0
        d_plain = plain["layers"][li]["w_gate"] - w0
        tol = (1e-5 * float(d_plain.abs().max())
               + torch.finfo(torch.float32).eps * float(w0.abs().max()))
        assert float((d_ep - d_plain).abs().max()) <= tol
        assert all(float((s - w0[2 * r:2 * r + 2]).abs().max()) > 0
                   for r, s in enumerate(slices))


def test_dryrun_train_step_matches_plain_step():
    """The DP + TP + SP step on (2, 2, 2) against train_step on the same
    float32 parameters and batch."""
    cfg = graft_entry.dryrun_config(2)
    mesh = make_mesh(data=2, model=2, seq=2, devices="cpu")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 513)))
    new, loss = graft_entry.dryrun_train_step(mesh, params, tokens, cfg, 1.0)
    wq0 = params["layers"][0]["wq"].clone()
    plain, loss_p = graft_entry.train_step(
        tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        tokens, cfg, 1.0)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * float(loss_p)
    d_tp = torch.cat([r["layers"][0]["wq"] for r in new], dim=1) - wq0
    d_plain = plain["layers"][0]["wq"] - wq0
    # plus the float32 rounding of the update itself (w ± Δ)
    tol = (1e-5 * float(d_plain.abs().max())
           + torch.finfo(torch.float32).eps * float(wq0.abs().max()))
    assert float((d_tp - d_plain).abs().max()) <= tol


def test_dryrun_multichip_across_processes(capsys):
    """dryrun_multichip(2, processes=2): two gloo workers, one sequence
    rank each (the ring over the mesh's sequence sub-group)."""
    graft_entry.dryrun_multichip(2, processes=2, devices="cpu", timeout=240)
    text = capsys.readouterr().out
    for r in range(2):
        assert f"[process {r}] dryrun_multichip OK: n=2" in text


@pytest.mark.parametrize("devices", [None, ["cuda:0", "cuda:1"]])
def test_dryrun_multichip_across_processes_needs_a_card(monkeypatch,
                                                         devices):
    """Across processes the workers run on the CPU only when the caller
    asks for it: with no card visible, the default devices and a list of
    cards raise before any worker starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2, processes=2, devices=devices)
    assert not started


def test_dryrun_workers_take_one_card_each(monkeypatch):
    """The workers' devices: the caller's cards one a process, in order;
    two processes on one card, or too few cards, raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert graft_entry._worker_devices(2, None) == "cuda:0,cuda:1"
    assert graft_entry._worker_devices(2, ["cuda:3", "cuda:1"]) == \
        "cuda:3,cuda:1"
    assert graft_entry._worker_devices(2, "cpu") == "cpu,cpu"
    for bad in (["cuda:0", "cuda:0"], "cuda", ["cuda:0"], ["cpu", "cpu"],
                ["cuda:4", "cuda:5"]):
        with pytest.raises(ValueError):
            graft_entry._worker_devices(2, bad)


@pytest.mark.parametrize("axis", ["model", "seq"])
def test_mesh_ranks_work_on_their_devices(monkeypatch, axis):
    """A list of devices takes a line's ranks in consecutive blocks, and
    AxisGroup.map runs each rank's work with its own device current; a
    list for a block spanning two axes raises (its off-line ranks' devices
    would stay idle), one device for it does not."""
    from tpu_flash_torch.parallel import mesh as mesh_mod

    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    line = make_mesh(**{axis: 4}, devices=devs).axis(axis)
    assert line.devices == [devs[0], devs[0], devs[1], devs[1]]
    current = []
    monkeypatch.setattr(mesh_mod, "on", lambda dev: (
        current.append(dev), mesh_mod.contextlib.nullcontext())[1])
    assert line.map(lambda i, x: (i, x), list("abcd")) == [
        (0, "a"), (1, "b"), (2, "c"), (3, "d")]
    assert current == line.devices
    with pytest.raises(ValueError, match="one axis line"):
        make_mesh(model=2, seq=2, devices=devs)
    box = make_mesh(data=2, model=2, seq=2, devices="cpu")
    assert box.axis("model").devices == [torch.device("cpu")] * 2


_CFG = dict(vocab_size=128, dim=64, num_layers=2, num_q_heads=4,
            num_kv_heads=2, head_dim=16, block_q=128, block_kv=128,
            dtype="float32")
_PAGE = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=16,
             max_seqs=2, max_pages_per_seq=4, dtype="int8")


def _inputs():
    """Everything both runs take, from seeds."""
    rng = np.random.default_rng(21)
    g = torch.Generator().manual_seed(3)
    cfg = tfm.ModelConfig(**_CFG)
    dcfg = graft_entry.dryrun_config(2)
    return dict(
        params=tfm.init_params(cfg, g, "cpu"),
        toks=torch.as_tensor(rng.integers(1, 127, (2, 24))),
        dparams=tfm.init_params(dcfg, torch.Generator().manual_seed(0),
                                "cpu"),
        dtoks=torch.as_tensor(rng.integers(0, 256, (2, 513))),
        kv=[torch.from_numpy(rng.standard_normal((2, 2, 32)).astype(
            np.float32)) for _ in range(2 * 20)],
        q=torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32)),
        new=[torch.from_numpy(rng.standard_normal((2, 2, 32)).astype(
            np.float32)) for _ in range(2)],
        attn=[torch.from_numpy(rng.standard_normal((1, 4, 512, 32)).astype(
            np.float32)) for _ in range(4)])


def _shard_cache(inp, rank):
    """Rank ``rank`` of 2's cache: tokens [10·rank, 10·rank + 10)."""
    c = PagedKVCache.create(CacheConfig(**_PAGE), "cpu")
    c.page_tables[:, :2] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    slots = torch.arange(2, dtype=torch.int32)
    kv = inp["kv"]
    for i in range(10 * rank, 10 * rank + 10):
        c.append(slots, kv[2 * i], kv[2 * i + 1])
    return c


def _run_parallel(inp, part):
    """The checks' outputs on this process's ranks: ``part(x)`` cuts a
    sequence-global tensor to this process's positions."""
    out = {}
    tp = make_mesh(model=2, devices="cpu").axis("model")
    cfg = tfm.ModelConfig(**_CFG)
    out["tp_logits"] = tfm.forward(shardings.shard_params(inp["params"], tp),
                                   inp["toks"], cfg, tp=tp)
    dmesh = make_mesh(model=2, seq=2, devices="cpu")
    new, loss = graft_entry.dryrun_train_step(
        dmesh, inp["dparams"], inp["dtoks"], graft_entry.dryrun_config(2), 1.0)
    out["dryrun_loss"] = loss
    out["dryrun_wq"] = [r["layers"][0]["wq"] for r in new]
    seq_mesh = make_mesh(seq=2, devices="cpu")
    seq = seq_mesh.axis("seq")
    caches = [_shard_cache(inp, r) for r in seq.indices]
    slots = torch.arange(2, dtype=torch.int32)
    out["seq_o"], out["seq_lse"], _ = sharded_paged_attention(
        inp["q"], caches, slots, seq, new_kv=tuple(inp["new"]),
        return_lse=True)
    out["seq_lengths"] = [c.lengths[:2].clone() for c in caches]
    q, k, v, w = (part(x) for x in inp["attn"])
    out["ring_o"] = ring.ring_attention(
        q, k, v, pattern="local", radius=100, local_ranks=seq.local,
        transport=ring.RingTransport.of(seq), block_q=128, block_kv=128)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ulysses_attention(*xs, seq, schedule="causal", block_q=128,
                          block_kv=128)
    (o * w).sum().backward()
    out["ulysses"] = [o.detach()] + [x.grad for x in xs]
    return out


_WORKER = """
import datetime, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_dryrun as T

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
inp = T._inputs()
n = inp["attn"][0].shape[2] // world
res = T._run_parallel(inp, lambda x: x[:, :, rank * n:(rank + 1) * n])
torch.save(res, out)
dist.barrier()
dist.destroy_process_group()
"""


def test_parallel_modules_across_gloo_processes(tmp_path):
    """Two gloo processes (one rank each on the TP and the sequence mesh;
    the dry run's 1 × 2 × 2 mesh with TP across them) against one process
    of virtual ranks: TP logits, the dry run's loss and wq slices, the
    seq-sharded decode's o, lse and lengths, the ring on the mesh's
    sequence sub-group, and Ulysses' output and gradients, each within
    1e-6 of its largest entry (float32 sums in another order)."""
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), "2",
         f"file://{tmp_path / 'rendezvous'}", str(tmp_path / f"out{r}.pt"),
         os.path.join(_REPO, "tests")], env=env, cwd=str(tmp_path),
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
    want = _run_parallel(_inputs(), lambda x: x)

    def close(a, b, name):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale, name

    for r in range(2):
        g = got[r]
        close(g["tp_logits"], want["tp_logits"], "tp logits")
        close(g["dryrun_loss"], want["dryrun_loss"], "dryrun loss")
        close(g["dryrun_wq"][0], want["dryrun_wq"][r], "dryrun wq")
        close(g["seq_o"], want["seq_o"], "seq o")
        close(g["seq_lse"], want["seq_lse"], "seq lse")
        assert torch.equal(g["seq_lengths"][0], want["seq_lengths"][r])
        part = slice(r * 256, (r + 1) * 256)
        close(g["ring_o"], want["ring_o"][:, :, part], "ring o")
        for name, a, b in zip(("o", "dq", "dk", "dv"), g["ulysses"],
                              want["ulysses"]):
            close(a, b[:, :, part], f"ulysses {name}")
