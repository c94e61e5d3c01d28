"""Entry points: the counterparts of ``__graft_entry__.py``'s ``entry``,
``train_step`` and ``dryrun_multichip``.

    fn, args = entry()            # the flagship forward on a small config
    logits = fn(*args)
    params, loss = train_step(params, tokens, cfg, lr)
    params, loss = seq_parallel_train_step(params, tokens, cfg, lr, ranks=4)
    dryrun_multichip(8)                   # 8 ranks in this process
    ep_dryrun(8)                          # its expert-parallel phase alone
    dryrun_multichip(4, processes=4)      # 4 processes, one rank each

``entry`` builds the reference's small flagship config (vocab 512, dim 256,
2 layers, 4/2 heads, head_dim 64) with random weights from seed 0 and
tokens (2, 256); ``fn`` is ``models/transformer.py:forward``.

The train steps take the gradient of ``models/transformer.py:loss_fn``
with respect to every parameter leaf (attention backward through B4/B5 on
the card) and apply the reference's update ``p − lr·g.astype(p.dtype)``.
The sequence-parallel step runs attention as the causal ring over
``ranks`` virtual ranks (``parallel/ring.py``), K/V heads repeated to the
q heads.

``dryrun_multichip(n)`` splits n ranks into ``(data, model, seq)`` as the
reference does and runs ONE training step of a small float32 model with
every axis real: the batch over ``data`` (gradients summed over it, the
loss a mean over the global batch), attention heads and the MLP hidden dim
over ``model`` (column- and row-parallel slices whose autograd sums the
partials), the sequence over ``seq`` (the causal ring); then a decode
phase on ``SeqShardedEngine`` with an int8 cache over n sequence ranks,
and the expert-parallel phase (:func:`ep_dryrun`): one SGD step of a
2-layer float32 MoE model whose expert bank splits over an ``expert``
axis of 4 ranks (2 when 4 does not divide n). With ``processes > 1`` it
starts that many worker processes (a file rendezvous; NCCL, one card a
process, or gloo on the CPU when the caller asks for the CPU) that run
the step across processes; the engine and the expert phases are
single-process and skipped there, as in the reference.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_flash_torch.models import moe
from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.parallel import ring, shardings
from tpu_flash_torch.parallel.mesh import make_mesh


ENTRY_CONFIG = dict(vocab_size=512, dim=256, num_layers=2, num_q_heads=4,
                    num_kv_heads=2, head_dim=64, block_q=128, block_kv=128)


def entry(device="cuda"):
    """``(fn, example_args)``: the flagship forward, ``fn(params, tokens)
    → logits (2, 256, 512)`` float32, on :data:`ENTRY_CONFIG` with bf16
    weights from seed 0 and zero tokens, on ``device``."""
    cfg = tfm.ModelConfig(**ENTRY_CONFIG)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.zeros((2, 256), dtype=torch.int64, device=device)

    def fn(params, tokens):
        return tfm.forward(params, tokens, cfg)

    return fn, (params, tokens)


def named_leaves(params, prefix=""):
    """(name, tensor) for each leaf of a parameter tree (dicts and lists),
    in a fixed order; names read like ``layers[3].wq``."""
    if isinstance(params, dict):
        return [leaf for key in params
                for leaf in named_leaves(params[key], f"{prefix}.{key}")]
    if isinstance(params, (list, tuple)):
        return [leaf for i, item in enumerate(params)
                for leaf in named_leaves(item, f"{prefix}[{i}]")]
    return [(prefix.lstrip("."), params)]


def param_leaves(params):
    """The tensors of a parameter tree, in :func:`named_leaves` order."""
    return [t for _, t in named_leaves(params)]


def _with_leaves(params, leaves):
    """``params``' tree with its leaves replaced, in :func:`param_leaves`
    order."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {key: rebuild(node[key]) for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(item) for item in node)
        return next(it)

    return rebuild(params)


def loss_and_grads(params, tokens, cfg: tfm.ModelConfig, attn_fn=None,
                   ep=None):
    """``loss_fn`` and its gradient with respect to every leaf of
    ``params`` → (detached 0-d loss, grads in :func:`param_leaves` order).
    The caller's tensors keep ``requires_grad`` as they were. ``ep``: the
    expert axis whose ranks' slices ``params`` holds (``loss_fn``)."""
    with torch.enable_grad():
        tracked = [t.detach().requires_grad_(True)
                   for t in param_leaves(params)]
        loss = tfm.loss_fn(_with_leaves(params, tracked), tokens, cfg,
                           attn_fn=attn_fn, ep=ep)
        grads = torch.autograd.grad(loss, tracked)
    return loss.detach(), list(grads)


def train_step(params, tokens, cfg: tfm.ModelConfig, lr: float,
               attn_fn=None, ep=None):
    """One SGD step on ``loss_fn(params, tokens, cfg, attn_fn)``; returns
    ``(params, loss)``, the loss before the step as a 0-d float32 tensor.

    Updates the parameter tensors IN PLACE (and returns the same tree): the
    gradient of each leaf is cast to the leaf's dtype, scaled by ``lr`` and
    subtracted, the reference's rule ``p − lr·g.astype(p.dtype)``."""
    loss, grads = loss_and_grads(params, tokens, cfg, attn_fn=attn_fn,
                                 ep=ep)
    with torch.no_grad():
        for p, g in zip(param_leaves(params), grads):
            p.sub_(g.to(p.dtype) * lr)
    return params, loss


def seq_parallel_train_step(params, tokens, cfg: tfm.ModelConfig, lr: float,
                            ranks: int):
    """:func:`train_step` with attention as the causal ring over ``ranks``
    virtual ranks (``tokens[:, :-1]`` must split into them): the dry run's
    ``loss_fn(..., attn_fn=ring)`` step on one device."""
    return train_step(params, tokens, cfg, lr, attn_fn=ring.ring_attn_fn(
        ranks, pattern="causal", block_q=cfg.block_q, block_kv=cfg.block_kv))


def mesh_factors(n: int):
    """Split n ranks into (data, model, seq), every axis that fits: n 8 →
    (2, 2, 2), n 4 → (1, 2, 2), n 2 → (1, 1, 2)."""
    seq = 2 if n % 2 == 0 else 1
    rest = n // seq
    model = 2 if rest % 2 == 0 else 1
    return rest // model, model, seq


def dryrun_config(model: int) -> tfm.ModelConfig:
    """The dry run's float32 model (the reference's), heads and MLP hidden
    dim growing with the tensor-parallel axis."""
    return tfm.ModelConfig(vocab_size=256, dim=128, num_layers=2,
                           num_q_heads=4 * model, num_kv_heads=2 * model,
                           head_dim=64, mlp_hidden=256 * model, block_q=128,
                           block_kv=128, dtype="float32")


def _tracked(rank_trees):
    """Leaves to differentiate: each rank's slices, and rank 0's
    replicated leaves, which the other ranks take as differentiable copies
    on their devices (so their gradients add up on rank 0's)."""
    names = [n for n, _ in named_leaves(rank_trees[0])]
    first = [t.detach().requires_grad_(True) for t in param_leaves(
        rank_trees[0])]
    out = [first]
    for tree in rank_trees[1:]:
        leaves = []
        for name, src, t in zip(names, first, param_leaves(tree)):
            if name.split(".")[-1] in shardings.COLUMN + shardings.ROW:
                leaves.append(t.detach().requires_grad_(True))
            else:
                leaves.append(src.to(t.device))
        out.append(leaves)
    return names, out


def dryrun_train_step(mesh, params, tokens, cfg: tfm.ModelConfig,
                      lr: float):
    """One DP + TP + SP SGD step of ``loss_fn`` over ``mesh``.

    ``params``: the whole parameter tree and ``tokens`` ``(B, N + 1)`` the
    whole batch, alike on every process. This process computes its block
    of rows (its ``data`` ranks) and positions (its ``seq`` ranks): the
    projections and the MLP on its ``model`` ranks' slices
    (``parallel/shardings.py``), each row-parallel product summed over the
    axis, attention as the causal ring over the ``seq`` line
    (``RingTransport.of``), the loss as its share of the mean over the
    global batch. Gradients are summed over ``seq`` and ``data``; the
    update is the reference's ``p − lr·g``. Returns ``(rank slices after
    the step, one tree a local model rank; the global mean loss)``."""
    tp, seq, data = (mesh.axis(a) for a in ("model", "seq", "data"))
    b, n = tokens.shape[0], tokens.shape[1] - 1
    rows, nl = b // mesh.shape["data"], n // mesh.shape["seq"]
    r0 = slice(data.first * rows, (data.first + data.local) * rows)
    p0, p1 = seq.first * nl, (seq.first + seq.local) * nl
    dev = tp.device
    inp = tokens[r0, p0:p1].to(dev)
    tgt = tokens[r0, p0 + 1:p1 + 1].to(dev)
    positions = torch.arange(p0, p1, dtype=torch.int32,
                             device=dev).expand(inp.shape[0], p1 - p0)
    transport = ring.RingTransport.of(seq)

    def attn_fn(q, k, v):
        return ring.ring_attention(q, k, v, pattern="causal",
                                   local_ranks=seq.local, transport=transport,
                                   block_q=cfg.block_q, block_kv=cfg.block_kv)

    rank_trees = shardings.shard_params(params, tp)
    names, tracked = _tracked(rank_trees)
    with torch.enable_grad():
        trees = [_with_leaves(t, leaves)
                 for t, leaves in zip(rank_trees, tracked)]
        logits = tfm.forward(trees, inp, cfg, positions=positions,
                             attn_fn=attn_fn, tp=tp)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt[..., None].long())
        loss = nll.sum() / (b * n)
        leaves = [t for rank in tracked for t in rank if t.is_leaf]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach().clone()
    for axis in (seq, data):
        if axis.group is not None:
            dist.all_reduce(loss, group=axis.group)
    grad_of = {id(t): g for t, g in zip(leaves, grads)}
    new = []
    with torch.no_grad():
        for rank_i, (tree, leaves_r) in enumerate(zip(rank_trees, tracked)):
            out = []
            for name, t, tl in zip(names, param_leaves(tree), leaves_r):
                sharded = name.split(".")[-1] in (shardings.COLUMN
                                                  + shardings.ROW)
                src = tl if (sharded or rank_i == 0) else tracked[0][
                    names.index(name)]
                g = grad_of.get(id(src))
                g = torch.zeros_like(src) if g is None else g.clone()
                for axis in (seq, data):
                    if axis.group is not None:
                        dist.all_reduce(g, group=axis.group)
                out.append((src.detach() - (g.to(src.dtype) * lr)).to(
                    t.device))
            new.append(_with_leaves(tree, out))
    return new, loss


def ep_config(ep: int) -> tfm.ModelConfig:
    """The expert-parallel phase's float32 model (the reference's): 2
    layers, ``2·ep`` experts, top-2, capacity factor 1.25."""
    return tfm.ModelConfig(vocab_size=256, dim=128, num_layers=2,
                           num_q_heads=4, num_kv_heads=2, head_dim=32,
                           mlp_hidden=256, block_q=128, block_kv=128,
                           dtype="float32", moe_experts=2 * ep, moe_top_k=2)


def ep_train_step(mesh, params, tokens, cfg: tfm.ModelConfig, lr: float):
    """One SGD step of ``loss_fn`` (with the balance loss) with each MoE
    layer's experts split over the mesh's ``expert`` line
    (``models/moe.py:shard_experts``): each rank computes its experts'
    slots and its share of the combine, the shares summed over the line
    in rank order. Single-process (the reference's phase is). Returns
    ``(the step's tree, its expert tensors one slice a rank; the loss)``."""
    ep = mesh.axis("expert")
    if ep.group is not None:
        raise NotImplementedError("the expert-parallel step is "
                                  "single-process, as in the reference")
    own = _with_leaves(params, [t.clone() for t in param_leaves(params)])
    return train_step(moe.shard_experts(own, ep), tokens, cfg, lr, ep=ep)


def ep_dryrun(n_devices: int, devices=None) -> dict:
    """The dry run's expert-parallel phase: ``ep = 4 if n % 4 == 0 else
    2`` ranks of an ``expert`` mesh on ``devices`` (default the current
    card), :func:`ep_config`'s model from seed 3, tokens (2, 129) from
    seed 4, one :func:`ep_train_step` at lr 1e-3. Prints the reference's
    line; returns the numbers."""
    ep = 4 if n_devices % 4 == 0 else 2
    mesh = make_mesh(expert=ep, devices=devices)
    dev = mesh.axis("expert").device
    cfg = ep_config(ep)
    params = tfm.init_params(
        cfg, torch.Generator(device=dev.type).manual_seed(3), dev)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 129)), device=dev)
    new, loss = ep_train_step(mesh, params, tokens, cfg, 1e-3)
    loss_val = float(loss)
    if not math.isfinite(loss_val):
        raise AssertionError(f"non-finite MoE loss {loss_val}")
    w_gate = torch.cat([w.to(dev) for w in new["layers"][0]["w_gate"]])
    delta = float((w_gate - params["layers"][0]["w_gate"]).abs().max())
    if not delta > 0:
        raise AssertionError("MoE step produced no expert update")
    print(f"dryrun EP OK: experts={cfg.moe_experts} over {ep} devices, "
          f"loss={loss_val:.4f}", flush=True)
    return dict(ep=ep, loss=loss_val, delta_w_gate=delta, params=params,
                tokens=tokens, new=new, cfg=cfg)


def _dryrun(n_devices: int, devices=None, single: bool = True) -> dict:
    """The dry run in this process (one of the workers, or the only
    process): the train step on the (data, model, seq) mesh, then, in a
    single process, the seq-sharded decode phase and the expert-parallel
    phase. Prints the reference's lines; returns the numbers."""
    data, model, seq = mesh_factors(n_devices)
    mesh = make_mesh(data=data, model=model, seq=seq, devices=devices)
    print(f"dryrun mesh: data={data} model={model} seq={seq}", flush=True)
    cfg = dryrun_config(model)
    dev = mesh.axis("model").device
    params = tfm.init_params(
        cfg, torch.Generator(device=dev.type).manual_seed(0), dev)
    seq_len = 256 * seq
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2 * data, seq_len + 1)), device=dev)
    new, loss = dryrun_train_step(mesh, params, tokens, cfg, 1e-3)
    loss_val = float(loss)
    if not math.isfinite(loss_val):
        raise AssertionError(f"non-finite loss {loss_val}")
    tp = mesh.axis("model")
    wq = params["layers"][0]["wq"]
    part = wq.shape[1] // tp.size
    delta = max(float((r["layers"][0]["wq"].to(dev) - wq[:, i * part:(
        i + 1) * part]).abs().max()) for i, r in zip(
            range(tp.first, tp.first + tp.local), new))
    if not delta > 0:
        raise AssertionError("train step produced no parameter update")
    print(f"dryrun_multichip OK: n={n_devices} loss={loss_val:.4f} "
          f"max|Δwq|={delta:.2e}", flush=True)
    out = dict(mesh=(data, model, seq), loss=loss_val, delta_wq=delta,
               params=params, tokens=tokens, new=new)
    if single and n_devices >= 2:
        from tpu_flash_torch.cache.paged_cache import CacheConfig
        from tpu_flash_torch.serving.engine import EngineConfig, Request
        from tpu_flash_torch.serving.seq_engine import SeqShardedEngine

        dcfg = tfm.ModelConfig(vocab_size=256, dim=128, num_layers=2,
                               num_q_heads=4, num_kv_heads=2, head_dim=32,
                               block_q=128, block_kv=128)
        dparams = tfm.init_params(
            dcfg, torch.Generator(device=dev.type).manual_seed(2), dev)
        ccfg = CacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                           total_pages=64, max_seqs=4, max_pages_per_seq=8,
                           dtype="int8")
        eng = SeqShardedEngine(dparams, dcfg, ccfg, EngineConfig(max_batch=2),
                               mesh=make_mesh(seq=n_devices, devices=devices))
        eng.submit(Request(rid=0, prompt=[5, 7, 11, 13, 17],
                           max_new_tokens=4))
        done = eng.run()
        if len(done) != 1 or len(done[0].new_tokens) != 4:
            raise AssertionError(f"decode phase: {done}")
        print(f"dryrun decode OK: seq={n_devices} shards, "
              f"tokens={done[0].new_tokens}", flush=True)
        out["decode_tokens"] = done[0].new_tokens
        out["ep"] = ep_dryrun(n_devices, devices=devices)
    return out


_WORKER = """
import datetime, sys, torch
import torch.distributed as dist
from tpu_flash_torch import graft_entry
rank, world, init, n = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
device = torch.device(sys.argv[5].split(",")[rank])
if device.type == "cuda":
    if not torch.cuda.is_available():
        raise RuntimeError(f"dryrun worker {rank}: no CUDA device for {device}")
    torch.cuda.set_device(device)
dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                        init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
torch.backends.cuda.matmul.allow_tf32 = False
graft_entry._dryrun(n, devices=device, single=False)
dist.barrier()
dist.destroy_process_group()
"""


def _worker_devices(processes: int, devices) -> str:
    """The workers' devices, one a process, as the workers' argument: the
    CPU (gloo) only when the caller asked for it; otherwise one card a
    process (default ``cuda:0 … processes − 1``, or the caller's list),
    and no card raises."""
    if devices == "cpu":
        return ",".join(["cpu"] * processes)
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (devices=\"cpu\" "
                           "runs the workers on the CPU over gloo)")
    if devices is None:
        devices = [torch.device("cuda", r) for r in range(processes)]
    devs = ([torch.device(devices)] if isinstance(devices, (str, torch.device))
            else [torch.device(d) for d in devices])
    if (len(devs) != processes or len(set(devs)) != processes
            or any(d.type != "cuda" or d.index is None for d in devs)):
        raise ValueError(f"dryrun_multichip: {processes} processes need one "
                         f"card each (cuda:i), got {devices}")
    if max(d.index for d in devs) >= torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip: {devices} but "
                         f"{torch.cuda.device_count()} cards visible")
    return ",".join(str(d) for d in devs)


def dryrun_multichip(n_devices: int, processes: int = 1, devices=None,
                     timeout: float = 900) -> dict:
    """The multi-chip dry run over ``n_devices`` ranks (see the module
    note). ``processes == 1``: every rank in this process, on ``devices``
    (default the current card; ``"cpu"`` for a rehearsal). ``processes >
    1``: that many workers, ``n_devices / processes`` ranks each, their
    output printed here; a worker that fails raises. The workers run on
    one card each over NCCL (default ``cuda:0 …``, or ``devices``, a list
    of one card a process), or on the CPU over gloo when ``devices`` is
    ``"cpu"``; without a card anything else raises. Returns the
    one-process run's numbers (None across processes)."""
    if processes == 1:
        return _dryrun(n_devices, devices=devices)
    spec = _worker_devices(processes, devices)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if devices == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        paths = [os.path.join(tmp, f"worker{r}.log") for r in range(processes)]
        procs = []
        try:
            for r, path in enumerate(paths):
                with open(path, "wb") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _WORKER, str(r), str(processes),
                         init, str(n_devices), spec], env=env, cwd=root,
                        stdout=out, stderr=subprocess.STDOUT))
            # until every worker ends, one fails or the time is up: a
            # failed worker leaves the others waiting in a collective
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = []
        for path in paths:
            with open(path, "rb") as f:
                logs.append(f.read().decode(errors="replace"))
    for r, log in enumerate(logs):
        sys.stdout.write("".join(f"[process {r}] {line}\n"
                                 for line in log.splitlines()))
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("dryrun workers failed (rc "
                           f"{[p.returncode for p in procs]})")
    return None
