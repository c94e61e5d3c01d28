"""Checkpoint and resume of the serving engine: weights and the live paged
KV cache; port of ``tpu_flash/serving/checkpoint.py``.

A snapshot taken between engine steps (the engine's quiesce point) restores
to an engine that continues decoding the same requests from byte-identical
cache contents. Tensors (the weights, each layer's pages, scales, page
tables and lengths; under tensor parallelism each rank's slices) go through
``torch.save``; the host state (configurations, request queues, the page
pool's tables) is JSON. Sampling needs no saved state: its noise is a pure
function of (engine seed, request, position). The prefix-cache index is not
saved (the restored pool holds only the running slots' pages), nor are the
draft's caches: a restored speculative engine replays each history
through the draft in its first round's catch-up feeds. Nor is a LoRA bank:
a snapshot whose waiting or running requests name an adapter is refused
at load (the reference restores them onto an engine without a bank, where
they would decode on the base model).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque

import torch

from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.serving.engine import (
    Engine,
    EngineConfig,
    FinishedRequest,
    Request,
    _Running,
)

_HOST_STATE = "host_state.json"
_ARRAYS = "arrays.pt"
_CACHE_FIELDS = ("k_pages", "v_pages", "k_scales", "v_scales", "page_tables",
                 "lengths")


def _tree(fn, x):
    """``fn`` on every tensor of a nested dict/list tree."""
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(fn, v) for v in x]
    return fn(x)


def save_checkpoint(path: str, engine: Engine) -> None:
    """Snapshot the engine (weights, caches, page pool, queues) to the
    directory ``path``, between engine steps. Refuses while chunked
    prefills are in flight; commits an in-flight async round first."""
    if hasattr(engine, "_allocs"):
        raise NotImplementedError(
            "checkpointing a sequence-sharded engine is not supported")
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if engine.prefilling:
        raise ValueError(
            "cannot snapshot with chunked prefills in flight; step the "
            "engine until engine.prefilling is empty")
    engine.flush()  # commit any async decode round before snapshotting

    def host(t):
        return t.detach().cpu()

    torch.save(dict(
        params=_tree(host, engine.params),
        caches=[{f: host(getattr(c, f)) for f in _CACHE_FIELDS
                 if getattr(c, f) is not None}
                for c in engine._all_caches()],
    ), os.path.join(path, _ARRAYS))
    alloc = engine._alloc
    state = dict(
        model_cfg=dataclasses.asdict(engine.mcfg),
        cache_cfg=dataclasses.asdict(engine.ccfg),
        engine_cfg={**dataclasses.asdict(engine.ecfg),
                    "prefill_buckets": list(engine.ecfg.prefill_buckets)},
        waiting=[dataclasses.asdict(r) for r in engine.waiting],
        running={str(s): dataclasses.asdict(r)
                 for s, r in engine.running.items()},
        finished=[dataclasses.asdict(f) for f in engine.finished],
        free_slots=list(engine._free_slots),
        alloc_tables={str(s): alloc.table(s)[:alloc.num_pages(s)].tolist()
                      for s in engine.running},
        tensor_parallel=None if engine.tp is None else engine.tp.size,
    )
    with open(os.path.join(path, _HOST_STATE), "w") as f:
        json.dump(state, f)


def load_checkpoint(path: str, mesh=None, tp_axis: str = "model",
                    draft=None, device="cuda") -> Engine:
    """Rebuild an engine from :func:`save_checkpoint` output to resume it.

    ``device``: where the weights and caches go (the mesh's devices under
    tensor parallelism). A snapshot of a tensor-parallel engine needs a
    ``mesh`` of the same axis size, whose ranks take their own slices.
    ``draft``: (draft params, draft ModelConfig), required when the
    snapshot's EngineConfig has ``speculate_k > 0`` (resuming without one
    would silently decode plain). The restored engine captures its CUDA
    graphs afresh: none refers to the old engine's tensors.
    """
    path = os.path.abspath(path)
    with open(os.path.join(path, _HOST_STATE)) as f:
        state = json.load(f)
    ranks = state["tensor_parallel"]
    if ranks is not None and mesh is None:
        raise ValueError(
            "checkpoint was saved from a tensor-parallel engine; pass the "
            "mesh to restore with (load_checkpoint(path, mesh=...))")
    if ranks is not None and mesh.axis(tp_axis).size != ranks:
        raise ValueError(f"checkpoint has {ranks} tensor-parallel ranks, "
                         f"the mesh's {tp_axis!r} axis "
                         f"{mesh.axis(tp_axis).size}")
    mcfg = tfm.ModelConfig(**state["model_cfg"])
    ccfg = CacheConfig(**state["cache_cfg"])
    ecfg = EngineConfig(**{**state["engine_cfg"], "prefill_buckets": tuple(
        state["engine_cfg"]["prefill_buckets"])})
    adapted = sorted(r["rid"] for r in [*state["waiting"],
                                         *state["running"].values()]
                     if r.get("adapter_id", -1) >= 0)
    if adapted:
        raise ValueError(
            f"checkpoint holds requests {adapted} that name LoRA adapters; "
            "load_checkpoint takes no adapter bank, and resuming them would "
            "decode them on the base model")
    if ecfg.speculate_k > 0 and draft is None:
        raise ValueError(
            f"checkpoint was saved with speculate_k={ecfg.speculate_k}; "
            "pass draft=(params, cfg) to restore speculative decoding "
            "(resuming without one would silently decode plain)")
    arrays = torch.load(os.path.join(path, _ARRAYS), map_location="cpu",
                        weights_only=True, mmap=True)
    if ranks is None:
        params = _tree(lambda t: t.to(device), arrays["params"])
    else:  # rank r's slices onto rank r's device
        params = [_tree(lambda t, d=dev: t.to(d), p) for p, dev in
                  zip(arrays["params"], mesh.axis(tp_axis).devices)]
    engine = Engine(params, mcfg, ccfg, ecfg, mesh=mesh, tp_axis=tp_axis,
                    draft=draft)
    caches = engine._all_caches()
    if len(caches) != len(arrays["caches"]):
        raise ValueError(f"checkpoint has {len(arrays['caches'])} caches, "
                         f"the engine {len(caches)}")
    for c, saved in zip(caches, arrays["caches"]):
        for name, t in saved.items():
            getattr(c, name).copy_(t)
    engine.waiting = deque(Request(**r) for r in state["waiting"])
    engine.running = {int(s): _Running(**r)
                      for s, r in state["running"].items()}
    engine.finished = [FinishedRequest(**f) for f in state["finished"]]
    engine._free_slots = deque(state["free_slots"])
    for s, table in state["alloc_tables"].items():
        if not engine._alloc.restore(int(s), table):
            raise RuntimeError(f"allocator restore failed for slot {s}")
    if engine._draft is not None:
        # the fresh draft caches' tables are all trash: without a sync the
        # first round's catch-up would write every history into page 0
        for s in state["alloc_tables"]:
            engine._sync_slot_tables(int(s))
    return engine
