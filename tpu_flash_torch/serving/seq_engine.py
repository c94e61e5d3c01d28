"""Sequence-sharded serving engine: each layer's paged KV-cache split over a
mesh ``seq`` axis, decode merged with the (o, lse) algebra; port of
``tpu_flash/serving/seq_engine.py``.

BASELINE config #5 (ring-attention decode with an INT4/INT8 KV-cache
sharded over N hosts) on a mesh's sequence line:

* every rank owns an independent page pool, page table and length vector
  (one ``PagedKVCache`` a rank and layer, on the rank's device);
* a prompt's K/V are sliced contiguously across the ranks at prefill (rank
  i holds positions ``[i·Ls, (i + 1)·Ls)`` of the padded bucket); RoPE is
  applied before the write, so slices carry their global positions;
* every decode step runs the dense stack once (replicated) and attention
  on every rank's local slice (B2 with lse), the partials merged over the
  axis (``parallel/ring_decode.py``); the new token's K/V land only on the
  last rank, whose pool is the only one that grows;
* the host keeps one ``PageAllocator`` a rank; capacity pressure and
  preemption follow the base engine's rules against the tail rank's pool.

One process drives every rank (the reference's single controller: its
host loop drives per-shard arrays and is single-process only). Chunked
prefill, the prefix cache, speculative decoding and sliding-window models
are refused, as in the reference, and so is multi-LoRA (the engine takes
no bank, so a request naming an adapter raises at ``submit``); so are
K-step rounds (``decode_steps > 1``, and with them ``async_decode``),
which the reference's engine never composed with sequence sharding (its
``_ensure_capacity`` takes no ``ahead`` and the multi-step path was never
overridden).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_flash_torch.cache.allocator import PageAllocator
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.serving.engine import Engine, EngineConfig, _sample_packed


class SeqShardedEngine(Engine):
    """Engine with per-layer caches sharded over a mesh ``seq`` axis."""

    def __init__(
        self,
        params,
        model_cfg: tfm.ModelConfig,
        cache_cfg: CacheConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        *,
        mesh,
        seq_axis: str = "seq",
    ):
        if engine_cfg.chunk_size is not None:
            raise NotImplementedError(
                "chunked prefill is not composed with sequence sharding")
        if model_cfg.attention == "sliding":
            raise NotImplementedError("seq-sharded decode is causal-only")
        if engine_cfg.prefix_cache:
            raise NotImplementedError(
                "prefix caching is not composed with sequence sharding")
        if engine_cfg.speculate_k > 0:
            raise NotImplementedError(
                "speculative decoding is not composed with sequence "
                "sharding")
        if engine_cfg.decode_steps > 1:
            raise NotImplementedError(
                "K-step rounds (decode_steps > 1, async_decode) are not "
                "composed with sequence sharding")
        seq = mesh.axis(seq_axis)
        if seq.group is not None or seq.local != seq.size:
            raise NotImplementedError(
                "the seq-sharded engine is single-process: the seq line "
                "must lie in this process")
        self.seq = seq
        self.seq_axis = seq_axis
        self.n_shards = seq.size
        super().__init__(params, model_cfg, cache_cfg, engine_cfg)
        self.mesh = mesh
        # one independent pool a rank (page 0 stays the trash page)
        self._allocs = [
            PageAllocator(
                total_pages=cache_cfg.total_pages - 1,
                max_seqs=cache_cfg.max_seqs,
                max_pages_per_seq=cache_cfg.max_pages_per_seq,
                decode_reserve=engine_cfg.max_batch,
            )
            for _ in range(self.n_shards)
        ]
        self._alloc = self._allocs[-1]  # base-class paths see the tail pool
        self._seq_meta: dict = {}  # slot → {"lens0": [...], "n0": n}

    def _make_caches(self):
        return [[PagedKVCache.create(self.ccfg, dev)
                 for _ in range(self.mcfg.num_layers)]
                for dev in self.seq.devices]

    # ---- geometry -----------------------------------------------------

    def _slice_len(self, bucket: int) -> int:
        return bucket // self.n_shards

    def _bucket(self, n: int) -> int:
        # per-rank slices must be page-aligned → bucket % (S·page) == 0
        b = super()._bucket(n)
        gran = self.n_shards * self.ccfg.page_size
        b = -(-b // gran) * gran
        cap = self.ccfg.max_pages_per_seq * self.ccfg.page_size * self.n_shards
        return min(b, cap)

    def _shard_lens(self, slot: int) -> list:
        meta = self._seq_meta[slot]
        r = self.running.get(slot)
        lens = list(meta["lens0"])
        if r is not None:
            # every decode-step append went to the tail rank
            lens[-1] += (len(r.tokens) - 1) - meta["n0"]
        return lens

    def shard_pages(self, slot: int) -> list:
        """Pages each rank holds for ``slot``."""
        return [a.num_pages(slot) for a in self._allocs]

    # ---- host-side page bookkeeping -----------------------------------

    def _sync_slot_tables(self, slot: int, set_length=None) -> None:
        for alloc, rank in zip(self._allocs, self.caches):
            npages = alloc.num_pages(slot)
            row = np.zeros(self.ccfg.max_pages_per_seq, np.int32)
            row[:npages] = alloc.table(slot)[:npages] + 1
            row_t = torch.as_tensor(row, device=rank[0].page_tables.device)
            for c in rank:
                c.page_tables[slot] = row_t
                if set_length is not None:
                    c.lengths[slot].fill_(set_length)

    def _admit(self) -> None:
        while (self.waiting and self._free_slots
               and len(self.running) < self.ecfg.max_batch):
            req = self.waiting[0]
            bucket = self._bucket(len(req.prompt) + 1)
            ls = self._slice_len(bucket)
            pages_each = -(-ls // self.ccfg.page_size)
            slot = self._free_slots[0]
            ok = []
            for alloc in self._allocs:
                if alloc.admit(slot, pages_each):
                    ok.append(alloc)
                else:
                    break
            if len(ok) < len(self._allocs):
                for alloc in ok:  # roll back a partial admission
                    alloc.free_seq(slot)
                break
            self.waiting.popleft()
            self._free_slots.popleft()
            self._sync_slot_tables(slot)
            n = len(req.prompt)
            lens0 = [int(np.clip(n - i * ls, 0, ls))
                     for i in range(self.n_shards)]
            self._seq_meta[slot] = {"lens0": lens0, "n0": n}
            self._prefill(req, slot, bucket, pages_each * self.n_shards)

    def _ensure_capacity(self, slot: int, ahead: int = 1) -> str:
        tail = self._shard_lens(slot)[-1]
        alloc = self._allocs[-1]
        synced = False
        while tail + ahead > alloc.num_pages(slot) * self.ccfg.page_size:
            if alloc.num_pages(slot) >= self.ccfg.max_pages_per_seq:
                status = "cap"
                break
            if alloc.extend(slot) is None:
                status = "pool"
                break
            synced = True
        else:
            status = "ok"
        if synced:
            self._sync_slot_tables(slot)
        return status

    def _free_other_ranks(self, slot: int) -> None:
        for alloc in self._allocs[:-1]:
            alloc.free_seq(slot)
        self._seq_meta.pop(slot, None)

    def _finish_capacity(self, slot: int) -> None:
        super()._finish_capacity(slot)
        # the base class freed only the tail pool (self._alloc)
        self._free_other_ranks(slot)

    def _preempt(self, slot: int) -> None:
        was = slot in self.running
        super()._preempt(slot)
        if was and slot not in self.running:
            self._free_other_ranks(slot)

    def _maybe_finish(self, slot: int) -> None:
        was = slot in self.running
        super()._maybe_finish(slot)
        if was and slot not in self.running:
            self._free_other_ranks(slot)

    def _pages_bound(self, ahead: int = 0) -> int:
        if self.ecfg.pages_bound is not None:
            return self.ecfg.pages_bound
        ps = self.ccfg.page_size
        need = 1
        for slot in self.running:
            need = max(need, max(-(-n // ps) for n in self._shard_lens(slot))
                       or 1)
        bound = 4
        while bound < need:
            bound *= 4
        return min(bound, self.ccfg.max_pages_per_seq)

    # ---- device work ----------------------------------------------------

    def _write_prompt_kv(self, kv, slot: int, n: int) -> None:
        """Rank i stores positions ``[i·Ls, (i + 1)·Ls)`` of the padded
        bucket in its pool; its length is the real tokens among them."""
        bucket = kv[0][0].shape[1]
        ls = self._slice_len(bucket)
        for i, rank in enumerate(self.caches):
            off = i * ls
            for c, (k, v) in zip(rank, kv):
                dev = c.k_pages.device
                c.write_prompt(slot, k[0, off:off + ls].transpose(0, 1).to(dev),
                               v[0, off:off + ls].transpose(0, 1).to(dev))
                c.lengths[slot].fill_(int(np.clip(n - off, 0, ls)))

    def _step(self, tokens, positions, slots, samp, keys, aids,
              pages_bound: int, host_samp=None):
        # aids rides the base class's call; this engine holds no adapter
        # bank (multi-LoRA is not composed with sequence sharding, as in
        # the reference), so every lane is the base model
        logits, _ = tfm.decode_step_seq(
            self.params, tokens, positions, self.caches, slots, self.mcfg,
            self.seq, pages_bound=pages_bound)
        for c in self._all_caches():
            c.lengths[self._trash_slot].fill_(0)
        return _sample_packed(logits, samp, keys, positions + 1, host_samp)
