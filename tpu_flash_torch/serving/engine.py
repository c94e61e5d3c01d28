"""Continuous-batching inference engine over the paged KV-cache: port of
``tpu_flash/serving/engine.py``.

Requests stream in; an admitted prompt is prefilled whole, padded to a
bucket, through the flash kernel (B1), or, when it is longer than
``chunk_size``, streamed in page-aligned chunks, one chunk per engine step
interleaved with decode (``models/transformer.py:prefill_chunk``: the
chunk's prefix through the paged kernel B2, the chunk itself through B1,
the two partials merged). Its K/V land in paged cache slots granted by the
native allocator; every engine step advances all running sequences by one
token through the paged kernels (append B3, then attention B2; with
``pipelined_decode`` each lane walks exactly its own pages) and samples on
the device. Finished sequences release their pages at once; pool
exhaustion preempts a sequence back to the queue.

* Decode runs ``max_batch`` lanes; idle lanes sit on a trash slot
  (``max_seqs − 1``) whose page table points at physical page 0, which is
  never granted. The trash slot's length is reset after every step.
* PyTorch runs eagerly, so there is nothing to compile per bucket; caches
  are updated in place.
* Sampling: each lane's noise comes from a generator on the device seeded
  purely from ``(engine seed, rid, position)`` — the reference's keying
  structure (``fold_in(fold_in(key(seed), rid), position)``), not its bits.
  Streams are batching-invariant and reproducible; greedy streams match
  the reference token for token.
* Decode pins the exact running max; ``prefill_bound_max`` lets prefill
  take the norm bound, which relaxes chunked == unchunked from identical
  to a tolerance, as in the reference.

Not ported yet (ROADMAP A7 unless named): the prefix cache, speculative
decoding (A9), ``decode_steps > 1``/async decode, LoRA (A9), tensor
parallelism (A13). Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from tpu_flash_torch.cache.allocator import PageAllocator
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.models import transformer as tfm

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def noise_seed(seed: int, rid: int, position: int) -> int:
    """Seed of the sampling noise for request ``rid``'s token at
    ``position``: a pure function of the three, like the reference's
    ``fold_in(fold_in(key(seed), rid), position)``. Fits torch's seed range."""
    h = _mix64(_mix64(_mix64(seed & _MASK64) ^ (rid & 0x7FFFFFFF))
               ^ (position & _MASK64))
    return h & ((1 << 63) - 1)


def _truncated_scores(logits: torch.Tensor, samp: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits with top-k / nucleus truncation applied
    (truncated entries at -1e30). ``samp``: (B, 3) f32 rows of
    [temperature, top_k, top_p]. Untruncated batches skip the sort."""
    temps, top_k, top_p = samp[:, 0], samp[:, 1], samp[:, 2]
    t = torch.clamp_min(temps, 1e-6)[:, None]
    scaled = logits.float() / t
    if not bool(((top_k > 0) | (top_p < 1.0)).any()):
        return scaled
    neg = -1e30
    v = scaled.shape[-1]
    # ONE descending sort serves both filters: the top-k mask is
    # order-preserving in sorted space, so the nucleus pass reuses it.
    srt = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: keep entries >= the k-th largest (ties keep extras)
    k_idx = torch.clamp(top_k.to(torch.int64) - 1, 0, v - 1)
    kth = torch.gather(srt, 1, k_idx[:, None])
    kmask = top_k[:, None] > 0
    srt = torch.where(kmask & (srt < kth), neg, srt)
    # nucleus: smallest prefix of the sorted distribution reaching top_p; the
    # epsilon keeps the most likely token alive for a degenerate top_p = 0
    prob = torch.softmax(srt, dim=-1)
    csum = torch.cumsum(prob, dim=-1)
    keep = (csum - prob) < torch.clamp_min(top_p, 1e-9)[:, None]
    cutoff = torch.where(keep, srt, float("inf")).amin(dim=-1)
    scaled = torch.where(kmask & (scaled < kth), neg, scaled)
    return torch.where(scaled >= cutoff[:, None], scaled, neg)


def _device_sample(logits: torch.Tensor, samp: torch.Tensor,
                   seeds: List[Optional[int]]) -> torch.Tensor:
    """On-device next-token choice: greedy for temperature ≤ 0, Gumbel-max
    over the (optionally top-k / nucleus-truncated) scaled distribution
    otherwise. ``seeds[i]`` (from :func:`noise_seed`) seeds lane i's
    uniform noise; None marks a greedy lane, which draws none."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if all(s is None for s in seeds):
        return greedy
    scaled = _truncated_scores(logits, samp)
    v = logits.shape[-1]
    u = torch.full_like(logits, 0.5)  # greedy lanes: unused, finite
    for lane, s in enumerate(seeds):
        if s is not None:
            gen = torch.Generator(device=logits.device).manual_seed(s)
            u[lane] = torch.rand(v, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(samp[:, 0] <= 0.0, greedy, sampled)


def _sample_packed(logits, samp, seeds) -> torch.Tensor:
    """(token, logprob) packed into one (B, 2) f32 tensor — one host fetch
    per step. The logprob is the chosen token's raw log-softmax (the model
    distribution, untempered)."""
    tok = _device_sample(logits, samp, seeds)
    lp = torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                      tok[:, None])[:, 0]
    return torch.stack([tok.float(), lp], dim=1)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0        # 0 = disabled; keep only the k most likely
    top_p: float = 1.0    # nucleus sampling mass; 1.0 = disabled
    eos_id: Optional[int] = None
    # finish when the GENERATED tail ends with any of these token sequences
    stop_sequences: tuple = ()
    adapter_id: int = -1  # LoRA adapters: ROADMAP A9
    # internal: set on preemption requeue — the ORIGINAL user prompt length,
    # so a stop sequence straddling the preemption boundary still fires
    true_prompt_len: Optional[int] = None


@dataclasses.dataclass
class _Running:
    rid: int
    slot: int
    tokens: List[int]          # prompt + generated
    prompt_len: int
    max_new_tokens: int
    temperature: float
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    alloc_tokens: int = 0      # page-covered capacity
    next_token: int = -1
    logprobs: List[float] = dataclasses.field(default_factory=list)
    stop_sequences: tuple = ()
    true_prompt_len: Optional[int] = None


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: List[int]
    new_tokens: List[int]
    reason: str  # "length" | "eos" | "stop" | "cap"
    # raw log-softmax of each generated token under the model distribution
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    prefill_buckets: tuple = (64, 128, 256, 512, 1024, 2048)
    pages_bound: Optional[int] = None  # static cap for the decode kernel
    pipelined_decode: bool = False  # each lane walks exactly its own pages
    # tokens per prefill chunk (a page multiple): longer prompts stream in
    # chunks, one per engine step, interleaved with decode
    chunk_size: Optional[int] = None
    prefix_cache: bool = False  # ROADMAP A7
    prefix_cache_entries: int = 4096
    # prefill (whole or chunked) with the norm-bound max: chunked ==
    # unchunked then holds to a tolerance, not exactly; decode stays exact
    prefill_bound_max: bool = False
    metrics_path: Optional[str] = None  # per-step JSONL metrics stream
    speculate_k: int = 0  # ROADMAP A9
    async_decode: bool = True  # applies to decode_steps > 1 only
    decode_steps: int = 1  # >1: ROADMAP A7
    seed: int = 0


def _check_engine_config(ecfg: EngineConfig) -> None:
    unported = dict(
        prefix_cache=(ecfg.prefix_cache, "A7"),
        speculate_k=(ecfg.speculate_k > 0, "A9"),
        decode_steps=(ecfg.decode_steps > 1, "A7"),
    )
    for name, (used, item) in unported.items():
        if used:
            raise NotImplementedError(
                f"EngineConfig.{name} is not ported yet (ROADMAP {item})")


class Engine:
    def __init__(
        self,
        params,
        model_cfg: tfm.ModelConfig,
        cache_cfg: CacheConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        mesh=None,
        draft=None,
        lora=None,
    ):
        _check_engine_config(engine_cfg)
        for name, val, item in (("mesh", mesh, "A13"), ("draft", draft, "A9"),
                                ("lora", lora, "A9")):
            if val is not None:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported yet (ROADMAP {item})")
        # The engine pins the exact running max (the reference's bit-identical
        # chunked-vs-unchunked contract forbids the span-dependent bound).
        if model_cfg.attn_bound_max:
            raise ValueError(
                "attn_bound_max=True breaks the engine's bit-identical "
                "chunked-vs-unchunked prefill contract; leave it None")
        self.params = params
        self.mcfg = dataclasses.replace(model_cfg, attn_bound_max=False)
        # prefill may opt into the norm bound (a tolerance contract)
        self.mcfg_prefill = (
            dataclasses.replace(model_cfg, attn_bound_max=True)
            if engine_cfg.prefill_bound_max else self.mcfg)
        self.ccfg = cache_cfg
        self.ecfg = engine_cfg
        self.device = params["embed"].device
        if engine_cfg.max_batch > cache_cfg.max_seqs - 1:
            raise ValueError("max_batch must leave one trash slot free")
        if (engine_cfg.chunk_size is not None
                and engine_cfg.chunk_size % cache_cfg.page_size):
            raise ValueError("chunk_size must be a multiple of page_size")
        # physical page 0 is the trash page; allocator hands out [1, total).
        self._alloc = PageAllocator(
            total_pages=cache_cfg.total_pages - 1,
            max_seqs=cache_cfg.max_seqs,
            max_pages_per_seq=cache_cfg.max_pages_per_seq,
            decode_reserve=engine_cfg.max_batch,
        )
        self.caches = [PagedKVCache.create(cache_cfg, self.device)
                       for _ in range(model_cfg.num_layers)]
        self._trash_slot = cache_cfg.max_seqs - 1
        self._free_slots = deque(
            s for s in range(cache_cfg.max_seqs) if s != self._trash_slot)
        self.waiting: deque[Request] = deque()
        self.running: dict[int, _Running] = {}
        self.prefilling: dict[int, dict] = {}  # slot → chunked-prefill state
        self.finished: List[FinishedRequest] = []
        self._steps = 0
        self._tokens_out = 0
        self._preemptions = 0
        self._metrics_fh = (open(engine_cfg.metrics_path, "a")
                            if engine_cfg.metrics_path else None)

    # ---- public API -----------------------------------------------------

    def submit(self, req: Request) -> None:
        cap = self.ccfg.max_pages_per_seq * self.ccfg.page_size
        if len(req.prompt) + 1 > cap:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds per-sequence "
                f"cache capacity {cap}")
        if req.adapter_id != -1:
            raise ValueError(
                f"request {req.rid} names adapter {req.adapter_id} but this "
                "engine was built without a LoRA bank")
        self.waiting.append(req)

    def step(self) -> None:
        """Admit + prefill new requests, advance one chunked prefill, then
        advance all running sequences by one decode token."""
        t0 = time.monotonic()
        tok0 = self._tokens_out
        self._admit()
        self._advance_prefill()
        if self.running:
            self._decode()
        self._steps += 1
        if self._metrics_fh is not None:
            row = dict(
                step=self._steps,
                wall_ms=round((time.monotonic() - t0) * 1e3, 3),
                new_tokens=self._tokens_out - tok0,
                running=len(self.running),
                prefilling=len(self.prefilling),
                waiting=len(self.waiting),
                free_pages=self._alloc.num_free(),
                preemptions=self._preemptions,
            )
            self._metrics_fh.write(json.dumps(row) + "\n")
            self._metrics_fh.flush()

    def close(self) -> None:
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def metrics(self) -> dict:
        """Aggregate engine counters."""
        return dict(
            steps=self._steps,
            tokens_out=self._tokens_out,
            preemptions=self._preemptions,
            finished=len(self.finished),
            free_pages=self._alloc.num_free(),
        )

    def run(self, max_steps: int = 10_000) -> List[FinishedRequest]:
        steps = 0
        while ((self.waiting or self.running or self.prefilling)
               and steps < max_steps):
            self.step()
            steps += 1
        return self.finished

    # ---- internals ------------------------------------------------------

    def _seed_for(self, r, position: int) -> Optional[int]:
        """Noise seed of a lane, or None for a greedy lane."""
        if r.temperature <= 0.0:
            return None
        return noise_seed(self.ecfg.seed, r.rid, position)

    def _samp(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.float32).reshape(-1, 3),
                               device=self.device)

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        # beyond the configured buckets (long prompts, or preempted sequences
        # re-queued with their generated context): grow by doubling, capped
        # at the per-sequence cache capacity so admission can succeed.
        cap = self.ccfg.max_pages_per_seq * self.ccfg.page_size
        b = max(self.ecfg.prefill_buckets)
        while b < n:
            b *= 2
        return min(b, cap)

    def _sync_slot_tables(self, slot: int,
                          set_length: Optional[int] = None) -> None:
        # Allocator ids are shifted +1 (physical page 0 is the trash page);
        # entries beyond the allocated count stay 0 → trash. At admission
        # the slot's length is reset (a recycled slot's stale length would
        # expose old pages); decode-time extends keep it.
        npages = self._alloc.num_pages(slot)
        row = np.zeros(self.ccfg.max_pages_per_seq, np.int32)
        row[:npages] = self._alloc.table(slot)[:npages] + 1
        row_t = torch.as_tensor(row, device=self.device)
        for c in self.caches:
            c.page_tables[slot] = row_t
            if set_length is not None:
                c.lengths[slot].fill_(set_length)

    def _admit(self) -> None:
        ps, cs = self.ccfg.page_size, self.ecfg.chunk_size
        while (self.waiting and self._free_slots
               and len(self.running) + len(self.prefilling)
               < self.ecfg.max_batch):
            req = self.waiting[0]
            slot = self._free_slots[0]
            chunked = cs is not None and len(req.prompt) > cs
            bucket = cs if chunked else self._bucket(len(req.prompt) + 1)
            # a chunked prompt is page-covered whole, plus one decode token
            pages_needed = -(-(len(req.prompt) + 1 if chunked else bucket)
                             // ps)
            if not self._alloc.admit(slot, pages_needed):
                break  # pool exhausted; retry next step
            self.waiting.popleft()
            self._free_slots.popleft()
            # a recycled slot's stale length must not leak into the first
            # chunk's prefix attention
            self._sync_slot_tables(slot, set_length=0)
            if chunked:
                self.prefilling[slot] = dict(req=req, done=0,
                                             pages=pages_needed)
            else:
                self._prefill(req, slot, bucket, pages_needed)

    def _advance_prefill(self) -> None:
        """Process ONE chunk of the oldest in-flight chunked prefill, so a
        long prompt streams in without stalling the decode batch. The
        prefix walk's ``pages_bound`` is bucketed to powers of two, as the
        reference's compiled variants are."""
        if not self.prefilling:
            return
        slot, st = next(iter(self.prefilling.items()))
        req, done = st["req"], st["done"]
        cs, ps = self.ecfg.chunk_size, self.ccfg.page_size
        chunk = req.prompt[done:done + cs]
        true_n = len(chunk)
        toks = np.zeros((1, cs), np.int64)
        toks[0, :true_n] = chunk
        need = max(1, -(-done // ps))
        pb = 1
        while pb < need:
            pb *= 2
        logits, _, self.caches = tfm.prefill_chunk(
            self.params, torch.as_tensor(toks, device=self.device), done,
            true_n, self.caches, slot, self.mcfg_prefill,
            pages_bound=min(pb, self.ccfg.max_pages_per_seq))
        st["done"] = done + true_n
        if st["done"] < len(req.prompt):
            return  # intermediate chunks sample nothing
        del self.prefilling[slot]
        self._start_running(req, slot, st["pages"], logits[:, true_n - 1])

    def _write_prompt_kv(self, kv, slot: int, n: int) -> None:
        """Write a whole prompt's K/V into every layer's cache; the padded
        bucket tail is page-covered and masked by length."""
        for c, (k, v) in zip(self.caches, kv):
            c.write_prompt(slot, k[0].transpose(0, 1), v[0].transpose(0, 1))
            c.lengths[slot].fill_(n)  # write_prompt set the padded bucket length

    def _prefill(self, req: Request, slot: int, bucket: int, pages: int) -> None:
        n = len(req.prompt)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = req.prompt
        logits_all, kv = _prefill_all_logits(
            self.params, torch.as_tensor(toks, device=self.device),
            self.mcfg_prefill)
        self._write_prompt_kv(kv, slot, n)
        self._start_running(req, slot, pages, logits_all[:, n - 1])

    def _start_running(self, req: Request, slot: int, pages: int,
                       logits: torch.Tensor) -> None:
        """Sample a prefilled prompt's first token from its last position's
        ``(1, vocab)`` logits (it lands at position ``len(prompt)``) and put
        the request on the decode batch."""
        n = len(req.prompt)
        tok_lp = _sample_packed(
            logits, self._samp([req.temperature, req.top_k, req.top_p]),
            [self._seed_for(req, n)]).cpu().numpy()[0]
        self._tokens_out += 1
        tok = int(tok_lp[0])
        self.running[slot] = _Running(
            rid=req.rid,
            slot=slot,
            tokens=list(req.prompt) + [tok],
            prompt_len=n,
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            top_k=req.top_k,
            top_p=req.top_p,
            eos_id=req.eos_id,
            stop_sequences=tuple(tuple(x) for x in req.stop_sequences),
            true_prompt_len=req.true_prompt_len,
            alloc_tokens=pages * self.ccfg.page_size,
            next_token=tok,
            logprobs=[float(tok_lp[1])],
        )
        self._maybe_finish(slot)

    def _ensure_capacity(self, slot: int, ahead: int = 1) -> str:
        """Make sure the slot can hold ``ahead`` more tokens.

        Returns ``"ok"``, ``"cap"`` (the slot already owns max_pages_per_seq:
        the request must finish, not preempt) or ``"pool"`` (transient pool
        exhaustion: preempt and retry later)."""
        r = self.running[slot]
        need = len(r.tokens) - 1 + ahead
        synced = False
        while need > r.alloc_tokens:
            if self._alloc.num_pages(slot) >= self.ccfg.max_pages_per_seq:
                return "cap"
            if self._alloc.extend(slot) is None:
                if synced:
                    self._sync_slot_tables(slot)
                return "pool"
            r.alloc_tokens += self.ccfg.page_size
            synced = True
        if synced:
            self._sync_slot_tables(slot)
        return "ok"

    def _finish_capacity(self, slot: int) -> None:
        """Terminate a sequence that hit its per-slot page ceiling."""
        r = self.running.pop(slot)
        self.finished.append(FinishedRequest(
            rid=r.rid, tokens=list(r.tokens),
            new_tokens=r.tokens[r.prompt_len:], reason="cap",
            logprobs=list(r.logprobs)))
        self._alloc.free_seq(slot)
        self._free_slots.append(slot)

    def _preempt(self, slot: int) -> None:
        """Return a sequence to the waiting queue (re-prefill later)."""
        cap = self.ccfg.max_pages_per_seq * self.ccfg.page_size
        if len(self.running[slot].tokens) + 1 > cap:
            self._finish_capacity(slot)
            return
        r = self.running.pop(slot)
        self._preemptions += 1
        self._alloc.free_seq(slot)
        self._free_slots.append(slot)
        self.waiting.appendleft(Request(
            rid=r.rid,
            prompt=r.tokens,  # resume with generated context as prompt
            max_new_tokens=r.max_new_tokens - (len(r.tokens) - r.prompt_len),
            temperature=r.temperature,
            top_k=r.top_k,
            top_p=r.top_p,
            eos_id=r.eos_id,
            stop_sequences=r.stop_sequences,
            true_prompt_len=(r.true_prompt_len if r.true_prompt_len is not None
                             else r.prompt_len),
        ))

    def _pages_bound(self) -> int:
        ps = self.ccfg.page_size
        if self.ecfg.pages_bound is not None:
            return self.ecfg.pages_bound
        need = max(-(-len(r.tokens) // ps) for r in self.running.values())
        # powers of 4 (4, 16, 64, …) as in the reference, whose every bucket
        # is a compiled variant; here it only bounds the page walk
        bound = 4
        while bound < need:
            bound *= 4
        return min(bound, self.ccfg.max_pages_per_seq)

    def _decode(self) -> None:
        # capacity check first (may finish at-cap sequences or preempt)
        for slot in sorted(self.running):
            status = self._ensure_capacity(slot)
            if status == "cap":
                self._finish_capacity(slot)
            elif status == "pool":
                self._preempt(slot)
        if not self.running:
            return
        mb = self.ecfg.max_batch
        slots_np = np.full(mb, self._trash_slot, np.int32)
        toks_np = np.zeros(mb, np.int64)
        pos_np = np.zeros(mb, np.int32)
        samp_np = np.zeros((mb, 3), np.float32)
        samp_np[:, 2] = 1.0  # idle lanes: top_p disabled
        seeds: List[Optional[int]] = [None] * mb
        lanes = []
        for lane, slot in enumerate(sorted(self.running)[:mb]):
            r = self.running[slot]
            slots_np[lane] = slot
            toks_np[lane] = r.next_token
            pos_np[lane] = len(r.tokens) - 1  # position of the new token
            samp_np[lane] = (r.temperature, r.top_k, r.top_p)
            # the sampled token lands at position pos + 1
            seeds[lane] = self._seed_for(r, len(r.tokens))
            lanes.append(slot)
        dev = self.device
        logits, self.caches = tfm.decode_step(
            self.params, torch.as_tensor(toks_np, device=dev),
            torch.as_tensor(pos_np, device=dev), self.caches,
            torch.as_tensor(slots_np, device=dev), self.mcfg,
            pages_bound=self._pages_bound(),
            pipelined=self.ecfg.pipelined_decode,
        )
        # idle lanes append to the trash slot every step; reset its length
        # so it never walks off its (all-trash-page) table
        for c in self.caches:
            c.lengths[self._trash_slot].fill_(0)
        packed = _sample_packed(logits, self._samp(samp_np), seeds)
        packed = packed.cpu().numpy()
        for lane, slot in enumerate(lanes):
            r = self.running[slot]
            tok = int(packed[lane, 0])
            r.tokens.append(tok)
            r.next_token = tok
            r.logprobs.append(float(packed[lane, 1]))
            self._tokens_out += 1
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        r = self.running.get(slot)
        if r is None:
            return
        produced = len(r.tokens) - r.prompt_len
        # stop sequences match against everything generated since the
        # ORIGINAL prompt (a preemption requeue absorbs generated tokens)
        gen_total = len(r.tokens) - (
            r.true_prompt_len if r.true_prompt_len is not None
            else r.prompt_len)
        reason = None
        if r.eos_id is not None and r.tokens[-1] == r.eos_id:
            reason = "eos"
        elif any(len(ss) and gen_total >= len(ss)
                 and tuple(r.tokens[-len(ss):]) == tuple(ss)
                 for ss in r.stop_sequences):
            reason = "stop"
        elif produced >= r.max_new_tokens:
            reason = "length"
        if reason:
            self.finished.append(FinishedRequest(
                rid=r.rid, tokens=list(r.tokens),
                new_tokens=r.tokens[r.prompt_len:], reason=reason,
                logprobs=list(r.logprobs)[: len(r.tokens) - r.prompt_len]))
            del self.running[slot]
            self._alloc.free_seq(slot)
            self._free_slots.append(slot)


def _prefill_all_logits(params, tokens, cfg: tfm.ModelConfig):
    """Prefill returning logits for ALL positions (the engine picks
    length − 1) and each layer's rotated K/V."""
    b, n = tokens.shape
    positions = tfm._positions(b, n, tokens.device)
    x = params["embed"][tokens]
    kv = []
    for layer in params["layers"]:
        x = tfm._block(layer, x, positions, cfg, collect_kv=kv)
    x = tfm.rmsnorm(x, params["ln_f"])
    return (x @ params["embed"].T).float(), kv
