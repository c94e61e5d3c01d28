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
* ``decode_steps > 1``: a round of up to K steps a dispatch, tokens
  sampled and appended on the device and fetched once a round; lanes that
  finish mid-round are rolled back on the host. On the card a round is one
  CUDA graph, captured once for each (pages_bound, K) and replayed (the
  reference's jitted ``lax.scan``); the CPU runs the same step body
  eagerly. ``async_decode`` keeps one round in flight, chained on the
  previous round's device outputs. Caches are updated in place, so a
  graph's replays see the engine's current state.
* Sampling: each lane's noise is a counter-based hash on the device of
  (request key, position), the request key a pure function of (engine
  seed, rid) — the reference's keying structure (``fold_in(fold_in(
  key(seed), rid), position)``), not its bits. Streams are
  batching-invariant and reproducible, a K-step round equals K one-token
  steps bit for bit, and greedy streams match the reference token for
  token.
* Decode pins the exact running max; ``prefill_bound_max`` lets prefill
  take the norm bound, which relaxes chunked == unchunked from identical
  to a tolerance, as in the reference.
* Tensor parallelism (``mesh=``, ``tp_axis``): the weights and the cache
  heads split over the mesh's ``tp_axis`` line through this process
  (``parallel/shardings.py``), one process driving its ranks one after
  another (the reference's single-controller loop); every entry point runs
  the model under ``tp=`` (``models/transformer.py``). ``self.params`` is
  then the ranks' slices and ``self.caches`` one list of layer caches a
  rank. On one card a round stays one CUDA graph with the rank sums inside
  it; when the ranks span several cards in one process, rounds run
  eagerly (capture over several devices is later work).

* Prefix cache (``prefix_cache``, ``serving/prefix_cache.py``): full
  prompt pages are indexed by content in the page pool and shared by
  reference; a hit admits with the cached pages in its table and prefills
  only its tail through the chunked path from the cached offset, so no
  kernel writes a shared page. Cached pages are evicted (LRU) before a
  live sequence is preempted.
* Speculative decoding (``Engine(draft=(params, cfg))``, ``speculate_k``
  K ≥ 2): a small draft model with its own paged caches on the target's
  page tables proposes K − 1 tokens a lane in micro-steps, one
  ``decode_verify`` call of the target scores the pending token and the
  proposals, and rejection sampling (:func:`_spec_accept`) emits tokens
  distributed as plain decoding would: greedy streams equal plain greedy
  ones, up to near-ties between the verify and step logits. Proposal and
  acceptance noise come from streams of their own (request key, stream
  tag, position). Every speculative round runs eagerly on committed state;
  ``decode_steps`` is ignored while a draft is attached. Under tensor
  parallelism the draft stays unsharded.
* Multi-LoRA (``Engine(lora=bank)``, ``models/lora.py``): each request
  names an adapter of the bank (``Request.adapter_id``, −1 the base
  model) and every path adds its lanes' adapter deltas: the whole-prompt
  and chunked prefills, the one-token step, the K-step rounds (the round
  graph reads the lanes' ids from a static buffer, refreshed before every
  replay) and the speculative verify (the draft stays base). The prefix
  cache keeps one namespace an adapter. Refused under tensor parallelism,
  as in the reference.
* MoE models (``models/moe.py``) serve through every mode above; the
  engine refuses a capacity factor that could drop a token
  (``models/transformer.py:_check_serving_moe``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.cache.allocator import PageAllocator
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.parallel import shardings
from tpu_flash_torch.serving.prefix_cache import PrefixCache

_MASK64 = (1 << 64) - 1
# splitmix64's increment and finalizer multipliers
_GAMMA = 0x9E3779B97F4A7C15
_M1, _M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective 64-bit hash."""
    x = (x + _GAMMA) & _MASK64
    x = ((x ^ (x >> 30)) * _M1) & _MASK64
    x = ((x ^ (x >> 27)) * _M2) & _MASK64
    return x ^ (x >> 31)


def request_key(seed: int, rid: int) -> int:
    """Request ``rid``'s sampling key, a pure function of (engine seed,
    rid) like the reference's ``fold_in(key(seed), rid)``."""
    return _mix64(_mix64(seed & _MASK64) ^ (rid & 0x7FFFFFFF))


# Stream tags: a speculative round's draft proposals and its acceptance
# draw noise keyed by (request, stream, position), never the target's
# stream; the keys of a stream are mix64(request key ^ tag).
DRAFT_STREAM = 0x64726166745F7370  # "draft_sp"
ACCEPT_STREAM = 0x6163636570745F73  # "accept_s"


def stream_key(seed: int, rid: int, tag: int) -> int:
    """Request ``rid``'s key on the noise stream ``tag``."""
    return _mix64(request_key(seed, rid) ^ tag)


def noise_seed(seed: int, rid: int, position: int) -> int:
    """Key of the sampling noise for request ``rid``'s token at
    ``position``, the reference's ``fold_in(fold_in(key(seed), rid),
    position)`` in structure: the host form of the fold the device makes
    (:func:`_fold`), as an unsigned 64-bit int."""
    return _mix64(request_key(seed, rid) ^ (position & _MASK64))


def _i64(c: int) -> int:
    """An unsigned 64-bit value as the signed one an int64 tensor holds."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 values (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` on int64 tensors: additions and products wrap."""
    x = x + _i64(_GAMMA)
    x = (x ^ _shr(x, 30)) * _i64(_M1)
    x = (x ^ _shr(x, 27)) * _i64(_M2)
    return x ^ _shr(x, 31)


def _fold(keys: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Per-lane noise keys on the device: :func:`noise_seed` of each lane's
    request key (int64, :func:`request_key`) and position."""
    return _mix64_t(keys ^ positions.to(torch.int64))


def _uniforms(lane_keys: torch.Tensor, v: int) -> torch.Tensor:
    """``(B,)`` noise keys → ``(B, v)`` float32 uniforms in (0, 1),
    counter-based: element i takes the top 23 bits of splitmix64's i-th
    output from the lane's key, centred, ``(k + 0.5)·2⁻²³`` (exact)."""
    idx = torch.arange(v, dtype=torch.int64, device=lane_keys.device)
    h = _mix64_t(lane_keys[:, None] + idx[None] * _i64(_GAMMA))
    return (_shr(h, 41).float() + 0.5) * 2.0 ** -23


def _truncated_scores(logits: torch.Tensor, samp: torch.Tensor,
                      truncate: Optional[bool] = None) -> torch.Tensor:
    """Temperature-scaled logits with top-k / nucleus truncation applied
    (truncated entries at -1e30). ``samp``: (B, 3) f32 rows of
    [temperature, top_k, top_p]. A batch with no truncation keeps the
    scaled logits: ``truncate``, where the host knows whether any lane
    truncates (False skips the sort), else chosen on the device (no host
    sync, so a CUDA graph captures it; the reference's ``lax.cond``). The
    values are the same either way."""
    temps, top_k, top_p = samp[:, 0], samp[:, 1], samp[:, 2]
    t = torch.clamp_min(temps, 1e-6)[:, None]
    scaled = logits.float() / t
    if truncate is False:
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
    cut = torch.where(kmask & (scaled < kth), neg, scaled)
    cut = torch.where(cut >= cutoff[:, None], cut, neg)
    if truncate:
        return cut
    return torch.where(((top_k > 0) | (top_p < 1.0)).any(), cut, scaled)


def _device_sample(logits: torch.Tensor, samp: torch.Tensor,
                   keys: torch.Tensor, positions: torch.Tensor,
                   host_samp=None) -> torch.Tensor:
    """On-device next-token choice: greedy for temperature ≤ 0, Gumbel-max
    over the (optionally top-k / nucleus-truncated) scaled distribution
    otherwise. ``keys``: (B,) int64 request keys; ``positions``: (B,) the
    position each sampled token lands at. Lane i's noise is keyed by
    (request, position) alone (:func:`_fold`), so streams are
    batching-invariant and a K-step round equals K single steps.
    ``host_samp``: the host's copy of ``samp`` on an eager step, where an
    all-greedy batch takes the argmax alone and an untruncated one skips
    the sort, bit for bit as without it; None (a captured round) runs
    every part and chooses on the device."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    truncate = None
    if host_samp is not None:
        rows = np.asarray(host_samp, np.float32).reshape(-1, 3)
        if (rows[:, 0] <= 0.0).all():
            return greedy
        truncate = bool(((rows[:, 1] > 0) | (rows[:, 2] < 1.0)).any())
    scaled = _truncated_scores(logits, samp, truncate)
    u = _uniforms(_fold(keys, positions), logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(samp[:, 0] <= 0.0, greedy, sampled)


def _sample_packed(logits, samp, keys, positions,
                   host_samp=None) -> torch.Tensor:
    """(token, logprob) packed into one (B, 2) f32 tensor — one host fetch
    per step. The logprob is the chosen token's raw log-softmax (the model
    distribution, untempered)."""
    tok = _device_sample(logits, samp, keys, positions, host_samp)
    lp = torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                      tok[:, None])[:, 0]
    return torch.stack([tok.float(), lp], dim=1)


def _trunc_dist(logits: torch.Tensor, samp: torch.Tensor,
                host_samp=None) -> torch.Tensor:
    """The distribution plain decoding samples from: the truncated
    temperature softmax, a one-hot argmax at temperature ≤ 0. The p (and q)
    of speculative rejection sampling; its greedy limit makes greedy
    acceptance a case of accept-with-probability min(1, p/q).
    ``host_samp``: the host's copy of ``samp`` (an all-greedy batch skips
    the softmax, an untruncated one the sort), as in
    :func:`_device_sample`."""
    logits = logits.float()
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    truncate = None
    if host_samp is not None:
        rows = np.asarray(host_samp, np.float32).reshape(-1, 3)
        if (rows[:, 0] <= 0.0).all():
            return onehot
        truncate = bool(((rows[:, 1] > 0) | (rows[:, 2] < 1.0)).any())
    probs = torch.softmax(_truncated_scores(logits, samp, truncate), dim=-1)
    return torch.where((samp[:, 0] <= 0.0)[:, None], onehot, probs)


def _spec_accept(toks: torch.Tensor, p_all: torch.Tensor, q: torch.Tensor,
                 lane_keys: torch.Tensor):
    """Speculative rejection sampling (Leviathan et al.), greedy-inclusive.

    toks: (B, K) the pending token and K − 1 draft proposals; p_all: (B, K,
    V) target distributions (``p_all[:, j]`` is that of the token after
    ``toks[:, j]``); q: (B, K − 1, V) the draft distributions the proposals
    were drawn from; lane_keys: (B,) int64 noise keys (the acceptance
    stream's, folded with the round's position). Proposal d_i is accepted
    with probability min(1, p(d_i)/q(d_i)); the first rejection resamples
    from norm(max(p − q, 0)); full acceptance draws the bonus from
    ``p[:, K − 1]``. With one-hot p and q (temperature ≤ 0,
    :func:`_trunc_dist`) this is greedy token matching. Emitted tokens are
    distributed per p for any draft. Lane b's K − 1 coins and its final
    Gumbel noise are elements 0 … K − 2 and K − 1 … of its counter-based
    uniforms (:func:`_uniforms`).

    Returns (m (B,) accepted-proposal counts, final (B,) int64 token).
    """
    b, K = toks.shape
    v = p_all.shape[-1]
    un = _uniforms(lane_keys, K - 1 + v)
    u, uf = un[:, :K - 1], un[:, K - 1:]
    d = toks[:, 1:].long()
    p_d = p_all[:, :K - 1].gather(-1, d[..., None])[..., 0]
    q_d = q.gather(-1, d[..., None])[..., 0]
    accept = (u * q_d < p_d).to(torch.int64)  # u < p/q without the divide
    m = torch.cumprod(accept, dim=1).sum(dim=1)
    rows = torch.arange(b, device=toks.device)
    p_cut = p_all[rows, m]
    q_cut = q[rows, torch.clamp_max(m, K - 2)]
    resid = torch.clamp_min(p_cut - q_cut, 0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 1e-9, resid / torch.clamp_min(rs, 1e-30),
                        p_cut)  # p == q: nothing rejects
    dist = torch.where((m == K - 1)[:, None], p_cut, resid)
    g = -torch.log(-torch.log(uf))
    final = torch.argmax(torch.log(torch.clamp_min(dist, 1e-30)) + g, dim=-1)
    return m, final


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
    # multi-LoRA serving: the adapter's row in the engine's bank (−1: the
    # base model); any mix of adapters and base rides one batched decode
    adapter_id: int = -1
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
    adapter_id: int = -1


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: List[int]
    new_tokens: List[int]
    reason: str  # "length" | "eos" | "stop" | "cap"
    # raw log-softmax of each generated token under the model distribution
    logprobs: List[float] = dataclasses.field(default_factory=list)
    adapter_id: int = -1


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    prefill_buckets: tuple = (64, 128, 256, 512, 1024, 2048)
    pages_bound: Optional[int] = None  # static cap for the decode kernel
    pipelined_decode: bool = False  # each lane walks exactly its own pages
    # tokens per prefill chunk (a page multiple): longer prompts stream in
    # chunks, one per engine step, interleaved with decode
    chunk_size: Optional[int] = None
    # copy-on-write sharing of full prompt pages (serving/prefix_cache.py)
    prefix_cache: bool = False
    prefix_cache_entries: int = 4096
    # prefill (whole or chunked) with the norm-bound max: chunked ==
    # unchunked then holds to a tolerance, not exactly; decode stays exact
    prefill_bound_max: bool = False
    metrics_path: Optional[str] = None  # per-step JSONL metrics stream
    # speculative decoding: tokens a lane verifies a round (the pending one
    # and K - 1 proposals); needs Engine(draft=...)
    speculate_k: int = 0
    # decode_steps > 1 only: keep one round in flight, round N+1 issued on
    # round N's device outputs before N's tokens are fetched; the committed
    # streams are those of the synchronous loop
    async_decode: bool = True
    # > 1: up to this many decode steps a round (powers of two), one host
    # fetch a round; on the card a round is one CUDA graph replay; ignored
    # while a draft model is attached
    decode_steps: int = 1
    seed: int = 0


def _check_engine_config(ecfg: EngineConfig) -> None:
    if ecfg.decode_steps < 1:
        raise ValueError(f"decode_steps must be >= 1, got {ecfg.decode_steps}")


class Engine:
    def __init__(
        self,
        params,
        model_cfg: tfm.ModelConfig,
        cache_cfg: CacheConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        mesh=None,
        tp_axis: str = "model",
        draft=None,
        lora=None,
    ):
        _check_engine_config(engine_cfg)
        if lora is not None and mesh is not None:
            raise NotImplementedError(
                "multi-LoRA under tensor parallelism is not composed yet "
                "(the adapter deltas would need the projections' shardings)")
        tfm._check_serving_moe(model_cfg)
        # The engine pins the exact running max (the reference's bit-identical
        # chunked-vs-unchunked contract forbids the span-dependent bound).
        if model_cfg.attn_bound_max:
            raise ValueError(
                "attn_bound_max=True breaks the engine's bit-identical "
                "chunked-vs-unchunked prefill contract; leave it None")
        self.mesh = mesh
        self.tp = mesh.axis(tp_axis) if mesh is not None else None
        if self.tp is not None:
            shardings.check_divisible(model_cfg, self.tp.size)
            if not isinstance(params, list):  # else: this process's slices
                params = shardings.shard_params(params, self.tp)
        self.params = params
        # the adapter bank (models/lora.py: one dict a layer) or None
        self.lora = lora
        self._n_adapters = (0 if lora is None else
                            next(iter(lora[0].values()))["a"].shape[0])
        self.mcfg = dataclasses.replace(model_cfg, attn_bound_max=False)
        # prefill may opt into the norm bound (a tolerance contract)
        self.mcfg_prefill = (
            dataclasses.replace(model_cfg, attn_bound_max=True)
            if engine_cfg.prefill_bound_max else self.mcfg)
        self.ccfg = cache_cfg
        self.ecfg = engine_cfg
        self.device = (params if self.tp is None else params[0])[
            "embed"].device
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
        self.caches = self._make_caches()
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
        self._inflight = None  # async decode: the one issued round
        # K-step rounds on the card: one CUDA graph per (pages_bound, K),
        # all reading one set of static inputs (_round_graph)
        self._graphs: dict = {}
        self._static: Optional[dict] = None
        # graph captures and replays, and the kernel launches they carry:
        # kernels.LAUNCHES counts a graph's launches once, at its capture
        self.graph_stats = dict(captures=0, replays=0, captured={},
                                replayed={})
        self._pcache = (PrefixCache(self._alloc,
                                    engine_cfg.prefix_cache_entries)
                        if engine_cfg.prefix_cache else None)
        # speculative decoding: the draft model and its own paged caches,
        # on the target's page geometry and tables (the draft pool mirrors
        # the target's pages, so no second allocator); unsharded under TP
        self._draft = None
        if draft is not None and engine_cfg.speculate_k > 0:
            if engine_cfg.speculate_k < 2:
                raise ValueError(
                    "speculate_k must be >= 2 (one pending + >=1 proposal); "
                    "k=1 would pay the draft prefills for nothing")
            dparams, dcfg = draft
            if dcfg.vocab_size != model_cfg.vocab_size:
                raise ValueError("draft vocab must match the target's")
            dccfg = dataclasses.replace(cache_cfg,
                                        num_kv_heads=dcfg.num_kv_heads,
                                        head_dim=dcfg.head_dim)
            self._draft = dict(
                params=dparams, cfg=dataclasses.replace(
                    dcfg, attn_bound_max=False),
                caches=[PagedKVCache.create(dccfg, self.device)
                        for _ in range(dcfg.num_layers)],
                lens={})  # slot → tokens the draft cache stores (host)
        self._spec_proposed = 0
        self._spec_accepted = 0

    def _make_caches(self):
        """One paged cache a layer; under tensor parallelism one such list
        a rank, each cache holding the rank's kv heads, on its device."""
        if self.tp is None:
            return [PagedKVCache.create(self.ccfg, self.device)
                    for _ in range(self.mcfg.num_layers)]
        rank_cfg = shardings.rank_cache_config(self.ccfg, self.tp.size)
        return [[PagedKVCache.create(rank_cfg, dev)
                 for _ in range(self.mcfg.num_layers)]
                for dev in self.tp.devices]

    def _all_caches(self):
        """Every cache of every rank this engine drives."""
        if isinstance(self.caches[0], PagedKVCache):
            return list(self.caches)
        return [c for rank in self.caches for c in rank]

    def _graphs_ok(self) -> bool:
        """Rounds run as CUDA graphs: on a card, every cache on it."""
        return (self.device.type == "cuda"
                and all(c.lengths.device == self.device
                        for c in self._all_caches()))

    # ---- public API -----------------------------------------------------

    def submit(self, req: Request) -> None:
        cap = self.ccfg.max_pages_per_seq * self.ccfg.page_size
        if len(req.prompt) + 1 > cap:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds per-sequence "
                f"cache capacity {cap}")
        if req.adapter_id != -1 and self.lora is None:
            # decoding an adapter request on the base model would be silent
            raise ValueError(
                f"request {req.rid} names adapter {req.adapter_id} but this "
                "engine was built without a LoRA bank")
        if req.adapter_id != -1 and not 0 <= req.adapter_id < self._n_adapters:
            # the reference clamps the id into the bank: another adapter's
            # deltas, silently
            raise ValueError(
                f"request {req.rid} names adapter {req.adapter_id}; the bank "
                f"holds {self._n_adapters}")
        self.waiting.append(req)

    def step(self) -> None:
        """Admit + prefill new requests, advance one chunked prefill, then
        advance all running sequences by one decode token, or by a round of
        up to ``decode_steps`` tokens."""
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
                **self._feature_stats(),
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
            graph_captures=self.graph_stats["captures"],
            graph_replays=self.graph_stats["replays"],
            **self._feature_stats(),
        )

    def _feature_stats(self) -> dict:
        """The prefix cache's and the speculation's counters, where on."""
        out = {}
        if self._pcache is not None:
            out["prefix_cache"] = self._pcache.stats()
        if self._draft is not None:
            out["speculative"] = self.spec_stats()
        return out

    def spec_stats(self) -> dict:
        """Draft proposals verified and accepted so far."""
        return dict(proposed=self._spec_proposed,
                    accepted=self._spec_accepted)

    def run(self, max_steps: int = 10_000) -> List[FinishedRequest]:
        steps = 0
        while ((self.waiting or self.running or self.prefilling)
               and steps < max_steps):
            self.step()
            steps += 1
        self.flush()  # commit any async round left in flight
        return self.finished

    def stream(self, max_steps: int = 10_000):
        """Generator form of :meth:`run`: yields ``(rid, token, logprob)``
        for every generated token as soon as its engine step commits it (a
        round yields several per rid at once), then the FinishedRequest when
        a request completes. A preemption requeue absorbs generated tokens
        into the prompt; each token is still yielded exactly once."""
        # rid → [prompt_len last seen, tokens yielded in that basis]: a
        # requeued request's indices restart at its grown prompt_len, which
        # the prompt_len change itself reveals
        state: dict[int, list] = {}
        done_seen = 0
        steps = 0

        def drain():
            nonlocal done_seen
            out = []
            for r in list(self.running.values()):
                st = state.setdefault(r.rid, [r.prompt_len, 0])
                if r.prompt_len > st[0]:
                    st[1] = max(0, st[1] - (r.prompt_len - st[0]))
                    st[0] = r.prompt_len
                n = len(r.tokens) - r.prompt_len
                for i in range(st[1], n):
                    out.append((r.rid, r.tokens[r.prompt_len + i],
                                r.logprobs[i] if i < len(r.logprobs)
                                else None))
                st[1] = n
            while done_seen < len(self.finished):
                f = self.finished[done_seen]
                done_seen += 1
                st = state.pop(f.rid, [0, 0])
                for i in range(st[1], len(f.new_tokens)):
                    out.append((f.rid, f.new_tokens[i],
                                f.logprobs[i] if i < len(f.logprobs)
                                else None))
                out.append(f)
            return out

        while ((self.waiting or self.running or self.prefilling)
               and steps < max_steps):
            self.step()
            steps += 1
            yield from drain()
        self.flush()  # commit any async round left in flight
        yield from drain()

    def flush(self) -> None:
        """Commit the in-flight async round, if any, and roll the cache
        lengths back to the committed tokens. The step loop flushes by
        itself whenever the batch changes or capacity tightens."""
        info, self._inflight = self._inflight, None
        if info is None:
            return
        self._commit_round(info)
        self._rollback_lengths(info)

    # ---- internals ------------------------------------------------------

    def _key_for(self, rid: int, stream: Optional[int] = None) -> int:
        """The request's sampling key as an int64 value; ``stream``: the key
        on that noise stream (:func:`stream_key`) instead."""
        if stream is None:
            return _i64(request_key(self.ecfg.seed, rid))
        return _i64(stream_key(self.ecfg.seed, rid, stream))

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _samp(self, rows) -> torch.Tensor:
        return self._dev(np.asarray(rows, np.float32).reshape(-1, 3))

    def _aids(self, ids) -> Optional[torch.Tensor]:
        """Lanes' adapter ids on the device (int32), or None without a
        bank."""
        if self.lora is None:
            return None
        return self._dev(np.asarray(ids, np.int32).reshape(-1))

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
        # A prefix hit's length is its cached prefix. The draft caches
        # mirror the target's tables and lengths.
        npages = self._alloc.num_pages(slot)
        row = np.zeros(self.ccfg.max_pages_per_seq, np.int32)
        row[:npages] = self._alloc.table(slot)[:npages] + 1
        row_t = torch.as_tensor(row, device=self.device)
        drafts = self._draft["caches"] if self._draft is not None else []
        for c in self._all_caches() + drafts:
            c.page_tables[slot] = row_t.to(c.page_tables.device)
            if set_length is not None:
                c.lengths[slot].fill_(set_length)

    def _evict_for_pool(self) -> bool:
        """Drop LRU prefix-cache entries until a page actually returns to
        the pool (entries whose pages a table still holds free nothing).
        False when the cache is drained, or off."""
        if self._pcache is None:
            return False
        while len(self._pcache):
            if self._pcache.evict(4):
                return True
        return False

    def _chunk_bucket(self, n: int) -> int:
        """The prefill chunk of an n-token tail: its bucket rounded up to a
        page multiple (a chunk writes whole pages)."""
        ps = self.ccfg.page_size
        return -(-self._bucket(max(n, 1)) // ps) * ps

    def _can_admit(self) -> bool:
        return bool(self.waiting and self._free_slots
                    and len(self.running) + len(self.prefilling)
                    < self.ecfg.max_batch)

    def _admit(self) -> None:
        ps, cs = self.ccfg.page_size, self.ecfg.chunk_size
        if (self._pcache is not None and self._inflight is not None
                and self._can_admit()):
            # a hit's tail chunk reads pages an in-flight round's lanes
            # share: commit the round first, as a change of batch does
            self.flush()
        while self._can_admit():
            req = self.waiting[0]
            slot = self._free_slots[0]
            # Herd gate: a request whose first page a prefilling one shares
            # waits a step, so the leader's insert turns it into a whole-
            # chain hit rather than a one-page match.
            if self._pcache is not None and self.prefilling:
                head = tuple(req.prompt[:ps])
                if any(tuple(st["req"].prompt[:ps]) == head
                       for st in self.prefilling.values()):
                    break
            shared = (self._pcache.match(req.prompt, ps,
                                         anchor=-2 - req.adapter_id)
                      if self._pcache is not None else [])
            # a sliver hit trades a whole-prompt prefill for a slower
            # chunked one: require the cached prefix to be worth it
            if shared and (len(shared) * ps
                           < max(2 * ps, len(req.prompt) // 8)):
                shared = []
            if shared:
                # the table: the shared pages, then fresh tail pages; the
                # tail prefills through the chunked path from the cached
                # offset, attending the shared prefix through B2
                cached = len(shared) * ps
                pages_needed = -(-(len(req.prompt) + 1) // ps)
                if not self._alloc.admit_shared(slot, shared,
                                                pages_needed - len(shared)):
                    if self._evict_for_pool():
                        continue  # pages came back; retry this request
                    break
                self.waiting.popleft()
                self._free_slots.popleft()
                self._sync_slot_tables(slot, set_length=cached)
                tail = len(req.prompt) - cached
                self.prefilling[slot] = dict(
                    req=req, done=cached, pages=pages_needed,
                    chunk=min(self._chunk_bucket(tail), cs or 10**9))
                continue
            chunked = cs is not None and len(req.prompt) > cs
            bucket = cs if chunked else self._bucket(len(req.prompt) + 1)
            # a chunked prompt is page-covered whole, plus one decode token
            pages_needed = -(-(len(req.prompt) + 1 if chunked else bucket)
                             // ps)
            if not self._alloc.admit(slot, pages_needed):
                if self._evict_for_pool():
                    continue  # pages came back; retry this request
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
        # a prefix hit's tail runs in a chunk of its own size
        cs = st.get("chunk") or self.ecfg.chunk_size
        ps = self.ccfg.page_size
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
            pages_bound=min(pb, self.ccfg.max_pages_per_seq), tp=self.tp,
            lora=self.lora, adapter_ids=self._aids([req.adapter_id]))
        st["done"] = done + true_n
        if st["done"] < len(req.prompt):
            return  # intermediate chunks sample nothing
        del self.prefilling[slot]
        self._start_running(req, slot, st["pages"], logits[:, true_n - 1])

    def _write_prompt_kv(self, kv, slot: int, n: int) -> None:
        """Write a whole prompt's K/V into every layer's cache (under
        tensor parallelism each rank's heads into its caches); the padded
        bucket tail is page-covered and masked by length."""
        if self.tp is not None:
            pairs = [(c, kvr) for li, layer_kv in enumerate(kv)
                     for c, kvr in zip((r[li] for r in self.caches),
                                       layer_kv)]
        else:
            pairs = zip(self.caches, kv)
        for c, (k, v) in pairs:
            c.write_prompt(slot, k[0].transpose(0, 1), v[0].transpose(0, 1))
            c.lengths[slot].fill_(n)  # write_prompt set the padded bucket length

    def _prefill(self, req: Request, slot: int, bucket: int, pages: int) -> None:
        n = len(req.prompt)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = req.prompt
        logits_all, kv = _prefill_all_logits(
            self.params, torch.as_tensor(toks, device=self.device),
            self.mcfg_prefill, tp=self.tp, lora=self.lora,
            adapter_ids=self._aids([req.adapter_id]))
        self._write_prompt_kv(kv, slot, n)
        self._start_running(req, slot, pages, logits_all[:, n - 1])

    def _start_running(self, req: Request, slot: int, pages: int,
                       logits: torch.Tensor) -> None:
        """Sample a prefilled prompt's first token from its last position's
        ``(1, vocab)`` logits (it lands at position ``len(prompt)``) and put
        the request on the decode batch; first index its full prompt pages
        in the prefix cache and seed the draft's caches, where on."""
        if self._pcache is not None:
            self._pcache.insert(req.prompt, self._alloc.table(slot),
                                self.ccfg.page_size,
                                anchor=-2 - req.adapter_id)
        if self._draft is not None:
            self._draft_prefill(req.prompt, slot)
        n = len(req.prompt)
        row = [req.temperature, req.top_k, req.top_p]
        tok_lp = _sample_packed(
            logits, self._samp(row),
            self._dev(np.array([self._key_for(req.rid)], np.int64)),
            self._dev(np.array([n], np.int32)), host_samp=row).cpu().numpy()[0]
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
            adapter_id=req.adapter_id,
            alloc_tokens=pages * self.ccfg.page_size,
            next_token=tok,
            logprobs=[float(tok_lp[1])],
        )
        self._maybe_finish(slot)

    def _ensure_capacity(self, slot: int, ahead: int = 1) -> str:
        """Make sure the slot can hold ``ahead`` more tokens (a K-step round
        appends K before the host commits any).

        Returns ``"ok"``, ``"cap"`` (the slot already owns max_pages_per_seq:
        the request must finish, not preempt) or ``"pool"`` (transient pool
        exhaustion: preempt and retry later)."""
        r = self.running[slot]
        need = len(r.tokens) - 1 + ahead
        synced = False
        while need > r.alloc_tokens:
            if self._alloc.num_pages(slot) >= self.ccfg.max_pages_per_seq:
                return "cap"
            page = self._alloc.extend(slot)
            if page is None and self._evict_for_pool():
                # cached but unused pages go before a live sequence
                page = self._alloc.extend(slot)
            if page is None:
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
            logprobs=list(r.logprobs), adapter_id=r.adapter_id))
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
            adapter_id=r.adapter_id,
            true_prompt_len=(r.true_prompt_len if r.true_prompt_len is not None
                             else r.prompt_len),
        ))

    def _pages_bound(self, ahead: int = 0) -> int:
        """The decode walk's page cap for the running lanes, ``ahead``
        tokens past their committed ones: powers of 4 (4, 16, 64, …) as in
        the reference, whose every bucket is a compiled variant; here each
        bucket bounds the walk and keys a round's CUDA graph. A pinned
        ``EngineConfig.pages_bound`` stands, raised for a round that needs
        more."""
        ps = self.ccfg.page_size
        need = max(-(-(len(r.tokens) + ahead) // ps)
                   for r in self.running.values())
        bound = 4
        while bound < need:
            bound *= 4
        bound = min(bound, self.ccfg.max_pages_per_seq)
        if self.ecfg.pages_bound is not None:
            if ahead:
                return min(max(self.ecfg.pages_bound, bound),
                           self.ccfg.max_pages_per_seq)
            return self.ecfg.pages_bound
        return bound

    def _decode(self) -> None:
        # With a round in flight the host lags the device by its K tokens:
        # the capacity probe covers them too, and any shortfall flushes
        # first, so finish/preempt below act on committed state.
        if self._inflight is not None:
            ka = self._inflight["K"]
            if any(self._ensure_capacity(s, ahead=ka + 1) != "ok"
                   for s in sorted(self.running)):
                self.flush()
        # capacity check first (may finish at-cap sequences or preempt)
        for slot in sorted(self.running):
            status = self._ensure_capacity(slot)
            if status == "cap":
                self._finish_capacity(slot)
            elif status == "pool":
                self._preempt(slot)
        if not self.running:
            self.flush()  # every in-flight lane is dead: drain it
            return
        K = self.ecfg.speculate_k
        if self._draft is not None:
            # a speculative round runs on committed state; a lane that
            # cannot page-cover the K pre-acceptance writes makes the
            # whole step a plain one
            self.flush()
            if not self.running:
                return
            if all(self._ensure_capacity(s, ahead=K) == "ok"
                   for s in sorted(self.running)[:self.ecfg.max_batch]):
                self._decode_speculative(K)
                return
        elif self.ecfg.decode_steps > 1:
            remaining = self._remaining()
            if remaining <= 0:
                # the round in flight finishes every lane: drain it rather
                # than chain a round of discards
                self.flush()
                if not self.running:
                    return
                remaining = self._remaining()
            # K in powers of two (one graph each), shrunk toward the tail so
            # a batch one token from done does not run a round of discards
            K = 1
            while K < min(self.ecfg.decode_steps, remaining):
                K *= 2
            K = min(K, self.ecfg.decode_steps)
            # a chained round stacks its K appends on the in-flight round's
            ka = K + (self._inflight["K"] if self._inflight is not None
                      else 0)
            if K > 1 and all(
                    self._ensure_capacity(s, ahead=ka) == "ok"
                    for s in sorted(self.running)[:self.ecfg.max_batch]):
                self._decode_multi(K)
                return
        self.flush()  # the one-token step fetches synchronously
        if not self.running:
            return
        lanes, slots_np, toks_np, pos_np, samp_np, keys_np, aids_np, _ = (
            self._decode_composition())
        packed = self._step(
            *(self._dev(a) for a in (toks_np, pos_np, slots_np, samp_np,
                                     keys_np)), self._aids(aids_np),
            self._pages_bound(), host_samp=samp_np).cpu().numpy()
        for lane, slot in enumerate(lanes):
            r = self.running[slot]
            tok = int(packed[lane, 0])
            r.tokens.append(tok)
            r.next_token = tok
            r.logprobs.append(float(packed[lane, 1]))
            self._tokens_out += 1
            self._maybe_finish(slot)

    def _step(self, tokens, positions, slots, samp, keys, aids,
              pages_bound: int, host_samp=None):
        """One decode step of every lane on the device: the model step, the
        trash slot's length reset (idle lanes append to it every step, so
        it never walks off its all-trash table) and the sampling of each
        lane's next token (it lands at position + 1). Returns packed
        ``(mb, 2)`` (token, logprob). The one-token step and every step of
        a round, eager or captured, run this; the one-token step passes
        ``host_samp`` (:func:`_device_sample`). ``aids``: the lanes' adapter
        ids (None without a bank)."""
        logits, _ = tfm.decode_step(
            self.params, tokens, positions, self.caches, slots, self.mcfg,
            pages_bound=pages_bound, pipelined=self.ecfg.pipelined_decode,
            tp=self.tp, lora=self.lora, adapter_ids=aids)
        for c in self._all_caches():
            c.lengths[self._trash_slot].fill_(0)
        return _sample_packed(logits, samp, keys, positions + 1, host_samp)

    # ---- speculative decoding --------------------------------------------

    def _draft_prefill(self, prompt, slot: int) -> None:
        """Seed the draft caches with the prompt's K/V: one whole-prompt
        draft forward (B1), padded to its bucket like the target's. A
        prefix hit's shared draft pages are rewritten with the values the
        same prefix gave them."""
        dp = self._draft
        n = len(prompt)
        toks = np.zeros((1, self._bucket(n)), np.int64)
        toks[0, :n] = prompt
        _, kv = tfm.prefill(dp["params"],
                            torch.as_tensor(toks, device=self.device),
                            dp["cfg"])
        for c, (k, v) in zip(dp["caches"], kv):
            c.write_prompt(slot, k[0].transpose(0, 1), v[0].transpose(0, 1))
            c.lengths[slot].fill_(n)
        dp["lens"][slot] = n

    def _draft_step(self, tokens, positions, slots, samp, keys,
                    pages_bound: int, host_samp):
        """One draft decode step of every lane (B2 with B3 fused on the
        draft's caches): the sampled proposal (from the request's own
        truncated distribution over the draft's logits, on the draft
        stream) and that distribution, for the acceptance ratio."""
        dp = self._draft
        logits, _ = tfm.decode_step(dp["params"], tokens, positions,
                                    dp["caches"], slots, dp["cfg"],
                                    pages_bound=pages_bound)
        for c in dp["caches"]:
            c.lengths[self._trash_slot].fill_(0)
        return (_device_sample(logits, samp, keys, positions + 1, host_samp),
                _trunc_dist(logits, samp, host_samp))

    def _decode_speculative(self, K: int) -> None:
        """One speculative round: the draft proposes K − 1 tokens a lane in
        micro-steps (first feeding the confirmed tokens its cache lacks,
        ending with the pending one), one target ``decode_verify`` scores
        the pending token and the proposals, and :func:`_spec_accept`
        emits 1 + accepted tokens a lane, distributed as plain decoding's.
        The micro-steps chain on the device (a lane's next input is its
        next feed token, else its last proposal); the round fetches once.
        Rejected tokens' K/V stay as length-masked garbage."""
        dp = self._draft
        mb = self.ecfg.max_batch
        lanes = sorted(self.running)[:mb]
        n = len(lanes)
        bound = self._pages_bound(ahead=K)
        feeds = [self.running[s].tokens[dp["lens"].get(s, 0):] for s in lanes]
        steps = max(len(f) for f in feeds) + K - 2
        samp_np = np.zeros((mb, 3), np.float32)
        samp_np[:, 2] = 1.0
        slots_np = np.full(mb, self._trash_slot, np.int32)
        dkeys_np, akeys_np = np.zeros(mb, np.int64), np.zeros(mb, np.int64)
        dpos_np, pos_np = np.zeros(mb, np.int32), np.zeros(mb, np.int32)
        feed_np = np.zeros((steps, mb), np.int64)
        use_np = np.zeros((steps, mb), bool)
        pend_np = np.zeros(mb, np.int64)
        aids_np = np.full(mb, -1, np.int32)
        for lane, (s, f) in enumerate(zip(lanes, feeds)):
            r = self.running[s]
            samp_np[lane] = (r.temperature, r.top_k, r.top_p)
            slots_np[lane] = s
            dkeys_np[lane] = self._key_for(r.rid, DRAFT_STREAM)
            akeys_np[lane] = self._key_for(r.rid, ACCEPT_STREAM)
            dpos_np[lane] = dp["lens"].get(s, 0)
            pos_np[lane] = len(r.tokens) - 1  # the pending token's
            pend_np[lane] = r.next_token
            aids_np[lane] = r.adapter_id
            feed_np[:len(f), lane] = f
            use_np[:len(f), lane] = True
        samp, slots, dkeys, akeys, dpos, pos, feed, use = (
            self._dev(a) for a in (samp_np, slots_np, dkeys_np, akeys_np,
                                   dpos_np, pos_np, feed_np, use_np))
        vocab = self.mcfg.vocab_size
        qd = torch.zeros((mb, K - 1, vocab), dtype=torch.float32,
                         device=self.device)
        prop = torch.zeros((mb, K - 1), dtype=torch.int64, device=self.device)
        idle = torch.arange(mb, device=self.device) >= n
        out = None
        for si in range(steps):
            toks = feed[si] if out is None else torch.where(use[si], feed[si],
                                                            out)
            # idle lanes stay at position 0 of the trash slot
            out, qrow = self._draft_step(
                toks, torch.where(idle, 0, dpos + si).to(torch.int32), slots,
                samp, dkeys, bound, samp_np)
            # proposal i of a lane comes from its micro-step len(feed) − 1 + i
            hits = [(lane, si - len(f) + 1) for lane, f in enumerate(feeds)
                    if 0 <= si - len(f) + 1 < K - 1]
            if hits:
                li, ii = (self._dev(np.asarray(x, np.int64))
                          for x in zip(*hits))
                qd[li, ii] = qrow[li]
                prop[li, ii] = out[li]
        toks_v = torch.cat([self._dev(pend_np)[:, None], prop], dim=1)
        # the target verifies under each lane's adapter; the draft is base
        logits, _ = tfm.decode_verify(self.params, toks_v, pos, self.caches,
                                      slots, self.mcfg, pages_bound=bound,
                                      tp=self.tp, lora=self.lora,
                                      adapter_ids=self._aids(aids_np))
        b, _, v = logits.shape
        p_all = _trunc_dist(logits.reshape(b * K, v),
                            samp.repeat_interleave(K, dim=0),
                            np.repeat(samp_np, K, axis=0)).reshape(b, K, v)
        m, final = _spec_accept(toks_v, p_all, qd, _fold(akeys, pos))
        logp = torch.log_softmax(logits, dim=-1)
        rows = torch.arange(b, device=logits.device)
        lp_prop = logp[:, :K - 1].gather(-1, toks_v[:, 1:, None])[..., 0]
        lp_final = logp[rows, m].gather(-1, final[:, None])
        # every verified slot: length base + m + 1; the trash slot: 0
        idx = slots[:n].long()
        new_len = (pos + m + 1).to(torch.int32)[:n]
        for c in self._all_caches():
            dev = c.lengths.device
            c.lengths.index_copy_(0, idx.to(dev), new_len.to(dev))
            c.lengths[self._trash_slot].fill_(0)
        host = torch.cat([prop.float(), m[:, None].float(),
                          final[:, None].float(), lp_prop, lp_final],
                         dim=1).cpu().numpy()
        dlens = np.zeros(n, np.int32)
        for lane, s in enumerate(lanes):
            r = self.running[s]
            base = len(r.tokens) - 1
            acc = int(host[lane, K - 1])
            self._spec_proposed += K - 1
            self._spec_accepted += acc
            # the draft stored every confirmed token through base, and of
            # the proposals d_i (at base + i) only d_1 … d_{K−2} were fed
            dlens[lane] = base + min(acc, K - 2) + 1
            dp["lens"][s] = int(dlens[lane])
            new = [int(x) for x in host[lane, :acc]] + [int(host[lane, K])]
            lps = [float(x) for x in host[lane, K + 1:K + 1 + acc]]
            lps.append(float(host[lane, 2 * K]))
            for tok, lp in zip(new, lps):
                r.tokens.append(tok)
                r.next_token = tok
                r.logprobs.append(lp)
                self._tokens_out += 1
                self._maybe_finish(s)
                if s not in self.running:
                    break
        for c in dp["caches"]:
            c.lengths.index_copy_(0, idx, self._dev(dlens))
        for s in list(dp["lens"]):
            if s not in self.running and s not in self.prefilling:
                dp["lens"].pop(s)

    def _remaining(self) -> int:
        """The most tokens a running lane has still to make, less those
        the round in flight makes for it (committed tokens lag the device
        by that round)."""
        info = self._inflight
        ahead = (set() if info is None
                 else set(zip(info["lanes"], info["rids"])))
        return max(r.max_new_tokens - (len(r.tokens) - r.prompt_len)
                   - (info["K"] if (slot, r.rid) in ahead else 0)
                   for slot, r in self.running.items())

    def _round(self, K: int, pages_bound: int, tokens, positions, slots,
               samp, keys, aids):
        """K :meth:`_step` s, each on the tokens the last one sampled: the
        reference's ``lax.scan``. Returns ``(packed (mb, K, 2), tokens,
        positions)``, the last two feeding a chained round."""
        packs = []
        for _ in range(K):
            packed = self._step(tokens, positions, slots, samp, keys, aids,
                                pages_bound)
            packs.append(packed)
            tokens = packed[:, 0].to(torch.int64)
            positions = positions + 1
        return torch.stack(packs, dim=1), tokens, positions

    def _round_graph(self, pages_bound: int, K: int) -> dict:
        """The CUDA graph of a K-step round at ``pages_bound``, captured at
        its first use (the reference's jit cache key): it reads the
        engine's static inputs and writes its own static outputs. The
        caches and the weights are the same tensors at every replay (they
        are updated in place). A capture that fails raises."""
        key = (pages_bound, K)
        if key in self._graphs:
            return self._graphs[key]
        from tpu_flash_torch.kernels import _build

        if self._static is None:
            mb, dev = self.ecfg.max_batch, self.device
            self._static = dict(
                tokens=torch.zeros(mb, dtype=torch.int64, device=dev),
                positions=torch.zeros(mb, dtype=torch.int32, device=dev),
                slots=torch.full((mb,), self._trash_slot, dtype=torch.int32,
                                 device=dev),
                samp=torch.zeros((mb, 3), dtype=torch.float32, device=dev),
                keys=torch.zeros(mb, dtype=torch.int64, device=dev),
                aids=torch.full((mb,), -1, dtype=torch.int32, device=dev))
        _build.library()  # load the kernels before the capture
        st = self._static
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = self._round(K, pages_bound, st["tokens"], st["positions"],
                               st["slots"], st["samp"], st["keys"],
                               st["aids"] if self.lora is not None else None)
        launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                    if n != before[k]}
        self._graphs[key] = g = dict(graph=graph, outs=outs,
                                     launches=launches)
        self.graph_stats["captures"] += 1
        _add(self.graph_stats["captured"], launches)
        return g

    def _decode_composition(self):
        """Host arrays of the current decode batch, and the chain signature:
        everything a round consumes but tokens and positions, which a
        chained round takes from the previous round's device outputs."""
        mb = self.ecfg.max_batch
        slots_np = np.full(mb, self._trash_slot, np.int32)
        toks_np = np.zeros(mb, np.int64)
        pos_np = np.zeros(mb, np.int32)
        samp_np = np.zeros((mb, 3), np.float32)
        samp_np[:, 2] = 1.0  # idle lanes: top_p disabled
        keys_np = np.zeros(mb, np.int64)
        aids_np = np.full(mb, -1, np.int32)  # idle lanes: the base model
        lanes = []
        for lane, slot in enumerate(sorted(self.running)[:mb]):
            r = self.running[slot]
            slots_np[lane] = slot
            toks_np[lane] = r.next_token
            pos_np[lane] = len(r.tokens) - 1  # position of the new token
            samp_np[lane] = (r.temperature, r.top_k, r.top_p)
            keys_np[lane] = self._key_for(r.rid)
            aids_np[lane] = r.adapter_id
            lanes.append(slot)
        sig = (tuple(lanes), samp_np.tobytes(), keys_np.tobytes(),
               aids_np.tobytes())
        return (lanes, slots_np, toks_np, pos_np, samp_np, keys_np, aids_np,
                sig)

    def _decode_multi(self, K: int) -> None:
        """Advance every running lane by a round of K tokens.

        The K appends run on the device (capacity covered beforehand); the
        host commits the tokens in order through the finish logic, and
        tokens past a finish are discarded (their K/V stay as
        length-masked garbage). With ``async_decode`` one round stays in
        flight: round N+1 is issued on round N's device outputs before N's
        tokens are fetched, so the fetch overlaps the next round. Any change
        of the batch breaks the chain (a flush: fetch, commit, length
        rollback). A chained round may take another K than the round in
        flight (a chain's tail). Sampling is keyed by (request, position),
        so the committed streams are those of the synchronous loop."""
        comp = self._decode_composition()
        use_async = self.ecfg.async_decode
        inflight = self._inflight
        if inflight is not None:
            if use_async and inflight["sig"] == comp[-1]:
                self._inflight = self._issue_round(
                    K, comp, prev=inflight, pages_ahead=inflight["K"] + K)
                self._commit_round(inflight)
                # finishes here change the batch; the next call's sig
                # mismatch flushes the round just issued
                return
            self.flush()
            comp = self._decode_composition()  # the flush may free lanes
            if not comp[0]:
                return
        info = self._issue_round(K, comp,
                                 pages_ahead=2 * K if use_async else K)
        if use_async:
            self._inflight = info
            return
        self._commit_round(info)
        self._rollback_lengths(info)

    def _issue_round(self, K: int, comp, prev=None, *, pages_ahead: int):
        """Start a round: on the card, copy its inputs into the static
        buffers (a chained round: tokens and positions from ``prev``'s
        device outputs, the rest already there) and replay its graph, then
        queue the copy of its tokens to pinned host memory behind an event;
        on the CPU, or with ranks on several cards, run the round
        eagerly."""
        lanes, slots_np, toks_np, pos_np, samp_np, keys_np, aids_np, sig = comp
        bound = self._pages_bound(ahead=pages_ahead)
        if self._graphs_ok():
            g = self._round_graph(bound, K)
            st = self._static
            if prev is None:
                self._load_static(dict(
                    tokens=toks_np, positions=pos_np, slots=slots_np,
                    samp=samp_np, keys=keys_np, aids=aids_np))
            else:
                st["tokens"].copy_(prev["ntok"])
                st["positions"].copy_(prev["npos"])
            g["graph"].replay()
            self.graph_stats["replays"] += 1
            _add(self.graph_stats["replayed"], g["launches"])
            packed, ntok, npos = g["outs"]
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            inputs = None
        else:
            if prev is None:
                inputs = (*(self._dev(a) for a in (slots_np, samp_np,
                                                   keys_np)),
                          self._aids(aids_np))
                toks, pos = self._dev(toks_np), self._dev(pos_np)
            else:
                inputs, toks, pos = prev["inputs"], prev["ntok"], prev["npos"]
            host, ntok, npos = self._round(K, bound, toks, pos, *inputs)
            done = None
        return dict(packed=host, done=done, ntok=ntok, npos=npos, K=K,
                    sig=sig, inputs=inputs, lanes=list(lanes),
                    rids=[self.running[s].rid for s in lanes])

    def _load_static(self, arrays: dict) -> None:
        """Copy a round's host inputs into the graph's static buffers,
        every one of them before every replay that is not chained: the
        lanes' slots, sampling rows, keys and adapter ids change as
        requests finish and are admitted."""
        for name, a in arrays.items():
            self._static[name].copy_(torch.from_numpy(a))

    def _commit_round(self, info) -> None:
        """Fetch an issued round and commit its tokens through the finish
        logic. Lanes that finished at an earlier step (or in an earlier
        round) and slots a newer request took are discarded."""
        if info["done"] is not None:
            info["done"].synchronize()
        packed = info["packed"].cpu().numpy()  # (mb, K, 2)
        for j in range(info["K"]):
            for lane, slot in enumerate(info["lanes"]):
                r = self.running.get(slot)
                if r is None or r.rid != info["rids"][lane]:
                    continue  # finished earlier, or recycled: discard
                tok = int(packed[lane, j, 0])
                r.tokens.append(tok)
                r.next_token = tok
                r.logprobs.append(float(packed[lane, j, 1]))
                self._tokens_out += 1
                self._maybe_finish(slot)

    def _rollback_lengths(self, info) -> None:
        """Set each lane's cache length back to its committed count (the
        engine's invariant: length = len(tokens) − 1, the pending token's
        K/V appended by the next step); a finished lane's slot goes to 0.
        A slot that a newer request already took (running or in a chunked
        prefill) keeps that request's length."""
        slots, lens = [], []
        for lane, slot in enumerate(info["lanes"]):
            r = self.running.get(slot)
            if r is not None and r.rid == info["rids"][lane]:
                slots.append(slot)
                lens.append(len(r.tokens) - 1)
            elif r is None and slot not in self.prefilling:
                slots.append(slot)
                lens.append(0)
        if not slots:
            return
        idx = self._dev(np.asarray(slots, np.int64))
        vals = self._dev(np.asarray(lens, np.int32))
        for c in self._all_caches():
            dev = c.lengths.device
            c.lengths.index_copy_(0, idx.to(dev), vals.to(dev))

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
                logprobs=list(r.logprobs)[: len(r.tokens) - r.prompt_len],
                adapter_id=r.adapter_id))
            del self.running[slot]
            self._alloc.free_seq(slot)
            self._free_slots.append(slot)


def _add(total: dict, counts: dict) -> None:
    """Add launch counts into a running total, name by name."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def _prefill_all_logits(params, tokens, cfg: tfm.ModelConfig, tp=None,
                        lora=None, adapter_ids=None):
    """Prefill returning logits for ALL positions (the engine picks
    length − 1) and each layer's rotated K/V (under ``tp``, each layer's
    per-rank list). ``lora``, ``adapter_ids``: the adapter bank and the
    rows' ids."""
    tfm._check_serving_moe(cfg)
    top = params if tp is None else params[0]
    b, n = tokens.shape
    positions = tfm._positions(b, n, tokens.device)
    x = top["embed"][tokens]
    kv = []
    for i in range(len(top["layers"])):
        x = tfm._block(tfm._layer(params, i, tp), x, positions, cfg,
                       collect_kv=kv, tp=tp,
                       lora_layer=None if lora is None else lora[i],
                       adapter_ids=adapter_ids)
    x = tfm.rmsnorm(x, top["ln_f"])
    return (x @ top["embed"].T).float(), kv
