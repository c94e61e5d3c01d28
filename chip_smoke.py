#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_flash_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tpu_flash_torch/csrc with nvcc, holds
each kernel against its plain PyTorch version at its path's shapes, serves
16 requests through the port's engine at the full width of the repo's
canonical decode model (vocab 32000, dim 2048, 16 layers, 16 q / 8 kv heads,
head_dim 128, bf16 weights from a seed, int8 paged cache) and checks the
output against a teacher-forced forward, and serves them again from an fp8
(e4m3) and from an int4 cache, each within its own drift bound, then serves
them with int8 weights (quantize_weights) for 96 new tokens in rounds of up
to 8 decode steps, each round one CUDA graph replay, async (phase
serve_multistep), held against the one-token engine (tokens equal,
logprobs within 1e-6), the synchronous rounds and a teacher-forced forward,
and holds decode_verify of 4 tokens on each of the 16 lanes against 4
decode steps on the float32 model of the same weights (a planted fault,
one key too many, rejected; the bf16 model's gap printed), each of its 16
B2 calls over 64 lanes held against the plain version on its own inputs
(the same fault rejected), then serves the canonical model with 4 q / 2 kv
heads of head_dim 512 (phase wide_heads_serve: the same weight and cache
bytes) one token a step, in async rounds of 8 as CUDA graphs (streams
equal) and through chunked prefill (against whole-prompt prefill), holds
the last layer's B1, B2 (B3 fused) and B2 shared-table calls against
their plain versions (V's columns 256–511 hidden must fail each check)
and times the kernels at d 512, then takes
three SGD train steps of the same model on 4 × 1025 tokens and checks their
gradient against the f32 oracle attention's, three of the model in
float32 (phase train_f32: B4/B5 on their 3×TF32 kernels, 48 launches of
each by device name, the projections in full float32), three of the wide
model in float32 (phase train_wide_f32: B4/B5 at width 512 on the 3×TF32
kernels that split the head dim across a 4-CTA cluster), and three of the
same model with a sliding window (1025) on 2 × 2049 tokens, its gradient held against
the sliding oracle's and shown to miss the causal oracle's, then runs the
backward sweep at its quick shapes (tpu_flash_torch/bench/sweep.py), then
runs the quantized headline (bench.py's shape:
batch 4, 8 heads, n 8192, d 128) through serving_flash_attention (fp8 and
int8) and quantized_dense_fa (fp8), each gated against the blockwise f32
oracle, and holds B6/B7 against their plain versions there and at variant
shapes; then runs B6/B7 on the band, circulant and block-diagonal
schedules at the baseline's shapes through the public calls (phase
quant_bands: sliding_fa, circulant_fa, block_fa, serving_flash_attention
and the d <= 64 route), each gated against its matched oracle and shown to
miss the full-history one, with B6/B7 held against their plain versions on
every kind and four planted faults rejected; then serves the canonical
model with a sliding window (1025)
through chunked prefill (chunks of 512) and the pipelined decode, checks it
against a teacher-forced sliding forward and against an unchunked engine,
and holds the band, norm-bound and banded paged kernels against their plain
versions at that path's shapes; then runs the primitives (fused_softmax and
matmul at the sweep's full-size shapes, tpu_flash_torch/bench/sweep.py)
and the N-d and new-schedule path (circulant_fa and block_fa at n 8192,
block2d over 256 × 256, N-d dense_fa and windowed_fa), each gated against
the oracles, and holds the softmax, matmul and B1 circulant and
block-diagonal kernels against their plain versions, timed beside the
library calls; then runs ring attention (tpu_flash_torch/parallel/ring.py)
over virtual ranks on the one card: B1, B4/B5, B6 and B7 against their
plain versions on the ring hop's shifted kinds (two planted faults
rejected), the ring at the baseline's attention width (32 heads, d 128,
N 32768, 8 ranks) in bf16 dense, causal, local and circulant and in three
quantized local modes against the single-device kernels and the oracles,
its gradient against the single-device one, and the sequence-parallel
train step of the canonical model against the plain step; then runs the
parallel modules over virtual ranks on the card (phases seq_serve,
seq_decode, tp_serve, ulysses): SeqShardedEngine over 4 sequence ranks of
an int4 cache (BASELINE config #5 on the canonical model: 4 lanes of
32,704 + 64 tokens) against the unsharded engine, the sharded decode at
32 heads × d 128 over 4 × 32,768 tokens against one walk of the whole
history (two planted faults rejected), each rank's B2 call and the tail
rank's fused append in both held against the plain versions on their own
inputs (a hidden page rejected), tensor-parallel serving with int8
weights in rounds of 8 over 2 and 4 ranks against the unsharded engine
and the float32 TP forward (a dropped partial rejected), and Ulysses over
8 ranks at the ring's width (every schedule, the gradient, fp8, a
reversed inverse rejected), timed beside the single-device kernels and
the ring; then the serving features (phases speculative, prefix_cache,
resume), each on the canonical model at full width with the port's native
page pool: speculative decoding with the 2-layer draft of
scripts/r2_exp6.py at K 2 and 4 and a self-draft at K 4 (8 prompts of 128
tokens, 64 new, int8 cache of 512 pages), speculative greedy held to plain
greedy token for token on the float32 model (a parting allowed only at a
near-tie, one proposal too many accepted rejected), the bf16 streams'
drift, a round's verify B2 calls and a draft micro-step's fused B2 + B3
against their plain versions; the prefix cache on 8 requests of a shared
2048-token prompt (cold, then cached twice: every request after the first
hits the 32-page prefix, each hit's last-prompt logits against the cold
run's, a hit admitted with length 0 rejected, the shared pages' bytes
unchanged, the hit tail's B2 shared-route call against its plain
version); checkpoint and resume of the engine cell (bf16, and int8 weights
in rounds of 8) against the uninterrupted run (a swapped page-table row
rejected), and supervised runs with a crash, plain and speculative;
then the MoE model and multi-LoRA (phases moe_serve, lora_serve,
ep_dryrun): the canonical model with 8 experts a layer, top-2, at the
drop-free capacity factor 4 (9.39 GB of weights) served from the int8
cache in one-token steps and in async rounds of 8 as CUDA graphs (streams
equal; against the teacher-forced forward routed as the decode was, drift
≤ 0.15 and flipped tokens only at near-ties, at most one in 8; routing
flips against the free forward at most one decision in 8; one step's and
one prefill's device time by group beside the byte floor; a dropful
capacity factor refused), its float32 2-layer cut decoding as that
forward but at near-ties (un-renormalized gates must fail); the bf16
canonical model with 4 rank-16 adapters on wq/wk/wv/wo
serving 24 requests of mixed adapters in one-token steps and in rounds
of 8 (streams equal while lanes change adapters, a graph whose id buffer
is not refreshed must part), the prefix cache scoped by adapter, a zero
bank bit for bit the base engine, beside the base engine's times, and in
float32 at 2 layers each adapter's stream equal to its merged model's and
a mixed batch to solo runs but at near-ties; one layer's decode call (B3
fused) of each engine against the plain versions; and the dry run's
expert-parallel step over 4 expert ranks against the unsharded step.
B4/B5 are held against their plain version on every
schedule kind (dense, causal, local, local_causal, circulant, block) in
each kernel family and under the int8 dp product. B1, B4/B5 and B14 rows
give two times: the kernel's device
time (a CUDA graph of 20 wrapper calls replayed under CUDA events, ``ms``,
which the kernels line reports) and the wrapper call's (``call_ms``), the
library call timed the same two ways (for B4/B5 the library's fused
backward alone, K/V expanded to the q heads outside the call); planted
faults in their plain versions (B1 a kv tile, B14 a k-slab, B4/B5 a slab of
64 keys or of 64 queries left out) must fail their checks. B2 runs on its
two routes (split and shared table), each held against the plain version
under the card's split plan, twice bitwise equal, with one page of the walk
hidden from the plain version as a planted fault; the decode call with B3's
append fused is one launch, its pages and scales bit-exact to B3's plain
version; all of it on bf16, int8, int4 and fp8 pages (the chunk prefix and
the pipelined decode on the three quantized ones). The device
phase prints the registers and spills of the TMA + wgmma and bulk-copy
sources (ptxas).
Each phase prints one JSON line; any failure raises and the exit code is
not 0. Without a CUDA device it fails at once and prints no result. The
train phase ends with a torch.profiler breakdown of one step. Imports torch
and the port only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.utils.checkpoint

MODEL = dict(vocab_size=32000, dim=2048, num_layers=16, num_q_heads=16,
             num_kv_heads=8, head_dim=128)
CACHE = dict(num_kv_heads=8, head_dim=128, page_size=64, total_pages=1024,
             max_seqs=32, max_pages_per_seq=64, dtype="int8")
MAX_BATCH = 16
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 16, 512, 32
# kernel vs plain version, and vs the f32 oracle: one bf16 ulp of P or of
# the prescaled q, summed (the reference's own bf16 gate)
TOL_BF16 = 2e-2
TOL_F32 = 1e-4
# teacher-forced logprob drift with an int8 cache: more than twice the
# reference's measured 0.0627 at this configuration
TOL_LOGPROB = 0.15
# and from an fp8 (e4m3) cache: more than twice the reference's measured
# 0.1257 at this configuration (logs/decode.jsonl:4, a drift on its TPU,
# not a time); from an int4 cache: the reference's own sweep tolerance for
# it (tpu_flash/bench/sweep.py:551-552)
TOL_LOGPROB_FP8 = 0.30
TOL_LOGPROB_INT4 = 2.5
# the cache types of the paged phase (B2, B3 at the decode shape), and the
# full-width serving runs beyond the int8 one, with their drift bounds
PAGED_CACHES = ("bfloat16", "int8", "int4", "fp8")
QUANT_PAGES = ("int8", "int4", "fp8")
SERVE_CACHES = (("fp8", TOL_LOGPROB_FP8), ("int4", TOL_LOGPROB_INT4))
# backward: B4/B5 vs the plain backward, relative to the largest grad (one
# bf16 ulp of P or dS is 2⁻⁸; float32 differs by summation order only);
# the Function's grads vs the f32 oracle's: the reference's backward gate
# (tpu_flash/bench/sweep.py:396-411) in bf16, tests/test_grad.py's
# atol/rtol in float32
TOL_BWD_PLAIN = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
TOL_BWD_ORACLE = 2.5e-2
# the int8 dp product vs the f32 oracle: twice the reference's 2.5e-2
# (tests/test_grad.py:171-190), which its own algorithm misses on these
# inputs (the plain dp version, which holds the reference's dp grads within
# 1e-4 on the CPU, misses the oracle by as much as the kernel; PERF.md §6,
# PR 11); a σv one channel off on the dO side must fail it
TOL_BWD_DP_ORACLE = 5e-2
# training: tokens (batch, 1 + positions); lr at which bf16 updates
# register (PERF.md §4: a bf16 weight near 0.02 has an ulp of 1.2e-4)
TRAIN_TOKENS = (4, 1025)
TRAIN_STEPS = 3
TRAIN_LR = 1.0
TOL_COSINE = 0.99
TOL_DLOSS = 2e-2
# the sliding model's training: 2 × 2049 tokens at window 1025; an oracle of
# the wrong attention (full causal history) must miss its gradients by at
# least SEPARATION times the right oracle's 1 − cosine
SLIDING_TRAIN_TOKENS = (2, 2049)
SEPARATION = 10.0
# the sliding serving path: the canonical model with ModelConfig's default
# window (radius 512); 12 long prompts (chunked, 3–4 chunks each) and 4
# short ones (prefilled whole), 32 new tokens each
SLIDING_WINDOW = 1025
SLIDING_CHUNK = 512
SLIDING_LONG, SLIDING_SHORT = (1100, 2000), (300, 500)
N_LONG, N_SHORT = 12, 4
# lse of a kernel vs its plain version (float32 sums in another order)
TOL_LSE = 1e-4
# H100 SXM datasheet peaks (dense): bf16 and int8 tensor cores, float32
# FMA, tf32 tensor cores (the float32 B4/B5 at widths 64 and 128: three
# tf32 products a float32 one), HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


# the run's start: each phase's line carries the seconds since it
# (elapsed_s), so the phases' shares of the time limit can be read off
START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - START)
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over entries finite in both; the ±inf pattern must agree."""
    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError("finite/infinite pattern differs")
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above {tol}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max(max |b|, 1): the reference's backward gate."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def roofline(ops, nbytes: float, dtype) -> dict:
    """Least time the card could take: operations over the peak rate of
    their type (``ops`` a count of ``dtype`` operations, or {dtype: count}
    for work of several types), or bytes (each input read once, each output
    written once) over the memory rate, whichever is larger."""
    if not isinstance(ops, dict):
        ops = {dtype: ops}
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in ops.items()) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def visible_pairs(n_q: int, n_kv: int, causal: bool) -> int:
    """(query, key) pairs a head attends: all, or the right-aligned
    causal triangle."""
    if not causal:
        return n_q * n_kv
    off = n_kv - n_q
    return sum(min(n_kv, max(0, i + off + 1)) for i in range(n_q))


def band_pairs(n: int, radius: int, causal: bool) -> int:
    """(query, key) pairs a head attends under the band |i − j| ≤ radius
    (and j ≤ i when causal), n queries and keys."""
    return sum(min(i, radius) + 1 + (0 if causal else min(n - 1 - i, radius))
               for i in range(n))


def sdpa(q, k, v, causal, mask=None):
    """The library's fused attention on (B, H, N, D), causal or under a
    boolean mask; the yardstick that chip_smoke times beside the port's
    kernels (the port never calls it)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=q.shape[1] != k.shape[1])


# B1's planted fault: the plain version with one middle kv tile (64 keys)
# left out must fail the kernel-vs-plain check
B1_FAULT_TILE = 64


def flash_phase(dev):
    """B1 kernel vs its plain version and vs the f32 dense_dpa oracle (o and
    lse vs plain within TOL_BF16 and TOL_LSE); a planted fault (one middle
    kv tile left out of the plain version) must fail that check. Timed at
    the serving prefill (b 1) and at the training shape (b 4): the
    kernel's device time (a CUDA graph of wrapper calls) and the wrapper
    call's time, beside the library's attention timed the same two ways."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.ops.oracle import dense_dpa

    gen = torch.Generator(device=dev).manual_seed(1)
    hq, hkv, d = 16, 8, 128
    # (name, batch, n_q, n_kv, causal, dtype)
    cases = [("causal_1024", 1, 1024, 1024, True, torch.bfloat16),
             ("train_causal_1024_b4", 4, 1024, 1024, True, torch.bfloat16),
             ("ragged_causal_1000", 1, 1000, 1000, True, torch.bfloat16),
             ("right_aligned_256_of_1024", 1, 256, 1024, True, torch.bfloat16),
             ("dense_1024", 1, 1024, 1024, False, torch.bfloat16),
             ("dense_f32_300", 1, 300, 300, False, torch.float32)]
    worst, timed, rows = 0.0, {}, []
    for name, b, n_q, n_kv, causal, dt in cases:
        q = torch.randn(b, hq, n_q, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, hkv, n_kv, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, hkv, n_kv, d, generator=gen, device=dev).to(dt)
        sched = flash.build_schedule("causal" if causal else "dense", n_q,
                                     n_kv, 256, 256)
        qf = (q.float() * (d ** -0.5 * flash.LOG2E)).to(dt).flatten(0, 1)
        args = (qf, k.flatten(0, 1), v.flatten(0, 1), sched, hq, hkv)
        ko, kl = flash._flash_fwd_kernel(*args, True)
        po, pl = flash._flash_fwd_plain(*args)
        g = hq // hkv
        oo, ol = dense_dpa(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                           causal=causal)
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
        errs = dict(o_vs_plain=max_err(ko, po), lse_vs_plain=max_err(kl, pl),
                    o_vs_oracle=max_err(ko, oo.flatten(0, 1)),
                    lse_vs_oracle=max_err(kl, ol.flatten(0, 1)))
        limits = dict(o_vs_plain=tol, lse_vs_plain=min(tol, TOL_LSE),
                      o_vs_oracle=TOL_BF16, lse_vs_oracle=TOL_BF16)
        for key, err in errs.items():
            check(f"B1 {name} {key}", err, limits[key])
        row = dict(case=name, batch=b, n_q=n_q, n_kv=n_kv,
                   dtype=str(dt).replace("torch.", ""), tol=limits, **errs)
        if name == "dense_1024":  # the planted fault
            j = n_kv // 2
            keep = torch.cat([torch.arange(j, device=dev),
                              torch.arange(j + B1_FAULT_TILE, n_kv, device=dev)])
            fsched = flash.build_schedule("dense", n_q, n_kv - B1_FAULT_TILE,
                                          256, 256)
            fo, fl = flash._flash_fwd_plain(qf, args[1][:, keep], args[2][:, keep],
                                            fsched, hq, hkv)
            fault = dict(o_vs_plain=max_err(ko, fo), lse_vs_plain=max_err(kl, fl))
            if all(fault[key] <= limits[key] for key in fault):
                raise AssertionError(f"B1 planted fault kv_tile_left_out passes "
                                     f"the kernel-vs-plain check: {fault}")
            row["planted_fault_kv_tile_left_out"] = fault
        if causal and n_q == n_kv == 1024:  # the serving and training shapes
            row.update(ms=device_ms(lambda: flash._flash_fwd_kernel(*args, True)),
                       call_ms=cuda_ms(lambda: flash._flash_fwd_kernel(*args, True)),
                       plain_ms=cuda_ms(lambda: flash._flash_fwd_plain(*args),
                                        iters=5),
                       library_ms=device_ms(lambda: sdpa(q, k, v, True)),
                       library_call_ms=cuda_ms(lambda: sdpa(q, k, v, True)))
            flops = 4 * d * b * hq * visible_pairs(n_q, n_kv, True)
            row["tflops"] = flops / row["ms"] / 1e9
            nbytes = (2 * b * (2 * hq * n_q * d + 2 * hkv * n_kv * d)
                      + 4 * b * hq * n_q)
            row.update(roofline(flops, nbytes, dt))
            timed[name] = row
        worst = max(worst, errs["o_vs_plain"], errs["lse_vs_plain"])
        rows.append(row)
    emit(dict(phase="flash_fwd", hq=hq, hkv=hkv, d=d, cases=rows))
    serving = timed["causal_1024"]
    return dict(max_abs_err=worst,
                **{key: serving[key] for key in ("ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")})


def _decode_cache(dtype, lens, dev, seed, n_pages=CACHE["max_pages_per_seq"] // 4,
                  cache=CACHE):
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache

    cfg = CacheConfig(**{**cache, "dtype": dtype})
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = PagedKVCache.create(cfg, dev)
    perm = torch.randperm(cfg.total_pages - 1, generator=gen, device=dev) + 1
    c.page_tables[: len(lens), :n_pages] = perm[: len(lens) * n_pages].reshape(
        len(lens), n_pages).int()
    shape = (cfg.num_kv_heads, cfg.head_dim)
    for s, n in enumerate(lens):
        c.write_prompt(s, torch.randn(shape[0], n, shape[1], generator=gen, device=dev),
                       torch.randn(shape[0], n, shape[1], generator=gen, device=dev))
    return c


def _cache_copy(c):
    from tpu_flash_torch.cache.paged_cache import PagedKVCache

    return PagedKVCache(*(None if t is None else t.clone() for t in (
        c.k_pages, c.v_pages, c.k_scales, c.v_scales, c.page_tables,
        c.lengths)), config=c.config)


def _same_cache(name, a, b):
    for key in ("k_pages", "v_pages", "k_scales", "v_scales"):
        x, y = getattr(a, key), getattr(b, key)
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{name}: {key} not bit-exact")


def _b2_args(q, c, slots, len_add, bound, out_dtype=torch.bfloat16, tables=None):
    return (q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots, c.lengths,
            c.page_tables if tables is None else tables, len_add, bound,
            out_dtype, True)


def _card_plan(q, c, shared=False, radius=None):
    """The split plan of the card's route for this call (None: one
    split): the engine's, sized for the cache's walk (plan_pages)."""
    from tpu_flash_torch.ops import paged

    b, kvh, _, d = q.shape
    page = c.k_pages.shape[2]
    if paged.paged_route(page, shared) != "split":
        return None
    return paged.split_plan(b, kvh, d, page, c.config.page_type,
                            paged.plan_pages(c.config, radius))


def _hidden_page(c, slot, logical, dev):
    """A copy of the page tables whose entry (slot, logical) points at
    another lane's page: the planted fault "one page of the walk hidden"
    for the plain version."""
    tables = c.page_tables.clone()
    tables[slot, logical] = c.page_tables[(slot + 1) % 2, logical]
    return tables


def _held_b2(name, got, want, tol_o=TOL_BF16, tol_lse=TOL_BF16):
    (ko, kl), (po, pl) = got, want
    errs = dict(o_vs_plain=max_err(ko, po), lse_vs_plain=max_err(kl, pl))
    check(f"{name} o vs plain", errs["o_vs_plain"], tol_o)
    check(f"{name} lse vs plain", errs["lse_vs_plain"], tol_lse)
    return errs


def _rejects(name, got, fault, tol=TOL_BF16):
    """The planted fault must fail the kernel-vs-plain check."""
    (ko, kl), (fo, fl) = got, fault
    errs = dict(o_vs_plain=max_err(ko, fo), lse_vs_plain=max_err(kl, fl))
    if all(e <= tol for e in errs.values()):
        raise AssertionError(f"{name}: the planted fault passes the check: "
                             f"{errs}")
    return errs


def _bitwise_repeat(name, fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two calls differ")
    return a


def paged_phase(dev, caches=PAGED_CACHES, model=MODEL, cache=CACHE,
                phase="paged"):
    """B3, and B2's split route, vs their plain versions at the decode
    shape (16 lanes, ~540 tokens, ``model``'s q heads over ``cache``'s kv
    heads and head dim, bf16, int8, int4 and fp8 caches): B3's
    pages and scales bit-exact; B2 after B3 and the fused call (B2 with the
    append, one launch) against the plain B3 then B2 under the card's split
    plan, pages bit-exact, o and lse within TOL_BF16, two calls bitwise
    equal; a planted fault (one page of lane 0's walk hidden from the plain
    version) rejected. Timed: device time (a CUDA graph of 20 calls) and call time
    of B3, the split route and the fused call, and the plain versions;
    the fused append's own time is the fused call's less the split
    route's alone."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import paged

    gen = torch.Generator(device=dev).manual_seed(2)
    b, bound = 16, 16
    hq, kvh, d = model["num_q_heads"], cache["num_kv_heads"], cache["head_dim"]
    g = hq // kvh
    lens = (530 + torch.randint(0, 20, (b,), generator=gen, device=dev)).tolist()
    out = {}
    qscale = d ** -0.5 * paged.LOG2E
    for dtype in caches:
        kc = _decode_cache(dtype, lens, dev, 3, cache=cache)
        pc, fc = (_cache_copy(kc) for _ in range(2))
        pt = kc.config.page_type
        kern = functools.partial(paged._paged_attention_kernel, page_type=pt,
                                 walk=paged.plan_pages(kc.config))
        plain = functools.partial(paged._paged_attention_plain, page_type=pt)
        slots = torch.arange(b, dtype=torch.int32, device=dev)
        kn = torch.randn(b, kvh, d, generator=gen, device=dev).bfloat16()
        vn = torch.randn(b, kvh, d, generator=gen, device=dev).bfloat16()

        def app_args(c):
            return (kn, vn, c.k_pages, c.v_pages, c.k_scales, c.v_scales,
                    slots, c.lengths, c.page_tables)

        def app_kernel(c):
            paged._paged_append_kernel(*app_args(c), page_type=pt)

        def app_plain(c):
            paged._paged_append_plain(*app_args(c), page_type=pt)

        app_kernel(kc)
        app_plain(pc)
        _same_cache(f"B3 {dtype}", kc, pc)
        q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
        qr = q.reshape(b, kvh, g, d)
        qg = (q.float() * qscale).bfloat16().reshape(b, kvh, g, d)
        split = _card_plan(qg, kc)
        ka = _b2_args(qg, kc, slots, 1, bound)
        got = _bitwise_repeat(f"B2 split {dtype}", lambda: kern(*ka))
        errs = _held_b2(f"B2 split {dtype}", got, plain(
            *_b2_args(qg, pc, slots, 1, bound), split_pages=split))
        fault = _rejects(f"B2 split {dtype}", got, plain(
            *_b2_args(qg, pc, slots, 1, bound,
                      tables=_hidden_page(pc, 0, 3, dev)), split_pages=split))
        # the fused call on an unappended copy: one launch
        fa = _b2_args(qr, fc, slots, 1, bound)

        def fused():
            return kern(*fa, new_kv=(kn, vn), q_scale=qscale)

        fgot = _bitwise_repeat(f"B2 fused {dtype}", fused)
        _same_cache(f"B2 fused append {dtype}", fc, pc)
        fused_errs = _held_b2(f"B2 fused {dtype}", fgot, plain(
            *_b2_args(qg, pc, slots, 1, bound), split_pages=split))

        row = dict(
            cache=dtype, lanes=b, lens_min=min(lens), lens_max=max(lens),
            pages_bound=bound, split_pages=split, append_bit_exact=True,
            fused_append_bit_exact=True, tol=TOL_BF16, **errs,
            fused=fused_errs, planted_fault_page_hidden=fault,
            append_ms=device_ms(lambda: app_kernel(kc)),
            append_call_ms=cuda_ms(lambda: app_kernel(kc)),
            append_plain_ms=cuda_ms(lambda: app_plain(pc)),
            attention_ms=device_ms(lambda: kern(*ka)),
            attention_call_ms=cuda_ms(lambda: kern(*ka)),
            fused_ms=device_ms(fused), fused_call_ms=cuda_ms(fused),
            attention_plain_ms=cuda_ms(lambda: plain(
                *_b2_args(qg, pc, slots, 1, bound), split_pages=split)))
        # bytes the two functions must move at these lengths (B2 reads
        # each lane's length + 1 tokens: the appended one too); a K or V
        # row of the cache is paged.row_bytes (its scale included): bf16
        # 2d, int8 and fp8 d + 4, int4 d/2 + 4
        rowb = paged.row_bytes(pt, d)
        toks = sum(lens) + b
        att_bytes = toks * kvh * 2 * rowb + b * hq * (4 * d + 4)
        app_bytes = b * kvh * 2 * (2 * d + rowb) + 3 * 4 * b
        row["attention_bound"] = roofline(4 * d * hq * toks, att_bytes,
                                          torch.bfloat16)
        row["append_bound"] = roofline(0, app_bytes, torch.bfloat16)
        row["fused_append_ms"] = row["fused_ms"] - row["attention_ms"]
        row["fused_bound"] = roofline(4 * d * hq * toks, att_bytes + app_bytes,
                                      torch.bfloat16)
        out[dtype] = dict(row, append_err=0.0)
    emit(dict(phase=phase, hq=hq, kvh=kvh, d=d, caches=[out[k] for k in out]))
    return out


def engine_phase(dev, model=MODEL, cache=CACHE, max_batch=MAX_BATCH,
                 n_requests=N_REQUESTS, prompt_len=PROMPT_LEN,
                 new_tokens=NEW_TOKENS):
    """Serve the requests through the port's engine; return the finished
    requests, step times and the launch counts of the run."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    mcfg = tfm.ModelConfig(**model)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(params, mcfg, CacheConfig(**cache), EngineConfig(max_batch=max_batch))
    vocab = mcfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab - 1, (n_requests + 1, prompt_len)).tolist()
    # warm-up request: first cuBLAS handles, allocator pools, kernel loads
    eng.submit(Request(rid=10_000, prompt=prompts[-1], max_new_tokens=new_tokens))
    eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for i in range(n_requests):
        hot = i == n_requests - 1
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=new_tokens,
                           temperature=0.7 if hot else 0.0,
                           top_k=50 if hot else 0, top_p=0.9 if hot else 1.0))
    n_done0 = len(eng.finished)
    kernels.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    while eng.waiting or eng.running or eng.prefilling:
        ts = time.perf_counter()
        eng.step()  # ends in a host fetch of the sampled tokens
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    done = {f.rid: f for f in eng.finished[n_done0:]}
    return dict(params=params, mcfg=mcfg, done=done, step_ms=step_ms,
                wall_s=wall, launches=launches, cache=cache["dtype"])


# the multi-step serving path (the reference sweep's decode rows,
# tpu_flash/bench/sweep.py:475-520): int8 weights (quantize_weights), the
# int8 cache, rounds of up to MULTISTEP_K tokens with async rounds, 96 new
# tokens a request; held against the one-token engine (tokens equal,
# logprobs within tests/test_engine.py:543's 1e-6) and the synchronous
# rounds; decode_verify of VERIFY_K tokens a lane against as many
# decode_steps on the float32 model of the same int8 weights, at
# tests/test_speculative.py:66-67's atol and rtol where the card meets
# them, else at TOL_BF16 (the served bf16 model's gap printed beside);
# each decode_verify's B2 calls against the plain version at TOL_BF16
MULTISTEP_K = 8
MULTISTEP_NEW_TOKENS = 96
TOL_STEPS_LOGPROB = 1e-6
VERIFY_K = 4
TOL_VERIFY = 1e-4


def multistep_serve(params, mcfg, prompts, dev, decode_steps, async_decode,
                    cache=CACHE, new_tokens=MULTISTEP_NEW_TOKENS):
    """Serve the 16 requests (the last one at temperature 0.7, top-k 50,
    top-p 0.9) after one warm-up request through an engine with the given
    decode mode; return the finished requests, each step's host ms, the
    wall time, and the kernel launches that ran (a graph's launches count
    once for each replay, not at its capture)."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    eng = Engine(params, mcfg, CacheConfig(**cache), EngineConfig(
        max_batch=MAX_BATCH, decode_steps=decode_steps,
        async_decode=async_decode))
    eng.submit(Request(rid=10_000, prompt=prompts[-1],
                       max_new_tokens=new_tokens))
    eng.run()
    torch.cuda.synchronize()
    stats = eng.graph_stats
    before = dict(captures=stats["captures"], replays=stats["replays"],
                  captured=dict(stats["captured"]),
                  replayed=dict(stats["replayed"]))
    for i in range(N_REQUESTS):
        hot = i == N_REQUESTS - 1
        eng.submit(Request(rid=i, prompt=prompts[i],
                           max_new_tokens=new_tokens,
                           temperature=0.7 if hot else 0.0,
                           top_k=50 if hot else 0, top_p=0.9 if hot else 1.0))
    n0 = len(eng.finished)
    kernels.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    while eng.waiting or eng.running or eng.prefilling:
        ts = time.perf_counter()
        eng.step()  # ends in a host fetch of the tokens committed
        step_ms.append((time.perf_counter() - ts) * 1e3)
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def delta(key):
        return {k: n - before[key].get(k, 0) for k, n in stats[key].items()}

    captured, replayed = delta("captured"), delta("replayed")
    ran = {k: n - captured.get(k, 0) + replayed.get(k, 0)
           for k, n in kernels.LAUNCHES.items()}
    eager = {k: n - captured.get(k, 0) for k, n in kernels.LAUNCHES.items()}
    out = dict(done={f.rid: f for f in eng.finished[n0:]}, step_ms=step_ms,
               wall_s=wall, launches=ran, eager_launches=eager,
               captures=stats["captures"] - before["captures"],
               replays=stats["replays"] - before["replays"],
               captures_total=stats["captures"],
               graphs=sorted(eng._graphs))
    del eng
    torch.cuda.empty_cache()
    return out


def same_streams(name, got, want, tol=TOL_STEPS_LOGPROB) -> float:
    """Every request of ``want`` finished in ``got`` with its tokens and
    finish reason, logprobs within ``tol``; returns the largest gap."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: finished {sorted(got)}")
    worst = 0.0
    for rid, f in want.items():
        g = got[rid]
        if g.tokens != f.tokens or g.reason != f.reason:
            raise AssertionError(f"{name}: request {rid} differs")
        worst = max(worst, float(np.abs(np.subtract(g.logprobs,
                                                    f.logprobs)).max()))
    check(f"{name}: logprobs", worst, tol)
    return worst


def held_streams(name, got, want, tol=TOL_STEPS_LOGPROB) -> float:
    """The N_REQUESTS requests of ``want`` all finished, and ``got`` holds
    them alike (:func:`same_streams`); returns the largest logprob gap."""
    if sorted(want) != list(range(N_REQUESTS)):
        raise AssertionError(f"{name}: finished {sorted(want)}")
    return same_streams(name, got, want, tol)


def held_verify_b2(calls) -> dict:
    """B2 on exactly the inputs decode_verify gave it, layer by layer:
    16 × VERIFY_K lanes (each slot on VERIFY_K consecutive lanes), visible
    lengths base + j + 1 (lengths_override, no append), each layer's cache
    as its appends left it. The wrapper's o is the main path's bit for
    bit; o and lse are within TOL_BF16 of the plain version under the
    engine's split plan; the planted fault (visible lengths one too long:
    token j sees j + 1's key) must fail that check over the 16 layers (one
    key among ~530 moves o by about its attention weight, so a layer's
    rows may all stay within the bound; the layers that reject it are
    counted)."""
    from tpu_flash_torch.ops import paged

    worst, fault_errs = 0.0, []
    for layer, call in enumerate(calls):
        q, c, slots, kw = call["q"], call["cache"], call["slots"], call["kw"]
        b, qh, d = q.shape
        kvh = c.k_pages.shape[0]
        qr = q.reshape(b, kvh, qh // kvh, d)
        qscale = d ** -0.5 * paged.LOG2E
        qg = (qr.float() * qscale).bfloat16()
        radius = kw.get("radius")
        walk = paged.plan_pages(c.config, radius)
        bound = min(kw["pages_bound"] or walk, walk)
        vis = kw["lengths_override"].to(torch.int32)
        lane_kw = dict(radius=radius, positions=None if radius is None
                       else kw["positions"].to(torch.int32),
                       page_type=c.config.page_type)
        args = (c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
                c.lengths, c.page_tables, 0, bound, q.dtype, True)
        got = paged._paged_attention_kernel(qr, *args, lengths_override=vis,
                                            q_scale=qscale, walk=walk,
                                            **lane_kw)
        torch.cuda.synchronize()
        if not torch.equal(got[0].reshape(b, qh, d), call["o"]):
            raise AssertionError(f"decode_verify B2 layer {layer}: the "
                                 "wrapper's o is not the main path's")
        split = _card_plan(qg, c, radius=radius)
        errs = _held_b2(f"decode_verify B2 layer {layer}", got,
                        paged._paged_attention_plain(
                            qg, *args, lengths_override=vis,
                            split_pages=split, **lane_kw))
        fo, fl = paged._paged_attention_plain(
            qg, *args, lengths_override=vis + 1, split_pages=split,
            **lane_kw)
        worst = max(worst, *errs.values())
        fault_errs.append(max(max_err(got[0], fo), max_err(got[1], fl)))
    out = dict(layers=len(calls), lanes=b, pages_bound=bound,
               split_pages=split, tol=TOL_BF16, max_abs_err=worst,
               main_path_o_bitwise=True, fault_max_err=max(fault_errs),
               fault_least_err=min(fault_errs),
               fault_rejected_layers=sum(e > TOL_BF16 for e in fault_errs))
    if out["fault_max_err"] <= TOL_BF16:
        raise AssertionError("decode_verify B2: the planted fault (one key "
                             f"too many) passes the check: {out}")
    return out


def verify_phase(params, mcfg, prompts, dev, gate: bool) -> dict:
    """decode_verify of VERIFY_K tokens on each of the 16 lanes (prompts
    prefilled through the engine), against VERIFY_K sequential decode_steps
    on a copy of the caches, with its B2 calls held against the plain
    version on their own inputs (:func:`held_verify_b2`). With ``gate``:
    logits within atol + rtol TOL_VERIFY where the card meets it, else
    TOL_BF16, argmax equal, and a planted fault (visible lengths one too
    long: token j sees j + 1's key) must fail the same check; without, the
    model's gap is only reported."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    eng = Engine(params, mcfg, CacheConfig(**CACHE),
                 EngineConfig(max_batch=MAX_BATCH))
    for i in range(N_REQUESTS):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=8))
    eng._admit()  # prefill every prompt; the pages cover 8 more tokens
    caches = eng.caches
    seq_caches = [_cache_copy(c) for c in caches]
    fault_caches = [_cache_copy(c) for c in caches]
    del eng
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, mcfg.vocab_size - 1,
                                        (N_REQUESTS, VERIFY_K)), device=dev)
    slots = torch.arange(N_REQUESTS, dtype=torch.int32, device=dev)
    base = caches[0].lengths[:N_REQUESTS].clone()
    paged = tfm.paged_attention
    calls = []

    def recorded(q, cache, slots, **kw):  # B2's inputs and o, a layer each
        o = paged(q, cache, slots, **kw)
        calls.append(dict(q=q.clone(), cache=cache, slots=slots, kw=kw, o=o))
        return o

    tfm.paged_attention = recorded
    kernels.reset_launches()
    try:
        got, _ = tfm.decode_verify(params, toks, base, caches, slots, mcfg)
        torch.cuda.synchronize()
    finally:
        tfm.paged_attention = paged
    launches = {k: kernels.LAUNCHES[k] for k in (
        "paged_append", "paged_attention_split", "paged_append_fused")}
    if (launches["paged_append"] != VERIFY_K * mcfg.num_layers
            or launches["paged_attention_split"] != mcfg.num_layers
            or launches["paged_append_fused"]):
        raise AssertionError(f"decode_verify launches {launches}")
    b2 = held_verify_b2(calls)
    del calls
    want = torch.stack([tfm.decode_step(
        params, toks[:, j], base + j, seq_caches, slots, mcfg)[0]
        for j in range(VERIFY_K)], dim=1)
    lengths_ok = all(torch.equal(a.lengths, b.lengths)
                     for a, b in zip(caches, seq_caches))
    if not lengths_ok or not torch.equal(caches[0].lengths[:N_REQUESTS],
                                         base + VERIFY_K):
        raise AssertionError("decode_verify: lengths not advanced by K")
    def one_too_many(*a, lengths_override=None, **kw):
        return paged(*a, lengths_override=lengths_override + 1, **kw)

    tfm.paged_attention = one_too_many
    try:
        fault, _ = tfm.decode_verify(params, toks, base, fault_caches, slots,
                                     mcfg)
    finally:
        tfm.paged_attention = paged
    gap = (got - want).abs()
    excess = float((gap - TOL_VERIFY * want.abs()).max())
    tight = excess <= TOL_VERIFY

    def within(x):  # atol + rtol·|want| where the card meets it, else TOL_BF16
        d = (x - want).abs()
        if tight:
            return bool((d <= TOL_VERIFY + TOL_VERIFY * want.abs()).all())
        return float(d.max()) <= TOL_BF16

    argmax_agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    out = dict(dtype=mcfg.dtype, lanes=N_REQUESTS, K=VERIFY_K,
               max_abs_gap=float(gap.max()), excess_over_atol_rtol=excess,
               tight=tight, gated=gate,
               tol="atol 1e-4 + rtol 1e-4" if tight else "TOL_BF16 2e-2",
               fault_gap=float((fault - want).abs().max()),
               fault_rejected=not within(fault), argmax_agreement=argmax_agree,
               launches=launches, b2=b2)
    if gate:
        if not within(got):
            raise AssertionError(f"decode_verify vs steps: {out}")
        if within(fault):
            raise AssertionError("decode_verify: the planted fault (one key "
                                 f"too many) passes the check: {out}")
        if argmax_agree != 1.0:
            raise AssertionError(f"decode_verify: argmax differs: {out}")
    del caches, seq_caches, fault_caches
    torch.cuda.empty_cache()
    return out


def serve_multistep_phase(dev, smi: str, engine_decode_ms: float) -> dict:
    """The canonical model with int8 weights from the int8 cache in
    rounds of up to MULTISTEP_K tokens (async), against the one-token
    engine, the synchronous rounds and a teacher-forced forward; then
    decode_verify at full width, and the round's profile."""
    from tpu_flash_torch.bench import paged_profile
    from tpu_flash_torch.models import transformer as tfm

    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.quantize_weights(tfm.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(0), dev))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (N_REQUESTS + 1, PROMPT_LEN)).tolist()
    runs = {}
    for name, steps, asy in (("multi", MULTISTEP_K, True),
                             ("one_token", 1, True),
                             ("sync", MULTISTEP_K, False)):
        runs[name] = multistep_serve(params, mcfg, prompts, dev, steps, asy)
    multi = runs["multi"]
    done = multi["done"]
    for f in done.values():
        if (f.reason != "length" or len(f.new_tokens) != MULTISTEP_NEW_TOKENS
                or not all(np.isfinite(f.logprobs))):
            raise AssertionError(f"serve_multistep: request {f.rid}: "
                                 f"{f.reason}, {len(f.new_tokens)} tokens")
    vs_one = held_streams("multi-step vs one-token", done,
                          runs["one_token"]["done"])
    vs_sync = held_streams("async vs sync rounds", done, runs["sync"]["done"])
    drift = teacher_forced_drift(params, mcfg, done[0])
    check("serve_multistep: teacher-forced logprob drift", drift, TOL_LOGPROB)
    for key in ("flash_fwd", "paged_attention_split", "paged_append_fused"):
        if multi["launches"][key] <= 0:
            raise AssertionError(f"serve_multistep: {key} never launched")
    if multi["replays"] <= 0 or multi["eager_launches"]["paged_attention_split"]:
        raise AssertionError(
            f"serve_multistep: {multi['replays']} replays, "
            f"{multi['eager_launches']['paged_attention_split']} eager decode "
            "launches: every round must be a graph replay")
    rounds_ms = multi["step_ms"][1:]  # step 1 admits and prefills
    round_ms = float(np.median(rounds_ms))
    one_ms = float(np.median(runs["one_token"]["step_ms"][1:]))
    # decode_verify on the served model: its 16 B2 calls held against the
    # plain version on their own inputs (the model's gap to the steps, bf16
    # activations, is reported); the model gated on the float32 copy of
    # the same weights, where rounding leaves the algorithm visible (the
    # CPU tests' reason)
    verify = dict(served=verify_phase(params, mcfg, prompts, dev, gate=False))
    del params
    torch.cuda.empty_cache()
    mcfg32 = tfm.ModelConfig(**MODEL, dtype="float32")
    params32 = tfm.quantize_weights(tfm.init_params(
        mcfg32, torch.Generator(device=dev).manual_seed(0), dev))
    verify["float32"] = verify_phase(params32, mcfg32, prompts, dev, gate=True)
    del params32
    torch.cuda.empty_cache()
    params = tfm.quantize_weights(tfm.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(0), dev))
    lens = [PROMPT_LEN + 24 + int(i) for i in range(N_REQUESTS)]
    step_row, round_row = paged_profile.profile_round(params, mcfg,
                                                      MULTISTEP_K, lens, dev)
    out = dict(
        phase="serve_multistep", nvidia_smi=smi, weights="int8",
        cache=CACHE["dtype"], requests=N_REQUESTS, prompt_len=PROMPT_LEN,
        new_tokens=MULTISTEP_NEW_TOKENS, decode_steps=MULTISTEP_K,
        async_decode=True, steps_vs_one_token_max_logprob_gap=vs_one,
        async_vs_sync_max_logprob_gap=vs_sync, teacher_forced_drift=drift,
        drift_tol=TOL_LOGPROB,
        warm_e2e_tok_s=N_REQUESTS * MULTISTEP_NEW_TOKENS / multi["wall_s"],
        one_token_warm_e2e_tok_s=(N_REQUESTS * MULTISTEP_NEW_TOKENS
                                  / runs["one_token"]["wall_s"]),
        sync_warm_e2e_tok_s=(N_REQUESTS * MULTISTEP_NEW_TOKENS
                             / runs["sync"]["wall_s"]),
        host_ms_per_round=round_ms, host_ms_per_token=round_ms / MULTISTEP_K,
        one_token_host_ms_per_step=one_ms,
        engine_phase_decode_ms_per_step=engine_decode_ms,
        rounds=len(rounds_ms), graph_captures=multi["captures"],
        graph_captures_with_warmup=multi["captures_total"],
        graph_replays=multi["replays"], graphs=multi["graphs"],
        launches=multi["launches"], eager_launches=multi["eager_launches"],
        decode_verify=verify, profile_step=step_row, profile_round=round_row,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(out)
    del params
    torch.cuda.empty_cache()
    return out


# (name, batch, hq, hkv, n_q, n_kv, d, schedule, radius or section, dtype,
# quant): the training shape first, then ragged, right-aligned causal, d 64
# (where the reference's transposed kernels B10a/B10b fold into B4/B5),
# dense float32 and G 4 (B5 walks four q heads of a group through one CTA's
# ring); the sliding training shape (local_causal, radius 512); the local,
# local_causal, circulant and block-diagonal kinds in each family (bf16 64,
# 128 and 256 on the TMA + wgmma kernels, float32 on the FMA one) at a
# ragged n with GQA 16/8; the int8 dp product on dense,
# causal and a band at bf16 128 and 256 and at float32; and the shapes that
# time bf16 d 256 and float32
BF16, F32 = torch.bfloat16, torch.float32
BWD_CASES = [
    ("train_4x1024", 4, 16, 8, 1024, 1024, 128, "causal", 0, BF16, None),
    ("ragged_causal_1000", 1, 16, 8, 1000, 1000, 128, "causal", 0, BF16, None),
    ("right_aligned_256_of_1024", 1, 16, 8, 256, 1024, 128, "causal", 0, BF16,
     None),
    ("d64_causal_1024", 1, 16, 8, 1024, 1024, 64, "causal", 0, BF16, None),
    ("dense_f32_300", 1, 16, 8, 300, 300, 128, "dense", 0, F32, None),
    ("gqa4_causal_1000", 1, 32, 8, 1000, 1000, 128, "causal", 0, BF16, None),
    ("sliding_train_2x2048", 2, 16, 8, 2048, 2048, 128, "local_causal", 512,
     BF16, None),
    *[(f"{kind}_{w}_{str(dt)[6:]}_1000", 1, 16, 8, n, n, w, kind, width, dt, None)
      for w, dt, n in ((64, BF16, 1000), (128, BF16, 1000), (256, BF16, 1000),
                       (128, F32, 500))
      for kind, width in (("local", 100), ("local_causal", 100),
                          ("circulant", 64), ("block", 250 if n == 1000 else 100))],
    *[(f"dp_{kind}_{w}_{str(dt)[6:]}", 1, 16, 8, n, n, w, kind, width, dt, "dp")
      for w, dt, n in ((128, BF16, 1000), (256, BF16, 1000), (128, F32, 500),
                       (256, F32, 500))
      for kind, width in (("dense", 0), ("causal", 0), ("local_causal", 100))],
    ("d256_causal_1024", 1, 16, 8, 1024, 1024, 256, "causal", 0, BF16, None),
    ("f32_causal_1024", 1, 16, 8, 1024, 1024, 128, "causal", 0, F32, None),
    # float32 on the 3×TF32 kernels: d 64, d 256 (the head dim split across
    # a 2-CTA cluster), and GQA 4 at a ragged n
    ("f32_d64_causal_1024", 1, 16, 8, 1024, 1024, 64, "causal", 0, F32, None),
    ("f32_d256_causal_1024", 1, 16, 8, 1024, 1024, 256, "causal", 0, F32,
     None),
    ("f32_gqa4_causal_1000", 1, 32, 8, 1000, 1000, 128, "causal", 0, F32,
     None),
    # width 512 at the wide model's heads (4/2): the wide training shape
    # (b 4, n 1025 causal) in bf16 (flash_bwd_wide.cu) and in float32 (a
    # 4-CTA cluster a tile, flash_bwd_f32_wide.cu), then bf16 d 512, 512
    # with dv 256 (the last entry), 320 and 264 (zero-padded) and float32
    # 512, each under causal and local_causal radius 512 at a ragged n, and
    # dp in bf16 and float32
    ("wide_train_4x1025", 4, 4, 2, 1025, 1025, 512, "causal", 0, BF16, None),
    ("f32_wide_train_4x1025", 4, 4, 2, 1025, 1025, 512, "causal", 0, F32,
     None),
    *[(f"wide_{quant or 'exact'}_{kind}_{d}{f'_dv{dv}' if dv != d else ''}"
       f"_{str(dt)[6:]}", 1, 4,
       2, 1000, 1000, d, kind, width, dt, quant, dv)
      for d, dv, dt, quant in ((512, 512, BF16, None), (512, 256, BF16, None),
                               (320, 320, BF16, None), (264, 264, BF16, None),
                               (512, 512, F32, None), (512, 512, BF16, "dp"),
                               (512, 512, F32, "dp"))
      for kind, width in (("causal", 0), ("local_causal", 512))],
]
# the cases whose B4/B5 are timed, beside the library's fused backward
BWD_TIMED = ("train_4x1024", "d64_causal_1024", "sliding_train_2x2048",
             "d256_causal_1024", "f32_causal_1024", "f32_d64_causal_1024",
             "f32_d256_causal_1024", "wide_exact_causal_512_float32",
             "wide_train_4x1025", "f32_wide_train_4x1025")
# B4/B5's planted faults: the plain backward under the case's schedule minus
# one middle slab of 64 keys (dq, dk and dv must move) or of 64 queries (dk
# and dv must move) must fail the kernel-vs-plain check, at the training
# shape and at the sliding training shape
BWD_FAULT_SLAB = 64
BWD_FAULT_CASES = ("train_4x1024", "sliding_train_2x2048", "wide_train_4x1025")
# the rows whose device kernels are named: bf16 at widths 256 and 512 must
# run flash_bwd_tc.cuh's TMA + wgmma kernels, float32 flash_bwd_f32.cuh's
# 3×TF32 ones (<columns a CTA, dp, CTAs a cluster>: the whole width at 64
# and 128, a 128-column slice a CTA of a 2- or 4-CTA cluster at 256 and
# 512), never the block kernels that once held the bf16 WMMA route and
# float32 (the first port's FMA kernels, deleted)
BWD_NAMED = {"d256_causal_1024": ("flash_bwd_dq_wide<256", "flash_bwd_dkv_wide<256"),
             "wide_train_4x1025": ("flash_bwd_dq_wide<512", "flash_bwd_dkv_wide<512"),
             "f32_causal_1024": ("flash_bwd_dq_f32<128, false, 1>",
                                 "flash_bwd_dkv_f32<128, false, 1>"),
             "f32_d64_causal_1024": ("flash_bwd_dq_f32<64, false, 1>",
                                     "flash_bwd_dkv_f32<64, false, 1>"),
             "f32_d256_causal_1024": ("flash_bwd_dq_f32<128, false, 2>",
                                      "flash_bwd_dkv_f32<128, false, 2>"),
             "f32_wide_train_4x1025": ("flash_bwd_dq_f32<128, false, 4>",
                                       "flash_bwd_dkv_f32<128, false, 4>")}
# the float32 kernels' names (3×TF32) at width 128 and at width 512, and
# the deleted FMA kernels' that they replace
F32_KERNELS = BWD_NAMED["f32_causal_1024"]
F32_WIDE_KERNELS = BWD_NAMED["f32_wide_train_4x1025"]
BLOCK_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def bwd_kernel_names(name: str, call) -> list:
    """The device kernels of one B4/B5 call of BWD_NAMED's row ``name``
    (profiler), printed; raises unless both of the row's kernels ran and no
    block kernel (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) or WMMA one
    did."""
    names = sorted(fresh_trace("port", name, trace(call)))
    print(f"B4/B5 {name} device kernels: {names}", flush=True)
    missing = [k for k in BWD_NAMED[name] if not any(k in n for n in names)]
    block = [n for n in names if any(b in n for b in BLOCK_KERNELS)
             or "wmma" in n.lower()]
    if missing or block:
        raise AssertionError(f"B4/B5 {name}: the call ran {names}; "
                             f"missing {missing}, block or WMMA kernels {block}")
    return names


def slab_fault(sched, axis: str, start: int, size: int = BWD_FAULT_SLAB):
    """``sched`` with the keys (axis "kv") or queries ("q") in [start,
    start + size) seeing nothing: a planted fault for the plain backward."""
    base = sched.visible

    class SlabFault:
        def visible(self, q_pos, k_pos):
            pos = k_pos if axis == "kv" else q_pos
            m = (pos < start) | (pos >= start + size)
            seen = base(q_pos, k_pos)
            return m if seen is None else seen & m

    return SlabFault()


def library_backward(q, k, v, do, causal, window_left=None):
    """The library's fused attention backward alone on (B, H, N, D), K/V
    already expanded to q's heads (so it skips the group sum): a closure
    over one forward's outputs, the name of the call it times, and whether
    the call can be captured in a CUDA graph (an autograd call cannot).
    ``window_left`` bands the causal triangle (keys i − window_left .. i):
    ``aten._flash_attention_backward`` with ``window_size_left``/``_right``
    where this torch takes them. Where an op is missing or refuses the
    inputs (float32), autograd of one saved scaled_dot_product_attention
    graph (under a boolean band mask for the band) instead."""
    n = q.shape[2]
    if window_left is not None:
        op = getattr(torch.ops.aten, "_flash_attention_backward", None)
        try:
            if op is None or "window_size_left" not in str(op.default._schema):
                raise NotImplementedError("no window_size_left")
            qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                               for x in (q, k, v, do))
            out, lse, rng, unused = torch.ops.aten._flash_attention_forward(
                qt, kt, vt, None, None, n, n, 0.0, True, False,
                window_size_left=window_left, window_size_right=0)[:4]
            fn = functools.partial(
                op, dot, qt, kt, vt, out, lse, None, None, n, n, 0.0, True,
                rng, unused, window_size_left=window_left, window_size_right=0)
            fn()
            return (lambda: [g.transpose(1, 2) for g in fn()],
                    f"aten._flash_attention_backward(window_size_left="
                    f"{window_left}, window_size_right=0)", True)
        except (NotImplementedError, RuntimeError, TypeError) as err:
            i = torch.arange(n, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                 <= window_left)
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = sdpa(*xs, False, mask)
            return (lambda: torch.autograd.grad(o, xs, do, retain_graph=True),
                    "torch.autograd.grad of one saved scaled_dot_product_"
                    f"attention under a boolean band mask ({str(err)[:80]})",
                    False)
    try:
        out, lse, cq, ck, mq, mk, seed, off = (
            torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, causal, False)[:8])
        fn = functools.partial(
            torch.ops.aten._scaled_dot_product_flash_attention_backward,
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal, seed, off)
        fn()
        return fn, "aten._scaled_dot_product_flash_attention_backward", True
    except (AttributeError, RuntimeError):  # missing, or refuses float32
        pass
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = sdpa(*xs, causal)
    return (lambda: torch.autograd.grad(o, xs, do, retain_graph=True),
            "torch.autograd.grad of one saved scaled_dot_product_attention",
            False)


def fastest_sdpa(q, k, v, do, hq: int, hkv: int) -> dict:
    """The fastest float32 backward of scaled_dot_product_attention (causal)
    on ``(B·H, n, d)`` operands, K/V expanded to the q heads outside the
    timed call: for each backend that takes the shape, autograd of one
    saved forward, the sum of its kernels' device times a call over 10
    (profiler) → {ms, backend, kernels (the three longest), tried}. With
    ``do`` None, the forward alone (B1's library call): the yardstick
    beside ``tpu_flash_torch/bench/bwd_bench.py``'s float32 rows, which
    the port's package may not name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    g = hq // hkv
    xs = [x.detach().unsqueeze(0).requires_grad_(True)
          for x in (q, k.repeat_interleave(g, 0), v.repeat_interleave(g, 0))]
    dout = None if do is None else do.unsqueeze(0)
    best, tried = None, {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                o = torch.nn.functional.scaled_dot_product_attention(
                    *xs, is_causal=True)

            def call(o=o, backend=backend):
                if do is None:
                    with sdpa_kernel([backend]), torch.no_grad():
                        return torch.nn.functional.scaled_dot_product_attention(
                            *xs, is_causal=True)
                return torch.autograd.grad(o, xs, dout, retain_graph=True)

            call()
            torch.cuda.synchronize()
        except RuntimeError as err:
            tried[backend.name] = str(err)[:60]
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kern = {e.key: e.self_device_time_total / 1e3 / 10
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        ms = sum(kern.values())
        tried[backend.name] = ms
        if ms > 0 and (best is None or ms < best["ms"]):
            best = dict(ms=ms, backend=backend.name, kernels={
                k_[:100]: v_ for k_, v_ in sorted(
                    kern.items(), key=lambda kv: -kv[1])[:3]})
        del o
    return dict(best or {}, tried=tried)


# bench/bwd_bench.py's float32 rows: (name, B·HQ, B·HKV, n, d, backward)
SDPA_F32_ROWS = [("f32_causal_1024", 16, 8, 1024, 128, True),
                 ("f32_d64_causal_1024", 16, 8, 1024, 64, True),
                 ("f32_d256_causal_1024", 16, 8, 1024, 256, True),
                 ("f32_d512_causal_1000", 4, 2, 1000, 512, True),
                 ("f32_wide_train_4x1025", 16, 8, 1025, 512, True),
                 ("b1_f32_causal_1024", 16, 8, 1024, 128, False),
                 ("b1_f32_d512_causal_1000", 4, 2, 1000, 512, False)]


def sdpa_f32_rows() -> dict:
    """The library's fastest float32 causal attention (backward, or
    forward for B1's rows) at each SDPA_F32_ROWS shape
    (:func:`fastest_sdpa`), printed as one JSON line with the card's name
    and power limit. Alone: ``PYTHONPATH=$PWD python -c "import
    chip_smoke as cs; cs.sdpa_f32_rows()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = dict(device=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    for name, bhq, bhkv, n, d, backward in SDPA_F32_ROWS:
        q, k, v = (torch.randn(h, n, d, generator=gen, device="cuda")
                   for h in (bhq, bhkv, bhkv))
        do = torch.randn(bhq, n, d, generator=gen, device="cuda")
        row[name] = fastest_sdpa(q, k, v, do if backward else None, bhq, bhkv)
    print(json.dumps(row), flush=True)
    return row


def rel_to_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b|: :func:`rel_err` without its floor of 1, for
    grads far below 1 (a model's), where that floor would make it an
    absolute error."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def upper_half_faults(name: str, got, plain, tol: float, err=rel_err) -> dict:
    """Each grad of ``got`` against the plain backward's with its columns
    256–511 zeroed, where it has them, by ``err``: a kernel that dropped
    the upper half of its output would pass that check, so each must fail
    it."""
    errs = {}
    for x, a_, p_ in zip("qkv", got, plain):
        if p_.shape[-1] <= WIDE_UPPER.start:
            continue
        hidden = p_.clone()
        hidden[..., WIDE_UPPER] = 0
        errs[f"d{x}"] = err(a_, hidden)
        if errs[f"d{x}"] <= tol:
            raise AssertionError(f"{name}: d{x} with columns 256-511 zeroed "
                                 f"passes the kernel-vs-plain check: {errs}")
    return errs


def library_backward_wide(q, k, v, do, causal, window_left=None):
    """As :func:`library_backward` above width 256, where the flash
    backend stops: autograd of one saved scaled_dot_product_attention
    under each backend that takes the head dim (the band under a boolean
    mask), the fastest of them, named with the times of all that ran."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n = q.shape[2]
    mask = None
    if window_left is not None:
        i = torch.arange(n, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                             <= window_left)
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    tried, best = {}, None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                o = sdpa(*xs, causal, mask)

            def fn(o=o):
                return torch.autograd.grad(o, xs, do, retain_graph=True)

            tried[backend.name] = cuda_ms(fn, iters=5)
        except RuntimeError as err:
            tried[backend.name] = str(err)[:60]
            continue
        if best is None or tried[backend.name] < tried[best[1]]:
            best = (fn, backend.name)
    return (best[0], f"torch.autograd.grad of one saved scaled_dot_product_"
            f"attention, backend {best[1]} (fastest of {tried})", False)


def trace(fn, iters: int = 1, tries: int = 5) -> dict:
    """{device kernel: [launches, device ms] a call} over ``iters`` calls of
    ``fn`` under torch.profiler, after one call outside it. A trace that
    recorded no device activity at all is taken again, up to ``tries``
    times: the card's traces have come back empty in a long run. {} if
    every one did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {e.key: [e.count / iters, e.self_device_time_total / 1e3 / iters]
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if got:
            return got
    return {}


def device_kernel_names(fn) -> list:
    """Names of the device kernels one ``fn`` call launches (profiler)."""
    return sorted(trace(fn))


def fresh_process(argv: list, what: str) -> dict:
    """The JSON object that ``python argv`` prints as its last line, run
    from the checkout's root in a process of its own, merged over up to
    three runs until no key's value is empty: late in a long run this
    process's traces have come back empty where a fresh one's did not, and
    now and then a fresh one's too. The one route by which the smoke takes
    a trace again in a new process (:func:`fresh_trace`,
    :func:`quant_kernel_names`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    got: dict = {}
    for _ in range(3):
        out = subprocess.run(
            [sys.executable, *argv], cwd=root, capture_output=True, text=True,
            timeout=900, env=dict(os.environ, PYTHONPATH=root))
        if out.returncode != 0:
            raise AssertionError(f"{what} in a process of its own failed: "
                                 f"{out.stderr[-3000:]}")
        new = json.loads(out.stdout.strip().splitlines()[-1])
        got.update({k: v for k, v in new.items() if v or not got.get(k)})
        if got and all(got.values()):
            break
    print(f"{what}: traced in a process of its own", flush=True)
    return got


def fresh_trace(kind: str, case: str, local: dict) -> dict:
    """``local``, a trace taken in this process, or where it came back
    empty the same trace taken by :func:`child_trace` in a fresh process
    (:func:`fresh_process`)."""
    if local:
        return local
    return fresh_process(
        ["-c", f"import chip_smoke as cs; cs.child_trace({kind!r}, {case!r})"],
        f"trace of {kind} {case}")


def child_trace(kind: str, case: str) -> None:
    """Print, as the last line, a :func:`trace` taken in this (fresh)
    process: of one call of BWD_CASES row ``case``'s B4/B5 ("port") or of
    10 of its library backward ("library"), on inputs drawn anew (which
    kernels run, and their times, depend on shapes and dtypes alone); or
    of the float32 model's TRAIN_STEPS train steps at lr 0 ("train_f32",
    and the wide model's, "train_wide_f32")."""
    from tpu_flash_torch import graft_entry
    from tpu_flash_torch.ops import flash_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if kind in ("train_f32", "train_wide_f32"):
        model = MODEL_WIDE if kind == "train_wide_f32" else MODEL
        params, tokens, mcfg = train_inputs(dict(model, dtype="float32"),
                                            TRAIN_TOKENS, dev)
        got = trace(lambda: [graft_entry.train_step(params, tokens, mcfg, 0.0)
                             for _ in range(TRAIN_STEPS)])
    else:
        gen = torch.Generator(device=dev).manual_seed(4)

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        (_, b, hq, hkv, n_q, n_kv, d, schedule, width, dt, quant,
         *dv) = next(c for c in BWD_CASES if c[0] == case)
        dv = dv[0] if dv else d
        q, k, v = (rand(b, h, n, dd).to(dt) for h, n, dd in
                   ((hq, n_q, d), (hkv, n_kv, d), (hkv, n_kv, dv)))
        _, args = bwd_operands(q, k, v, hq, hkv, schedule, width, rand)
        if kind == "port":
            got = trace(lambda: flash_bwd._flash_bwd_kernel(*args, quant))
        else:
            got = trace(library_call(q, k, v, args[5], hq, hkv, schedule,
                                     width)[0], iters=10)
    print(json.dumps(got), flush=True)


def bwd_operands(q, k, v, hq: int, hkv: int, schedule: str, width: int,
                 rand) -> tuple:
    """A BWD_CASES row's kernel operands from its (B, H, N, D) q, k, v →
    (sched, (q, k, v, o, lse, dO, dlse, sched, hq, hkv)) as flash_backward
    takes them: q prescaled, (B·H, N, D), circulant K/V halo-extended, o
    and lse from B1, dO and dlse drawn by ``rand``."""
    from tpu_flash_torch.ops import flash

    (b, _, n_q, d), (_, _, n_kv, dv), dt = q.shape, v.shape, q.dtype
    qf = (q.float() * (d ** -0.5 * flash.LOG2E)).to(dt).reshape(
        b * hq, n_q, d)
    kf, vf = k.reshape(b * hkv, n_kv, d), v.reshape(b * hkv, n_kv, dv)
    sched = flash.build_schedule(schedule, n_q, n_kv, 256, 256,
                                 radius=0 if schedule == "block" else width,
                                 section=width if schedule == "block" else 0)
    if schedule == "circulant":
        kf, vf = (torch.cat([x[:, -width:], x, x[:, :width]], 1)
                  for x in (kf, vf))
    o, lse = flash._flash_fwd_kernel(qf, kf, vf, sched, hq, hkv, True)
    do = rand(b * hq, n_q, dv).to(dt)
    return sched, (qf, kf, vf, o, lse, do, rand(b * hq, n_q), sched, hq, hkv)


def library_call(q, k, v, do, hq: int, hkv: int, schedule: str, width: int):
    """The library's backward of a BWD_CASES row on its (B, H, N, D) q, k,
    v and (B·H, N, dv) dO, K/V expanded to the q heads outside the timed
    call (it then skips the group sum); above width 256, and in float32
    (which the flash backend refuses), the fastest backend that takes the
    shape → (fn, call name, graphable)."""
    g = hq // hkv
    wide = q.shape[-1] > 256 or q.dtype == torch.float32
    return (library_backward_wide if wide else library_backward)(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        do.reshape(*q.shape[:3], do.shape[-1]), schedule != "dense",
        window_left=width if schedule == "local_causal" else None)


@contextlib.contextmanager
def plain_backward(flash_bwd):
    """flash_backward's CUDA tensors take the plain version (float32
    products on the card) inside the block."""
    kernel = flash_bwd._flash_bwd_kernel
    flash_bwd._flash_bwd_kernel = flash_bwd._flash_bwd_plain
    try:
        yield
    finally:
        flash_bwd._flash_bwd_kernel = kernel


@contextlib.contextmanager
def sv_channel_off(flash_bwd):
    """dp's operands with σv of channel 0 doubled on the dO side (v̂ kept):
    dP takes channel 0's products twice. A planted fault."""
    good = flash_bwd.dp_operands

    def faulted(q, v, do, delta, hq, hkv):
        off = torch.ones(v.shape[-1], device=v.device)
        off[0] = 2.0
        v8 = good(q, v, do, delta, hq, hkv)[0]
        return (v8, *good(q, v * off, do, delta, hq, hkv)[1:])

    flash_bwd.dp_operands = faulted
    try:
        yield
    finally:
        flash_bwd.dp_operands = good


def band_call(schedule: str, width: int, quant):
    """The public call of a schedule on (B, H, N, D) → (o, lse), and the
    f32 oracle's call on K/V expanded to q's heads."""
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.ops.oracle import blockwise_dpa, dense_dpa

    kw = dict(return_lse=True, bwd_quant=quant)
    if schedule in ("dense", "causal"):
        causal = schedule == "causal"
        return (lambda q, k, v: flash.dense_fa(q, k, v, causal=causal, **kw),
                lambda q, k, v: dense_dpa(q, k, v, causal=causal))
    if schedule in ("local", "local_causal"):
        causal = schedule == "local_causal"
        return (lambda q, k, v: flash.sliding_fa(q, k, v, 2 * width + 1,
                                                 causal=causal, **kw),
                lambda q, k, v: blockwise_dpa(q, k, v, window_size=2 * width + 1,
                                              causal=causal))
    if schedule == "circulant":
        return (lambda q, k, v: flash.circulant_fa(q, k, v, 2 * width + 1, **kw),
                lambda q, k, v: blockwise_dpa(q, k, v, window_size=2 * width + 1,
                                              wrap=True))
    return (lambda q, k, v: flash.block_fa(q, k, v, width, **kw),
            lambda q, k, v: blockwise_dpa(q, k, v, block_size=width))


def bwd_pairs(schedule: str, n_q: int, n_kv: int, width: int) -> int:
    """(query, key) pairs a head attends under the schedule (this run's
    data: ragged edges, the band's ends, a partial last section)."""
    if schedule in ("dense", "causal"):
        return visible_pairs(n_q, n_kv, schedule == "causal")
    if schedule in ("local", "local_causal"):
        return band_pairs(n_q, width, schedule == "local_causal")
    if schedule == "circulant":
        return n_q * (2 * width + 1)
    return sum(min(width, n_kv - s) ** 2 for s in range(0, n_kv, width))


def bwd_timing(ops, sched, hq, hkv, dt, pairs, d, b, n_q, n_kv, quant,
               reads=None):
    """B4's and B5's device and call times and bounds on prepared operands.
    Operations: B4 three products, B5 four, 2·d each a visible pair (under
    dp the dP product at the int8 rate); bytes: q, k, v, dO (dÔ, v̂ and qs
    under dp) and the row vectors read once, the grads written once.
    ``reads``: (query rows, keys) whose operands the schedule needs, where
    fewer than n_q and n_kv (a ring hop that few rows reach)."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash_bwd

    def run_dq():
        return flash_bwd._dq_kernel(*ops, sched, hq, hkv)

    def run_dkv():
        return flash_bwd._dkv_kernel(*ops, sched, hq, hkv)

    e = 2 if dt == torch.bfloat16 else 4
    n_q_in, n_kv_in = (n_q, n_kv) if reads is None else reads
    # read (the rows and keys the schedule reaches) and written (all)
    q_in, kv_in = e * b * hq * n_q_in * d, e * b * hkv * n_kv_in * d
    q_out, kv_out = e * b * hq * n_q * d, e * b * hkv * n_kv * d
    rows = 4 * b * hq * n_q_in
    prod = 2 * d * pairs
    # float32: each product three tf32 ones (3×TF32)
    ft = "tf32" if dt == torch.float32 else dt
    nt = 3 if ft == "tf32" else 1
    if quant is None:
        dq_ops, dkv_ops = {ft: 3 * nt * prod}, {ft: 4 * nt * prod}
        dq_bytes = 2 * q_in + 2 * kv_in + 2 * rows + q_out
        dkv_bytes = 2 * q_in + 2 * kv_in + 2 * rows + 2 * kv_out
    else:
        dq_ops, dkv_ops = ({ft: 2 * nt * prod, torch.int8: prod},
                           {ft: 3 * nt * prod, torch.int8: prod})
        q8, kv8 = q_in // e, kv_in // e
        dq_bytes = q_in + q8 + kv_in + kv8 + 3 * rows + q_out
        dkv_bytes = 3 * q_in + q8 + kv_in + kv8 + 2 * rows + 2 * kv_out
    dq = dict(ms=device_ms(run_dq), call_ms=cuda_ms(run_dq),
              **roofline(dq_ops, dq_bytes, dt))
    dkv = dict(ms=device_ms(run_dkv), call_ms=cuda_ms(run_dkv),
               **roofline(dkv_ops, dkv_bytes, dt))
    dq["tflops"] = 3 * prod / dq["ms"] / 1e9
    dkv["tflops"] = 4 * prod / dkv["ms"] / 1e9
    if ft == "tf32":  # beside it, the bound at the float32 FMA peak
        dq["fma_bound_ms"] = roofline(3 * prod, dq_bytes, dt)["bound_ms"]
        dkv["fma_bound_ms"] = roofline(4 * prod, dkv_bytes, dt)["bound_ms"]
    return dq, dkv


def flash_bwd_phase(dev):
    """B4/B5 vs the plain backward (under the same quant), the Function's
    grads vs the f32 oracle's, bitwise repeatability, on every schedule
    kind of the forward, each family and the int8 dp product; two planted
    faults in the plain backward rejected at the training shape and at the
    sliding training shape. Timed at the training shape (and under dp
    there), at d 64, at the sliding training shape, at bf16 d 256 and in
    float32: B4's and B5's device time (a CUDA graph of 20 wrapper calls)
    and call time, beside the library's fused backward alone timed the
    same two ways (under the band for the sliding shape)."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash, flash_bwd

    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    rows, worst, worst_f32, timing = [], 0.0, 0.0, {}
    for (name, b, hq, hkv, n_q, n_kv, d, schedule, width, dt,
         quant, *dv) in BWD_CASES:
        g = hq // hkv
        dv = dv[0] if dv else d
        q, k, v = (rand(b, h, n, dd).to(dt) for h, n, dd in
                   ((hq, n_q, d), (hkv, n_kv, d), (hkv, n_kv, dv)))
        w, wl = rand(b, hq, n_q, dv), rand(b, hq, n_q)

        def grads(attn):
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o, lse = attn(*xs)
            ((o.float() * w).sum() + 0.3 * (lse * wl).sum()).backward()
            return [x.grad for x in xs]

        port_fn, oracle_fn = band_call(schedule, width, quant)
        got = grads(port_fn)
        want = grads(lambda q_, k_, v_: oracle_fn(
            q_, k_.repeat_interleave(g, 1), v_.repeat_interleave(g, 1)))
        row = dict(case=name, batch=b, hq=hq, hkv=hkv, n_q=n_q, n_kv=n_kv,
                   d=d, dv=dv, schedule=schedule, width=width, quant=quant,
                   dtype=str(dt).replace("torch.", ""))
        for x, a_, b_ in zip("qkv", got, want):
            if dt == torch.bfloat16 or quant == "dp":
                row[f"d{x}_vs_oracle"] = rel_err(a_, b_)
                check(f"grad {name} d{x} vs oracle", row[f"d{x}_vs_oracle"],
                      TOL_BWD_DP_ORACLE if quant == "dp" else TOL_BWD_ORACLE)
            else:  # atol 3e-4 + rtol 1e-3
                row[f"d{x}_vs_oracle"] = float(
                    ((a_ - b_).abs() - 1e-3 * b_.abs()).max())
                check(f"grad {name} d{x} vs oracle", row[f"d{x}_vs_oracle"],
                      3e-4)
        if quant == "dp":
            # the algorithm's own miss: the plain dp backward (float32, no
            # kernel) through the same public call, and with σv of one
            # channel off, which must fail the gate on dq and dk
            with plain_backward(flash_bwd):
                plain = grads(port_fn)
                row.update({f"d{x}_plain_dp_vs_oracle": rel_err(a_, b_)
                            for x, a_, b_ in zip("qkv", plain, want)})
                if schedule == "local_causal" and d == 128:
                    with sv_channel_off(flash_bwd):
                        bad = grads(port_fn)
                    errs = {f"d{x}": rel_err(a_, b_)
                            for x, a_, b_ in zip("qkv", bad, want)}
                    if min(errs["dq"], errs["dk"]) <= TOL_BWD_DP_ORACLE:
                        raise AssertionError(
                            f"dp planted fault sv_channel_off passes the "
                            f"oracle gate on {name}: {errs}")
                    row["planted_fault_sv_channel_off"] = errs
        del got, want

        sched, args = bwd_operands(q, k, v, hq, hkv, schedule, width, rand)
        tol = TOL_BWD_PLAIN[dt]

        def held(quant_, tag=""):
            nonlocal worst, worst_f32
            first = flash_bwd._flash_bwd_kernel(*args, quant_)
            second = flash_bwd._flash_bwd_kernel(*args, quant_)
            plain = flash_bwd._flash_bwd_plain(*args, quant_)
            for x, a_, a2, p_ in zip("qkv", first, second, plain):
                if not torch.equal(a_, a2):
                    raise AssertionError(f"B4/B5 {name}{tag}: d{x} not bitwise "
                                         "equal between two calls")
                row[f"d{x}_vs_plain{tag}"] = rel_err(a_, p_)
                check(f"B4/B5 {name}{tag} d{x} vs plain",
                      row[f"d{x}_vs_plain{tag}"], tol)
                worst = max(worst, max_err(a_, p_))
            if d > 256:  # each grad's upper half hidden must fail the check
                row[f"planted_fault_upper_half{tag}"] = upper_half_faults(
                    f"B4/B5 {name}{tag}", first, plain, tol)
            if dt == torch.float32:
                # the 3×TF32 kernels: beside the exact plain backward, the
                # plain one through the model of their product
                # (flash_bwd.tf32x3), reported; and the same kernels on one
                # TF32 pass, a planted fault, must fail the check on each
                # grad
                model = flash_bwd._flash_bwd_plain(
                    *args, quant_, products=flash_bwd.tf32x3)
                row.update({f"d{x}_vs_tf32x3_model{tag}": rel_err(a_, m_)
                            for x, a_, m_ in zip("qkv", first, model)})
                del model
                one = flash_bwd._flash_bwd_kernel(*args, quant_,
                                                  tf32_passes=1)
                errs = {f"d{x}": rel_err(a_, p_)
                        for x, a_, p_ in zip("qkv", one, plain)}
                passed = [x for x, e in errs.items() if e <= tol]
                if passed:
                    raise AssertionError(
                        f"B4/B5 planted fault one_tf32_pass on {name}{tag} "
                        f"passes the kernel-vs-plain check on {passed}: {errs}")
                row[f"planted_fault_one_tf32_pass{tag}"] = errs
                worst_f32 = max(worst_f32, *(max_err(a_, p_)
                                             for a_, p_ in zip(first, plain)))
            return first

        first = held(quant)
        row.update(bitwise_repeat=True, tol_plain=tol)
        if name in BWD_NAMED:
            row["device_kernels"] = [k_[:100] for k_ in bwd_kernel_names(
                name, lambda: flash_bwd._flash_bwd_kernel(*args, quant))]

        if name in BWD_FAULT_CASES:  # the planted faults
            for fault, axis, must in (("kv_slab_left_out", "kv", "qkv"),
                                      ("q_slab_left_out", "q", "kv")):
                start = (n_kv if axis == "kv" else n_q) // 2
                faulted = flash_bwd._flash_bwd_plain(
                    *args[:7], slab_fault(sched, axis, start), hq, hkv)
                errs = {f"d{x}": rel_err(a_, f_)
                        for x, a_, f_ in zip("qkv", first, faulted)}
                passed = [x for x in must if errs[f"d{x}"] <= tol]
                if passed:
                    raise AssertionError(
                        f"B4/B5 planted fault {fault} on {name} passes the "
                        f"kernel-vs-plain check on {passed}: {errs}")
                row[f"planted_fault_{fault}"] = errs
                del faulted
        if name in BWD_TIMED:
            pairs = bwd_pairs(schedule, n_q, n_kv, width) * b * hq
            ops = flash_bwd._kernel_operands(*args)
            dq, dkv = bwd_timing(ops, sched, hq, hkv, dt, pairs, d, b, n_q,
                                 n_kv, None)
            lib_bwd, lib_call, graphable = library_call(
                q, k, v, args[5], hq, hkv, schedule, width)
            # its kernels (and their device times) over 10 calls
            lib_trace = fresh_trace("library", name, trace(lib_bwd, iters=10))
            names = sorted(lib_trace)
            if lib_call.startswith("aten.") and not any(
                    "flash" in k_.lower() and "bwd" in k_.lower()
                    for k_ in names):
                raise AssertionError(f"the library's backward ran no fused "
                                     f"flash backward kernel: {names}")
            plain_ms = cuda_ms(lambda: flash_bwd._flash_bwd_plain(*args),
                               iters=3)
            if graphable:  # device time from a CUDA graph of calls
                lib_ms = device_ms(lib_bwd)
            elif dt == torch.float32:
                # the sum of the call's kernels' device times (profiler):
                # the float32 backward is an autograd call; its kernels
                # beside it
                if not lib_trace:
                    raise AssertionError(f"{name}: no trace of the library's "
                                         "backward")
                lib_ms = sum(ms for _, ms in lib_trace.values())
                row["library_bwd_kernel_ms"] = {
                    k_[:120]: ms for k_, (_, ms) in sorted(
                        lib_trace.items(), key=lambda kv: -kv[1][1])[:6]}
            else:  # events around calls
                lib_ms = cuda_ms(lib_bwd)
            row.update(dq_ms=dq["ms"], dq_call_ms=dq["call_ms"],
                       dq_bound_ms=dq["bound_ms"], dkv_ms=dkv["ms"],
                       dkv_call_ms=dkv["call_ms"], dkv_bound_ms=dkv["bound_ms"],
                       visible_pairs=pairs, library_bwd_ms=lib_ms,
                       library_bwd_call_ms=cuda_ms(lib_bwd),
                       library_bwd_call=lib_call,
                       library_bwd_kernels=[k_[:100] for k_ in names],
                       dq_tflops=dq["tflops"], dkv_tflops=dkv["tflops"],
                       plain_bwd_ms=plain_ms)
            if "fma_bound_ms" in dq:
                row.update(dq_fma_bound_ms=dq["fma_bound_ms"],
                           dkv_fma_bound_ms=dkv["fma_bound_ms"])
            timing[name] = dict(dq=dict(dq, plain_ms=plain_ms),
                                dkv=dict(dkv, plain_ms=plain_ms),
                                library_ms=row["library_bwd_ms"],
                                library_call=lib_call)
        if name == "train_4x1024":
            # the int8 dp product at the training shape, beside the run
            # without it: held against the plain version, then timed
            held("dp", "_dp")
            ops = flash_bwd._kernel_operands(*args, quant="dp")
            dq, dkv = bwd_timing(ops, sched, hq, hkv, dt, pairs, d, b, n_q,
                                 n_kv, "dp")
            row.update(dq_dp_ms=dq["ms"], dq_dp_call_ms=dq["call_ms"],
                       dq_dp_bound_ms=dq["bound_ms"], dkv_dp_ms=dkv["ms"],
                       dkv_dp_call_ms=dkv["call_ms"],
                       dkv_dp_bound_ms=dkv["bound_ms"])
            timing["train_4x1024_dp"] = dict(dq=dq, dkv=dkv)
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            do4 = rand(b, hq, n_q, d).to(dt)
            fwdbwd_ms = cuda_ms(lambda: flash.dense_fa(
                *xs, causal=True).backward(do4))
            library_ms = cuda_ms(lambda: sdpa(*xs, True).backward(do4))
            # FA-2's least work: 2 products forward, 5 backward
            qb, kvb = 2 * b * hq * n_q * d, 2 * b * hkv * n_kv * d
            fb_bound = roofline(14 * d * pairs, 2 * (3 * qb + 4 * kvb)
                                + 4 * b * hq * n_q, dt)
            row.update(port_fwd_bwd_ms=fwdbwd_ms, library_fwd_bwd_ms=library_ms,
                       fwd_bwd_bound_ms=fb_bound["bound_ms"])
        rows.append(row)
        del q, k, v, args, first
    emit(dict(phase="flash_bwd", cases=rows))
    return dict(max_abs_err=worst, max_abs_err_f32=worst_f32, **timing)


def checkpointed(attn):
    """``attn`` on (B, H, N, D) → o, recomputed in the backward: the float64
    oracles' score tensors are not kept across a full-depth model."""
    return lambda q, k, v: torch.utils.checkpoint.checkpoint(
        lambda a, b, c: attn(a, b, c)[0], q, k, v, use_reentrant=False)


def grad_cosines(params, grads_a, grads_b) -> dict:
    """Cosine of each parameter's two gradients (float64)."""
    from tpu_flash_torch import graft_entry

    cos = {}
    for (name, _), a, b in zip(graft_entry.named_leaves(params), grads_a,
                               grads_b):
        a, b = a.double().flatten(), b.double().flatten()
        cos[name] = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
    return cos


def train_phase(dev, phase="train", model=MODEL, tokens_shape=TRAIN_TOKENS,
                oracle=None, other=None, named=()):
    """Three SGD steps at the canonical model's full width and depth (with
    ``model``'s attention), then one step's gradient against the
    oracle-attention path's (``oracle``: dense_dpa, causal). ``other``
    (name, attention) is an oracle of another attention that must miss the
    flash gradients by more than ``oracle`` does: it shows that the check
    sees the difference. ``named``: device-kernel names whose launches over
    the three steps' work (the steps again at lr 0 under the profiler) must
    each equal B4's launch count, with no block kernel of
    flash_bwd.cuh among them."""
    from tpu_flash_torch import graft_entry, kernels
    from tpu_flash_torch.ops.oracle import dense_dpa

    if oracle is None:
        oracle = lambda q, k, v: dense_dpa(q, k, v, causal=True)  # noqa: E731
    params, tokens, mcfg = train_inputs(model, tokens_shape, dev)
    leaves = graft_entry.param_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    wq0 = params["layers"][0]["wq"].clone()
    embed0 = params["embed"].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, loss = graft_entry.train_step(params, tokens, mcfg, TRAIN_LR)
        losses.append(float(loss))  # a host fetch: the step's work is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            changed = dict(
                wq=float((params["layers"][0]["wq"] != wq0).float().mean()),
                embed=float((params["embed"] != embed0).float().mean()))
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dwq = float((params["layers"][0]["wq"].float() - wq0.float()).abs().max())
    del embed0
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    check(f"{phase} first loss vs ln(vocab)",
          abs(losses[0] - math.log(mcfg.vocab_size)), 1.0)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall: {losses}")
    if not dwq > 0:
        raise AssertionError(f"{phase}: train step produced no parameter update")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {phase} "
                                 "run")

    loss_k, grads_k = graft_entry.loss_and_grads(params, tokens, mcfg)
    loss_o, grads_o = graft_entry.loss_and_grads(
        params, tokens, mcfg, attn_fn=checkpointed(oracle))
    cos = grad_cosines(params, grads_k, grads_o)
    del grads_o
    worst_cos = min(cos, key=cos.get)
    dloss = abs(float(loss_k) - float(loss_o))
    check(f"{phase} loss vs oracle-attention loss", dloss, TOL_DLOSS)
    if not cos[worst_cos] >= TOL_COSINE:
        raise AssertionError(f"{phase} grad cosine {worst_cos}: "
                             f"{cos[worst_cos]}")
    median_ms = float(np.median(step_ms[1:]))
    n_tok = tokens_shape[0] * (tokens_shape[1] - 1)
    row = dict(
        phase=phase, attention=mcfg.attention,
        window=mcfg.window if mcfg.attention == "sliding" else None,
        tokens=list(tokens_shape), steps=TRAIN_STEPS,
        lr=TRAIN_LR, params=n_params, losses=losses, ln_vocab=math.log(
            mcfg.vocab_size), max_abs_dwq=dwq, frac_changed_step1=changed,
        step_ms=step_ms, median_step_ms=median_ms,
        tokens_per_s=n_tok / median_ms * 1e3, peak_mem_gb=peak_gb,
        launches=launches, loss_flash=float(loss_k), loss_oracle=float(loss_o),
        dloss=dloss, min_grad_cosine=cos[worst_cos], min_cosine_param=worst_cos,
        grad_batch=tokens_shape[0])
    if other is not None:
        # the flash gradients against another attention's oracle must miss
        # by more: a lower worst cosine (1 − cosine at least SEPARATION
        # times the right oracle's)
        other_name, other_attn = other
        loss_x, grads_x = graft_entry.loss_and_grads(
            params, tokens, mcfg, attn_fn=checkpointed(other_attn))
        cos_x = grad_cosines(params, grads_k, grads_x)
        del grads_x
        worst_x = min(cos_x, key=cos_x.get)
        miss, miss_x = 1.0 - cos[worst_cos], 1.0 - cos_x[worst_x]
        row.update({f"vs_{other_name}": dict(
            loss_oracle=float(loss_x), dloss=abs(float(loss_k) - float(loss_x)),
            min_grad_cosine=cos_x[worst_x], min_cosine_param=worst_x,
            cosine_of_worst_param=cos_x[worst_cos],
            miss_ratio=miss_x / max(miss, 1e-300))})
        if not miss_x > SEPARATION * miss:
            raise AssertionError(
                f"{phase}: the {other_name} oracle misses the flash gradients "
                f"by 1 - {cos_x[worst_x]}, not more than {SEPARATION} times "
                f"the right oracle's 1 - {cos[worst_cos]}")
    del grads_k
    row["profile"] = profile_train_step(params, tokens, mcfg, median_ms)
    if named:
        got = fresh_trace(phase, "", trace(
            lambda: [graft_entry.train_step(params, tokens, mcfg, 0.0)
                     for _ in range(TRAIN_STEPS)]))
        counts = {n: sum(c for k_, (c, _) in got.items() if n in k_)
                  for n in (*named, *BLOCK_KERNELS)}
        row["launches_by_device_name"] = counts
        bad = {k: v for k, v in counts.items()
               if v != (launches["flash_bwd_dq"] if k in named else 0)}
        if bad:
            raise AssertionError(
                f"{phase}: {launches['flash_bwd_dq']} launches of B4 and of "
                f"B5, but by device name {counts}")
    row["matmul_allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    emit(row)
    del params
    return launches


def train_inputs(model: dict, tokens_shape, dev) -> tuple:
    """The train phases' model (weights from seed 0) and tokens (seed 1) →
    (params, tokens, ModelConfig)."""
    from tpu_flash_torch.models import transformer as tfm

    mcfg = tfm.ModelConfig(**model)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, tokens_shape), device=dev)
    return params, tokens, mcfg


def train_f32_phase(dev):
    """The canonical model in float32 (``dtype="float32"``): three SGD steps
    at full width and depth through B1 and the float32 B4/B5 (3×TF32 at
    d 128), the gradient against the oracle-attention path's, and B4's and
    B5's launches by device name (flash_bwd_f32.cu's kernels, 16 layers × 3
    steps each). The projections stay full float32
    (torch.backends.cuda.matmul.allow_tf32 False, in the phase's line).
    Then the backward's first B4/B5 call (the last layer's: b 4, the
    1024 input tokens of each 1025-token row, on the model's own
    activations and lse) re-run on its own inputs (:func:`held_first_bwd`),
    and the same call on one TF32 pass, a planted fault, rejected on every
    grad."""
    from tpu_flash_torch.ops import flash_bwd

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train_f32: the projections would run in TF32")
    with first_bwd_call() as rec:
        launches = train_phase(dev, "train_f32", dict(MODEL, dtype="float32"),
                               named=F32_KERNELS)
        torch.cuda.synchronize()
    held, got, plain = held_first_bwd("train_f32", rec)
    one = flash_bwd._flash_bwd_kernel(*rec["args"], rec["quant"],
                                      tf32_passes=1)
    errs = {f"d{x}": rel_to_max(a_, p_) for x, a_, p_ in zip("qkv", one, plain)}
    passed = [x for x, e in errs.items() if e <= held["tol"]]
    if passed:
        raise AssertionError(f"train_f32 B4/B5: planted fault one_tf32_pass "
                             f"passes the kernel-vs-plain check on {passed}: "
                             f"{errs}")
    held["planted_fault_one_tf32_pass"] = errs
    emit(dict(phase="train_f32_checks", last_layer_b4_b5=held))
    del rec, got, plain, one
    return launches


def train_sliding_phase(dev):
    """The sliding model's training: the canonical model with
    ``attention="sliding", window=1025`` on 2 × 2049 tokens (the causal
    phase's token count at twice its length, so that the band hides most
    keys of most rows), three SGD steps through B1 and B4/B5 on the
    local_causal kind; the gradient held against sliding_dpa's (causal) and
    shown to miss dense_dpa's (causal) by more."""
    from tpu_flash_torch.ops.oracle import dense_dpa, sliding_dpa

    return train_phase(
        dev, "train_sliding",
        dict(MODEL, attention="sliding", window=SLIDING_WINDOW),
        SLIDING_TRAIN_TOKENS,
        oracle=lambda q, k, v: sliding_dpa(q, k, v, SLIDING_WINDOW,
                                           causal=True),
        other=("causal", lambda q, k, v: dense_dpa(q, k, v, causal=True)))


def backward_sweep_phase(dev):
    """``bench/sweep.py``'s backward suite at its quick shapes: dense,
    causal, sliding and circulant (n > 1025) fwd + bwd through the public
    calls, gated against the checkpointed blockwise oracle's grads."""
    from tpu_flash_torch.bench import sweep

    rows = sweep.suite_backward(dev, quick=True)
    emit(dict(phase="backward_sweep", rows=rows))
    return rows


def profile_train_step(params, tokens, mcfg, step_ms, top=15):
    """torch.profiler over one train step at lr 0 (weights unchanged):
    device time by kernel, the kernel count, and the device's busy share
    of ``step_ms``, the step's unprofiled time (the profiler's own start-up
    would inflate a profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_flash_torch import graft_entry

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graft_entry.train_step(params, tokens, mcfg, 0.0)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kern}
    total_us = sum(dev_us.values())
    rows = sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]
    groups = {"flash forward (B1)": ("flash_fwd",),
              "flash backward (B4, B5)": ("flash_bwd",),
              "matrix products": ("nvjet", "gemm", "cutlass", "sm90_")}
    by_group = {name: sum(v for k, v in dev_us.items()
                          if any(m in k for m in marks)) / 1e3
                for name, marks in groups.items()}
    by_group["elementwise, copies, reductions"] = (
        total_us / 1e3 - sum(by_group.values()))
    return dict(device_ms=total_us / 1e3,
                device_busy_share=total_us / 1e3 / step_ms,
                b4_b5_device_share=(by_group["flash backward (B4, B5)"]
                                    / (total_us / 1e3) if total_us else None),
                device_kernels=sum(e.count for e in kern),
                device_ms_by_group=by_group,
                top=[dict(kernel=k[:80], ms=v / 1e3, share=v / total_us)
                     for k, v in rows])


# the quantized headline (bench.py's shape): batch, heads, n, d
QUANT_SHAPE = (4, 8, 8192, 128)
# (name, dtype, mode): serving fp8 with tensor K scales and serving int8
# with token K scales (B6), end-to-end fp8 (B7)
QUANT_RUNS = [("serving_fp8", "float8_e4m3fn", "serving"),
              ("serving_int8", "int8", "serving"),
              ("e2e_fp8", "float8_e4m3fn", "e2e")]
# gate: the matched-bit-width contract (≤ 1e-2 against the f32 oracle on
# inputs quantized at the same granularity)
TOL_QUANT_GATE = 1e-2
# B6/B7 vs their plain versions: each o entry within TOL_Q_ULPS bf16 ulps
# of its row's max |plain o| (both sides round P and o from float32 sums
# taken in another order) and within TOL_BF16; lse within TOL_Q_LSE
# (float32 sums; lse ≲ 10 has an ulp near 1e-6; the plain version sums the
# fp8 products as the card's fp8 units do, flash_q.fp8_scores). A kv tile
# left out or the V scales one channel off must fail: the headline cases
# plant those faults in the plain version and check.
TOL_Q_ULPS = 4
TOL_Q_LSE = 1e-4
# the planted faults' gap: 64 keys (half a kernel tile at d 128)
FAULT_TILE = 64


def row_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| in bf16 ulps of the row's max |ref| (ulp of x in
    [2^e, 2^(e+1)) is 2^(e−7)); a row of zeros must match exactly."""
    top = ref.float().abs().amax(-1, keepdim=True)
    ulp = torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                      torch.finfo(torch.float32).tiny)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def quant_errs(ko, kl, po, pl, exact=None) -> dict:
    """o and lse against the plain version. Where the scores come from the
    fp8 products, ``exact`` is the plain version's (o, lse) with exact
    float32 sums in place of the fp8 units' (:func:`float32_sums`): how far
    those units move the result, reported and not gated (ROADMAP C)."""
    errs = dict(o_vs_plain=max_err(ko, po), o_vs_plain_ulps=row_ulps(ko, po),
                lse_vs_plain=max_err(kl, pl))
    if exact is not None:
        errs.update(o_vs_float32_sums=max_err(ko, exact[0]),
                    lse_vs_float32_sums=max_err(kl, exact[1].reshape(
                        kl.shape)))
    return errs


def float32_sums(q_op, qs, ops, sched, hq, hkv, out_dtype):
    """The plain tile loop on e4m3 q̂ handed over in float32: the fp8
    products then sum exactly in float32, not as the card's fp8 units sum
    them. ``ops`` as ``serving_operands`` (q, k̂, v̂, σk token, σk tensor,
    σv, gk); ``qs`` the row factors; ``sched`` the call's schedule."""
    from tpu_flash_torch.quant import flash_q as tfq

    _, k_vals, v_vals, sk, _, sv, gk = ops
    return tfq._attend_plain(q_op.float(), qs, k_vals, v_vals, sk, sv, gk,
                             sched, hq, hkv, out_dtype)


QUANT_TOL = dict(o_vs_plain=TOL_BF16, o_vs_plain_ulps=TOL_Q_ULPS,
                 lse_vs_plain=TOL_Q_LSE)


def planted_faults(plain_fn, args, ko, kl):
    """The kernel's (o, lse) against the serving plain version with a fault
    planted: one kv tile in the middle left out, or the V scales applied
    one channel off. Each must fail the kernel-vs-plain check; returns the
    errors it shows."""
    q, k_vals, v_vals, sk_token, sk_tensor, sv, *rest = args
    n_kv = k_vals.shape[1]
    j = n_kv // 2
    keep = torch.cat([torch.arange(j, device=k_vals.device),
                      torch.arange(j + FAULT_TILE, n_kv, device=k_vals.device)])
    faults = {
        "kv_tile_left_out": (q, k_vals[:, keep], v_vals[:, keep],
                             None if sk_token is None else sk_token[:, keep],
                             sk_tensor, sv, *rest),
        "v_scale_one_channel_off": (q, k_vals, v_vals, sk_token, sk_tensor,
                                    torch.roll(sv, 1, dims=-1), *rest),
    }
    out = {}
    for fault, fargs in faults.items():
        errs = quant_errs(ko, kl, *plain_fn(*fargs))
        if all(errs[key] <= tol for key, tol in QUANT_TOL.items()):
            raise AssertionError(f"planted fault {fault} passes the "
                                 f"kernel-vs-plain check: {errs}")
        out[fault] = errs
    return out


# kernel vs plain at variant shapes, b 1: (name, q_dtype, kv_dtype,
# kv_scale, pv_quant, hq, hkv, n, d, dv, causal); d 64 is where the
# reference's transposed B8 runs; d 256 the widest compiled width, d 96 with
# dv 64 a padded one
QUANT_VARIANTS = [
    ("d64_int8_causal_gqa", "int8", "int8", "token", False, 16, 8, 1000, 64,
     64, True),
    ("d64_fp8_causal_gqa", "float8_e4m3fn", "float8_e4m3fn", "tensor", False,
     16, 8, 1000, 64, 64, True),
    ("weight_only_int8", None, "int8", "token", False, 16, 8, 1000, 128, 128,
     True),
    ("weight_only_fp8", None, "float8_e4m3fn", "tensor", False, 16, 8, 1000,
     128, 128, False),
    ("int8_pv_quant", "int8", "int8", "token", True, 16, 8, 1000, 128, 128,
     False),
    ("e5m2_cache", "float8_e4m3fn", "float8_e5m2", "tensor", False, 16, 8,
     1000, 128, 128, False),
    ("d256_fp8_token_causal", "float8_e4m3fn", "float8_e4m3fn", "token",
     False, 16, 8, 1000, 256, 256, True),
    ("d256_int8", "int8", "int8", "token", False, 8, 8, 1000, 256, 256,
     False),
    ("d96_dv64_fp8_gqa", "float8_e4m3fn", "float8_e4m3fn", "tensor", False,
     16, 8, 1000, 96, 64, True),
    ("d96_dv64_int8", "int8", "int8", "token", False, 8, 8, 1000, 96, 64,
     False),
]


# B6/B7's device kernel: csrc/quant_attention.cu's persistent kernel covers
# every instantiation (pv_quant and width 512 included; B6 runs its Q
# staging pass, quant_stage_q, before it); the one-CTA-a-tile kernel it
# replaced was quant_attention_kernel
QUANT_NAMED = "quant_attention_persistent"
QUANT_REPLACED = "quant_attention_kernel"
# quant_bands' timed rows → bench/quant_bench.py:NAME_ROWS
QB_NAMED = {"sliding_causal_fp8": "a_local_causal_fp8",
            "sliding_causal_int8": "a_local_causal_int8",
            "sliding_w257_fp8": "b_local_r128_fp8",
            "circulant_int8_weight_only": "c_circulant_weight_only",
            "circulant_int8": "c_circulant_int8",
            "block512_fp8": "d_block512_fp8",
            "serving_local_causal_fp8_gqa": "e_serving_local_causal_fp8",
            "serving_local_causal_int8_pv_quant":
                "e_serving_local_causal_int8_pv_quant"}
_QUANT_NAMES: dict = {}


def quant_kernel_names() -> dict:
    """The device kernels (profiler) of one call of each timed B6/B7 row's
    instantiation (bench/quant_bench.py --names: the headline's three,
    rows a–e, d 512 and B8's shape, at a small shape), taken in a process
    of its own (:func:`fresh_process`: in this one, after the phases
    before, the card's traces have come back empty for them; a row with no
    trace is taken again), printed; raises unless every row ran the
    persistent kernel and none the replaced one. Taken once a run."""
    if not _QUANT_NAMES:
        _QUANT_NAMES.update(fresh_process(
            ["-m", "tpu_flash_torch.bench.quant_bench", "--names"],
            "quant_bench --names"))
    for row, names in _QUANT_NAMES.items():
        print(f"B6/B7 {row} device kernels: {names}", flush=True)
        if not any(QUANT_NAMED in n for n in names) or any(
                QUANT_REPLACED in n for n in names):
            raise AssertionError(f"B6/B7 {row}: the call ran {names}, not "
                                 f"{QUANT_NAMED} alone")
    return {row: [short_kernel_name(n)[:80] for n in names
                  if "quant_attention" in n or "quant_stage_q" in n]
            for row, names in _QUANT_NAMES.items()}


def staged_bytes(t: torch.Tensor) -> torch.Tensor:
    """A staged Q operand as raw integers (e4m3 and int8 bytes, bf16
    words), for an exact comparison."""
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(torch.int16)


def quant_attention_phase(dev):
    """The headline at full shape through the public entry points (the
    slice's main path, counted), each gated against blockwise_dpa; then
    B6 and B7 against their plain versions on the same inputs (staged Q
    bytes equal, o within QUANT_TOL, lse within TOL_Q_LSE; planted faults
    rejected), timed beside the bound and the
    library's bf16 attention; then the variant shapes."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.bench import harness, headline
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    named = quant_kernel_names()
    b, h, n, d = QUANT_SHAPE
    q, k, v = headline.make_inputs(b, h, n, d, dev)
    kernels.reset_launches()
    runs = {name: headline.run(q, k, v, dt, mode) for name, dt, mode in
            QUANT_RUNS}
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in (
        "serving_attention", "quant_attention")}
    for name, r in runs.items():
        check(f"{name} gate", r["max_abs_err"], TOL_QUANT_GATE)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "headline runs")

    peaks = harness.device_peaks(dev)
    c = tfq.f32(d ** -0.5 * flash.LOG2E)
    flops = harness.attention_flops(b, h, n, n, d)
    worst = {"serving": 0.0, "quant": 0.0}
    rows = []

    def held(kind, name, kernel_fn, plain_fn, scale_elems, qk,
             staged=None, time_it=False, faults=None, exact_fn=None):
        ko, kl = kernel_fn()
        errs = quant_errs(ko, kl, *plain_fn(),
                          None if exact_fn is None else exact_fn())
        for key, tol in QUANT_TOL.items():
            check(f"{kind} {name} {key}", errs[key], tol)
        worst[kind] = max(worst[kind], errs["o_vs_plain"],
                          errs["lse_vs_plain"])
        row = dict(kernel=kind, case=name, tol=QUANT_TOL, **errs)
        if staged is not None:
            row["staged_q_bytes_equal"] = staged
        if faults is not None:
            row["planted_faults"] = faults(ko, kl)
        if time_it:
            row["device_kernels"] = named["headline_" + name]
            bh, bh_kv = b * h, b * h
            # q and o in bf16, the cache at one byte, the fp32 scales
            nbytes = 2 * 2 * bh * n * d + 2 * bh_kv * n * d + 4 * scale_elems
            row.update(ms=cuda_ms(lambda: kernel_fn(False)),
                       plain_ms=cuda_ms(plain_fn, iters=3, warmup=1),
                       library_ms=library_ms,
                       **harness.roofline(flops / 2, flops / 2, nbytes, peaks,
                                          qk, "bf16"))
            row["tflops"] = flops / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        return row

    sched = flash.build_schedule("dense", n, n, 1024, 2048)
    library_ms = cuda_ms(lambda: sdpa(q, k, v, False))
    timed = {}
    for name, dt, kv_scale in (("serving_fp8", "float8_e4m3fn", "tensor"),
                               ("serving_int8", "int8", "token")):
        kq, vq = tsa.quantize_kv_cache(k, v, dt, kv_scale=kv_scale)
        ops = tsa.serving_operands(q, kq, vq, True)
        mode = "int8" if dt == "int8" else "fp8"
        args = (*ops, sched, h, h, mode, c, False)
        _, _, q_op, qs = tsa._serving_attention_kernel(*args, False,
                                                       staged=True)
        skf = 1.0 if ops[4] is None else ops[4][:, None, None]
        p_op, p_qs = tsa._stage_q_plain(ops[0], mode, c, skf)
        same = torch.equal(staged_bytes(q_op), staged_bytes(p_op))
        same = same and torch.equal(qs, p_qs)
        if not same:
            raise AssertionError(f"B6 {name}: staged Q differs from the "
                                 "plain staging")
        scale_elems = sum(t.numel() for t in ops[3:] if t is not None)
        timed[name] = held(
            "serving", name,
            lambda need=True: tsa._serving_attention_kernel(*args, need),
            lambda: tsa._serving_plain(*args), scale_elems,
            "int8" if dt == "int8" else "fp8", staged=True, time_it=True,
            faults=lambda ko, kl, args=args: planted_faults(
                tsa._serving_plain, args, ko, kl),
            exact_fn=None if mode == "int8" else lambda: float32_sums(
                p_op, p_qs, ops, sched, h, h, q.dtype))
        del kq, vq, ops, args
    prep = tfq.prepare_quantized(q, k, v, torch.float8_e4m3fn,
                                 torch.float8_e4m3fn, False, d ** -0.5)
    qops = tfq.quant_operands(*prep, False, True)
    timed["e2e_fp8"] = held(
        "quant", "e2e_fp8",
        lambda need=True: tfq._quant_attention_kernel(
            *qops, sched, h, h, torch.bfloat16, need),
        lambda: tfq._quant_plain(*qops, sched, h, h, torch.bfloat16),
        sum(t.numel() for t in qops[4:] if t is not None), "fp8",
        time_it=True, exact_fn=lambda: tfq._quant_plain(
            qops[0].float(), *qops[1:], sched, h, h, torch.bfloat16))
    del prep, qops

    gen = torch.Generator(device=dev).manual_seed(5)
    for (name, q_dt, kv_dt, kv_scale, pvq, hq, hkv, nv, d_, dv_,
         causal) in QUANT_VARIANTS:
        qv, kv, vv = (torch.randn(1, hh, nv, dd, generator=gen, device=dev)
                      .bfloat16() for hh, dd in ((hq, d_), (hkv, d_),
                                                 (hkv, dv_)))
        kq, vq = tsa.quantize_kv_cache(kv, vv, kv_dt, kv_scale=kv_scale)
        ops = tsa.serving_operands(qv, kq, vq, not pvq)
        vsched = flash.build_schedule("causal" if causal else "dense", nv,
                                      nv, 1024, 2048)
        mode = {"int8": "int8", None: "raw"}.get(q_dt, "fp8")
        args = (*ops, vsched, hq, hkv, mode, tfq.f32(
            d_ ** -0.5 * flash.LOG2E), pvq)
        staged = exact_fn = None
        if q_dt is not None:
            _, _, q_op, qs = tsa._serving_attention_kernel(*args, False,
                                                           staged=True)
            skf = 1.0 if ops[4] is None else ops[4].repeat_interleave(
                hq // hkv)[:, None, None]
            p_op, p_qs = tsa._stage_q_plain(ops[0], mode, args[-2], skf)
            staged = (torch.equal(staged_bytes(q_op), staged_bytes(p_op))
                      and torch.equal(qs, p_qs))
            if not staged:
                raise AssertionError(f"B6 {name}: staged Q differs from the "
                                     "plain staging")
            if mode == "fp8":
                exact_fn = (lambda p_op=p_op, p_qs=p_qs, ops=ops, vs=vsched,
                            hq=hq, hkv=hkv, qv=qv: float32_sums(
                                p_op, p_qs, ops, vs, hq, hkv, qv.dtype))
        row = held("serving", name,
                   lambda need=True: tsa._serving_attention_kernel(*args, need),
                   lambda: tsa._serving_plain(*args), 0, "bf16", staged=staged,
                   exact_fn=exact_fn)
        if name == "d64_fp8_causal_gqa":  # B8's shape, folded into B6
            row["device_kernels"] = named["b8_d64_causal_fp8"]
            flops_b8 = 4 * dv_ * hq * visible_pairs(nv, nv, True)
            # q and o in bf16, the cache at one byte, the fp32 scales
            nbytes = (2 * 2 * hq * nv * dv_ + 2 * hkv * nv * dv_ + 4 * sum(
                t.numel() for t in ops[3:] if t is not None))
            # the library's time at this small shape moves from run to
            # run: the median of five samples, all five reported
            lib = [cuda_ms(lambda: sdpa(qv, kv, vv, True)) for _ in range(5)]
            row.update(ms=cuda_ms(lambda: tsa._serving_attention_kernel(
                           *args, False)),
                       plain_ms=cuda_ms(lambda: tsa._serving_plain(*args),
                                        iters=3, warmup=1),
                       library_ms=sorted(lib)[2], library_ms_samples=lib,
                       **harness.roofline(flops_b8 / 2, flops_b8 / 2, nbytes,
                                          peaks, "fp8", "bf16"))
            row["tflops"] = flops_b8 / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            timed["b8_shape"] = row
        if q_dt is not None and not pvq:  # the same case through B7
            prep = tfq.prepare_quantized(
                qv, kv, vv, tfq.as_dtype(q_dt), tfq.as_dtype(kv_dt),
                kv_scale == "token", d_ ** -0.5)
            qops = tfq.quant_operands(*prep, kv_scale == "token", True)
            held("quant", name,
                 lambda need=True: tfq._quant_attention_kernel(
                     *qops, vsched, hq, hkv, torch.bfloat16, need),
                 lambda: tfq._quant_plain(*qops, vsched, hq, hkv,
                                          torch.bfloat16), 0, "bf16",
                 exact_fn=None if mode != "fp8" else lambda: tfq._quant_plain(
                     qops[0].float(), *qops[1:], vsched, hq, hkv,
                     torch.bfloat16))
    emit(dict(phase="quant_attention", shape=dict(batch=b, heads=h, n=n, d=d),
              headline=runs, launches=launches, library_bf16_sdpa_ms=library_ms,
              kernels_vs_plain=rows))
    return dict(launches=launches, worst=worst, timed=timed,
                library_ms=library_ms)


def headdims_phase(dev):
    """Head and value dims other than 64 and 128, and a group of 16, on
    every attention kernel, each against its plain version: B1 then B4/B5
    (bf16 at d 96, 256, 96/64 and 40/200; float32 at 256, the smaller-tile
    instantiations), B1 alone above 256 (bf16 at 320, 512, 512/256 and 260
    under causal, local_causal and the norm bound; float32 at 512), B3
    (bytes equal) and B2 on its split and shared-table routes at d 40 and
    96 with G 16 (int8, bf16 and float32 pages) and at d 100, 260 and 512
    with G 2 and 16 on every page type, B6 and B7 through their
    public entry points at d 96, 256 and 96/64 (the CPU tensors take the
    plain versions)."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
    from tpu_flash_torch.ops import flash, flash_bwd, paged
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    kernels.reset_launches()
    rows = []
    hq, hkv, n = 8, 4, 500
    for d, dv, dt in ((96, 96, torch.bfloat16), (256, 256, torch.bfloat16),
                      (96, 64, torch.bfloat16), (40, 200, torch.bfloat16),
                      (256, 256, torch.float32)):
        q = (randn(hq, n, d) * (d ** -0.5 * flash.LOG2E)).to(dt)
        k, v = randn(hkv, n, d).to(dt), randn(hkv, n, dv).to(dt)
        sched = flash.build_schedule("causal", n, n, 256, 256)
        ko, kl = flash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
        po, pl = flash._flash_fwd_plain(q, k, v, sched, hq, hkv)
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
        errs = dict(o_vs_plain=max_err(ko, po), lse_vs_plain=max_err(kl, pl))
        do, dlse = randn(hq, n, dv).to(dt), randn(hq, n)
        bwd = (q, k, v, ko, kl, do, dlse, sched, hq, hkv)
        for name, a, w in zip(("dq", "dk", "dv"),
                              flash_bwd._flash_bwd_kernel(*bwd),
                              flash_bwd._flash_bwd_plain(*bwd)):
            if a.shape != w.shape:
                raise AssertionError(f"B4/B5 d {d}/{dv}: {name} shape")
            errs[f"{name}_vs_plain_rel"] = rel_err(a, w)
        for key, err in errs.items():
            check(f"headdims B1/B4/B5 d {d}/{dv} {key}", err,
                  TOL_BWD_PLAIN[dt] if "rel" in key else tol)
        rows.append(dict(kernels="flash_fwd, flash_bwd", d=d, dv=dv,
                         dtype=str(dt).replace("torch.", ""), **errs))

    # B1 above 256 (its backward stops at 256: ROADMAP A15b): bf16 at d/dv
    # 320, 512, 512/256 and 260 under causal, local_causal (radius 512) and
    # the norm bound (dense), float32 at 512
    b1_kinds = (("causal", 0, False), ("local_causal", 512, False),
                ("dense", 0, True))
    for d, dv, dt, kinds in ((320, 320, torch.bfloat16, b1_kinds),
                             (512, 512, torch.bfloat16, b1_kinds),
                             (512, 256, torch.bfloat16, b1_kinds),
                             (260, 260, torch.bfloat16, b1_kinds),
                             (512, 512, torch.float32, b1_kinds[:1])):
        nw = 1000  # the band of radius 512 leaves keys out
        q = (randn(hq, nw, d) * (d ** -0.5 * flash.LOG2E)).to(dt)
        k, v = randn(hkv, nw, d).to(dt), randn(hkv, nw, dv).to(dt)
        for schedule, radius, bound in kinds:
            sched = flash.build_schedule(schedule, nw, nw, 512, 1024,
                                         radius=radius)
            ko, kl = flash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True,
                                             bound)
            po, pl = flash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
            errs = dict(o_vs_plain=max_err(ko, po), lse_vs_plain=max_err(kl, pl))
            check(f"headdims B1 d {d}/{dv} {schedule} o", errs["o_vs_plain"],
                  TOL_BF16 if dt == torch.bfloat16 else TOL_F32)
            check(f"headdims B1 d {d}/{dv} {schedule} lse",
                  errs["lse_vs_plain"], TOL_LSE)
            rows.append(dict(kernels="flash_fwd", d=d, dv=dv,
                             dtype=str(dt).replace("torch.", ""),
                             schedule=schedule, radius=radius, bound_max=bound,
                             **errs))

    def paged_case(d, dtype, groups, tol_lse):
        """B3's bytes, then B2's split and shared-table routes at each
        group size, against the plain versions (4 lanes, 2 kv heads)."""
        cfg = CacheConfig(num_kv_heads=2, head_dim=d, page_size=64,
                          total_pages=64, max_seqs=8, max_pages_per_seq=16,
                          dtype=dtype)
        caches = [PagedKVCache.create(cfg, dev) for _ in range(2)]
        table = (torch.randperm(63, generator=gen, device=dev)[:32] + 1
                 ).reshape(4, 8).int()
        lens = [300, 257, 64, 450]
        prompts = [(randn(2, m, d), randn(2, m, d)) for m in lens]
        for c in caches:
            c.page_tables[:4, :8] = table
            for slot, (kp, vp) in enumerate(prompts):
                c.write_prompt(slot, kp, vp)
        slots = torch.arange(4, dtype=torch.int32, device=dev)
        kn, vn = randn(4, 2, d).bfloat16(), randn(4, 2, d).bfloat16()
        kc, pc = caches
        pt = cfg.page_type
        paged._paged_append_kernel(kn, vn, kc.k_pages, kc.v_pages,
                                   kc.k_scales, kc.v_scales, slots,
                                   kc.lengths, kc.page_tables, page_type=pt)
        paged._paged_append_plain(kn, vn, pc.k_pages, pc.v_pages,
                                  pc.k_scales, pc.v_scales, slots,
                                  pc.lengths, pc.page_tables, page_type=pt)
        _same_cache(f"headdims B3 d {d} {dtype}", kc, pc)
        walk = paged.plan_pages(kc.config)
        for g in groups:
            qg = randn(4, 2, g, d).bfloat16()
            args = (qg, kc.k_pages, kc.v_pages, kc.k_scales, kc.v_scales,
                    slots, kc.lengths, kc.page_tables, 1, 16, torch.bfloat16,
                    True)
            ko, kl = paged._paged_attention_kernel(*args, page_type=pt,
                                                   walk=walk)
            po, pl = paged._paged_attention_plain(
                *args, split_pages=_card_plan(qg, kc), page_type=pt)
            errs = dict(o_vs_plain=max_err(ko, po),
                        lse_vs_plain=max_err(kl, pl))
            # the shared-table route: the four lanes on slot 0
            one = torch.zeros(4, dtype=torch.int32, device=dev)
            sargs = (qg, kc.k_pages, kc.v_pages, kc.k_scales, kc.v_scales,
                     one, kc.lengths, kc.page_tables, 0, 16, torch.bfloat16,
                     True)
            so, sl = paged._paged_attention_kernel(*sargs,
                                                   shared_page_table=True,
                                                   page_type=pt, walk=walk)
            po, pl = paged._paged_attention_plain(*sargs, page_type=pt)
            errs.update(shared_o_vs_plain=max_err(so, po),
                        shared_lse_vs_plain=max_err(sl, pl))
            for key, err in errs.items():
                check(f"headdims B2 d {d} {dtype} G {g} {key}", err,
                      tol_lse if "lse" in key else TOL_BF16)
            rows.append(dict(kernels="paged_append, paged_attention split "
                             "and shared", d=d, g=g, cache=dtype,
                             append_bit_exact=True, **errs))

    for d in (40, 96):
        # float32 pages: the split route stages them by the threads' own
        # loads (as bf16), not by bulk copy
        for dtype in ("int8", "bfloat16", "float32"):
            paged_case(d, dtype, (16,), TOL_LSE)
    # head dims above 256 (two 8-column chunks a lane on the split route,
    # O's halves on the shared route's grid) and d 100, not a multiple of
    # 8 (rows staged zero-padded), on every page type, G 2 and 16
    for d in (100, 260, 512):
        for dtype in ("float32", "bfloat16", "int8", "int4", "fp8"):
            paged_case(d, dtype, (2, 16), TOL_LSE)

    hq, hkv = 16, 8
    for d, dv, q_dt, kv_scale in ((96, 96, "float8_e4m3fn", "tensor"),
                                  (256, 256, "int8", "token"),
                                  (96, 64, "float8_e4m3fn", "token"),
                                  (256, 128, None, "token")):
        kv_dt = q_dt or "int8"
        q, k, v = (randn(1, hq, n, d).bfloat16(), randn(1, hkv, n, d).bfloat16(),
                   randn(1, hkv, n, dv).bfloat16())
        kq, vq = tsa.quantize_kv_cache(k, v, kv_dt, kv_scale=kv_scale)
        cpu = [tfq.QArray(a.values.cpu(), a.scales.cpu(), a.axis)
               for a in (kq, vq)]
        kw = dict(q_dtype=q_dt, schedule="causal", return_lse=True)
        ko, kl = tsa.serving_flash_attention(q, kq, vq, **kw)
        po, pl = tsa.serving_flash_attention(q.cpu(), *cpu, **kw)
        exact = None
        if q_dt == "float8_e4m3fn":  # the fp8 products: the staged operands
            ops = tsa.serving_operands(q.cpu(), *cpu, True)
            rows_kv = flash._kv_rows(hq, hq, hkv, "cpu")
            skf = 1.0 if ops[4] is None else ops[4][rows_kv][:, None, None]
            q_op, qs = tsa._stage_q_plain(ops[0], "fp8", tfq.f32(
                d ** -0.5 * flash.LOG2E), skf)
            eo, el = float32_sums(q_op, qs, ops, flash.build_schedule(
                "causal", n, n, 1024, 2048), hq, hkv, q.dtype)
            exact = (eo[..., :dv].reshape(po.shape), el)
        errs = quant_errs(ko.cpu(), kl.cpu(), po, pl, exact)
        for key, tol in QUANT_TOL.items():
            check(f"headdims B6 d {d}/{dv} {key}", errs[key], tol)
        rows.append(dict(kernels="serving_attention", d=d, dv=dv,
                         q_dtype=q_dt, **errs))
        if q_dt is None or d <= 64:
            continue
        kw = dict(q_dtype=q_dt, kv_dtype=kv_dt, kv_scale=kv_scale,
                  schedule="dense", return_lse=True)
        ko, kl = tfq.quantized_flash_attention(q, k, v, **kw)
        po, pl = tfq.quantized_flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
        if exact is not None:
            prep = tfq.prepare_quantized(
                q.cpu(), k.cpu(), v.cpu(), tfq.as_dtype(q_dt),
                tfq.as_dtype(kv_dt), kv_scale == "token", d ** -0.5)
            qops = tfq.quant_operands(*prep, kv_scale == "token", True)
            sched = flash.build_schedule("dense", n, n, 1024, 2048)
            eo, el = tfq._quant_plain(qops[0].float(), *qops[1:], sched, hq,
                                      hkv, q.dtype)
            exact = (eo.reshape(po.shape), el)
        errs = quant_errs(ko.cpu(), kl.cpu(), po, pl, exact)
        for key, tol in QUANT_TOL.items():
            check(f"headdims B7 d {d}/{dv} {key}", errs[key], tol)
        rows.append(dict(kernels="quant_attention", d=d, dv=dv, q_dtype=q_dt,
                         **errs))
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_append",
                 "paged_attention_split", "paged_attention_shared",
                 "serving_attention", "quant_attention"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"headdims: kernel {name} never launched")
    emit(dict(phase="headdims", launches=launches, cases=rows))
    return dict(launches=launches, rows=rows)


# The wide-head serving path: the canonical model with 4 q / 2 kv heads of
# head_dim 512 (the same q and kv widths, so the same weight bytes from
# seed 0 and the same cache bytes a token), served as engine_phase serves
# it, in async rounds of 8 as CUDA graphs and through chunked prefill; B1,
# B2 (split with B3 fused, and shared) held against their plain versions on
# the path's own inputs, each check shown to reject the upper half of the
# head hidden (V's columns 256–511 zeroed in a copy of the plain version's
# inputs); each kernel timed at d 512 beside its bound
MODEL_WIDE = dict(MODEL, num_q_heads=4, num_kv_heads=2, head_dim=512)
CACHE_WIDE = dict(CACHE, num_kv_heads=2, head_dim=512)
WIDE_CHUNK = 512
WIDE_LONG, N_WIDE_LONG = (1100, 2000), 4
WIDE_UPPER = slice(256, 512)  # the columns the planted faults zero


@contextlib.contextmanager
def no_plain_on_cuda():
    """Count the plain versions' calls on CUDA tensors while the block
    runs (the wrappers take them only for CPU tensors): B1's, B2's, B3's,
    the backward's (B4/B5) and the quantized ones (B7, B6); yields the
    counts."""
    from tpu_flash_torch.ops import flash, flash_bwd, paged
    from tpu_flash_torch.quant import flash_q, serving_attn

    counts, saved = {}, []
    for mod, name in ((flash, "_flash_fwd_plain"),
                      (paged, "_paged_attention_plain"),
                      (paged, "_paged_append_plain"),
                      (flash_bwd, "_flash_bwd_plain"),
                      (flash_q, "_quant_plain"),
                      (serving_attn, "_serving_plain")):
        real = getattr(mod, name)
        saved.append((mod, name, real))
        counts[name] = 0

        def counted(*a, _real=real, _name=name, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                counts[_name] += 1
            return _real(*a, **kw)

        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def held_b1_call(fn, name: str) -> dict:
    """Run ``fn`` with B1's wrapper recording its last call (on the
    model's path, the last layer's), re-run that call: o bitwise the main
    path's, o within TOL_BF16 and lse within TOL_LSE of the plain version;
    the plain version with V's columns 256–511 zeroed must fail that
    check."""
    from tpu_flash_torch.ops import flash

    real, rec = flash._flash_fwd_kernel, {}

    def recorded(q, k, v, sched, hq, hkv, need_lse, bound_max=False, kmax=None):
        out = real(q, k, v, sched, hq, hkv, need_lse, bound_max, kmax)
        rec.update(args=(q.clone(), k.clone(), v.clone(), sched, hq, hkv),
                   bound=bound_max, o=out[0].clone())
        return out

    flash._flash_fwd_kernel = recorded
    try:
        fn()
    finally:
        flash._flash_fwd_kernel = real
    q, k, v, sched, hq, hkv = rec["args"]
    got = flash._flash_fwd_kernel(*rec["args"], True, rec["bound"])
    torch.cuda.synchronize()
    if not torch.equal(got[0], rec["o"]):
        raise AssertionError(f"{name} B1: the wrapper's o is not the main path's")
    errs = _held_b2(f"{name} B1", got, flash._flash_fwd_plain(
        *rec["args"], rec["bound"]), tol_lse=TOL_LSE)
    hidden = v.clone()
    hidden[..., WIDE_UPPER] = 0
    fault = _rejects(f"{name} B1", got, flash._flash_fwd_plain(
        q, k, hidden, sched, hq, hkv, rec["bound"]))
    return dict(bh=q.shape[0], hq=hq, hkv=hkv, n_q=q.shape[1], n_kv=k.shape[1],
                d=q.shape[-1], dv=v.shape[-1], kind=type(sched).__name__,
                bound_max=rec["bound"], main_path_o_bitwise=True, tol=TOL_BF16,
                tol_lse=TOL_LSE, planted_fault_v_upper_half=fault, **errs)


def _upper_half_hidden(c):
    """A copy of cache ``c`` whose V pages hold 0 in columns 256–511 (a
    page type of one storage unit a value)."""
    hidden = _cache_copy(c)
    hidden.v_pages[..., WIDE_UPPER] = 0
    return hidden


def record_shared(cache, rec: dict):
    """A recorder for ``tfm.paged_attention``: the first shared-table call
    on ``cache`` over a non-empty prefix (a chunk after the first) goes
    into ``rec`` with a copy of the cache as it found it, its inputs and
    its o and lse."""
    from tpu_flash_torch.models import transformer as tfm

    real = tfm.paged_attention

    def recorded(q, c, slots, **kw):
        if (c is cache and not rec and kw.get("shared_page_table")
                and int(c.lengths[int(slots[0])]) > 0):
            rec.update(q=q.clone(), pre=_cache_copy(c), slots=slots.clone(),
                       kw=dict(kw))
            out = real(q, c, slots, **kw)
            rec.update(o=out[0].clone(), lse=out[1].clone())
            return out
        return real(q, c, slots, **kw)

    return recorded


def step_groups(fn) -> dict:
    """torch.profiler over one ``fn()`` (ending in a synchronise): device
    ms by kernel group — B2/B3 (``paged_``), B1 (``flash_fwd``), cuBLAS
    products (``gemm``, ``xmma``, ``nvjet``), the rest — and the
    activities."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = dict(paged=0.0, flash_fwd=0.0, gemm=0.0, rest=0.0)
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        group = next((g for g, keys in (("paged", ("paged_",)),
                                        ("flash_fwd", ("flash_fwd",)),
                                        ("gemm", ("gemm", "xmma", "nvjet")))
                      if any(k in name for k in keys)), "rest")
        groups[group] += e.self_device_time_total / 1e3
        count += e.count
    return dict(device_ms=sum(groups.values()), device_activities=count,
                **{f"{g}_ms": t for g, t in groups.items()})


def wide_kernel_timing(dev) -> dict:
    """B1 at n 1024 causal, b 1, 4/2 heads, d 512 (and d 320, padded to
    512), and B2's shared route at the chunk prefix (512 lanes of one slot
    over a 1536-token int8 prefix, d 512), each against its plain version
    and timed beside its bound; for B1 also the library's attention (its
    kernels named by the profiler)."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash, paged

    gen = torch.Generator(device=dev).manual_seed(18)
    hq, hkv = MODEL_WIDE["num_q_heads"], MODEL_WIDE["num_kv_heads"]
    n, out = 1024, {}
    for d in (512, 320):
        q = torch.randn(1, hq, n, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(1, hkv, n, d, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        sched = flash.build_schedule("causal", n, n, 1024, 1024)
        qf = (q.float() * (d ** -0.5 * flash.LOG2E)).bfloat16()[0]
        args = (qf, k[0], v[0], sched, hq, hkv)
        errs = _held_b2(f"wide B1 d {d}", flash._flash_fwd_kernel(*args, True),
                        flash._flash_fwd_plain(*args), tol_lse=TOL_LSE)
        pairs = visible_pairs(n, n, True)
        nbytes = 2 * (2 * hq * n * d + 2 * hkv * n * d) + 4 * hq * n
        row = dict(n=n, hq=hq, hkv=hkv, d=d, schedule="causal", **errs,
                   ms=device_ms(lambda: flash._flash_fwd_kernel(*args, True)),
                   call_ms=cuda_ms(lambda: flash._flash_fwd_kernel(*args, True)),
                   plain_ms=cuda_ms(lambda: flash._flash_fwd_plain(*args),
                                    iters=5),
                   pairs=pairs, **roofline(4 * d * hq * pairs, nbytes,
                                           torch.bfloat16))
        if d == 512:
            # the backend PyTorch picks, named by the kernels it runs
            lib = functools.partial(sdpa, q, k, v, True)
            names = device_kernel_names(lib)
            backend = next((tag for key, tag in (
                ("flash", "flash"), ("fmha", "efficient"),
                ("cudnn", "cudnn")) if any(key in n.lower() for n in names)),
                "math")
            row.update(library_ms=device_ms(lib), library_call_ms=cuda_ms(lib),
                       library_backend=backend,
                       library_kernels=[n[:80] for n in names])
        out[f"flash_fwd_d{d}"] = row

    d, lanes, prefix = 512, WIDE_CHUNK, 1536
    cache = _decode_cache("int8", [prefix], dev, 9, n_pages=32,
                          cache=CACHE_WIDE)
    pt = cache.config.page_type
    qg = (torch.randn(lanes, hkv, hq // hkv, d, generator=gen, device=dev)
          * (d ** -0.5 * flash.LOG2E)).bfloat16()
    slots = torch.zeros(lanes, dtype=torch.int32, device=dev)
    bound = -(-prefix // CACHE_WIDE["page_size"])
    walk = paged.plan_pages(cache.config)

    def shared():
        return paged._paged_attention_kernel(
            *_b2_args(qg, cache, slots, 0, bound), shared_page_table=True,
            walk=walk, page_type=pt)

    def plain():
        return paged._paged_attention_plain(
            *_b2_args(qg, cache, slots, 0, bound), page_type=pt)

    errs = _held_b2("wide B2 shared chunk prefix",
                    _bitwise_repeat("wide B2 shared", shared), plain(),
                    tol_lse=TOL_LSE)
    nbytes = (prefix * hkv * 2 * paged.row_bytes(pt, d)
              + lanes * hq * (4 * d + 4))
    out["chunk_prefix"] = dict(
        lanes=lanes, prefix=prefix, cache="int8", d=d, **errs,
        ms=device_ms(shared), call_ms=cuda_ms(shared),
        plain_ms=cuda_ms(plain, iters=5),
        **roofline(4 * d * lanes * hq * prefix, nbytes, torch.bfloat16))
    return out


def wide_heads_serve_phase(dev, smi: str) -> dict:
    """The wide-head model (MODEL_WIDE, int8 cache CACHE_WIDE) at full
    width: the engine cell (16 × (512 + 32) tokens, the last request
    sampled), its teacher-forced drift; the same requests in async rounds
    of 8 as CUDA graphs, equal to the one-token streams; 4 prompts of
    1100–2000 tokens in chunks of 512 against the unchunked engine's
    last-prompt logits; no plain version on a CUDA tensor meanwhile. Then
    the prefill's B1 call, a decode step's B2 call (B3 fused) and a chunk's
    B2 shared call of the last layer held against their plain versions,
    each with its upper-half fault rejected; B2/B3 at the decode shape
    (:func:`paged_phase`) and the kernels' d-512 times."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    with no_plain_on_cuda() as plain_calls:
        run = engine_phase(dev, model=MODEL_WIDE, cache=CACHE_WIDE)
        params, mcfg, done = run["params"], run["mcfg"], run["done"]
        if sorted(done) != list(range(N_REQUESTS)) or any(
                f.reason != "length" or len(f.new_tokens) != NEW_TOKENS
                or not all(np.isfinite(f.logprobs)) for f in done.values()):
            raise AssertionError("wide engine run: a request did not finish "
                                 "with finite logprobs")
        launches = {k: run["launches"][k] for k in (
            "flash_fwd", "paged_attention_split", "paged_append_fused")}
        rng = np.random.default_rng(0)
        prompts = rng.integers(1, mcfg.vocab_size - 1,
                               (N_REQUESTS + 1, PROMPT_LEN)).tolist()
        rounds = multistep_serve(params, mcfg, prompts, dev, MULTISTEP_K, True,
                                 cache=CACHE_WIDE, new_tokens=NEW_TOKENS)
        if (rounds["replays"] <= 0
                or rounds["eager_launches"]["paged_attention_split"]):
            raise AssertionError("wide rounds: every round must be a graph "
                                 "replay")
        rng = np.random.default_rng(17)
        long_prompts = []
        for n in rng.integers(*WIDE_LONG, N_WIDE_LONG):
            n = int(n) + (int(n) % CACHE_WIDE["page_size"] == 0)
            long_prompts.append(rng.integers(1, mcfg.vocab_size - 1, n).tolist())

        def reqs():
            return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(long_prompts)]

        warm = [Request(rid=10_000, prompt=long_prompts[0][:1100],
                        max_new_tokens=4)]
        eng = Engine(params, mcfg, CacheConfig(**CACHE_WIDE), EngineConfig(
            max_batch=MAX_BATCH, chunk_size=WIDE_CHUNK))
        rec_shared = {}
        real = tfm.paged_attention
        tfm.paged_attention = record_shared(eng.caches[-1], rec_shared)
        try:
            chunked = serve(eng, reqs(), warm)
        finally:
            tfm.paged_attention = real
        del eng
        eng = Engine(params, mcfg, CacheConfig(**CACHE_WIDE),
                     EngineConfig(max_batch=MAX_BATCH))
        whole = serve(eng, reqs(), warm)
        del eng
        torch.cuda.empty_cache()
    if any(plain_calls.values()):
        raise AssertionError(f"wide serving: plain versions ran on CUDA "
                             f"tensors: {plain_calls}")
    launches["paged_attention_shared"] = chunked["launches"][
        "paged_attention_shared"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"wide serving: kernel {name} never launched")
    drift = teacher_forced_drift(params, mcfg, done[0])
    check("wide teacher-forced logprob drift", drift, TOL_LOGPROB)
    vs_one = held_streams("wide rounds of 8 vs one-token", rounds["done"], done)
    if sorted(chunked["done"]) != list(range(N_WIDE_LONG)):
        raise AssertionError(f"wide chunked: finished {sorted(chunked['done'])}")
    chunked_vs_whole = max(
        float((chunked["first"][i] - whole["first"][i]).abs().max())
        for i in range(N_WIDE_LONG))
    check("wide chunked vs unchunked last-prompt logits", chunked_vs_whole,
          TOL_LOGPROB)

    # the kernels on the path's own inputs, the last layer's calls
    b1 = held_b1_call(lambda: tfm.prefill(params, torch.tensor(
        [prompts[0]], device=dev), mcfg), "wide prefill")
    if not rec_shared:
        raise AssertionError("wide chunked run: no shared-table call recorded")
    shared = held_shared_b2(rec_shared["q"], rec_shared["pre"],
                            rec_shared["slots"], rec_shared["kw"],
                            rec_shared["o"], rec_shared["lse"],
                            upper_half=True)
    eng = Engine(params, mcfg, CacheConfig(**CACHE_WIDE),
                 EngineConfig(max_batch=MAX_BATCH))
    for i in range(N_REQUESTS):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=8))
    eng.step()
    # one decode step of the 16 lanes, by kernel group
    step = step_groups(eng.step)
    rec = {}
    tfm.paged_attention = record_fused(eng.caches[-1], rec)
    try:
        eng.step()
        torch.cuda.synchronize()
    finally:
        tfm.paged_attention = real
    eng.run()
    del eng
    if not rec:
        raise AssertionError("wide decode: the last layer's B2 call not recorded")
    fused = held_fused_b2(rec, "wide decode", tol_lse=TOL_LSE, upper_half=True)
    del rec, rec_shared, params
    torch.cuda.empty_cache()

    decode = paged_phase(dev, ("int8",), MODEL_WIDE, CACHE_WIDE,
                         phase="wide_paged")["int8"]
    timed = wide_kernel_timing(dev)
    out = dict(
        phase="wide_heads_serve", nvidia_smi=smi, model=MODEL_WIDE,
        cache=CACHE_WIDE["dtype"], requests=N_REQUESTS, prompt_len=PROMPT_LEN,
        new_tokens=NEW_TOKENS, launches=launches,
        plain_calls_on_cuda=plain_calls, teacher_forced_drift=drift,
        drift_tol=TOL_LOGPROB, rounds_of=MULTISTEP_K,
        rounds_vs_one_token_max_logprob_gap=vs_one,
        rounds_graph_replays=rounds["replays"],
        chunked_prompt_lens=[len(p) for p in long_prompts],
        chunk=WIDE_CHUNK, chunks=len(chunked["chunk"]),
        chunked_vs_unchunked_logits=chunked_vs_whole,
        decode_ms_per_step=float(np.median(run["step_ms"][1:])),
        warm_e2e_tok_s=N_REQUESTS * NEW_TOKENS / run["wall_s"],
        rounds_warm_e2e_tok_s=N_REQUESTS * NEW_TOKENS / rounds["wall_s"],
        decode_step_device=step, b1_prefill=b1, b2_decode_fused=fused,
        b2_chunk_shared=shared, timed=timed)
    emit(out)
    return dict(launches=launches, b1=b1, fused=fused, shared=shared,
                decode=decode, timed=timed)


@contextlib.contextmanager
def first_bwd_call():
    """Inside the block, the first B4/B5 call (a training run's first
    backward's first: the last layer's) recorded, its inputs and grads
    cloned, into the dict the block gets."""
    from tpu_flash_torch.ops import flash_bwd

    real, rec = flash_bwd._flash_bwd_kernel, {}

    def recorded(q, k, v, o, lse, do, dlse, sched, hq, hkv, quant=None):
        out = real(q, k, v, o, lse, do, dlse, sched, hq, hkv, quant)
        if not rec:
            rec.update(args=(*(None if t is None else t.clone()
                               for t in (q, k, v, o, lse, do, dlse)),
                             sched, hq, hkv),
                       quant=quant, out=[t.clone() for t in out])
        return out

    flash_bwd._flash_bwd_kernel = recorded
    try:
        yield rec
    finally:
        flash_bwd._flash_bwd_kernel = real


def held_first_bwd(phase: str, rec: dict) -> tuple:
    """The B4/B5 call :func:`first_bwd_call` recorded, re-run on its own
    inputs: bitwise the main path's grads, and within TOL_BWD_PLAIN of the
    plain backward on them. The grads are a model's (far below 1), so each
    is held relative to its own largest entry (:func:`rel_to_max`) →
    (the row, the grads, the plain grads)."""
    from tpu_flash_torch.ops import flash_bwd

    if not rec:
        raise AssertionError(f"{phase}: no B4/B5 call recorded")
    args, quant = rec["args"], rec["quant"]
    got = flash_bwd._flash_bwd_kernel(*args, quant)
    torch.cuda.synchronize()
    for x, a_, m_ in zip("qkv", got, rec["out"]):
        if not torch.equal(a_, m_):
            raise AssertionError(f"{phase} B4/B5: d{x} is not the main "
                                 "path's")
    plain = flash_bwd._flash_bwd_plain(*args, quant)
    q = args[0]
    tol = TOL_BWD_PLAIN[q.dtype]
    errs = {f"d{x}_vs_plain": rel_to_max(a_, p_)
            for x, a_, p_ in zip("qkv", got, plain)}
    for key, err in errs.items():
        check(f"{phase} B4/B5 {key}", err, tol)
    held = dict(bh=q.shape[0], hq=args[8], hkv=args[9], n_q=q.shape[1],
                n_kv=args[1].shape[1], d=q.shape[-1], dv=args[2].shape[-1],
                dtype=str(q.dtype).replace("torch.", ""),
                kind=type(args[7]).__name__, dlse=args[6] is not None,
                main_path_bitwise=True, tol=tol, error="max |a - b| / max |b|",
                **errs,
                max_abs_err=max(max_err(a_, p_) for a_, p_ in zip(got, plain)))
    return held, got, plain


def wide_heads_train_phase(dev) -> dict:
    """The wide-head model's training: MODEL_WIDE at full width and depth
    on 4 × 1025 tokens, three SGD steps through B1 at width 512 and B4/B5
    at width 512 (train_phase: the gradient's per-parameter cosine and
    Δloss against the oracle-attention path, step ms, tokens/s, peak
    memory), with no plain version on a CUDA tensor meanwhile. Then the
    backward's first B4/B5 call (the last layer's) re-run on its own
    inputs (:func:`held_first_bwd`), and each grad with its columns
    256–511 zeroed in the plain version rejected."""
    with first_bwd_call() as rec, no_plain_on_cuda() as plain_calls:
        launches = train_phase(dev, "wide_heads_train", MODEL_WIDE,
                               TRAIN_TOKENS)
        torch.cuda.synchronize()
    if any(plain_calls.values()):
        raise AssertionError(f"wide training: plain versions ran on CUDA "
                             f"tensors: {plain_calls}")
    held, got, plain = held_first_bwd("wide training", rec)
    held["planted_fault_upper_half"] = upper_half_faults(
        "wide training B4/B5", got, plain, held["tol"], rel_to_max)
    emit(dict(phase="wide_heads_train_checks", plain_calls_on_cuda=plain_calls,
              last_layer_b4_b5=held))
    del rec, got, plain
    return dict(launches=launches, held=held)


def train_wide_f32_phase(dev) -> dict:
    """The wide-head model in float32 (MODEL_WIDE, ``dtype="float32"``):
    three SGD steps on 4 × 1025 tokens at full width and depth through B1
    and B4/B5 at width 512 on flash_bwd_f32.cuh's 3×TF32 kernels, the head
    dim split across a 4-CTA cluster (train_phase: the gradient's cosine
    and Δloss against the oracle-attention path, step ms, tokens/s, peak
    memory, and 48 launches of each kernel by device name, none of the
    deleted FMA kernels), the projections in full float32 (allow_tf32
    False), with no plain version on a CUDA tensor meanwhile. Then the
    backward's first B4/B5 call (the last layer's) re-run on its own
    inputs (:func:`held_first_bwd`: bitwise the main path's, within 1e-4
    of each grad's largest entry from the exact plain backward), and two
    planted faults rejected on every grad: the same call on one TF32 pass,
    and the plain backward with each grad's columns 256–511 zeroed."""
    from tpu_flash_torch.ops import flash_bwd

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train_wide_f32: the projections would run in "
                             "TF32")
    with first_bwd_call() as rec, no_plain_on_cuda() as plain_calls:
        launches = train_phase(dev, "train_wide_f32",
                               dict(MODEL_WIDE, dtype="float32"),
                               TRAIN_TOKENS, named=F32_WIDE_KERNELS)
        torch.cuda.synchronize()
    if any(plain_calls.values()):
        raise AssertionError(f"train_wide_f32: plain versions ran on CUDA "
                             f"tensors: {plain_calls}")
    held, got, plain = held_first_bwd("train_wide_f32", rec)
    one = flash_bwd._flash_bwd_kernel(*rec["args"], rec["quant"],
                                      tf32_passes=1)
    errs = {f"d{x}": rel_to_max(a_, p_) for x, a_, p_ in zip("qkv", one, plain)}
    passed = [x for x, e in errs.items() if e <= held["tol"]]
    if passed:
        raise AssertionError(f"train_wide_f32 B4/B5: planted fault "
                             f"one_tf32_pass passes the kernel-vs-plain check "
                             f"on {passed}: {errs}")
    held["planted_fault_one_tf32_pass"] = errs
    held["planted_fault_upper_half"] = upper_half_faults(
        "train_wide_f32 B4/B5", got, plain, held["tol"], rel_to_max)
    emit(dict(phase="train_wide_f32_checks", plain_calls_on_cuda=plain_calls,
              last_layer_b4_b5=held))
    del rec, got, plain, one
    return dict(launches=launches, held=held)


# The wide-head quantized path: B7 through flash_attention(q_dtype=…) and
# B6 through serving_flash_attention at the wide model's heads (4 q / 2 kv
# of 512), on e4m3, int8 and weight-only Q and int8 P·V (pv_quant), under
# the causal and local_causal (radius 512) kinds at a ragged n, each call
# held against its plain version on the call's own operands with V̂'s
# columns 256–511 hidden rejected; then timed at b 2, n 8192, dense (b·hq·d
# = 4096, the quantized headline's), gated against the matched-bit-width
# oracle on three 1024-row bands (the fp8 plain version takes seconds
# there), beside bf16 scaled_dot_product_attention at the same shape.
WIDE_QUANT_N = 1000
WIDE_QUANT_TIMED = (2, 8192)
WIDE_QUANT_BANDS = (0, 3584, 7168)
# (name, family, q_dtype, kv_dtype, kv_scale, pv_quant)
WIDE_QUANT_MODES = [
    ("serving_e4m3", "serving", "float8_e4m3fn", "float8_e4m3fn", "tensor",
     False),
    ("serving_int8", "serving", "int8", "int8", "token", False),
    ("serving_weight_only", "serving", None, "int8", "token", False),
    ("serving_pv_quant", "serving", "int8", "int8", "token", True),
    ("quant_e4m3", "quant", "float8_e4m3fn", "float8_e4m3fn", "token", False),
    ("quant_int8", "quant", "int8", "int8", "token", False),
    ("quant_weight_only", "quant", None, "int8", "token", False),
]


def wide_quant_call(family, q, k, v, q_dt, kv_dt, kv_scale, pvq, schedule,
                    radius):
    """One wide quantized mode on q, k, v: ``call()`` the public entry
    point → (o, lse); ``ops`` the kernel's operands as the entry point
    builds them, ``vi`` v̂'s index among them; ``plain(ops)`` the plain
    version and ``kernel(ops)`` the kernel's wrapper (no lse) on them."""
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    h, hkv, n, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    if family == "serving":
        kq, vq = tsa.quantize_kv_cache(k, v, kv_dt, kv_scale=kv_scale)
        sched = flash.build_schedule(schedule, n, n, 4096, 2048, radius=radius)
        ops = tsa.serving_operands(q, kq, vq, not pvq)
        mode = {"int8": "int8", None: "raw"}.get(q_dt, "fp8")
        c = tfq.f32(d ** -0.5 * flash.LOG2E)

        def call():
            return tsa.serving_flash_attention(
                q, kq, vq, q_dtype=q_dt, schedule=schedule, radius=radius,
                pv_quant=pvq, return_lse=True)

        return dict(call=call, ops=ops, vi=2, plain=lambda ops: tsa._serving_plain(
            *ops, sched, h, hkv, mode, c, pvq),
            kernel=lambda ops: tsa._serving_attention_kernel(
                *ops, sched, h, hkv, mode, c, pvq, False))
    sched = flash.build_schedule(schedule, n, n, 1024, 2048, radius=radius)
    prep = tfq.prepare_quantized(
        q, k, v, None if q_dt is None else tfq.as_dtype(q_dt),
        tfq.as_dtype(kv_dt), kv_scale == "token", d ** -0.5)
    ops = tfq.quant_operands(*prep, kv_scale == "token", True)

    def call():
        return flash.flash_attention(q, k, v, q_dtype=q_dt, kv_dtype=kv_dt,
                                     kv_scale=kv_scale, schedule=schedule,
                                     radius=radius, return_lse=True)

    return dict(call=call, ops=ops, vi=3,
                plain=lambda ops: tfq._quant_plain(*ops, sched, h, hkv,
                                                   q.dtype),
                kernel=lambda ops: tfq._quant_attention_kernel(
                    *ops, sched, h, hkv, q.dtype, False))


def wide_quant_attention_phase(dev) -> dict:
    """B6 and B7 at width 512 (see WIDE_QUANT_MODES): the public calls (the
    path, counted, no plain version on a CUDA tensor), each against its
    plain version (QUANT_TOL) with V̂'s upper half hidden rejected; the
    timed shape's serving e4m3 (B6) and end-to-end e4m3 (B7) calls gated
    against the matched oracle, timed beside their bound, plain version
    and bf16 scaled_dot_product_attention."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.bench import harness
    from tpu_flash_torch.ops.oracle import blockwise_dpa
    from tpu_flash_torch.quant import serving_attn as tsa

    hq, hkv, d = (MODEL_WIDE[k] for k in ("num_q_heads", "num_kv_heads",
                                          "head_dim"))
    gen = torch.Generator(device=dev).manual_seed(19)
    n = WIDE_QUANT_N
    q, k, v = (torch.randn(1, h, n, d, generator=gen, device=dev).bfloat16()
               for h in (hq, hkv, hkv))
    calls = {}
    kernels.reset_launches()
    with no_plain_on_cuda() as plain_calls:
        for name, fam, q_dt, kv_dt, kv_scale, pvq in WIDE_QUANT_MODES:
            for schedule, radius in (("causal", 0), ("local_causal", 512)):
                mode = wide_quant_call(fam, q, k, v, q_dt, kv_dt, kv_scale,
                                       pvq, schedule, radius)
                o, lse = mode["call"]()
                calls[f"{name}_{schedule}"] = (o.reshape(hq, n, d),
                                               lse.reshape(hq, n), mode)
        torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in (
        "serving_attention", "quant_attention")}
    if any(plain_calls.values()):
        raise AssertionError(f"wide quantized calls: plain versions ran on "
                             f"CUDA tensors: {plain_calls}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"wide quantized calls: kernel {name} never "
                                 "launched")
    rows, worst = [], {"serving": 0.0, "quant": 0.0}
    for case, (ko, kl, mode) in calls.items():
        plain, vi, ops = mode["plain"], mode["vi"], mode["ops"]
        errs = quant_errs(ko, kl, *plain(ops))
        for key, tol in QUANT_TOL.items():
            check(f"wide {case} {key}", errs[key], tol)
        fam = case.split("_")[0]
        worst[fam] = max(worst[fam], errs["o_vs_plain"], errs["lse_vs_plain"])
        hidden = ops[vi].clone()
        hidden.view(torch.uint8)[..., WIDE_UPPER] = 0
        fault = quant_errs(ko, kl, *plain((*ops[:vi], hidden, *ops[vi + 1:])))
        if all(fault[key] <= tol for key, tol in QUANT_TOL.items()):
            raise AssertionError(f"wide {case}: V̂'s upper half hidden passes "
                                 f"the kernel-vs-plain check: {fault}")
        rows.append(dict(case=case, n=n, hq=hq, hkv=hkv, d=d, tol=QUANT_TOL,
                         **errs, planted_fault_v_upper_half=fault))
    del calls

    # the timed shape: serving e4m3 (tensor K scales) and end-to-end e4m3
    b, nt = WIDE_QUANT_TIMED
    q, k, v = (torch.randn(b, h, nt, d, generator=gen, device=dev).bfloat16()
               for h in (hq, hkv, hkv))
    peaks = harness.device_peaks(dev)
    flops = harness.attention_flops(b, hq, nt, nt, d)
    library = functools.partial(sdpa, q, k, v, False)
    names = device_kernel_names(library)
    backend = next((tag for key, tag in (
        ("flash", "flash"), ("fmha", "efficient"), ("cudnn", "cudnn"))
        if any(key in n_.lower() for n_ in names)), "math")
    library_ms = cuda_ms(library)
    timed = {}
    for name, fam, kv_scale in (("serving_e4m3", "serving", "tensor"),
                                ("quant_e4m3", "quant", "tensor")):
        mode = wide_quant_call(fam, q, k, v, QB_FP8, QB_FP8, kv_scale, False,
                               "dense", 0)
        ops = mode["ops"]
        o = mode["call"]()[0]
        cache = (tsa.quantize_kv_cache(k, v, QB_FP8, kv_scale=kv_scale)
                 if fam == "serving" else None)
        qf, kf, vf = qb_matched(q, k, v, QB_FP8, QB_FP8, kv_scale, cache)
        gate = 0.0
        for s0 in WIDE_QUANT_BANDS:
            want, _ = blockwise_dpa(qf[:, :, s0:s0 + 1024], kf, vf, scale=1.0,
                                    chunk=2048)
            gate = max(gate, max_err(o[:, :, s0:s0 + 1024], want))
        del qf, kf, vf, want
        check(f"wide timed {name} vs the matched oracle", gate,
              TOL_QUANT_GATE)
        # q and o in bf16, the cache at one byte, the fp32 scales
        nbytes = (2 * 2 * b * hq * nt * d + 2 * b * hkv * nt * d
                  + 4 * sum(t.numel() for t in ops if t is not None
                            and t.dtype == torch.float32))
        timed[name] = dict(
            batch=b, n=nt, hq=hq, hkv=hkv, d=d, schedule="dense",
            kv_scale=kv_scale, gate_rows=[[s, s + 1024] for s in
                                          WIDE_QUANT_BANDS],
            gate_max_abs_err=gate, gate_tol=TOL_QUANT_GATE,
            ms=cuda_ms(lambda: mode["kernel"](ops), iters=10),
            call_ms=cuda_ms(lambda: mode["call"](), iters=10),
            plain_ms=cuda_ms(lambda: mode["plain"](ops), iters=1, warmup=0),
            library_ms=library_ms, library_backend=backend,
            library_kernels=[n_[:80] for n_ in names],
            **harness.roofline(flops / 2, flops / 2, nbytes, peaks, "fp8",
                               "bf16"))
        timed[name]["share_of_bound"] = (timed[name]["bound_ms"]
                                         / timed[name]["ms"])
        del o, ops, mode
        torch.cuda.empty_cache()
    emit(dict(phase="wide_quant_attention", launches=launches,
              plain_calls_on_cuda=plain_calls, kernels_vs_plain=rows,
              timed=timed))
    return dict(launches=launches, worst=worst, timed=timed)


# The quant_bands phase: the quantized route on the band, circulant and
# block-diagonal kinds at the baseline's shapes (BASELINE.json: windowed_fa
# window 256 at seqlen 4k with FP8 Q/K/V; circulant_fa 8k with an INT8 KV
# cache; the quantized headline's b 4, h 8, n 8192, d 128), each row a
# public call gated against its matched-bit-width oracle (TOL_QUANT_GATE)
# and shown to miss the full-history oracle by SEPARATION times more; then
# B6/B7 against their plain versions on every kind × Q mode × maximum at
# QB_SMALL, planted faults rejected; then rows a–e timed.
QB_FP8 = "float8_e4m3fn"
QB_SMALL = dict(n=2048, radius=8, section=100)
# The kernels (the reference's as the port's) round P to bf16 for the P·V
# product and sum l from the float32 P, so a row whose softmax mass sits on
# one key carries that rounding in full: o moves by up to 2⁻⁸ of a value of
# V. The dense headline averages it away over thousands of keys; a band's
# first rows see a handful (B6 local_causal, 16/8 heads at n 8192: 0.0127
# against the 1e-2 contract, PERF.md §6; the reference's kernel rounds the
# same way). So a band row's gate is the contract plus that bound,
# 2⁻⁸ · max |V|.
P_ROUNDING = 2.0 ** -8
# the int8 P·V product (pv_quant) rounds P to multiples of 1/127, which
# moves o by ~4e-2 on these inputs in the reference as in the port (the
# plain version matches the reference there, tests/test_torch_quant_bands.py):
# the reference's own bound for it against the f32 oracle
# (tests/test_serving_attn.py:99-113)
TOL_PV_QUANT_GATE = 0.08


def qb_pairs(schedule: str, n: int, radius: int = 0, section: int = 0) -> int:
    """(query, key) pairs a head attends under the schedule, n queries:
    what this run's kernel must compute (the circulant's over its halo)."""
    i = np.arange(n)
    if schedule == "local":
        return int((np.minimum(n - 1, i + radius) - np.maximum(0, i - radius)
                    + 1).sum())
    if schedule == "local_causal":
        return int((i - np.maximum(0, i - radius) + 1).sum())
    if schedule == "circulant":
        return n * (2 * radius + 1)
    return int((np.minimum(n, (i // section + 1) * section)
                - i // section * section).sum())


def qb_matched(q, k, v, q_dtype, kv_dtype, kv_scale, cache=None):
    """Inputs of the matched-bit-width oracle, K/V expanded to q's heads:
    Q quantized per token as the call quantizes it (e4m3 or int8; the
    weight-only mode's Q as it is): scaled in float32 first
    (quantized_flash_attention's host), or scaled after (serving's staging,
    with a ``cache``); K per token or per tensor and V per channel (or the
    given cache), dequantized."""
    from tpu_flash_torch.quant import qarray

    scale = q.shape[-1] ** -0.5
    qf = q.float() if cache is not None else q.float() * scale
    if q_dtype is not None:
        qf = qarray.dequantize(qarray.quantize(qf, q_dtype, axis=-1))
    if cache is not None:
        qf = qf * scale
    else:
        k_axis = -1 if kv_scale == "token" else (-2, -1)
        cache = (qarray.quantize(k.float(), kv_dtype, axis=k_axis),
                 qarray.quantize(v.float(), kv_dtype, axis=-2))
    g = q.shape[1] // k.shape[1]
    kf, vf = (qarray.dequantize(a).repeat_interleave(g, 1) for a in cache)
    return qf, kf, vf


def qb_gate(o, inputs, mask: dict, full: dict, tol: float) -> dict:
    """max |o − oracle| against the matched oracle under the schedule's
    mask and against the full-history one; the first must be within
    ``tol``, the second SEPARATION times larger."""
    from tpu_flash_torch.ops.oracle import blockwise_dpa

    want, _ = blockwise_dpa(*inputs, scale=1.0, chunk=2048, **mask)
    err = max_err(o, want)
    del want
    hist, _ = blockwise_dpa(*inputs, scale=1.0, chunk=2048, **full)
    miss = max_err(o, hist)
    return dict(max_abs_err=err, tol=tol, full_history_err=miss,
                separation=miss / max(err, 1e-30))


def qb_library(schedule, q, k, v, radius=0, section=0):
    """One library call of the same function in bf16 (no library call
    takes a quantized cache): aten._flash_attention_forward with
    window_size_left/_right for the bands, scaled_dot_product_attention
    over the sequence cut into its sections for the block-diagonal kind,
    and under the boolean circulant mask for the circulant. Returns the
    call and its name."""
    b, h, n, d = q.shape
    if schedule == "block":
        cut = [x.reshape(b, x.shape[1] * (n // section), section, d)
               for x in (q, k, v)]
        return (lambda: sdpa(*cut, False),
                "scaled_dot_product_attention over n/section sections")
    if schedule == "circulant":
        mask = circulant_mask(n, radius, q.device)
        return (lambda: sdpa(q, k, v, False, mask),
                "scaled_dot_product_attention under the circulant mask")
    causal = schedule == "local_causal"
    g = h // k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
    return (lambda: torch.ops.aten._flash_attention_forward(
        qt, kt, vt, None, None, n, n, 0.0, causal, False,
        window_size_left=radius, window_size_right=0 if causal else radius),
        f"aten._flash_attention_forward(window_size_left={radius}, "
        f"window_size_right={0 if causal else radius}), K/V expanded")


def qb_small_checks(dev) -> tuple:
    """B6 and B7 against their plain versions at QB_SMALL (16/8 heads,
    d 128) on every kind, Q mode (bf16 weight-only, int8, e4m3) and
    maximum, B6's staged Q bytes equal; each planted fault of the kind
    (bench/quant_bands.py) fails QUANT_TOL. Returns (rows, worst error by
    family)."""
    from tpu_flash_torch.bench.quant_bands import band_case, faults

    gen = torch.Generator(device=dev).manual_seed(12)
    n, radius, section = (QB_SMALL[key] for key in ("n", "radius", "section"))
    q, k, v = (torch.randn(1, h, n, 128, generator=gen, device=dev).bfloat16()
               for h in (16, 8, 8))
    rows, worst = [], {"serving": 0.0, "quant": 0.0}
    modes = [(None, "int8", "token"), ("int8", "int8", "token"),
             (QB_FP8, QB_FP8, "tensor")]
    for schedule in ("local", "local_causal", "circulant", "block"):
        extra = dict(radius=radius) if schedule != "block" else dict(
            section=section)
        for family in ("serving", "quant"):
            for q_dt, kv_dt, kv_scale in modes:
                for bound in (True, False):
                    kernel, plain, staged = band_case(
                        family, schedule, q, k, v, q_dtype=q_dt,
                        kv_dtype=kv_dt, kv_scale=kv_scale, bound_max=bound,
                        **extra)
                    ko, kl = kernel()
                    errs = quant_errs(ko, kl, *plain())
                    name = (f"{family} {schedule} {q_dt or 'weight_only'} "
                            f"{'bound' if bound else 'exact'}")
                    for key, tol in QUANT_TOL.items():
                        check(f"quant_bands {name} {key}", errs[key], tol)
                    worst[family] = max(worst[family], errs["o_vs_plain"],
                                        errs["lse_vs_plain"])
                    row = dict(case=name, **errs)
                    if staged is not None:
                        row["staged_q_bytes_equal"] = staged()
                        if not row["staged_q_bytes_equal"]:
                            raise AssertionError(f"quant_bands {name}: "
                                                 "staged Q differs")
                    if q_dt == QB_FP8 and bound:
                        row["planted_faults"] = {}
                        for fault in faults(family, schedule):
                            ferrs = quant_errs(ko, kl, *plain(fault))
                            if all(ferrs[key] <= tol
                                   for key, tol in QUANT_TOL.items()):
                                raise AssertionError(
                                    f"quant_bands {name}: planted fault "
                                    f"{fault} passes: {ferrs}")
                            row["planted_faults"][fault] = ferrs
                    rows.append(row)
                    del ko, kl
    return rows, worst


QB_R = (SLIDING_WINDOW - 1) // 2
# the rows: (row, name, shape (b, hq, hkv, n, d), schedule, radius or
# section, q_dtype, kv_dtype, kv_scale, entry (serving_flash_attention:
# "serving", B6; the flash wrappers: "quant", B7, or "routed", B6 through
# the d <= 64 rule), oracle mask, full-history mask, timed). a: the quantized headline's shape
# under the sliding model's band; b: the baseline's window 256 (257, odd)
# at 4k; c: its circulant 8k with an int8 cache; d: block-diagonal; e: the
# canonical model's attention (16/8 heads) with the sliding window; f: the
# d <= 64 route (B6 at B8's shape), f': the circulant stays on B7
QB_ROWS = [
    ("a", "sliding_causal_fp8", (4, 8, 8, 8192, 128), "local_causal",
     QB_R, QB_FP8, QB_FP8, "tensor", "quant",
     dict(window_size=SLIDING_WINDOW, causal=True), dict(causal=True),
     True),
    ("a", "sliding_causal_int8", (4, 8, 8, 8192, 128), "local_causal",
     QB_R, "int8", "int8", "token", "quant",
     dict(window_size=SLIDING_WINDOW, causal=True), dict(causal=True),
     True),
    ("b", "sliding_w257_fp8", (4, 8, 8, 4096, 128), "local", 128, QB_FP8,
     QB_FP8, "token", "quant", dict(window_size=257), {}, True),
    ("c", "circulant_int8_weight_only", (4, 8, 8, 8192, 128),
     "circulant", QB_R, None, "int8", "token", "quant",
     dict(window_size=SLIDING_WINDOW, wrap=True), {}, True),
    ("c", "circulant_int8", (4, 8, 8, 8192, 128), "circulant", QB_R,
     "int8", "int8", "token", "quant",
     dict(window_size=SLIDING_WINDOW, wrap=True), {}, True),
    ("d", "block512_fp8", (4, 8, 8, 8192, 128), "block", 512, QB_FP8,
     QB_FP8, "token", "quant", dict(block_size=512), {}, True),
    ("e", "serving_local_causal_fp8_gqa", (1, 16, 8, 8192, 128),
     "local_causal", QB_R, QB_FP8, QB_FP8, "token", "serving",
     dict(window_size=SLIDING_WINDOW, causal=True), dict(causal=True),
     True),
    ("e", "serving_local_causal_int8_pv_quant", (1, 16, 8, 8192, 128),
     "local_causal", QB_R, "int8", "int8", "token", "serving",
     dict(window_size=SLIDING_WINDOW, causal=True), dict(causal=True),
     True),
    ("f", "sliding_causal_d64_fp8", (1, 16, 8, 1000, 64), "local_causal",
     128, QB_FP8, QB_FP8, "token", "routed",
     dict(window_size=257, causal=True), dict(causal=True), False),
    ("f", "block250_d64_fp8", (1, 16, 8, 1000, 64), "block", 250, QB_FP8,
     QB_FP8, "token", "routed", dict(block_size=250), {}, False),
    ("f'", "circulant_d64_fp8", (1, 16, 8, 1000, 64), "circulant", 128,
     QB_FP8, QB_FP8, "token", "quant", dict(window_size=257, wrap=True),
     {}, False),
]

# the kernels line's rows of the phase: (kernel, family, label, row,
# the TPU kernel it replaces)
QB_KERNEL_ROWS = [
    ("quant_attention", "quant", "B7 local_causal band, fp8",
     "sliding_causal_fp8", "tpu_flash/quant/flash_q.py:136"),
    ("quant_attention", "quant", "B7 local band, fp8", "sliding_w257_fp8",
     "tpu_flash/quant/flash_q.py:136"),
    ("quant_attention", "quant", "B7 circulant, int8", "circulant_int8",
     "tpu_flash/quant/flash_q.py:136"),
    ("quant_attention", "quant", "B7 block-diagonal, fp8", "block512_fp8",
     "tpu_flash/quant/flash_q.py:136"),
    ("serving_attention", "serving", "B6 local_causal band, fp8, GQA",
     "serving_local_causal_fp8_gqa", "tpu_flash/quant/serving_attn.py:59"),
]


def quant_bands_phase(dev):
    """Rows a–f′ through the public entry points, each counted apart
    (every row must launch its kernel, f′ B7 and not B6), gated against
    the matched oracle with its separation from the full-history one (the
    gated call takes and returns float32, whose o the kernels write
    unrounded: a bf16 o of a row that sees a few keys has an ulp of 2⁻⁶
    at |o| ≥ 2, near the gate itself); B6/B7
    against their plain versions (qb_small_checks); rows a–e timed: the
    kernel alone (a CUDA graph of 20 calls, bench/harness.py:device_ms), the
    public call, the plain version at the same shape (also held to
    QUANT_TOL there), the bound over the visible pairs and the library's
    bf16 call."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.bench.harness import device_ms, device_peaks
    from tpu_flash_torch.bench.harness import roofline as hroofline
    from tpu_flash_torch.bench.quant_bands import band_case
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.quant import serving_attn as tsa

    gen = torch.Generator(device=dev).manual_seed(13)

    def inputs(b, hq, hkv, n, d):
        return [torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16()
                for h in (hq, hkv, hkv)]

    peaks = device_peaks(dev)
    runs, timed, worst = [], {}, {"serving": 0.0, "quant": 0.0}
    for (row_id, name, shape, schedule, extra, q_dt, kv_dt, kv_scale,
         entry, mask, full, time_it) in QB_ROWS:
        b, hq, hkv, n, d = shape
        family = "quant" if entry == "quant" else "serving"
        q, k, v = inputs(b, hq, hkv, n, d)
        radius = extra if schedule != "block" else 0
        section = extra if schedule == "block" else 0
        pvq = name.endswith("pv_quant")
        # the cache the serving kernel reads (the d <= 64 route quantizes
        # K/V the same way inside the call)
        cache = (None if entry == "quant" else
                 tsa.quantize_kv_cache(k, v, kv_dt, kv_scale=kv_scale))
        if entry == "serving":

            def call(q, k, v):
                return tsa.serving_flash_attention(
                    q, *cache, q_dtype=q_dt, schedule=schedule,
                    radius=radius, section=section, pv_quant=pvq,
                    bound_max=False if pvq else None)
        else:
            window = 2 * radius + 1
            kw = dict(q_dtype=q_dt, kv_dtype=kv_dt, kv_scale=kv_scale)
            call = {
                "local_causal": lambda q, k, v: flash.sliding_fa(
                    q, k, v, window, causal=True, **kw),
                "local": lambda q, k, v: flash.sliding_fa(q, k, v, window,
                                                          **kw),
                "circulant": lambda q, k, v: flash.circulant_fa(
                    q, k, v, window, **kw),
                "block": lambda q, k, v: flash.block_fa(q, k, v, section,
                                                        **kw),
            }[schedule]
        kernels.reset_launches()
        o = call(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        launches = {key: kernels.LAUNCHES[key] for key in (
            "serving_attention", "quant_attention")}
        want = f"{family}_attention"
        if launches[want] <= 0 or (row_id == "f'" and
                                   launches["serving_attention"]):
            raise AssertionError(f"quant_bands {name}: launches {launches}")
        matched = qb_matched(q, k, v, q_dt, kv_dt, kv_scale, cache)
        gate = qb_gate(o, matched, mask, full, TOL_PV_QUANT_GATE if pvq else
                       TOL_QUANT_GATE + P_ROUNDING * float(
                           matched[2].abs().max()))
        del matched
        check(f"quant_bands {name} gate", gate["max_abs_err"], gate["tol"])
        if gate["separation"] < SEPARATION:
            raise AssertionError(f"quant_bands {name}: the full-history "
                                 f"oracle is not separated: {gate}")
        row = dict(row=row_id, case=name, schedule=schedule, radius=radius,
                   section=section, shape=dict(zip("b hq hkv n d".split(),
                                                   shape)),
                   q_dtype=q_dt, kv_dtype=kv_dt, kv_scale=kv_scale,
                   launches=launches, **gate)
        del o
        if time_it:
            flat = [x.reshape(1, -1, n, d) for x in (q, k, v)]
            kernel, plain, _ = band_case(
                family, schedule, *flat, q_dtype=q_dt, kv_dtype=kv_dt,
                kv_scale=kv_scale, bound_max=not pvq, radius=radius,
                section=section, pv_quant=pvq)
            errs = quant_errs(*kernel(), *plain())
            for key, tol in QUANT_TOL.items():
                check(f"quant_bands {name} full size {key}", errs[key], tol)
            worst[family] = max(worst[family], errs["o_vs_plain"],
                                errs["lse_vs_plain"])
            pairs = b * hq * qb_pairs(schedule, n, radius, section)
            lib_fn, lib_name = qb_library(schedule, q, k, v, radius, section)
            # bytes: q (B6: bf16; B7: bf16, or 8-bit q̂ and its float32
            # row factors) and o in bf16, K̂/V̂ at one byte (the
            # circulant's with its halo) and their float32 scales
            n_kv = n + 2 * radius if schedule == "circulant" else n
            q8 = family == "quant" and q_dt is not None
            sk = n_kv if kv_scale == "token" else 1
            nbytes = (b * hq * n * (d + 4 if q8 else 2 * d)
                      + 2 * b * hq * n * d + 2 * b * hkv * n_kv * d
                      + 4 * b * hkv * (sk + d + 1))
            qk = "bf16" if q_dt is None else "int8" if q_dt == "int8" else "fp8"
            row["device_kernels"] = quant_kernel_names()[QB_NAMED[name]]
            row.update(
                kernel_vs_plain=errs, ms=device_ms(lambda: kernel(False)),
                call_ms=cuda_ms(lambda: call(q, k, v)),
                plain_ms=cuda_ms(plain, iters=2, warmup=1),
                library=lib_name, library_ms=device_ms(lib_fn),
                visible_pairs=pairs,
                **hroofline(2 * d * pairs, 2 * d * pairs, nbytes, peaks, qk,
                            "int8" if pvq else "bf16"))
            row["tflops"] = 4 * d * pairs / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            timed[name] = row
        runs.append(row)
        del q, k, v, cache
        torch.cuda.empty_cache()
    small, small_worst = qb_small_checks(dev)
    for fam in worst:
        worst[fam] = max(worst[fam], small_worst[fam])
    emit(dict(phase="quant_bands", rows=runs, kernels_vs_plain=small,
              small_shape=QB_SMALL))
    return dict(timed=timed, worst=worst,
                launches={r["case"]: r["launches"] for r in runs})


def held_engine_run(phase: str, run, tol: float) -> dict:
    """Check a serving run of engine_phase and print its line: every
    request finished with NEW_TOKENS tokens and finite logprobs; B1, and
    B2's split route with B3's append fused (decode: no B3 launch of its
    own), launched; the teacher-forced drift of request 0 within ``tol``.
    Returns the run's launch counts of those kernels."""
    done, step_ms = run["done"], run["step_ms"]
    if sorted(done) != list(range(N_REQUESTS)):
        raise AssertionError(f"{phase}: finished {sorted(done)}")
    for f in done.values():
        if f.reason != "length" or len(f.new_tokens) != NEW_TOKENS:
            raise AssertionError(f"{phase}: request {f.rid}: {f.reason}, "
                                 f"{len(f.new_tokens)} tokens")
        if not all(np.isfinite(f.logprobs)):
            raise AssertionError(f"{phase}: request {f.rid}: non-finite "
                                 "logprobs")
    launches = {k: run["launches"][k] for k in (
        "flash_fwd", "paged_attention_split", "paged_append_fused")}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{phase}: kernel {name} never launched")
    drift = teacher_forced_drift(run["params"], run["mcfg"], done[0])
    check(f"{phase}: teacher-forced logprob drift", drift, tol)
    decode_ms = float(np.median(step_ms[1:]))
    emit(dict(
        phase=phase, requests=N_REQUESTS, prompt_len=PROMPT_LEN,
        new_tokens=NEW_TOKENS, cache=run["cache"], finished=len(done),
        finish_reasons=sorted({f.reason for f in done.values()}),
        new_tokens_per_request=sorted({len(f.new_tokens) for f in done.values()}),
        steps=len(step_ms),
        launches=launches, teacher_forced_drift=drift, drift_tol=tol,
        # step 1 admits and prefills all requests, then decodes once
        prefill_ms_per_request=(step_ms[0] - decode_ms) / N_REQUESTS,
        decode_ms_per_step=decode_ms,
        warm_e2e_tok_s=N_REQUESTS * NEW_TOKENS / run["wall_s"],
        wall_s=run["wall_s"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    ))
    return launches


def teacher_forced_drift(params, mcfg, f) -> float:
    """max |engine logprob − logprob of a full forward over the stream|."""
    from tpu_flash_torch.models import transformer as tfm

    toks = torch.tensor([f.tokens[:-1]], device=params["embed"].device)
    n_new = len(f.new_tokens)
    with torch.no_grad():
        logits = tfm.forward(params, toks, mcfg)[0, -n_new:]
    lp = torch.log_softmax(logits, dim=-1)
    ref = lp.gather(1, torch.tensor(f.new_tokens, device=lp.device)[:, None])[:, 0]
    got = torch.tensor(f.logprobs, device=lp.device)
    return float((ref - got).abs().max())


def sliding_prompts(vocab: int):
    """The sliding phase's prompts from a seed: N_LONG long ones (chunked),
    then N_SHORT short ones (prefilled whole); no length is a page
    multiple."""
    rng = np.random.default_rng(7)
    lens = ([int(n) for n in rng.integers(*SLIDING_LONG, N_LONG)]
            + [int(n) for n in rng.integers(*SLIDING_SHORT, N_SHORT)])
    lens = [n + 1 if n % CACHE["page_size"] == 0 else n for n in lens]
    return [rng.integers(1, vocab - 1, n).tolist() for n in lens]


def serve(eng, reqs, warm):
    """Run ``warm`` to the end, then ``reqs`` with the launch counts reset:
    returns the finished requests by rid, the launches, the wall time, the
    host-clock ms of each decode (``_decode``) and each prefill chunk
    (``_advance_prefill`` that ran one), each ending in a synchronise, and
    each request's first-token logits (its last prompt position)."""
    from tpu_flash_torch import kernels

    first, times = {}, {"decode": [], "chunk": []}
    start_running = eng._start_running

    def keep(req, slot, pages, logits):
        first[req.rid] = logits[0].float().clone()
        start_running(req, slot, pages, logits)

    def timed(name, fn):
        def run():
            busy = name != "chunk" or bool(eng.prefilling)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if busy:
                times[name].append((time.perf_counter() - t0) * 1e3)
        return run

    eng._start_running = keep
    eng._decode = timed("decode", eng._decode)
    eng._advance_prefill = timed("chunk", eng._advance_prefill)
    for r in warm:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    n0 = len(eng.finished)
    times["decode"].clear()
    times["chunk"].clear()
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    return dict(done={f.rid: f for f in eng.finished[n0:]},
                launches=dict(kernels.LAUNCHES), wall_s=wall, first=first,
                **times)


def sliding_serve_phase(dev):
    """The sliding-window serving path at full width: engine A (chunked
    prefill in chunks of SLIDING_CHUNK, pipelined decode) serves 12 long and
    4 short requests; its streams are held against a teacher-forced sliding
    forward, which a full-history forward must miss; engine B (whole
    prompts) serves the 12 long prompts, and each one's last-prompt-position
    logits are held against engine A's; engine C does as B under the norm
    bound (``prefill_bound_max``), held against B."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    mcfg = tfm.ModelConfig(**MODEL, attention="sliding", window=SLIDING_WINDOW)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = sliding_prompts(mcfg.vocab_size)
    hot = len(prompts) - 1

    def reqs(rids):
        return [Request(rid=i, prompt=prompts[i], max_new_tokens=NEW_TOKENS,
                        temperature=0.7 if i == hot else 0.0,
                        top_k=50 if i == hot else 0,
                        top_p=0.9 if i == hot else 1.0) for i in rids]

    warm = [Request(rid=10_000, prompt=prompts[0][:1100], max_new_tokens=4)]
    eng_a = Engine(params, mcfg, CacheConfig(**CACHE), EngineConfig(
        max_batch=MAX_BATCH, chunk_size=SLIDING_CHUNK, pipelined_decode=True))
    a = serve(eng_a, reqs(range(len(prompts))), warm)
    del eng_a
    done = a["done"]
    if sorted(done) != list(range(len(prompts))):
        raise AssertionError(f"sliding: finished {sorted(done)}")
    for f in done.values():
        if f.reason != "length" or len(f.new_tokens) != NEW_TOKENS:
            raise AssertionError(f"sliding request {f.rid}: {f.reason}, "
                                 f"{len(f.new_tokens)} tokens")
        if not all(np.isfinite(f.logprobs)):
            raise AssertionError(f"sliding request {f.rid}: non-finite")
    for name in ("flash_fwd", "paged_attention_split",
                 "paged_attention_shared"):
        if a["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "sliding engine run")
    # every chunked (long, greedy) stream against a sliding forward, and
    # against a full-history one, which the same check must reject
    drifts = [teacher_forced_drift(params, mcfg, done[i]) for i in range(N_LONG)]
    full = tfm.ModelConfig(**MODEL)
    full_drifts = [teacher_forced_drift(params, full, done[i])
                   for i in range(N_LONG)]
    drift, full_history = max(drifts), max(full_drifts)
    check("sliding teacher-forced drift", drift, TOL_LOGPROB)
    if not full_history > TOL_LOGPROB:
        raise AssertionError(f"a full-history forward passes the drift check "
                             f"({full_history}): it cannot see the band")

    # engine B prefills the long prompts whole; engine C too, under the
    # norm bound (prefill_bound_max: a tolerance contract)
    unchunked = {}
    for name, bound in (("exact", False), ("bound", True)):
        eng = Engine(params, mcfg, CacheConfig(**CACHE), EngineConfig(
            max_batch=MAX_BATCH, prefill_bound_max=bound))
        unchunked[name] = serve(eng, reqs(range(N_LONG)), [Request(
            rid=10_000, prompt=prompts[-1], max_new_tokens=4)])
        del eng
        if sorted(unchunked[name]["done"]) != list(range(N_LONG)):
            raise AssertionError(f"unchunked engine ({name}): finished "
                                 f"{sorted(unchunked[name]['done'])}")
        if unchunked[name]["launches"]["flash_fwd"] <= 0:
            raise AssertionError("flash_fwd never launched in the unchunked "
                                 f"run ({name})")
    b, c = unchunked["exact"], unchunked["bound"]

    def dlogits(x, y):
        return max(float((x["first"][i] - y["first"][i]).abs().max())
                   for i in range(N_LONG))

    def same(x, y, first=False):
        return sum((x["done"][i].new_tokens[0] == y["done"][i].new_tokens[0])
                   if first else (x["done"][i].tokens == y["done"][i].tokens)
                   for i in range(N_LONG))

    chunked_vs_whole = dlogits(a, b)
    bound_vs_exact = dlogits(c, b)
    check("chunked vs unchunked last-prompt logits", chunked_vs_whole,
          TOL_LOGPROB)
    check("norm-bound vs exact-max prefill last-prompt logits",
          bound_vs_exact, TOL_LOGPROB)
    decode_ms = float(np.median(a["decode"]))
    row = dict(
        phase="sliding_serve", window=SLIDING_WINDOW, chunk=SLIDING_CHUNK,
        cache=CACHE["dtype"], requests=len(prompts), finished=len(done),
        prompt_lens=[len(p) for p in prompts], new_tokens=NEW_TOKENS,
        chunks=len(a["chunk"]), launches=a["launches"],
        teacher_forced_drift=drift, full_history_drift=full_history,
        full_history_drift_min=min(full_drifts),
        drift_tol=TOL_LOGPROB, chunked_vs_unchunked_logits=chunked_vs_whole,
        identical_greedy_streams=f"{same(a, b)}/{N_LONG}",
        identical_first_tokens=f"{same(a, b, True)}/{N_LONG}",
        bound_vs_exact_prefill_logits=bound_vs_exact,
        bound_identical_greedy_streams=f"{same(c, b)}/{N_LONG}",
        unchunked_launches=b["launches"], bound_launches=c["launches"],
        decode_ms_per_step=decode_ms,
        decode_ms_range=[min(a["decode"]), max(a["decode"])],
        prefill_ms_per_chunk=float(np.median(a["chunk"])),
        prefill_chunk_ms_range=[min(a["chunk"]), max(a["chunk"])],
        warm_e2e_tok_s=len(prompts) * NEW_TOKENS / a["wall_s"],
        wall_s=a["wall_s"], unchunked_wall_s=b["wall_s"])
    emit(row)
    return dict(launches=a["launches"], bound_launches=c["launches"])


def sliding_kernels_phase(dev):
    """B1 (band, norm bound) and B2 (band start, positions, visible
    lengths, empty prefix; the pipelined decode) against their plain
    versions at the sliding path's shapes, timed beside their bounds and,
    for B1, the library's attention under the same mask. B2's chunk
    prefix on its two routes (shared table, split), the pipelined decode
    as one fused call, each on int8, int4 and fp8 pages; each B2 call
    twice, bitwise equal; a planted fault (a page of the walk hidden)
    rejected."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash, paged

    gen = torch.Generator(device=dev).manual_seed(8)
    hq, hkv = 16, 8
    r = (SLIDING_WINDOW - 1) // 2
    rows, timed = [], {}
    worst = {"flash_fwd": 0.0, "paged_attention_split": 0.0,
             "paged_attention_shared": 0.0}

    def held(kernel, name, got, want, tol):
        (ko, kl), (po, pl) = got, want
        errs = dict(o_vs_plain=max_err(ko, po), lse_vs_plain=max_err(kl, pl))
        check(f"{name} o vs plain", errs["o_vs_plain"], tol)
        check(f"{name} lse vs plain", errs["lse_vs_plain"], TOL_LSE)
        worst[kernel] = max(worst[kernel], *errs.values())
        row = dict(kernel=kernel, case=name, tol=tol, tol_lse=TOL_LSE, **errs)
        rows.append(row)
        return row

    # B1: (name, schedule, n, d, bound, dtype, timed as)
    b1_cases = [
        ("band_causal_2048", "local_causal", 2048, 128, False, torch.bfloat16,
         "band"),
        ("band_1000", "local", 1000, 128, None, torch.bfloat16, None),
        ("bound_d64_dense_1024", "dense", 1024, 64, True, torch.bfloat16,
         "bound"),
        ("bound_d64_dense_f32_1000", "dense", 1000, 64, True, torch.float32,
         None),
    ]
    for name, schedule, n, d, bound, dt, tag in b1_cases:
        q = torch.randn(1, hq, n, d, generator=gen, device=dev).to(dt)
        k = torch.randn(1, hkv, n, d, generator=gen, device=dev).to(dt)
        v = torch.randn(1, hkv, n, d, generator=gen, device=dev).to(dt)
        radius = r if schedule != "dense" else 0
        sched = flash.build_schedule(schedule, n, n, 512, 1024, radius=radius)
        if bound is None:
            bound = flash.auto_bound_max(sched)
        qf = (q.float() * (d ** -0.5 * flash.LOG2E)).to(dt)[0]
        args = (qf, k[0], v[0], sched, hq, hkv)
        row = held("flash_fwd", name,
                   flash._flash_fwd_kernel(*args, True, bound),
                   flash._flash_fwd_plain(*args, bound),
                   TOL_BF16 if dt == torch.bfloat16 else TOL_F32)
        row.update(schedule=schedule, n=n, d=d, bound_max=bound,
                   dtype=str(dt).replace("torch.", ""))
        if tag is None:
            continue
        pos = torch.arange(n, device=dev)
        mask = None
        if schedule != "dense":
            mask = (pos[:, None] - pos[None, :]).abs() <= radius
            if schedule == "local_causal":
                mask &= pos[None, :] <= pos[:, None]
        pairs = (n * n if schedule == "dense"
                 else band_pairs(n, radius, schedule == "local_causal"))
        esz = 2 if dt == torch.bfloat16 else 4
        nbytes = esz * (2 * hq * n * d + 2 * hkv * n * d) + 4 * hq * n
        # the kernel alone (the norm bound's key norms computed before it,
        # and timed with it apart), and the public call
        kmax = flash.key_norm_max(args[1]) if bound else None
        row.update(ms=device_ms(lambda: flash._flash_fwd_kernel(
                       *args, True, bound, kmax)),
                   call_ms=cuda_ms(lambda: flash._flash_fwd_kernel(*args, True,
                                                                    bound)),
                   plain_ms=cuda_ms(lambda: flash._flash_fwd_plain(*args, bound),
                                    iters=5),
                   library_ms=device_ms(lambda: sdpa(q, k, v, False, mask)),
                   library_call_ms=cuda_ms(lambda: sdpa(q, k, v, False, mask)),
                   pairs=pairs, **roofline(4 * d * hq * pairs, nbytes, dt))
        if bound:
            row["with_key_norms_ms"] = device_ms(
                lambda: flash._flash_fwd_kernel(*args, True, bound))
        timed[tag] = row

    # B2 at the chunk-prefix shape: 512 lanes of one slot (a shared table),
    # positions 1536..2047 against a 1536-token prefix, radius 512; slot 1
    # holds nothing (a first chunk's empty prefix). The shared-table route
    # (what prefill_chunk takes) against the one-split walk; the split
    # route against the plain version under its plan. On the int8 cache
    # every case; on int4 and fp8 pages the chunk prefix itself
    lanes, g, d = SLIDING_CHUNK, hq // hkv, 128
    qg = (torch.randn(lanes, hkv, g, d, generator=gen, device=dev)
          * (d ** -0.5 * flash.LOG2E)).bfloat16()
    pos = torch.arange(1536, 1536 + lanes, dtype=torch.int32, device=dev)
    steps = min(32, -(-(r + 1) // CACHE["page_size"]) + 1)
    kern, plain = paged._paged_attention_kernel, paged._paged_attention_plain

    def b2(fn, slots, len_add=0, q=qg, c=None, tables=None, **kw):
        if fn is kern:  # the split plan's walk, as paged_attention's
            kw["walk"] = paged.plan_pages(c.config, r)
        return fn(*_b2_args(q, c, slots, len_add, steps, tables=tables),
                  radius=r, page_type=c.config.page_type, **kw)

    for dtype in QUANT_PAGES:
        cache = _decode_cache(dtype, [1536, 1], dev, 9, n_pages=32)
        cache.lengths[1] = 0
        tag = "" if dtype == "int8" else f"_{dtype}"
        cases = (("chunk_prefix_512_lanes", 0),) + (
            (("empty_prefix", 1),) if dtype == "int8" else ())
        for name, slot in cases:
            slots = torch.full((lanes,), slot, dtype=torch.int32, device=dev)
            plan = _card_plan(qg, cache, radius=r)
            calls = dict(
                shared=lambda: b2(kern, slots, c=cache, positions=pos,
                                  shared_page_table=True),
                split=lambda: b2(kern, slots, c=cache, positions=pos))
            wants = dict(shared=b2(plain, slots, c=cache, positions=pos),
                         split=b2(plain, slots, c=cache, positions=pos,
                                  split_pages=plan))
            got = {}
            for route, call in calls.items():
                got[route] = _bitwise_repeat(f"B2 {route} {name}{tag}", call)
                row = held(f"paged_attention_{route}", f"{name}_{route}{tag}",
                           got[route], wants[route], TOL_BF16)
            if slot == 1:
                for route, (o, lse) in got.items():
                    if not (torch.isneginf(lse).all() and (o == 0).all()):
                        raise AssertionError(f"empty prefix ({route}): o "
                                             "must be 0, lse −inf")
                row["all_lse_neg_inf"] = True
                continue
            fault = _rejects(f"B2 shared chunk prefix{tag}", got["shared"], b2(
                plain, slots, c=cache, positions=pos,
                tables=_hidden_page(cache, 0, 20, dev)))
            visible = sum(1536 - max(int(p) - r, 0) for p in pos.tolist())
            nbytes = (2 * r * hkv * paged.row_bytes(cache.config.page_type, d)
                      + lanes * hq * (4 * d + 4))
            row = dict(case=name + tag, cache=dtype, route="shared",
                       planted_fault_page_hidden=fault,
                       ms=device_ms(calls["shared"]),
                       call_ms=cuda_ms(calls["shared"]),
                       split_ms=device_ms(calls["split"]), split_pages=plan,
                       split_call_ms=cuda_ms(calls["split"]),
                       plain_ms=cuda_ms(lambda: b2(plain, slots, c=cache,
                                                   positions=pos), iters=5),
                       visible_pairs=visible * hq,
                       **roofline(4 * d * hq * visible, nbytes, torch.bfloat16))
            rows.append(row)
            timed["chunk_prefix" + tag] = row
        if dtype == "int8":
            slots = torch.zeros(64, dtype=torch.int32, device=dev)
            vis = torch.arange(1536 - 64, 1536, dtype=torch.int32,
                               device=dev) + 1
            held("paged_attention_shared", "lengths_override_64_lanes_shared",
                 _bitwise_repeat("B2 shared lengths_override", lambda: b2(
                     kern, slots, q=qg[:64], c=cache, lengths_override=vis,
                     positions=vis - 1, shared_page_table=True)),
                 b2(plain, slots, q=qg[:64], c=cache, lengths_override=vis,
                    positions=vis - 1),
                 TOL_BF16)
        del cache

    # the pipelined decode: 16 lanes of 1100–2032 tokens, each walking its
    # own band pages (no pages_bound below the band's): the fused call (the
    # split route with the append, one launch) against the plain B3 then
    # B2 under the card's plan, on each quantized page type
    lens = (1100 + torch.randint(0, 932, (MAX_BATCH,), generator=gen,
                                 device=dev)).tolist()
    slots = torch.arange(MAX_BATCH, dtype=torch.int32, device=dev)
    qr = torch.randn(MAX_BATCH, hkv, g, d, generator=gen,
                     device=dev).bfloat16()
    qscale = d ** -0.5 * flash.LOG2E
    qd = (qr.float() * qscale).bfloat16()
    kn, vn = (torch.randn(MAX_BATCH, hkv, d, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    for dtype in QUANT_PAGES:
        kc = _decode_cache(dtype, lens, dev, 10, n_pages=32)
        pc = _cache_copy(kc)
        pt = kc.config.page_type
        tag = "" if dtype == "int8" else f"_{dtype}"

        def fused():
            return b2(kern, slots, 1, qr, kc, new_kv=(kn, vn), q_scale=qscale)

        got = _bitwise_repeat(f"B2 pipelined fused{tag}", fused)
        paged._paged_append_plain(kn, vn, pc.k_pages, pc.v_pages, pc.k_scales,
                                  pc.v_scales, slots, pc.lengths,
                                  pc.page_tables, page_type=pt)
        _same_cache(f"pipelined decode fused append{tag}", kc, pc)
        plan = _card_plan(qd, kc, radius=r)
        row = held("paged_attention_split",
                   f"pipelined_decode_16_lanes_fused{tag}", got,
                   b2(plain, slots, 1, qd, pc, split_pages=plan), TOL_BF16)
        fault = _rejects(f"B2 pipelined fused{tag}", got, b2(
            plain, slots, 1, qd, pc, split_pages=plan,
            tables=_hidden_page(pc, 0, (lens[0] - 1) // 64 - 1, dev)))
        toks = MAX_BATCH * (r + 1)
        nbytes = (toks * hkv * 2 * paged.row_bytes(pt, d)
                  + MAX_BATCH * hq * (4 * d + 4))
        row.update(cache=dtype, lens_min=min(lens), lens_max=max(lens),
                   append_bit_exact=True, split_pages=plan,
                   planted_fault_page_hidden=fault,
                   ms=device_ms(fused), call_ms=cuda_ms(fused),
                   plain_ms=cuda_ms(lambda: b2(plain, slots, 1, qd, pc,
                                               split_pages=plan), iters=5),
                   **roofline(4 * d * hq * toks, nbytes, torch.bfloat16))
        timed["pipelined" + tag] = row
        del kc, pc
    emit(dict(phase="sliding_kernels", hq=hq, hkv=hkv, radius=r, cases=rows))
    return dict(timed=timed, worst=worst)


# the new phases' kernel-vs-plain limits: softmax and matmul take the
# sweep's gates (sweep.TOL_SOFTMAX; sweep.TOL_MATMUL relative to the largest
# |plain| entry), lse of the stats pass 1e-5; B1's circulant and block kinds
# at the bands shape: o 4e-3 (bf16, ~8 ulps at |o| ~ 0.1), lse TOL_LSE
TOL_STATS = 1e-5
TOL_B1_NEW = 4e-3
# B14's planted fault: the plain product with one 64-deep k-slab left out
# must fail the kernel-vs-plain check
MM_FAULT_SLAB = 64


def primitives_phase(dev):
    """fused_softmax and matmul at the sweep's full-size shapes through the
    public entry points (the path, counted; the sweep gates each case), then
    each against the library call on the same input, and each kernel alone
    against its plain version (row and column shapes), timed beside its
    bound and the library call."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.bench import sweep
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import matmul as mm
    from tpu_flash_torch.ops import softmax as sm

    names = ("softmax_onepass", "softmax_stats", "softmax_norm", "matmul")
    kernels.reset_launches()
    soft = sweep.suite_softmax(dev)
    mat = sweep.suite_matmul(dev)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in names}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "primitives run")
    for case, row in zip(sweep.SOFTMAX_CASES, soft):
        x = sweep.softmax_input(case, dev)
        axis, dt = case[2], case[3]
        row["err_vs_torch_softmax"] = max_err(sm.fused_softmax(x, axis=axis),
                                              torch.softmax(x, dim=axis))
        check(f"softmax {row['shape']} vs torch.softmax",
              row["err_vs_torch_softmax"], sweep.TOL_SOFTMAX[dt])
        row["library_ms"] = cuda_ms(lambda: torch.softmax(x, dim=axis), iters=10)
        del x
    for case, row in zip(sweep.MATMUL_CASES, mat):
        a, b = sweep.matmul_inputs(case, dev)
        lib = a @ b
        got = (mm.matvec if b.ndim == 1 else mm.matmul)(a, b)
        row["rel_err_vs_torch_matmul"] = max_err(got, lib) / float(
            lib.float().abs().max())
        check(f"{row['name']} vs torch.matmul", row["rel_err_vs_torch_matmul"],
              sweep.TOL_MATMUL[case[4]])
        row["library_ms"] = cuda_ms(lambda: a @ b, iters=10)
        del a, b, lib, got

    # each kernel alone vs its plain version: row and column shapes
    timed, worst = {}, {k: 0.0 for k in names}

    def held(kernel, got, want, tol, **extra):
        err = max_err(got, want)
        check(f"{kernel} vs plain", err, tol)
        worst[kernel] = max(worst[kernel], err)
        return dict(extra, max_abs_err=err, tol=tol)

    def fibers(case):
        x = sweep.softmax_input(case, dev)
        return x.reshape(-1, x.shape[-1], 1) if case[2] == -1 else x[None]

    rows = []
    for case in (sweep.SOFTMAX_CASES[0], sweep.SOFTMAX_CASES[5]):
        x3 = fibers(case)
        row = held("softmax_onepass", sm._onepass_kernel(x3),
                   sm._onepass_plain(x3), sweep.TOL_SOFTMAX[x3.dtype],
                   shape=list(case[:2]), axis=case[2])
        nbytes = 2 * 4 * x3.numel()
        row.update(ms=cuda_ms(lambda: sm._onepass_kernel(x3)),
                   plain_ms=cuda_ms(lambda: sm._onepass_plain(x3), iters=3),
                   library_ms=cuda_ms(lambda: torch.softmax(x3, dim=1)),
                   **roofline(0, nbytes, torch.float32))
        rows.append(dict(row, kernel="softmax_onepass"))
        timed.setdefault("softmax_onepass", row)
        del x3
    for case in (sweep.SOFTMAX_CASES[2], sweep.SOFTMAX_CASES[4]):
        x3 = fibers(case)
        lse = sm._stats_kernel(x3)
        row = held("softmax_stats", lse, sm._stats_plain(x3), TOL_STATS,
                   shape=list(case[:2]), axis=case[2])
        nbytes = 4 * x3.numel() + 4 * lse.numel()
        row.update(ms=cuda_ms(lambda: sm._stats_kernel(x3)),
                   plain_ms=cuda_ms(lambda: sm._stats_plain(x3), iters=3),
                   library_ms=cuda_ms(lambda: torch.logsumexp(x3, dim=1)),
                   **roofline(0, nbytes, torch.float32))
        rows.append(dict(row, kernel="softmax_stats"))
        timed.setdefault("softmax_stats", row)
        row = held("softmax_norm", sm._norm_kernel(x3, lse),
                   sm._norm_plain(x3, lse), sweep.TOL_SOFTMAX[x3.dtype],
                   shape=list(case[:2]), axis=case[2])
        row.update(ms=cuda_ms(lambda: sm._norm_kernel(x3, lse)),
                   plain_ms=cuda_ms(lambda: sm._norm_plain(x3, lse), iters=3),
                   library_ms=None,
                   **roofline(0, 2 * 4 * x3.numel() + 4 * lse.numel(),
                              torch.float32))
        rows.append(dict(row, kernel="softmax_norm"))
        timed.setdefault("softmax_norm", row)
        del x3, lse
    for case in sweep.MATMUL_CASES:
        a, b = sweep.matmul_inputs(case, dev)
        b2 = b[:, None] if b.ndim == 1 else b
        dt = case[4]
        (m, k), n = a.shape, b2.shape[1]
        want = mm._matmul_plain(a, b2, dt)
        got = mm._matmul_kernel(a, b2, dt)
        top = float(want.float().abs().max())
        tol = sweep.TOL_MATMUL[dt] * top
        row = held("matmul", got, want, tol, case=case[0],
                   route=mm._matmul_route(m, n, k, dt),
                   rel_err=max_err(got, want) / top)
        if case[0] == "matmul_4096_bf16":  # the planted fault
            j = k // 2
            keep = torch.cat([torch.arange(j, device=dev),
                              torch.arange(j + MM_FAULT_SLAB, k, device=dev)])
            fault = max_err(got, mm._matmul_plain(a[:, keep], b2[keep], dt))
            if fault <= tol:
                raise AssertionError(f"B14 planted fault k_slab_left_out passes "
                                     f"the kernel-vs-plain check: {fault}")
            row["planted_fault_k_slab_left_out"] = dict(max_abs_err=fault, tol=tol)
        row.update(ms=device_ms(lambda: mm._matmul_kernel(a, b2, dt)),
                   call_ms=cuda_ms(lambda: mm._matmul_kernel(a, b2, dt)),
                   plain_ms=cuda_ms(lambda: mm._matmul_plain(a, b2, dt), iters=3),
                   library_ms=device_ms(lambda: a @ b2),
                   library_call_ms=cuda_ms(lambda: a @ b2),
                   **roofline(2 * m * k * n, a.element_size() * (m * k + k * n)
                              + got.element_size() * m * n, dt))
        row["tflops"] = 2 * m * k * n / row["ms"] / 1e9
        if case[0] == "matmul_4096_bf16":
            timed["matmul"] = row
        rows.append(dict(row, kernel="matmul"))
        del a, b, b2, want, got
    emit(dict(phase="primitives", launches=launches, softmax=soft, matmul=mat,
              kernels_vs_plain=rows))
    return dict(launches=launches, timed=timed, worst=worst)


def circulant_mask(n: int, radius: int, dev) -> torch.Tensor:
    pos = torch.arange(n, device=dev)
    off = torch.remainder(pos[:, None] - pos[None, :], n)
    return (off <= radius) | (off >= n - radius)


def ndim_phase(dev):
    """The N-d and new-schedule path: the circulant row, the block rows
    (suite_attention's and block2d) and the other N-d cases through their
    public calls, each set counted apart (the sweep gates each case
    against the oracles); then B1's circulant and block-diagonal kinds
    against their plain version at the bands shape, timed beside their
    bound and the library attention under the same boolean mask."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.bench import sweep
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash

    runs, launches = {}, {}
    for key, fn in (
            ("circulant", lambda: sweep.suite_bands(dev, names=("circulant",))),
            ("block", lambda: sweep.suite_bands(dev, names=("block",))
             + sweep.suite_ndim(dev, names=("block2d",))),
            ("ndim", lambda: sweep.suite_ndim(
                dev, names=("dense2d", "dense2d_fp8", "dense3d",
                            "windowed2d_fp8")))):
        kernels.reset_launches()
        runs[key] = fn()
        torch.cuda.synchronize()
        launches[key] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for key, kernel in (("circulant", "flash_fwd"), ("block", "flash_fwd"),
                        ("ndim", "flash_fwd"), ("ndim", "serving_attention")):
        if launches[key].get(kernel, 0) <= 0:
            raise AssertionError(f"kernel {kernel} never launched in the "
                                 f"{key} run")

    shape = sweep.BANDS
    b, h, n, d = shape["b"], shape["h"], shape["n"], shape["d"]
    params = sweep.band_params(n)
    q, k, v = sweep.band_inputs(shape, dev)
    qf = (q.float() * (d ** -0.5 * flash.LOG2E)).bfloat16()[0]
    timed, rows, worst = {}, [], 0.0
    for name in ("circulant", "block"):
        if name == "circulant":
            r = (params["window"] - 1) // 2
            sched = flash.build_schedule("circulant", n, n, 512, 1024, radius=r)
            kf, vf = (torch.cat([x[0, :, -r:], x[0], x[0, :, :r]], dim=1)
                      for x in (k, v))
            mask = circulant_mask(n, r, dev)
            pairs = n * params["window"]
        else:
            sec = params["section"]
            sched = flash.build_schedule("block", n, n, 1024, 2048, section=sec)
            kf, vf = k[0], v[0]
            pos = torch.arange(n, device=dev) // sec
            mask = pos[:, None] == pos[None, :]
            pairs = n * sec
        bound = flash.auto_bound_max(sched)
        args = (qf, kf, vf, sched, h, h)
        (ko, kl), (po, pl) = (flash._flash_fwd_kernel(*args, True, bound),
                              flash._flash_fwd_plain(*args, bound))
        errs = dict(o_vs_plain=max_err(ko, po), lse_vs_plain=max_err(kl, pl))
        check(f"B1 {name} o vs plain", errs["o_vs_plain"], TOL_B1_NEW)
        check(f"B1 {name} lse vs plain", errs["lse_vs_plain"], TOL_LSE)
        worst = max(worst, *errs.values())
        del ko, kl, po, pl
        nbytes = 2 * 4 * b * h * n * d + 4 * b * h * n
        row = dict(kernel="flash_fwd", schedule=name, n=n, h=h, d=d,
                   bound_max=bound, tol=TOL_B1_NEW, tol_lse=TOL_LSE,
                   visible_pairs=pairs * h, **errs,
                   ms=device_ms(lambda: flash._flash_fwd_kernel(*args, True, bound)),
                   call_ms=cuda_ms(lambda: flash._flash_fwd_kernel(*args, True,
                                                                    bound)),
                   plain_ms=cuda_ms(lambda: flash._flash_fwd_plain(*args, bound),
                                    iters=3),
                   library_ms=device_ms(lambda: sdpa(q, k, v, False, mask)),
                   library_call_ms=cuda_ms(lambda: sdpa(q, k, v, False, mask)),
                   **roofline(4 * d * h * pairs, nbytes, torch.bfloat16))
        row["tflops"] = 4 * d * h * pairs / row["ms"] / 1e9
        rows.append(row)
        timed[name] = row
        del kf, vf, mask
    emit(dict(phase="ndim", launches=launches, bands=runs["circulant"]
              + runs["block"][:1], ndim=runs["block"][1:] + runs["ndim"],
              kernels_vs_plain=rows))
    return dict(launches=launches, timed=timed, worst=worst)


# The ring phase. (a) the shifted kinds at a hop's shape (b 1, 8 heads,
# shard 1024, d 128): (name, shift, radius, wrap_n, causal): a band hop from
# the previous rank, the hop from a later rank (negative shift), the
# circulant hop whose wrapped band reaches the shard at both ends (two runs
# of keys), shifted_causal with a band and without one (300 rows see no key)
RING_HOP_N = 1024
RING_HOPS = [("band_forward", 1024, 512, 0, False),
             ("band_from_later_rank", -1024, 512, 0, False),
             ("two_runs", 0, 300, 1024, False),
             ("causal_band", 256, 512, 0, True),
             ("causal_no_band", -300, -1, 0, True)]
# (b) the ring at the baseline's 7B-proxy attention width over 8 virtual
# ranks: (batch, heads, N, d), ranks, band radius; the bands of query rows
# held against the f32 oracle (edges and interior, as tests/test_ring.py's
# 32k case); (c) the gradient's shape and ranks; (d) the train step's ranks
RING_SHAPE, RING_RANKS, RING_RADIUS = (1, 32, 32768, 128), 8, 512
RING_BAND_ROWS = 1024
RING_GRAD_SHAPE, RING_GRAD_RANKS = (1, 32, 8192, 128), 4
RING_TRAIN_RANKS = 4
# the quantized rings (q_dtype, kv_dtype) on the local pattern
RING_QUANT = [("int8", "int8"), (QB_FP8, QB_FP8), ("int8", "int4")]
LOG2E_F = math.log2(math.e)


def hop_mask(sched, n, dev):
    """The boolean (n, n) mask of a shifted hop (the library's input)."""
    pos = torch.arange(n, device=dev)
    return torch.broadcast_to(sched.visible(pos[:, None], pos[None, :]),
                              (n, n))


def ring_hop_checks(dev):
    """(a) B1 (bf16 d 64 and 128, float32; B9: d 64 under the norm bound),
    B4/B5 (bf16 64, 128 and 256 on wgmma, float32 on FMA), B6 (fp8,
    int8; B8: int8 at d 64) and B7 (fp8, int8, weight-only) against their
    plain versions on every hop of RING_HOPS, rows seeing no key o 0 and lse
    −inf; two planted faults in the plain versions (the shift one row off,
    the wrapped band's second run dropped) must fail B1's and B6/B7's
    checks. Returns (rows, worst error by kernel)."""
    from tpu_flash_torch.bench.quant_bands import band_case, faults
    from tpu_flash_torch.ops import flash, flash_bwd

    gen = torch.Generator(device=dev).manual_seed(14)
    n, h = RING_HOP_N, 8
    rows = []
    worst = dict(flash_fwd=0.0, flash_bwd=0.0, serving=0.0, quant=0.0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def empty_rows_zero(name, o, lse):
        if not bool((o[~torch.isfinite(lse)] == 0).all()):
            raise AssertionError(f"ring {name}: a row that sees no key "
                                 "has o != 0")

    for name, shift, radius, wrap, causal in RING_HOPS:
        sched = flash.build_schedule("shifted", n, n, 512, 1024, shift=shift,
                                     radius=radius, wrap_n=wrap,
                                     shifted_causal=causal)
        row = dict(hop=name, shift=shift, radius=radius, wrap_n=wrap,
                   causal=causal, rows_seeing_no_key=int(
                       (~hop_mask(sched, n, dev).any(-1)).sum()))
        for d, dt, bound in ((64, torch.bfloat16, False),
                             (64, torch.bfloat16, True),
                             (128, torch.bfloat16, False),
                             (128, torch.float32, False)):
            q = (randn(h, n, d) * (d ** -0.5 * LOG2E_F)).to(dt)
            k, v = randn(h, n, d).to(dt), randn(h, n, d).to(dt)
            ko, kl = flash._flash_fwd_kernel(q, k, v, sched, h, h, True, bound)
            po, pl = flash._flash_fwd_plain(q, k, v, sched, h, h, bound)
            key = f"b1_d{d}_{str(dt)[6:]}" + ("_bound" if bound else "")
            errs = dict(o=max_err(ko, po), lse=max_err(kl, pl))
            check(f"ring {name} {key} o", errs["o"],
                  TOL_BF16 if dt == torch.bfloat16 else TOL_F32)
            check(f"ring {name} {key} lse", errs["lse"], TOL_LSE)
            empty_rows_zero(f"{name} {key}", ko, kl)
            worst["flash_fwd"] = max(worst["flash_fwd"], errs["o"], errs["lse"])
            row[key] = errs
            if d == 128 and dt == torch.bfloat16:
                row["b1_planted_faults"] = {}
                for fault in faults("b1", "shifted", wrap):
                    bad = dataclasses.replace(sched, **(
                        dict(shift=shift + 1) if fault == "shift"
                        else dict(wrap_n=0)))
                    fo, fl = flash._flash_fwd_plain(q, k, v, bad, h, h)
                    ferrs = dict(o=max_err(ko, fo))
                    ferrs["lse"] = (max_err(kl, fl) if torch.equal(
                        torch.isfinite(kl), torch.isfinite(fl))
                        else "finite/infinite pattern differs")
                    if ferrs["o"] <= TOL_BF16 and not isinstance(
                            ferrs["lse"], str) and ferrs["lse"] <= TOL_LSE:
                        raise AssertionError(f"ring {name}: planted fault "
                                             f"{fault} passes B1's check")
                    row["b1_planted_faults"][fault] = ferrs
        for d, dt in ((64, torch.bfloat16), (128, torch.bfloat16),
                      (256, torch.bfloat16), (128, torch.float32)):
            q = (randn(h, n, d) * (d ** -0.5 * LOG2E_F)).to(dt)
            k, v = randn(h, n, d).to(dt), randn(h, n, d).to(dt)
            o, lse = flash._flash_fwd_kernel(q, k, v, sched, h, h, True)
            do, dlse = randn(h, n, d).to(dt), randn(h, n)
            args = (q, k, v, o, lse, do, dlse, sched, h, h)
            got = flash_bwd._flash_bwd_kernel(*args)
            want = flash_bwd._flash_bwd_plain(*args)
            key = f"b45_d{d}_{str(dt)[6:]}"
            errs = {f"d{x}": rel_err(a, b) for x, a, b in zip("qkv", got, want)}
            for x, err in errs.items():
                check(f"ring {name} {key} {x}", err, TOL_BWD_PLAIN[dt])
            worst["flash_bwd"] = max(worst["flash_bwd"], *errs.values())
            row[key] = errs
        for family, q_dt, kv_dt, d in (
                ("serving", QB_FP8, QB_FP8, 128), ("serving", "int8", "int8", 128),
                ("serving", "int8", "int8", 64), ("quant", QB_FP8, QB_FP8, 128),
                ("quant", "int8", "int8", 128), ("quant", None, "int8", 128)):
            q, k, v = (randn(1, h, n, d).bfloat16() for _ in range(3))
            kernel, plain, staged = band_case(
                family, "shifted", q, k, v, q_dtype=q_dt, kv_dtype=kv_dt,
                radius=radius, shift=shift, wrap_n=wrap,
                shifted_causal=causal)
            ko, kl = kernel()
            errs = quant_errs(ko, kl, *plain())
            key = f"{family}_{q_dt or 'weight_only'}_d{d}"
            for tkey, tol in QUANT_TOL.items():
                check(f"ring {name} {key} {tkey}", errs[tkey], tol)
            empty_rows_zero(f"{name} {key}", ko, kl)
            if staged is not None and not staged():
                raise AssertionError(f"ring {name} {key}: staged Q differs")
            worst[family] = max(worst[family], errs["o_vs_plain"],
                                errs["lse_vs_plain"])
            if q_dt == QB_FP8:
                errs["planted_faults"] = {}
                for fault in faults(family, "shifted", wrap):
                    fo, fl = plain(fault)
                    if not torch.equal(torch.isfinite(kl), torch.isfinite(fl)):
                        errs["planted_faults"][fault] = dict(
                            o_vs_plain=max_err(ko, fo),
                            lse_vs_plain="finite/infinite pattern differs")
                        continue
                    ferrs = quant_errs(ko, kl, fo, fl)
                    if all(ferrs[tk] <= tol for tk, tol in QUANT_TOL.items()):
                        raise AssertionError(f"ring {name} {key}: planted "
                                             f"fault {fault} passes")
                    errs["planted_faults"][fault] = ferrs
            row[key] = errs
        rows.append(row)
    return rows, worst


def ring_oracle_inputs(q, k, v, p, q_dtype, kv_dtype):
    """The matched-bit-width oracle's inputs of a quantized ring over p
    ranks: Q as the ring hands it to its hop kernel (int8 q̂·σq, or the
    bf16 fold of e4m3 Q with log2e taken out again), K per token and V per
    channel quantized shard by shard (scales travel with their shard),
    int4 through its own quantizer, dequantized; the softmax scale is in
    Q."""
    from tpu_flash_torch.quant import qarray
    from tpu_flash_torch.quant.flash_q import prepare_ring_operands

    q_pre, _, _ = prepare_ring_operands(
        q, k[:, :, :1], v[:, :, :1], q_dtype=q_dtype,
        kv_dtype="int8" if kv_dtype == "int4" else kv_dtype)
    qd = (qarray.dequantize(q_pre) if isinstance(q_pre, qarray.QArray)
          else q_pre.float() / LOG2E_F)
    nl = k.shape[2] // p
    if kv_dtype == "int4":
        quant, deq = qarray.quantize_int4, qarray.dequantize_int4
    else:
        def quant(x, axis):
            return qarray.quantize(x, kv_dtype, axis=axis)
        deq = qarray.dequantize
    kd = torch.cat([deq(quant(k[:, :, s * nl:(s + 1) * nl].float(), axis=-1))
                    for s in range(p)], dim=2)
    vd = torch.cat([deq(quant(v[:, :, s * nl:(s + 1) * nl].float(), axis=-2))
                    for s in range(p)], dim=2)
    return qd, kd, vd


def ring_band_errs(o, qd, kd, vd, mask: dict, scale) -> list:
    """max |o − f32 oracle| on RING_BAND_ROWS query rows at the start, the
    middle and the end of the sequence (blockwise_dpa with q_start)."""
    from tpu_flash_torch.ops.oracle import blockwise_dpa

    n, rows = o.shape[2], RING_BAND_ROWS
    errs = []
    for a in (0, n // 2 - rows // 2, n - rows):
        want, _ = blockwise_dpa(qd[:, :, a:a + rows].float(), kd, vd,
                                scale=scale, q_start=a, **mask)
        errs.append(max_err(o[:, :, a:a + rows], want))
    return errs


def hull_reads(mask: torch.Tensor) -> tuple:
    """(query rows that see a key, keys that a row sees) of a hop's (n, n)
    mask: the rows and keys whose operands the hop must read."""
    return int(mask.any(-1).sum()), int(mask.any(0).sum())


def shift_fault(name, ko, kl, fo, fl, tols: dict, errs_fn):
    """The planted fault's errors (a plain version with the shift one row
    off); AssertionError when they pass every limit of ``tols``."""
    if not torch.equal(torch.isfinite(kl), torch.isfinite(fl)):
        return dict(lse="finite/infinite pattern differs")
    errs = errs_fn(ko, kl, fo, fl)
    if all(errs[key] <= tol for key, tol in tols.items()):
        raise AssertionError(f"{name}: planted fault shift + 1 passes")
    return errs


def ring_timed_hop(hq_, hk_, hv_, shift: int, r: int, gen, peaks) -> tuple:
    """One ring hop at full width on ``(1, h, nl, d)`` bf16 q, k, v: shift
    ``shift``, band radius ``r``, no wrap. B1, B4/B5 and B6/B7 (fp8) are
    held against their plain versions on the hop's own outputs (TOL_BF16
    and TOL_LSE, TOL_BWD_PLAIN, QUANT_TOL), a plain version with the shift
    one row off must fail B1's and B6/B7's checks, and each kernel is timed
    alone beside its plain version and the library under the hop's boolean
    mask. Bounds: 2·d operations a visible pair in each product, or the
    bytes the hop needs: o and lse (B4/B5: the grads) written in full, Q
    (dO, lse, Δ) read for the rows that see a key and K/V for the keys a
    row sees. Returns (errors, timed rows)."""
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.bench.harness import roofline as hroofline
    from tpu_flash_torch.bench.quant_bands import band_case
    from tpu_flash_torch.ops import flash, flash_bwd

    _, h, nl, d = hq_.shape
    sched = flash.build_schedule("shifted", nl, nl, 512, 512, shift=shift,
                                 radius=r)
    bad = dataclasses.replace(sched, shift=shift + 1)
    mask = hop_mask(sched, nl, dev=hq_.device)
    pairs = h * int(mask.sum())
    rows_in, keys_in = hull_reads(mask)
    label = f"ring hop shift {shift}"
    qf = (hq_.float() * (d ** -0.5 * LOG2E_F)).bfloat16().reshape(h, nl, d)
    kf, vf = hk_.reshape(h, nl, d), hv_.reshape(h, nl, d)

    def plain_fwd():
        return flash._flash_fwd_plain(qf, kf, vf, sched, h, h)

    o, lse = flash._flash_fwd_kernel(qf, kf, vf, sched, h, h, True)
    po, pl = plain_fwd()
    errs = dict(rows_seeing_a_key=rows_in, keys_seen=keys_in,
                flash_fwd=dict(o=max_err(o, po), lse=max_err(lse, pl)))
    check(f"{label} B1 o", errs["flash_fwd"]["o"], TOL_BF16)
    check(f"{label} B1 lse", errs["flash_fwd"]["lse"], TOL_LSE)
    fo, fl = flash._flash_fwd_plain(qf, kf, vf, bad, h, h)
    errs["flash_fwd"]["planted_fault_shift"] = shift_fault(
        f"{label} B1", o, lse, fo, fl, dict(o=TOL_BF16, lse=TOL_LSE),
        lambda a, al, b, bl: dict(o=max_err(a, b), lse=max_err(al, bl)))
    del po, pl, fo, fl
    lib_ms = device_ms(lambda: sdpa(hq_, hk_, hv_, False, mask))
    fwd_bytes = 2 * h * d * (rows_in + 2 * keys_in) + 2 * h * nl * d \
        + 4 * h * nl
    timed = dict(flash_fwd=dict(
        ms=device_ms(lambda: flash._flash_fwd_kernel(qf, kf, vf, sched, h, h,
                                                     True)),
        plain_ms=cuda_ms(plain_fwd, iters=2, warmup=1), library_ms=lib_ms,
        visible_pairs=pairs, **roofline(4 * d * pairs, fwd_bytes,
                                        torch.bfloat16)))

    do = torch.randn(h, nl, d, generator=gen, device=hq_.device).bfloat16()
    bwd_args = (qf, kf, vf, o, lse, do, None, sched, h, h)
    got = flash_bwd._flash_bwd_kernel(*bwd_args)
    want = flash_bwd._flash_bwd_plain(*bwd_args)
    errs["flash_bwd"] = {f"d{x}": rel_err(a, b)
                         for x, a, b in zip("qkv", got, want)}
    for x, err in errs["flash_bwd"].items():
        check(f"{label} B4/B5 {x}", err, TOL_BWD_PLAIN[torch.bfloat16])
    del got, want
    ops = flash_bwd._kernel_operands(*bwd_args)
    dq, dkv = bwd_timing(ops, sched, h, h, torch.bfloat16, pairs, d, 1, nl,
                         nl, None, reads=(rows_in, keys_in))
    bwd_plain_ms = cuda_ms(lambda: flash_bwd._flash_bwd_plain(*bwd_args),
                           iters=2, warmup=1)
    xs = [x.detach().requires_grad_(True) for x in (hq_, hk_, hv_)]
    lo = sdpa(*xs, False, mask)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        lo, xs, do.reshape(1, h, nl, d), retain_graph=True), iters=5)
    del lo, xs, ops
    for part in (dq, dkv):
        part.update(plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                    visible_pairs=pairs)
    timed["flash_bwd_dq"], timed["flash_bwd_dkv"] = dq, dkv

    for family in ("serving", "quant"):
        kernel, plain, _ = band_case(
            family, "shifted", hq_, hk_, hv_, q_dtype=QB_FP8, kv_dtype=QB_FP8,
            radius=r, shift=shift)
        ko, kl = kernel()
        errs[family] = quant_errs(ko, kl, *plain())
        for key, tol in QUANT_TOL.items():
            check(f"{label} {family} fp8 {key}", errs[family][key], tol)
        errs[family]["planted_fault_shift"] = shift_fault(
            f"{label} {family} fp8", ko, kl, *plain("shift"), QUANT_TOL,
            quant_errs)
        del ko, kl
        # Q: bf16 (B6 quantizes it in the kernel) or e4m3 and its row
        # scale; K̂/V̂ one byte, K's per-token and V's per-channel scales
        q_row = 2 * d if family == "serving" else d + 4
        nb = h * (q_row * rows_in + 2 * d * keys_in + 2 * d * nl
                  + 4 * (keys_in + d + 1))
        timed[family] = dict(
            ms=device_ms(lambda: kernel(False)),
            plain_ms=cuda_ms(plain, iters=2, warmup=1), library_ms=lib_ms,
            visible_pairs=pairs,
            **hroofline(2 * d * pairs, 2 * d * pairs, nb, peaks, "fp8", "bf16"))
    return errs, timed


def ring_phase(dev):
    """Ring attention (parallel/ring.py) over virtual ranks on one card:
    (a) the shifted kinds against the plain versions (ring_hop_checks);
    (b) the ring at full width over 8 ranks, bf16 dense, causal, local and
    circulant against the single-device kernels on the whole sequence and
    the f32 oracle on three row bands, the quantized local rings against
    their matched oracle; (c) the ring's gradient against the
    single-device flash gradient; (d) the sequence-parallel train step of
    the canonical model against the plain one. (b)–(d) are the path: the
    launch counts are zeroed before (b) and read after (d); the timings
    come after. On one card no communication is measured: the rotation
    between virtual ranks moves no data."""
    from tpu_flash_torch import graft_entry, kernels
    from tpu_flash_torch.bench.harness import device_ms, device_peaks
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.parallel import ring
    from tpu_flash_torch.quant import serving_attn as tsa

    t_phase = time.perf_counter()
    hop_rows, worst = ring_hop_checks(dev)
    emit(dict(phase="ring_hops", shape=dict(b=1, h=8, n=RING_HOP_N, d=128),
              rows=hop_rows, worst=worst))
    torch.cuda.empty_cache()

    b, h, n, d = RING_SHAPE
    p, r, nl = RING_RANKS, RING_RADIUS, RING_SHAPE[2] // RING_RANKS
    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    window = 2 * r + 1
    single = {
        "dense": (lambda: flash.dense_fa(q, k, v), {}),
        "causal": (lambda: flash.dense_fa(q, k, v, causal=True),
                   dict(causal=True)),
        "local": (lambda: flash.sliding_fa(q, k, v, window),
                  dict(window_size=window)),
        "circulant": (lambda: flash.circulant_fa(q, k, v, window),
                      dict(window_size=window, wrap=True)),
    }

    def ring_call(pattern, **kw):
        return lambda: ring.ring_dense_fa(q, k, v, p, pattern=pattern,
                                          radius=r, **kw)

    def hops(pattern):
        run = sum(ring.hop_schedule(pattern, r, p, nl, t, rank) is not None
                  for t in range(p) for rank in range(p))
        static = sum(ring.hop_needed(pattern, r, p, nl, t) for t in range(p))
        return dict(hop_calls=run, hop_calls_skipped=p * p - run,
                    hops_needed=static, hops_skipped=p - static)

    path = dict.fromkeys(kernels.LAUNCHES, 0)

    def counted(fn):
        """``fn()``, its kernel launches added to the path's counts."""
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = {key: n for key, n in kernels.LAUNCHES.items() if n}
        for key, n in launches.items():
            path[key] += n
        return out, launches

    rings = {}
    for pattern, (call, mask) in single.items():
        o, launches = counted(ring_call(pattern))
        with torch.no_grad():
            os_ = call()
        err_single = max_err(o, os_)
        del os_
        check(f"ring {pattern} vs single-device", err_single, TOL_BF16)
        bands = ring_band_errs(o, q.float() * d ** -0.5, k.float(), v.float(),
                               mask, 1.0)
        check(f"ring {pattern} vs f32 oracle", max(bands), TOL_BF16)
        rings[pattern] = dict(vs_single_device=err_single,
                              vs_f32_oracle_bands=bands, launches=launches,
                              **hops(pattern))
        del o
    for q_dt, kv_dt in RING_QUANT:
        o, launches = counted(ring_call("local", q_dtype=q_dt, kv_dtype=kv_dt))
        matched = ring_oracle_inputs(q, k, v, p, q_dt, kv_dt)
        bands = ring_band_errs(o, *matched, dict(window_size=window), 1.0)
        del matched
        check(f"ring local {q_dt}/{kv_dt} vs matched oracle", max(bands),
              TOL_QUANT_GATE)
        rings[f"local_{q_dt}_{kv_dt}"] = dict(
            vs_matched_oracle_bands=bands, launches=launches, **hops("local"))
        del o
    torch.cuda.empty_cache()

    # (c) the gradient
    gb, gh, gn, gd = RING_GRAD_SHAPE
    gq, gk, gv = (torch.randn(gb, gh, gn, gd, generator=gen, device=dev)
                  .bfloat16() for _ in range(3))
    gw = torch.randn(gb, gh, gn, gd, generator=gen, device=dev)
    grad_single = {
        "causal": lambda a, b_, c: flash.dense_fa(a, b_, c, causal=True),
        "local": lambda a, b_, c: flash.sliding_fa(a, b_, c, window),
        "circulant": lambda a, b_, c: flash.circulant_fa(a, b_, c, window),
    }

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (gq, gk, gv)]
        (fn(*xs).float() * gw).sum().backward()
        return [x.grad for x in xs]

    grad_rows = {}
    for pattern, fn in grad_single.items():
        got, launches = counted(lambda: grads(
            lambda a, b_, c: ring.ring_dense_fa(a, b_, c, RING_GRAD_RANKS,
                                                pattern=pattern, radius=r)))
        want = grads(fn)
        errs = {f"d{x}": rel_err(a, w) for x, a, w in zip("qkv", got, want)}
        for x, err in errs.items():
            check(f"ring grad {pattern} {x}", err, TOL_BWD_ORACLE)
        grad_rows[pattern] = dict(errs, launches=launches)
        del got, want
    del gq, gk, gv, gw
    torch.cuda.empty_cache()

    # (d) the sequence-parallel train step of the canonical model
    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, TRAIN_TOKENS), device=dev)
    ring_fn = ring.ring_attn_fn(RING_TRAIN_RANKS, pattern="causal",
                                block_q=mcfg.block_q, block_kv=mcfg.block_kv)
    (loss_r, grads_r), _ = counted(lambda: graft_entry.loss_and_grads(
        params, tokens, mcfg, attn_fn=ring_fn))
    loss_p, grads_p = graft_entry.loss_and_grads(params, tokens, mcfg)
    cos = grad_cosines(params, grads_r, grads_p)
    del grads_r, grads_p
    worst_cos = min(cos, key=cos.get)
    dloss = abs(float(loss_r) - float(loss_p))
    check("ring train loss vs plain", dloss, TOL_DLOSS)
    if not cos[worst_cos] >= TOL_COSINE:
        raise AssertionError(f"ring train grad cosine {worst_cos}: "
                             f"{cos[worst_cos]}")
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (params, loss), _ = counted(lambda: graft_entry.seq_parallel_train_step(
            params, tokens, mcfg, TRAIN_LR, ranks=RING_TRAIN_RANKS))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ring train: losses {losses}")
    path_launches = {key: n for key, n in path.items() if n}
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "quant_attention"):
        if path_launches.get(key, 0) <= 0:
            raise AssertionError(f"kernel {key} never launched on the ring "
                                 "path")
    train_row = dict(tokens=list(TRAIN_TOKENS), ranks=RING_TRAIN_RANKS,
                     loss_ring=float(loss_r), loss_plain=float(loss_p),
                     dloss=dloss, min_grad_cosine=cos[worst_cos],
                     min_cosine_param=worst_cos, losses=losses,
                     step_ms=step_ms,
                     median_step_ms=float(np.median(step_ms[1:])))
    del params
    torch.cuda.empty_cache()

    # timings: each ring beside the single-device kernel on the whole
    # sequence (all virtual ranks serialized on one card)
    for pattern, (call, _) in single.items():
        rings[pattern]["ring_ms"] = cuda_ms(ring_call(pattern), iters=3,
                                            warmup=1)
        rings[pattern]["single_device_ms"] = cuda_ms(call, iters=3, warmup=1)
    for q_dt, kv_dt in RING_QUANT:
        rings[f"local_{q_dt}_{kv_dt}"]["ring_ms"] = cuda_ms(
            ring_call("local", q_dtype=q_dt, kv_dtype=kv_dt), iters=3,
            warmup=1)

    # the kernels line's shifted rows: the ring's hops at full width (b 1,
    # 32 heads, shard 4096, d 128, radius 512), the kernels held against
    # their plain versions there and timed alone: hop 0 (shift 0, every row
    # sees 513–1025 keys; the band rings' work) and the hop from the
    # previous rank (shift nl: rows 0–511 see keys 3584–4095)
    peaks = device_peaks(dev)
    hq_, hk_, hv_ = (x[:, :, :nl].contiguous() for x in (q, k, v))
    del q, k, v
    torch.cuda.empty_cache()
    hop_errs, hop_timed = {}, {}
    timed_shifts = dict(t0=0, from_previous_rank=nl)
    for name, shift in timed_shifts.items():
        hop_errs[name], hop_timed[name] = ring_timed_hop(hq_, hk_, hv_, shift,
                                                        r, gen, peaks)
        torch.cuda.empty_cache()
    timed = hop_timed["t0"]
    for errs in hop_errs.values():
        worst["flash_fwd"] = max(worst["flash_fwd"], errs["flash_fwd"]["o"],
                                 errs["flash_fwd"]["lse"])
        worst["flash_bwd"] = max(worst["flash_bwd"],
                                 *errs["flash_bwd"].values())
        for family in ("serving", "quant"):
            worst[family] = max(worst[family], errs[family]["o_vs_plain"],
                                errs[family]["lse_vs_plain"])
    # the local ring's time split: B1 alone on each of its hop calls (the
    # shift −nl hop timed too) against the ring's ms; the rest is the float32
    # merges, the wrapper's work around each launch and the host
    shifts = [c["shift"] for c in (
        ring.hop_schedule("local", r, p, nl, t, rank)
        for t in range(p) for rank in range(p)) if c is not None]
    qf = (hq_.float() * (d ** -0.5 * LOG2E_F)).bfloat16().reshape(h, nl, d)
    kf, vf = hk_.reshape(h, nl, d), hv_.reshape(h, nl, d)
    b1_ms = {}
    for shift in sorted(set(shifts)):
        sched = flash.build_schedule("shifted", nl, nl, 512, 512, shift=shift,
                                     radius=r)
        b1_ms[shift] = device_ms(lambda: flash._flash_fwd_kernel(
            qf, kf, vf, sched, h, h, True))
    b1_sum = sum(b1_ms[s] for s in shifts)
    rings["local"]["split"] = dict(
        hop_calls_by_shift={str(s): shifts.count(s) for s in b1_ms},
        b1_ms_by_shift={str(s): ms for s, ms in b1_ms.items()},
        b1_sum_ms=b1_sum, rest_ms=rings["local"]["ring_ms"] - b1_sum)
    del qf, kf, vf
    # B6 through its public entry point on the same hop (serving_flash_
    # attention over an fp8 cache of the shard), gated against its matched
    # oracle: the ring itself runs B7
    mask = hop_mask(flash.build_schedule("shifted", nl, nl, 512, 512,
                                         shift=nl, radius=r), nl, dev)
    cache = tsa.quantize_kv_cache(hk_, hv_, QB_FP8)
    kernels.reset_launches()
    so = tsa.serving_flash_attention(hq_.float(), *cache, q_dtype=QB_FP8,
                                     schedule="shifted", shift=nl, radius=r)
    torch.cuda.synchronize()
    serving_launches = kernels.LAUNCHES["serving_attention"]
    qm, km, vm = qb_matched(hq_, hk_, hv_, QB_FP8, QB_FP8, "token", cache)
    s_ = torch.einsum("bhqd,bhkd->bhqk", qm, km).masked_fill(~mask, -math.inf)
    ref = torch.nan_to_num(torch.softmax(s_, -1)) @ vm
    served = dict(launches=serving_launches, vs_matched_oracle=max_err(so, ref),
                  tol=TOL_QUANT_GATE + P_ROUNDING * float(vm.abs().max()))
    check("ring served hop vs matched oracle", served["vs_matched_oracle"],
          served["tol"])
    del s_, ref, so
    emit(dict(phase="ring", shape=dict(zip("b h n d".split(), RING_SHAPE)),
              ranks=p, radius=r, rings=rings, grad_shape=dict(zip(
                  "b h n d".split(), RING_GRAD_SHAPE)),
              grad_ranks=RING_GRAD_RANKS, grads_vs_single_device=grad_rows,
              train=train_row, path_launches=path_launches,
              served_hop=served, timed_hops=dict(
                  radius=r, shard=nl, heads=h, d=d,
                  hops={name: dict(shift=shift, vs_plain=hop_errs[name],
                                   timed=hop_timed[name])
                        for name, shift in timed_shifts.items()}),
              note="one card: the rotation between virtual ranks moves no "
                   "data, so no communication is measured",
              phase_s=time.perf_counter() - t_phase))
    return dict(launches=path_launches, served_launches=serving_launches,
                timed=timed, worst=worst)


# ---- the parallel modules (parallel/mesh.py, ring_decode.py, shardings.py,
# ulysses.py; serving/seq_engine.py; Engine(mesh=)) over virtual ranks on
# the one card: every rank on cuda:0, the rank sums and all-to-alls inside
# the process, so no communication is measured

# BASELINE config #5 on the canonical model: 4 sequence ranks, an int4
# cache of page 64, 4 lanes of 32,704 prompt + 64 new tokens (32,768 a
# lane), greedy; both engines get pages enough that no lane stops at the
# cap (32,768 tokens = 512 pages a lane)
SEQ_RANKS, SEQ_LANES, SEQ_PROMPT, SEQ_NEW = 4, 4, 32704, 64
SEQ_CACHE = dict(CACHE, dtype="int4", max_seqs=SEQ_LANES + 1,
                 max_pages_per_seq=520, total_pages=SEQ_LANES * 520 + 16)
# the layer whose rank calls are held against the plain versions, at the
# first decode step of all 4 lanes after this many of the layer's calls
# (the warm request's 4 tokens take fewer)
SEQ_HELD_LAYER, SEQ_HELD_AFTER = MODEL["num_layers"] - 1, 8
# the seq_decode kernel row: the baseline's attention width (32 heads for
# q and kv, d 128, RING_SHAPE's), int4 pages, 4 lanes × 32,768 tokens over
# 4 ranks, the new token appended on the last
SEQ_DECODE_HEADS, SEQ_DECODE_N = 32, 32768
# tensor-parallel serving: the engine phase's cell with int8 weights in
# rounds of 8, over 2 and 4 ranks; tests/test_tp.py's agreement ≥ 0.9,
# the float32 model within TOL_F32 of max |logit|, and bf16 TP no further
# than 5e-2 beyond the unsharded bf16 model's own distance from the
# float32 logits
TP_SIZES, TP_ROUNDS = (2, 4), 8
TOL_TP_AGREE, TOL_TP_BF16 = 0.9, 5e-2
TP_FORWARD_TOKENS = (2, 256)
# Ulysses at the ring phase's width over 8 ranks
ULYSSES_RANKS = 8


def prof_device(fn) -> dict:
    """torch.profiler over one ``fn()`` (ending in a synchronise): the
    device time of its kernels and their count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(device_ms=sum(e.self_device_time_total for e in kern) / 1e3,
                device_activities=sum(e.count for e in kern))


def tail_logprobs(params, mcfg, tokens, n_tail) -> torch.Tensor:
    """log_softmax of a full forward's logits at the last ``n_tail``
    positions only (the blocks over every position, the unembed over the
    tail: a 32k prompt's every logit would take 4 GB)."""
    from tpu_flash_torch.models import transformer as tfm

    toks = torch.tensor([tokens], device=params["embed"].device)
    b, n = toks.shape
    x = params["embed"][toks]
    pos = tfm._positions(b, n, toks.device)
    for layer in params["layers"]:
        x = tfm._block(layer, x, pos, mcfg)
    x = tfm.rmsnorm(x[:, -n_tail:], params["ln_f"])
    return torch.log_softmax((x @ params["embed"].T).float()[0], dim=-1)


def stream_drift(params, mcfg, f) -> float:
    """max |engine logprob − teacher-forced logprob| over a stream's new
    tokens (tail_logprobs of its tokens but the last)."""
    lp = tail_logprobs(params, mcfg, f.tokens[:-1], len(f.new_tokens))
    ref = lp.gather(1, torch.tensor(f.new_tokens, device=lp.device)[:, None])
    return float((ref[:, 0] - torch.tensor(f.logprobs, device=lp.device))
                 .abs().max())


def agreement(got, want) -> dict:
    """Per request: the share of equal tokens and the first new-token
    index where the streams part (None: never)."""
    out = {}
    for rid, f in want.items():
        a, b = got[rid].tokens, f.tokens
        part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        out[rid] = dict(agree=sum(x == y for x, y in zip(a, b)) / len(b),
                        parts_at=None if part is None else part - len(
                            f.tokens) + len(f.new_tokens))
    return out


def run_engine(eng, reqs, warm=None, profile_at=None) -> dict:
    """Serve ``warm`` to the end, then ``reqs`` with the launch counts
    zeroed: finished requests by rid, each step's host ms (a step ends in
    a host fetch), the wall time, the launches that ran (a graph's once a
    replay) and the graph replays; step ``profile_at`` runs under
    torch.profiler (``prof_device``) and is left out of the step times."""
    from tpu_flash_torch import kernels

    if warm is not None:
        eng.submit(warm)
        eng.run()
    torch.cuda.synchronize()
    stats = eng.graph_stats
    cap0, rep0 = dict(stats["captured"]), dict(stats["replayed"])
    replays0 = stats["replays"]
    n0 = len(eng.finished)
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    step_ms, profiled = [], None
    t0 = time.perf_counter()
    while eng.waiting or eng.running or eng.prefilling:
        if len(step_ms) == profile_at and profiled is None:
            profiled = prof_device(eng.step)
            continue
        ts = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {k: n - (stats["captured"].get(k, 0) - cap0.get(k, 0))
           + (stats["replayed"].get(k, 0) - rep0.get(k, 0))
           for k, n in kernels.LAUNCHES.items()}
    return dict(done={f.rid: f for f in eng.finished[n0:]}, step_ms=step_ms,
                wall_s=wall, launches={k: n for k, n in ran.items() if n},
                replays=stats["replays"] - replays0, profiled=profiled)


@contextlib.contextmanager
def recorded_rank_calls(caches, after=0, trash=None):
    """Record the B2 calls that sharded_paged_attention makes on
    ``caches`` (one layer's cache a rank), at one call of the axis: the
    first whose rank-0 call comes after ``after`` earlier ones and whose
    lanes each have a slot of their own (none the engine's ``trash``
    slot). A record holds the call's inputs, the cache as the call found
    it and (with an append) as it left it, o and lse. Yields the list."""
    from tpu_flash_torch.parallel import ring_decode

    base = ring_decode.paged_attention
    rank_of = {id(c): r for r, c in enumerate(caches)}
    calls, state = [], dict(seen=0, armed=False)

    def recorded(q, cache, slots, **kw):
        r = rank_of.get(id(cache))
        if r == 0 and not calls:
            state["seen"] += 1
            if state["seen"] > after:
                s = slots.tolist()
                state["armed"] = len(set(s)) == len(s) and trash not in s
        if r is None or not state["armed"]:
            return base(q, cache, slots, **kw)
        new_kv = kw.get("new_kv")
        rec = dict(rank=r, q=q.clone(), slots=slots.clone(),
                   kw={k: v for k, v in kw.items() if k != "new_kv"},
                   new_kv=None if new_kv is None else tuple(
                       t.clone() for t in new_kv),
                   before=_cache_copy(cache))
        out = base(q, cache, slots, **kw)
        rec.update(o=out[0].clone(), lse=out[1].clone(),
                   after=rec["before"] if new_kv is None else _cache_copy(cache))
        calls.append(rec)
        if r == len(caches) - 1:
            state["armed"] = False
        return out

    ring_decode.paged_attention = recorded
    try:
        yield calls
    finally:
        ring_decode.paged_attention = base


def held_rank_b2(name, calls) -> dict:
    """Each recorded rank call (:func:`recorded_rank_calls`) against the
    plain versions on its own inputs, under the engine's split plan
    (``plan_pages`` of the rank's cache): with an append, the pages the
    fused call wrote bit for bit _paged_append_plain's; o within TOL_BF16
    and lse within TOL_LSE of _paged_attention_plain. A planted fault (one
    page of the first lane's walk on rank 0 taken from the second lane's)
    must fail that check."""
    from tpu_flash_torch.ops import paged

    if len(calls) < 2:
        raise AssertionError(f"{name}: {len(calls)} rank calls recorded")
    worst, rows = 0.0, []
    for call in calls:
        c, q, slots, kw = call["before"], call["q"], call["slots"], call["kw"]
        cfg = c.config
        b, qh, d = q.shape
        kvh = c.k_pages.shape[0]
        scale = kw.get("scale") or d ** -0.5
        qg = (q.float() * (scale * paged.LOG2E)).bfloat16().reshape(
            b, kvh, qh // kvh, d)
        radius = kw.get("radius")
        walk = paged.plan_pages(cfg, radius)
        bound = min(kw.get("pages_bound") or walk, walk)
        append = call["new_kv"] is not None
        label = f"{name} rank {call['rank']}"
        if append:
            paged._paged_append_plain(
                *call["new_kv"], c.k_pages, c.v_pages, c.k_scales, c.v_scales,
                slots, c.lengths, c.page_tables, page_type=cfg.page_type)
            _same_cache(f"{label} fused append", call["after"], c)
        split = _card_plan(qg, c, radius=radius)

        def plain(tables=None):
            o, lse = paged._paged_attention_plain(
                *_b2_args(qg, c, slots, int(append), bound, q.dtype, tables),
                radius=radius, split_pages=split, page_type=cfg.page_type)
            return o.reshape(b, qh, d), lse.reshape(b, qh)

        got = (call["o"], call["lse"])
        errs = _held_b2(label, got, plain(), tol_lse=TOL_LSE)
        worst = max(worst, *errs.values())
        row = dict(rank=call["rank"], append=append, lanes=b,
                   pages_bound=bound, split_pages=split, **errs)
        if call["rank"] == 0:
            tables = c.page_tables.clone()
            s0, s1 = (int(x) for x in slots[:2])
            tables[s0, 3] = c.page_tables[s1, 3]
            fo, fl = plain(tables)
            row["fault_o"], row["fault_lse"] = (max_err(got[0], fo),
                                                max_err(got[1], fl))
            if row["fault_o"] <= TOL_BF16 and row["fault_lse"] <= TOL_LSE:
                raise AssertionError(f"{label}: the planted fault (a page "
                                     f"of lane 0 hidden) passes: {row}")
        rows.append(row)
    return dict(ranks=rows, tol_o=TOL_BF16, tol_lse=TOL_LSE,
                max_abs_err=worst,
                appends_bit_exact=sum(r["append"] for r in rows))


def seq_serve_phase(dev) -> dict:
    """BASELINE config #5 on the canonical model: SeqShardedEngine over
    SEQ_RANKS ranks of an int4 cache against the unsharded engine on an
    int4 cache of the same page size; the reference's int4 gate (prompt
    and first generated token equal), the agreement and where the streams
    part, each stream's teacher-forced drift (logits at the decode
    positions only) ≤ TOL_LOGPROB_INT4 with the unsharded engine's beside
    it, per-rank pages before and after (only the last rank may change),
    one layer's rank calls at one decode step held against the plain
    versions on their own inputs (:func:`held_rank_b2`), ms a decode step,
    prefill ms a request and one step's device ms."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.parallel.mesh import make_mesh
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request
    from tpu_flash_torch.serving.seq_engine import SeqShardedEngine

    t_phase = time.perf_counter()
    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.default_rng(31)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (SEQ_LANES, SEQ_PROMPT)).tolist()
    ecfg = EngineConfig(max_batch=SEQ_LANES)

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=SEQ_NEW)
                for i, p in enumerate(prompts)]

    warm = Request(rid=10_000, prompt=prompts[0][:1000], max_new_tokens=4)
    runs, pages = {}, {}
    for name in ("sharded", "unsharded"):
        if name == "sharded":
            eng = SeqShardedEngine(params, mcfg, CacheConfig(**SEQ_CACHE), ecfg,
                                   mesh=make_mesh(seq=SEQ_RANKS, devices=dev))
            start, ensure = eng._start_running, eng._ensure_capacity

            def keep(req, slot, pages_n, logits, eng=eng, start=start):
                pages[req.rid] = dict(before=eng.shard_pages(slot))
                start(req, slot, pages_n, logits)

            def tracked(slot, ahead=1, eng=eng, ensure=ensure):
                status = ensure(slot, ahead)
                pages[eng.running[slot].rid]["after"] = eng.shard_pages(slot)
                return status

            eng._start_running, eng._ensure_capacity = keep, tracked
            # one layer's rank calls at one decode step of the run (after
            # the warm request's steps), held against the plain versions
            record = recorded_rank_calls(
                [c[SEQ_HELD_LAYER] for c in eng.caches], after=SEQ_HELD_AFTER,
                trash=eng._trash_slot)
        else:
            eng = Engine(params, mcfg, CacheConfig(**SEQ_CACHE), ecfg)
            record = contextlib.nullcontext()
        with record as calls:
            runs[name] = run_engine(eng, reqs(), warm, profile_at=SEQ_NEW // 2)
        if name == "sharded":
            held = held_rank_b2(f"seq_serve layer {SEQ_HELD_LAYER}", calls)
            del calls
        pages.pop(10_000, None)
        del eng
        torch.cuda.empty_cache()
    got, want = runs["sharded"]["done"], runs["unsharded"]["done"]
    for rid in range(SEQ_LANES):
        g, w = got[rid], want[rid]
        if len(g.new_tokens) != SEQ_NEW or g.reason != "length":
            raise AssertionError(f"seq_serve: request {rid}: {g.reason}, "
                                 f"{len(g.new_tokens)} tokens")
        if g.tokens[:SEQ_PROMPT + 1] != w.tokens[:SEQ_PROMPT + 1]:
            raise AssertionError(f"seq_serve: request {rid}: prompt or first "
                                 "token differs from the unsharded engine")
        pg = pages[rid]
        if pg.get("after", pg["before"])[:-1] != pg["before"][:-1]:
            raise AssertionError(f"seq_serve: request {rid}: a rank other "
                                 f"than the last grew: {pg}")
    drift = {rid: stream_drift(params, mcfg, got[rid]) for rid in got}
    drift_unsharded = {rid: stream_drift(params, mcfg, want[rid])
                       for rid in want}
    check("seq_serve: teacher-forced drift", max(drift.values()),
          TOL_LOGPROB_INT4)
    launches = runs["sharded"]["launches"]
    for key in ("flash_fwd", "paged_attention_split", "paged_append_fused"):
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"seq_serve: kernel {key} never launched")
    row = {}
    for name, run in runs.items():
        decode = float(np.median(run["step_ms"][1:]))
        row[name] = dict(decode_ms_per_step=decode,
                         prefill_ms_per_request=(run["step_ms"][0] - decode)
                         / SEQ_LANES, steps=len(run["step_ms"]),
                         wall_s=run["wall_s"], launches=run["launches"],
                         one_step_profiled=run["profiled"])
    emit(dict(phase="seq_serve", ranks=SEQ_RANKS, lanes=SEQ_LANES,
              prompt_len=SEQ_PROMPT, new_tokens=SEQ_NEW, cache="int4",
              page=SEQ_CACHE["page_size"], agreement=agreement(got, want),
              drift=drift, drift_unsharded=drift_unsharded,
              drift_tol=TOL_LOGPROB_INT4, pages_per_rank=pages,
              held_b2=dict(held, layer=SEQ_HELD_LAYER), **row,
              phase_s=time.perf_counter() - t_phase))
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, held_b2=held)


def seq_decode_phase(dev) -> dict:
    """The sharded decode kernel path at the baseline's attention width:
    sharded_paged_attention over SEQ_RANKS int4 caches (the append on the
    last rank); each rank's B2 call and the last rank's fused append held
    against the plain versions on their own inputs (:func:`held_rank_b2`);
    the merged call against one B2 walk over one cache of the whole history: o
    within TOL_BF16, lse within TOL_LSE, the new token's pages bit for bit
    the single cache's and only the last rank's length grown. Two planted
    faults must fail: the append sent to rank 0, one shard's lse moved by
    ln 2. The merged call is timed against the single walk (device ms, a
    CUDA graph of calls)."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
    from tpu_flash_torch.ops.paged import paged_attention
    from tpu_flash_torch.parallel.mesh import make_mesh
    from tpu_flash_torch.parallel.ring_decode import (
        merge_shard_partials,
        sharded_paged_attention,
    )

    h, d, n, b, p = SEQ_DECODE_HEADS, 128, SEQ_DECODE_N, SEQ_LANES, SEQ_RANKS
    page, nl = 64, SEQ_DECODE_N // SEQ_RANKS
    pp = nl // page  # pages a lane a rank
    # one spare table entry a lane (the trash page): the rank-0 fault's
    # append lands there instead of past the table
    rank_cfg = CacheConfig(num_kv_heads=h, head_dim=d, page_size=page,
                           total_pages=b * pp + 1, max_seqs=b,
                           max_pages_per_seq=pp + 1, dtype="int4")
    one_cfg = CacheConfig(num_kv_heads=h, head_dim=d, page_size=page,
                          total_pages=b * pp * p + 1, max_seqs=b,
                          max_pages_per_seq=pp * p, dtype="int4")
    ranks = [PagedKVCache.create(rank_cfg, dev) for _ in range(p)]
    one = PagedKVCache.create(one_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    for lane in range(b):
        for c in ranks:
            c.page_tables[lane, :pp] = torch.arange(
                1 + lane * pp, 1 + (lane + 1) * pp, dtype=torch.int32)
        one.page_tables[lane] = torch.arange(
            1 + lane * pp * p, 1 + (lane + 1) * pp * p, dtype=torch.int32)
        k, v = (torch.randn(h, n - 1, d, generator=gen, device=dev).bfloat16()
                for _ in "kv")
        one.write_prompt(lane, k, v)
        for r, c in enumerate(ranks):
            part = slice(r * nl, min((r + 1) * nl, n - 1))
            c.write_prompt(lane, k[:, part], v[:, part])
        del k, v
    q, kn, vn = (torch.randn(b, h, d, generator=gen, device=dev).bfloat16()
                 for _ in range(3))
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    axis = make_mesh(seq=p, devices=dev).axis("seq")

    def copies(cs):
        return [dataclasses.replace(c, **{f: getattr(c, f).clone() for f in (
            "k_pages", "v_pages", "k_scales", "v_scales", "page_tables",
            "lengths")}) for c in cs]

    spare = copies(ranks)
    with recorded_rank_calls(ranks) as calls:
        kernels.reset_launches()
        o, lse, _ = sharded_paged_attention(q, ranks, slots, axis,
                                            new_kv=(kn, vn), return_lse=True)
        torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    # each rank's B2 call, and the tail's fused append, against the plain
    # versions on the same inputs
    held = held_rank_b2("seq_decode", calls)
    del calls
    ro, rl, _ = paged_attention(q, one, slots, new_kv=(kn, vn),
                                return_lse=True)

    def errs(o_, lse_, cs):
        """o and lse against the single walk, and the append's placement:
        every rank's lengths and the last rank's new token's bytes."""
        lens = [c.lengths[:b].tolist() for c in cs]
        want_lens = [[nl] * b] * p
        tail = cs[-1]
        placed = lens == want_lens and all(
            torch.equal(getattr(tail, f)[:, int(tail.page_tables[lane, pp - 1]),
                                          page - 1],
                        getattr(one, f)[:, int(one.page_tables[lane, p * pp - 1]),
                                        page - 1])
            for lane in range(b) for f in ("k_pages", "v_pages", "k_scales",
                                            "v_scales"))
        return dict(o=max_err(o_, ro), lse=max_err(lse_, rl), placed=placed)

    def passes(e):
        return e["o"] <= TOL_BF16 and e["lse"] <= TOL_LSE and e["placed"]

    main = errs(o, lse, ranks)
    if not passes(main):
        raise AssertionError(f"seq_decode: {main}")
    fo, fl, _ = sharded_paged_attention(q, spare, slots, axis, new_kv=(kn, vn),
                                        return_lse=True, owns_append=0)
    fault_rank0 = errs(fo, fl, spare)
    del spare
    parts = [paged_attention(q, c, slots, return_lse=True) for c in ranks]
    ro0, rl0 = paged_attention(q, one, slots, return_lse=True)

    def merged(shift):
        lses = [x for _, x in parts]
        lses[1] = lses[1] + shift
        mo, ml = merge_shard_partials([x for x, _ in parts], lses, axis,
                                      return_lse=True)
        return dict(o=max_err(mo, ro0), lse=max_err(ml, rl0))

    unshifted, fault_lse = merged(0.0), merged(math.log(2.0))
    if not (unshifted["o"] <= TOL_BF16 and unshifted["lse"] <= TOL_LSE):
        raise AssertionError(f"seq_decode merge: {unshifted}")
    for name, e in (("append on rank 0", fault_rank0),
                    ("lse moved by ln 2", fault_lse)):
        if e["o"] <= TOL_BF16 and e["lse"] <= TOL_LSE and e.get("placed", True):
            raise AssertionError(f"seq_decode: planted fault {name} passed")
    ms = device_ms(lambda: sharded_paged_attention(q, ranks, slots, axis))
    single_ms = device_ms(lambda: paged_attention(q, one, slots,
                                                  return_lse=True))
    # bytes: every page row the history holds (int4 values and f32
    # scales of K and V), q read, o and lse written
    nbytes = b * h * n * 2 * (d // 2 + 4) + b * h * d * 2 * 2 + b * h * 4
    bound = roofline(0, nbytes, torch.bfloat16)
    emit(dict(phase="seq_decode", lanes=b, heads=h, d=d, tokens=n, ranks=p,
              page=page, cache="int4", per_rank_vs_plain=held,
              vs_single_walk=main,
              merge_without_append=unshifted,
              faults=dict(append_on_rank0=fault_rank0,
                          lse_moved_ln2=fault_lse),
              launches=launches, merged_ms=ms, single_walk_ms=single_ms,
              **bound))
    del ranks, one
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, single_walk_ms=single_ms,
                max_abs_err=max(main["o"], main["lse"]), held_b2=held,
                **bound)


class _RankCounts:
    """Launch counts by tensor-parallel rank: wraps the engine's AxisGroup
    map, so each rank's work is counted on its own, and its round graphs'
    capture, so a graph's launches a rank are known and count once a
    replay (``ran``)."""

    def __init__(self, eng):
        from tpu_flash_torch import kernels

        tp = eng.tp
        self.eager = [dict() for _ in range(tp.local)]
        self.graphs, self.replays = {}, {}
        self._into = self.eager
        base_map, base_graph = tp.map, eng._round_graph

        def counted_map(fn, *per_rank):
            def one(i, *args):
                before = dict(kernels.LAUNCHES)
                out = fn(i, *args)
                for k, n in kernels.LAUNCHES.items():
                    if n != before[k]:
                        self._into[i][k] = (self._into[i].get(k, 0)
                                            + n - before[k])
                return out
            return base_map(one, *per_rank)

        def counted_graph(pages_bound, K):
            key = (pages_bound, K)
            if key not in self.graphs:
                self.graphs[key] = self._into = [dict() for _ in self.eager]
            try:
                g = base_graph(pages_bound, K)
            finally:
                self._into = self.eager
            self.replays[key] = self.replays.get(key, 0) + 1
            return g

        tp.map, eng._round_graph = counted_map, counted_graph

    def reset(self) -> None:
        """Zero the eager counts and the replays (the captures stay)."""
        self.eager = [dict() for _ in self.eager]
        self._into, self.replays = self.eager, {}

    def ran(self) -> list:
        """Each rank's launches since ``reset``: eager, plus each graph's
        a replay."""
        out = []
        for i, eager in enumerate(self.eager):
            tot = dict(eager)
            for key, n in self.replays.items():
                for k, c in self.graphs[key][i].items():
                    tot[k] = tot.get(k, 0) + c * n
            out.append(tot)
        return out


def tp_serve_phase(dev) -> dict:
    """Tensor-parallel serving at the engine phase's cell (16 × (512 + 32)
    tokens, int8 cache) with int8 weights in rounds of TP_ROUNDS (CUDA
    graphs), over 2 and 4 ranks on the card, against the unsharded engine
    of the same weights: agreement ≥ TOL_TP_AGREE, drift ≤ TOL_LOGPROB; the
    float32 model's forward within TOL_F32 of max |logit| of the unsharded
    one, and one rank's row-parallel partial left out of the sum must fail
    that; the bf16 TP forward no further from the float32 logits than the
    unsharded bf16 forward is, plus TOL_TP_BF16. Prints ms a
    round and a token, each rank's launches and the graph replays."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.parallel import shardings
    from tpu_flash_torch.parallel.mesh import AxisGroup, make_mesh
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    t_phase = time.perf_counter()
    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (N_REQUESTS + 1, PROMPT_LEN)).tolist()
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=NEW_TOKENS)
            for i in range(N_REQUESTS)]
    # the warm-up request: the graphs of the run's buckets captured before
    warm = Request(rid=10_000, prompt=prompts[-1], max_new_tokens=NEW_TOKENS)
    qparams = tfm.quantize_weights(params)
    ecfg = EngineConfig(max_batch=MAX_BATCH, decode_steps=TP_ROUNDS)
    runs, ranks = {}, {}
    for size in (1, *TP_SIZES):
        mesh = make_mesh(model=size, devices=dev) if size > 1 else None
        eng = Engine(qparams, mcfg, CacheConfig(**CACHE), ecfg, mesh=mesh)
        counts = _RankCounts(eng) if size > 1 else None
        eng.submit(dataclasses.replace(warm))
        eng.run()
        if counts is not None:
            counts.reset()
        run = run_engine(eng, [dataclasses.replace(r) for r in reqs])
        run["graphs"] = sorted(eng._graphs)
        if counts is not None:
            ranks[size] = counts.ran()
        runs[size] = run
        del eng
        torch.cuda.empty_cache()
    want = runs[1]["done"]
    rows = {}
    for size, run in runs.items():
        got = run["done"]
        if sorted(got) != list(range(N_REQUESTS)):
            raise AssertionError(f"tp_serve {size}: finished {sorted(got)}")
        agree = agreement(got, want)
        worst = min(a["agree"] for a in agree.values())
        if size > 1 and worst < TOL_TP_AGREE:
            raise AssertionError(f"tp_serve {size}: agreement {worst}")
        drift = max(stream_drift(qparams, mcfg, got[rid]) for rid in range(4))
        check(f"tp_serve {size}: drift", drift, TOL_LOGPROB)
        step = float(np.median(run["step_ms"][1:]))
        for key in ("flash_fwd", "paged_attention_split",
                    "paged_append_fused"):
            if run["launches"].get(key, 0) <= 0:
                raise AssertionError(f"tp_serve {size}: {key} never launched")
        rows[size] = dict(
            min_agreement=worst, agreement_parts_at={
                rid: a["parts_at"] for rid, a in agree.items()
                if a["parts_at"] is not None},
            drift_4_requests=drift, ms_a_round=step,
            ms_a_token=step / TP_ROUNDS, steps=len(run["step_ms"]),
            wall_s=run["wall_s"],
            warm_tok_s=N_REQUESTS * NEW_TOKENS / run["wall_s"],
            launches=run["launches"], graph_replays=run["replays"],
            graphs=run["graphs"],
            launches_by_rank=ranks.get(size))
    del qparams
    torch.cuda.empty_cache()
    # the forwards: float32 TP against the unsharded float32 model (the
    # gate), and with the last rank's partial left out of every sum (must
    # fail it); bf16 TP against the unsharded bf16 forward (printed, the
    # reference test's 5e-2 is a 2-layer model's) and against the float32
    # logits, where TP may add at most TOL_TP_BF16 to the unsharded bf16
    # model's own distance from them
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        1, mcfg.vocab_size - 1, TP_FORWARD_TOKENS), device=dev)
    fwd = {}
    fcfg = dataclasses.replace(mcfg, dtype="float32")
    fparams = {"embed": params["embed"].float(), "ln_f": params["ln_f"],
               "layers": [{k: w.float() for k, w in lp.items()}
                          for lp in params["layers"]]}
    ref = tfm.forward(fparams, toks, fcfg)
    scale = float(ref.abs().max())
    bf16 = tfm.forward(params, toks, mcfg)
    fwd["bf16_unsharded_vs_float32"] = max_err(bf16, ref)
    for size in TP_SIZES:
        tp = make_mesh(model=size, devices=dev).axis("model")
        got = tfm.forward(shardings.shard_params(params, tp), toks, mcfg, tp=tp)
        fwd[f"bf16_tp{size}_vs_bf16_unsharded"] = max_err(got, bf16)
        fwd[f"bf16_tp{size}_vs_float32"] = max_err(got, ref)
        check(f"tp forward bf16 {size} vs float32",
              fwd[f"bf16_tp{size}_vs_float32"],
              fwd["bf16_unsharded_vs_float32"] + TOL_TP_BF16)
    del bf16, got, params
    torch.cuda.empty_cache()

    class DropLast(AxisGroup):
        def sum(self, parts):
            return super().sum(list(parts)[:-1])

    for size in TP_SIZES:
        tp = make_mesh(model=size, devices=dev).axis("model")
        sliced = shardings.shard_params(fparams, tp)
        fwd[f"float32_tp{size}_rel"] = max_err(
            tfm.forward(sliced, toks, fcfg, tp=tp), ref) / scale
        check(f"tp forward float32 {size}", fwd[f"float32_tp{size}_rel"],
              TOL_F32)
        bad = DropLast(**{f.name: getattr(tp, f.name)
                          for f in dataclasses.fields(tp)})
        fwd[f"fault_drop_last_partial_tp{size}_rel"] = max_err(
            tfm.forward(sliced, toks, fcfg, tp=bad), ref) / scale
        if fwd[f"fault_drop_last_partial_tp{size}_rel"] <= TOL_F32:
            raise AssertionError("tp: the dropped partial passed")
        del sliced
    del fparams, ref
    torch.cuda.empty_cache()
    launches = {size: runs[size]["launches"] for size in TP_SIZES}
    emit(dict(phase="tp_serve", requests=N_REQUESTS, prompt_len=PROMPT_LEN,
              new_tokens=NEW_TOKENS, cache="int8", weights="int8",
              decode_steps=TP_ROUNDS, ranks_on_one_card=list(TP_SIZES),
              by_ranks={("unsharded" if k == 1 else f"tp{k}"): v
                        for k, v in rows.items()},
              forward=fwd, forward_tokens=list(TP_FORWARD_TOKENS),
              tol=dict(agree=TOL_TP_AGREE, drift=TOL_LOGPROB,
                       bf16=TOL_TP_BF16, float32_rel=TOL_F32),
              phase_s=time.perf_counter() - t_phase))
    return dict(launches={k: sum(launches[s].get(k, 0) for s in TP_SIZES)
                          for k in set().union(*launches.values())})


def ulysses_phase(dev) -> dict:
    """Ulysses (parallel/ulysses.py) at the ring phase's width over
    ULYSSES_RANKS ranks: dense, causal, local (r RING_RADIUS) and
    circulant against the single-device kernels and the ring within
    TOL_BF16; the causal gradient (RING_GRAD_SHAPE) within TOL_BWD_ORACLE
    of the largest; the fp8 route against its matched oracle within
    TOL_QUANT_GATE; the inverse all-to-all with its rank order reversed
    must fail. Timed beside the single-device call and the ring."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.parallel import ring, ulysses
    from tpu_flash_torch.parallel.mesh import make_mesh
    from tpu_flash_torch.parallel.ulysses import ulysses_attention

    t_phase = time.perf_counter()
    b, h, n, d = RING_SHAPE
    p, r = ULYSSES_RANKS, RING_RADIUS
    window = 2 * r + 1
    axis = make_mesh(seq=p, devices=dev).axis("seq")
    gen = torch.Generator(device=dev).manual_seed(51)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    cases = {
        "dense": (dict(schedule="dense"), lambda: flash.dense_fa(q, k, v)),
        "causal": (dict(schedule="causal"),
                   lambda: flash.dense_fa(q, k, v, causal=True)),
        "local": (dict(schedule="local", radius=r),
                  lambda: flash.sliding_fa(q, k, v, window)),
        "circulant": (dict(schedule="circulant", radius=r),
                      lambda: flash.circulant_fa(q, k, v, window)),
    }
    ring_pattern = dict(dense="dense", causal="causal", local="local",
                        circulant="circulant")
    path = {}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        ran = {key: c for key, c in kernels.LAUNCHES.items() if c}
        for key, c in ran.items():
            path[key] = path.get(key, 0) + c
        return out, ran

    rows = {}
    for name, (kw, single) in cases.items():
        o, ran = counted(lambda: ulysses_attention(q, k, v, axis, **kw))
        if ran.get("flash_fwd") != p or len(ran) != 1:
            raise AssertionError(f"ulysses {name}: launches {ran}")
        e_single = max_err(o, single())
        e_ring = max_err(o, ring.ring_dense_fa(
            q, k, v, p, pattern=ring_pattern[name], radius=r))
        check(f"ulysses {name} vs single-device", e_single, TOL_BF16)
        check(f"ulysses {name} vs ring", e_ring, TOL_BF16)
        rows[name] = dict(vs_single_device=e_single, vs_ring=e_ring,
                          launches=ran)
        del o
    inverse = ulysses._heads_to_seq
    with mock.patch.object(ulysses, "_heads_to_seq",
                           lambda parts, spec: inverse(parts[::-1], spec)):
        bad = ulysses_attention(q, k, v, axis, schedule="causal")
    fault = max_err(bad, cases["causal"][1]())
    if fault <= TOL_BF16:
        raise AssertionError("ulysses: the reversed inverse passed")
    del bad
    # the fp8 route on the local band against the matched oracle
    o, ran = counted(lambda: ulysses_attention(
        q, k, v, axis, schedule="local", radius=r, q_dtype=QB_FP8,
        kv_dtype=QB_FP8))
    matched = ring_oracle_inputs(q, k, v, 1, QB_FP8, QB_FP8)
    bands = ring_band_errs(o, *matched, dict(window_size=window), 1.0)
    del matched, o
    check("ulysses fp8 vs matched oracle", max(bands), TOL_QUANT_GATE)
    rows["local_fp8"] = dict(vs_matched_oracle_bands=bands, launches=ran)
    # the causal gradient
    gb, gh, gn, gd = RING_GRAD_SHAPE
    gq, gk, gv = (torch.randn(gb, gh, gn, gd, generator=gen, device=dev)
                  .bfloat16() for _ in range(3))
    gw = torch.randn(gb, gh, gn, gd, generator=gen, device=dev)

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (gq, gk, gv)]
        (fn(*xs).float() * gw).sum().backward()
        return [x.grad for x in xs]

    with torch.enable_grad():
        got, ran = counted(lambda: grads(lambda a, b_, c: ulysses_attention(
            a, b_, c, axis, schedule="causal")))
        want = grads(lambda a, b_, c: flash.dense_fa(a, b_, c, causal=True))
    gerr = {f"d{x}": rel_err(a, w_) for x, a, w_ in zip("qkv", got, want)}
    for x, e in gerr.items():
        check(f"ulysses grad {x}", e, TOL_BWD_ORACLE)
    rows["causal_grad"] = dict(errs=gerr, launches=ran)
    del got, want, gq, gk, gv, gw
    torch.cuda.empty_cache()
    for name, (kw, single) in cases.items():
        rows[name]["ulysses_ms"] = cuda_ms(
            lambda: ulysses_attention(q, k, v, axis, **kw), iters=3, warmup=1)
        rows[name]["single_device_ms"] = cuda_ms(single, iters=3, warmup=1)
        rows[name]["ring_ms"] = cuda_ms(lambda: ring.ring_dense_fa(
            q, k, v, p, pattern=ring_pattern[name], radius=r), iters=3,
            warmup=1)
    emit(dict(phase="ulysses", shape=dict(zip("b h n d".split(), RING_SHAPE)),
              ranks=p, radius=r, rows=rows, fault_reversed_inverse=fault,
              grad_shape=dict(zip("b h n d".split(), RING_GRAD_SHAPE)),
              path_launches=path,
              note="one card: the all-to-all between virtual ranks is a "
                   "concatenation on the card; no communication is measured",
              phase_s=time.perf_counter() - t_phase))
    del q, k, v
    torch.cuda.empty_cache()
    return dict(launches=path)


def parallel_phases(dev) -> dict:
    """The four phases of the parallel modules, in order."""
    out = {}
    with torch.no_grad():
        out["seq_serve"] = seq_serve_phase(dev)
        out["seq_decode"] = seq_decode_phase(dev)
        out["tp_serve"] = tp_serve_phase(dev)
    out["ulysses"] = ulysses_phase(dev)
    return out


# ---- the serving features: speculation, the prefix cache, resume --------

# the speculative path (scripts/r2_exp6.py part B): the canonical model over
# r2_exp6's int8 cache (512 pages of 64, 24 slots of up to 64 pages), 16
# lanes, 8 prompts of 128 tokens, 64 new tokens each; r2_exp6's 2-layer
# draft (:39-43: vocab 32000, dim 512, 4/4 heads, d 128, its own seed) at
# speculate_k 2 and 4, then the target as its own draft at K 4 on 4
# prompts. Exactness is held on the float32 model of the same weights over
# a float32 cache; the served bf16 model against a teacher-forced forward
SPEC_CACHE = dict(CACHE, total_pages=512, max_seqs=24)
SPEC_DRAFT = dict(vocab_size=32000, dim=512, num_layers=2, num_q_heads=4,
                  num_kv_heads=4, head_dim=128)
SPEC_PROMPTS, SPEC_PROMPT_LEN, SPEC_NEW = 8, 128, 64
SPEC_KS = (2, 4)
SELF_DRAFT_K, SELF_DRAFT_PROMPTS = 4, 4
# the prefix cache (r2_exp6 part A): 8 requests of a shared 2048-token
# system prompt and 64 tokens of their own, 16 new tokens each, on the
# same model and cache: cold, then with the cache twice (the second run is
# the steady state); a hit's last-prompt logits against the cold run's at
# the chunked-vs-unchunked rule (TOL_LOGPROB)
PC_SYSTEM, PC_OWN, PC_REQUESTS, PC_NEW = 2048, 64, 8, 16
# resume: the engine cell snapshotted after RESUME_AT steps (the first
# admits and prefills) and run to the end in a fresh engine: tokens equal,
# logprobs within TOL_STEPS_LOGPROB; the same with int8 weights in rounds
# of MULTISTEP_K; supervised runs of the engine cell with a crash at
# SUP_CRASH_AT, snapshots every SUP_EVERY steps, on a pool cut to
# SUP_PAGES pages (the 16 requests hold 256; each snapshot writes the
# weights and every page)
RESUME_AT = 12
RESUME_ROUNDS_AT = 2  # rounds of 8: 17 of 32 tokens committed
SUP_EVERY, SUP_CRASH_AT, SUP_PAGES = 16, 20, 288


def _features():
    from tpu_flash_torch import kernels
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.serving import engine as eng_mod

    return kernels, CacheConfig, tfm, eng_mod


def ran(kernels) -> dict:
    """The kernels that launched since the counts were reset."""
    return {k: n for k, n in kernels.LAUNCHES.items() if n}


def launched(phase: str, launches: dict, keys) -> None:
    """Each of these kernels launched in the phase's main path run."""
    for key in keys:
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"{phase}: {key} never launched")


def native_pool(eng) -> None:
    """The engine's page pool is the port's native one on the card."""
    if not eng._alloc.native:
        raise AssertionError("the engine's allocator is not the native pool")


def spec_serve(params, mcfg, prompts, dev, cache, draft=None, k=0):
    """Serve ``prompts`` greedily (after a warm-up request) through an
    engine with the draft at ``speculate_k`` k (or plainly); return the
    finished requests, the wall time, the launches, the acceptance and the
    target's decode calls (one-token steps and verify calls)."""
    kernels, CacheConfig, _, eng_mod = _features()
    new = SPEC_NEW
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**cache),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH,
                                              speculate_k=k),
                         draft=draft)
    native_pool(eng)
    eng.submit(eng_mod.Request(rid=10_000, prompt=prompts[0][:64],
                               max_new_tokens=8))
    eng.run()
    calls = dict(target=0, draft=0)

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    eng._step = counted("target", eng._step)
    eng._decode_speculative = counted("target", eng._decode_speculative)
    if eng._draft is not None:
        eng._draft_step = counted("draft", eng._draft_step)
    st0 = eng.spec_stats()
    n0 = len(eng.finished)
    torch.cuda.synchronize()
    for i, p in enumerate(prompts):
        eng.submit(eng_mod.Request(rid=i, prompt=p, max_new_tokens=new))
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {f.rid: f for f in eng.finished[n0:]}
    st = eng.spec_stats()
    proposed = st["proposed"] - st0["proposed"]
    accepted = st["accepted"] - st0["accepted"]
    tokens = sum(len(f.new_tokens) for f in done.values())
    out = dict(done=done, wall_s=wall, launches=ran(kernels),
               tok_s=tokens / wall, tokens=tokens, proposed=proposed,
               accepted=accepted,
               acceptance=accepted / proposed if proposed else None,
               target_calls=calls["target"], draft_steps=calls["draft"],
               # a decode call serves every lane: calls over the tokens a
               # request made after its first (prefill's)
               target_calls_per_token=calls["target"] / (new - 1))
    del eng
    torch.cuda.empty_cache()
    return out


def verify_step_distance(params, mcfg, prompts, dev, K, cache) -> float:
    """max |decode_verify of K tokens − K decode_steps| over the logits of
    the prompts' lanes (prefilled by an engine): how far the verify call's
    logits may lie from the plain step's in this model."""
    _, CacheConfig, tfm, eng_mod = _features()
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**cache),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH))
    for i, p in enumerate(prompts):
        eng.submit(eng_mod.Request(rid=i, prompt=p, max_new_tokens=8))
    eng._admit()
    n = len(prompts)
    caches = eng.caches
    steps = [_cache_copy(c) for c in caches]
    del eng
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(1, mcfg.vocab_size - 1, (n, K)),
                           device=dev)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    base = caches[0].lengths[:n].clone()
    got, _ = tfm.decode_verify(params, toks, base, caches, slots, mcfg)
    want = torch.stack([tfm.decode_step(params, toks[:, j], base + j, steps,
                                        slots, mcfg)[0] for j in range(K)],
                       dim=1)
    dist = float((got - want).abs().max())
    del caches, steps
    torch.cuda.empty_cache()
    return dist


def stream_partings(params, mcfg, plain, got, dist) -> list:
    """Where each of ``got``'s streams parts from ``plain``'s: the new
    token's index, and the plain stream's top-2 logit gap there (a
    teacher-forced forward over the plain stream). A parting is allowed
    only where that gap is below ``dist`` (a near-tie the verify call may
    break the other way)."""
    _, _, tfm, _ = _features()
    out = []
    for rid, g in sorted(got.items()):
        f = plain[rid]
        at = next((i for i, (a, b) in enumerate(zip(f.new_tokens,
                                                    g.new_tokens))
                   if a != b), None)
        if at is None and len(g.new_tokens) == len(f.new_tokens):
            continue
        at = min(len(f.new_tokens), len(g.new_tokens)) if at is None else at
        n0 = len(f.tokens) - len(f.new_tokens)
        toks = torch.tensor([f.tokens[:n0 + at]],
                            device=params["embed"].device)
        logits = tfm.forward(params, toks, mcfg)[0, -1].float()
        top = torch.topk(logits, 2).values
        gap = float(top[0] - top[1])
        out.append(dict(rid=rid, new_token=at, top2_gap=gap,
                        allowed=gap < dist))
    return out


def spec_kernel_checks(params, mcfg, draft, prompts, dev) -> dict:
    """One speculative round at K 4 on the served model, its B2 calls
    recorded: every layer's verify call (64 lanes, visible lengths) held
    against the plain version on its own inputs (:func:`held_verify_b2`),
    and the first draft micro-step's last-layer call — B2 with B3's
    append fused, on the draft's 4 kv heads (G 1) — re-run on a copy of
    the cache as it found it: its o the main path's bit for bit, o and
    lse against the plain B2 after the plain B3, the pages bit for bit."""
    _, CacheConfig, tfm, eng_mod = _features()
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**SPEC_CACHE),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH,
                                              speculate_k=4), draft=draft)
    native_pool(eng)
    for i, p in enumerate(prompts):
        eng.submit(eng_mod.Request(rid=i, prompt=p, max_new_tokens=8))
    eng._admit()
    real = tfm.paged_attention
    dlast = eng._draft["caches"][-1]
    calls = dict(verify=[], draft=None)

    def recorded(q, cache, slots, **kw):
        if kw.get("lengths_override") is not None:
            o = real(q, cache, slots, **kw)
            calls["verify"].append(dict(q=q.clone(), cache=cache,
                                        slots=slots, kw=kw, o=o))
            return o
        if cache is dlast and calls["draft"] is None:
            rec = dict(q=q.clone(), pre=_cache_copy(cache),
                       slots=slots.clone(), kw=kw,
                       new_kv=tuple(t.clone() for t in kw["new_kv"]))
            out = real(q, cache, slots, **kw)
            rec["o"] = out[0].clone()
            calls["draft"] = rec
            return out
        return real(q, cache, slots, **kw)

    tfm.paged_attention = recorded
    try:
        eng._decode()
        torch.cuda.synchronize()
    finally:
        tfm.paged_attention = real
    if len(calls["verify"]) != mcfg.num_layers or calls["draft"] is None:
        raise AssertionError("speculative round: B2 calls not recorded")
    verify = held_verify_b2(calls["verify"])
    draft_step = held_fused_b2(calls["draft"], "draft micro-step")
    del eng, calls
    torch.cuda.empty_cache()
    return dict(verify=verify, draft_step=draft_step)


def record_fused(cache, rec: dict):
    """A recorder for ``tfm.paged_attention``: the first decode call on
    ``cache`` (B2 with B3's append fused) goes into ``rec`` with a copy
    of the cache as it found it, its inputs and its o."""
    from tpu_flash_torch.models import transformer as tfm

    real = tfm.paged_attention

    def recorded(q, c, slots, **kw):
        if c is cache and not rec and kw.get("new_kv") is not None:
            rec.update(q=q.clone(), pre=_cache_copy(c), slots=slots.clone(),
                       kw=kw, new_kv=tuple(t.clone() for t in kw["new_kv"]))
            out = real(q, c, slots, **kw)
            rec["o"] = out[0].clone()
            return out
        return real(q, c, slots, **kw)

    return recorded


def held_fused_b2(d: dict, name: str, tol_lse=TOL_BF16,
                  upper_half=False) -> dict:
    """A recorded decode call (:func:`record_fused`) re-run on a copy of
    the cache as it found it: its o the main path's bit for bit; the
    pages bit for bit B3's plain append; o within TOL_BF16 and lse within
    ``tol_lse`` of the plain B2 after it, under the card's split plan;
    with ``upper_half`` the plain B2 on pages whose V hides columns
    256–511 must fail that check."""
    from tpu_flash_torch.ops import paged

    c, q, slots = d["pre"], d["q"], d["slots"]
    pt = c.config.page_type
    b, qh, hd = q.shape
    kvh = c.k_pages.shape[0]
    qscale = hd ** -0.5 * paged.LOG2E
    qr = q.reshape(b, kvh, qh // kvh, hd)
    qg = (qr.float() * qscale).bfloat16()
    walk = paged.plan_pages(c.config)
    bound = min(d["kw"]["pages_bound"] or walk, walk)
    kn, vn = d["new_kv"]

    def fused(cache, want_lse):
        return paged._paged_attention_kernel(
            qr, cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
            slots, cache.lengths, cache.page_tables, 1, bound, q.dtype,
            want_lse, new_kv=(kn, vn), q_scale=qscale, walk=walk,
            page_type=pt)

    main = fused(_cache_copy(c), False)
    fc, pc = _cache_copy(c), _cache_copy(c)
    got = fused(fc, True)
    torch.cuda.synchronize()
    if not torch.equal(main[0].reshape(b, qh, hd), d["o"]):
        raise AssertionError(f"{name} B2: the wrapper's o is not the main "
                             "path's")
    paged._paged_append_plain(kn, vn, pc.k_pages, pc.v_pages, pc.k_scales,
                              pc.v_scales, slots, pc.lengths, pc.page_tables,
                              page_type=pt)
    _same_cache(f"{name} fused B3", fc, pc)
    split = _card_plan(qg, pc)

    def plain(cache):
        return paged._paged_attention_plain(
            qg, *_b2_args(qg, cache, slots, 1, bound)[1:], split_pages=split,
            page_type=pt)

    errs = _held_b2(f"{name} B2", got, plain(pc), tol_lse=tol_lse)
    if upper_half:
        errs["planted_fault_v_upper_half"] = _rejects(
            f"{name} B2 (V columns 256-511 hidden)", got,
            plain(_upper_half_hidden(pc)))
    return dict(lanes=b, kv_heads=kvh, g=qh // kvh, d=hd, page_type=pt,
                pages_bound=bound, split_pages=split, append_bit_exact=True,
                main_path_o_bitwise=True, tol=TOL_BF16, **errs)


def speculative_phase(dev, smi: str) -> dict:
    """Speculative decoding at full width: plain, the 2-layer draft at K 2
    and 4, a self-draft at K 4 (wall, tok/s, acceptance, target calls a
    token); in float32 every speculative greedy stream equals the plain
    one but at near-ties (a planted fault, one proposal too many accepted,
    must fail that check); the bf16 streams' drift; B2 and B3 on the
    round's calls against their plain versions."""
    kernels, CacheConfig, tfm, eng_mod = _features()
    mcfg = tfm.ModelConfig(**MODEL)
    dcfg = tfm.ModelConfig(**SPEC_DRAFT)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (SPEC_PROMPTS, SPEC_PROMPT_LEN)).tolist()
    runs, exact = {}, {}
    for dtype in ("float32", "bfloat16"):
        m = tfm.ModelConfig(**MODEL, dtype=dtype)
        d = tfm.ModelConfig(**SPEC_DRAFT, dtype=dtype)
        params = tfm.init_params(m, torch.Generator(device=dev).manual_seed(0),
                                 dev)
        draft = (tfm.init_params(d, torch.Generator(device=dev).manual_seed(1),
                                 dev), d)
        cache = dict(SPEC_CACHE, dtype="float32" if dtype == "float32"
                     else SPEC_CACHE["dtype"])
        r = dict(plain=spec_serve(params, m, prompts, dev, cache))
        for k in SPEC_KS:
            r[f"draft_k{k}"] = spec_serve(params, m, prompts, dev, cache,
                                          draft, k)
        r["self_k4"] = spec_serve(params, m, prompts[:SELF_DRAFT_PROMPTS],
                                  dev, cache, (params, m), SELF_DRAFT_K)
        if dtype == "float32":
            dist = verify_step_distance(params, m, prompts, dev, 4, cache)
            plain = r["plain"]["done"]
            parts = {name: stream_partings(params, m, plain, run["done"],
                                           dist)
                     for name, run in r.items() if name != "plain"}
            # the planted fault: one proposal more than the coins accepted
            real = eng_mod._spec_accept

            def one_too_many(toks, p_all, q, keys):
                acc, final = real(toks, p_all, q, keys)
                return torch.clamp_max(acc + 1, toks.shape[1] - 1), final

            eng_mod._spec_accept = one_too_many
            try:
                fault = spec_serve(params, m, prompts, dev, cache, draft, 2)
            finally:
                eng_mod._spec_accept = real
            fault_parts = stream_partings(params, m, plain, fault["done"],
                                          dist)
            bad = {name: [p for p in ps if not p["allowed"]]
                   for name, ps in parts.items()}
            exact = dict(verify_vs_step_distance=dist,
                         partings={n: ps for n, ps in parts.items() if ps},
                         parted_requests=sum(len(ps) for ps in parts.values()),
                         fault_partings=len(fault_parts),
                         fault_rejected=sum(not p["allowed"]
                                            for p in fault_parts))
            if any(bad.values()):
                raise AssertionError(f"speculative greedy (float32) parts "
                                     f"from plain greedy beyond a near-tie: "
                                     f"{bad}")
            if not exact["fault_rejected"]:
                raise AssertionError("the planted fault (one proposal too "
                                     f"many) passes the stream check: "
                                     f"{fault_parts}")
            for name, run in r.items():
                exact[f"{name}_acceptance"] = run["acceptance"]
            del params, draft, r, fault
            torch.cuda.empty_cache()
            continue
        runs = r
        served = (params, draft)
    params, draft = served
    drift = max(teacher_forced_drift(params, mcfg, runs[name]["done"][0])
                for name in runs)
    check("speculative: teacher-forced logprob drift", drift, TOL_LOGPROB)
    for name, run in runs.items():
        n = SELF_DRAFT_PROMPTS if name == "self_k4" else SPEC_PROMPTS
        if sorted(run["done"]) != list(range(n)) or any(
                len(f.new_tokens) != SPEC_NEW or f.reason != "length"
                or not all(np.isfinite(f.logprobs))
                for f in run["done"].values()):
            raise AssertionError(f"speculative {name}: unfinished streams")
    plain = runs["plain"]["done"]
    agree = {name: agreement(
        {rid: plain[rid] for rid in run["done"]}, run["done"])
        for name, run in runs.items() if name != "plain"}
    main = runs[f"draft_k{SPEC_KS[-1]}"]
    launched("speculative", main["launches"], (
        "flash_fwd", "paged_attention_split", "paged_append",
        "paged_append_fused"))
    if runs["self_k4"]["accepted"] != runs["self_k4"]["proposed"]:
        print(f"self-draft bf16 acceptance {runs['self_k4']['acceptance']}",
              file=sys.stderr)
    checks = spec_kernel_checks(params, mcfg, draft, prompts, dev)
    row = dict(
        phase="speculative", nvidia_smi=smi, cache=SPEC_CACHE["dtype"],
        pages=SPEC_CACHE["total_pages"], lanes=MAX_BATCH,
        requests=SPEC_PROMPTS, prompt_len=SPEC_PROMPT_LEN,
        new_tokens=SPEC_NEW, draft=SPEC_DRAFT,
        runs={name: {k: v for k, v in run.items() if k != "done"}
              for name, run in runs.items()},
        bf16_agreement_with_plain=agree, teacher_forced_drift=drift,
        drift_tol=TOL_LOGPROB, float32=exact, kernels=checks)
    emit(row)
    del params, draft
    torch.cuda.empty_cache()
    return dict(launches=main["launches"], checks=checks)


def pc_serve(params, mcfg, prompts, dev, prefix_cache, warm, record=None,
             hit_length_zero=False):
    """Serve the requests through :func:`serve` (whole-prompt prefills and
    hit tails timed too, each ending in a synchronise) on an engine with
    or without the prefix cache; ``record``: a function the engine's B2
    calls go through; ``hit_length_zero``: the planted fault, a hit
    admitted with length 0. Returns serve's result with the prefill ms,
    the cache's statistics of the run, the engine."""
    _, CacheConfig, tfm, eng_mod = _features()
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**SPEC_CACHE),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH,
                                              prefix_cache=prefix_cache))
    native_pool(eng)
    prefill_ms = []
    whole = eng._prefill

    def timed_prefill(*a):
        t0 = time.perf_counter()
        whole(*a)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)

    eng._prefill = timed_prefill
    if hit_length_zero:
        sync = eng._sync_slot_tables
        eng._sync_slot_tables = lambda slot, set_length=None: sync(
            slot, 0 if set_length else set_length)
    stats0 = {}
    submit = eng.submit

    def counted_from(req):  # the run's statistics start at its first request
        if req.rid == 0 and eng._pcache is not None:
            stats0.update(eng._pcache.stats())
        submit(req)

    eng.submit = counted_from
    real = tfm.paged_attention
    if record is not None:
        tfm.paged_attention = functools.partial(record, real, eng)
    try:
        out = serve(eng, [eng_mod.Request(rid=i, prompt=p,
                                          max_new_tokens=PC_NEW)
                          for i, p in enumerate(prompts)], warm)
    finally:
        tfm.paged_attention = real
    torch.cuda.synchronize()
    n = len(prompts)
    out["prefill_ms"] = sum(prefill_ms[-n:]) if not prefix_cache else None
    out["engine"] = eng
    # the run's own times: later calls on the engine (pc_profile) append
    out["prefill_calls_ms"] = list(prefill_ms)
    out["chunk"] = list(out["chunk"])
    if eng._pcache is not None:
        st = eng._pcache.stats()
        out["stats"] = st
        out["run_stats"] = {k: st[k] - stats0.get(k, 0)
                            for k in ("hits", "misses", "hit_tokens")}
    return out


def held_shared_b2(q, cache, slots, kw, o, lse, upper_half=False) -> dict:
    """B2's shared-table route on the inputs a hit's tail chunk gave it
    (the chunk's lanes over the cached prefix), before the chunk's write:
    re-run, bitwise the main path's; o within TOL_BF16, lse within TOL_LSE
    of the plain version (one walk); the prefix's first half of pages read
    as its second half must fail that check, and with ``upper_half`` V's
    columns 256–511 hidden."""
    from tpu_flash_torch.ops import paged

    pt = cache.config.page_type
    b, qh, d = q.shape
    kvh = cache.k_pages.shape[0]
    qscale = d ** -0.5 * paged.LOG2E
    qr = q.reshape(b, kvh, qh // kvh, d)
    qg = (qr.float() * qscale).bfloat16()
    walk = paged.plan_pages(cache.config)
    bound = min(kw["pages_bound"] or walk, walk)
    got = paged._paged_attention_kernel(
        *_b2_args(qr, cache, slots, 0, bound, q.dtype), q_scale=qscale,
        shared_page_table=True, walk=walk, page_type=pt)
    torch.cuda.synchronize()
    if not (torch.equal(got[0].reshape(b, qh, d), o)
            and torch.equal(got[1].reshape(b, qh), lse)):
        raise AssertionError("hit tail B2: the wrapper's o, lse are not the "
                             "main path's")
    want = paged._paged_attention_plain(
        qg, *_b2_args(qg, cache, slots, 0, bound)[1:], page_type=pt)
    errs = _held_b2("hit tail B2 (shared route)", got, want,
                    tol_lse=TOL_LSE)
    # the planted fault: the prefix's first half of pages read as its second
    slot = int(slots[0])
    prefix = int(cache.lengths[slot])
    half = prefix // cache.config.page_size // 2
    tables = cache.page_tables.clone()
    tables[slot, :half] = cache.page_tables[slot, half:2 * half]
    fault = _rejects("hit tail B2 (shared route)", got,
                     paged._paged_attention_plain(
                         qg, *_b2_args(qg, cache, slots, 0, bound,
                                       tables=tables)[1:], page_type=pt))
    if upper_half:
        errs["planted_fault_v_upper_half"] = _rejects(
            "chunk-prefix B2 (V columns 256-511 hidden)", got,
            paged._paged_attention_plain(
                qg, *_b2_args(qg, _upper_half_hidden(cache), slots, 0,
                              bound)[1:], page_type=pt))
    return dict(lanes=b, prefix_tokens=prefix, pages_bound=bound,
                tol=TOL_BF16, tol_lse=TOL_LSE, main_path_bitwise=True,
                planted_fault_half_prefix_replaced=fault, **errs)


def pc_profile(eng, system) -> dict:
    """On an engine whose cache holds ``system``'s pages: one hit's tail
    chunk (``_advance_prefill`` after the hit's admission) and one whole
    cold prefill (``_admit`` of an unrelated prompt), each first timed on
    the host clock (it ends in the sampled token's fetch), then, on
    another such request, profiled (device ms and activities)."""
    _, _, _, eng_mod = _features()
    rng = np.random.default_rng(11)
    vocab = eng.mcfg.vocab_size
    out = {}
    for rep in range(2):
        for name in ("hit_tail_chunk", "cold_prefill"):
            hit = name == "hit_tail_chunk"
            prompt = (system if hit else rng.integers(
                1, vocab - 1, PC_SYSTEM).tolist()) + rng.integers(
                    1, vocab - 1, PC_OWN).tolist()
            eng.submit(eng_mod.Request(rid=20_000 + 2 * rep + hit,
                                       prompt=prompt, max_new_tokens=1))
            if hit:
                eng._admit()
            fn = eng._advance_prefill if hit else eng._admit
            if rep == 0:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out[name] = dict(host_ms=(time.perf_counter() - t0) * 1e3)
            else:
                out[name].update(prof_device(fn))
            eng.run()
    return out


def prefix_cache_phase(dev, smi: str) -> dict:
    """The prefix cache at full width: the 8 shared-prompt requests served
    cold, then with the cache twice; every request after the first hits
    the 32-page prefix; each hit's last-prompt logits against the cold
    run's and a hit stream against a teacher-forced forward; B2's shared
    route on a hit's tail chunk against its plain version; the shared
    pages' bytes unchanged by the serve; a hit admitted with length 0 must
    fail the logits gate."""
    kernels, _, tfm, eng_mod = _features()
    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.default_rng(5)
    system = rng.integers(1, mcfg.vocab_size - 1, PC_SYSTEM).tolist()
    prompts = [system + rng.integers(1, mcfg.vocab_size - 1, PC_OWN).tolist()
               for _ in range(PC_REQUESTS)]
    other = rng.integers(1, mcfg.vocab_size - 1, PC_SYSTEM + PC_OWN).tolist()
    # warm-up: an unrelated prompt twice (with the cache the second hits)
    warm = [eng_mod.Request(rid=10_000 + i, prompt=other, max_new_tokens=4)
            for i in range(2)]
    cold = pc_serve(params, mcfg, prompts, dev, False, warm)
    checked = {}

    def record(real, eng, q, cache, slots, **kw):
        out = real(q, cache, slots, **kw)
        if (kw.get("shared_page_table") and cache is eng.caches[-1]
                and not checked):
            slot = kw["_shared_slot"]
            req = eng.prefilling[slot]["req"]
            if req.rid < 10_000 and int(cache.lengths[slot]) > 0:
                checked.update(held_shared_b2(q, cache, slots, kw, *out),
                               rid=req.rid)
        return out

    runs = [pc_serve(params, mcfg, prompts, dev, True, warm, record=record)]
    # the steady state, the shared pages' bytes held over its serve
    shared = {}

    def snapshot(real, eng, q, cache, slots, **kw):
        if not shared and eng._pcache is not None and 0 in {
                r.rid for r in eng.running.values()}:
            s0 = next(s for s, r in eng.running.items() if r.rid == 0)
            n = PC_SYSTEM // SPEC_CACHE["page_size"]
            ids = torch.as_tensor(eng._alloc.table(s0)[:n] + 1,
                                  device=dev).long()
            shared["ids"] = ids
            shared["bytes"] = [tuple(t[:, ids].clone() for t in (
                c.k_pages, c.v_pages, c.k_scales, c.v_scales))
                for c in eng.caches]
        return real(q, cache, slots, **kw)

    runs.append(pc_serve(params, mcfg, prompts, dev, True, warm,
                         record=snapshot))
    steady = runs[-1]
    eng = steady.pop("engine")
    if not shared:
        raise AssertionError("prefix_cache: the shared pages were never seen")
    for c, saved in zip(eng.caches, shared["bytes"]):
        now = tuple(t[:, shared["ids"]] for t in (
            c.k_pages, c.v_pages, c.k_scales, c.v_scales))
        if not all(torch.equal(a, b) for a, b in zip(now, saved)):
            raise AssertionError("prefix_cache: a shared page was written")
    profile = pc_profile(eng, system)
    del eng, shared
    runs[0].pop("engine")
    cold.pop("engine")
    fault = pc_serve(params, mcfg, prompts[:2], dev, True, [],
                     hit_length_zero=True)
    fault.pop("engine")
    hits = list(range(1, PC_REQUESTS))
    gaps = []
    for run in runs:
        st = run["run_stats"]
        if (st["hits"] != PC_REQUESTS - 1 or st["misses"] != 1
                or st["hit_tokens"] != (PC_REQUESTS - 1) * PC_SYSTEM):
            raise AssertionError(f"prefix_cache: hits {st}: every request "
                                 "after the first must hit the whole prefix")
        if sorted(run["done"]) != list(range(PC_REQUESTS)):
            raise AssertionError("prefix_cache: unfinished requests")
        gaps.append(max(float((run["first"][i] - cold["first"][i]).abs()
                              .max()) for i in hits))
    gate = max(gaps)
    check("prefix_cache: hit vs cold last-prompt logits", gate, TOL_LOGPROB)
    fault_gap = float((fault["first"][1] - cold["first"][1]).abs().max())
    if fault_gap <= TOL_LOGPROB:
        raise AssertionError("prefix_cache: a hit admitted with length 0 "
                             f"passes the gate ({fault_gap})")
    drift = max(teacher_forced_drift(params, mcfg, steady["done"][i])
                for i in (0, 1, PC_REQUESTS - 1))
    check("prefix_cache: teacher-forced logprob drift", drift, TOL_LOGPROB)
    launched("prefix_cache", steady["launches"], (
        "flash_fwd", "paged_attention_shared", "paged_attention_split",
        "paged_append_fused"))
    if not checked:
        raise AssertionError("prefix_cache: no hit tail B2 call checked")
    tokens = PC_REQUESTS * PC_NEW
    warm_prefill = [sum(run["prefill_calls_ms"][-1:]) + sum(run["chunk"])
                    for run in runs]

    def summary(run):
        return dict(wall_s=run["wall_s"], tok_s=tokens / run["wall_s"],
                    decode_ms_per_step=float(np.median(run["decode"])),
                    launches={k: n for k, n in run["launches"].items() if n})

    row = dict(
        phase="prefix_cache", nvidia_smi=smi, cache=SPEC_CACHE["dtype"],
        pages=SPEC_CACHE["total_pages"], requests=PC_REQUESTS,
        system_prompt=PC_SYSTEM, own_tokens=PC_OWN, new_tokens=PC_NEW,
        cold=summary(cold),
        cold_prefill_ms=cold["prefill_ms"],
        runs=[dict(summary(run), stats=run["stats"],
                   run_stats=run["run_stats"],
                   prefill_ms=warm_prefill[i],
                   hit_tail_chunk_ms=run["chunk"],
                   prefill_ms_saved=cold["prefill_ms"] - warm_prefill[i])
              for i, run in enumerate(runs)],
        hit_vs_cold_logits=gaps, gate_tol=TOL_LOGPROB,
        fault_hit_length_zero_logits=fault_gap, teacher_forced_drift=drift,
        shared_pages_unchanged=True, hit_tail_b2=checked, profile=profile)
    emit(row)
    del params
    torch.cuda.empty_cache()
    return dict(launches=steady["launches"], b2=checked)


def resume_phase(dev, smi: str) -> dict:
    """Checkpoint and resume at the engine cell: snapshotted after
    RESUME_AT steps, loaded into a fresh engine and run to the end, against
    the uninterrupted run (tokens equal, logprobs within 1e-6), with bf16
    and with int8 weights in rounds of MULTISTEP_K; one page-table row
    swapped in the snapshot must fail; supervised runs with a crash at
    SUP_CRASH_AT, plain and speculative, against their uninterrupted runs."""
    import shutil
    import tempfile

    kernels, CacheConfig, tfm, eng_mod = _features()
    from tpu_flash_torch.serving.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from tpu_flash_torch.serving.supervisor import Supervisor, SupervisorConfig

    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (N_REQUESTS, PROMPT_LEN)).tolist()

    def reqs(hot=True):
        return [eng_mod.Request(
            rid=i, prompt=prompts[i], max_new_tokens=NEW_TOKENS,
            temperature=0.7 if hot and i == N_REQUESTS - 1 else 0.0,
            top_k=50 if hot and i == N_REQUESTS - 1 else 0,
            top_p=0.9 if hot and i == N_REQUESTS - 1 else 1.0)
            for i in range(N_REQUESTS)]

    def make(p, cache=CACHE, submit=True, hot=True, draft=None, **kw):
        eng = eng_mod.Engine(p, mcfg, CacheConfig(**cache),
                             eng_mod.EngineConfig(max_batch=MAX_BATCH, **kw),
                             draft=draft)
        native_pool(eng)
        for r in reqs(hot) if submit else ():
            eng.submit(r)
        return eng

    def finished(eng):
        eng.run()
        torch.cuda.synchronize()
        return {f.rid: f for f in eng.finished}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    out = dict(phase="resume", nvidia_smi=smi, cache=CACHE["dtype"],
               requests=N_REQUESTS, prompt_len=PROMPT_LEN,
               new_tokens=NEW_TOKENS, snapshot_after_steps=RESUME_AT)
    try:
        cases = {}
        for name, p, kw in (("bf16", params, {}),
                            ("int8_weights_rounds", tfm.quantize_weights(
                                params), dict(decode_steps=MULTISTEP_K))):
            whole = finished(make(p, **kw))
            eng = make(p, **kw)
            for _ in range(RESUME_AT if not kw else RESUME_ROUNDS_AT):
                eng.step()
            path = f"{tmp}/{name}"
            t0 = time.perf_counter()
            save_checkpoint(path, eng)
            save_ms = (time.perf_counter() - t0) * 1e3
            running = len(eng.running)
            del eng
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            restored = load_checkpoint(path, device=dev)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            if not restored.running or restored._graphs:
                raise AssertionError(f"resume {name}: restored state")
            kernels.reset_launches()
            got = finished(restored)
            launches = ran(kernels)
            launched(f"resume {name}", launches, (
                "paged_attention_split", "paged_append_fused"))
            gap = held_streams(f"resume {name}", got, whole)
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            cases[name] = dict(save_ms=save_ms, load_ms=load_ms,
                               snapshot_bytes=size, running_at_snapshot=running,
                               max_logprob_gap=gap, launches=launches,
                               graph_stats={k: restored.graph_stats[k] for k
                                            in ("captures", "replays")})
            if (kw and restored._graphs_ok()
                    and not restored.graph_stats["replays"]):
                raise AssertionError("resume: the restored engine replayed "
                                     "no round graph")
            del restored
            torch.cuda.empty_cache()
            if name == "bf16":
                # the planted fault: two running slots' rows swapped
                arrays = torch.load(f"{path}/arrays.pt", weights_only=True)
                for c in arrays["caches"]:
                    c["page_tables"][[0, 1]] = c["page_tables"][[1, 0]].clone()
                torch.save(arrays, f"{path}/arrays.pt")
                del arrays
                swapped = finished(load_checkpoint(path, device=dev))
                try:
                    held_streams("resume with swapped rows", swapped, whole)
                except AssertionError:
                    cases[name]["fault_swapped_rows_rejected"] = True
                else:
                    raise AssertionError("resume: a swapped page-table row "
                                         "passes the stream check")
                base = whole
            shutil.rmtree(path, ignore_errors=True)
        out["cases"] = cases

        # supervised runs: a crash after the first snapshot
        sup_cache = dict(CACHE, total_pages=SUP_PAGES)
        dcfg = tfm.ModelConfig(**SPEC_DRAFT)
        draft = (tfm.init_params(dcfg, torch.Generator(device=dev)
                                 .manual_seed(1), dev), dcfg)
        sup_rows = {}
        for name, kw, want in (
                ("plain", {}, base),
                ("speculative", dict(speculate_k=4, draft=draft, hot=False),
                 None)):
            if want is None:
                want = finished(make(params, sup_cache, **kw))
            fired = []

            def crash(step, engine):
                if step == SUP_CRASH_AT and not fired:
                    fired.append(step)
                    raise RuntimeError("injected failure")

            sup = Supervisor(
                lambda: make(params, sup_cache, submit=False, **kw),
                SupervisorConfig(dir=f"{tmp}/sup_{name}",
                                 checkpoint_every=SUP_EVERY,
                                 fault_hook=crash),
                draft=kw.get("draft"), device=dev)
            for r in reqs(kw.get("hot", True)):
                sup.submit(r)
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = {f.rid: f for f in sup.run()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not fired or sup.restarts != 1:
                raise AssertionError(f"supervisor {name}: no recovery")
            launched(f"supervisor {name}", ran(kernels), (
                "flash_fwd", "paged_attention_split", "paged_append_fused"))
            gap = held_streams(f"supervisor {name}", got, want)
            sup_rows[name] = dict(wall_s=wall, restarts=sup.restarts,
                                  max_logprob_gap=gap,
                                  launches=ran(kernels))
            if name == "speculative":
                sup_rows[name]["spec_stats"] = sup.engine.spec_stats()
                sup_rows[name]["agreement_with_plain"] = agreement(
                    {rid: base[rid] for rid in range(N_REQUESTS - 1)},
                    {rid: got[rid] for rid in range(N_REQUESTS - 1)})
            del sup
            torch.cuda.empty_cache()
        out["supervisor"] = sup_rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    del params
    torch.cuda.empty_cache()
    return dict(launches=out["cases"]["bf16"]["launches"],
                supervisor_launches=out["supervisor"]["plain"]["launches"])


def feature_phases(dev, smi: str) -> dict:
    """The serving features' phases: speculative, prefix_cache, resume."""
    with torch.no_grad():
        out = dict(speculative=speculative_phase(dev, smi))
        torch.cuda.empty_cache()
        out["prefix_cache"] = prefix_cache_phase(dev, smi)
        torch.cuda.empty_cache()
        out["resume"] = resume_phase(dev, smi)
        torch.cuda.empty_cache()
    return out


# ---- the last serving features: MoE models and multi-LoRA ---------------

# MoE serving: the canonical model with 8 experts a layer, top-2, at the
# drop-free capacity factor E / top_k that the serving guard demands (8.86
# GB of experts, 9.39 GB of weights); the engine cell's int8 cache, 16
# lanes, 16 greedy requests of 512 + 32 tokens, one-token steps, then
# async rounds of MULTISTEP_K as CUDA graphs
MOE = dict(MODEL, moe_experts=8, moe_top_k=2, moe_capacity_factor=4.0)
# ROADMAP C: top-k flips at near-ties. A router near-tie resolved the other
# way in bf16 (decode's hidden states differ from the forward's by the
# int8 cache's error) swaps an expert, which moves that token's logits by
# ~1: the drift against a free teacher-forced forward is no bound. So the
# int8 rule (drift ≤ TOL_LOGPROB) is held against the teacher-forced
# forward routed as the served decode was (its expert choices forced at
# the generated positions; the prompt's routing is the engine's prefill's
# bit for bit); routing flips (served experts ≠ the free forward's) are
# counted, at most one decision in MOE_FLIP_SHARE; a flipped token
# (served ≠ that forward's argmax) only where the forward's logit of the
# argmax exceeds the served token's by at most twice the drift bound, at
# most one token in MOE_FLIP_SHARE (a random model's top-2 logit gap is
# ~0.2 on average at this width)
MOE_FLIP_SHARE = 1 / 8
MOE_FLIP_GAP = 2 * TOL_LOGPROB
# the float32 checks: the same widths cut to 2 layers over a float32 cache
EXACT_LAYERS = 2
EXACT_STEPS = 8
# multi-LoRA: the bf16 canonical model and 4 adapters of rank 16 on
# wq/wk/wv/wo, b ~ N(0, σ²) from a seed, σ scaled from tests/test_lora.py:
# 33-46's fill (0.3 at dim 64, rank 4) so that an adapter's delta is as
# large beside the base projection as there (1.2 times its output's std:
# Var(x·a·b) = dim · rank⁻² · rank · σ²); a zero b is a no-op; the engine
# cell's 16 requests with adapters
# −1, 0, 1, 2, 3 interleaved over the lanes and 16 + i new tokens (lanes
# finish one a step), then LORA_EXTRA more admitted into the freed lanes,
# the first three on one LORA_SHARED-token prompt under adapters 0, 1, 0
# (the prefix cache is on: a hit within adapter 0, none across)
LORA_ADAPTERS, LORA_RANK = 4, 16
LORA_B_STD = 0.3 * math.sqrt((64 / 4) / (MODEL["dim"] / LORA_RANK))
LORA_SHARED, LORA_EXTRA = 1024, 8


def tree_bytes(tree) -> int:
    from tpu_flash_torch.graft_entry import param_leaves

    return sum(t.numel() * t.element_size() for t in param_leaves(tree))


def served(eng, reqs, warm=None) -> dict:
    """:func:`run_engine` with the run's tokens, tok/s and median step ms
    (after the first step, which admits and prefills)."""
    run = run_engine(eng, reqs, warm=warm)
    tokens = sum(len(f.new_tokens) for f in run["done"].values())
    run.update(tokens=tokens, tok_s=tokens / run["wall_s"],
               step_ms_median=float(np.median(run["step_ms"][1:])))
    return run


def teacher_forced_flips(params, mcfg, done) -> dict:
    """Each stream against a forward over it (its tokens but the last):
    a flip is a new token that is not the forward's argmax, its gap the
    forward's top logit less the served token's; the drift is the largest
    |served logprob − forward logprob|. Streams of one length share a
    forward."""
    _, _, tfm, _ = _features()
    dev = params["embed"].device
    by_len = {}
    for rid, f in sorted(done.items()):
        by_len.setdefault((len(f.tokens), len(f.new_tokens)), []).append(f)
    flips, drift, n = [], 0.0, 0
    for (_, n_new), fs in by_len.items():
        toks = torch.tensor([f.tokens[:-1] for f in fs], device=dev)
        logits = tfm.forward(params, toks, mcfg)[:, -n_new:].float()
        lp = torch.log_softmax(logits, dim=-1)
        for f, lg, lpr in zip(fs, logits, lp):
            new = torch.tensor(f.new_tokens, device=dev)
            drift = max(drift, float((lpr.gather(1, new[:, None])[:, 0]
                                      - torch.tensor(f.logprobs, device=dev))
                                     .abs().max()))
            top = lg.argmax(-1)
            for j in torch.nonzero(top != new)[:, 0].tolist():
                flips.append(dict(rid=f.rid, new_token=j, gap=float(
                    lg[j, top[j]] - lg[j, new[j]])))
            n += n_new
        del logits, lp
    return dict(tokens=n, flips=flips, max_gap=max(
        (x["gap"] for x in flips), default=0.0), drift=drift)


def step_forward_distance(params, mcfg, prompts, cache,
                          steps=EXACT_STEPS) -> float:
    """max |decode_step logits − forward logits| over ``steps`` greedy
    steps of the prompts' lanes (prefilled by an engine), each lane's
    forward routed as its decode steps were (:func:`routed_forward`): how
    far a served step may lie from the teacher-forced forward in this
    model once the experts agree."""
    from tpu_flash_torch.models import moe
    _, CacheConfig, tfm, eng_mod = _features()
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**cache),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH))
    for i, p in enumerate(prompts):
        eng.submit(eng_mod.Request(rid=i, prompt=p, max_new_tokens=steps + 4))
    eng._admit()
    lanes = sorted(eng.running)
    seqs = [list(eng.running[s].tokens) for s in lanes]
    bucket, start = eng._bucket(len(prompts[0]) + 1), len(prompts[0])
    dev = params["embed"].device
    slots = torch.tensor(lanes, dtype=torch.int32, device=dev)
    real, recorded, dist = moe._route, [], 0.0
    for _ in range(steps):
        calls = []

        def recording(logits, top_k, capacity):
            r, aux = real(logits, top_k, capacity)
            calls.append((logits[:, 0].float().clone(),
                          r.experts[:, 0].clone()))
            return r, aux

        toks = torch.tensor([q[-1] for q in seqs], device=dev)
        pos = torch.tensor([len(q) - 1 for q in seqs], dtype=torch.int32,
                           device=dev)
        moe._route = recording
        try:
            got, _ = tfm.decode_step(params, toks, pos, eng.caches, slots,
                                     mcfg)
        finally:
            moe._route = real
        recorded.append(calls)
        for lane, q in enumerate(seqs):
            want = routed_forward(params, mcfg, q, bucket, start, lane,
                                  recorded)["logits"][-1]
            dist = max(dist, float((got[lane] - want).abs().max()))
        seqs = [q + [int(t)] for q, t in zip(seqs, got.argmax(-1).tolist())]
    del eng
    torch.cuda.empty_cache()
    return dist


def grouped_profile(fn, groups: dict) -> dict:
    """torch.profiler over one ``fn()``: the device ms of its kernels, and
    of those launched inside each group (``name → (module, attribute)``,
    the function wrapped in a ``record_function`` range), nested groups
    counted in each; the busy share of the host-clock window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for name, (mod, attr) in groups.items():
        real = getattr(mod, attr)

        def wrapped(*a, _real=real, _name=name, **kw):
            with record_function(f"group:{_name}"):
                return _real(*a, **kw)

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, real))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    ev = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # the ranges' own device-side spans are not kernels
    kern = [e for e in ev if e.device_type == cuda
            and not e.key.startswith("group:")]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    out = dict(device_ms=total, host_ms=host_ms,
               activities=sum(e.count for e in kern),
               paged_kernels_ms=sum(e.self_device_time_total for e in kern
                                    if "paged" in e.key) / 1e3)
    for name in groups:
        out[f"{name}_ms"] = sum(e.device_time_total for e in ev
                                if e.key == f"group:{name}"
                                and e.device_type == cpu) / 1e3
    out["top_kernels"] = [
        [e.key[:60], e.count, e.self_device_time_total / 1e3]
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]]
    return out


def record_routes(eng, reqs) -> tuple:
    """Serve ``reqs`` on ``eng`` with ``moe._route`` recording its decode
    calls (one token a lane): the finished requests, and for each decode
    step and layer the lanes' router logits ``(B, E)`` and choices ``(B,
    k)``."""
    from tpu_flash_torch.models import moe

    real, calls = moe._route, []

    def recording(logits, top_k, capacity):
        r, aux = real(logits, top_k, capacity)
        if logits.shape[1] == 1:
            calls.append((logits[:, 0].float().clone(),
                          r.experts[:, 0].clone()))
        return r, aux

    moe._route = recording
    try:
        for r in reqs:
            eng.submit(r)
        done = {f.rid: f for f in eng.run()}
    finally:
        moe._route = real
    layers = len(eng.params["layers"])
    return done, [calls[i:i + layers] for i in range(0, len(calls), layers)]


def routed_forward(params, mcfg, tokens, bucket: int, start: int, lane: int,
                   steps) -> dict:
    """A teacher-forced forward over ``tokens`` padded to ``bucket`` (the
    engine's prefill shape, so the prompt's routing and K/V are the
    prefill's bit for bit), each layer's expert choices at positions
    ``start …`` forced to lane ``lane``'s recorded decode choices
    (:func:`record_routes`; the gates renormalized from the forward's own
    router probabilities). Returns its logits at ``start − 1 …`` and, per
    decode step and layer, whether the free forward chose other experts
    and by what router-logit margin."""
    from tpu_flash_torch.models import moe
    _, _, tfm, _ = _features()

    real = moe._route
    n = len(steps)
    flips, margins, dist = 0, [], 0.0
    layer = [0]

    def forced(logits, top_k, capacity):
        nonlocal flips, dist
        li = layer[0]
        layer[0] += 1
        dec = torch.stack([st[li][1][lane] for st in steps])  # (n, k)
        dec_logits = torch.stack([st[li][0][lane] for st in steps])
        free_r, _ = real(logits, top_k, capacity)
        lg = logits.float()
        window = lg[0, start:start + n]
        dist = max(dist, float((window - dec_logits).abs().max()))
        free = free_r.experts[0, start:start + n]
        for s in range(n):
            if set(free[s].tolist()) != set(dec[s].tolist()):
                flips += 1
                extra = [e for e in dec[s].tolist()
                         if e not in free[s].tolist()]
                kth = window[s, free[s]].min()
                margins.append(float(kth - window[s, extra].max()))
        # large enough to decide the argmax, small enough that the second
        # choice's probability stays a normal float32 (its argmax too)
        bonus = torch.tensor([60.0, 30.0][:top_k], device=lg.device)
        lg2 = lg.clone()
        lg2[0, start:start + n].scatter_add_(-1, dec, bonus.expand(n, -1))
        r, aux = real(lg2, top_k, capacity)
        probs = torch.softmax(lg, dim=-1)
        g = probs.gather(-1, r.experts) * r.keep.float()
        r.weights = g / g.sum(-1, keepdim=True).clamp_min(1e-30)
        return r, aux

    toks = torch.zeros((1, bucket), dtype=torch.int64,
                       device=params["embed"].device)
    toks[0, :len(tokens)] = torch.tensor(tokens, device=toks.device)
    moe._route = forced
    try:
        logits = tfm.forward(params, toks, mcfg)[0, start - 1:start + n]
    finally:
        moe._route = real
    return dict(logits=logits.float(), route_flips=flips, margins=margins,
                router_distance=dist)


def routed_stats(params, mcfg, reqs, done, steps, bucket: int) -> dict:
    """The served streams ``done`` (of ``reqs``, lane i = request i, with
    their recorded decode routes ``steps``) against the teacher-forced
    forward routed as their decode was (:func:`routed_forward`): the
    drift, the flipped tokens and their gaps; and the routing flips
    against the free forward."""
    start = len(reqs[0].prompt)  # the first generated token's position
    drift, flips, route_flips, margins, dist, n_tok = 0.0, [], 0, [], 0.0, 0
    for lane, r in enumerate(reqs):
        f = done[r.rid]
        out = routed_forward(params, mcfg, f.tokens[:-1], bucket, start,
                             lane, steps)
        lg = out["logits"]
        lp = torch.log_softmax(lg, dim=-1)
        new = torch.tensor(f.new_tokens, device=lg.device)
        drift = max(drift, float((lp.gather(1, new[:, None])[:, 0]
                                  - torch.tensor(f.logprobs,
                                                 device=lg.device))
                                 .abs().max()))
        top = lg.argmax(-1)
        for j in torch.nonzero(top != new)[:, 0].tolist():
            flips.append(dict(rid=f.rid, new_token=j, gap=float(
                lg[j, top[j]] - lg[j, new[j]])))
        route_flips += out["route_flips"]
        margins += out["margins"]
        dist = max(dist, out["router_distance"])
        n_tok += len(new)
    decisions = len(steps) * mcfg.num_layers * len(reqs)
    return dict(drift=drift, flips=flips, tokens=n_tok,
                max_gap=max((x["gap"] for x in flips), default=0.0),
                route_flips=route_flips, route_decisions=decisions,
                route_flip_max_margin=max(margins, default=0.0),
                router_logit_distance=dist)


def moe_routed_check(params, mcfg, eng, reqs, want) -> dict:
    """``eng`` serves ``reqs`` again with the routes recorded (its streams
    ``want``'s bit for bit), held by :func:`routed_stats`."""
    done, steps = record_routes(eng, reqs)
    same_streams("moe_serve recorded vs one-token", done, want, tol=0.0)
    return routed_stats(params, mcfg, reqs, done, steps,
                        eng._bucket(len(reqs[0].prompt) + 1))


def moe_step_profile(eng, prompts) -> dict:
    """One decode step of the 16 lanes (after the step that admits them)
    by group: the expert products (the slot copy, the three batched
    products, the weighted gather), the routing (router product, softmax,
    choices, positions: the MoE block less its experts), attention (B2
    with B3 fused) and the rest (projections, norms, sampling); and one
    whole-prompt prefill (a request of one token admitted alone: its
    bucket's E·C expert slots, the reference's formulation)."""
    from tpu_flash_torch.models import moe
    _, _, tfm, eng_mod = _features()

    groups = dict(moe=(tfm, "moe_mlp"), experts=(moe, "_experts"),
                  attention=(tfm, "paged_attention"))

    def split(prof):
        prof["routing_ms"] = prof["moe_ms"] - prof["experts_ms"]
        # B2's launches (ctypes) fall outside the profiler's ranges:
        # attention is the paged kernels' own time plus the range's
        prof["attention_ms"] += prof["paged_kernels_ms"]
        prof["other_ms"] = (prof["device_ms"] - prof["moe_ms"]
                            - prof["attention_ms"])
        return prof

    eng.submit(eng_mod.Request(rid=19_999, prompt=prompts[0],
                               max_new_tokens=1))
    prefill = split(grouped_profile(eng.step, groups))
    for i, p in enumerate(prompts[:N_REQUESTS]):
        eng.submit(eng_mod.Request(rid=20_000 + i, prompt=p,
                                   max_new_tokens=4))
    eng.step()
    step = split(grouped_profile(eng.step, groups))
    eng.run()
    return dict(step=step, prefill=prefill)


def fused_b2_at_step(eng, reqs, layer: int, name: str) -> dict:
    """Admit ``reqs`` (one step), then record ``layer``'s B2 call (B3
    fused) at the next decode step and hold it (:func:`held_fused_b2`)."""
    _, _, tfm, _ = _features()
    for r in reqs:
        eng.submit(r)
    eng.step()
    rec = {}
    real = tfm.paged_attention
    tfm.paged_attention = record_fused(eng.caches[layer], rec)
    try:
        eng.step()
        torch.cuda.synchronize()
    finally:
        tfm.paged_attention = real
    eng.run()
    if not rec:
        raise AssertionError(f"{name}: layer {layer}'s B2 call not recorded")
    return held_fused_b2(rec, name)


def moe_exact(dev, prompts) -> dict:
    """The MoE model cut to EXACT_LAYERS layers in float32 over a float32
    cache: greedy decode against the teacher-forced forward routed as it
    was (:func:`routed_stats`), a flip allowed only where that forward's
    top-2 gap is below the measured step-vs-forward distance
    (:func:`step_forward_distance`), the logprob drift within twice it
    (lse moves by at most the largest logit move); the routing flips
    against the free forward reported. Planted fault: un-renormalized
    gates (each kept gate its raw probability) in the served model must
    fail that check."""
    from tpu_flash_torch.models import moe
    _, CacheConfig, tfm, eng_mod = _features()

    mcfg = tfm.ModelConfig(**dict(MOE, num_layers=EXACT_LAYERS,
                                  dtype="float32"))
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    cache = dict(CACHE, dtype="float32")
    dist = step_forward_distance(params, mcfg, prompts[:N_REQUESTS], cache)
    reqs = [eng_mod.Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts[:N_REQUESTS])]

    def served_stats(route=None):
        eng = eng_mod.Engine(params, mcfg, CacheConfig(**cache),
                             eng_mod.EngineConfig(max_batch=MAX_BATCH))
        real = moe._route
        moe._route = route or real
        try:
            done, steps = record_routes(eng, reqs)
        finally:
            moe._route = real
        bucket = eng._bucket(len(reqs[0].prompt) + 1)
        del eng
        return routed_stats(params, mcfg, reqs, done, steps, bucket)

    def held(chk):
        return (all(x["gap"] < dist for x in chk["flips"])
                and chk["drift"] <= 2 * dist)

    def unrenormalized(logits, top_k, capacity):
        r, aux = real(logits, top_k, capacity)
        probs = torch.softmax(logits.float(), dim=-1)
        r.weights = probs.gather(-1, r.experts) * r.keep.float()
        return r, aux

    real = moe._route
    got = served_stats()
    fault = served_stats(unrenormalized)
    out = dict(layers=EXACT_LAYERS, step_vs_forward_distance=dist,
               flips=got["flips"], drift=got["drift"], drift_tol=2 * dist,
               route_flips=got["route_flips"],
               route_decisions=got["route_decisions"],
               route_flip_max_margin=got["route_flip_max_margin"],
               fault_flips=len(fault["flips"]),
               fault_max_gap=fault["max_gap"], fault_drift=fault["drift"],
               fault_rejected=not held(fault))
    if not held(got):
        raise AssertionError(f"moe_serve float32: decode parts from the "
                             f"forward beyond a near-tie: {out}")
    if held(fault):
        raise AssertionError("moe_serve float32: un-renormalized gates pass "
                             f"the check: {out}")
    del params
    torch.cuda.empty_cache()
    return out


def moe_serve_phase(dev, smi: str) -> dict:
    """The MoE serving path at full width (MOE): one-token steps, then the
    same requests in async rounds of MULTISTEP_K as CUDA graphs, streams
    equal; drift and flips against the teacher-forced forward; one step's
    device time by group and its byte floor beside the dense model's; the
    last layer's B2 call (B3 fused) at one step against its plain
    versions; the float32 exactness check (:func:`moe_exact`); a dropful
    capacity factor refused."""
    kernels, CacheConfig, tfm, eng_mod = _features()
    mcfg = tfm.ModelConfig(**MOE)
    try:
        tfm._check_serving_moe(dataclasses.replace(
            mcfg, moe_capacity_factor=1.25))
    except ValueError:
        pass
    else:
        raise AssertionError("moe_serve: capacity factor 1.25 was accepted")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (N_REQUESTS + 1, PROMPT_LEN)).tolist()
    exact = moe_exact(dev, prompts)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    weights = tree_bytes(params)
    experts = sum(tree_bytes({k: lp[k] for k in ("w_gate", "w_up", "w_down")})
                  for lp in params["layers"])
    dense = (weights - experts - tree_bytes([lp["wr"] for lp in
                                             params["layers"]])
             + mcfg.num_layers * 3 * mcfg.dim * mcfg.hidden * 2)
    reqs = [eng_mod.Request(rid=i, prompt=prompts[i],
                            max_new_tokens=NEW_TOKENS)
            for i in range(N_REQUESTS)]
    warm = eng_mod.Request(rid=10_000, prompt=prompts[-1],
                           max_new_tokens=NEW_TOKENS)
    runs = {}
    for name, steps in (("one_token", 1), ("rounds", MULTISTEP_K)):
        eng = eng_mod.Engine(params, mcfg, CacheConfig(**CACHE),
                             eng_mod.EngineConfig(max_batch=MAX_BATCH,
                                                  decode_steps=steps))
        runs[name] = served(eng, reqs, warm)
        if name == "one_token":
            profile = moe_step_profile(eng, prompts)
            b2 = fused_b2_at_step(eng, [dataclasses.replace(
                r, rid=30_000 + r.rid) for r in reqs],
                mcfg.num_layers - 1, "moe_serve")
        del eng
        torch.cuda.empty_cache()
    one, rounds = runs["one_token"], runs["rounds"]
    for f in one["done"].values():
        if (f.reason != "length" or len(f.new_tokens) != NEW_TOKENS
                or not all(np.isfinite(f.logprobs))):
            raise AssertionError(f"moe_serve: request {f.rid}: {f.reason}, "
                                 f"{len(f.new_tokens)} tokens")
    gap = same_streams("moe_serve rounds vs one-token", rounds["done"],
                       one["done"])
    if rounds["replays"] <= 0:
        raise AssertionError("moe_serve: no round was a graph replay")
    launched("moe_serve", rounds["launches"], (
        "flash_fwd", "paged_attention_split", "paged_append_fused"))
    free = teacher_forced_flips(params, mcfg, one["done"])
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**CACHE),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH))
    tf = moe_routed_check(params, mcfg, eng, reqs, one["done"])
    del eng
    torch.cuda.empty_cache()
    check("moe_serve: teacher-forced logprob drift (routed as served)",
          tf["drift"], TOL_LOGPROB)
    check("moe_serve: flipped tokens", len(tf["flips"]),
          MOE_FLIP_SHARE * tf["tokens"])
    check("moe_serve: flip gap", tf["max_gap"], MOE_FLIP_GAP)
    check("moe_serve: routing flips", tf["route_flips"],
          MOE_FLIP_SHARE * tf["route_decisions"])
    row = dict(
        phase="moe_serve", nvidia_smi=smi, model=MOE, cache=CACHE["dtype"],
        requests=N_REQUESTS, prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
        weights_gb=weights / 1e9, experts_gb=experts / 1e9,
        dense_model_gb=dense / 1e9,
        step_byte_floor_ms=weights / PEAK_BYTES * 1e3,
        dense_step_byte_floor_ms=dense / PEAK_BYTES * 1e3,
        ms_per_step=one["step_ms_median"],
        ms_per_round=rounds["step_ms_median"], decode_steps=MULTISTEP_K,
        tok_s=one["tok_s"], rounds_tok_s=rounds["tok_s"],
        graph_replays=rounds["replays"],
        rounds_vs_one_token_max_logprob_gap=gap,
        teacher_forced_drift=tf["drift"], drift_tol=TOL_LOGPROB,
        flips=len(tf["flips"]), flip_max_gap=tf["max_gap"],
        flip_tokens=tf["tokens"], flip_share_tol=MOE_FLIP_SHARE,
        flip_gap_tol=MOE_FLIP_GAP, route_flips=tf["route_flips"],
        route_decisions=tf["route_decisions"],
        route_flip_max_margin=tf["route_flip_max_margin"],
        router_logit_distance=tf["router_logit_distance"],
        free_forward=dict(drift=free["drift"], flips=len(free["flips"]),
                          flip_max_gap=free["max_gap"]),
        step_profile=profile, b2=b2,
        float32=exact, launches=rounds["launches"],
        one_token_launches=one["launches"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(row)
    del params
    torch.cuda.empty_cache()
    return dict(launches=rounds["launches"], b2=b2)


def lora_bank(mcfg, dev, seed: int, zero: bool = False):
    """LORA_ADAPTERS adapters of rank LORA_RANK from ``seed``; ``b``
    filled with N(0, LORA_B_STD²) unless ``zero``."""
    from tpu_flash_torch.models.lora import init_lora_bank

    bank = init_lora_bank(mcfg, LORA_ADAPTERS, LORA_RANK,
                          torch.Generator(device=dev).manual_seed(seed), dev)
    if zero:
        return bank
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for layer in bank:
        for e in layer.values():
            e["b"] = (torch.randn(e["b"].shape, generator=gen, device=dev)
                      * LORA_B_STD).to(e["b"].dtype)
    return bank


def lora_requests(vocab: int):
    """The engine cell's 16 prompts with adapters −1 … 3 interleaved and
    16 + i new tokens, then LORA_EXTRA more: three on one LORA_SHARED-token
    prompt (adapters 0, 1, 0), the rest on prompts of their own; and the
    warm-up request (adapter 2)."""
    _, _, _, eng_mod = _features()

    def aid(i):
        return i % (LORA_ADAPTERS + 1) - 1
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, vocab - 1, (N_REQUESTS + 1, PROMPT_LEN)).tolist()
    shared = rng.integers(1, vocab - 1, LORA_SHARED).tolist()
    reqs = [eng_mod.Request(rid=i, prompt=prompts[i], max_new_tokens=16 + i,
                            adapter_id=aid(i)) for i in range(N_REQUESTS)]
    own = rng.integers(1, vocab - 1, (LORA_EXTRA - 3, PROMPT_LEN)).tolist()
    for j in range(LORA_EXTRA):
        rid = N_REQUESTS + j
        reqs.append(eng_mod.Request(
            rid=rid, prompt=shared if j < 3 else own[j - 3],
            max_new_tokens=NEW_TOKENS,
            adapter_id=(0, 1, 0)[j] if j < 3 else aid(rid)))
    warm = eng_mod.Request(rid=10_000, prompt=prompts[-1], max_new_tokens=8,
                           adapter_id=2)
    return reqs, warm


def lora_decode_distance(params, bank, merged, mcfg, reqs, cache) -> float:
    """max |decode_step logits under the adapter − decode_step logits of
    the merged model| over each request's NEW_TOKENS − 1 decode steps,
    both fed the adapter path's greedy tokens, each from its own engine's
    prefill: how far the two computations of one model lie apart."""
    _, _, tfm, eng_mod = _features()

    def admitted(p, lora, rs):
        eng = eng_mod.Engine(p, mcfg, cache, eng_mod.EngineConfig(
            max_batch=MAX_BATCH), lora=lora)
        for r in rs:
            eng.submit(r)
        eng._admit()
        return eng

    eng = admitted(params, bank, reqs)
    solo = [admitted(merged[r.adapter_id], None,
                     [dataclasses.replace(r, adapter_id=-1)]) for r in reqs]
    lanes = sorted(eng.running)
    dev = params["embed"].device
    seqs = [list(eng.running[s].tokens) for s in lanes]
    aids = torch.tensor([eng.running[s].adapter_id for s in lanes],
                        dtype=torch.int32, device=dev)
    slots = torch.tensor(lanes, dtype=torch.int32, device=dev)
    dist = 0.0
    for _ in range(NEW_TOKENS - 1):
        toks = torch.tensor([q[-1] for q in seqs], device=dev)
        pos = torch.tensor([len(q) - 1 for q in seqs], dtype=torch.int32,
                           device=dev)
        got, _ = tfm.decode_step(params, toks, pos, eng.caches, slots, mcfg,
                                 lora=bank, adapter_ids=aids)
        for lane, (r, e) in enumerate(zip(reqs, solo)):
            want, _ = tfm.decode_step(
                merged[r.adapter_id], toks[lane:lane + 1],
                pos[lane:lane + 1], e.caches,
                torch.tensor(sorted(e.running), dtype=torch.int32,
                             device=dev), mcfg)
            dist = max(dist, float((got[lane] - want[0]).abs().max()))
        seqs = [q + [int(t)] for q, t in zip(seqs, got.argmax(-1).tolist())]
    del eng, solo
    torch.cuda.empty_cache()
    return dist


def lora_exact(dev) -> dict:
    """The canonical widths cut to EXACT_LAYERS layers in float32 over a
    float32 cache, with a float32 bank: one request a adapter (0 … 3) and a
    base one served together; adapter k's stream equals
    ``merge_lora(params, bank, k)`` served as base, and each request's
    stream equals it served solo, a parting allowed only where the
    merged model's teacher-forced top-2 gap is below the measured
    distance of the adapter path from the merged one
    (:func:`lora_decode_distance`)."""
    from tpu_flash_torch.models.lora import merge_lora
    _, CacheConfig, tfm, eng_mod = _features()

    mcfg = tfm.ModelConfig(**dict(MODEL, num_layers=EXACT_LAYERS,
                                  dtype="float32"))
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    bank = lora_bank(mcfg, dev, seed=5)
    cache = CacheConfig(**dict(CACHE, dtype="float32"))
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (LORA_ADAPTERS + 1, PROMPT_LEN)).tolist()
    aids = list(range(LORA_ADAPTERS)) + [-1]

    def serve(p, lora, reqs):
        eng = eng_mod.Engine(p, mcfg, cache, eng_mod.EngineConfig(
            max_batch=MAX_BATCH), lora=lora)
        for r in reqs:
            eng.submit(r)
        done = {f.rid: f for f in eng.run()}
        del eng
        return done

    reqs = [eng_mod.Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS,
                            adapter_id=a)
            for i, (p, a) in enumerate(zip(prompts, aids))]
    mixed = serve(params, bank, reqs)
    merged = {a: merge_lora(params, bank, a) if a >= 0 else params
              for a in aids}
    dist = lora_decode_distance(params, bank, merged, mcfg, reqs, cache)
    parts, rejected = {}, []
    for r in reqs:
        a = r.adapter_id
        as_merged = serve(merged[a], None, [dataclasses.replace(
            r, adapter_id=-1)])
        solo = serve(params, bank, [r])
        for name, want in (("merged", as_merged), ("solo", solo)):
            ps = stream_partings(merged[a], mcfg, want, {r.rid: mixed[r.rid]},
                                 dist)
            if ps:
                parts.setdefault(name, []).extend(ps)
            rejected += [p for p in ps if not p["allowed"]]
    base = serve(params, None, [dataclasses.replace(r, adapter_id=-1)
                                for r in reqs[:LORA_ADAPTERS]])
    differ = sum(base[r.rid].tokens != mixed[r.rid].tokens
                 for r in reqs[:LORA_ADAPTERS])
    out = dict(layers=EXACT_LAYERS, adapter_vs_merged_distance=dist,
               partings=parts, adapters_differing_from_base=differ)
    if rejected:
        raise AssertionError(f"lora_serve float32: streams part beyond a "
                             f"near-tie: {out}")
    if differ != LORA_ADAPTERS:
        raise AssertionError(f"lora_serve float32: an adapter's stream is "
                             f"the base model's: {out}")
    del params, bank, merged
    torch.cuda.empty_cache()
    return out


def lora_run(params, mcfg, lora, steps, reqs, warm, load_once=False):
    """:func:`served` on an engine with ``lora`` (or none), the prefix
    cache on, rounds of ``steps``; with the run's prefix hits.
    ``load_once``: the planted fault, a round graph whose adapter-id
    buffer is loaded at the first round only (not refreshed)."""
    _, CacheConfig, _, eng_mod = _features()
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**CACHE),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH,
                                              decode_steps=steps,
                                              prefix_cache=True), lora=lora)
    native_pool(eng)
    if load_once:
        real, loads = eng._load_static, [0]

        def stale(arrays):
            loads[0] += 1
            if loads[0] > 1:
                arrays = {k: v for k, v in arrays.items() if k != "aids"}
            real(arrays)

        eng._load_static = stale
    hits0 = eng._pcache.stats()["hits"]
    out = served(eng, reqs, warm)
    out["hits"] = eng._pcache.stats()["hits"] - hits0
    del eng
    torch.cuda.empty_cache()
    return out


def lora_drift(params, mcfg, bank, f) -> float:
    """max |served logprob − teacher-forced logprob| over a stream's new
    tokens, the forward carrying the stream's adapter deltas
    (``serving/engine.py:_prefill_all_logits`` over its tokens but the
    last)."""
    from tpu_flash_torch.serving.engine import _prefill_all_logits

    dev = params["embed"].device
    toks = torch.tensor([f.tokens[:-1]], device=dev)
    logits, _ = _prefill_all_logits(
        params, toks, mcfg, lora=bank,
        adapter_ids=torch.tensor([f.adapter_id], dtype=torch.int32,
                                 device=dev))
    lp = torch.log_softmax(logits[0, -len(f.new_tokens):].float(), dim=-1)
    ref = lp.gather(1, torch.tensor(f.new_tokens, device=dev)[:, None])[:, 0]
    return float((ref - torch.tensor(f.logprobs, device=dev)).abs().max())


def stale_ids_fault(params, mcfg, bank, reqs, warm, want) -> int:
    """The rounds with the adapter ids loaded at the first round only must
    part from the one-token streams ``want``: returns how many part."""
    fault = lora_run(params, mcfg, bank, MULTISTEP_K, reqs, warm,
                     load_once=True)
    parted = sum(fault["done"][rid].tokens != f.tokens
                 for rid, f in want.items())
    if not parted:
        raise AssertionError("lora_serve: a round graph whose adapter ids "
                             "are not refreshed gives the one-token streams")
    return parted


def lora_serve_phase(dev, smi: str) -> dict:
    """Multi-LoRA at full width: the mixed-adapter requests (lora_requests)
    served in one-token steps and in async rounds of MULTISTEP_K as CUDA
    graphs (streams equal; lanes change adapters between rounds), beside
    the base engine's times on the same requests; the prefix cache scoped
    by adapter; a zero bank equal to the base engine bit for bit; a round
    graph whose id buffer is loaded once (not refreshed) must part from
    the one-token streams; the served B2 call of one layer against its
    plain versions; the float32 exactness checks (:func:`lora_exact`)."""
    _, CacheConfig, tfm, eng_mod = _features()
    mcfg = tfm.ModelConfig(**MODEL)
    exact = lora_exact(dev)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    bank = lora_bank(mcfg, dev, seed=5)
    reqs, warm = lora_requests(mcfg.vocab_size)
    base_reqs = [dataclasses.replace(r, adapter_id=-1) for r in reqs]
    base_warm = dataclasses.replace(warm, adapter_id=-1)

    def run(lora, steps, rs, wm):
        return lora_run(params, mcfg, lora, steps, rs, wm)

    runs = dict(one_token=run(bank, 1, reqs, warm),
                rounds=run(bank, MULTISTEP_K, reqs, warm),
                base_one_token=run(None, 1, base_reqs, base_warm),
                base_rounds=run(None, MULTISTEP_K, base_reqs, base_warm),
                zero_bank=run(lora_bank(mcfg, dev, 5, zero=True), 1, reqs,
                              warm))
    one, rounds = runs["one_token"], runs["rounds"]
    n = N_REQUESTS + LORA_EXTRA
    if sorted(one["done"]) != list(range(n)):
        raise AssertionError(f"lora_serve: finished {sorted(one['done'])}")
    for f in one["done"].values():
        if f.reason != "length" or not all(np.isfinite(f.logprobs)):
            raise AssertionError(f"lora_serve: request {f.rid}: {f.reason}")
        if f.adapter_id != reqs[f.rid].adapter_id:
            raise AssertionError(f"lora_serve: request {f.rid} finished "
                                 f"under adapter {f.adapter_id}")
    gap = same_streams("lora_serve rounds vs one-token", rounds["done"],
                       one["done"])
    # the zero bank bit for bit the base engine's, but for the request
    # the base engine serves from a prefix hit (its adapter's namespace
    # is another under the bank, so it prefills whole there)
    cross = N_REQUESTS + 1
    same_streams("lora_serve zero bank vs base",
                 {r: f for r, f in runs["zero_bank"]["done"].items()
                  if r != cross},
                 {r: f for r, f in runs["base_one_token"]["done"].items()
                  if r != cross}, tol=0.0)
    if rounds["replays"] <= 0:
        raise AssertionError("lora_serve: no round was a graph replay")
    # adapter 0's repeat hits (and under the base engine, all three share
    # one namespace: two hits); adapter 1 on the same prompt never does
    for name, r in runs.items():
        want = 2 if name.startswith("base") else 1
        if r["hits"] != want:
            raise AssertionError(f"lora_serve {name}: {r['hits']} prefix "
                                 f"hits, want {want}")
    differ = sum(one["done"][i].tokens != runs["base_one_token"]["done"][i]
                 .tokens for i in range(n) if reqs[i].adapter_id >= 0)
    if not differ:
        raise AssertionError("lora_serve: the adapters change no stream")
    fault_parted = stale_ids_fault(params, mcfg, bank, reqs, warm,
                                   one["done"])
    launched("lora_serve", rounds["launches"], (
        "flash_fwd", "paged_attention_split", "paged_append_fused",
        "paged_attention_shared"))
    eng = eng_mod.Engine(params, mcfg, CacheConfig(**CACHE),
                         eng_mod.EngineConfig(max_batch=MAX_BATCH), lora=bank)
    b2 = fused_b2_at_step(eng, [dataclasses.replace(r, rid=30_000 + r.rid)
                                for r in reqs[:N_REQUESTS]],
                          mcfg.num_layers - 1, "lora_serve")
    del eng
    # drift against a teacher-forced forward with the request's adapter
    # (the engine's whole-prompt prefill over the stream): the int8 rule
    drift = {f"adapter{reqs[i].adapter_id}": lora_drift(
        params, mcfg, bank, one["done"][i]) for i in range(LORA_ADAPTERS + 1)}
    for name, d in drift.items():
        check(f"lora_serve: teacher-forced drift ({name})", d, TOL_LOGPROB)
    row = dict(
        phase="lora_serve", nvidia_smi=smi, cache=CACHE["dtype"],
        adapters=LORA_ADAPTERS, rank=LORA_RANK, b_std=LORA_B_STD,
        requests=n, lanes=MAX_BATCH, shared_prompt=LORA_SHARED,
        ms_per_step=one["step_ms_median"],
        ms_per_round=rounds["step_ms_median"], decode_steps=MULTISTEP_K,
        base_ms_per_step=runs["base_one_token"]["step_ms_median"],
        base_ms_per_round=runs["base_rounds"]["step_ms_median"],
        tok_s={name: r["tok_s"] for name, r in runs.items()},
        wall_s={name: r["wall_s"] for name, r in runs.items()},
        hits={name: r["hits"] for name, r in runs.items()},
        graph_replays=rounds["replays"],
        rounds_vs_one_token_max_logprob_gap=gap,
        zero_bank_bitwise_base=True, adapted_streams_differing=differ,
        stale_ids_fault_parted=fault_parted,
        teacher_forced_drift=drift, drift_tol=TOL_LOGPROB, b2=b2,
        float32=exact,
        launches=rounds["launches"], one_token_launches=one["launches"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(row)
    del params, bank
    torch.cuda.empty_cache()
    return dict(launches=rounds["launches"], b2=b2)


def ep_dryrun_phase(dev, smi: str) -> dict:
    """The dry run's expert-parallel phase on the card (4 virtual expert
    ranks: B1 and B4/B5 at the dry run's d 32, float32), its loss and
    updated experts against one unsharded train_step of the same
    parameters (loss 1e-5 relative, Δw_gate 1e-5 of its largest entry
    plus an ulp of the weight)."""
    kernels, _, _, _ = _features()
    from tpu_flash_torch import graft_entry as ge

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = ge.ep_dryrun(8)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = ran(kernels)
    launched("ep_dryrun", launches, ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"))
    params, cfg = out["params"], out["cfg"]
    plain, loss = ge.train_step(ge._with_leaves(params, [
        t.clone() for t in ge.param_leaves(params)]), out["tokens"], cfg,
        1e-3)
    errs = []
    for li in range(cfg.num_layers):
        w0 = params["layers"][li]["w_gate"]
        d_ep = torch.cat(out["new"]["layers"][li]["w_gate"]) - w0
        d_plain = plain["layers"][li]["w_gate"] - w0
        tol = (1e-5 * float(d_plain.abs().max())
               + torch.finfo(torch.float32).eps * float(w0.abs().max()))
        errs.append(float((d_ep - d_plain).abs().max()))
        check(f"ep_dryrun layer {li} Δw_gate vs unsharded", errs[-1], tol)
    check("ep_dryrun loss vs unsharded", abs(out["loss"] - float(loss)),
          1e-5 * float(loss))
    row = dict(phase="ep_dryrun", nvidia_smi=smi, ep=out["ep"],
               experts=cfg.moe_experts, loss=out["loss"],
               unsharded_loss=float(loss), delta_w_gate_errs=errs,
               step_s=step_s, launches=launches)
    emit(row)
    return dict(launches=launches)


def slice_phases(dev, smi: str) -> dict:
    """The MoE and multi-LoRA phases, then the EP dry run."""
    with torch.no_grad():
        out = dict(moe_serve=moe_serve_phase(dev, smi))
        torch.cuda.empty_cache()
        out["lora_serve"] = lora_serve_phase(dev, smi)
        torch.cuda.empty_cache()
    out["ep_dryrun"] = ep_dryrun_phase(dev, smi)
    torch.cuda.empty_cache()
    return out


def _timing(row) -> dict:
    return {key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")}


PTXAS_SOURCES = ("flash_fwd.cu", "matmul.cu", "flash_bwd.cu",
                 "flash_bwd_wide.cu", "paged_attention.cu",
                 "paged_attention_wide.cu", "quant_attention.cu")


def short_kernel_name(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace: the kernel
    and its template arguments, e.g. flash_fwd_tcILi128ELi2EE..."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_[0-9a-f]{8}\d+", "", mangled)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpu_flash_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # the build, and beside it the registers and spills of the TMA + wgmma
    # kernels (nvcc -Xptxas -v, a compile of their own): both take about
    # as long as paged_attention.cu's compile
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(PTXAS_SOURCES) + 1) as pool:
        lib = pool.submit(_build.library)
        reports = list(pool.map(_build.ptxas_report, PTXAS_SOURCES))
        lib.result()
        build_s = time.perf_counter() - t0
    ptxas = {src: [[short_kernel_name(k), line] for k, line in rows]
             for src, rows in zip(PTXAS_SOURCES, reports)}
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              torch=torch.__version__, cuda=torch.version.cuda,
              build_s=build_s, ptxas=ptxas))

    with torch.no_grad():
        b1 = flash_phase(dev)
        b23 = paged_phase(dev)
        run = engine_phase(dev)
        engine_launches = held_engine_run("engine", run, TOL_LOGPROB)
        engine_decode_ms = float(np.median(run["step_ms"][1:]))
        # the same serving run from an fp8 and from an int4 cache
        del run
        torch.cuda.empty_cache()
        for dtype, tol in SERVE_CACHES:
            run = engine_phase(dev, cache={**CACHE, "dtype": dtype})
            held_engine_run(f"engine_{dtype}", run, tol)
            del run
            torch.cuda.empty_cache()
        multistep = serve_multistep_phase(dev, smi, engine_decode_ms)
        torch.cuda.empty_cache()
        wide = wide_heads_serve_phase(dev, smi)
        torch.cuda.empty_cache()
    b45 = flash_bwd_phase(dev)
    torch.cuda.empty_cache()
    train = train_phase(dev)
    torch.cuda.empty_cache()
    train_f32 = train_f32_phase(dev)
    torch.cuda.empty_cache()
    wide_train = wide_heads_train_phase(dev)
    torch.cuda.empty_cache()
    wide_f32 = train_wide_f32_phase(dev)
    torch.cuda.empty_cache()
    train_sliding = train_sliding_phase(dev)
    torch.cuda.empty_cache()
    backward_sweep_phase(dev)
    torch.cuda.empty_cache()
    with torch.no_grad():
        quant = quant_attention_phase(dev)
        torch.cuda.empty_cache()
        wide_quant = wide_quant_attention_phase(dev)
        torch.cuda.empty_cache()
    headdims_phase(dev)
    torch.cuda.empty_cache()
    with torch.no_grad():
        qb = quant_bands_phase(dev)
        torch.cuda.empty_cache()
        sliding = sliding_serve_phase(dev)
        torch.cuda.empty_cache()
        sk = sliding_kernels_phase(dev)
        torch.cuda.empty_cache()
        prim = primitives_phase(dev)
        torch.cuda.empty_cache()
        nd = ndim_phase(dev)
        torch.cuda.empty_cache()
    rg = ring_phase(dev)
    torch.cuda.empty_cache()
    par = parallel_phases(dev)
    par_launches = {name: par[name]["launches"] for name in par}
    torch.cuda.empty_cache()
    feat = feature_phases(dev, smi)
    feat_launches = dict(
        speculative=feat["speculative"]["launches"],
        prefix_cache=feat["prefix_cache"]["launches"],
        resume=feat["resume"]["launches"],
        supervisor=feat["resume"]["supervisor_launches"])
    torch.cuda.empty_cache()
    sl = slice_phases(dev, smi)
    slice_launches = {name: sl[name]["launches"] for name in sl}

    def new_paths(*keys, suffix=""):
        """The parallel, serving-feature, MoE, multi-LoRA and EP dry-run
        phases' launches of these kernels, by phase (each phase's main
        path run)."""
        return {f"launches_{name}{suffix}": sum(got.get(k, 0) for k in keys)
                for name, got in {**par_launches, **feat_launches,
                                  **slice_launches}.items()
                if any(got.get(k, 0) for k in keys)}

    spec_checks = feat["speculative"]["checks"]
    hit_b2 = feat["prefix_cache"]["b2"]
    wl, wt, wd = wide["launches"], wide["timed"], wide["decode"]
    wtl, wqt = wide_train["launches"], wide_quant["timed"]

    # launches: the engine run for the serving kernels, the train run for
    # the backward ones (the forward kernel runs in both; the train run's
    # count is reported)
    launches = dict(engine_launches, **{k: train[k] for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    int8 = b23["int8"]
    emit({"kernels": [
        dict(name="flash_fwd", route="cuda",
             source="tpu_flash_torch/csrc/flash_fwd.cu",
             replaces="tpu_flash/ops/flash.py:204",
             launches=launches["flash_fwd"], max_abs_err=b1["max_abs_err"],
             ms=b1["ms"], plain_ms=b1["plain_ms"], bound_ms=b1["bound_ms"],
             bound_by=b1["bound_by"], library_ms=b1["library_ms"],
             **new_paths("flash_fwd")),
        # B2's split route at the int8 decode shape, as the engine's decode
        # calls it: one launch with B3's append fused (time: the fused
        # call; plain: B3's then B2's plain versions under the split plan);
        # launches: the engine run's split launches; beside them the
        # served decode_verify's (64 lanes, held against the plain version
        # on its own inputs, in max_abs_err), and the seq phases' per-rank
        # calls (held the same way, in max_abs_err)
        dict(name="paged_attention (split route, B3 fused)", route="cuda",
             source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:74, tpu_flash/ops/paged.py:267",
             launches=launches["paged_attention_split"],
             launches_serve_multistep=multistep["launches"][
                 "paged_attention_split"],
             launches_decode_verify=multistep["decode_verify"]["served"][
                 "launches"]["paged_attention_split"],
             **new_paths("paged_attention_split"),
             # the seq_decode phase's merged call over 4 int4 ranks (32
             # heads, 4 lanes × 32768 tokens) beside one walk of the whole
             # history, device ms, and its byte bound
             seq_decode=dict(merged_ms=par["seq_decode"]["ms"],
                             single_walk_ms=par["seq_decode"]["single_walk_ms"],
                             bound_ms=par["seq_decode"]["bound_ms"],
                             max_abs_err=par["seq_decode"]["max_abs_err"]),
             max_abs_err=max(
                 *(max(r[k] for k in ("o_vs_plain", "lse_vs_plain"))
                   for r in b23.values()),
                 *(v["b2"]["max_abs_err"]
                   for v in multistep["decode_verify"].values()),
                 *(par[k]["held_b2"]["max_abs_err"]
                   for k in ("seq_serve", "seq_decode")),
                 # the speculative round's verify calls (16 layers, 64
                 # lanes) and a draft micro-step's fused call (G 1)
                 spec_checks["verify"]["max_abs_err"],
                 spec_checks["draft_step"]["o_vs_plain"],
                 spec_checks["draft_step"]["lse_vs_plain"],
                 # one layer's decode call (B3 fused) at one step of the
                 # MoE and the multi-LoRA engines
                 *(sl[k]["b2"][e] for k in ("moe_serve", "lora_serve")
                   for e in ("o_vs_plain", "lse_vs_plain"))),
             ms=int8["fused_ms"],
             plain_ms=int8["append_plain_ms"] + int8["attention_plain_ms"],
             **int8["fused_bound"], library_ms=None),
        # B3's function as the main path runs it: inside the split route's
        # launch (launches: the engine's fused appends; time: the fused
        # call's less the split route's alone at the same shape, against
        # the append's own bytes; pages bit-exact to B3's plain version)
        dict(name="paged_append", route="cuda",
             source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:267",
             launches=launches["paged_append_fused"],
             launches_serve_multistep=multistep["launches"][
                 "paged_append_fused"],
             launches_decode_verify_standalone=multistep["decode_verify"][
                 "served"]["launches"]["paged_append"],
             **new_paths("paged_append_fused"),
             **new_paths("paged_append", suffix="_standalone"),
             max_abs_err=max(r["append_err"] for r in b23.values()),
             ms=int8["fused_append_ms"], plain_ms=int8["append_plain_ms"],
             **int8["append_bound"], library_ms=None),
        # B2's shared-table route at the chunk prefix (512 lanes of one
        # slot, positions 1536..2047, radius 512, int8); launches: sliding
        # engine A's chunked prefill
        dict(name="paged_attention (shared-table route)", route="cuda",
             source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:74",
             launches=sliding["launches"]["paged_attention_shared"],
             **new_paths("paged_attention_shared"),
             # and a prefix hit's tail chunk over the shared pages
             max_abs_err=max(sk["worst"]["paged_attention_shared"],
                             hit_b2["o_vs_plain"], hit_b2["lse_vs_plain"]),
             **_timing(sk["timed"]["chunk_prefix"]), library_ms=None),
        # the kernels at head_dim 512 (wide_heads_serve): launches from the
        # wide model's engine run (B2 shared: its chunked run); B1 timed at
        # n 1024 causal, b 1, 4/2 heads (library: scaled_dot_product_
        # attention, its kernels in the phase's line); B2 and B3 at the
        # decode shape (16 lanes × ~540 tokens, int8, 2 kv heads, G 2) and
        # B2 shared at the chunk prefix (512 lanes over 1536 tokens)
        dict(name="flash_fwd (d 512)", route="cuda",
             source="tpu_flash_torch/csrc/flash_fwd.cu",
             replaces="tpu_flash/ops/flash.py:204",
             launches=wl["flash_fwd"],
             launches_wide_heads_train=wtl["flash_fwd"],
             max_abs_err=max(wide["b1"]["o_vs_plain"], wide["b1"]["lse_vs_plain"],
                             wt["flash_fwd_d512"]["o_vs_plain"],
                             wt["flash_fwd_d512"]["lse_vs_plain"]),
             **_timing(wt["flash_fwd_d512"]),
             library_ms=wt["flash_fwd_d512"]["library_ms"]),
        dict(name="paged_attention (split route, B3 fused, d 512)",
             route="cuda", source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:74, tpu_flash/ops/paged.py:267",
             launches=wl["paged_attention_split"],
             max_abs_err=max(wd["o_vs_plain"], wd["lse_vs_plain"],
                             wd["fused"]["o_vs_plain"],
                             wd["fused"]["lse_vs_plain"],
                             wide["fused"]["o_vs_plain"],
                             wide["fused"]["lse_vs_plain"]),
             ms=wd["fused_ms"],
             plain_ms=wd["append_plain_ms"] + wd["attention_plain_ms"],
             **wd["fused_bound"], library_ms=None),
        dict(name="paged_append (d 512)", route="cuda",
             source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:267",
             launches=wl["paged_append_fused"], max_abs_err=wd["append_err"],
             ms=wd["fused_append_ms"], plain_ms=wd["append_plain_ms"],
             standalone_ms=wd["append_ms"], **wd["append_bound"],
             library_ms=None),
        dict(name="paged_attention (shared-table route, d 512)", route="cuda",
             source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:74",
             launches=wl["paged_attention_shared"],
             max_abs_err=max(wide["shared"]["o_vs_plain"],
                             wide["shared"]["lse_vs_plain"],
                             wt["chunk_prefix"]["o_vs_plain"],
                             wt["chunk_prefix"]["lse_vs_plain"]),
             **_timing(wt["chunk_prefix"]), library_ms=None),
        # B4/B5 at width 512 (flash_bwd_tc.cuh's kernels, instantiated in
        # flash_bwd_wide.cu): launches from the wide model's train run;
        # times at the wide training shape (b 4, 4/2 heads, n 1025 causal,
        # d 512); library: the fastest scaled_dot_product_attention
        # backward that takes d 512, K/V expanded (its backend named in the
        # flash_bwd phase's line); max_abs_err: every backward case and the
        # train run's last-layer call
        *[dict(name=f"flash_bwd_{part} (d 512)", route="cuda",
               source="tpu_flash_torch/csrc/flash_bwd_tc.cuh", replaces=line,
               launches=wtl[f"flash_bwd_{part}"],
               launches_wide_heads_train=wtl[f"flash_bwd_{part}"],
               max_abs_err=max(b45["max_abs_err"],
                               wide_train["held"]["max_abs_err"]),
               **_timing(b45["wide_train_4x1025"][part]),
               library_ms=b45["wide_train_4x1025"]["library_ms"])
          for part, line in (("dq", "tpu_flash/ops/flash_bwd.py:137"),
                             ("dkv", "tpu_flash/ops/flash_bwd.py:252"))],
        # B6/B7 at width 512 (wide_quant_attention): launches from the
        # phase's public calls; times at b 2, 4/2 heads, n 8192, d 512,
        # dense, e4m3 (B6 serving with tensor K scales, B7 end to end);
        # library: bf16 scaled_dot_product_attention there
        *[dict(name=f"{kernel} (d 512)", route="cuda",
               source="tpu_flash_torch/csrc/quant_attention.cu", replaces=line,
               launches=wide_quant["launches"][kernel],
               launches_wide_quant_attention=wide_quant["launches"][kernel],
               max_abs_err=wide_quant["worst"][fam], **_timing(wqt[case]),
               library_ms=wqt[case]["library_ms"])
          for kernel, fam, case, line in (
              ("serving_attention", "serving", "serving_e4m3",
               "tpu_flash/quant/serving_attn.py:59"),
              ("quant_attention", "quant", "quant_e4m3",
               "tpu_flash/quant/flash_q.py:136"))],
        # B4/B5 in float32 at widths 64 and 128 (flash_bwd_f32.cuh, 3×TF32
        # on wgmma): launches from the float32 train run (and the EP dry
        # run's float32 d 32 calls); times at b 1, 16/8 heads, n 1024
        # causal, d 128; bound: 3 tf32 products a float32 one at the tf32
        # peak; library: the float32 backward of scaled_dot_product_
        # attention (K/V expanded), the sum of its kernels' device times
        # (its kernels in the flash_bwd phase's line); max_abs_err: every
        # float32 case
        *[dict(name=f"flash_bwd_{part} (float32, 3xTF32)", route="cuda",
               source="tpu_flash_torch/csrc/flash_bwd_f32.cuh", replaces=line,
               launches=train_f32[f"flash_bwd_{part}"],
               launches_ep_dryrun=slice_launches["ep_dryrun"].get(
                   f"flash_bwd_{part}", 0),
               max_abs_err=b45["max_abs_err_f32"],
               **_timing(b45["f32_causal_1024"][part]),
               library_ms=b45["f32_causal_1024"]["library_ms"])
          for part, line in (("dq", "tpu_flash/ops/flash_bwd.py:137"),
                             ("dkv", "tpu_flash/ops/flash_bwd.py:252"))],
        # B4/B5 in float32 at widths 256 and 512 (flash_bwd_f32.cuh, the
        # head dim split across a 2- or 4-CTA cluster, instantiated in
        # flash_bwd_f32_wide.cu): launches from the wide model's float32
        # train run (width 512); times at the wide training shape (b 4, 4/2
        # heads, n 1025 causal, d 512) and, beside them, at d 256 (b 1,
        # 16/8 heads, n 1024 causal); library: the fastest float32
        # scaled_dot_product_attention backward that takes the shape (K/V
        # expanded; its backend and kernels in the flash_bwd phase's line);
        # max_abs_err: every float32 case and the train run's last-layer
        # call
        *[dict(name=f"flash_bwd_{part} (float32, 3xTF32, d 256/512 cluster)",
               route="cuda", source="tpu_flash_torch/csrc/flash_bwd_f32.cuh",
               replaces=line, launches=wide_f32["launches"][f"flash_bwd_{part}"],
               launches_train_wide_f32=wide_f32["launches"][f"flash_bwd_{part}"],
               max_abs_err=max(b45["max_abs_err_f32"],
                               wide_f32["held"]["max_abs_err"]),
               **_timing(b45["f32_wide_train_4x1025"][part]),
               library_ms=b45["f32_wide_train_4x1025"]["library_ms"],
               d256=dict(**_timing(b45["f32_d256_causal_1024"][part]),
                         library_ms=b45["f32_d256_causal_1024"]["library_ms"]))
          for part, line in (("dq", "tpu_flash/ops/flash_bwd.py:137"),
                             ("dkv", "tpu_flash/ops/flash_bwd.py:252"))],
        # the plain backward and the library's fused backward (K/V expanded
        # to 16 heads outside the call) each compute dq, dk and dv in one
        # call: their times stand in both rows; device times at the
        # training shape; launches: the causal train run's, and the sliding
        # train run's beside them
        *[dict(name=f"flash_bwd_{part}", route="cuda",
               source="tpu_flash_torch/csrc/flash_bwd.cu", replaces=line,
               launches=launches[f"flash_bwd_{part}"],
               launches_train_sliding=train_sliding[f"flash_bwd_{part}"],
               # the EP dry run's float32 launches stand in the float32 rows
               **{k_: v_ for k_, v_ in new_paths(f"flash_bwd_{part}").items()
                  if k_ != "launches_ep_dryrun"},
               max_abs_err=b45["max_abs_err"],
               **_timing(b45["train_4x1024"][part]),
               library_ms=b45["train_4x1024"]["library_ms"])
          for part, line in (("dq", "tpu_flash/ops/flash_bwd.py:137"),
                             ("dkv", "tpu_flash/ops/flash_bwd.py:252"))],
        # B4/B5 on the local_causal kind at the sliding training shape (b 2,
        # 16/8 heads, n 2048, radius 512, d 128); launches: the sliding
        # train run's; library: the fused backward under the same band
        *[dict(name=f"flash_bwd_{part} (local_causal band)", route="cuda",
               source="tpu_flash_torch/csrc/flash_bwd.cu", replaces=line,
               launches=train_sliding[f"flash_bwd_{part}"],
               max_abs_err=b45["max_abs_err"],
               **_timing(b45["sliding_train_2x2048"][part]),
               library_ms=b45["sliding_train_2x2048"]["library_ms"])
          for part, line in (("dq", "tpu_flash/ops/flash_bwd.py:137"),
                             ("dkv", "tpu_flash/ops/flash_bwd.py:252"))],
        # times at the headline (b 4, h 8, n 8192, d 128): B6 in serving
        # fp8 with tensor K scales, B7 in end-to-end fp8; library: bf16
        # scaled_dot_product_attention at that shape (no library call takes
        # a quantized cache)
        dict(name="serving_attention", route="cuda",
             source="tpu_flash_torch/csrc/quant_attention.cu",
             replaces="tpu_flash/quant/serving_attn.py:59, "
                      "tpu_flash/quant/serving_attn.py:349",
             launches=quant["launches"]["serving_attention"],
             max_abs_err=quant["worst"]["serving"],
             **_timing(quant["timed"]["serving_fp8"]),
             library_ms=quant["library_ms"]),
        dict(name="quant_attention", route="cuda",
             source="tpu_flash_torch/csrc/quant_attention.cu",
             replaces="tpu_flash/quant/flash_q.py:136",
             launches=quant["launches"]["quant_attention"],
             **new_paths("quant_attention", "serving_attention"),
             max_abs_err=quant["worst"]["quant"],
             **_timing(quant["timed"]["e2e_fp8"]),
             library_ms=quant["library_ms"]),
        # B6/B7 on the band, circulant and block-diagonal kinds (the
        # quant_bands phase's rows a–e); launches: that row's public call;
        # library: the same function in bf16 (qb_library)
        *[dict(name=f"{kernel} ({label})", route="cuda",
               source="tpu_flash_torch/csrc/quant_attention.cu",
               replaces=line, launches=qb["launches"][case][kernel],
               max_abs_err=qb["worst"][fam], **_timing(qb["timed"][case]),
               library_ms=qb["timed"][case]["library_ms"])
          for kernel, fam, label, case, line in QB_KERNEL_ROWS],
        # TPU kernels folded into B1 and B2, each with its own measurement
        # at the sliding path's shapes; launches: the host kernel's in the
        # sliding engine run (B11, B12: engine A, every B1 launch there is
        # a band, every B2 launch a band walk; B9: engine C, whose prefill
        # runs B1 under the norm bound, at d 128)
        dict(name="flash_fwd (B11 band, folded)", route="cuda",
             source="tpu_flash_torch/csrc/flash_fwd.cu",
             replaces="tpu_flash/ops/flash.py:380",
             launches=sliding["launches"]["flash_fwd"],
             max_abs_err=sk["worst"]["flash_fwd"],
             **_timing(sk["timed"]["band"]),
             library_ms=sk["timed"]["band"]["library_ms"]),
        dict(name="flash_fwd (B9 norm-bound max, folded)", route="cuda",
             source="tpu_flash_torch/csrc/flash_fwd.cu",
             replaces="tpu_flash/ops/flash.py:711",
             launches=sliding["bound_launches"]["flash_fwd"],
             max_abs_err=sk["worst"]["flash_fwd"],
             **_timing(sk["timed"]["bound"]),
             library_ms=sk["timed"]["bound"]["library_ms"]),
        dict(name="paged_attention (B12 pipelined decode, split route, "
                  "B3 fused)",
             route="cuda", source="tpu_flash_torch/csrc/paged_attention.cu",
             replaces="tpu_flash/ops/paged.py:663",
             launches=sliding["launches"]["paged_attention_split"],
             max_abs_err=sk["worst"]["paged_attention_split"],
             **_timing(sk["timed"]["pipelined"]), library_ms=None),
        # B8 (the d <= 64 serving kernel) folded into B6: its shape (d 64,
        # 16/8 heads, causal, n 1000, fp8, tensor K scales); launches: B6 at
        # d 64 in the ndim run (dense2d_fp8, windowed2d_fp8); library: bf16
        # scaled_dot_product_attention at that shape
        dict(name="serving_attention (B8 d <= 64, folded)", route="cuda",
             source="tpu_flash_torch/csrc/quant_attention.cu",
             replaces="tpu_flash/quant/serving_attn.py:349",
             launches=nd["launches"]["ndim"]["serving_attention"],
             max_abs_err=quant["worst"]["serving"],
             **_timing(quant["timed"]["b8_shape"]),
             library_ms=quant["timed"]["b8_shape"]["library_ms"]),
        # the primitives run (fused_softmax, matmul at the sweep's shapes);
        # times at the first row shape of each pass (8192 × 16384 one-pass,
        # 2048 × 131072 two-pass) and 4096³ bf16; library: torch.softmax,
        # torch.logsumexp (the stats pass's function), torch.matmul
        dict(name="softmax_onepass", route="cuda",
             source="tpu_flash_torch/csrc/softmax.cu",
             replaces="tpu_flash/ops/softmax.py:59, tpu_flash/ops/softmax.py:158",
             launches=prim["launches"]["softmax_onepass"],
             max_abs_err=prim["worst"]["softmax_onepass"],
             **_timing(prim["timed"]["softmax_onepass"]),
             library_ms=prim["timed"]["softmax_onepass"]["library_ms"]),
        dict(name="softmax_stats", route="cuda",
             source="tpu_flash_torch/csrc/softmax.cu",
             replaces="tpu_flash/ops/softmax.py:66, tpu_flash/ops/softmax.py:165",
             launches=prim["launches"]["softmax_stats"],
             max_abs_err=prim["worst"]["softmax_stats"],
             **_timing(prim["timed"]["softmax_stats"]),
             library_ms=prim["timed"]["softmax_stats"]["library_ms"]),
        dict(name="softmax_norm", route="cuda",
             source="tpu_flash_torch/csrc/softmax.cu",
             replaces="tpu_flash/ops/softmax.py:87, tpu_flash/ops/softmax.py:186",
             launches=prim["launches"]["softmax_norm"],
             max_abs_err=prim["worst"]["softmax_norm"],
             **_timing(prim["timed"]["softmax_norm"]), library_ms=None),
        dict(name="matmul", route="cuda",
             source="tpu_flash_torch/csrc/matmul.cu",
             replaces="tpu_flash/ops/matmul.py:37",
             launches=prim["launches"]["matmul"],
             max_abs_err=prim["worst"]["matmul"],
             **_timing(prim["timed"]["matmul"]),
             library_ms=prim["timed"]["matmul"]["library_ms"]),
        # B1's new kinds at suite_attention's bands shape (b 1, h 8, n 8192,
        # d 128; window 1025, section 512); launches: the circulant run, and
        # the block run (the block row and block2d); library:
        # scaled_dot_product_attention under the same boolean mask
        dict(name="flash_fwd (B11 circulant, folded)", route="cuda",
             source="tpu_flash_torch/csrc/flash_fwd.cu",
             replaces="tpu_flash/ops/flash.py:380",
             launches=nd["launches"]["circulant"]["flash_fwd"],
             max_abs_err=nd["worst"], **_timing(nd["timed"]["circulant"]),
             library_ms=nd["timed"]["circulant"]["library_ms"]),
        dict(name="flash_fwd (block-diagonal)", route="cuda",
             source="tpu_flash_torch/csrc/flash_fwd.cu",
             replaces="tpu_flash/ops/flash.py:204",
             launches=nd["launches"]["block"]["flash_fwd"],
             max_abs_err=nd["worst"], **_timing(nd["timed"]["block"]),
             library_ms=nd["timed"]["block"]["library_ms"]),
        # the ring hop's shifted kinds (ring phase): times at the band
        # rings' hop 0 at full width (b 1, 32 heads, shard 4096, d 128,
        # shift 0, radius 512); launches: the ring
        # path (the bf16 rings, their gradients and the sequence-parallel
        # train step for B1 and B4/B5, the quantized rings for B7) and for
        # B6 its public call on that hop; library: scaled_dot_product_
        # attention under the hop's boolean mask (forward, or autograd's
        # backward of one saved call)
        *[dict(name=f"{name} (shifted ring hop)", route="cuda",
               source=f"tpu_flash_torch/csrc/{src}", replaces=line,
               launches=(rg["served_launches"] if key == "serving"
                         else rg["launches"][name]),
               max_abs_err=rg["worst"][worst], **_timing(rg["timed"][key]),
               library_ms=rg["timed"][key]["library_ms"])
          for name, key, worst, src, line in (
              ("flash_fwd", "flash_fwd", "flash_fwd", "flash_fwd.cu",
               "tpu_flash/ops/flash.py:204"),
              ("flash_bwd_dq", "flash_bwd_dq", "flash_bwd", "flash_bwd.cu",
               "tpu_flash/ops/flash_bwd.py:137"),
              ("flash_bwd_dkv", "flash_bwd_dkv", "flash_bwd", "flash_bwd.cu",
               "tpu_flash/ops/flash_bwd.py:252"),
              ("serving_attention", "serving", "serving",
               "quant_attention.cu", "tpu_flash/quant/serving_attn.py:59"),
              ("quant_attention", "quant", "quant", "quant_attention.cu",
               "tpu_flash/quant/flash_q.py:136"))],
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
