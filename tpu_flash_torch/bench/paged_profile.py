"""torch.profiler over one decode step and one prefill chunk of the
canonical decode model at full width, one JSON line each.

    python -m tpu_flash_torch.bench.paged_profile [--decode-steps K]

The model is ``chip_smoke.py``'s (vocab 32000, dim 2048, 16 layers, 16 q /
8 kv heads, head_dim 128, bf16 weights from seed 0, a paged cache of 1024
pages × 64, int8 but where said). Steps, each warmed up twice before its
profiled run:

- ``causal_decode``: ``decode_step`` over 16 lanes of 530–549 cached
  tokens (the engine's pages_bound 16), from an int8, an fp8 and an int4
  cache (a page type the checkout's cache refuses prints a ``skipped``
  line);
- ``sliding_decode``: the same with ``attention="sliding", window=1025``
  and the pipelined decode, lanes of 1100–2031 tokens;
- ``sliding_chunk``: ``prefill_chunk`` of 512 tokens at offset 1536 of a
  slot, the sliding model (the chunk prefix through the paged kernel);
- with ``--decode-steps K``, ``causal_round``: the engine's K-step round
  (``serving/engine.py:Engine._round_graph``, one CUDA graph replay, the
  sampling included) over the causal decode's lanes and int8 cache, beside
  ``causal_step``, the round's step body run once eagerly
  (``Engine._step``, its sampling in the round's branch-free form; the
  one-token engine's own step: ``bench/engine_step.py``).

Each line gives the step's host-clock ms (unprofiled, median of 5, ending
in a synchronise), the device ms the profiler's kernels sum to, the kernel
launches (device activities), the device's idle share of the step (1 −
device / step), the device ms by kernel group and the kernels that take
the most; a round's line also the host ms a token. Without ``--decode-steps`` it uses only the port's model
API, so the same script profiles an older checkout of the package on
``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

MODEL = dict(vocab_size=32000, dim=2048, num_layers=16, num_q_heads=16,
             num_kv_heads=8, head_dim=128)
CACHE = dict(num_kv_heads=8, head_dim=128, page_size=64, total_pages=1024,
             max_seqs=32, max_pages_per_seq=64, dtype="int8")
GROUPS = {"paged attention (B2)": ("paged_attention", "paged_split",
                                   "paged_shared"),
          "paged append (B3)": ("paged_append",),
          "flash forward (B1)": ("flash_fwd",),
          "matrix products": ("nvjet", "gemm", "cutlass", "sm90_")}
# kernels a line lists by device time: (name, launches, ms)
TOP = 8


def _caches(lens, dev, n_layers, dtype):
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache

    cfg = CacheConfig(**{**CACHE, "dtype": dtype})
    gen = torch.Generator(device=dev).manual_seed(3)
    base = PagedKVCache.create(cfg, dev)
    perm = torch.randperm(cfg.total_pages - 1, generator=gen, device=dev) + 1
    base.page_tables[: len(lens), :32] = perm[: len(lens) * 32].reshape(
        len(lens), 32).int()
    for s, n in enumerate(lens):
        base.write_prompt(s, torch.randn(8, n, 128, generator=gen, device=dev),
                          torch.randn(8, n, 128, generator=gen, device=dev))
    return [PagedKVCache(*(None if t is None else t.clone() for t in (
        base.k_pages, base.v_pages, base.k_scales, base.v_scales,
        base.page_tables, base.lengths)), config=cfg)
        for _ in range(n_layers)]


def _profile(name, step, reset, cache, tokens=1) -> dict:
    """Profile ``step`` (each run after ``reset``); ``tokens``: the decode
    tokens a lane that one step makes."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        reset()
        step()
    wall = []
    for _ in range(5):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kern}
    total = sum(dev_us.values()) / 1e3
    by_group = {g: sum(v for k, v in dev_us.items()
                       if any(m in k for m in marks)) / 1e3
                for g, marks in GROUPS.items()}
    by_group["other (elementwise, copies, reductions)"] = total - sum(
        by_group.values())
    step_ms = statistics.median(wall)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:TOP]
    return dict(
        step=name, cache=cache, step_ms=step_ms, step_ms_range=[min(wall), max(wall)],
        tokens_per_lane=tokens, ms_per_token=step_ms / tokens,
        device_ms=total, launches=sum(e.count for e in kern),
        idle_share=1.0 - total / step_ms, device_ms_by_group=by_group,
        top_kernels=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
                     for e in top],
        device=torch.cuda.get_device_name(0))


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def profile_round(params, mcfg, K: int, lens, dev, dtype="int8"):
    """(``causal_step``, ``causal_round``) rows: one eager decode step and
    one K-step round (a CUDA graph replay) of an engine over 16 lanes of
    ``lens`` cached tokens (pages_bound 16), greedy sampling included."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.serving.engine import Engine, EngineConfig

    n = len(lens)
    eng = Engine(params, mcfg, CacheConfig(**{**CACHE, "dtype": dtype}),
                 EngineConfig(max_batch=n, decode_steps=K))
    eng.caches = _caches(lens, dev, mcfg.num_layers, dtype)
    start = [c.lengths.clone() for c in eng.caches]
    rng = np.random.default_rng(1)
    inputs = dict(
        tokens=torch.as_tensor(rng.integers(1, mcfg.vocab_size - 1, n),
                               device=dev),
        positions=torch.as_tensor(lens, dtype=torch.int32, device=dev),
        slots=torch.arange(n, dtype=torch.int32, device=dev),
        samp=torch.tensor([[0.0, 0.0, 1.0]] * n, device=dev),
        keys=torch.zeros(n, dtype=torch.int64, device=dev))

    def reset():
        for c, s in zip(eng.caches, start):
            c.lengths.copy_(s)

    g = eng._round_graph(16, K)
    for name, t in inputs.items():
        eng._static[name].copy_(t)
    rows = (_profile("causal_step",
                     lambda: eng._step(*inputs.values(), None, 16),
                     reset, dtype),
            _profile("causal_round", g["graph"].replay, reset, dtype,
                     tokens=K))
    del eng, g
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    from tpu_flash_torch.models import transformer as tfm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="also profile the engine's K-step round (K > 1)")
    args = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for attention in ("causal", "sliding"):
            kw = {} if attention == "causal" else dict(attention="sliding",
                                                       window=1025)
            mcfg = tfm.ModelConfig(**MODEL, **kw)
            params = tfm.init_params(
                mcfg, torch.Generator(device=dev).manual_seed(0), dev)
            lo, hi = (530, 550) if attention == "causal" else (1100, 2032)
            lens = rng.integers(lo, hi, 16).tolist()
            slots = torch.arange(16, dtype=torch.int32, device=dev)
            tokens = torch.as_tensor(rng.integers(1, 31999, 16), device=dev)
            positions = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            for dtype in (("int8", "fp8", "int4") if attention == "causal"
                          else ("int8",)):
                try:
                    caches = _caches(lens, dev, mcfg.num_layers, dtype)
                except (NotImplementedError, ValueError) as e:
                    print(json.dumps(dict(step=f"{attention}_decode",
                                          cache=dtype, skipped=str(e))),
                          flush=True)
                    continue
                start = [c.lengths.clone() for c in caches]

                def reset():
                    for c, s in zip(caches, start):
                        c.lengths.copy_(s)

                def decode():
                    tfm.decode_step(
                        params, tokens, positions, caches, slots, mcfg,
                        pages_bound=16 if attention == "causal" else None,
                        pipelined=attention == "sliding")

                _emit(_profile(f"{attention}_decode", decode, reset, dtype))
            if attention == "causal":
                if args.decode_steps > 1:
                    for row in profile_round(params, mcfg, args.decode_steps,
                                             lens, dev):
                        _emit(row)
                continue
            chunk = torch.as_tensor(rng.integers(1, 31999, (1, 512)), device=dev)
            for c in caches:
                c.lengths[0] = 1536

            def reset_chunk():
                for c in caches:
                    c.lengths[0] = 1536

            def prefill():
                tfm.prefill_chunk(params, chunk, 1536, 512, caches, 0, mcfg,
                                  pages_bound=32)

            _emit(_profile("sliding_chunk", prefill, reset_chunk, "int8"))
            del caches, params
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
