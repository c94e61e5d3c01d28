"""Host ms and device work of the one-token ``Engine.step`` at the serving
smoke's engine cell, one JSON line a batch.

    python -m tpu_flash_torch.bench.engine_step
    PYTHONPATH=<older checkout> python tpu_flash_torch/bench/engine_step.py

The cell is ``chip_smoke.py``'s engine phase: the canonical decode model
(vocab 32000, dim 2048, 16 layers, 16 q / 8 kv heads, head_dim 128, bf16
weights from seed 0), an int8 paged cache of 1024 pages × 64, 16 requests
of 512-token prompts on 16 lanes. Two batches: ``mixed``, the engine
phase's (the last request at temperature 0.7, top-k 50, top-p 0.9, the
rest greedy), and ``greedy``. After the step that admits and prefills
every request and two more, ``STEPS`` one-token steps are timed on the
host clock (each ends in the fetch of its tokens), then one more is
profiled (``torch.profiler``): its device ms, its device activities
(kernel launches) and the device's idle share of the median step. Only
the engine's public API is used, so the second form measures an older
checkout of the package with this script.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

MODEL = dict(vocab_size=32000, dim=2048, num_layers=16, num_q_heads=16,
             num_kv_heads=8, head_dim=128)
CACHE = dict(num_kv_heads=8, head_dim=128, page_size=64, total_pages=1024,
             max_seqs=32, max_pages_per_seq=64, dtype="int8")
LANES, PROMPT_LEN, STEPS = 16, 512, 24


def engine_step(batch: str, params, mcfg, dev) -> dict:
    """The ``batch`` row (``mixed`` or ``greedy``)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_flash_torch.cache.paged_cache import CacheConfig
    from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request

    eng = Engine(params, mcfg, CacheConfig(**CACHE),
                 EngineConfig(max_batch=LANES))
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (LANES, PROMPT_LEN)).tolist()
    for i, prompt in enumerate(prompts):
        hot = batch == "mixed" and i == LANES - 1
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=STEPS + 8,
                           temperature=0.7 if hot else 0.0,
                           top_k=50 if hot else 0,
                           top_p=0.9 if hot else 1.0))
    for _ in range(3):  # admission and prefill, then two warm steps
        eng.step()
    if len(eng.running) != LANES:
        raise RuntimeError(f"{len(eng.running)} lanes decoding, not {LANES}")
    wall = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        eng.step()  # ends in the host fetch of the sampled tokens
        wall.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    step_ms = statistics.median(wall)
    del eng
    torch.cuda.empty_cache()
    return dict(step="engine_step", batch=batch, lanes=LANES,
                step_ms=step_ms, step_ms_range=[min(wall), max(wall)],
                steps_timed=STEPS, device_ms=device_ms,
                launches=sum(e.count for e in kern),
                idle_share=1.0 - device_ms / step_ms,
                device=torch.cuda.get_device_name(0))


def main() -> int:
    from tpu_flash_torch.models import transformer as tfm

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    with torch.no_grad():
        for batch in ("mixed", "greedy"):
            print(json.dumps(engine_step(batch, params, mcfg, dev)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
