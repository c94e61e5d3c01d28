"""Tensor-parallel and sequence-sharded serving at full width, with the
ranks on one card or one card a rank.

    python -m tpu_flash_torch.bench.parallel_serve \\
        [--devices cuda:0,cuda:1,cuda:2,cuda:3] [--tp 4] [--seq 4]

Serves the canonical decode model (vocab 32000, dim 2048, 16 layers, 16 q
/ 8 kv heads, d 128, bf16 weights from seed 0) twice, each after a
warm-up request:

* ``tp``: ``Engine(mesh=make_mesh(model=--tp))`` with int8 weights
  (``quantize_weights``) over an int8 cache, 16 greedy requests of 512 +
  32 tokens, rounds of 8 decode steps (``chip_smoke.py``'s ``tp_serve``
  cell; on one card a round is one CUDA graph, across cards it runs
  eagerly);
* ``seq``: ``SeqShardedEngine`` over ``--seq`` ranks of an int4 cache of
  page 64, 4 greedy lanes of 32,704 + 64 tokens (BASELINE config #5, the
  ``seq_serve`` cell).

The ranks sit on ``--devices``: one device holds them all (virtual
ranks), several take them in consecutive blocks. Prints one JSON line a
run: the median host-clock ms of an engine step after the first (a step
ends in a host fetch), new tokens a second over the run's wall time, and
the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from tpu_flash_torch.cache.paged_cache import CacheConfig
from tpu_flash_torch.models import transformer as tfm
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.serving.engine import Engine, EngineConfig, Request
from tpu_flash_torch.serving.seq_engine import SeqShardedEngine

MODEL = dict(vocab_size=32000, dim=2048, num_layers=16, num_q_heads=16,
             num_kv_heads=8, head_dim=128)
TP_CACHE = dict(num_kv_heads=8, head_dim=128, page_size=64, total_pages=1024,
                max_seqs=32, max_pages_per_seq=64, dtype="int8")
SEQ_LANES, SEQ_PROMPT, SEQ_NEW = 4, 32704, 64
SEQ_CACHE = dict(num_kv_heads=8, head_dim=128, page_size=64,
                 total_pages=SEQ_LANES * 520 + 16, max_seqs=SEQ_LANES + 1,
                 max_pages_per_seq=520, dtype="int4")


def _serve(eng, reqs, warm) -> dict:
    eng.submit(warm)
    eng.run()
    torch.cuda.synchronize()
    for r in reqs:
        eng.submit(r)
    n0, step_ms = len(eng.finished), []
    t0 = time.perf_counter()
    while eng.waiting or eng.running or eng.prefilling:
        ts = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = eng.finished[n0:]
    new = sum(len(f.new_tokens) for f in done)
    return dict(requests=len(done), new_tokens=new,
                ms_a_step=float(np.median(step_ms[1:])),
                first_step_ms=step_ms[0], steps=len(step_ms), wall_s=wall,
                tok_s=new / wall)


def run(devices, tp: int, seq: int) -> list:
    dev = torch.device(devices[0])
    mcfg = tfm.ModelConfig(**MODEL)
    params = tfm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    rows = []
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, mcfg.vocab_size - 1, (17, 512)).tolist()
    eng = Engine(tfm.quantize_weights(params), mcfg, CacheConfig(**TP_CACHE),
                 EngineConfig(max_batch=16, decode_steps=8),
                 mesh=make_mesh(model=tp, devices=devices))
    rows.append(dict(run="tp", ranks=tp, devices=devices,
                     graphs=eng._graphs_ok(), **_serve(
                         eng, [Request(rid=i, prompt=prompts[i],
                                       max_new_tokens=32) for i in range(16)],
                         Request(rid=100, prompt=prompts[16],
                                 max_new_tokens=32))))
    del eng
    torch.cuda.empty_cache()
    rng = np.random.default_rng(31)
    prompts = rng.integers(1, mcfg.vocab_size - 1,
                           (SEQ_LANES, SEQ_PROMPT)).tolist()
    eng = SeqShardedEngine(params, mcfg, CacheConfig(**SEQ_CACHE),
                           EngineConfig(max_batch=SEQ_LANES),
                           mesh=make_mesh(seq=seq, devices=devices))
    rows.append(dict(run="seq", ranks=seq, devices=devices, **_serve(
        eng, [Request(rid=i, prompt=p, max_new_tokens=SEQ_NEW)
              for i, p in enumerate(prompts)],
        Request(rid=100, prompt=prompts[0][:1000], max_new_tokens=4))))
    for row in rows:
        row["nvidia_smi"] = smi
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="cuda",
                    help="comma-separated devices the ranks take in blocks")
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    for row in run(args.devices.split(","), args.tp, args.seq):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
