"""B4 and B5 at the training shapes, one JSON line: the device time of one
wrapper call (a CUDA graph of 20 calls, ``harness.device_ms``) of each.

    python -m tpu_flash_torch.bench.bwd_bench

Shapes (``chip_smoke.py``'s): the training shape (b 4, 16 q / 8 kv heads,
n 1024 causal, d 128), d 64 at b 1, the sliding training shape (b 2,
n 2048, local_causal radius 512, d 128), d 256 at b 1 (16/8 heads, n 1024
causal) and the wide training shape (b 4, 4 q / 2 kv heads, n 1025 causal,
d 512), bf16, on prepared operands (``_kernel_operands``). It calls only what every checkout of the port has
had since B4/B5 came in (a schedule the checkout's kernels refuse prints
its error in place of the times), so the same script times an older
checkout on ``PYTHONPATH`` beside this one: run it as a file path from
that checkout's root with ``PYTHONPATH="$PWD"``. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess

import torch

# (name, batch, hq, hkv, n, d, schedule, radius)
CASES = [("train_4x1024", 4, 16, 8, 1024, 128, "causal", 0),
         ("d64_causal_1024", 1, 16, 8, 1024, 64, "causal", 0),
         ("sliding_train_2x2048", 2, 16, 8, 2048, 128, "local_causal", 512),
         ("d256_causal_1024", 1, 16, 8, 1024, 256, "causal", 0),
         ("wide_train_4x1025", 4, 4, 2, 1025, 512, "causal", 0)]


def main() -> dict:
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.ops import flash_bwd as fb

    gen = torch.Generator(device="cuda").manual_seed(0)
    row = dict(device=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), package=flash.__file__)
    for name, b, hq, hkv, n, d, schedule, radius in CASES:
        q = (torch.randn(b * hq, n, d, generator=gen, device="cuda")
             * (d ** -0.5 * flash.LOG2E)).bfloat16()
        k, v = (torch.randn(b * hkv, n, d, generator=gen, device="cuda")
                .bfloat16() for _ in "kv")
        sched = flash.build_schedule(schedule, n, n, 256, 256, radius=radius)
        o, lse = flash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
        do = torch.randn(b * hq, n, d, generator=gen, device="cuda").bfloat16()
        dlse = torch.randn(b * hq, n, generator=gen, device="cuda")
        try:
            ops = fb._kernel_operands(q, k, v, o, lse, do, dlse, sched, hq,
                                      hkv)
        except NotImplementedError as err:
            row[name] = str(err)
            continue
        row[name] = dict(
            dq_ms=device_ms(lambda: fb._dq_kernel(*ops, sched, hq, hkv)),
            dkv_ms=device_ms(lambda: fb._dkv_kernel(*ops, sched, hq, hkv)))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
