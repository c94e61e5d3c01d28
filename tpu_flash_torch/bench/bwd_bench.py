"""B4 and B5 at the training shapes, one JSON line: the device time of one
wrapper call (a CUDA graph of 20 calls, ``harness.device_ms``) of each.

    python -m tpu_flash_torch.bench.bwd_bench

Shapes (``chip_smoke.py``'s): the training shape (b 4, 16 q / 8 kv heads,
n 1024 causal, d 128), d 64 at b 1, the sliding training shape (b 2,
n 2048, local_causal radius 512, d 128), d 256 at b 1 (16/8 heads, n 1024
causal) and the wide training shape (b 4, 4 q / 2 kv heads, n 1025 causal,
d 512), bf16; then float32 at b 1, 16/8 heads, n 1024 causal, d 128, 64
and 256, at d 512 (b 1, 4/2 heads, n 1000 causal) and at the wide
training shape. All on prepared operands (``_kernel_operands``), o and
lse from the plain forward (the same in every checkout), with a hash of
each row's dq, dk and dv (``sha``: two checkouts' kernels agree bit for bit
where it is equal). Last, B1 in float32 (``b1_f32_*``: device ms of one
wrapper call) at b 1, 16/8 heads, n 1024 causal, d 64, 128 and 256, at
d 512 (4/2 heads, n 1000), and at the two training shapes (b 4, n 1025
causal: 16/8 heads at d 128, 4/2 at d 512).
``chip_smoke.py``'s flash_bwd phase times the library's backward beside
the timed rows, and ``chip_smoke.sdpa_f32_rows`` the library's fastest
float32 forward and backward at the float32 rows' shapes. It calls only
what every checkout of the port has
had since B4/B5 came in (a schedule the checkout's kernels refuse prints
its error in place of the times), so the same script times an older
checkout on ``PYTHONPATH`` beside this one: run it as a file path from
that checkout's root with ``PYTHONPATH="$PWD"``. Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess

import torch

BF16, F32 = torch.bfloat16, torch.float32
# (name, batch, hq, hkv, n, d, schedule, radius, dtype)
CASES = [("train_4x1024", 4, 16, 8, 1024, 128, "causal", 0, BF16),
         ("d64_causal_1024", 1, 16, 8, 1024, 64, "causal", 0, BF16),
         ("sliding_train_2x2048", 2, 16, 8, 2048, 128, "local_causal", 512,
          BF16),
         ("d256_causal_1024", 1, 16, 8, 1024, 256, "causal", 0, BF16),
         ("wide_train_4x1025", 4, 4, 2, 1025, 512, "causal", 0, BF16),
         ("f32_causal_1024", 1, 16, 8, 1024, 128, "causal", 0, F32),
         ("f32_d64_causal_1024", 1, 16, 8, 1024, 64, "causal", 0, F32),
         ("f32_d256_causal_1024", 1, 16, 8, 1024, 256, "causal", 0, F32),
         ("f32_d512_causal_1000", 1, 4, 2, 1000, 512, "causal", 0, F32),
         ("f32_wide_train_4x1025", 4, 4, 2, 1025, 512, "causal", 0, F32)]
# B1 in float32: (name, batch, hq, hkv, n, d), causal
B1_F32 = [("b1_f32_d64_causal_1024", 1, 16, 8, 1024, 64),
          ("b1_f32_causal_1024", 1, 16, 8, 1024, 128),
          ("b1_f32_d256_causal_1024", 1, 16, 8, 1024, 256),
          ("b1_f32_d512_causal_1000", 1, 4, 2, 1000, 512),
          ("b1_f32_train_4x1025", 4, 16, 8, 1025, 128),
          ("b1_f32_wide_train_4x1025", 4, 4, 2, 1025, 512)]


def digest(*ts) -> str:
    """A hash of the tensors' bytes."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> dict:
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.ops import flash_bwd as fb

    gen = torch.Generator(device="cuda").manual_seed(0)
    row = dict(device=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), package=flash.__file__)
    for name, b, hq, hkv, n, d, schedule, radius, dt in CASES:
        q = (torch.randn(b * hq, n, d, generator=gen, device="cuda")
             * (d ** -0.5 * flash.LOG2E)).to(dt)
        k, v = (torch.randn(b * hkv, n, d, generator=gen, device="cuda")
                .to(dt) for _ in "kv")
        sched = flash.build_schedule(schedule, n, n, 256, 256, radius=radius)
        o, lse = flash._flash_fwd_plain(q, k, v, sched, hq, hkv)
        do = torch.randn(b * hq, n, d, generator=gen, device="cuda").to(dt)
        dlse = torch.randn(b * hq, n, generator=gen, device="cuda")
        try:
            ops = fb._kernel_operands(q, k, v, o, lse, do, dlse, sched, hq,
                                      hkv)
        except NotImplementedError as err:
            row[name] = str(err)
            continue
        row[name] = dict(
            dq_ms=device_ms(lambda: fb._dq_kernel(*ops, sched, hq, hkv)),
            dkv_ms=device_ms(lambda: fb._dkv_kernel(*ops, sched, hq, hkv)),
            sha=digest(fb._dq_kernel(*ops, sched, hq, hkv),
                       *fb._dkv_kernel(*ops, sched, hq, hkv)))
    # B1 in float32
    for name, b, hq, hkv, n, d in B1_F32:
        q = (torch.randn(b * hq, n, d, generator=gen, device="cuda")
             * (d ** -0.5 * flash.LOG2E))
        k, v = (torch.randn(b * hkv, n, d, generator=gen, device="cuda")
                for _ in "kv")
        sched = flash.build_schedule("causal", n, n, 256, 256)
        row[name] = dict(ms=device_ms(lambda: flash._flash_fwd_kernel(
            q, k, v, sched, hq, hkv, True)))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
