"""What the card's tf32 tensor cores make of a float32 word, asked through
the float32 B4/B5 themselves.

B4/B5 in float32 (``csrc/flash_bwd_f32.cuh``) split each operand into a
tf32 hi and a lo part. They clear hi's low 13 bits themselves where an
operand comes from registers (A), but hand the raw float32 tile to
``wgmma`` as B's hi part. That is right only if the tensor cores drop a
word's low 13 bits (truncate); if they rounded, B's hi would need a pass
of its own. On one TF32 pass (``_flash_bwd_kernel(..., tf32_passes=1)``,
hi·hi alone) the kernels' grads then follow the plain backward with every
product's operands truncated (``ops/flash_bwd.py:tf32x3``, ``passes=1``)
if the tensor cores truncate, and one with B rounded to nearest if they
round. The operands' low 13 bits are set above a half (not a tie), so the
two ways differ on every staged word.

One CTA each (b 1, one q head and one kv head, n 64: one q tile for B4,
one kv tile for B5), d 64 and 128, causal. It prints one JSON object:
each grad's ``max |a − b| / max |b|`` against the truncating and the
rounding model, the 3-pass kernel against ``tf32x3``, and the verdict, the
model that the one-pass kernel follows by at least ``SEPARATION`` times
closer; it exits 1 without one.

Run on a CUDA machine: ``python -m tpu_flash_torch.bench.tf32_probe``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys

import torch

N, SEPARATION = 64, 20.0


def rounded_b(eq: str, a: torch.Tensor, b: torch.Tensor, *,
              b_of: dict) -> torch.Tensor:
    """One TF32 pass with A truncated and B rounded to nearest (ties away),
    the kernels' product if the tensor cores rounded; ``b_of[eq]`` names
    the einsum operand that is the kernels' B (0 or 1; 0 for a product the
    caller does not read)."""
    from tpu_flash_torch.ops.flash_bwd import tf32_split

    def nearest(t):
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -8192).view(torch.float32)

    i = b_of.get(eq, 0)
    ops = [tf32_split(a)[0], tf32_split(b)[0]]
    ops[i] = nearest((a, b)[i])
    return torch.einsum(eq, *ops)


# which einsum operand of ops/flash_bwd.py:_flash_bwd_plain is B in the
# kernels' products: B4 stages K and V (S = Q·Kᵀ, dP = dO·Vᵀ) and writes dS
# (dQᵀ = Kᵀ·dS); B5 stages Q and dO (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ) and writes P
# and dS (dVᵀ = dOᵀ·P, dKᵀ = Qᵀ·dS)
B4_B = {"bqd,bkd->bqk": 1, "bqk,bkd->bqd": 0}
B5_B = {"bqd,bkd->bqk": 0, "bqk,bqd->bkd": 0}


def patterned(x: torch.Tensor, gen) -> torch.Tensor:
    """float32 ``x`` with its low 13 bits set to 0x1001–0x1fff: above half
    a tf32 step, so truncation and rounding part on every word."""
    low = torch.randint(0x1001, 0x2000, x.shape, generator=gen,
                        device=x.device, dtype=torch.int32)
    return ((x.contiguous().view(torch.int32) & -8192) | low).view(
        torch.float32)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def operands(d: int, dev) -> tuple:
    """flash_backward's arguments at the probe's shape: q (prescaled), k, v
    and dO patterned, o and lse from the forward (B1 on the card)."""
    from tpu_flash_torch.ops import flash

    gen = torch.Generator(device=dev).manual_seed(d)
    scale = [d ** -0.5 * flash.LOG2E, 1.0, 1.0, 1.0]
    q, k, v, do = (patterned(torch.randn(1, N, d, generator=gen, device=dev)
                             * s, gen) for s in scale)
    sched = flash.build_schedule("causal", N, N, 256, 256)
    o, lse = flash._flash_fwd(q, k, v, sched, need_lse=True)
    return q, k, v, o, lse, do, None, sched, 1, 1


def rounding_models(args) -> tuple:
    """(dq, dk, dv) of the plain backward with every product truncated on
    one TF32 pass, and with the kernels' B operands rounded instead."""
    from tpu_flash_torch.ops import flash_bwd as fb

    trunc = fb._flash_bwd_plain(
        *args, products=functools.partial(fb.tf32x3, passes=1))
    # B4's dq from its own products, B5's dk and dv from theirs
    round_dq = fb._flash_bwd_plain(*args, products=functools.partial(
        rounded_b, b_of=B4_B))[0]
    round_dkv = fb._flash_bwd_plain(*args, products=functools.partial(
        rounded_b, b_of=B5_B))[1:]
    return trunc, (round_dq, *round_dkv)


def probe(d: int, dev) -> dict:
    from tpu_flash_torch.ops import flash_bwd as fb

    args = operands(d, dev)
    one = fb._flash_bwd_kernel(*args, tf32_passes=1)
    three = fb._flash_bwd_kernel(*args)
    model = fb._flash_bwd_plain(*args, products=fb.tf32x3)
    trunc, rounded = rounding_models(args)
    out = dict(d=d, n=N, schedule="causal")
    for x, o1, t, r, o3, m in zip("qkv", one, trunc, rounded, three, model):
        out[f"d{x}"] = dict(one_pass_vs_truncating=rel(o1, t),
                            one_pass_vs_rounding=rel(o1, r),
                            three_pass_vs_tf32x3=rel(o3, m))
    return out


def main() -> int:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rows = [probe(d, dev) for d in (64, 128)]
    grads = [g for r in rows for g in (r["dq"], r["dk"], r["dv"])]
    verdict = None
    if all(g["one_pass_vs_rounding"] > SEPARATION * g["one_pass_vs_truncating"]
           for g in grads):
        verdict = "truncate"
    elif all(g["one_pass_vs_truncating"] > SEPARATION * g["one_pass_vs_rounding"]
             for g in grads):
        verdict = "round"
    print(json.dumps(dict(device=smi, separation=SEPARATION, rows=rows,
                          verdict=verdict)), flush=True)
    return 0 if verdict else 1


if __name__ == "__main__":
    sys.exit(main())
