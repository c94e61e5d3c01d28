"""How the card's fp8 tensor cores sum the products of a score.

B6/B7 dot e4m3 q̂ with e4m3/e5m2 K̂ on ``wgmma`` (``csrc/quant_attention.cu``),
one k32 step at a time, and add the steps in float32. This script measures
those sums through the kernel itself: with one key per head, row factor 1
and no K scale, the kernel's lse is fl(s·ln2) with s its float32 score.
Each (head, row) is one experiment.

It prints, as one JSON object per line:

- ``one_k32_step``: on 65536 patterned e4m3 and 65536 random e5m2 steps,
  the share of lse values that the port's model of those sums
  (``quant/flash_q.py:fp8_scores``, the plain version's) reproduces bit for
  bit, beside two simpler models (no guard bit; exact float32 sums);
- ``scores``: per head dim, the share of whole scores the model
  reproduces, how far the card's scores land from exact sums, as
  natural-log score errors for randn inputs quantized as the port quantizes
  them (one key per row makes that the lse error), and what cutting each
  k32 step into 16- or 8-lane steps, a ±q̂ mean or a two-way split of q̂ by
  magnitude would give.

Run on a CUDA machine: ``python -m tpu_flash_torch.bench.fp8_sums``.
"""

from __future__ import annotations

import json
import math

import torch

LN2 = torch.tensor(0.693147180559945309, dtype=torch.float32)
HEADS, ROWS = 64, 1024
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    return x.to(E4M3)


def quantized(gen, d: int, k_dtype, dev):
    """randn q (HEADS, ROWS, d) and k (HEADS, 1, d) quantized per row as the
    port does (amax → the format's max) → (q̂, k̂, natural-score factor
    (HEADS, ROWS) = σq·σk/√d)."""
    q = torch.randn(HEADS, ROWS, d, generator=gen, device=dev)
    k = torch.randn(HEADS, 1, d, generator=gen, device=dev)
    kmax = 448.0 if k_dtype == E4M3 else 57344.0
    sq = q.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 448.0
    sk = k.abs().amax(-1, keepdim=True).clamp_min(1e-12) / kmax
    q8, k8 = _e4m3(q / sq), (k / sk).to(k_dtype)
    return q8, k8, (sq * sk.transpose(1, 2))[..., 0] / math.sqrt(d)


def patterned(gen, dev):
    """One k32 step per (head, row), lanes 32-63 zero, e4m3 K̂. Heads 0-15:
    random q̂ against k̂ = 1.875; 16-31: 448 or 240 in lane 0 and one e4m3
    value (all of them in turn, negative on odd heads) in lane 1-9, k̂ =
    1.875; 32-47: 448 in lane 0 and one e4m3 value in every other lane,
    random signs, random k̂; 48-63: random q̂ and k̂ → (q̂, k̂)."""
    vals = torch.arange(1, 127, dtype=torch.uint8, device=dev).view(E4M3).float()
    q8, k8, _ = quantized(gen, 64, E4M3, dev)
    q, k = q8.float(), k8.float()
    k[:32] = 1.875
    r = torch.arange(ROWS, device=dev)
    small = vals[r % 126]
    for h in range(16, 32):
        q[h] = 0.0
        q[h, :, 0] = 448.0 if h < 24 else 240.0
        q[h, r, 1 + (r // 126) % 31] = small * (-1.0 if h % 2 else 1.0)
    sign = torch.randint(0, 2, (16, ROWS, 31), generator=gen, device=dev) * 2 - 1
    q[32:48, :, 0] = 448.0
    q[32:48, :, 1:32] = small[None, :, None] * sign
    q[..., 32:] = 0.0
    return _e4m3(q), _e4m3(k)


def kernel_lse(q8: torch.Tensor, k8: torch.Tensor) -> torch.Tensor:
    """The kernel's lse = fl(s·ln2) of each (head, row) against its head's
    one key, s = Σ q̂·k̂ its float32 score → float32 (HEADS, ROWS) on the
    CPU."""
    from tpu_flash_torch import kernels
    from tpu_flash_torch.kernels import _build

    h, r, d = q8.shape
    dev = q8.device
    q8, k8 = q8.contiguous(), k8.contiguous()
    v8 = torch.zeros_like(k8)
    sq = torch.ones(h, r, device=dev)
    sv = torch.ones(h, d, device=dev)
    o = torch.empty(h, r, d, device=dev, dtype=torch.bfloat16)
    lse = torch.empty(h, r, device=dev)
    err = _build.library().tf_quant_attention(
        q8.data_ptr(), sq.data_ptr(), k8.data_ptr(), v8.data_ptr(), None,
        sv.data_ptr(), None, o.data_ptr(), lse.data_ptr(), h, r, 1, 1, 1, d,
        0, 0, 0, 0, 2, kernels.KV_CODES[k8.dtype], 0, 1.0,
        kernels.stream_handle(q8))
    _build.check(err, "tf_quant_attention")
    torch.cuda.synchronize()
    return lse.cpu()


def model_lse(q8: torch.Tensor, k8: torch.Tensor, guard: bool = True):
    """fl(s·ln2), s the port's model of the card's sums
    (``flash_q.fp8_scores``), or with the products truncated at 2^(E−13)
    (no guard bit) when ``guard`` is false."""
    from tpu_flash_torch.quant import flash_q

    q, k = q8.float().cpu(), k8.float().cpu()
    if guard:
        return flash_q.fp8_scores(q, k, q8.dtype, k8.dtype)[..., 0] * LN2
    e = (flash_q._exponents(q, flash_q.FP8_EMIN[q8.dtype])
         + flash_q._exponents(k, flash_q.FP8_EMIN[k8.dtype])).amax(-1) + 1
    e = torch.clamp_min(e, -100.0)
    t = flash_q._truncate(q * k, (e - 13)[..., None]).sum(-1)
    return flash_q._truncate(t, torch.frexp(t).exponent.float() - 14) * LN2


def _share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).double().mean())


def _stats(lse: torch.Tensor, exact: torch.Tensor, nat: torch.Tensor) -> dict:
    """Natural-log score errors of scores lse/ln2 against exact sums."""
    err = (lse.double() / LN2.double() - exact) * nat.double().cpu()
    e = err.abs().flatten()
    return dict(nat_max=float(e.max()),
                nat_p9999=float(torch.quantile(e.float(), 0.9999)),
                nat_mean_signed=float(err.mean()))


def _split(q8: torch.Tensor, parts: int):
    """q̂ with each k32 step cut into ``parts`` lane ranges: one operand per
    range, zero elsewhere."""
    lane = torch.arange(q8.shape[-1], device=q8.device) % 32
    width = 32 // parts
    return [_e4m3(torch.where(lane // width == i, q8.float(), 0.0))
            for i in range(parts)]


def main() -> int:
    if not torch.cuda.is_available():
        print("fp8_sums needs a CUDA device")
        return 1
    from tpu_flash_torch.quant import flash_q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    q8, k8 = patterned(gen, dev)
    lane = torch.arange(64, device=dev)
    r8, s8, _ = quantized(gen, 64, E5M2, dev)
    r8 = _e4m3(torch.where(lane < 32, r8.float(), 0.0))
    for name, (qq, kk) in (("patterned_e4m3", (q8, k8)),
                           ("random_e5m2", (r8, s8))):
        card = kernel_lse(qq, kk)
        qs, ks = qq[..., :32], kk[..., :32]
        exact = (qs.double() * ks.double()).sum(-1).float().cpu() * LN2
        print(json.dumps(dict(
            experiment="one_k32_step", data=name, n=card.numel(),
            lse_equal_model=_share(card, model_lse(qs, ks)),
            lse_equal_no_guard_bit=_share(card, model_lse(qs, ks, False)),
            lse_equal_float32_sums=_share(card, exact))), flush=True)

    for d, k_dtype in ((64, E4M3), (128, E4M3), (256, E4M3), (128, E5M2)):
        q8, k8, nat = quantized(gen, d, k_dtype, dev)
        exact = (q8.double() * k8.double()).sum(-1).cpu()
        card = kernel_lse(q8, k8)
        model = flash_q.fp8_scores(q8.float().cpu(), k8.float().cpu(), E4M3,
                                   k_dtype)[..., 0] * LN2
        row = dict(experiment="scores", d=d, k_dtype=str(k_dtype)[6:],
                   lse_equal_model=_share(card, model),
                   promoted_k32=_stats(card, exact, nat))
        for parts in (2, 4):
            s = sum(kernel_lse(qp, k8).double() for qp in _split(q8, parts))
            row[f"k{32 // parts}_steps"] = _stats(s, exact, nat)
        neg = kernel_lse(_e4m3(-q8.float()), k8)
        row["negated_mean"] = _stats((card - neg) / 2, exact, nat)
        big = q8.float().abs() >= 28.0
        hi = _e4m3(torch.where(big, q8.float(), 0.0))
        lo = _e4m3(torch.where(big, 0.0, q8.float() * 16.0))
        s = kernel_lse(hi, k8).double() + kernel_lse(lo, k8).double() / 16.0
        row["magnitude_split"] = _stats(s, exact, nat)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
