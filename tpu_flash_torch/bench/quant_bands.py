"""B6 and B7 on the band, circulant, block-diagonal and shifted (ring-hop)
schedules, each beside its plain version on the same operands, with the
planted faults that a kernel-vs-plain check must reject.

:func:`band_case` builds the operands of one call the way the public entry
points build them (``serving_flash_attention``: the cache quantized once,
the circulant's phantom zero rows after it; ``quantized_flash_attention``:
K/V halo-extended for the circulant, then quantized) and returns the
kernel's call, the plain version's (optionally with a fault planted), and,
for B6, whether the kernel's staged Q equals the plain staging. Used by
``chip_smoke.py`` (phase ``quant_bands``) and ``tests/test_torch_kernels.py``;
both need a CUDA device for the kernel side.

Faults, each a plain version of a different function:
- ``radius``: the band one key wider on each side;
- ``section``: the block-diagonal sections shifted by one row;
- ``halo``: the circulant over K/V that were not halo-extended (B7);
- ``phantom``: serving circulant without the 2·radius phantom rows (B6);
- ``shift``: the shifted schedule one row further along (shift + 1);
- ``wrap``: the shifted band without its wrap (a wrapped band's second run
  of keys dropped).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_flash_torch.ops.flash import LOG2E, build_schedule, halo_extend
from tpu_flash_torch.ops.schedule import BlockDiagonalSchedule
from tpu_flash_torch.quant import flash_q as tfq
from tpu_flash_torch.quant import serving_attn as tsa
from tpu_flash_torch.quant.qarray import as_dtype


def faults(family: str, schedule: str, wrap_n: int = 0) -> tuple:
    """The planted faults that apply to a family and schedule."""
    if schedule == "shifted":
        return ("shift", "wrap") if wrap_n else ("shift",)
    if schedule == "block":
        return ("section",)
    if schedule == "circulant":
        return ("radius", "phantom" if family == "serving" else "halo")
    return ("radius",)


@dataclasses.dataclass(frozen=True)
class _ShiftedSections(BlockDiagonalSchedule):
    """The block-diagonal rule with every section boundary one row later
    (a planted fault)."""

    def visible(self, q_pos, k_pos):
        return super().visible(q_pos + 1, k_pos + 1)


def band_case(family: str, schedule: str, q, k, v, *, q_dtype, kv_dtype,
              kv_scale: str = "token", bound_max: bool = True,
              radius: int = 0, section: int = 0, pv_quant: bool = False,
              shift: int = 0, wrap_n: int = 0, shifted_causal: bool = False):
    """One call of B6 (``family="serving"``) or B7 (``"quant"``) on
    ``(1, h, n, d)`` q, k, v. Returns ``(kernel, plain, staged)``:
    ``kernel(need_lse=True)`` and ``plain(fault=None)`` give (o, lse) on
    the flattened ``(h, n, dv)`` layout; ``staged()`` (B6 with q_dtype
    only, else None) is True when the kernel's staged Q bytes and row
    factors equal the plain staging's."""
    hq, hkv, n_q, d = q.shape[1], k.shape[1], q.shape[2], q.shape[-1]
    n_kv = k.shape[2]
    hop = dict(shift=shift, wrap_n=wrap_n, shifted_causal=shifted_causal)
    sched = build_schedule(schedule, n_q, n_kv, 1024, 2048, radius=radius,
                           section=section, **hop)
    circ = schedule == "circulant"

    def faulty(fault):
        if fault == "radius":
            return build_schedule(schedule, n_q, n_kv, 1024, 2048,
                                  radius=radius + 1, section=section, **hop)
        if fault == "section":
            return _ShiftedSections(**dataclasses.asdict(sched))
        if fault in ("shift", "wrap"):
            return dataclasses.replace(
                sched, **(dict(shift=shift + 1) if fault == "shift"
                          else dict(wrap_n=0)))
        return sched

    if family == "serving":
        kq, vq = tsa.quantize_kv_cache(k, v, kv_dtype, kv_scale=kv_scale)
        mode = ("raw" if q_dtype is None else
                "int8" if as_dtype(q_dtype) == torch.int8 else "fp8")
        c = tfq.f32(d ** -0.5 * LOG2E)

        def args(fault=None):
            kp, vp = ((kq, vq) if not circ or fault == "phantom"
                      else tfq.phantom_rows(kq, vq, 2 * radius))
            return (*tsa.serving_operands(q, kp, vp, bound_max),
                    faulty(fault), hq, hkv, mode, c, pv_quant)

        ops = args()

        def kernel(need_lse=True):
            return tsa._serving_attention_kernel(*ops, need_lse)

        def plain(fault=None):
            return tsa._serving_plain(*(ops if fault is None else args(fault)))

        def staged():
            _, _, q_op, qs = tsa._serving_attention_kernel(*ops, False,
                                                           staged=True)
            skf = 1.0 if ops[4] is None else ops[4].repeat_interleave(
                hq // hkv)[:, None, None]
            p_op, p_qs = tsa._stage_q_plain(ops[0], mode, c, skf)
            as_ints = (lambda t: t.view(torch.uint8) if t.element_size() == 1
                       else t.view(torch.int16))
            return (torch.equal(as_ints(q_op), as_ints(p_op))
                    and torch.equal(qs, p_qs))

        return kernel, plain, None if mode == "raw" else staged

    k_scaled = kv_scale == "token"
    q_dt = None if q_dtype is None else as_dtype(q_dtype)

    def operands(fault=None):
        kh, vh = k, v
        if circ and fault != "halo":
            kh, vh = halo_extend(k, radius), halo_extend(v, radius)
        prep = tfq.prepare_quantized(q, kh, vh, q_dt, as_dtype(kv_dtype),
                                     k_scaled, d ** -0.5)
        return tfq.quant_operands(*prep, k_scaled, bound_max)

    qops = operands()

    def kernel(need_lse=True):
        return tfq._quant_attention_kernel(*qops, sched, hq, hkv,
                                           torch.bfloat16, need_lse)

    def plain(fault: Optional[str] = None):
        ops = qops if fault in (None, "radius", "section", "shift",
                                "wrap") else operands(fault)
        return tfq._quant_plain(*ops, faulty(fault), hq, hkv, torch.bfloat16)

    return kernel, plain, None
