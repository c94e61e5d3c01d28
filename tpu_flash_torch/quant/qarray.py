"""Symmetric max-abs int8 quantizer: port of ``quantize``/``dequantize`` from
``tpu_flash/quant/qarray.py``.

Bit-identical to the reference: float32 math, ``max(amax, 1e-12) / 127``,
a true IEEE division ``x / scale``, round half to even, clip to ±127. The
paged-append CUDA kernel (``csrc/paged_append.cu``) repeats this arithmetic
and must stay bit-identical to it.
"""

from __future__ import annotations

import dataclasses

import torch

QMAX = {torch.int8: 127.0}
_EPS = 1e-12


@dataclasses.dataclass
class QArray:
    """values·scales ≈ original; ``axis`` is the reduction axis the scales
    were computed over (scales have size 1 there)."""

    values: torch.Tensor
    scales: torch.Tensor
    axis: int = -1


def quantize(x: torch.Tensor, dtype=torch.int8, axis=-1) -> QArray:
    """Symmetric max-abs quantization of ``x`` along ``axis`` (an int or a
    tuple of ints). Only int8 is ported; fp8 raises (ROADMAP A4)."""
    if dtype not in QMAX:
        raise NotImplementedError(
            f"quantize to {dtype} is not ported yet (ROADMAP A4); int8 only")
    qmax = QMAX[dtype]
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # `tensor / number` into a multiply by the reciprocal (not IEEE)
    scales = torch.clamp_min(amax, _EPS) / torch.full_like(amax, qmax)
    values = torch.clamp(torch.round(x32 / scales), -qmax, qmax).to(dtype)
    return QArray(values=values, scales=scales, axis=axis)


def dequantize(qa: QArray) -> torch.Tensor:
    """f32 reconstruction — the matched-bit-width oracle input."""
    return qa.values.float() * qa.scales
