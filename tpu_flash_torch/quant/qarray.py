"""Symmetric max-abs quantizers: port of ``quantize``/``dequantize`` from
``tpu_flash/quant/qarray.py`` for int8, float8_e4m3fn and float8_e5m2.

Bit-identical to the reference's eager ``quantize``: float32 math,
``max(amax, 1e-12) / qmax``, a true IEEE division ``x / scale``; int8 rounds
half to even and clips to ±127, fp8 casts with round-to-nearest-even. The
paged-append kernel (``csrc/paged_append.cu``) and the serving attention
kernel's in-kernel Q staging (``csrc/quant_attention.cu``) repeat this
arithmetic and must stay bit-identical to it. int4 is not ported yet
(ROADMAP A4).
"""

from __future__ import annotations

import dataclasses

import torch

QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0,
        torch.float8_e5m2: 57344.0}
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
_EPS = 1e-12
_NAMES = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}


def as_dtype(dtype) -> torch.dtype:
    """A quantized storage type given as a torch dtype or by its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _NAMES:
        raise NotImplementedError(
            f"quantized type {dtype!r} is not ported yet (ROADMAP A4); "
            f"one of {sorted(_NAMES)}")
    return _NAMES[dtype]


@dataclasses.dataclass
class QArray:
    """values·scales ≈ original; ``axis`` is the reduction axis the scales
    were computed over (scales have size 1 there)."""

    values: torch.Tensor
    scales: torch.Tensor
    axis: int = -1


def quantize(x: torch.Tensor, dtype=torch.int8, axis=-1) -> QArray:
    """Symmetric max-abs quantization of ``x`` along ``axis`` (an int or a
    tuple of ints): -1 per token, -2 per channel, (-2, -1) per tensor."""
    dtype = as_dtype(dtype)
    if dtype not in QMAX:
        raise NotImplementedError(
            f"quantize to {dtype} is not ported yet (ROADMAP A4)")
    qmax = QMAX[dtype]
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # `tensor / number` into a multiply by the reciprocal (not IEEE)
    scales = torch.clamp_min(amax, _EPS) / torch.full_like(amax, qmax)
    scaled = x32 / scales
    if dtype == torch.int8:
        values = torch.clamp(torch.round(scaled), -qmax, qmax).to(dtype)
    else:
        values = scaled.to(dtype)  # round to nearest even
    return QArray(values=values, scales=scales, axis=axis)


def dequantize(qa: QArray) -> torch.Tensor:
    """f32 reconstruction — the matched-bit-width oracle input."""
    return qa.values.float() * qa.scales
