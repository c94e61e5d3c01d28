"""Symmetric max-abs quantizers: port of ``tpu_flash/quant/qarray.py`` —
``quantize``/``dequantize`` for int8, float8_e4m3fn and float8_e5m2, and
the int4 quantizers with their two nibble packings (pairwise, and halves:
the paged cache's layout).

Bit-identical to the reference's eager functions: float32 math,
``max(amax, 1e-12) / qmax``, a true IEEE division ``x / scale``; int8 and
int4 round half to even and clip (±127; [−8, 7]), fp8 casts with
round-to-nearest-even. The paged-append kernels (``csrc/paged_page.cuh``)
and the serving attention kernel's in-kernel Q staging
(``csrc/quant_attention.cu``) repeat this arithmetic and must stay
bit-identical to it.
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
        raise ValueError(
            f"quantized type {dtype!r}: one of {sorted(_NAMES)} (int4 values "
            "go through quantize_int4 or quantize_int4_halves)")
    return _NAMES[dtype]


@dataclasses.dataclass
class QArray:
    """values·scales ≈ original; ``axis`` is the reduction axis the scales
    were computed over (scales have size 1 there)."""

    values: torch.Tensor
    scales: torch.Tensor
    axis: int = -1


def _scales(x32: torch.Tensor, axis, qmax: float) -> torch.Tensor:
    amax = x32.abs().amax(dim=axis, keepdim=True)
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # `tensor / number` into a multiply by the reciprocal (not IEEE)
    return torch.clamp_min(amax, _EPS) / torch.full_like(amax, qmax)


def quantize(x: torch.Tensor, dtype=torch.int8, axis=-1) -> QArray:
    """Symmetric max-abs quantization of ``x`` along ``axis`` (an int or a
    tuple of ints): -1 per token, -2 per channel, (-2, -1) per tensor."""
    dtype = as_dtype(dtype)
    if dtype not in QMAX:
        raise ValueError(f"quantize takes {sorted(map(str, QMAX))}, got "
                         f"{dtype}")
    qmax = QMAX[dtype]
    x32 = x.float()
    scales = _scales(x32, axis, qmax)
    scaled = x32 / scales
    if dtype == torch.int8:
        values = torch.clamp(torch.round(scaled), -qmax, qmax).to(dtype)
    else:
        values = scaled.to(dtype)  # round to nearest even
    return QArray(values=values, scales=scales, axis=axis)


def dequantize(qa: QArray) -> torch.Tensor:
    """f32 reconstruction — the matched-bit-width oracle input."""
    return qa.values.float() * qa.scales


def _nibbles(x: torch.Tensor) -> torch.Tensor:
    """The low four bits of int values in [−8, 7], in int32."""
    return x.to(torch.int32) & 0x0F


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """Pack int values in [−8, 7] pairwise along the last axis into one
    int8 per pair: low nibble = even index, high = odd."""
    if x.shape[-1] % 2:
        raise ValueError("last axis must be even to pack int4 pairs")
    packed = _nibbles(x[..., 0::2]) | (_nibbles(x[..., 1::2]) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def _unnibble(packed: torch.Tensor):
    """(low, high) nibbles of int8 bytes, sign-extended by int32 shifts."""
    x32 = packed.to(torch.int32)
    return ((x32 << 28) >> 28).to(torch.int8), (x32 >> 4).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`."""
    lo, hi = _unnibble(packed)
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def pack_int4_halves(x: torch.Tensor) -> torch.Tensor:
    """Pack int values in [−8, 7] with the last axis split in halves: low
    nibbles hold ``x[..., :d/2]``, high nibbles ``x[..., d/2:]`` (the paged
    cache's int4 layout)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError("last axis must be even")
    packed = _nibbles(x[..., : d // 2]) | (_nibbles(x[..., d // 2:]) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_halves`."""
    return torch.cat(_unnibble(packed), dim=-1)


def _quantize_int4_vals(x: torch.Tensor, axis):
    x32 = x.float()
    scales = _scales(x32, axis, 7.0)
    vals = torch.clamp(torch.round(x32 / scales), -8.0, 7.0).to(torch.int8)
    return vals, scales


def quantize_int4(x: torch.Tensor, axis=-1) -> QArray:
    """int4 symmetric quantization; values nibble-packed in pairs (int8,
    half the last axis)."""
    vals, scales = _quantize_int4_vals(x, axis)
    return QArray(values=pack_int4(vals), scales=scales, axis=axis)


def dequantize_int4(qa: QArray) -> torch.Tensor:
    return unpack_int4(qa.values).float() * qa.scales


def quantize_int4_halves(x: torch.Tensor, axis=-1) -> QArray:
    """int4 symmetric quantization with halves packing."""
    vals, scales = _quantize_int4_vals(x, axis)
    return QArray(values=pack_int4_halves(vals), scales=scales, axis=axis)
