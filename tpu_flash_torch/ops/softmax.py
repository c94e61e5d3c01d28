"""Fused softmax (B13a–f): port of ``tpu_flash/ops/softmax.py``.

:func:`fused_softmax` views its input as ``(L, n, m)`` fibers of length
``n`` (element stride ``m``): axis −1 is ``m = 1`` (the reference's row
kernels), axis −2 the softmax down the columns with no transpose (its
column kernels), any other axis moves to −1 first. A fiber that fits the
kernel's shared memory takes the one-pass kernel (max, exp, sum, divide:
``p / Σp``); a longer one takes the stats pass (the online (m, l) merge →
lse) and the norm pass (``exp(x − lse)``). The threshold is the card's, not
the TPU's VMEM budget: the resident fibers of a block, in float32, within
``ONEPASS_SMEM_BYTES`` — a row of up to 16384, or 32 neighbouring columns of
up to 512.

Each pass dispatches on the tensor's device: CPU tensors take its plain
PyTorch version, CUDA tensors launch ``csrc/softmax.cu`` (or raise).
"""

from __future__ import annotations

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import _aligned

# shared memory the one-pass kernel may hold its fibers in, and the number
# of neighbouring fibers a column block keeps (csrc/softmax.cu)
ONEPASS_SMEM_BYTES = 64 * 1024
COL_FIBERS = 32
# the plain stats pass merges the fiber in chunks of this length
STATS_CHUNK = 2048
# −inf stand-in of the reference's running max
NEG_BIG = -1e30


def onepass_fits(n: int, m: int) -> bool:
    """Whether ``(L, n, m)`` fibers take the one-pass kernel."""
    return 4 * n * (1 if m == 1 else COL_FIBERS) <= ONEPASS_SMEM_BYTES


def _onepass_plain(x3: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 1 of ``(L, n, m)``: amax, exp, sum and divide in
    float32, out in x's dtype."""
    x = x3.float()
    p = torch.exp(x - x.amax(dim=1, keepdim=True))
    return (p / p.sum(dim=1, keepdim=True)).to(x3.dtype)


def _stats_plain(x3: torch.Tensor) -> torch.Tensor:
    """lse ``(L, m)`` float32 of each fiber: the online (m, l) merge over
    chunks of ``STATS_CHUNK``, the running max starting at −1e30."""
    L, n, m = x3.shape
    mx = torch.full((L, m), NEG_BIG, device=x3.device)
    l = torch.zeros(L, m, device=x3.device)
    for c0 in range(0, n, STATS_CHUNK):
        x = x3[:, c0:c0 + STATS_CHUNK].float()
        m_new = torch.maximum(mx, x.amax(dim=1))
        l = l * torch.exp(mx - m_new) + torch.exp(x - m_new[:, None]).sum(dim=1)
        mx = m_new
    return mx + torch.log(l)


def _norm_plain(x3: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """exp(x − lse) on ``(L, n, m)`` with lse ``(L, m)``, out in x's dtype."""
    return torch.exp(x3.float() - lse[:, None, :]).to(x3.dtype)


def _kernel_operand(x3: torch.Tensor) -> torch.Tensor:
    if not x3.is_cuda:
        raise ValueError("softmax kernels take CUDA tensors")
    if x3.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"softmax kernels take float32 or bfloat16, got {x3.dtype}")
    return _aligned(x3)


def _sizes(x3):
    L, n, m = x3.shape
    return n, L * m, m


def _onepass_kernel(x3: torch.Tensor) -> torch.Tensor:
    """Launch ``tf_softmax_onepass`` (B13a rows, B13d columns)."""
    from tpu_flash_torch.kernels import _build

    x3 = _kernel_operand(x3)
    if not onepass_fits(x3.shape[1], x3.shape[2]):
        raise ValueError(f"fibers of {tuple(x3.shape)} exceed the one-pass "
                         "kernel's shared memory")
    out = torch.empty_like(x3)
    err = _build.library().tf_softmax_onepass(
        x3.data_ptr(), out.data_ptr(), *_sizes(x3),
        kernels.dtype_code(x3.dtype), kernels.stream_handle(x3))
    _build.check(err, "tf_softmax_onepass")
    kernels.LAUNCHES["softmax_onepass"] += 1
    return out


def _stats_kernel(x3: torch.Tensor) -> torch.Tensor:
    """Launch ``tf_softmax_stats`` (B13b rows, B13e columns) → lse (L, m)."""
    from tpu_flash_torch.kernels import _build

    x3 = _kernel_operand(x3)
    lse = torch.empty(x3.shape[0], x3.shape[2], device=x3.device)
    err = _build.library().tf_softmax_stats(
        x3.data_ptr(), lse.data_ptr(), *_sizes(x3),
        kernels.dtype_code(x3.dtype), kernels.stream_handle(x3))
    _build.check(err, "tf_softmax_stats")
    kernels.LAUNCHES["softmax_stats"] += 1
    return lse


def _norm_kernel(x3: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Launch ``tf_softmax_norm`` (B13c rows, B13f columns)."""
    from tpu_flash_torch.kernels import _build

    x3 = _kernel_operand(x3)
    if lse.shape != (x3.shape[0], x3.shape[2]) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} does not fit "
                         f"{tuple(x3.shape)}")
    lse = _aligned(lse.to(x3.device))
    out = torch.empty_like(x3)
    err = _build.library().tf_softmax_norm(
        x3.data_ptr(), lse.data_ptr(), out.data_ptr(), *_sizes(x3),
        kernels.dtype_code(x3.dtype), kernels.stream_handle(x3))
    _build.check(err, "tf_softmax_norm")
    kernels.LAUNCHES["softmax_norm"] += 1
    return out


def _on(x3, plain_fn, kernel_fn, *args):
    if x3.device.type == "cpu":
        return plain_fn(x3, *args)
    if x3.device.type == "cuda":
        return kernel_fn(x3, *args)
    raise NotImplementedError(f"no softmax path for device {x3.device}")


def softmax_onepass(x3):
    return _on(x3, _onepass_plain, _onepass_kernel)


def softmax_stats(x3):
    return _on(x3, _stats_plain, _stats_kernel)


def softmax_norm(x3, lse):
    return _on(x3, _norm_plain, _norm_kernel, lse)


def _softmax3(x3: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Softmax over axis 1 of ``(L, n, m)``: one pass, or stats then norm;
    ``plain`` runs the plain versions on any device."""
    if onepass_fits(x3.shape[1], x3.shape[2]):
        return (_onepass_plain if plain else softmax_onepass)(x3)
    lse = (_stats_plain if plain else softmax_stats)(x3)
    return (_norm_plain if plain else softmax_norm)(x3, lse)


def _fused_softmax(x: torch.Tensor, axis: int, plain: bool) -> torch.Tensor:
    axis = axis % x.ndim
    if x.ndim >= 2 and axis == x.ndim - 2:
        n, m = x.shape[-2], x.shape[-1]
        out = _softmax3(x.reshape(-1, n, m), plain)
        return out.reshape(x.shape)
    xt = x.movedim(axis, -1)
    out = _softmax3(xt.reshape(-1, xt.shape[-1], 1), plain).reshape(xt.shape)
    return out.movedim(-1, axis)


def fused_softmax(x: torch.Tensor, axis: int = -1, *,
                  block_rows: int = 1024) -> torch.Tensor:
    """Numerically stable softmax over ``axis`` through the fused kernels:
    axis −1 takes the row kernels, axis −2 the column kernels (no
    transpose), other axes move to −1 first. Float32 math, out in x's
    dtype. ``block_rows`` (the reference's rows per VMEM block) is accepted
    and checked; it sets no tile on the card."""
    if not isinstance(block_rows, int) or block_rows <= 0:
        raise ValueError(f"block_rows must be a positive int, got {block_rows!r}")
    return _fused_softmax(x, axis, plain=False)
