"""Matrix products: port of ``tpu_flash/ops/matmul.py``.

:func:`matmul` is the tiled product of the reference's ``_mm_kernel`` (B14):
``a @ b`` with a float32 sum, rounded once to ``out_dtype`` (a's dtype by
default). CPU tensors take its plain version (k-chunked products summed in
float32); CUDA tensors launch ``csrc/matmul.cu`` on the route that
:func:`_matmul_route` picks by shape and dtype alone, or raise: ``wgmma``
(bf16 with k and n multiples of 8: 128 × 256 tiles of a TMA ring and
``wgmma``), ``wmma`` (other bf16 shapes: 64 × 64 WMMA tiles), ``gemv``
(n == 1, either dtype: a warp per row, bytes-bound) and ``fma`` (float32:
128 × 128 tiles of exact float32 FMA); each masks its ragged edges in the
kernel. :func:`matvec` is a one-column :func:`matmul`, as in the reference,
and so takes the gemv route. :func:`circulant_matmul` is plain PyTorch
(halo, gather, einsum), because the reference computes it outside any
kernel.
"""

from __future__ import annotations

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import _aligned

# k-chunk of the plain version (the reference's default block_k)
PLAIN_BLOCK_K = 512
# route codes of csrc/matmul.cu
MATMUL_ROUTES = {"wmma": 0, "wgmma": 1, "gemv": 2, "fma": 3}


def _matmul_route(m: int, n: int, k: int, dtype) -> str:
    """The kernel route of an ``(m, k) @ (k, n)`` product of ``dtype``
    inputs, by shape and dtype alone: ``gemv`` for one column, ``fma`` for
    float32, ``wgmma`` for bf16 whose k and n give the 16-byte row pitches
    a TMA tensor map needs, ``wmma`` for other bf16 shapes. ``m`` never
    decides: every route takes any number of rows."""
    if n == 1:
        return "gemv"
    if dtype == torch.float32:
        return "fma"
    if k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "wmma"


def _matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Sum of k-chunked float32 products, rounded once to ``out_dtype``."""
    acc = torch.zeros(a.shape[0], b.shape[1], device=a.device)
    for k0 in range(0, a.shape[1], PLAIN_BLOCK_K):
        acc += a[:, k0:k0 + PLAIN_BLOCK_K].float() @ b[k0:k0 + PLAIN_BLOCK_K].float()
    return acc.to(out_dtype)


def _matmul_kernel(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Launch ``tf_matmul`` (B14) on CUDA tensors, on the route of
    :func:`_matmul_route`."""
    from tpu_flash_torch.kernels import _build

    if not (a.is_cuda and b.device == a.device):
        raise ValueError("matmul kernel: a and b must be on one CUDA device")
    ok = (torch.float32, torch.bfloat16)
    if a.dtype not in ok or b.dtype != a.dtype or out_dtype not in ok:
        raise NotImplementedError(
            f"matmul kernel takes float32 or bfloat16 a/b of one dtype and "
            f"out, got {a.dtype}/{b.dtype} → {out_dtype}")
    a, b = _aligned(a), _aligned(b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    route = MATMUL_ROUTES[_matmul_route(m, n, k, a.dtype)]
    err = _build.library().tf_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        kernels.dtype_code(a.dtype), kernels.dtype_code(out_dtype), route,
        kernels.stream_handle(a))
    _build.check(err, "tf_matmul")
    kernels.LAUNCHES["matmul"] += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 512,
           block_n: int = 512, block_k: int = 512,
           out_dtype=None) -> torch.Tensor:
    """Tiled ``a @ b`` of ``(m, k)`` and ``(k, n)`` with a float32 sum, out
    in ``out_dtype`` (default a's dtype). ``block_m/n/k`` (the reference's
    VMEM tiles) are accepted and checked; they set no tile on the card,
    whose kernel runs the tiles of its route (:func:`_matmul_route`)."""
    for name, blk in (("block_m", block_m), ("block_n", block_n),
                      ("block_k", block_k)):
        if not isinstance(blk, int) or blk <= 0:
            raise ValueError(f"{name} must be a positive int, got {blk!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return _matmul_plain(a, b, out_dtype)
    if a.device.type == "cuda":
        return _matmul_kernel(a, b, out_dtype)
    raise NotImplementedError(f"no matmul path for device {a.device}")


def matvec(a: torch.Tensor, x: torch.Tensor, **kw) -> torch.Tensor:
    """``a @ x`` for a matrix and a vector: a one-column :func:`matmul`."""
    return matmul(a, x[:, None], **kw)[:, 0]


def circulant_matmul(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Band-circulant × dense: ``A @ x`` with ``A[i, (i + o) mod n] =
    values[i, c]`` (``o = c − (w−1)/2``, ``w`` odd), without forming A: the
    wraparound band over x becomes contiguous after a halo
    ``cat([x[-r:], x, x[:r]])``, row i reads rows ``i … i + w − 1`` of it,
    and the windowed contraction runs in float32, out in x's dtype."""
    n, w = values.shape
    if w % 2 != 1:
        raise ValueError("band width must be odd")
    r = (w - 1) // 2
    x2 = x if x.ndim == 2 else x[:, None]
    xe = torch.cat([x2[n - r:], x2, x2[:r]]) if r else x2
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(w, device=x.device)[None, :])
    out = torch.einsum("nw,nwc->nc", values.float(), xe[idx].float()).to(x.dtype)
    return out if x.ndim == 2 else out[:, 0]
