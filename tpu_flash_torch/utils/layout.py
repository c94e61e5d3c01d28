"""Index and layout utilities: port of ``tpu_flash/utils/layout.py``.

* :func:`circulant_neighbors` — the (n, w) key-index map of the band-circulant
  pattern; :func:`circulant_matrix`/:func:`batch_circulant` build the sparse
  matrix from per-entry values (``torch.sparse_coo_tensor`` where the
  reference builds a BCOO).
* :func:`window` — N-d sliding windows (im2col) as per-dim strided gathers,
  as the reference does; :func:`unwindow` is its exact adjoint, a
  scatter-add (``index_add_``) over the same indices in reverse order, where
  the reference derives the transpose of ``window`` automatically.
  :func:`window_counts` gives the overlap divisor, and :func:`windowed`
  runs an attention over the windows and folds the result back with it.

Layout: spatial arrays are ``(batch, *spatial, channels)``. Plain PyTorch:
nothing here is a TPU kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def _as_tuple(x, n: int) -> tuple:
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"expected length-{n} tuple, got {x}")
        return tuple(x)
    return (x,) * n


def circulant_neighbors(n: int, w: int, device="cuda") -> torch.Tensor:
    """Neighbour index map of the n×n band-circulant pattern: ``[i, c]`` is
    key ``(i + c − (w−1)/2) mod n`` (``w`` odd), int64 ``(n, w)``, on
    ``device`` (the card unless the caller asks for another)."""
    if w % 2 != 1:
        raise ValueError(f"circulant window must be odd, got {w}")
    if w > n:
        raise ValueError(f"window {w} larger than sequence {n}")
    p = (w - 1) // 2
    i = torch.arange(n, device=device)[:, None]
    o = torch.arange(-p, p + 1, device=device)[None, :]
    return torch.remainder(i + o, n)


def _circulant_indices(n: int, w: int, device) -> torch.Tensor:
    idx_j = circulant_neighbors(n, w, device)
    idx_i = torch.arange(n, device=device)[:, None].expand(n, w)
    return torch.stack([idx_i.reshape(-1), idx_j.reshape(-1)])


def circulant_matrix(values: torch.Tensor) -> torch.Tensor:
    """``(n, w)`` values → sparse COO ``(n, n)`` with ``A[i, (i + o) mod n] =
    values[i, c]``, ``o = c − (w−1)/2``."""
    n, w = values.shape
    return torch.sparse_coo_tensor(
        _circulant_indices(n, w, values.device), values.reshape(-1), (n, n),
        check_invariants=False)


def batch_circulant(values: torch.Tensor) -> torch.Tensor:
    """``(b, n, w)`` values → sparse COO ``(b, n, n)``, one circulant each."""
    b, n, w = values.shape
    ij = _circulant_indices(n, w, values.device)
    bi = torch.arange(b, device=values.device).repeat_interleave(n * w)
    indices = torch.cat([bi[None], ij.repeat(1, b)])
    return torch.sparse_coo_tensor(indices, values.reshape(-1), (b, n, n),
                                   check_invariants=False)


def _geometry(nd: int, window_size, stride, pad):
    ws = _as_tuple(window_size, nd)
    st = _as_tuple(stride if stride is not None else window_size, nd)
    return ws, st, _as_tuple(pad, nd)


def _starts(size: int, w: int, t: int, k: int, shape, device) -> torch.Tensor:
    """Flat gather index of the windows along one padded dim: ``(nw·w,)``."""
    nw = (size - w) // t + 1
    if nw <= 0:
        raise ValueError(
            f"window {w} exceeds padded spatial extent {size} on dim {k} "
            f"(input {tuple(shape)}; layout is (batch, *spatial, channels) — a "
            "(b, h, n, d) attention array passed here is usually a layout "
            "mistake)")
    idx = (torch.arange(nw, device=device)[:, None] * t
           + torch.arange(w, device=device)[None, :])
    return idx.reshape(-1), nw


def window(x: torch.Tensor, window_size, *, stride=None, pad=0) -> torch.Tensor:
    """Sliding windows of ``(batch, *spatial, channels)`` →
    ``(batch, num_windows, prod(window_size), channels)``, windows and the
    elements inside each row-major over the spatial dims."""
    nd = x.ndim - 2
    if nd not in (1, 2, 3):
        raise ValueError(f"expected 1/2/3 spatial dims, got shape {tuple(x.shape)}")
    ws, st, pd = _geometry(nd, window_size, stride, pad)
    b, c = x.shape[0], x.shape[-1]
    widths = []
    for p in reversed(pd):  # F.pad lists the last dim first; channels: none
        widths += [p, p]
    out = F.pad(x, [0, 0] + widths)
    axis = 1
    for k in range(nd):
        size = out.shape[axis]
        idx, nw = _starts(size, ws[k], st[k], k, x.shape, x.device)
        out = out.index_select(axis, idx).unflatten(axis, (nw, ws[k]))
        axis += 2
    # (b, nw1, w1, …, nwk, wk, c) → (b, nw…, w…, c)
    perm = ([0] + [1 + 2 * k for k in range(nd)]
            + [2 + 2 * k for k in range(nd)] + [out.ndim - 1])
    out = out.permute(perm)
    nwin = math.prod(out.shape[1:1 + nd])
    return out.reshape(b, nwin, math.prod(ws), c)


def unwindow(patches: torch.Tensor, spatial: Sequence[int], window_size, *,
             stride=None, pad=0) -> torch.Tensor:
    """Fold ``(batch, num_windows, prod(window_size), channels)`` back to
    ``(batch, *spatial, channels)``, summing overlaps: the exact adjoint of
    :func:`window` (each dim's gather undone by an ``index_add_`` over the
    same indices, last dim first, then the padding cropped)."""
    nd = len(spatial)
    ws, st, pd = _geometry(nd, window_size, stride, pad)
    b, c = patches.shape[0], patches.shape[-1]
    padded = [s + 2 * p for s, p in zip(spatial, pd)]
    nws = [(s - w) // t + 1 for s, w, t in zip(padded, ws, st)]
    out = patches.reshape(b, *nws, *ws, c)
    perm = [0]
    for k in range(nd):
        perm += [1 + k, 1 + nd + k]
    out = out.permute(perm + [1 + 2 * nd])  # (b, nw1, w1, …, nwk, wk, c)
    for k in reversed(range(nd)):  # dims after k are already folded
        idx, _ = _starts(padded[k], ws[k], st[k], k, patches.shape,
                         patches.device)
        src = out.flatten(1 + 2 * k, 2 + 2 * k)
        shape = list(src.shape)
        shape[1 + 2 * k] = padded[k]
        acc = torch.zeros(shape, dtype=src.dtype, device=src.device)
        out = acc.index_add_(1 + 2 * k, idx, src)
    crop = [slice(None)] + [slice(p, p + s) for p, s in zip(pd, spatial)]
    return out[tuple(crop)]


def window_counts(spatial: Sequence[int], window_size, *, stride=None, pad=0,
                  device="cuda") -> torch.Tensor:
    """Coverage count ``unwindow(window(ones))`` per position, float32
    ``(1, *spatial, 1)``; 0 where no window covers a position."""
    ones = torch.ones((1, *spatial, 1), dtype=torch.float32, device=device)
    w = window(ones, window_size, stride=stride, pad=pad)
    return unwindow(w, spatial, window_size, stride=stride, pad=pad)


def windowed(q, k, v, window_size, *, stride=None, pad=0, attend,
             fold_dtype=None) -> torch.Tensor:
    """Windowed attention over 1-D/2-D/3-D ``(batch, *spatial, heads, ·)``
    q/k/v: ``attend`` runs on the ``(batch·windows, heads, window, ·)``
    patches; its output folds back (in ``fold_dtype``, default its own)
    and positions that several windows cover take the mean over them
    (0 where none does). Returns ``(batch, *spatial, heads, dv)`` in q's
    dtype."""
    nd = q.ndim - 3
    if nd not in (1, 2, 3):
        raise ValueError(f"expected (batch, *spatial(1..3), heads, d), got "
                         f"{tuple(q.shape)}")
    b, *spatial, h, _ = q.shape
    dv = v.shape[-1]

    def to_patches(x):
        xdim = x.shape[-1]
        pw = window(x.reshape(b, *spatial, h * xdim), window_size,
                    stride=stride, pad=pad)
        nwin, wlen = pw.shape[1], pw.shape[2]
        pw = pw.reshape(b, nwin, wlen, h, xdim).transpose(2, 3)
        return pw.reshape(b * nwin, h, wlen, xdim)

    ow = attend(to_patches(q), to_patches(k), to_patches(v))
    ow = ow.reshape(b, -1, h, ow.shape[2], dv).transpose(2, 3)
    ow = ow.reshape(b, ow.shape[1], ow.shape[2], h * dv)
    if fold_dtype is not None:
        ow = ow.to(fold_dtype)
    folded = unwindow(ow, spatial, window_size, stride=stride, pad=pad)
    counts = window_counts(spatial, window_size, stride=stride, pad=pad,
                           device=q.device).to(folded.dtype)
    out = torch.where(counts > 0, folded / torch.clamp_min(counts, 1), 0)
    return out.reshape(b, *spatial, h, dv).to(q.dtype)


def flatten_spatial(x: torch.Tensor):
    """(batch, *spatial, heads, dim) → ((batch, heads, N, dim), spatial)."""
    *lead, h, d = x.shape
    b, spatial = lead[0], tuple(lead[1:])
    n = math.prod(spatial)
    return x.reshape(b, n, h, d).movedim(1, 2), spatial


def unflatten_spatial(x: torch.Tensor, spatial: tuple) -> torch.Tensor:
    """(batch, heads, N, dim) → (batch, *spatial, heads, dim)."""
    b, h, n, d = x.shape
    return x.movedim(1, 2).reshape(b, *spatial, h, d)
