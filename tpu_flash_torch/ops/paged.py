"""Paged decode attention (B2) and the one-token append (B3): port of
``paged_attention``, ``paged_attention_pipelined``, ``fused_append`` and
``_encode_row`` from ``tpu_flash/ops/paged.py``.

One query token per lane attends its slot's pages, walking the page table
page by page with an online base-2 softmax. q is cast to bf16 whatever the
model dtype, and so are the K/V pages before the dots; int8 pages fold their
per-token K scale into the score column and their V scale into P.

The reference fuses the new token's quantize+append into the attention
pass. Here ``paged_attention(new_kv=...)`` launches the append (B3) and then
the attention (B2) on the same stream: the new token attends its own
quantized K/V exactly as in the fused kernel. Both update the cache in
place.

The reference's pipelined decode kernel (B12, ``_pipe_kernel``) walks
each lane's own pages with a hand-pipelined DMA loop; on the card that is
B2 with an uncapped walk (plus B3 for the append), so B12 folds into them.

Each wrapper dispatches on the tensors' device: CPU tensors take the plain
PyTorch version, CUDA tensors launch ``csrc/paged_attention.cu`` or
``csrc/paged_append.cu``, or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.ops.flash import DEFAULT_MASK_VALUE, LN2, LOG2E
from tpu_flash_torch.ops.schedule import cdiv


def _encode_row(x: torch.Tensor, *, quantized: bool, out_dtype):
    """(…, d) f32 → (storage values (…, d), scales (…, 1) | None).
    Bit-identical to PagedKVCache._encode (same eps, IEEE divide, round
    half to even, clip)."""
    if not quantized:
        return x.to(out_dtype), None
    amax = x.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor keeps the IEEE divide on CUDA (see quant/qarray.py)
    sc = torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)
    qv = torch.clamp(torch.round(x / sc), -127.0, 127.0)
    return qv.to(torch.int8), sc


# -- B3: append ---------------------------------------------------------------


def _paged_append_plain(k_new, v_new, k_pages, v_pages, k_scales, v_scales,
                        slots, lengths, page_tables):
    """Write row ``lengths[slot] % page`` of page
    ``page_tables[slot, lengths[slot] // page]`` for every lane, in place.
    Lengths are read, not advanced."""
    page = k_pages.shape[2]
    sl = slots.long()
    pos = lengths[sl].long()
    tpage = torch.clamp(pos // page, max=page_tables.shape[1] - 1)
    phys = page_tables[sl, tpage].long()
    off = pos % page
    quantized = k_scales is not None
    for new, pages, scales in ((k_new, k_pages, k_scales),
                               (v_new, v_pages, v_scales)):
        vals, sc = _encode_row(new.float(), quantized=quantized,
                               out_dtype=pages.dtype)  # (B, kvh, d)
        pages[:, phys, off] = vals.transpose(0, 1)
        if quantized:
            scales[:, phys, off] = sc[..., 0].transpose(0, 1)


def _paged_append_kernel(k_new, v_new, k_pages, v_pages, k_scales, v_scales,
                         slots, lengths, page_tables):
    """Launch ``csrc/paged_append.cu`` (same contract as the plain version)."""
    from tpu_flash_torch.kernels import _build

    b, kvh, d = k_new.shape
    _, total, page, stor = k_pages.shape
    quantized = k_scales is not None
    _check_cuda("paged_append", slots, lengths, page_tables, k_new, v_new,
                k_pages, v_pages, *((k_scales, v_scales) if quantized else ()))
    if k_new.dtype not in (torch.bfloat16, torch.float32) or (
            v_new.dtype != k_new.dtype):
        raise NotImplementedError(f"append kernel: new K/V dtype {k_new.dtype}")
    if stor != d:
        raise ValueError(f"append kernel: head_dim {d}, storage {stor}")
    _check_head_dim("append", d)
    if quantized != (k_pages.dtype == torch.int8):
        raise ValueError("append kernel: scales go with int8 pages only")
    err = _build.library().tf_paged_append(
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        slots.data_ptr(), lengths.data_ptr(), page_tables.data_ptr(),
        b, kvh, d, page, total, page_tables.shape[1],
        kernels.dtype_code(k_new.dtype), kernels.dtype_code(k_pages.dtype),
        kernels.stream_handle(k_new),
    )
    _build.check(err, "tf_paged_append")
    kernels.LAUNCHES["paged_append"] += 1


def fused_append(cache, slots: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """One-token-per-slot append (B3), in place. k, v: ``(B, kv_heads, d)``;
    slots ``(B,)`` int32. Lengths are not advanced (``PagedKVCache.append``
    and ``paged_attention`` do that)."""
    b = slots.shape[0]
    kh, _, _, _ = cache.k_pages.shape
    d = k.shape[-1]
    if k.shape != (b, kh, d) or v.shape != (b, kh, d):
        raise ValueError(f"append expects k/v of shape {(b, kh, d)}, got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    args = (k.contiguous(), v.contiguous(), cache.k_pages, cache.v_pages,
            cache.k_scales, cache.v_scales, slots, cache.lengths,
            cache.page_tables)
    if k.device.type == "cpu":
        _paged_append_plain(*args)
    elif k.device.type == "cuda":
        _paged_append_kernel(*args)
    else:
        raise NotImplementedError(f"no append path for device {k.device}")


# -- B2: decode attention --------------------------------------------------------


def _lane_view(slots, lengths, len_add: int, lengths_override, positions,
               radius):
    """Per-lane visible length and band start, as the kernel computes them:
    ``len = lengths_override`` or ``lengths[slot] + len_add``; ``start =
    max(qpos − radius, 0)`` with ``qpos = positions`` or ``len − 1`` under
    a band, else 0. int64 ``(B,)`` each."""
    if lengths_override is not None:
        lens = lengths_override.long()
    else:
        lens = lengths[slots.long()].long() + len_add
    if radius is None:
        return lens, torch.zeros_like(lens)
    qpos = lens - 1 if positions is None else positions.long()
    return lens, torch.clamp_min(qpos - radius, 0)


def _paged_attention_plain(qg, k_pages, v_pages, k_scales, v_scales, slots,
                           lengths, page_tables, len_add: int,
                           pages_bound: int, out_dtype, want_lse: bool,
                           lengths_override=None, positions=None,
                           radius: Optional[int] = None):
    """Plain PyTorch decode attention.

    qg: ``(B, kvh, G, d)`` bf16, prescaled by scale·log2(e). Lane b sees
    keys ``[start_b, len_b)`` (:func:`_lane_view`), walked page by page
    from page ``start_b // page`` like the kernel (at most ``pages_bound``
    pages; logical pages past the lane's length clamp to its last page and
    are masked). A lane with no visible key gives o = 0, lse = −inf.
    Returns ``(o (B, kvh, G, d) out_dtype, lse (B, kvh, G) f32 | None)``.
    """
    b, kvh, g, d = qg.shape
    page = k_pages.shape[2]
    sl = slots.long()
    lens, start = _lane_view(slots, lengths, len_add, lengths_override,
                             positions, radius)
    tables = page_tables[sl].long()  # (B, maxp)
    n_pages = (lens + page - 1) // page
    start_pg = start // page
    steps = n_pages - start_pg  # pages each lane walks (≤ 0: none)
    last = torch.clamp(torch.clamp_min(n_pages, 1) - 1,
                       max=tables.shape[1] - 1)
    quantized = k_scales is not None
    q = qg.float()
    m = torch.full((b, kvh, g), DEFAULT_MASK_VALUE, device=qg.device)
    l = torch.zeros((b, kvh, g), device=qg.device)
    acc = torch.zeros((b, kvh, g, d), device=qg.device)
    rows = torch.arange(page, device=qg.device)
    n_iter = min(pages_bound, int(steps.max())) if b else 0
    for i in range(n_iter):
        logical = start_pg + i
        phys = tables.gather(1, torch.minimum(logical, last)[:, None])[:, 0]
        kf = k_pages[:, phys].transpose(0, 1).to(qg.dtype).float()
        vf = v_pages[:, phys].transpose(0, 1).to(qg.dtype).float()
        s = torch.einsum("bhgd,bhpd->bhgp", q, kf)
        if quantized:
            s = s * k_scales[:, phys].transpose(0, 1)[:, :, None, :]
        kpos = (logical * page)[:, None] + rows[None, :]  # (B, page)
        seen = (kpos >= start[:, None]) & (kpos < lens[:, None])
        s = torch.where(seen[:, None, None, :], s, DEFAULT_MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s - m_next[..., None])
        l_next = alpha * l + p.sum(dim=-1)
        if quantized:
            p = p * v_scales[:, phys].transpose(0, 1)[:, :, None, :]
        pv = torch.einsum("bhgp,bhpd->bhgd", p.to(qg.dtype).float(), vf)
        acc_next = acc * alpha[..., None] + pv
        # lanes whose pages ran out skip the step, as the kernel does
        step = (i < steps)[:, None, None]
        m = torch.where(step, m_next, m)
        l = torch.where(step, l_next, l)
        acc = torch.where(step[..., None], acc_next, acc)
    valid = (l > 0.0) & (m > DEFAULT_MASK_VALUE * 0.5)
    l_safe = torch.where(l > 0.0, l, 1.0)
    o = (acc * torch.where(valid, 1.0 / l_safe, 0.0)[..., None]).to(out_dtype)
    lse = None
    if want_lse:
        lse = torch.where(valid, m * LN2 + torch.log(l_safe), float("-inf"))
    return o, lse


def _paged_attention_kernel(qg, k_pages, v_pages, k_scales, v_scales, slots,
                            lengths, page_tables, len_add: int,
                            pages_bound: int, out_dtype, want_lse: bool,
                            lengths_override=None, positions=None,
                            radius: Optional[int] = None):
    """Launch ``csrc/paged_attention.cu`` (same contract as the plain
    version; the kernel computes each lane's view itself)."""
    from tpu_flash_torch.kernels import _build

    b, kvh, g, d = qg.shape
    _, total, page, stor = k_pages.shape
    quantized = k_scales is not None
    lanes = tuple(t for t in (lengths_override, positions) if t is not None)
    _check_cuda("paged_attention", slots, lengths, page_tables, qg, k_pages,
                v_pages, *((k_scales, v_scales) if quantized else ()), *lanes)
    if any(t.dtype != torch.int32 or t.shape != (b,) for t in lanes):
        raise ValueError("paged kernel: lengths_override and positions must "
                         f"be int32 of shape ({b},)")
    if qg.dtype != torch.bfloat16:
        raise ValueError("paged kernel: q must be prescaled bf16")
    if stor != d:
        raise ValueError(f"paged kernel: head_dim {d}, storage {stor}")
    _check_head_dim("paged", d)
    if quantized != (k_pages.dtype == torch.int8):
        raise ValueError("paged kernel: scales go with int8 pages only")
    o = torch.empty((b, kvh, g, d), dtype=out_dtype, device=qg.device)
    lse = (torch.empty((b, kvh, g), dtype=torch.float32, device=qg.device)
           if want_lse else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().tf_paged_attention(
        qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        ptr(k_scales), ptr(v_scales), slots.data_ptr(), lengths.data_ptr(),
        ptr(lengths_override), ptr(positions), page_tables.data_ptr(),
        o.data_ptr(), ptr(lse), b, kvh, g, d, page, total,
        page_tables.shape[1], pages_bound, len_add,
        -1 if radius is None else radius, kernels.dtype_code(k_pages.dtype),
        kernels.dtype_code(out_dtype), kernels.stream_handle(qg),
    )
    _build.check(err, "tf_paged_attention")
    kernels.LAUNCHES["paged_attention"] += 1
    return o, lse


def _check_head_dim(name: str, d: int) -> None:
    """B2 and B3 take any head dim that is a multiple of 8 up to 256."""
    if d > 256:
        raise NotImplementedError(
            f"{name} kernel takes head dims up to 256, got {d} (ROADMAP A15)")
    if d % 8:
        raise NotImplementedError(
            f"{name} kernel takes head dims that are multiples of 8, got {d}")


def _check_cuda(name: str, slots, lengths, page_tables, *ts) -> None:
    """Every tensor contiguous on one CUDA device; index tensors int32."""
    dev = slots.device
    for t in (slots, lengths, page_tables, *ts):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} kernel: every tensor must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: tensors must be contiguous")
    for t in (slots, lengths, page_tables):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} kernel: slots, lengths and page tables "
                             f"must be int32, got {t.dtype}")


def paged_attention(
    q: torch.Tensor,
    cache,
    slots: torch.Tensor,
    *,
    new_kv=None,
    radius: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    lengths_override: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    pages_bound: Optional[int] = None,
    return_lse: bool = False,
    shared_page_table: bool = False,
):
    """Decode attention over the paged cache, optionally appending the new
    token first.

    q: ``(B, q_heads, head_dim)``; slots: ``(B,)`` int32 slot ids.
    ``new_kv=(k, v)``, each ``(B, kv_heads, head_dim)``: the new token's
    K/V are quantized and written into each slot's tail page (B3) before
    the attention (B2) reads it, and lengths advance by one per lane; the
    call then returns ``(out, cache)`` (or ``(out, lse, cache)``) with the
    cache updated in place. Without it the K/V must already be appended and
    the call returns ``out`` (or ``(out, lse)``). lse is in natural-log
    units; a lane with no visible key gives o = 0, lse = −inf.

    ``radius``: sliding-window band — the query at ``qpos`` sees keys from
    ``max(qpos − radius, 0)``, and the page walk starts there, so at most
    ``cdiv(radius + 1, page) + 1`` pages are walked. ``positions``
    (``(B,)`` int32): per-lane query positions for the band start (chunked
    prefill rides the chunk's tokens on the lanes); default ``lengths −
    1``. ``lengths_override`` (``(B,)`` int32): per-lane visible key
    counts instead of the slot lengths. ``shared_page_table``: every lane
    addresses the same slot (checked on the host). ``lengths_override`` and
    ``shared_page_table`` need pre-appended K/V (no ``new_kv``).
    ``pages_bound`` caps the pages walked (default: the cache's
    max_pages_per_seq).
    """
    cfg = cache.config
    b, qh, d = q.shape
    if d != cfg.head_dim:
        raise ValueError(f"head_dim mismatch: {d} vs {cfg.head_dim}")
    kvh = cache.k_pages.shape[0]
    if qh % kvh:
        raise ValueError(f"q_heads {qh} not a multiple of kv_heads {kvh}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    num_steps = pages_bound or cfg.max_pages_per_seq
    if radius is not None:
        # the band spans ≤ radius + 1 tokens → at most this many pages
        num_steps = min(num_steps, cdiv(radius + 1, cfg.page_size) + 1)
    append = new_kv is not None
    if append and lengths_override is not None:
        raise ValueError("lengths_override requires pre-appended K/V")
    if shared_page_table:
        if append:
            raise ValueError("shared_page_table requires pre-appended K/V")
        if b and not bool((slots == slots[:1]).all()):
            raise ValueError("shared_page_table: every lane must address "
                             "the same slot")
    if append:
        fused_append(cache, slots, *new_kv)
    qg = (q.float() * (scale * LOG2E)).to(torch.bfloat16)
    qg = qg.reshape(b, kvh, qh // kvh, d)
    args = (qg, cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
            slots, cache.lengths, cache.page_tables, int(append), num_steps,
            q.dtype, return_lse)
    def lanes(t):
        return None if t is None else t.to(torch.int32)

    lane_kw = dict(lengths_override=lanes(lengths_override),
                   positions=None if radius is None else lanes(positions),
                   radius=radius)
    if q.device.type == "cpu":
        o, lse = _paged_attention_plain(*args, **lane_kw)
    elif q.device.type == "cuda":
        o, lse = _paged_attention_kernel(*args, **lane_kw)
    else:
        raise NotImplementedError(f"no paged attention path for {q.device}")
    o = o.reshape(b, qh, d)
    out = (o,) if lse is None else (o, lse.reshape(b, qh))
    if append:
        cache.lengths.index_add_(
            0, slots.long(), torch.ones_like(slots, dtype=cache.lengths.dtype))
        return (*out, cache)
    return out if return_lse else o


def paged_attention_pipelined(
    q: torch.Tensor,
    cache,
    slots: torch.Tensor,
    *,
    new_kv=None,
    radius: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    chunk_pages: int = 4,
    return_lse: bool = False,
    rank1_append: bool = False,
):
    """The reference's hand-pipelined decode (``_pipe_kernel``), the same
    function as :func:`paged_attention` minus ``pages_bound``: each lane
    walks exactly its own ⌈visible/page⌉ pages from its band start.

    On the card that is B2 with the walk left uncapped, and the append is
    split (B3, then B2), as the reference's default is. ``rank1_append``
    (the reference's in-register rank-1 update of the new token, which its
    TPU path runs only in interpret mode) computes the same function; here
    it takes the same split path. ``chunk_pages`` is the TPU's DMA chunk
    and changes nothing here; it must be a positive int. The reference's
    limit on VMEM-resident scale bytes is TPU scaffolding and is not
    ported.
    """
    if not isinstance(chunk_pages, int) or chunk_pages < 1:
        raise ValueError(f"chunk_pages must be a positive int, got "
                         f"{chunk_pages!r}")
    return paged_attention(
        q, cache, slots, new_kv=new_kv, radius=radius, positions=positions,
        scale=scale, pages_bound=cache.config.max_pages_per_seq,
        return_lse=return_lse)
