"""Paged decode attention (B2) and the one-token append (B3): port of
``paged_attention``, ``paged_attention_pipelined``, ``fused_append`` and
``_encode_row`` from ``tpu_flash/ops/paged.py``.

One query token per lane attends its slot's pages, walking the page table
page by page with an online base-2 softmax. q is cast to bf16 whatever the
model dtype, and so are the K/V pages before the dots (int4 codes unpacked
and e4m3 codes decoded first, both exactly); quantized pages (int8, int4,
fp8) fold their per-token K scale into the score column and their V scale
into P. Every function here takes the page type (``CacheConfig.page_type``)
explicitly: an int4 page is an int8 tensor of width d/2.

On the card B2 has two routes (:func:`paged_route`, from static shapes
alone): ``split`` walks each lane's pages in splits of at most
:func:`split_plan` pages, one CTA a (split, kv head, lane), and combines the
splits' partials in split order; ``shared`` takes the chunk prefix
(``shared_page_table`` at page 64) as 64-row q tiles on the tensor cores.
The reference fuses the new token's quantize+append into the attention
pass, and so does the split route: ``paged_attention(new_kv=...)`` is one
launch that writes the new row and attends it. The q prescale is folded
into the kernels' q load.

The reference's pipelined decode kernel (B12, ``_pipe_kernel``) walks
each lane's own pages with a hand-pipelined DMA loop; on the card that is
B2 with an uncapped walk and the fused append, so B12 folds into it.

Each wrapper dispatches on the tensors' device: CPU tensors take the plain
PyTorch version (one split), CUDA tensors launch ``csrc/paged_attention.cu``
or ``csrc/paged_append.cu``, or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.cache.paged_cache import (
    PAGE_TYPES,
    decode,
    encode,
    storage_width,
)
from tpu_flash_torch.ops.flash import DEFAULT_MASK_VALUE, LN2, LOG2E
from tpu_flash_torch.ops.schedule import cdiv


# -- B3: append ---------------------------------------------------------------


def _paged_append_plain(k_new, v_new, k_pages, v_pages, k_scales, v_scales,
                        slots, lengths, page_tables, *, page_type: str):
    """Write row ``lengths[slot] % page`` of page
    ``page_tables[slot, lengths[slot] // page]`` for every lane, in place,
    encoded as the cache's writes encode (``paged_cache.encode``: the
    reference's ``_encode_row``). Lengths are read, not advanced."""
    page = k_pages.shape[2]
    sl = slots.long()
    pos = lengths[sl].long()
    tpage = torch.clamp(pos // page, max=page_tables.shape[1] - 1)
    phys = page_tables[sl, tpage].long()
    off = pos % page
    for new, pages, scales in ((k_new, k_pages, k_scales),
                               (v_new, v_pages, v_scales)):
        vals, sc = encode(new.float(), page_type)  # (B, kvh, stor)
        pages[:, phys, off] = vals.transpose(0, 1)
        if sc is not None:
            scales[:, phys, off] = sc.transpose(0, 1)


def _paged_append_kernel(k_new, v_new, k_pages, v_pages, k_scales, v_scales,
                         slots, lengths, page_tables, *, page_type: str):
    """Launch ``csrc/paged_append.cu`` (same contract as the plain version)."""
    from tpu_flash_torch.kernels import _build

    b, kvh, d = k_new.shape
    _, total, page, _ = k_pages.shape
    quantized = k_scales is not None
    _check_cuda("paged_append", slots, lengths, page_tables, k_new, v_new,
                k_pages, v_pages, *((k_scales, v_scales) if quantized else ()))
    if k_new.dtype not in (torch.bfloat16, torch.float32) or (
            v_new.dtype != k_new.dtype):
        raise NotImplementedError(f"append kernel: new K/V dtype {k_new.dtype}")
    _check_head_dim("append", d, page_type)
    _check_pages("append", page_type, d, k_pages, v_pages, quantized)
    err = _build.library().tf_paged_append(
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        slots.data_ptr(), lengths.data_ptr(), page_tables.data_ptr(),
        b, kvh, d, page, total, page_tables.shape[1],
        kernels.dtype_code(k_new.dtype), kernels.PAGE_CODES[page_type],
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
    page_type = cache.config.page_type
    if k.device.type == "cpu":
        _paged_append_plain(*args, page_type=page_type)
    elif k.device.type == "cuda":
        _paged_append_kernel(*args, page_type=page_type)
    else:
        raise NotImplementedError(f"no append path for device {k.device}")


# -- B2: decode attention --------------------------------------------------------

# SMs of an H100 SXM: the split plan aims at several CTAs an SM
_SMS = 132
# pages a split walks at most (all in flight at once): at the serving
# decode (16 lanes × 8 heads × 16 pages, d 128) 3 pages a split beat 2 and
# 4 on int8, int4 and fp8 pages alike (PERF.md §6);
# and the K/V page bytes (in the cache's storage) a split CTA may have in
# flight: with its scores and sums that keeps three CTAs an SM at d 128
_MAX_SPLIT_PAGES = 3
_SPLIT_BYTES = 57344
_SHARED_PAGE = 64
# B2's routes, in the order of their codes in csrc/paged_attention.cu
ROUTES = ("split", "shared")


def paged_route(page: int, shared_page_table: bool) -> str:
    """B2's route on the card, from static shapes alone: ``shared`` for
    the shared page table (the chunk prefix) at page 64, a tensor-core q
    tile over the prefix; ``split`` for every other call (any head dim,
    group, page size and cache dtype the kernels take)."""
    if shared_page_table and page == _SHARED_PAGE:
        return "shared"
    return "split"


def row_bytes(page_type: str, d: int) -> int:
    """Bytes of one K (or V) row of d values in the cache, and of its
    scale: float32 4d, bf16 2d, int8 and fp8 d + 4, int4 d/2 + 4."""
    dtype, quantized = PAGE_TYPES[page_type]
    return (storage_width(page_type, d) * dtype.itemsize
            + (4 if quantized else 0))


def split_plan(b: int, kvh: int, d: int, page: int, page_type: str,
               pages_bound: int) -> int:
    """Pages a split walks on the card (``S``), from static shapes only:
    enough splits that ``b·kvh`` (lane, head) walks of up to
    ``pages_bound`` pages make about 4 CTAs an SM, at most 3 pages, and at
    most 56 KB of K/V pages (and scale rows, :func:`row_bytes`) a CTA:
    at d 128, int8, int4 and fp8 pages take 3, bf16 1. The plain version
    takes the same plan to round where the kernel does; the launch refuses
    a plan whose stages do not fit in shared memory (one page always does
    but at d above 256 on bf16 and float32 pages of 128 rows: a K and V
    page pair of 128 × 512 bf16 is 256 KB; at page 64 it is 128 KB)."""
    page_bytes = 2 * page * row_bytes(page_type, d)
    want = -(-b * kvh * pages_bound // (4 * _SMS))
    return max(1, min(want, _MAX_SPLIT_PAGES, _SPLIT_BYTES // page_bytes))


def plan_pages(cfg, radius: Optional[int] = None) -> int:
    """The walk :func:`paged_attention` sizes its split plan for: the
    cache's ``max_pages_per_seq``, or the band's pages under ``radius``. A
    static shape, never the caller's ``pages_bound``: two calls whose caps
    both cover a lane's walk then split it alike and round alike (an
    engine's one-token step and a K-step round issued at a larger bucket
    give the same bits)."""
    pages = cfg.max_pages_per_seq
    if radius is not None:
        # the band spans ≤ radius + 1 tokens → at most this many pages
        pages = min(pages, cdiv(radius + 1, cfg.page_size) + 1)
    return pages


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
                           radius: Optional[int] = None,
                           split_pages: Optional[int] = None, *,
                           page_type: str):
    """Plain PyTorch decode attention.

    qg: ``(B, kvh, G, d)`` bf16, prescaled by scale·log2(e); the pages are
    of ``page_type`` (``CacheConfig.page_type``). Lane b sees
    keys ``[start_b, len_b)`` (:func:`_lane_view`), walked page by page
    from page ``start_b // page`` like the kernel (at most ``pages_bound``
    pages; logical pages past the lane's length clamp to its last page and
    are masked). ``split_pages``: the card's plan (:func:`split_plan`) —
    the walk is cut into splits of that many pages, each with its own
    online softmax from scratch (P rounds against the split's running
    max), and the splits' (m, l, acc) combine in split order as the split
    kernel combines them; ``None`` is one split, the reference's walk. A
    lane with no visible key gives o = 0, lse = −inf. Returns
    ``(o (B, kvh, G, d) out_dtype, lse (B, kvh, G) f32 | None)``.
    """
    b, kvh, g, d = qg.shape
    page = k_pages.shape[2]
    sl = slots.long()
    lens, start = _lane_view(slots, lengths, len_add, lengths_override,
                             positions, radius)
    tables = page_tables[sl].long()  # (B, maxp)
    n_pages = (lens + page - 1) // page
    start_pg = start // page
    # pages each lane walks
    n_walk = torch.clamp(n_pages - start_pg, 0, pages_bound)
    last = torch.clamp(torch.clamp_min(n_pages, 1) - 1,
                       max=tables.shape[1] - 1)
    quantized = k_scales is not None
    q = qg.float()
    rows = torch.arange(page, device=qg.device)
    per = pages_bound if split_pages is None else split_pages
    most = int(n_walk.max()) if b else 0
    parts = []
    for first in range(0, min(pages_bound, max(most, 1)), per):
        m = torch.full((b, kvh, g), DEFAULT_MASK_VALUE, device=qg.device)
        l = torch.zeros((b, kvh, g), device=qg.device)
        acc = torch.zeros((b, kvh, g, d), device=qg.device)
        for i in range(first, min(first + per, most)):
            logical = start_pg + i
            phys = tables.gather(1, torch.minimum(logical, last)[:, None])[:, 0]
            # int4 unpacked, e4m3 decoded, before the cast to q's dtype
            kf = decode(k_pages[:, phys], page_type).transpose(0, 1).to(
                qg.dtype).float()
            vf = decode(v_pages[:, phys], page_type).transpose(0, 1).to(
                qg.dtype).float()
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
            step = (i < n_walk)[:, None, None]
            m = torch.where(step, m_next, m)
            l = torch.where(step, l_next, l)
            acc = torch.where(step[..., None], acc_next, acc)
        parts.append((first, m, l, acc))
    if len(parts) == 1:
        _, m, l, acc = parts[0]
    else:
        # the splits that walked a page, combined in split order
        live = [(first < n_walk)[:, None, None] for first, *_ in parts]
        m = torch.full((b, kvh, g), DEFAULT_MASK_VALUE, device=qg.device)
        for on, (_, ms, _, _) in zip(live, parts):
            m = torch.where(on, torch.maximum(m, ms), m)
        l = torch.zeros((b, kvh, g), device=qg.device)
        acc = torch.zeros((b, kvh, g, d), device=qg.device)
        for on, (_, ms, ls, accs) in zip(live, parts):
            w = torch.where(on, torch.exp2(ms - m), 0.0)
            l = l + ls * w
            acc = acc + accs * w[..., None]
    valid = (l > 0.0) & (m > DEFAULT_MASK_VALUE * 0.5)
    l_safe = torch.where(l > 0.0, l, 1.0)
    o = (acc * torch.where(valid, 1.0 / l_safe, 0.0)[..., None]).to(out_dtype)
    lse = None
    if want_lse:
        lse = torch.where(valid, m * LN2 + torch.log(l_safe), float("-inf"))
    return o, lse


def _paged_attention_kernel(q, k_pages, v_pages, k_scales, v_scales, slots,
                            lengths, page_tables, len_add: int,
                            pages_bound: int, out_dtype, want_lse: bool,
                            lengths_override=None, positions=None,
                            radius: Optional[int] = None, *, new_kv=None,
                            q_scale: float = 1.0,
                            shared_page_table: bool = False,
                            walk: int, page_type: str):
    """Launch ``csrc/paged_attention.cu`` (the plain version's contract;
    the kernel computes each lane's view itself).

    q: ``(B, kvh, G, d)`` float32 or bf16; the kernel rounds ``q·q_scale``
    to bf16 as it loads it (``q_scale`` 1 for a prescaled bf16 q).
    ``new_kv=(k, v)`` (``(B, kvh, d)`` each): the split route's fused
    append writes them into each slot's tail page before they are
    attended (pass ``len_add`` 1). The route is :func:`paged_route`'s and
    the split plan :func:`split_plan`'s for a walk of ``walk`` pages, the
    cache's :func:`plan_pages`. Returns ``(o, lse | None)``; the cache's
    lengths are not advanced."""
    from tpu_flash_torch.kernels import _build

    b, kvh, g, d = q.shape
    _, total, page, _ = k_pages.shape
    quantized = k_scales is not None
    lanes = tuple(t for t in (lengths_override, positions) if t is not None)
    news = tuple(new_kv) if new_kv is not None else ()
    _check_cuda("paged_attention", slots, lengths, page_tables, q, k_pages,
                v_pages, *((k_scales, v_scales) if quantized else ()), *lanes,
                *news)
    if any(t.dtype != torch.int32 or t.shape != (b,) for t in lanes):
        raise ValueError("paged kernel: lengths_override and positions must "
                         f"be int32 of shape ({b},)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged kernel: q must be bf16 or float32, got {q.dtype}")
    _check_head_dim("paged", d, page_type)
    _check_pages("paged", page_type, d, k_pages, v_pages, quantized)
    if news and (news[0].shape != (b, kvh, d) or news[1].shape != (b, kvh, d)
                 or news[0].dtype not in (torch.bfloat16, torch.float32)
                 or news[1].dtype != news[0].dtype):
        raise ValueError(f"paged kernel: new K/V must be ({b}, {kvh}, {d}) "
                         "bf16 or float32")
    route = paged_route(page, shared_page_table)
    if news and route == "shared":
        raise ValueError("paged kernel: the shared route takes no append")
    split_pages, n_splits, ws_ptrs = 1, 1, (None,) * 3
    if route == "split":
        split_pages = split_plan(b, kvh, d, page, page_type, walk)
        n_splits = -(-pages_bound // split_pages)
    if n_splits > 1:
        # the splits' partials (acc, then m and l) and the (lane, head)
        # tickets, from the caching allocator on the call's stream; the
        # launch zeroes the tickets first
        parts = b * kvh * n_splits * g
        ws = torch.empty(parts * (d + 2) + b * kvh, dtype=torch.float32,
                         device=q.device)
        base = ws.data_ptr()
        ws_ptrs = (base, base + 4 * parts * d, base + 4 * parts * (d + 2))
    o = torch.empty((b, kvh, g, d), dtype=out_dtype, device=q.device)
    lse = (torch.empty((b, kvh, g), dtype=torch.float32, device=q.device)
           if want_lse else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().tf_paged_attention(
        q.data_ptr(), *(ptr(t) for t in (news or (None, None))),
        k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scales), ptr(v_scales),
        slots.data_ptr(), lengths.data_ptr(), ptr(lengths_override),
        ptr(positions), page_tables.data_ptr(), o.data_ptr(), ptr(lse),
        *ws_ptrs, b, kvh, g, d, page, total, page_tables.shape[1],
        pages_bound, len_add,
        -1 if radius is None else radius, kernels.dtype_code(q.dtype),
        kernels.dtype_code(news[0].dtype) if news else 0,
        kernels.PAGE_CODES[page_type], kernels.dtype_code(out_dtype),
        ROUTES.index(route), split_pages, n_splits, q_scale,
        kernels.stream_handle(q),
    )
    _build.check(err, f"tf_paged_attention ({route})")
    kernels.LAUNCHES[f"paged_attention_{route}"] += 1
    if news:
        kernels.LAUNCHES["paged_append_fused"] += 1
    return o, lse


def _check_head_dim(name: str, d: int, page_type: str) -> None:
    """B2 and B3 take any head dim from 8 to 512, an even one on int4
    pages (two codes a byte); wider heads raise (ROADMAP A15c)."""
    if d > 512:
        raise NotImplementedError(
            f"{name} kernel takes head dims up to 512, got {d} (ROADMAP A15c)")
    if d < 8:
        raise NotImplementedError(
            f"{name} kernel takes head dims from 8, got {d}")
    if page_type == "int4" and d % 2:
        raise NotImplementedError(
            f"{name} kernel takes even head dims on int4 pages, got {d}")


def _check_pages(name: str, page_type: str, d: int, k_pages, v_pages,
                 quantized: bool) -> None:
    """The pages are of ``page_type`` at head dim d, with scales exactly
    when the type is quantized."""
    dtype, scaled = PAGE_TYPES[page_type]
    width = storage_width(page_type, d)
    for t in (k_pages, v_pages):
        if t.dtype != dtype or t.shape[-1] != width:
            raise ValueError(
                f"{name} kernel: {page_type} pages at head_dim {d} are "
                f"{dtype} of width {width}, got {t.dtype} of width "
                f"{t.shape[-1]}")
    if quantized != scaled:
        raise ValueError(f"{name} kernel: scales go with quantized pages")


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
    _shared_slot: Optional[int] = None,
):
    """Decode attention over the paged cache, optionally appending the new
    token first.

    q: ``(B, q_heads, head_dim)``; slots: ``(B,)`` int32 slot ids.
    ``new_kv=(k, v)``, each ``(B, kv_heads, head_dim)``: the new token's
    K/V are quantized and written into each slot's tail page before the
    attention reads them (on the card one fused launch), and lengths
    advance by one per lane; the call then returns ``(out, cache)`` (or
    ``(out, lse, cache)``) with the cache updated in place. Without it the
    K/V must already be appended and the call returns ``out`` (or ``(out,
    lse)``). lse is in natural-log units; a lane with no visible key gives
    o = 0, lse = −inf.

    ``radius``: sliding-window band — the query at ``qpos`` sees keys from
    ``max(qpos − radius, 0)``, and the page walk starts there, so at most
    ``cdiv(radius + 1, page) + 1`` pages are walked. ``positions``
    (``(B,)`` int32): per-lane query positions for the band start (chunked
    prefill rides the chunk's tokens on the lanes); default ``lengths −
    1``. ``lengths_override`` (``(B,)`` int32): per-lane visible key
    counts instead of the slot lengths. ``shared_page_table``: every lane
    addresses the same slot (checked on the host, which waits for the
    device; ``_shared_slot``, the slot as a Python int from a caller that
    made ``slots`` itself, skips the check). ``lengths_override`` and
    ``shared_page_table`` need pre-appended K/V (no ``new_kv``).
    ``pages_bound`` caps the pages walked (default: the cache's
    max_pages_per_seq); the card's split plan does not follow it
    (:func:`plan_pages`).
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
    walk = plan_pages(cfg, radius)
    num_steps = min(pages_bound, walk) if pages_bound else walk
    append = new_kv is not None
    if append and lengths_override is not None:
        raise ValueError("lengths_override requires pre-appended K/V")
    if shared_page_table:
        if append:
            raise ValueError("shared_page_table requires pre-appended K/V")
        if (_shared_slot is None and b
                and not bool((slots == slots[:1]).all())):
            raise ValueError("shared_page_table: every lane must address "
                             "the same slot")

    def lanes(t):
        return None if t is None else t.to(torch.int32)

    lane_kw = dict(lengths_override=lanes(lengths_override),
                   positions=None if radius is None else lanes(positions),
                   radius=radius)
    g = qh // kvh
    page_type = cfg.page_type
    if q.device.type == "cpu":
        if append:
            fused_append(cache, slots, *new_kv)
        qg = (q.float() * (scale * LOG2E)).to(torch.bfloat16)
        o, lse = _paged_attention_plain(
            qg.reshape(b, kvh, g, d), cache.k_pages, cache.v_pages,
            cache.k_scales, cache.v_scales, slots, cache.lengths,
            cache.page_tables, int(append), num_steps, q.dtype, return_lse,
            **lane_kw, page_type=page_type)
    elif q.device.type == "cuda":
        news = tuple(t.contiguous() for t in new_kv) if append else None
        o, lse = _paged_attention_kernel(
            q.contiguous().reshape(b, kvh, g, d), cache.k_pages,
            cache.v_pages, cache.k_scales, cache.v_scales, slots,
            cache.lengths, cache.page_tables, int(append), num_steps,
            q.dtype, return_lse, **lane_kw, new_kv=news,
            q_scale=scale * LOG2E, shared_page_table=shared_page_table,
            walk=walk, page_type=page_type)
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

    On the card that is B2's split route with the walk left uncapped and
    the append fused, as the reference's default is. ``rank1_append``
    (the reference's in-register rank-1 update of the new token, which its
    TPU path runs only in interpret mode) computes the same function; here
    it takes the same path. ``chunk_pages`` is the TPU's DMA chunk and
    changes nothing here; it must be a positive int. The reference's limit
    on VMEM-resident scale bytes is TPU scaffolding and is not ported.
    """
    if not isinstance(chunk_pages, int) or chunk_pages < 1:
        raise ValueError(f"chunk_pages must be a positive int, got "
                         f"{chunk_pages!r}")
    return paged_attention(
        q, cache, slots, new_kv=new_kv, radius=radius, positions=positions,
        scale=scale, pages_bound=cache.config.max_pages_per_seq,
        return_lse=return_lse)
