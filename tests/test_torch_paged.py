"""Port parity: int8 quantizer, paged cache writes, the append (B3) and the
paged decode attention (B2) on every page type (float32, bf16, int8, int4,
fp8), plus the page allocator binding.

Inputs are made from a seed with numpy and go through the reference (Pallas
in interpret mode on the CPU) and through the port's plain path. Quantized
pages and scales must match bit for bit: the quantizer is float32 math with
an IEEE divide and round-half-to-even on both sides.

One deviation of the reference's kernels, held explicitly: their fp8 merge
of the new row (``_append_kernel``, and ``_paged_kernel``'s fused append)
decodes the whole target page through ``_fp8_upcast``, which maps e4m3
zeros and subnormals to other values, and re-encodes it: those codes of
the target page change. The port leaves them as they were.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.allocator import PageAllocator as JPageAllocator
from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.ops import paged as jpaged
from tpu_flash.quant import flash_q as jfq
from tpu_flash.quant import qarray as jq
from tpu_flash_torch.cache.allocator import PageAllocator
from tpu_flash_torch.ops import paged as tpaged
from tpu_flash_torch.ops.oracle import dense_dpa
from tpu_flash_torch.quant import qarray as tq
from tpu_flash_torch.utils.convert import cache_from_reference, to_numpy, to_torch

torch.set_num_threads(2)

KVH, D, PAGE, TOTAL, MAX_SEQS, MAXP = 2, 64, 16, 64, 4, 16


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _make_cache(dtype):
    cfg = JCacheConfig(num_kv_heads=KVH, head_dim=D, page_size=PAGE,
                       total_pages=TOTAL, max_seqs=MAX_SEQS,
                       max_pages_per_seq=MAXP, dtype=dtype)
    # slot s owns pages [1 + s·MAXP … ) mod TOTAL, never the trash page 0
    tables = 1 + np.arange(MAX_SEQS * MAXP).reshape(MAX_SEQS, MAXP) % (TOTAL - 1)
    return JPagedKVCache.create(cfg).assign_pages(jnp.asarray(tables, jnp.int32))


def _bits(a) -> np.ndarray:
    """A port tensor or a reference array as numpy, fp8 as its bytes
    (numpy has no fp8 type), bf16 as float32 (exact)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return to_numpy(a) if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _fp8_merged(codes: np.ndarray, phys) -> np.ndarray:
    """What the reference's fp8 append makes of its target pages ``phys``
    of ``codes`` ((kvh, total, page, d) e4m3): each code decoded by its
    ``_fp8_upcast`` and encoded again; other pages as they are."""
    out = np.array(codes)
    ids = sorted(set(int(p) for p in phys))
    out[:, ids] = np.asarray(jfq._fp8_upcast(jnp.asarray(codes[:, ids])).astype(
        jnp.float32).astype(jnp.float8_e4m3fn))
    return out


def _codes(pages: np.ndarray, dtype: str) -> np.ndarray:
    """int codes of quantized pages, one an element: int4 unpacked; e4m3
    as sign and magnitude bits (adjacent magnitudes are adjacent codes)."""
    if dtype == "int4":
        return np.asarray(jq.unpack_int4_halves(jnp.asarray(pages)), np.int32)
    if dtype == "fp8":
        b = _bits(pages).astype(np.int32)
        return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)
    return pages.astype(np.int32)


def _assert_kernel_rows(got_pages, got_scales, want_pages, want_scales,
                        dtype, name):
    """The reference kernel's quantized rows against the eager encode: its
    scales within 1 ulp (under jit, XLA's CPU backend divides by qmax as a
    multiply by the reciprocal); codes equal in the rows whose scale is
    equal, and at most one step apart in the rows whose scale is 1 ulp off
    (x / scale moved across a rounding boundary)."""
    np.testing.assert_array_max_ulp(got_scales, want_scales, maxulp=1)
    same = got_scales == want_scales
    g, w = _codes(got_pages, dtype), _codes(want_pages, dtype)
    np.testing.assert_array_equal(g[same], w[same], err_msg=name)
    assert np.abs(g[~same] - w[~same]).max(initial=0) <= 1, name


def _assert_cache_equal(tc, jc, kernel_targets=None):
    """Pages, scales and lengths bit-identical. ``kernel_targets``: the
    physical pages the reference's kernel appended to, on an int4 or fp8
    cache; its rows are held as :func:`_assert_kernel_rows` has them, and
    for fp8 its pages as :func:`_fp8_merged` of the port's."""
    dtype = tc.config.dtype
    if kernel_targets is not None:
        for kind in ("k", "v"):
            t = getattr(tc, f"{kind}_pages")
            want = (_fp8_merged(t.view(torch.uint8).numpy().view(
                jnp.float8_e4m3fn), kernel_targets) if dtype == "fp8"
                else t.numpy())
            _assert_kernel_rows(np.asarray(getattr(jc, f"{kind}_pages")),
                                np.asarray(getattr(jc, f"{kind}_scales")),
                                want, getattr(tc, f"{kind}_scales").numpy(),
                                dtype, kind)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        return
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert (j is None) == (t is None), name
        if t is not None:
            tn = _bits(t)
            np.testing.assert_array_equal(tn, _bits(j).astype(tn.dtype),
                                          err_msg=name)


def test_quantize_bit_exact():
    """int8 values and scales identical to qarray.quantize, including a zero
    row (the 1e-12 floor) and exact .5 ties (round half to even)."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 6, 5, 64) * np.array([1e-3, 1, 30, 1e4, 1, 1],
                                        np.float32)[:, None, None]
    x[4] = 0.0
    x[5, :, 0] = 127.0  # scale exactly 1.0
    x[5, :, 1:9] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 126.5, -2.5])
    ja = jq.quantize(jnp.asarray(x), jnp.int8, axis=-1)
    ta = tq.quantize(torch.as_tensor(x), torch.int8, axis=-1)
    np.testing.assert_array_equal(ta.values.numpy(), np.asarray(ja.values))
    np.testing.assert_array_equal(ta.scales.numpy(), np.asarray(ja.scales))
    np.testing.assert_array_equal(tq.dequantize(ta).numpy(),
                                  np.asarray(jq.dequantize(ja)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "fp8"])
def test_write_prompt_and_gather_bit_exact(dtype):
    """write_prompt (ragged 50 tokens → padded tail) and gather_kv."""
    rng = np.random.default_rng(1)
    k, v = _rand(rng, KVH, 50, D), _rand(rng, KVH, 50, D)
    jc = _make_cache(dtype)
    tc = cache_from_reference(jc, device="cpu")
    jc = jc.write_prompt(1, jnp.asarray(k), jnp.asarray(v))
    tc.write_prompt(1, torch.as_tensor(k), torch.as_tensor(v))
    _assert_cache_equal(tc, jc)
    jk, jv = jc.gather_kv(1, 50)
    tk, tv = tc.gather_kv(1, 50)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _seeded_caches(dtype, lens, rng):
    jc = _make_cache(dtype)
    for s, n in enumerate(lens):
        jc = jc.write_prompt(s, jnp.asarray(_rand(rng, KVH, n, D)),
                             jnp.asarray(_rand(rng, KVH, n, D)))
    return jc, cache_from_reference(jc, device="cpu")


@pytest.mark.parametrize("dtype,new_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("int8", "float32"),
    ("int8", "bfloat16"), ("int4", "float32"), ("int4", "bfloat16"),
    ("fp8", "float32"), ("fp8", "bfloat16")])
def test_append_bit_exact(dtype, new_dtype):
    """B3 plain vs the reference: rows at page boundaries (len 16, 31) and
    mid-page.

    The port must equal, bit for bit, the reference cache with each new row
    encoded by the reference's own quantizer (``PagedKVCache._encode``, run
    eagerly: an IEEE divide). The reference's append kernel must equal the
    same expectation too, except that its scales may sit 1 ulp off: under
    jit, XLA's CPU backend turns ``amax / qmax`` into a multiply by the
    reciprocal (about 4% of rows differ by 1 ulp from the eager quantizer),
    and that its fp8 pages are the expectation through its merge
    (:func:`_fp8_merged` of the written pages).
    """
    rng = np.random.default_rng(2)
    lens = [16, 31, 5]
    jc, tc = _seeded_caches(dtype, lens, rng)
    slots = np.array([0, 1, 2], np.int32)
    k = jnp.asarray(_rand(rng, 3, KVH, D), new_dtype)
    v = jnp.asarray(_rand(rng, 3, KVH, D), new_dtype)
    want = {n: None if getattr(jc, n) is None else np.array(getattr(jc, n))
            for n in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths")}
    tables = np.asarray(jc.page_tables)
    for lane, s in enumerate(slots):
        phys, off = tables[s, lens[s] // PAGE], lens[s] % PAGE
        for new, pg, sc in ((k, "k_pages", "k_scales"), (v, "v_pages", "v_scales")):
            vals, scales = jc._encode(new[lane].astype(jnp.float32))
            want[pg][:, phys, off] = np.asarray(vals)
            if scales is not None:
                want[sc][:, phys, off] = np.asarray(scales)
        want["lengths"][s] += 1
    jc = jc.append(jnp.asarray(slots), k, v)
    tc.append(torch.as_tensor(slots), to_torch(np.asarray(k), device="cpu"),
              to_torch(np.asarray(v), device="cpu"))
    for name, w in want.items():
        t = getattr(tc, name)
        if w is None:
            assert t is None and getattr(jc, name) is None
            continue
        tn = _bits(t)
        np.testing.assert_array_equal(tn, _bits(w).astype(tn.dtype),
                                      err_msg=name)
        jn = np.asarray(getattr(jc, name))
        if name.endswith("scales"):
            np.testing.assert_array_max_ulp(jn, w, maxulp=1)
        elif dtype in ("int4", "fp8") and name.endswith("pages"):
            if dtype == "fp8":
                w = _fp8_merged(w, [tables[s, lens[s] // PAGE] for s in slots])
            sc = name[0] + "_scales"
            _assert_kernel_rows(jn, np.asarray(getattr(jc, sc)), w, want[sc],
                                dtype, name)
        else:
            np.testing.assert_array_equal(jn, w, err_msg=name)


def test_append_trash_lanes_touch_only_the_trash_page():
    """Idle lanes all sit on the trash slot (table row of zeros): they write
    page 0 only, and its length advances once per lane."""
    rng = np.random.default_rng(3)
    _, tc = _seeded_caches("int8", [20, 7, 3], rng)
    trash = MAX_SEQS - 1
    tc.page_tables[trash] = 0
    before = [t.clone() for t in (tc.k_pages, tc.v_pages, tc.k_scales)]
    slots = torch.tensor([0, trash, trash, trash], dtype=torch.int32)
    tc.append(slots, torch.as_tensor(_rand(rng, 4, KVH, D)),
              torch.as_tensor(_rand(rng, 4, KVH, D)))
    assert tc.lengths.tolist() == [21, 7, 3, 3]
    for old, new in zip(before, (tc.k_pages, tc.v_pages, tc.k_scales)):
        changed = (old != new).flatten(2).any(-1).any(0).nonzero().flatten()
        table0 = int(tc.page_tables[0, 20 // PAGE])
        assert set(changed.tolist()) <= {0, table0}


# f32 pages: q, K and V are cast to bf16 on both sides (the reference's
# kernel contract), so only the f32 summation order differs: 1e-4.
# bf16/int8/int4: the reference's MXU-vs-einsum accumulation and P's bf16
# rounding: 2e-2 (int4 codes decode exactly on both sides, as int8's do).
# fp8: 3e-2 against the reference's kernel, its own fp8 tolerance
# (tests/test_paged.py:70-71): it decodes e4m3 subnormals approximately
# where the port decodes them exactly; and 2e-2 against the port's own
# matched oracle (its pages read back by gather_kv, f32 dense attention).
_B2_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2, "int4": 2e-2,
           "fp8": 3e-2}
_B2_ORACLE_TOL = 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "fp8"])
def test_paged_attention_append_matches_reference(dtype):
    """B2 with new_kv (append, then attend), GQA 4, lse, pages_bound; the
    quantized pages also against the matched oracle."""
    rng = np.random.default_rng(4)
    lens = [37, 47, 5]
    jc, tc = _seeded_caches(dtype, lens, rng)
    targets = [np.asarray(jc.page_tables)[s, n // PAGE]
               for s, n in enumerate(lens)]
    slots = np.array([0, 1, 2], np.int32)
    q = _rand(rng, 3, KVH * 4, D)
    kn, vn = _rand(rng, 3, KVH, D), _rand(rng, 3, KVH, D)
    jo, jl, jc = jpaged.paged_attention(
        jnp.asarray(q), jc, jnp.asarray(slots),
        new_kv=(jnp.asarray(kn), jnp.asarray(vn)), pages_bound=4,
        return_lse=True)
    to, tl, tc2 = tpaged.paged_attention(
        torch.as_tensor(q), tc, torch.as_tensor(slots),
        new_kv=(torch.as_tensor(kn), torch.as_tensor(vn)), pages_bound=4,
        return_lse=True)
    assert tc2 is tc
    _assert_cache_equal(tc, jc,
                        targets if dtype in ("int4", "fp8") else None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=_B2_TOL[dtype])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_B2_TOL[dtype])
    if tc.config.quantized:
        # the matched oracle: each lane's pages_bound = 4 pages (64 keys)
        for lane, n in enumerate(lens):
            seen = min(n + 1, 4 * PAGE)
            k, v = tc.gather_kv(lane, seen)
            qs = torch.as_tensor(q[lane])[None, :, None]  # (1, heads, 1, D)
            o, lse = dense_dpa(qs, k[:, None].expand(KVH, 4, seen, D)
                               .reshape(1, KVH * 4, seen, D),
                               v[:, None].expand(KVH, 4, seen, D)
                               .reshape(1, KVH * 4, seen, D),
                               scale=1 / math.sqrt(D))
            np.testing.assert_allclose(to[lane].numpy(), o[0, :, 0].numpy(),
                                       atol=_B2_ORACLE_TOL)
            np.testing.assert_allclose(tl[lane].numpy(), lse[0, :, 0].numpy(),
                                       atol=_B2_ORACLE_TOL)


def test_paged_attention_bf16_queries_without_append():
    """B2 without new_kv on bf16 queries: the output keeps q's dtype; 2e-2
    is one bf16 ulp of the output plus P's bf16 rounding."""
    rng = np.random.default_rng(5)
    jc, tc = _seeded_caches("int8", [33, 16, 1], rng)
    q = jnp.asarray(_rand(rng, 3, KVH * 2, D), jnp.bfloat16)
    slots = np.array([2, 0, 1], np.int32)
    jo = jpaged.paged_attention(q, jc, jnp.asarray(slots))
    to = tpaged.paged_attention(to_torch(np.asarray(q), device="cpu"), tc,
                                torch.as_tensor(slots))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                               atol=2e-2)


@pytest.mark.parametrize("kw", [dict(radius=8), dict(shared_page_table=True),
                                dict(lengths_override=np.array([3], np.int32))])
def test_paged_unported_options_raise(kw):
    """radius, shared_page_table and lengths_override as the reference
    takes them: the reference's o and lse on a 20-token slot (f32 pages:
    1e-4), and its ValueError where the option meets new_kv (the band
    alone has none)."""
    rng = np.random.default_rng(6)
    jc, tc = _seeded_caches("float32", [20], rng)
    q = _rand(rng, 1, KVH, D)
    slots = np.zeros(1, np.int32)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jo, jl = jpaged.paged_attention(jnp.asarray(q), jc, jnp.asarray(slots),
                                    return_lse=True, **jkw)
    to, tl = tpaged.paged_attention(torch.as_tensor(q), tc,
                                    torch.as_tensor(slots), return_lse=True,
                                    **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    if "radius" not in kw:
        new = torch.zeros(1, KVH, D)
        with pytest.raises(ValueError, match="pre-appended"):
            tpaged.paged_attention(torch.as_tensor(q), tc,
                                   torch.as_tensor(slots), new_kv=(new, new),
                                   **tkw)


@pytest.mark.parametrize("force_python", [False, True])
def test_allocator_matches_reference(force_python):
    """Same grants, tables, extends and frees as the reference allocator
    (native pool, or the Python fallback on both sides)."""
    args = dict(total_pages=20, max_seqs=4, max_pages_per_seq=8,
                decode_reserve=2, force_python=force_python)
    ja, ta = JPageAllocator(**args), PageAllocator(**args)
    assert ta.native == ja.native
    script = [("admit", 0, 5), ("admit", 1, 8), ("admit", 2, 9),
              ("extend", 0), ("free_seq", 1), ("admit", 2, 6), ("extend", 2),
              ("admit", 3, 7), ("extend", 3), ("free_seq", 0), ("extend", 3)]
    for op, *a in script:
        assert getattr(ta, op)(*a) == getattr(ja, op)(*a), (op, a)
        assert ta.num_free() == ja.num_free()
        for s in range(4):
            assert ta.num_pages(s) == ja.num_pages(s)
            np.testing.assert_array_equal(ta.table(s), ja.table(s))
