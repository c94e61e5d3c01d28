"""Port parity: int8 quantizer, paged cache writes, the append (B3) and the
paged decode attention (B2), plus the page allocator binding.

Inputs are made from a seed with numpy and go through the reference (Pallas
in interpret mode on the CPU) and through the port's plain path. Quantized
pages and scales must match bit for bit: the quantizer is float32 math with
an IEEE divide and round-half-to-even on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.allocator import PageAllocator as JPageAllocator
from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.ops import paged as jpaged
from tpu_flash.quant import qarray as jq
from tpu_flash_torch.cache.allocator import PageAllocator
from tpu_flash_torch.ops import paged as tpaged
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


def _assert_cache_equal(tc, jc):
    """Pages, scales and lengths bit-identical."""
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert (j is None) == (t is None), name
        if t is not None:
            jn = np.asarray(j)
            tn = to_numpy(t) if t.dtype == torch.bfloat16 else t.numpy()
            np.testing.assert_array_equal(tn, jn.astype(tn.dtype), err_msg=name)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_write_prompt_and_gather_bit_exact(dtype):
    """write_prompt (ragged 50 tokens → padded tail) and gather_kv."""
    rng = np.random.default_rng(1)
    k, v = _rand(rng, KVH, 50, D), _rand(rng, KVH, 50, D)
    jc = _make_cache(dtype)
    tc = cache_from_reference(jc)
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
    return jc, cache_from_reference(jc)


@pytest.mark.parametrize("dtype,new_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("int8", "float32"),
    ("int8", "bfloat16")])
def test_append_bit_exact(dtype, new_dtype):
    """B3 plain vs the reference: rows at page boundaries (len 16, 31) and
    mid-page.

    The port must equal, bit for bit, the reference cache with each new row
    encoded by the reference's own quantizer (``PagedKVCache._encode``, run
    eagerly: an IEEE divide). The reference's append kernel must equal the
    same expectation too, except that its scales may sit 1 ulp off: under
    jit, XLA's CPU backend turns ``amax / 127`` into a multiply by the
    reciprocal (about 4% of rows differ by 1 ulp from the eager quantizer).
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
    tc.append(torch.as_tensor(slots), to_torch(np.asarray(k)),
              to_torch(np.asarray(v)))
    for name, w in want.items():
        t = getattr(tc, name)
        if w is None:
            assert t is None and getattr(jc, name) is None
            continue
        tn = to_numpy(t) if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(tn, w.astype(tn.dtype), err_msg=name)
        jn = np.asarray(getattr(jc, name))
        if name.endswith("scales"):
            np.testing.assert_array_max_ulp(jn, w, maxulp=1)
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
# bf16/int8: the reference's MXU-vs-einsum accumulation and P's bf16
# rounding: 2e-2.
_B2_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_attention_append_matches_reference(dtype):
    """B2 with new_kv (append, then attend), GQA 4, lse, pages_bound."""
    rng = np.random.default_rng(4)
    jc, tc = _seeded_caches(dtype, [37, 47, 5], rng)
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
    _assert_cache_equal(tc, jc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=_B2_TOL[dtype])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_B2_TOL[dtype])


def test_paged_attention_bf16_queries_without_append():
    """B2 without new_kv on bf16 queries: the output keeps q's dtype; 2e-2
    is one bf16 ulp of the output plus P's bf16 rounding."""
    rng = np.random.default_rng(5)
    jc, tc = _seeded_caches("int8", [33, 16, 1], rng)
    q = jnp.asarray(_rand(rng, 3, KVH * 2, D), jnp.bfloat16)
    slots = np.array([2, 0, 1], np.int32)
    jo = jpaged.paged_attention(q, jc, jnp.asarray(slots))
    to = tpaged.paged_attention(to_torch(np.asarray(q)), tc,
                                torch.as_tensor(slots))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                               atol=2e-2)


@pytest.mark.parametrize("kw", [dict(radius=8), dict(shared_page_table=True),
                                dict(lengths_override=torch.ones(1))])
def test_paged_unported_options_raise(kw):
    _, tc = _seeded_caches("float32", [4], np.random.default_rng(6))
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tpaged.paged_attention(torch.zeros(1, KVH, D), tc,
                               torch.zeros(1, dtype=torch.int32), **kw)


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
