"""Port parity for the sliding-window path's ops: ``LocalSchedule``, the
band oracles, ``sliding_fa`` (B1 with the band; the reference's band kernel
B11), the norm-bound max (B1's bound; the reference's d ≤ 64 kernel B9),
``paged_attention`` with a band, per-lane positions, visible lengths and a
shared page table, ``paged_attention_pipelined`` (the reference's B12) and
``merge_partials``.

The same numpy inputs (made from a seed) go through the reference on the
CPU (Pallas in interpret mode, as its own tests run it) and through the
port's plain path. The CUDA kernels are held against these plain paths on
the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.ops import flash as jflash
from tpu_flash.ops import oracle as joracle
from tpu_flash.ops import paged as jpaged
from tpu_flash.ops import schedule as jsched
from tpu_flash.parallel.ring import merge_partials as jmerge
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import oracle as toracle
from tpu_flash_torch.ops import paged as tpaged
from tpu_flash_torch.ops import schedule as tsched
from tpu_flash_torch.parallel.ring import merge_partials as tmerge
from tpu_flash_torch.utils.convert import cache_from_reference, to_numpy, to_torch

torch.set_num_threads(2)

# f32: both sides sum in float32 in another order (~1e-6 apart); bf16: P
# rounds to bf16 against the running max (reference tiles) or the row max
# (port): one bf16 ulp of P ≈ 4e-3 relative (tests/test_torch_flash.py).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(seed, hq, hkv, n, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((1, h, n, d)).astype(np.float32)
          for h in (hq, hkv, hkv)]
    jx = [jnp.asarray(x, jnp.dtype(dtype)) for x in xs]
    return jx, [to_torch(np.asarray(x), device="cpu") for x in jx]


def _close(got, want, tol):
    """o (or lse) within tol where the reference is finite; −inf rows
    must agree."""
    got = to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_q,n_kv,bq,bkv,radius", [
    (256, 256, 64, 64, 64), (200, 200, 64, 128, 33), (300, 300, 128, 64, 0),
    (1000, 1000, 256, 256, 64), (100, 100, 64, 32, 200)])
def test_local_schedule_matches_reference(causal, n_q, n_kv, bq, bkv, radius):
    """Band visit math, the exact step counts and masks: identical."""
    js = jsched.LocalSchedule(n_q, n_kv, bq, bkv, radius=radius, causal=causal)
    ts = tsched.LocalSchedule(n_q, n_kv, bq, bkv, radius=radius, causal=causal)
    for attr in ("n_q_pad", "n_kv_pad", "num_q_blocks", "num_kv_blocks",
                 "max_kv_steps", "max_q_steps", "has_mask"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    for i in range(ts.num_q_blocks):
        for s in range(ts.max_kv_steps):
            assert ts.kv_block_index(i, s) == int(js.kv_block_index(i, s))
            assert ts.step_needed(i, s) == bool(js.step_needed(i, s))
            assert ts.block_unmasked(i, s) == bool(js.block_unmasked(i, s))
    for j in range(ts.num_kv_blocks):
        for s in range(ts.max_q_steps):
            assert ts.q_block_index(j, s) == int(js.q_block_index(j, s))
            assert ts.q_step_needed(j, s) == bool(js.q_step_needed(j, s))
    qp, kp = np.arange(ts.n_q_pad)[:, None], np.arange(ts.n_kv_pad)[None, :]
    np.testing.assert_array_equal(
        ts.mask(torch.as_tensor(qp), torch.as_tensor(kp)).numpy(),
        np.asarray(js.mask(jnp.asarray(qp), jnp.asarray(kp))))


@pytest.mark.parametrize("window,causal,n", [(9, False, 50), (33, True, 120),
                                             (65, False, 40)])
def test_band_oracles_match_reference(window, causal, n):
    """sliding_dpa and blockwise_dpa(window_size=) vs the reference's
    (HIGHEST-precision einsums): 1e-5, the file's f32 oracle bound."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, n, 32)
    jo, jl = joracle.sliding_dpa(jq, jk, jv, window, causal=causal)
    to, tl = toracle.sliding_dpa(tq, tk, tv, window, causal=causal)
    _close(to, jo, 1e-5)
    _close(tl, jl, 1e-5)
    jo, jl = joracle.blockwise_dpa(jq, jk, jv, window_size=window,
                                   causal=causal, chunk=16)
    to, tl = toracle.blockwise_dpa(tq, tk, tv, window_size=window,
                                   causal=causal, chunk=16)
    _close(to, jo, 1e-5)
    _close(tl, jl, 1e-5)
    with pytest.raises(ValueError, match="odd"):
        toracle.sliding_dpa(tq, tk, tv, window + 1)


# (hq, hkv, n, d, window, causal, dtype)
_SLIDING = [
    (2, 2, 200, 32, 33, False, "float32"),
    (4, 2, 200, 32, 33, True, "float32"),
    (2, 1, 300, 64, 65, True, "float32"),
    (4, 2, 250, 64, 129, False, "bfloat16"),
    (2, 2, 256, 64, 129, True, "bfloat16"),
]


@pytest.mark.parametrize("case", _SLIDING,
                         ids=[f"{c[2]}-{c[4]}-{'causal' if c[5] else 'band'}-"
                              f"{c[6]}" for c in _SLIDING])
def test_sliding_fa_matches_reference(case):
    """sliding_fa (local and local_causal, ragged n, GQA, lse) with the
    auto max policy on both sides (the bound for the band, the exact max
    for the causal band)."""
    hq, hkv, n, d, w, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, hq, hkv, n, d, dtype)
    kw = dict(causal=causal, return_lse=True, block_q=64, block_kv=64)
    jo, jl = jflash.sliding_fa(jq, jk, jv, w, **kw)
    to, tl = tflash.sliding_fa(tq, tk, tv, w, **kw)
    assert to.dtype == tq.dtype and to.shape == tq.shape
    _close(to, jo, TOL[dtype])
    _close(tl, jl, TOL[dtype])


@pytest.mark.parametrize("case", ["sliding", "sliding_causal", "ragged"])
def test_sliding_fa_matches_band_kernel(case):
    """The reference's band kernel B11 (``band_pipeline(True, sub=256)``
    with the exact max, at its own test's shapes: d 64, w 129, n 1024 and
    a ragged 1000) against the port with the exact max: 1e-4."""
    n = 1000 if case == "ragged" else 1024
    causal = case == "sliding_causal"
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2, 2, n, 64)
    kw = dict(causal=causal, return_lse=True, block_q=256, block_kv=256)
    with jflash.force_bound_max(False), jflash.band_pipeline(True, sub=256):
        jo, jl = jflash.sliding_fa(jq, jk, jv, 129, **kw)
    to, tl = tflash.sliding_fa(tq, tk, tv, 129, bound_max=False, **kw)
    _close(to, jo, 1e-4)
    _close(tl, jl, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bound_max_matches_transposed_kernel(dtype):
    """bound_max=True at d 64, dense: the reference routes to its d ≤ 64
    transposed kernel B9, whose max is the norm bound; the port's plain
    version takes the same bound. GQA 4/2, lse."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(4, 4, 2, 256, 64, dtype)
    kw = dict(schedule="dense", bound_max=True, return_lse=True,
              block_q=128, block_kv=128)
    jo, jl = jflash.flash_attention(jq, jk, jv, **kw)
    to, tl = tflash.flash_attention(tq, tk, tv, **kw)
    _close(to, jo, TOL[dtype])
    _close(tl, jl, TOL[dtype])


@pytest.mark.parametrize("schedule,n,want", [
    ("dense", 256, True), ("dense", 200, False), ("causal", 256, False),
    ("local", 200, True), ("local_causal", 256, False)])
def test_bound_max_auto_policy(schedule, n, want):
    """None resolves as the reference's rule (ops/flash.py:1005-1007): the
    bound for mask-free dense and the non-causal band, the exact max for
    causal, the causal band and ragged (masked) dense; the result is the
    forced policy's, bit for bit."""
    _, (tq, tk, tv) = _qkv(5, 2, 2, n, 32)
    kw = dict(schedule=schedule, radius=16, block_q=128, block_kv=128)
    sched = tflash.build_schedule(schedule, n, n, 128, 128, radius=16)
    assert tflash.auto_bound_max(sched) is want
    auto = tflash.flash_attention(tq, tk, tv, **kw)
    assert torch.equal(auto, tflash.flash_attention(tq, tk, tv, bound_max=want,
                                                    **kw))
    assert not torch.equal(auto, tflash.flash_attention(
        tq, tk, tv, bound_max=not want, **kw))


def test_band_backward_plain_matches_oracle_grads():
    """The band's backward (CPU plain version, through the schedule's mask)
    equals autograd through sliding_dpa: f32 3e-4 / 1e-3
    (tests/test_grad.py's bounds)."""
    _, (tq, tk, tv) = _qkv(6, 2, 2, 120, 32)
    w = torch.randn(1, 2, 120, 32, generator=torch.Generator().manual_seed(0))

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        (fn(*xs) * w).sum().backward()
        return [x.grad for x in xs]

    got = grads(lambda q, k, v: tflash.sliding_fa(q, k, v, 17, causal=True,
                                                  block_q=64, block_kv=64))
    want = grads(lambda q, k, v: toracle.sliding_dpa(q, k, v, 17,
                                                     causal=True)[0])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=1e-3)


# -- paged attention with a band, positions, visible lengths ----------------

KVH, D, PAGE, TOTAL, MAX_SEQS, MAXP = 2, 64, 16, 64, 4, 12
# f32 pages: q/K/V cast to bf16 on both sides by contract, f32 sums in
# another order; bf16/int8: P's bf16 rounding (tests/test_torch_paged.py)
_B2_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}


def _caches(dtype, lens, seed):
    """The reference cache with random prompts of ``lens`` tokens in slots
    0.., and the port's copy, bit for bit."""
    rng = np.random.default_rng(seed)
    cfg = JCacheConfig(num_kv_heads=KVH, head_dim=D, page_size=PAGE,
                       total_pages=TOTAL, max_seqs=MAX_SEQS,
                       max_pages_per_seq=MAXP, dtype=dtype)
    tables = 1 + (np.arange(MAX_SEQS * MAXP).reshape(MAX_SEQS, MAXP) * 5
                  % (TOTAL - 1))
    jc = JPagedKVCache.create(cfg).assign_pages(jnp.asarray(tables, jnp.int32))
    for s, n in enumerate(lens):
        k, v = (rng.standard_normal((KVH, n, D)).astype(np.float32)
                for _ in range(2))
        jc = jc.write_prompt(s, jnp.asarray(k), jnp.asarray(v))
    return jc, cache_from_reference(jc, device="cpu")


def _paged_pair(jc, tc, q, slots, **kw):
    """The reference's and the port's paged_attention on the same inputs
    (integer tensors converted for each side)."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    j = jpaged.paged_attention(jnp.asarray(q), jc, jnp.asarray(slots),
                               return_lse=True, **jkw)
    t = tpaged.paged_attention(torch.as_tensor(q), tc, torch.as_tensor(slots),
                               return_lse=True, **tkw)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_band_decode_matches_reference(dtype):
    """Decode with a band (radius 20: the walk starts at page
    (len − 1 − 20) // 16 and covers ≤ 3 pages) and the fused append."""
    jc, tc = _caches(dtype, [70, 33, 5], 7)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, KVH * 2, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((3, KVH, D)).astype(np.float32)
              for _ in range(2))
    slots = np.array([0, 1, 2], np.int32)
    jo, jl, jc = jpaged.paged_attention(
        jnp.asarray(q), jc, jnp.asarray(slots), radius=20, return_lse=True,
        new_kv=(jnp.asarray(kn), jnp.asarray(vn)))
    to, tl, tc = tpaged.paged_attention(
        torch.as_tensor(q), tc, torch.as_tensor(slots), radius=20,
        return_lse=True, new_kv=(torch.as_tensor(kn), torch.as_tensor(vn)))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    _close(to, jo, _B2_TOL[dtype])
    _close(tl, jl, _B2_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_chunk_prefix_matches_reference(dtype):
    """The chunk-prefix call of chunked prefill: 40 chunk tokens ride the
    lanes of one slot (shared page table) with per-lane positions 96..135
    and radius 50 against a 96-token prefix, pages_bound 8: each lane's
    band starts at its own position − 50."""
    jc, tc = _caches(dtype, [96], 9)
    rng = np.random.default_rng(10)
    q = rng.standard_normal((40, KVH * 2, D)).astype(np.float32)
    slots = np.zeros(40, np.int32)
    pos = np.arange(96, 136, dtype=np.int32)
    (jo, jl), (to, tl) = _paged_pair(jc, tc, q, slots, radius=50,
                                     positions=pos, pages_bound=8,
                                     shared_page_table=True)
    _close(to, jo, _B2_TOL[dtype])
    _close(tl, jl, _B2_TOL[dtype])


def test_paged_empty_prefix_gives_weightless_partials():
    """The first chunk's prefix is empty, and a band can start past the
    visible keys: both give o = 0, lse = −inf on both sides."""
    jc, tc = _caches("float32", [20], 11)  # slot 1 holds nothing
    q = np.random.default_rng(12).standard_normal((4, KVH * 2, D)).astype(
        np.float32)
    slots = np.array([1, 1, 0, 0], np.int32)
    pos = np.array([0, 5, 40, 19], np.int32)  # lane 2: band [30, 41) ∩ [0, 20)
    (jo, jl), (to, tl) = _paged_pair(jc, tc, q, slots, radius=10,
                                     positions=pos)
    assert torch.isneginf(tl[:3]).all() and (to[:3] == 0).all()
    assert torch.isfinite(tl[3]).all()
    _close(to, jo, 1e-4)
    _close(tl, jl, 1e-4)


@pytest.mark.parametrize("radius", [None, 12])
def test_paged_lengths_override_matches_reference(radius):
    """Per-lane visible key counts (speculative verification's K lanes on
    one slot), with and without a band."""
    jc, tc = _caches("int8", [50, 30], 13)
    q = np.random.default_rng(14).standard_normal((4, KVH * 2, D)).astype(
        np.float32)
    slots = np.array([0, 0, 0, 1], np.int32)
    vis = np.array([48, 49, 50, 17], np.int32)
    kw = dict(lengths_override=vis)
    if radius is not None:
        kw.update(radius=radius, positions=vis - 1)
    (jo, jl), (to, tl) = _paged_pair(jc, tc, q, slots, **kw)
    _close(to, jo, 2e-2)
    _close(tl, jl, 2e-2)


# -- the pipelined decode (the reference's B12) ---------------------------


@pytest.mark.parametrize("rank1", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pipelined_decode_matches_both_reference_paths(dtype, rank1):
    """paged_attention_pipelined with the append (split, or the reference's
    rank-1 update, which it runs in interpret mode) and a band, against the
    reference's pipelined kernel and its paged_attention: the same cache
    bytes (scales to 1 ulp: the reference's jitted quantizer multiplies by
    the reciprocal, ROADMAP C) and lengths, o and lse within the B2
    bounds (2e-2 against the pipelined kernel, see below)."""
    lens = [37, 16, 50, 15]
    jc, tc = _caches(dtype, lens, 15)
    rng = np.random.default_rng(16)
    q = rng.standard_normal((4, KVH * 2, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((4, KVH, D)).astype(np.float32)
              for _ in range(2))
    slots = np.arange(4, dtype=np.int32)
    jnew = (jnp.asarray(kn), jnp.asarray(vn))
    kw = dict(radius=20, return_lse=True)
    jp = jpaged.paged_attention_pipelined(
        jnp.asarray(q), jc, jnp.asarray(slots), new_kv=jnew, chunk_pages=2,
        rank1_append=rank1, interpret=True, **kw)
    jv = jpaged.paged_attention(jnp.asarray(q), jc, jnp.asarray(slots),
                                new_kv=jnew, **kw)
    to, tl, tc = tpaged.paged_attention_pipelined(
        torch.as_tensor(q), tc, torch.as_tensor(slots),
        new_kv=(torch.as_tensor(kn), torch.as_tensor(vn)), chunk_pages=2,
        rank1_append=rank1, **kw)
    # the pipelined kernel rounds P to bf16 against the running max of a
    # two-page chunk, B2 against a page's: one bf16 ulp of P apart (2e-2)
    for (jo, jl, jcache), tol in ((jp, 2e-2), (jv, _B2_TOL[dtype])):
        _close(to, jo, tol)
        _close(tl, jl, tol)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            t, j = getattr(tc, name), getattr(jcache, name)
            if t is None:
                continue
            if name.endswith("scales"):
                np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j),
                                                maxulp=1)
            else:
                np.testing.assert_array_equal(to_numpy(t),
                                              np.asarray(j, np.float32))


def test_pipelined_decode_without_append_and_chunk_check():
    """Without the append: each lane walks its own pages (no bound), the
    reference's no-append kernel's result; chunk_pages must be a positive
    int."""
    jc, tc = _caches("int8", [40, 21, 70], 17)
    q = np.random.default_rng(18).standard_normal((3, KVH * 2, D)).astype(
        np.float32)
    slots = np.array([0, 1, 2], np.int32)
    jo, jl = jpaged.paged_attention_pipelined(
        jnp.asarray(q), jc, jnp.asarray(slots), return_lse=True,
        chunk_pages=4, interpret=True)
    to, tl = tpaged.paged_attention_pipelined(
        torch.as_tensor(q), tc, torch.as_tensor(slots), return_lse=True)
    _close(to, jo, 2e-2)
    _close(tl, jl, 2e-2)
    with pytest.raises(ValueError, match="chunk_pages"):
        tpaged.paged_attention_pipelined(torch.as_tensor(q), tc,
                                         torch.as_tensor(slots), chunk_pages=0)


# -- merge_partials -------------------------------------------------------


def test_merge_partials_matches_reference():
    """Two partials merge as in the reference, −inf partials weigh 0, and
    two empty partials give o = 0, lse = −inf (1e-6: float32 exp/log)."""
    rng = np.random.default_rng(19)
    o1, o2 = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 3, 5)).astype(np.float32)
              for _ in range(2))
    l1[0, 0, :2] = -np.inf
    l2[0, 0, 1:3] = -np.inf
    jo, jl = jmerge(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    to, tl = tmerge(*(torch.as_tensor(x) for x in (o1, l1, o2, l2)))
    _close(tl, jl, 1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    assert (to[0, 0, 1] == 0).all() and torch.isneginf(tl[0, 0, 1])
    np.testing.assert_allclose(to[0, 0, 0].numpy(), o2[0, 0, 0], atol=1e-6)



# -- the card's split plan, on the plain version ------------------------------


@pytest.mark.parametrize("split_pages", [1, 2])
@pytest.mark.parametrize("radius", [None, 20])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_split_plain_matches_reference(dtype, radius, split_pages):
    """The plain version under a split plan (each split an online softmax
    of its own, P rounded against the split's running max, the splits
    combined in split order: what the card's split route computes) against
    the reference's paged_attention and its pipelined kernel, with the
    append and with and without a band: 2e-2, the reference's own bound for
    a walk that rounds P against another max (see the pipelined test
    above). A plan whose one split covers every lane's walk is the
    one-split walk, bit for bit."""
    lens = [37, 16, 50, 15]
    jc, tc = _caches(dtype, lens, 21)
    rng = np.random.default_rng(22)
    q = rng.standard_normal((4, KVH * 2, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((4, KVH, D)).astype(np.float32)
              for _ in range(2))
    slots = np.arange(4, dtype=np.int32)
    jnew = (jnp.asarray(kn), jnp.asarray(vn))
    jo, jl, _ = jpaged.paged_attention(
        jnp.asarray(q), jc, jnp.asarray(slots), new_kv=jnew, radius=radius,
        return_lse=True)
    jp = jpaged.paged_attention_pipelined(
        jnp.asarray(q), jc, jnp.asarray(slots), new_kv=jnew, radius=radius,
        chunk_pages=2, interpret=True, return_lse=True)
    ts = torch.as_tensor(slots)
    tpaged.fused_append(tc, ts, torch.as_tensor(kn), torch.as_tensor(vn))
    qg = (torch.as_tensor(q) * (D ** -0.5 * tpaged.LOG2E)).bfloat16()
    bound = MAXP if radius is None else min(MAXP, -(-(radius + 1) // PAGE) + 1)
    args = (qg.reshape(4, KVH, 2, D), tc.k_pages, tc.v_pages, tc.k_scales,
            tc.v_scales, ts, tc.lengths, tc.page_tables, 1, bound,
            torch.float32, True)
    kw = dict(radius=radius)
    to, tl = tpaged._paged_attention_plain(*args, **kw,
                                           split_pages=split_pages,
                                           page_type=dtype)
    for ref_o, ref_l in ((jo, jl), (jp[0], jp[1])):
        _close(to.reshape(4, KVH * 2, D), ref_o, 2e-2)
        _close(tl.reshape(4, KVH * 2), ref_l, 2e-2)
    one = tpaged._paged_attention_plain(*args, **kw, page_type=dtype)
    whole = tpaged._paged_attention_plain(*args, **kw, split_pages=bound,
                                          page_type=dtype)
    assert all(torch.equal(a, b) for a, b in zip(one, whole))


def test_fused_plain_is_append_then_attention():
    """paged_attention(new_kv=...) on the CPU is B3's plain version then
    B2's with len_add 1, bit for bit: pages, scales and lengths equal, o
    and lse equal."""
    _, tc = _caches("int8", [37, 16, 50], 23)
    _, pc = _caches("int8", [37, 16, 50], 23)
    rng = np.random.default_rng(24)
    q = torch.as_tensor(rng.standard_normal((3, KVH * 2, D)).astype(np.float32))
    kn, vn = (torch.as_tensor(rng.standard_normal((3, KVH, D)).astype(
        np.float32)) for _ in range(2))
    slots = torch.tensor([0, 1, 2], dtype=torch.int32)
    to, tl, _ = tpaged.paged_attention(q, tc, slots, new_kv=(kn, vn),
                                       radius=20, return_lse=True)
    tpaged._paged_append_plain(kn, vn, pc.k_pages, pc.v_pages, pc.k_scales,
                               pc.v_scales, slots, pc.lengths, pc.page_tables,
                               page_type="int8")
    qg = (q.float() * (D ** -0.5 * tpaged.LOG2E)).bfloat16()
    po, pl = tpaged._paged_attention_plain(
        qg.reshape(3, KVH, 2, D), pc.k_pages, pc.v_pages, pc.k_scales,
        pc.v_scales, slots, pc.lengths, pc.page_tables, 1,
        min(MAXP, -(-21 // PAGE) + 1), torch.float32, True, radius=20,
        page_type="int8")
    pc.lengths.index_add_(0, slots.long(), torch.ones_like(slots))
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths"):
        assert torch.equal(getattr(tc, name), getattr(pc, name)), name
    assert torch.equal(to, po.reshape(3, KVH * 2, D))
    assert torch.equal(tl, pl.reshape(3, KVH * 2))


def test_shared_slot_keyword_skips_only_the_check():
    """prefill_chunk's internal slot keyword gives the same call as the
    public shared-table check; the public check still refuses lanes on two
    slots."""
    _, tc = _caches("int8", [96, 20], 25)
    q = torch.as_tensor(np.random.default_rng(26).standard_normal(
        (40, KVH * 2, D)).astype(np.float32))
    slots = torch.zeros(40, dtype=torch.int32)
    pos = torch.arange(96, 136, dtype=torch.int32)
    kw = dict(radius=50, positions=pos, pages_bound=8, return_lse=True,
              shared_page_table=True)
    a = tpaged.paged_attention(q, tc, slots, **kw)
    b = tpaged.paged_attention(q, tc, slots, _shared_slot=0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="same slot"):
        tpaged.paged_attention(q, tc, torch.arange(40, dtype=torch.int32) % 2,
                               **kw)


@pytest.mark.parametrize("case,route", [
    ((128, 2, 64, "int8", True), "shared"),
    ((128, 2, 64, "int8", False), "split"),
    ((128, 2, 64, "bfloat16", False), "split"),
    ((40, 16, 64, "bfloat16", True), "shared"),
    ((96, 16, 32, "int8", True), "split"),
    ((256, 2, 128, "float32", False), "split"),
    ((8, 2, 18, "int8", False), "split"),
    ((8, 2, 20, "int8", False), "split"),
    ((256, 3, 128, "bfloat16", False), "split"),
    ((128, 2, 64, "int4", False), "split"),
    ((72, 4, 64, "fp8", True), "shared"),
])
def test_paged_route_and_split_plan(case, route):
    """paged_route picks the documented route: the shared table at page 64
    takes the tensor-core route; every other call, whatever its width,
    group, page or page type, the split route. split_plan: three int8,
    int4 or fp8 pages a split at the serving decode (16 lanes × 8 heads ×
    16 pages), one bf16, one at a single lane; never more than 56 KB of
    pages (rows of d·esize bytes, d/2 for int4, and a 4-byte scale for
    the quantized types) a split unless one page is more."""
    d, g, page, dtype, shared = case
    assert tpaged.paged_route(page, shared) == route
    if route == "split":
        s = tpaged.split_plan(16, 8, d, page, dtype, 16)
        row = {"float32": 4 * d, "bfloat16": 2 * d, "int8": d + 4,
               "fp8": d + 4, "int4": d // 2 + 4}[dtype]
        assert tpaged.row_bytes(dtype, d) == row
        assert 1 <= s <= 3 and (s * 2 * page * row <= 57344 or s == 1)
    assert tpaged.split_plan(16, 8, 128, 64, "int8", 16) == 3
    assert tpaged.split_plan(16, 8, 128, 64, "fp8", 16) == 3
    assert tpaged.split_plan(16, 8, 128, 64, "int4", 16) == 3
    assert tpaged.split_plan(16, 8, 128, 64, "bfloat16", 16) == 1
    assert tpaged.split_plan(1, 8, 128, 64, "int8", 16) == 1
