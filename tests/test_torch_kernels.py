"""The port's CUDA kernels (B1 flash forward with the band, the circulant
band, the block-diagonal schedule, the ring hop's shifted kinds and the
norm bound, where the reference's B9 and B11 fold in; B2 paged attention on its split and shared-table
routes with the band, positions and visible lengths, where B12 folds in,
and with B3's append fused; B3 paged append; B4/B5 flash backward;
B6/B8 serving and B7 quantized attention; B13 softmax; B14 matmul) against
their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports only torch and the port, so it also
runs where the reference's framework is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.bench import quant_bench
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import flash_bwd as tflash_bwd
from tpu_flash_torch.ops import paged as tpaged
from tpu_flash_torch.ops.oracle import dense_dpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("causal,n_q,n_kv,dtype", [
    (True, 1024, 1024, torch.bfloat16), (True, 1000, 1000, torch.bfloat16),
    (True, 256, 1024, torch.bfloat16), (False, 300, 300, torch.float32)])
def test_flash_kernel_matches_plain(gen, causal, n_q, n_kv, dtype, d=128,
                                    dv=128):
    """B1 kernel vs plain at the serving head layout (16 q heads, 8 kv
    heads, d 128). o bf16 2e-2: P rounds to bf16 against the tile's running
    max in the kernel and the row max in the plain version. f32 1e-4, and
    lse 1e-4 in both dtypes: summation order only (float32 sums)."""
    hq, hkv = 16, 8
    q = torch.randn(hq, n_q, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(hkv, n_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(hkv, n_kv, dv, generator=gen, device="cuda").to(dtype)
    sched = tflash.build_schedule("causal" if causal else "dense", n_q, n_kv,
                                  256, 256)
    before = kernels.LAUNCHES["flash_fwd"]
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    _assert_b1_close(ko, kl, po, pl, dtype)


def _assert_b1_close(ko, kl, po, pl, dtype):
    """B1's kernel-vs-plain check: o within 2e-2 (bf16) or 1e-4 (f32), the
    same rows finite in lse, and lse within 1e-4 where finite."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((ko.float() - po.float()).abs().max()) <= tol
    fin = torch.isfinite(pl)
    assert torch.equal(torch.isfinite(kl), fin)
    if fin.any():
        assert float((kl[fin] - pl[fin]).abs().max()) <= 1e-4


# (causal, n, d, dv, dtype): head and value dims other than 64 and 128,
# zero-padded to a compiled width (float32 at 256 splits the head dim across
# a 2-CTA cluster)
_B1_HEAD_DIMS = [(True, 1000, 96, 96, torch.bfloat16),
                 (True, 1000, 256, 256, torch.bfloat16),
                 (False, 300, 256, 256, torch.float32),
                 (True, 1000, 96, 64, torch.bfloat16),
                 (False, 500, 40, 200, torch.bfloat16)]


@pytest.mark.parametrize("causal,n,d,dv,dtype", _B1_HEAD_DIMS)
def test_flash_kernel_head_dims_match_plain(gen, causal, n, d, dv, dtype):
    """B1 at other head and value dims vs plain, as the d 128 cases."""
    test_flash_kernel_matches_plain(gen, causal, n, n, dtype, d, dv)


# (schedule, radius, n, d, bound_max, dtype): the sliding serving path's
# band (window 1025: radius 512) at n 2048 and a ragged n 1000, d 64 and
# 128; the norm-bound max at d 64 (where the reference's transposed kernel
# B9 runs) and d 128, dense, bf16 and float32
_B1_VARIANTS = [
    ("local_causal", 512, 2048, 128, False, torch.bfloat16),
    ("local", 512, 1000, 128, None, torch.bfloat16),
    ("local_causal", 64, 1000, 64, False, torch.bfloat16),
    ("local", 129, 1024, 64, None, torch.float32),
    ("dense", 0, 1024, 64, True, torch.bfloat16),
    ("dense", 0, 1000, 64, True, torch.float32),
    ("dense", 0, 1024, 128, True, torch.bfloat16),
    ("causal", 0, 1000, 128, True, torch.bfloat16),
]


@pytest.mark.parametrize("case", _B1_VARIANTS, ids=[
    f"{c[0]}-r{c[1]}-n{c[2]}-d{c[3]}-{'bound' if c[4] is not False else 'exact'}"
    f"-{str(c[5])[6:]}" for c in _B1_VARIANTS])
def test_flash_kernel_band_and_bound_match_plain(gen, case):
    """B1 with the band schedules and the norm-bound max vs its plain
    version (16 q / 8 kv heads). None takes the auto policy (the bound for
    the non-causal band). o bf16 2e-2, f32 1e-4, lse 1e-4 where finite,
    as the dense and causal cases."""
    schedule, radius, n, d, bound, dtype = case
    hq, hkv = 16, 8
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k = torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
    sched = tflash.build_schedule(schedule, n, n, 512, 1024, radius=radius)
    if bound is None:
        bound = tflash.auto_bound_max(sched)
    before = kernels.LAUNCHES["flash_fwd"]
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True, bound)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    _assert_b1_close(ko, kl, po, pl, dtype)


def _cache(dtype, lens, seed, *, kvh=8, d=128, page=64, total=1024, maxp=64,
           tables=32):
    cfg = CacheConfig(num_kv_heads=kvh, head_dim=d, page_size=page,
                      total_pages=total, max_seqs=32, max_pages_per_seq=maxp,
                      dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = PagedKVCache.create(cfg, "cuda")
    perm = torch.randperm(total - 1, generator=g, device="cuda") + 1
    c.page_tables[: len(lens), :tables] = perm[: len(lens) * tables].reshape(
        -1, tables).int()
    for s, n in enumerate(lens):
        c.write_prompt(s, torch.randn(kvh, n, d, generator=g, device="cuda"),
                       torch.randn(kvh, n, d, generator=g, device="cuda"))
    return c


def _copy(c):
    """A second cache with the same bytes."""
    return PagedKVCache(*(None if t is None else t.clone() for t in (
        c.k_pages, c.v_pages, c.k_scales, c.v_scales, c.page_tables,
        c.lengths)), config=c.config)


def _plan(q, cache, shared=False, radius=None):
    """The split plan the card takes for this call (None: one split): the
    public call's, sized for the cache's walk (``plan_pages``)."""
    b, kvh, _, d = q.shape
    page = cache.k_pages.shape[2]
    if tpaged.paged_route(page, shared) != "split":
        return None
    return tpaged.split_plan(b, kvh, d, page, cache.config.page_type,
                             tpaged.plan_pages(cache.config, radius))


def _kernel_kw(cache, radius=None):
    """The page type and the split plan's walk of B2's wrapper, as
    ``paged_attention`` passes them."""
    return dict(page_type=cache.config.page_type,
                walk=tpaged.plan_pages(cache.config, radius))


def _route_count(route):
    return kernels.LAUNCHES[f"paged_attention_{route}"]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32", "int4",
                                   "fp8"])
def test_paged_kernels_match_plain(gen, dtype):
    """B3 then B2 at the serving decode shape (16 lanes, 8 kv heads, G 2,
    d 128, page 64, ~540 tokens, pages_bound 16): B3's pages and scales
    bit-exact; B2 (the split route) within 2e-2 of the plain version under
    the same split plan (bf16 P either side, summation order)."""
    lens = (530 + torch.randint(0, 20, (16,), generator=gen, device="cuda")).tolist()
    kc, pc = _cache(dtype, lens, 1), _cache(dtype, lens, 1)
    slots = torch.arange(16, dtype=torch.int32, device="cuda")
    kn = torch.randn(16, 8, 128, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(16, 8, 128, generator=gen, device="cuda").bfloat16()

    def append_args(c):
        return (kn, vn, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
                c.lengths, c.page_tables)

    pt = kc.config.page_type
    before = dict(kernels.LAUNCHES)
    tpaged._paged_append_kernel(*append_args(kc), page_type=pt)
    tpaged._paged_append_plain(*append_args(pc), page_type=pt)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(kc, name), getattr(pc, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    q = torch.randn(16, 8, 2, 128, generator=gen, device="cuda").bfloat16()
    args = (q, kc.k_pages, kc.v_pages, kc.k_scales, kc.v_scales, slots,
            kc.lengths, kc.page_tables, 1, 16, torch.bfloat16, True)
    ko, kl = tpaged._paged_attention_kernel(*args, **_kernel_kw(kc))
    po, pl = tpaged._paged_attention_plain(*args, split_pages=_plan(q, kc),
                                           page_type=pt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_append"] == before["paged_append"] + 1
    assert (kernels.LAUNCHES["paged_attention_split"]
            == before["paged_attention_split"] + 1)
    assert float((ko.float() - po.float()).abs().max()) <= 2e-2
    assert float((kl - pl).abs().max()) <= 2e-2


def _paged_pair(cache, q, slots, bound=64, **kw):
    """B2 on CUDA tensors and its plain version (under the card's split
    plan) on the same tensors (o, lse each); the kernel twice, bitwise
    equal (the split combine is ordered)."""
    args = (q, cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
            slots, cache.lengths, cache.page_tables, 0, bound, torch.bfloat16,
            True)
    shared = kw.get("shared_page_table", False)
    route = tpaged.paged_route(cache.k_pages.shape[2], shared)
    pt = cache.config.page_type
    radius = kw.get("radius")
    before = _route_count(route)
    got = tpaged._paged_attention_kernel(*args, **kw,
                                         **_kernel_kw(cache, radius))
    again = tpaged._paged_attention_kernel(*args, **kw,
                                           **_kernel_kw(cache, radius))
    torch.cuda.synchronize()
    assert _route_count(route) == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    plain_kw = {k: v for k, v in kw.items()
                if k in ("lengths_override", "positions", "radius")}
    return got, tpaged._paged_attention_plain(
        *args, **plain_kw, split_pages=_plan(q, cache, shared, radius),
        page_type=pt)


def _assert_paged_close(got, want, tol=2e-2):
    """o within 2e-2 (bf16 P either side, summation order; float32 out
    1e-4 where given); lse within 1e-4 where finite, with the same −inf
    lanes."""
    (ko, kl), (po, pl) = got, want
    assert float((ko.float() - po.float()).abs().max()) <= tol
    fin = torch.isfinite(pl)
    assert torch.equal(torch.isfinite(kl), fin)
    if fin.any():
        assert float((kl[fin] - pl[fin]).abs().max()) <= 1e-4


@pytest.mark.parametrize("shared", [False, True], ids=["split", "shared"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "int4", "fp8"])
def test_paged_kernel_chunk_prefix_matches_plain(gen, dtype, shared):
    """B2 as chunked prefill calls it: 512 lanes of one slot, per-lane
    positions 1536..2047, radius 512, a 1536-token prefix, through the
    shared-table route (a tensor-core q tile) and the split route; and the
    empty prefix of a first chunk, where every lane gives o = 0,
    lse = −inf."""
    c = _cache(dtype, [1536, 1], 2)
    c.lengths[1] = 0
    q = torch.randn(512, 8, 2, 128, generator=gen, device="cuda").bfloat16()
    pos = torch.arange(1536, 2048, dtype=torch.int32, device="cuda")
    for slot in (0, 1):
        slots = torch.full((512,), slot, dtype=torch.int32, device="cuda")
        got, want = _paged_pair(c, q, slots, positions=pos, radius=512,
                                shared_page_table=shared)
        _assert_paged_close(got, want)
    assert torch.isneginf(got[1]).all() and (got[0] == 0).all()


@pytest.mark.parametrize("shared", [False, True], ids=["split", "shared"])
def test_paged_kernel_lengths_override_and_band_match_plain(gen, shared):
    """Per-lane visible lengths (with and without a band from their last
    position), and a band start at or past a lane's keys; under a shared
    table (every lane on slot 0) through the shared route."""
    c = _cache("int8", [700, 300], 3)
    slots = torch.tensor([0, 0, 0, 0 if shared else 1], dtype=torch.int32,
                         device="cuda")
    vis = torch.tensor([640, 641, 700, 257], dtype=torch.int32, device="cuda")
    q = torch.randn(4, 8, 2, 128, generator=gen, device="cuda").bfloat16()
    kw = dict(shared_page_table=shared)
    _assert_paged_close(*_paged_pair(c, q, slots, lengths_override=vis, **kw))
    _assert_paged_close(*_paged_pair(c, q, slots, lengths_override=vis,
                                     positions=vis - 1, radius=100, **kw))
    far = torch.tensor([900, 1000, 2000, 400], dtype=torch.int32,
                       device="cuda")
    got, want = _paged_pair(c, q, slots, positions=far, radius=200, **kw)
    _assert_paged_close(got, want)
    assert torch.isneginf(got[1][1:3]).all()


def test_pipelined_decode_kernels_match_plain(gen):
    """The pipelined decode at 16 lanes of 1100–2032 tokens with the
    sliding band (radius 512) on the int8 cache: one fused launch (the
    split route's append, no B3 launch) on the card vs the plain path on a
    CPU copy of the same cache; cache bytes equal; o and lse within the
    B2 bounds of the one-split walk."""
    lens = (1100 + torch.randint(0, 932, (16,), generator=gen,
                                 device="cuda")).tolist()
    c = _cache("int8", lens, 4)
    cpu = PagedKVCache(*(None if t is None else t.cpu() for t in (
        c.k_pages, c.v_pages, c.k_scales, c.v_scales, c.page_tables,
        c.lengths)), config=c.config)
    slots = torch.arange(16, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(16, 16, 128, generator=g, device="cuda").bfloat16()
    kn, vn = (torch.randn(16, 8, 128, generator=g, device="cuda").bfloat16()
              for _ in range(2))
    before = dict(kernels.LAUNCHES)
    ko, kl, _ = tpaged.paged_attention_pipelined(
        q, c, slots, new_kv=(kn, vn), radius=512, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_append"] == before["paged_append"]
    assert (kernels.LAUNCHES["paged_attention_split"]
            == before["paged_attention_split"] + 1)
    po, pl, _ = tpaged.paged_attention_pipelined(
        q.cpu(), cpu, slots.cpu(), new_kv=(kn.cpu(), vn.cpu()), radius=512,
        return_lse=True)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "lengths"):
        assert torch.equal(getattr(c, name).cpu(), getattr(cpu, name)), name
    _assert_paged_close((ko.cpu(), kl.cpu()), (po, pl))


@pytest.mark.parametrize("d,g", [(96, 16), (40, 16), (256, 3)])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "int4", "fp8"])
def test_paged_kernels_head_dims_and_groups_match_plain(gen, dtype, d, g):
    """B3 then B2 at head dims 40, 96 and 256 and groups of 16 (two chunks
    of 8) and 3: the appended pages and scales bit-exact, o and lse as
    :func:`_assert_paged_close` against the split plain version."""
    kc = _cache(dtype, [300, 257, 64, 450], 5, kvh=2, d=d, total=64,
                maxp=16, tables=8)
    pc = _copy(kc)
    slots = torch.arange(4, dtype=torch.int32, device="cuda")
    kn, vn = (torch.randn(4, 2, d, generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    pt = kc.config.page_type
    for c, fn in ((kc, tpaged._paged_append_kernel),
                  (pc, tpaged._paged_append_plain)):
        fn(kn, vn, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
           c.lengths, c.page_tables, page_type=pt)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(kc, name), getattr(pc, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    q = torch.randn(4, 2, g, d, generator=gen, device="cuda").bfloat16()
    args = (q, kc.k_pages, kc.v_pages, kc.k_scales, kc.v_scales, slots,
            kc.lengths, kc.page_tables, 1, 16, torch.bfloat16, True)
    before = _route_count("split")
    got = tpaged._paged_attention_kernel(*args, **_kernel_kw(kc))
    torch.cuda.synchronize()
    assert _route_count("split") == before + 1
    _assert_paged_close(got, tpaged._paged_attention_plain(
        *args, split_pages=_plan(q, kc), page_type=pt))


# head dims above 256 and paged head dims that are not a multiple of 8:
# B1 at width 512 (O's 256-column halves on the grid; 100 runs at 128)
_B1_WIDE = [(True, 1000, 100, 100, torch.bfloat16),
            (True, 1000, 260, 260, torch.bfloat16),
            (False, 500, 320, 320, torch.bfloat16),
            (True, 1000, 512, 512, torch.bfloat16),
            (True, 1000, 512, 256, torch.bfloat16),
            (False, 300, 512, 512, torch.float32)]


@pytest.mark.parametrize("causal,n,d,dv,dtype", _B1_WIDE)
def test_flash_kernel_wide_head_dims_match_plain(gen, causal, n, d, dv, dtype):
    """B1 at d 100, 260, 320 and 512 (dv 512 and 256), bf16 and float32,
    vs plain, as the d 128 cases."""
    test_flash_kernel_matches_plain(gen, causal, n, n, dtype, d, dv)


# every kind B1 takes (as _TC_KINDS below), at width 512
_WIDE_KINDS = [("dense", 0), ("causal", 0), ("local", 129), ("local_causal", 512),
               ("circulant", 100), ("block", 96)]


@pytest.mark.parametrize("bound", [False, True], ids=["exact", "bound"])
@pytest.mark.parametrize("kind", _WIDE_KINDS, ids=[k[0] for k in _WIDE_KINDS])
def test_flash_kernel_wide_every_kind_matches_plain(gen, kind, bound):
    """B1's bf16 kernel at width 512 on every kind and max mode (4/2 heads,
    n 1000, b 1)."""
    schedule, extra = kind
    hq, hkv, n, d = 4, 2, 1000, 512
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).bfloat16()
    k, v = (torch.randn(hkv, n, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    if schedule == "circulant":
        k, v = (torch.cat([x[:, -extra:], x, x[:, :extra]], dim=1) for x in (k, v))
    sched = tflash.build_schedule(schedule, n, n, 512, 1024, radius=extra
                                  if schedule != "block" else 0,
                                  section=extra if schedule == "block" else 0)
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True, bound)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
    _assert_b1_close(ko, kl, po, pl, torch.bfloat16)


@pytest.mark.parametrize("g", [2, 16])
@pytest.mark.parametrize("d", [100, 260, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "fp8"])
def test_paged_kernels_wide_match_plain(gen, dtype, d, g):
    """B3, B2's split route with and without B3 fused, and its shared
    route at d 100 (rows staged zero-padded), 260 and 512, G 2 and 16 (2
    kv heads, page 64): the appended pages and scales bit-exact, o and lse
    as :func:`_assert_paged_close` against the plain versions."""
    lens = [300, 257, 64, 450]
    kc = _cache(dtype, lens, 5, kvh=2, d=d, total=64, maxp=16, tables=8)
    pc, fc = _copy(kc), _copy(kc)
    slots = torch.arange(4, dtype=torch.int32, device="cuda")
    kn, vn = (torch.randn(4, 2, d, generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    pt = kc.config.page_type
    for c, fn in ((kc, tpaged._paged_append_kernel),
                  (pc, tpaged._paged_append_plain)):
        fn(kn, vn, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
           c.lengths, c.page_tables, page_type=pt)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(kc, name), getattr(pc, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    qr = torch.randn(4, 2, g, d, generator=gen, device="cuda").bfloat16()
    qscale = d ** -0.5 * tpaged.LOG2E
    q = (qr.float() * qscale).bfloat16()

    def args(q, c):
        return (q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
                c.lengths, c.page_tables, 1, 16, torch.bfloat16, True)

    want = tpaged._paged_attention_plain(*args(q, pc), split_pages=_plan(q, kc),
                                         page_type=pt)
    _assert_paged_close(tpaged._paged_attention_kernel(*args(q, kc),
                                                       **_kernel_kw(kc)), want)
    # the fused call on the unappended copy: one launch, the same pages
    before = kernels.LAUNCHES["paged_append_fused"]
    got = tpaged._paged_attention_kernel(*args(qr, fc), new_kv=(kn, vn),
                                         q_scale=qscale, **_kernel_kw(fc))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_append_fused"] == before + 1
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(fc, name), getattr(pc, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    _assert_paged_close(got, want)
    # the shared route: the four lanes on slot 0, each at its own position
    one = torch.zeros(4, dtype=torch.int32, device="cuda")
    pos = torch.tensor([40, 120, 250, 300], dtype=torch.int32, device="cuda")
    got, want = _paged_pair(kc, q, one, bound=16, positions=pos, radius=200,
                            shared_page_table=True)
    _assert_paged_close(got, want)


# (dtype, d, g, page, radius, out): the split route's groups (G 1, 2, 4,
# 16), widths (8, 64, 72, 96, 256), pages (16, 17, 18, 32, 64, 128), page
# types and float32 out, with and without a band; pages the bulk copies do
# not take, which the threads' own loads stage: float32 pages (staged as
# bf16, so that a page of 128 at d 256 fits), quantized pages off the
# 16-byte grid (scale rows of 4·18 bytes; an int4 page of 17 rows at d 8
# is 68 bytes, copied in 4-byte words); int4 at d 72 (rows of 36 bytes,
# off the 8-byte grid: decoded byte by byte)
_B2_CASES = [
    ("int8", 128, 1, 64, None, "bfloat16"),
    ("int8", 128, 2, 64, 100, "bfloat16"),
    ("bfloat16", 64, 4, 16, None, "bfloat16"),
    ("int8", 96, 16, 32, 40, "bfloat16"),
    ("float32", 256, 2, 128, None, "float32"),
    ("bfloat16", 256, 16, 128, 300, "float32"),
    ("float32", 64, 1, 32, 50, "float32"),
    ("int8", 8, 2, 18, None, "bfloat16"),
    ("int4", 64, 1, 64, None, "bfloat16"),
    ("int4", 256, 4, 32, 100, "float32"),
    ("int4", 72, 4, 18, None, "bfloat16"),
    ("int4", 72, 2, 64, 40, "bfloat16"),
    ("int4", 8, 2, 17, None, "bfloat16"),
    ("fp8", 64, 4, 16, None, "bfloat16"),
    ("fp8", 256, 1, 128, 300, "float32"),
    ("fp8", 72, 1, 18, 50, "bfloat16"),
]


@pytest.mark.parametrize("case", _B2_CASES, ids=[
    f"{c[0]}-d{c[1]}-g{c[2]}-p{c[3]}-r{c[4]}-{c[5]}" for c in _B2_CASES])
def test_paged_routes_match_split_plain(gen, case):
    """B2's split route vs the plain version under the same split plan
    (and the split plain version vs the one-split walk within the bf16
    bound): o within 2e-2, lse 1e-4, two calls bitwise equal."""
    dtype, d, g, page, radius, out = case
    lens = [700, 333, 1, 900, 64, 65]
    c = _cache(dtype, lens, 6, kvh=2, d=d, page=page, total=512,
               maxp=-(-1024 // page), tables=-(-1024 // page))
    b = len(lens)
    slots = torch.arange(b, dtype=torch.int32, device="cuda")
    q = (torch.randn(b, 2, g, d, generator=gen, device="cuda")
         * d ** -0.5).to(getattr(torch, out))
    bound = c.config.max_pages_per_seq
    if radius is not None:
        bound = min(bound, -(-(radius + 1) // page) + 1)
    args = (q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
            c.lengths, c.page_tables, 0, bound, getattr(torch, out), True)
    kw = dict(radius=radius, page_type=c.config.page_type)
    kern_kw = dict(kw, walk=tpaged.plan_pages(c.config, radius))
    before = _route_count("split")
    ko, kl = tpaged._paged_attention_kernel(*args, **kern_kw)
    ko2, kl2 = tpaged._paged_attention_kernel(*args, **kern_kw)
    torch.cuda.synchronize()
    assert _route_count("split") == before + 2
    assert torch.equal(ko, ko2) and torch.equal(kl, kl2)
    split = _plan(q, c, radius=radius)
    qb = q.to(torch.bfloat16) if out == "float32" else q
    pargs = (qb, *args[1:])
    po, pl = tpaged._paged_attention_plain(*pargs, **kw, split_pages=split)
    _assert_paged_close((ko, kl), (po, pl))
    one, _ = tpaged._paged_attention_plain(*pargs, **kw)
    assert float((po.float() - one.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32", "int4",
                                   "fp8"])
def test_paged_fused_append_matches_b3_then_b2(gen, dtype):
    """paged_attention(new_kv=...) on the card: one launch (the split
    route, no B3), pages and scales torch.equal to B3's plain append, o
    and lse within the bounds of the plain B3-then-B2 under the same
    plan (sized for the cache's walk, ``plan_pages``, whatever the
    bound); with pages_bound below a lane's walk the tail row is still
    written. Lanes 6–8 sit on the trash slot (a table row of zeros):
    pages other than the trash page are equal, and the real lanes
    match."""
    lens = [530, 64, 127, 1, 300, 2]
    kc = _cache(dtype, lens, 7, kvh=4, d=64, total=256, maxp=16, tables=16)
    kc.lengths[5] = 0  # an empty slot
    trash = 31
    kc.page_tables[trash] = 0
    pc = _copy(kc)
    slots = torch.tensor([0, 1, 2, 3, 4, 5, trash, trash, trash],
                         dtype=torch.int32, device="cuda")
    b = slots.shape[0]
    q = torch.randn(b, 8, 64, generator=gen, device="cuda").bfloat16()
    kn, vn = (torch.randn(b, 4, 64, generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    for bound in (16, 4):
        before = dict(kernels.LAUNCHES)
        ko, kl, _ = tpaged.paged_attention(q, kc, slots, new_kv=(kn, vn),
                                           pages_bound=bound, return_lse=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["paged_append"] == before["paged_append"]
        assert (kernels.LAUNCHES["paged_attention_split"]
                == before["paged_attention_split"] + 1)
        pt = pc.config.page_type
        tpaged._paged_append_plain(kn, vn, pc.k_pages, pc.v_pages,
                                   pc.k_scales, pc.v_scales, slots,
                                   pc.lengths, pc.page_tables, page_type=pt)
        qg = (q.float() * (64 ** -0.5 * tpaged.LOG2E)).bfloat16()
        qg = qg.reshape(b, 4, 2, 64)
        po, pl = tpaged._paged_attention_plain(
            qg, pc.k_pages, pc.v_pages, pc.k_scales, pc.v_scales, slots,
            pc.lengths, pc.page_tables, 1, bound, torch.bfloat16, True,
            split_pages=_plan(qg, pc),
            page_type=pt)
        pc.lengths.index_add_(0, slots.long(), torch.ones_like(slots))
        assert torch.equal(kc.lengths, pc.lengths)
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            a, w = getattr(kc, name), getattr(pc, name)
            if a is not None:
                assert torch.equal(a[:, 1:], w[:, 1:]), name
        real = slice(0, 6)
        _assert_paged_close((ko.reshape(b, 4, 2, 64)[real], kl.reshape(
            b, 4, 2)[real]), (po[real], pl[real]))
        assert torch.isfinite(kl).all()


def test_paged_split_calls_share_no_state(gen):
    """The split route's tickets live in each call's workspace, zeroed on
    the call's stream: calls on two streams at once, and a captured graph
    replayed beside eager calls on another stream, each give what one
    call alone gives, bitwise."""
    lens = (530 + torch.randint(0, 20, (16,), generator=gen,
                                device="cuda")).tolist()
    c = _cache("int8", lens, 8)
    slots = torch.arange(16, dtype=torch.int32, device="cuda")
    q = torch.randn(16, 8, 2, 128, generator=gen, device="cuda").bfloat16()
    args = (q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
            c.lengths, c.page_tables, 0, 16, torch.bfloat16, True)
    assert _plan(q, c) < 16  # several splits: the ticket combine runs
    kw = _kernel_kw(c)
    want = tpaged._paged_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = []
    for s in streams:
        with torch.cuda.stream(s):
            got += [tpaged._paged_attention_kernel(*args, **kw)
                    for _ in range(8)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tpaged._paged_attention_kernel(*args, **kw)
    graph.replay()
    with torch.cuda.stream(streams[0]):
        got += [tpaged._paged_attention_kernel(*args, **kw) for _ in range(8)]
    torch.cuda.synchronize()
    for o, lse in got + [captured]:
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_paged_verify_lanes_match_plain(gen, dtype):
    """decode_verify's B2 call: 4 slots × K 4 tokens on 16 lanes, each slot
    repeated on K consecutive lanes, visible lengths base + j + 1
    (``lengths_override``, no append), at the serving width; against the
    plain version under the same plan, as the other B2 cases."""
    lens = [530, 64, 301, 17]
    c = _cache(dtype, lens, 12)
    K = 4
    slots = torch.arange(4, dtype=torch.int32, device="cuda").repeat_interleave(K)
    base = torch.tensor(lens, dtype=torch.int32, device="cuda") - K
    vis = (base.repeat_interleave(K)
           + torch.arange(1, K + 1, dtype=torch.int32, device="cuda").repeat(4))
    q = (torch.randn(16, 8, 2, 128, generator=gen, device="cuda")
         * (128 ** -0.5 * tpaged.LOG2E)).bfloat16()
    _assert_paged_close(*_paged_pair(c, q, slots, bound=16,
                                     lengths_override=vis))


def test_round_graph_replays_match_eager_steps(gen):
    """A K-step round captured as one CUDA graph, replayed twice from the
    same state, gives the packed tokens and logprobs of the same K steps
    run eagerly, bitwise (a greedy and a temperature lane); the graph
    carries K launches of B2's split route with B3's append fused a
    layer."""
    from tpu_flash_torch.models import transformer as ttfm
    from tpu_flash_torch.serving import engine as teng

    cfg = ttfm.ModelConfig(vocab_size=512, dim=256, num_layers=2,
                           num_q_heads=4, num_kv_heads=2, head_dim=64)
    params = ttfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                              "cuda")
    eng = teng.Engine(params, cfg, CacheConfig(
        num_kv_heads=2, head_dim=64, page_size=16, total_pages=128,
        max_seqs=8, max_pages_per_seq=16, dtype="int8"),
        teng.EngineConfig(max_batch=4, decode_steps=4))
    for rid, n in enumerate((9, 30, 17)):
        eng.submit(teng.Request(rid=rid, prompt=list(range(1, n + 1)),
                                max_new_tokens=16, temperature=0.8 * (rid == 1),
                                top_k=20 * (rid == 1)))
    eng._admit()
    K = 4
    for slot in eng.running:
        assert eng._ensure_capacity(slot, ahead=K) == "ok"
    lanes, slots_np, toks_np, pos_np, samp_np, keys_np, _, _ = (
        eng._decode_composition())
    bound = eng._pages_bound(ahead=K)
    state = [(c.k_pages.clone(), c.v_pages.clone(), c.k_scales.clone(),
              c.v_scales.clone(), c.lengths.clone()) for c in eng.caches]

    def restore():
        for c, saved in zip(eng.caches, state):
            for t, s in zip((c.k_pages, c.v_pages, c.k_scales, c.v_scales,
                             c.lengths), saved):
                t.copy_(s)

    inputs = [torch.from_numpy(a).cuda() for a in (toks_np, pos_np, slots_np,
                                                   samp_np, keys_np)]
    want, ntok, npos = eng._round(K, bound, *inputs, None)
    restore()
    g = eng._round_graph(bound, K)
    assert g["launches"]["paged_attention_split"] == K * cfg.num_layers
    assert g["launches"]["paged_append_fused"] == K * cfg.num_layers
    for name, t in zip(("tokens", "positions", "slots", "samp", "keys"),
                       inputs):
        eng._static[name].copy_(t)
    got = []
    for _ in range(2):
        restore()
        g["graph"].replay()
        got.append(g["outs"][0].clone())
    torch.cuda.synchronize()
    for packed in got:
        assert torch.equal(packed, want)
    assert torch.equal(g["outs"][1], ntok) and torch.equal(g["outs"][2], npos)
    assert torch.isfinite(want[:, :, 1]).all()


@pytest.mark.parametrize("feature", ["moe", "lora", "lora_stale_ids"])
def test_moe_and_lora_rounds_match_one_token_steps(gen, feature):
    """A MoE model (8 experts, top-2, drop-free) and a LoRA bank over
    mixed adapter and base lanes, served greedily in async rounds of 4 as
    CUDA graphs, give the one-token engine's streams and logprobs bit for
    bit while lanes finish and are refilled (staggered lengths, more
    requests than lanes). Planted fault (``lora_stale_ids``): the rounds'
    adapter-id buffer loaded at the first round only parts the streams."""
    from tpu_flash_torch.models import lora as tlora
    from tpu_flash_torch.models import transformer as ttfm
    from tpu_flash_torch.serving import engine as teng

    moe = feature == "moe"
    cfg = ttfm.ModelConfig(vocab_size=512, dim=256, num_layers=2,
                           num_q_heads=4, num_kv_heads=2, head_dim=64,
                           moe_experts=8 if moe else 0, moe_top_k=2,
                           moe_capacity_factor=4.0)
    params = ttfm.init_params(cfg, gen, "cuda")
    bank = None
    if not moe:
        bank = tlora.init_lora_bank(cfg, 3, 8, gen, "cuda")
        for layer in bank:
            for e in layer.values():
                e["b"] = torch.randn(e["b"].shape, generator=gen,
                                     device="cuda").to(e["b"].dtype) * 0.1
    ccfg = CacheConfig(num_kv_heads=2, head_dim=64, page_size=16,
                       total_pages=256, max_seqs=8, max_pages_per_seq=16,
                       dtype="int8")
    reqs = [teng.Request(rid=i, prompt=list(range(1 + i, 20 + 3 * i)),
                         max_new_tokens=5 + 3 * i,
                         adapter_id=-1 if moe else i % 4 - 1)
            for i in range(9)]

    def serve(steps, stale=False):
        eng = teng.Engine(params, cfg, ccfg, teng.EngineConfig(
            max_batch=4, decode_steps=steps), lora=bank)
        if stale:
            real, loads = eng._load_static, [0]

            def load(arrays):
                loads[0] += 1
                real(arrays if loads[0] == 1 else
                     {k: v for k, v in arrays.items() if k != "aids"})

            eng._load_static = load
        for r in reqs:
            eng.submit(r)
        done = {f.rid: (f.tokens, f.logprobs) for f in eng.run()}
        return done, eng.graph_stats["replays"]

    want, _ = serve(1)
    got, replays = serve(4, stale=feature == "lora_stale_ids")
    assert replays > 0 and sorted(got) == sorted(want)
    same = all(got[r] == want[r] for r in want)
    assert same != (feature == "lora_stale_ids")


def test_kernels_reject_what_they_do_not_take(gen):
    """Unsupported shapes and types raise instead of falling back to a
    plain path: B1 and B4/B5 run head dim 264 (at width 512), a gradient
    at 320 flows through ``flash_attention``, and each raises above 512
    (ROADMAP A15c) before any launch; B1 raises on f16; B2 and B3 above
    512 (A15c)."""
    q = torch.randn(2, 64, 264, device="cuda")  # head_dim 264
    sched = tflash.build_schedule("causal", 64, 64, 256, 256)
    before = kernels.LAUNCHES["flash_fwd"]
    o, lse = tflash._flash_fwd_kernel(q, q, q, sched, 1, 1, True)
    assert kernels.LAUNCHES["flash_fwd"] == before + 1 and o.shape == q.shape
    wide = torch.randn(2, 64, 520, device="cuda")
    counts = dict(kernels.LAUNCHES)
    with pytest.raises(NotImplementedError, match="A15c"):
        tflash._flash_fwd_kernel(wide, wide, wide, sched, 1, 1, True)
    with pytest.raises(NotImplementedError, match="A15c"):
        tflash_bwd._flash_bwd_kernel(wide, wide, wide, wide, lse, wide, None,
                                     sched, 1, 1)
    wg = wide[None].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A15c"):
        tflash.flash_attention(wg, wg, wg, schedule="causal")
    assert kernels.LAUNCHES == counts  # each raised before a launch
    grads = tflash_bwd._flash_bwd_kernel(
        *(torch.randn(2, 64, 264, device="cuda") for _ in range(4)), lse,
        torch.randn(2, 64, 264, device="cuda"), None, sched, 1, 1)
    assert [tuple(g.shape) for g in grads] == [(2, 64, 264)] * 3
    qg = torch.randn(1, 2, 64, 320, device="cuda", requires_grad=True)
    counts = dict(kernels.LAUNCHES)
    tflash.flash_attention(qg, qg, qg, schedule="causal").sum().backward()
    assert qg.grad.shape == qg.shape and bool(torch.isfinite(qg.grad).all())
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.LAUNCHES[name] == counts[name] + 1, name
    q = q[..., :96]
    with pytest.raises(NotImplementedError):
        tflash._flash_fwd_kernel(q.half(), q.half(), q.half(), sched, 1, 1, True)
    c = _cache("int8", [100], 3, kvh=1, d=520, total=8, maxp=4, tables=4)
    slots = torch.zeros(1, dtype=torch.int32, device="cuda")
    new = torch.randn(1, 1, 520, device="cuda").bfloat16()
    with pytest.raises(NotImplementedError, match="A15c"):
        tpaged.paged_attention(torch.randn(1, 2, 520, device="cuda"), c, slots)
    with pytest.raises(NotImplementedError, match="A15c"):
        tpaged.fused_append(c, slots, new, new)


def _rel(a, b):
    """max |a − b| relative to max |b| (at least 1): the reference's
    backward gate (``tpu_flash/bench/sweep.py:396-403``)."""
    return float((a.float() - b.float()).abs().max()
                 / max(float(b.float().abs().max()), 1.0))


# (b, hq, hkv, n_q, n_kv, d, causal, dtype): the training shape, ragged
# causal, right-aligned causal, d 64 (where the reference's transposed
# kernels B10a/B10b fold into B4/B5), dense float32, and G 4 (B5 walks
# four q heads through one CTA's ring).
_BWD_CASES = [
    (4, 16, 8, 1024, 1024, 128, True, torch.bfloat16),
    (1, 16, 8, 1000, 1000, 128, True, torch.bfloat16),
    (1, 16, 8, 256, 1024, 128, True, torch.bfloat16),
    (1, 16, 8, 1024, 1024, 64, True, torch.bfloat16),
    (1, 16, 8, 300, 300, 128, False, torch.float32),
    (1, 32, 8, 1000, 1000, 128, True, torch.bfloat16),
]


def _bwd_args(gen, b, hq, hkv, n_q, n_kv, d, causal, dtype, dv=None):
    """Prescaled operands, the forward's o/lse, a random dO and dlse."""
    dv = d if dv is None else dv
    q = (torch.randn(b * hq, n_q, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k = torch.randn(b * hkv, n_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b * hkv, n_kv, dv, generator=gen, device="cuda").to(dtype)
    sched = tflash.build_schedule("causal" if causal else "dense", n_q, n_kv,
                                  256, 256)
    o, lse = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
    do = torch.randn(b * hq, n_q, dv, generator=gen, device="cuda").to(dtype)
    dlse = torch.randn(b * hq, n_q, generator=gen, device="cuda")
    return (q, k, v, o, lse, do, dlse, sched, hq, hkv)


def _slab_fault(sched, axis, start, size=64):
    """``sched`` with the keys (axis "kv") or queries ("q") in [start,
    start + size) seeing nothing: a planted fault for the plain backward."""
    class SlabFault:
        def visible(self, q_pos, k_pos):
            pos = k_pos if axis == "kv" else q_pos
            m = (pos < start) | (pos >= start + size)
            seen = sched.visible(q_pos, k_pos)
            return m if seen is None else seen & m

    return SlabFault()


@pytest.mark.parametrize("case", _BWD_CASES,
                         ids=["train", "ragged", "right_aligned", "d64",
                              "dense_f32", "gqa4"])
def test_flash_bwd_kernels_match_plain(gen, case):
    """B4/B5 vs the plain backward on the same o, lse, dO, dlse; two calls
    bitwise equal; each counter moves by one a call. bf16 1e-2 of the
    largest grad: both round P and dS to bf16 at the same points, but
    from scores summed in another order, so a rounding may fall one ulp
    (2⁻⁸) apart. float32 1e-4: summation order only. The plain backward
    with a middle slab of 64 keys (or of 64 queries) hidden must fail the
    same check on dq, dk and dv (on dk and dv): a kernel that dropped a
    tile's work would."""
    args = _bwd_args(gen, *case)
    before = dict(kernels.LAUNCHES)
    got = tflash_bwd._flash_bwd_kernel(*args)
    again = tflash_bwd._flash_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 2
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 2
    want = tflash_bwd._flash_bwd_plain(*args)
    tol = 1e-2 if case[7] == torch.bfloat16 else 1e-4
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name} differs between two calls"
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= tol, (name, _rel(a, w))
    q, k, sched = args[0], args[1], args[7]
    for axis, moved in (("kv", "qkv"), ("q", "kv")):
        n = k.shape[1] if axis == "kv" else q.shape[1]
        faulted = tflash_bwd._flash_bwd_plain(
            *args[:7], _slab_fault(sched, axis, n // 2), *args[8:])
        for name, a, f in zip("qkv", got, faulted):
            if name in moved:
                assert _rel(a, f) > tol, (axis, name, _rel(a, f))


# head and value dims other than 64 and 128: d 96 and 256 (B4's 32-row q
# tile and B5's 32-row kv tile), float32 at 256, dv 64 under d 96
_BWD_HEAD_DIMS = [(1, 16, 8, 1000, 1000, 96, True, torch.bfloat16),
                  (1, 16, 8, 1000, 1000, 256, True, torch.bfloat16),
                  (1, 4, 2, 300, 300, 256, False, torch.float32),
                  (1, 16, 8, 1000, 1000, 96, True, torch.bfloat16, 64)]


@pytest.mark.parametrize("case", _BWD_HEAD_DIMS,
                         ids=["d96", "d256", "d256_f32", "d96_dv64"])
def test_flash_bwd_kernels_head_dims_match_plain(gen, case):
    """B4/B5 at other head and value dims vs the plain backward, as
    :func:`test_flash_bwd_kernels_match_plain`."""
    test_flash_bwd_kernels_match_plain(gen, case)


# width 512 (flash_bwd_wide.cu): bf16 d 512, 512 with dv 256 (B5's upper
# half takes no dV), 320 and 264 (zero-padded), float32 512, GQA 4/2
_BWD_WIDE = [(1, 4, 2, 1000, 1000, 512, True, torch.bfloat16),
             (1, 4, 2, 1000, 1000, 512, True, torch.bfloat16, 256),
             (1, 4, 2, 1000, 1000, 320, True, torch.bfloat16),
             (1, 4, 2, 500, 500, 264, False, torch.bfloat16),
             (1, 4, 2, 300, 300, 512, True, torch.float32)]


@pytest.mark.parametrize("case", _BWD_WIDE, ids=[
    "d512", "d512_dv256", "d320", "d264_dense", "d512_f32"])
def test_flash_bwd_kernels_wide_match_plain(gen, case):
    """B4/B5 at width 512 vs the plain backward, as
    :func:`test_flash_bwd_kernels_match_plain` (bitwise repeat, the slab
    faults); and the plain backward with a grad's columns 256–511 zeroed
    fails the check on that grad: a kernel that dropped the upper half of
    its output would."""
    test_flash_bwd_kernels_match_plain(gen, case)
    args = _bwd_args(gen, *case)
    got = tflash_bwd._flash_bwd_kernel(*args)
    tol = 1e-2 if case[7] == torch.bfloat16 else 1e-4
    for name, a, w in zip("qkv", got, tflash_bwd._flash_bwd_plain(*args)):
        assert _rel(a, w) <= tol, (name, _rel(a, w))
        if w.shape[-1] > 256:
            hidden = w.clone()
            hidden[..., 256:] = 0
            assert _rel(a, hidden) > tol, name


# bf16 at widths 256 and 512 (flash_bwd_tc.cuh's TMA + wgmma kernels): GQA 4
# at d 256 (B5 sums four q heads in one CTA), and at 512 a ragged n off the
# 32-row step grid with dv 256 under dp (B5's upper half takes no dV)
_BWD_WIDE_TC = [((1, 32, 8, 1000, 1000, 256, True, torch.bfloat16), None),
                ((1, 4, 2, 1001, 1001, 512, True, torch.bfloat16, 256), "dp")]


@pytest.mark.parametrize("case,quant", _BWD_WIDE_TC,
                         ids=["d256_gqa4", "d512_dv256_dp_ragged"])
def test_flash_bwd_kernels_wide_tc_match_plain(gen, case, quant):
    """B4/B5 on bf16 at widths 256 and 512 vs the plain backward under the
    same quant, as :func:`test_flash_bwd_kernels_match_plain`: 1e-2 of the
    largest grad, two calls bitwise equal, each counter moving by one a
    call."""
    args = _bwd_args(gen, *case)
    before = dict(kernels.LAUNCHES)
    got = tflash_bwd._flash_bwd_kernel(*args, quant)
    again = tflash_bwd._flash_bwd_kernel(*args, quant)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 2
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 2
    want = tflash_bwd._flash_bwd_plain(*args, quant)
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name} differs between two calls"
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= 1e-2, (name, _rel(a, w))


def _device_kernels(fn):
    """Names of the device kernels one ``fn()`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("d", [256, 512])
def test_flash_bwd_wide_bf16_runs_tma_kernels(gen, d):
    """bf16 B4/B5 at widths 256 and 512 launch flash_bwd_tc.cuh's TMA +
    wgmma kernels (flash_bwd_dq_wide, flash_bwd_dkv_wide), by their device
    names under torch.profiler, and neither of the block kernels that once
    held them (flash_bwd_dq_kernel, flash_bwd_dkv_kernel: the bf16 WMMA
    route, then float32 alone, now deleted)."""
    args = _bwd_args(gen, 1, 4, 2, 300, 300, d, True, torch.bfloat16)
    names = _device_kernels(lambda: tflash_bwd._flash_bwd_kernel(*args))
    assert any("flash_bwd_dq_wide" in n for n in names), names
    assert any("flash_bwd_dkv_wide" in n for n in names), names
    assert not any("flash_bwd_dq_kernel" in n or "flash_bwd_dkv_kernel" in n
                   or "wmma" in n.lower() for n in names), names


@pytest.mark.parametrize("d", [32, 64, 128, 256, 320, 512])
def test_flash_bwd_f32_runs_tf32_kernels(gen, d):
    """float32 B4/B5 at head dims 32 (zero-padded to 64), 64, 128, 256, 320
    (zero-padded to 512) and 512 launch flash_bwd_f32.cuh's 3×TF32 kernels
    (flash_bwd_dq_f32, flash_bwd_dkv_f32; at 256 and 512 a cluster a tile),
    by their device names under torch.profiler, and none of the first port's FMA
    kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel, deleted) that held
    256 and 512 before."""
    args = _bwd_args(gen, 1, 4, 2, 300, 300, d, True, torch.float32)
    names = _device_kernels(lambda: tflash_bwd._flash_bwd_kernel(*args))
    assert any("flash_bwd_dq_f32" in n for n in names), names
    assert any("flash_bwd_dkv_f32" in n for n in names), names
    assert not any("flash_bwd_dq_kernel" in n or "flash_bwd_dkv_kernel" in n
                   for n in names), names


# float32 on the 3×TF32 kernels: d 64 and 128 causal, GQA 4 at a ragged n,
# and the int8 dp product at 128; the head dim split across a cluster at
# 256 and 512: causal, GQA 4 at a ragged n, a value dim below the head dim
# (the slices past it take no dV) and dp
_BWD_F32 = [((1, 16, 8, 1024, 1024, 64, True, torch.float32), None),
            ((1, 16, 8, 1024, 1024, 128, True, torch.float32), None),
            ((1, 32, 8, 1000, 1000, 128, True, torch.float32), None),
            ((1, 16, 8, 500, 500, 128, False, torch.float32), "dp"),
            ((1, 16, 8, 1024, 1024, 256, True, torch.float32), None),
            ((1, 32, 8, 1000, 1000, 256, True, torch.float32), None),
            ((1, 16, 8, 500, 500, 256, True, torch.float32, 128), None),
            ((1, 16, 8, 500, 500, 256, False, torch.float32), "dp"),
            ((1, 4, 2, 1000, 1000, 512, True, torch.float32), None),
            ((1, 8, 2, 777, 777, 512, True, torch.float32, 256), None),
            ((1, 4, 2, 500, 500, 512, True, torch.float32), "dp")]


def _rms(a, b):
    """root-mean-square of a − b relative to that of b"""
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("case,quant", _BWD_F32,
                         ids=["d64", "d128", "gqa4_ragged", "dp_dense",
                              "d256", "d256_gqa4_ragged", "d256_dv128",
                              "d256_dp_dense", "d512", "d512_gqa4_dv256",
                              "d512_dp"])
def test_flash_bwd_f32_tracks_tf32x3_model(gen, case, quant):
    """The float32 kernels against the plain backward through the model of
    their product (flash_bwd.tf32x3) and against the exact plain backward:
    within 1e-4 of the largest grad of each, and nearer the model than the
    exact path over the three grads (root-mean-square; both measures
    printed for each grad: at ~2e-6 the largest entry's error is as much
    the float32 sums' order as the split). The same kernels on one TF32
    pass (hi·hi alone) must fail the 1e-4 check against the exact path on
    each grad: the gate tells 3×TF32 from TF32. Two calls are bitwise
    equal (at 256 and 512 the cluster's partial sums are added in rank
    order)."""
    args = _bwd_args(gen, *case)
    got = tflash_bwd._flash_bwd_kernel(*args, quant)
    again = tflash_bwd._flash_bwd_kernel(*args, quant)
    for name, a, a2 in zip("qkv", got, again):
        assert torch.equal(a, a2), f"d{name} differs between two calls"
    exact = tflash_bwd._flash_bwd_plain(*args, quant)
    model = tflash_bwd._flash_bwd_plain(*args, quant,
                                        products=tflash_bwd.tf32x3)
    one = tflash_bwd._flash_bwd_kernel(*args, quant, tf32_passes=1)
    torch.cuda.synchronize()
    for name, a, e, m, o in zip("qkv", got, exact, model, one):
        to_model, to_exact = _rel(a, m), _rel(a, e)
        print(f"d{name}: max vs tf32x3 model {to_model:.3e}, vs exact "
              f"{to_exact:.3e}; rms vs model {_rms(a, m):.3e}, vs exact "
              f"{_rms(a, e):.3e}; one pass vs exact {_rel(o, e):.3e}")
        assert to_exact <= 1e-4 and to_model <= 1e-4, (name, to_exact, to_model)
        assert _rel(o, e) > 1e-4, (name, _rel(o, e))
    flat = [torch.cat([x.flatten() for x in xs]) for xs in (got, model, exact)]
    assert _rms(flat[0], flat[1]) < _rms(flat[0], flat[2]), (
        _rms(flat[0], flat[1]), _rms(flat[0], flat[2]))


@pytest.mark.parametrize("case", [_BWD_CASES[1], _BWD_CASES[4]],
                         ids=["ragged_bf16", "dense_f32"])
def test_flash_grads_match_oracle(gen, case):
    """Autograd through ``dense_fa`` (B1 then B4/B5) vs autograd through the
    f32 oracle: bf16 within the reference's gate, 2.5e-2 of the largest
    grad; float32 atol 3e-4 / rtol 1e-3 (``tests/test_grad.py``)."""
    b, hq, hkv, n_q, n_kv, d, causal, dtype = case
    q = torch.randn(b, hq, n_q, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, hkv, n_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, hkv, n_kv, d, generator=gen, device="cuda").to(dtype)
    w = torch.randn(b, hq, n_q, d, generator=gen, device="cuda")

    def grads(fn, g):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kx = [x.repeat_interleave(g, 1) for x in xs[1:]]
        (fn(xs[0], *kx).float() * w).sum().backward()
        return [x.grad for x in xs]

    before = dict(kernels.LAUNCHES)
    got = grads(lambda q_, k_, v_: tflash.dense_fa(q_, k_, v_, causal=causal),
                1)
    assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    want = grads(lambda q_, k_, v_: dense_dpa(q_, k_, v_, causal=causal)[0],
                 hq // hkv)
    for name, a, b_ in zip("qkv", got, want):
        if dtype == torch.bfloat16:
            assert _rel(a, b_) <= 2.5e-2, (name, _rel(a, b_))
        else:
            torch.testing.assert_close(a, b_, atol=3e-4, rtol=1e-3)


# Quantized attention (B6/B8 serving, B7): (q_dtype, kv_dtype, kv_scale,
# pv_quant, hq, hkv, n, d, causal). The headline modes at d 128, d 64 with
# GQA 16/8 and a ragged causal n (where the reference's B8 runs), the
# weight-only caches, e5m2 and the int8 P·V.
_SERVING_CASES = {
    "int8_token": ("int8", "int8", "token", False, 8, 8, 1024, 128, False),
    "fp8_tensor": ("float8_e4m3fn", "float8_e4m3fn", "tensor", False, 8, 8,
                   1024, 128, False),
    "fp8_token_causal": ("float8_e4m3fn", "float8_e4m3fn", "token", False,
                         16, 8, 1000, 128, True),
    "d64_int8_causal_gqa": ("int8", "int8", "token", False, 16, 8, 1000, 64,
                            True),
    "d64_fp8_tensor_gqa": ("float8_e4m3fn", "float8_e4m3fn", "tensor", False,
                           16, 8, 1000, 64, True),
    "weight_only_int8": (None, "int8", "token", False, 8, 8, 1024, 128, False),
    "weight_only_fp8": (None, "float8_e4m3fn", "tensor", False, 8, 8, 1024,
                        128, False),
    "fp8_e5m2_cache": ("float8_e4m3fn", "float8_e5m2", "tensor", False, 8, 8,
                       1024, 128, False),
    "int8_pv_quant": ("int8", "int8", "token", True, 8, 8, 1024, 128, False),
    # head and value dims other than 64 and 128 (the last entry is dv)
    "d96_fp8_tensor_gqa": ("float8_e4m3fn", "float8_e4m3fn", "tensor", False,
                           16, 8, 1000, 96, True, 96),
    "d256_fp8_token": ("float8_e4m3fn", "float8_e4m3fn", "token", False, 8,
                       8, 1000, 256, False, 256),
    "d256_int8_causal": ("int8", "int8", "token", False, 16, 8, 1000, 256,
                         True, 256),
    "d96_dv64_int8": ("int8", "int8", "token", False, 8, 8, 1000, 96, False,
                      64),
    "d256_dv128_weight_only": (None, "int8", "token", False, 8, 8, 1000, 256,
                               True, 128),
    "d40_dv200_pv_quant": ("int8", "int8", "token", True, 8, 8, 500, 40,
                           False, 200),
    # width 512: O's halves on the grid, kv tiles of 32
    "wide_d512_fp8_token_causal": ("float8_e4m3fn", "float8_e4m3fn", "token",
                                   False, 4, 2, 1000, 512, True, 512),
    "wide_d512_int8": ("int8", "int8", "token", False, 4, 2, 1000, 512, False,
                       512),
    "wide_d512_weight_only_int8": (None, "int8", "token", False, 4, 2, 1000,
                                   512, True, 512),
    "wide_d512_weight_only_fp8": (None, "float8_e4m3fn", "tensor", False, 4, 2,
                                  1000, 512, False, 512),
    "wide_d512_pv_quant": ("int8", "int8", "token", True, 4, 2, 1000, 512,
                           False, 512),
    "wide_d512_e5m2_cache": ("float8_e4m3fn", "float8_e5m2", "tensor", False,
                             4, 2, 1000, 512, False, 512),
    "wide_d320_fp8_tensor_causal": ("float8_e4m3fn", "float8_e4m3fn",
                                    "tensor", False, 4, 2, 1000, 320, True,
                                    320),
    "wide_d512_dv256_int8_causal": ("int8", "int8", "token", False, 4, 2,
                                    1000, 512, True, 256),
    "wide_d264_weight_only_pv_quant": (None, "int8", "token", True, 4, 2, 500,
                                       264, False, 264),
}


def _quant_inputs(gen, hq, hkv, n, d, dtype=torch.bfloat16, dv=None):
    return [torch.randn(1, h, n, dd, generator=gen, device="cuda").to(dtype)
            for h, dd in ((hq, d), (hkv, d), (hkv, d if dv is None else dv))]


def _assert_quant_close(ko, kl, po, pl):
    """Quantized kernel vs plain: each o entry within four bf16 ulps of its
    row's max |plain o| (both round P and o from float32 sums taken in
    another order; a row of zeros matches exactly) and within 2e-2; lse, in
    float32, within 1e-4 where finite, with the same -inf rows (the plain
    version sums fp8 products as the card's fp8 units do,
    ``flash_q.fp8_scores``). A kv tile left out or the V scales one channel
    off moves o by more than ten such ulps at the headline shape."""
    missed = _quant_misses(ko, kl, po, pl)
    assert not missed, missed


def _quant_misses(ko, kl, po, pl) -> list:
    """The rules of :func:`_assert_quant_close` that (ko, kl) break."""
    ko, po, kl, pl = ko.float().cpu(), po.float().cpu(), kl.cpu(), pl.cpu()
    top = po.abs().amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    diff = (ko - po).abs()
    fin = torch.isfinite(pl)
    missed = []
    if not bool((diff <= torch.where(top > 0, 4 * ulp, 0.0)).all()):
        missed.append("o beyond 4 row ulps")
    if float(diff.max()) > 2e-2:
        missed.append(f"o {float(diff.max())} > 2e-2")
    if not torch.equal(torch.isfinite(kl), fin):
        missed.append("lse finite on other rows")
    elif fin.any() and float((kl[fin] - pl[fin]).abs().max()) > 1e-4:
        missed.append(f"lse {float((kl[fin] - pl[fin]).abs().max())} > 1e-4")
    return missed


@pytest.mark.parametrize("name", list(_SERVING_CASES))
def test_serving_kernel_matches_plain(gen, name):
    """B6 (and the d 64 shapes of B8, and padded head dims) vs its plain
    version: the staged Q bytes (e4m3, int8, or the bf16 weight-only
    operand) and row factors equal; o and lse as :func:`_assert_quant_close`
    (int8 scores are exact on both sides; under pv_quant P's int8 rounding
    follows the same running max on both sides)."""
    from tpu_flash_torch.quant import serving_attn as tsa
    from tpu_flash_torch.quant.flash_q import f32

    (q_dtype, kv_dtype, kv_scale, pvq, hq, hkv, n, d, causal,
     *dv) = _SERVING_CASES[name]
    q, k, v = _quant_inputs(gen, hq, hkv, n, d, dv=(dv or [None])[0])
    kq, vq = tsa.quantize_kv_cache(k, v, kv_dtype, kv_scale=kv_scale)
    ops = tsa.serving_operands(q, kq, vq, bound_max=not pvq)
    sched = tflash.build_schedule("causal" if causal else "dense", n, n, 1024,
                                  2048)
    mode = {"int8": "int8", None: "raw"}.get(q_dtype, "fp8")
    args = (*ops, sched, hq, hkv, mode, f32(d ** -0.5 * tflash.LOG2E), pvq)
    before = kernels.LAUNCHES["serving_attention"]
    ko, kl, q_op, qs = tsa._serving_attention_kernel(*args, True, staged=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["serving_attention"] == before + 1
    skf = 1.0 if ops[4] is None else ops[4].repeat_interleave(
        hq // hkv)[:, None, None]
    p_op, p_qs = tsa._stage_q_plain(ops[0], mode, f32(d ** -0.5 * tflash.LOG2E),
                                    skf)
    assert q_op.dtype == p_op.dtype and q_op.shape == p_op.shape
    if q_op.element_size() == 1:
        assert torch.equal(q_op.view(torch.uint8), p_op.view(torch.uint8))
    else:
        assert torch.equal(q_op.view(torch.int16), p_op.view(torch.int16))
    assert (qs is None) == (p_qs is None)
    if p_qs is not None:
        assert torch.equal(qs, p_qs)
    po, pl = tsa._serving_plain(*args)
    _assert_quant_close(ko, kl, po, pl)


@pytest.mark.parametrize("q_dtype,kv_dtype,kv_scale,causal", [
    ("int8", "int8", "token", False), ("float8_e4m3fn", "float8_e4m3fn",
                                       "tensor", False),
    ("float8_e4m3fn", "float8_e4m3fn", "token", True),
    (None, "int8", "token", True)])
def test_quant_kernel_matches_plain(gen, q_dtype, kv_dtype, kv_scale, causal,
                                    d=128, dv=128):
    """B7 through ``quantized_flash_attention`` at d 128, GQA 16/8: the
    kernel on CUDA tensors vs the plain path on the same tensors moved to
    the CPU, as :func:`_assert_quant_close`."""
    from tpu_flash_torch.quant import flash_q as tfq

    q, k, v = _quant_inputs(gen, 16, 8, 1000, d, dv=dv)
    kw = dict(q_dtype=q_dtype, kv_dtype=kv_dtype, kv_scale=kv_scale,
              schedule="causal" if causal else "dense", return_lse=True)
    before = kernels.LAUNCHES["quant_attention"]
    ko, kl = tfq.quantized_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quant_attention"] == before + 1
    po, pl = tfq.quantized_flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    _assert_quant_close(ko, kl.reshape(16, -1), po, pl.reshape(16, -1))


@pytest.mark.parametrize("q_dtype,kv_dtype,kv_scale,causal,d,dv", [
    ("float8_e4m3fn", "float8_e4m3fn", "token", True, 96, 96),
    ("int8", "int8", "token", False, 256, 256),
    ("float8_e4m3fn", "float8_e5m2", "tensor", False, 256, 128),
    (None, "float8_e4m3fn", "token", True, 96, 64)])
def test_quant_kernel_head_dims_match_plain(gen, q_dtype, kv_dtype, kv_scale,
                                            causal, d, dv):
    """B7 at other head and value dims (zero-padded to a compiled width)
    vs its plain version, as :func:`test_quant_kernel_matches_plain`."""
    test_quant_kernel_matches_plain(gen, q_dtype, kv_dtype, kv_scale, causal,
                                    d, dv)


@pytest.mark.parametrize("q_dtype,kv_dtype,kv_scale,causal,d,dv", [
    ("float8_e4m3fn", "float8_e4m3fn", "token", True, 512, 512),
    ("int8", "int8", "token", False, 512, 512),
    (None, "int8", "token", True, 512, 512),
    ("float8_e4m3fn", "float8_e5m2", "tensor", False, 320, 320),
    ("float8_e4m3fn", "float8_e4m3fn", "tensor", True, 512, 256)])
def test_quant_kernel_wide_head_dims_match_plain(gen, q_dtype, kv_dtype,
                                                 kv_scale, causal, d, dv):
    """B7 at width 512 vs its plain version, as
    :func:`test_quant_kernel_matches_plain`."""
    test_quant_kernel_matches_plain(gen, q_dtype, kv_dtype, kv_scale, causal,
                                    d, dv)


def test_quant_kernels_wide_upper_half_fault_rejected(gen):
    """B6 at width 512 against its plain version with V's columns 256–511
    zeroed: the check must fail (a CTA that dropped O's upper half)."""
    from tpu_flash_torch.quant import serving_attn as tsa
    from tpu_flash_torch.quant.flash_q import f32

    q, k, v = _quant_inputs(gen, 4, 2, 1000, 512)
    kq, vq = tsa.quantize_kv_cache(k, v, "float8_e4m3fn")
    ops = tsa.serving_operands(q, kq, vq, True)
    sched = tflash.build_schedule("causal", 1000, 1000, 1024, 2048)
    args = (*ops, sched, 4, 2, "fp8", f32(512 ** -0.5 * tflash.LOG2E), False)
    ko, kl = tsa._serving_attention_kernel(*args, True)
    _assert_quant_close(ko, kl, *tsa._serving_plain(*args))
    hidden = ops[2].clone()
    hidden.view(torch.uint8)[..., 256:] = 0
    assert _quant_misses(ko, kl, *tsa._serving_plain(
        *args[:2], hidden, *args[3:]))


def test_quant_kernels_reject_what_they_do_not_take(gen):
    """Head dim 520 raises (ROADMAP A15c) before any launch, where 264 runs
    at width 512; an fp8 cache under int8 Q and f16 inputs raise, never
    fall back."""
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    for d in (264, 520):
        q, k, v = _quant_inputs(gen, 2, 2, 64, d)
        kq, vq = tsa.quantize_kv_cache(k, v, "int8")
        counts = dict(kernels.LAUNCHES)
        calls = (lambda: tsa.serving_flash_attention(q, kq, vq, q_dtype="int8"),
                 lambda: tfq.quantized_flash_attention(q, k, v),
                 lambda: tflash.flash_attention(q, k, v, q_dtype="int8"))
        for call in calls:
            if d == 520:
                with pytest.raises(NotImplementedError, match="A15c"):
                    call()
            else:
                assert call().shape == q.shape
        if d == 520:
            assert kernels.LAUNCHES == counts  # each raised before a launch
        else:
            assert kernels.LAUNCHES["serving_attention"] == \
                counts["serving_attention"] + 1
            assert kernels.LAUNCHES["quant_attention"] == \
                counts["quant_attention"] + 2
    q, k, v = _quant_inputs(gen, 2, 2, 64, 128)
    kq, vq = tsa.quantize_kv_cache(k, v, "float8_e4m3fn")
    ops = tsa.serving_operands(q, kq, vq, True)
    sched = tflash.build_schedule("dense", 64, 64, 1024, 2048)
    with pytest.raises(NotImplementedError):
        tsa._serving_attention_kernel(*ops, sched, 2, 2, "int8", 0.1, False,
                                      False)
    with pytest.raises(NotImplementedError):
        tfq.quantized_flash_attention(q.half(), k.half(), v.half())


# (schedule, radius, section) of the quantized route's band kinds: the
# smoke's small windows (radius 8; sections of 100, several to a kv tile and
# none aligned to it) and windows wider than a kv tile
_QUANT_BANDS = [("local", 8, 0), ("local_causal", 8, 0), ("circulant", 8, 0),
                ("block", 0, 100), ("local", 200, 0), ("local_causal", 300, 0),
                ("circulant", 150, 0), ("block", 0, 384)]
# (q_dtype, kv_dtype, kv_scale, bound_max)
_QUANT_BAND_MODES = [("int8", "int8", "token", True),
                     ("float8_e4m3fn", "float8_e4m3fn", "tensor", False),
                     ("float8_e4m3fn", "float8_e4m3fn", "token", True),
                     (None, "int8", "token", False)]


@pytest.mark.parametrize("mode", _QUANT_BAND_MODES, ids=[
    f"{m[0] or 'weight_only'}-{m[2]}-{'bound' if m[3] else 'exact'}"
    for m in _QUANT_BAND_MODES])
@pytest.mark.parametrize("family", ["serving", "quant"])
@pytest.mark.parametrize("band", _QUANT_BANDS, ids=[
    f"{b[0]}-{b[1] or b[2]}" for b in _QUANT_BANDS])
def test_quant_band_kernels_match_plain(gen, band, family, mode, d=128):
    """B6 (serving, the circulant over the cache and its phantom rows) and
    B7 (the circulant over halo-extended K/V) on the band, circulant and
    block-diagonal kinds vs their plain versions, at a ragged n (1000) with
    GQA 16/8, d 128: o and lse as :func:`_assert_quant_close`, B6's staged
    Q bytes equal."""
    from tpu_flash_torch.bench.quant_bands import band_case

    schedule, radius, section = band
    q_dtype, kv_dtype, kv_scale, bound = mode
    q, k, v = _quant_inputs(gen, 16, 8, 1000, d)
    kernel, plain, staged = band_case(
        family, schedule, q, k, v, q_dtype=q_dtype, kv_dtype=kv_dtype,
        kv_scale=kv_scale, bound_max=bound, radius=radius, section=section)
    name = "serving_attention" if family == "serving" else "quant_attention"
    before = kernels.LAUNCHES[name]
    ko, kl = kernel()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    if staged is not None:
        assert staged()
    _assert_quant_close(ko, kl, *plain())


@pytest.mark.parametrize("mode", _QUANT_BAND_MODES, ids=[
    f"{m[0] or 'weight_only'}-{m[2]}-{'bound' if m[3] else 'exact'}"
    for m in _QUANT_BAND_MODES])
@pytest.mark.parametrize("family", ["serving", "quant"])
@pytest.mark.parametrize("band", [*_QUANT_BANDS[:4], _QUANT_BANDS[5]], ids=[
    f"{b[0]}-{b[1] or b[2]}" for b in [*_QUANT_BANDS[:4], _QUANT_BANDS[5]]])
def test_quant_band_kernels_wide_match_plain(gen, band, family, mode):
    """B6 and B7 at width 512 on the band, circulant and block-diagonal
    kinds, as :func:`test_quant_band_kernels_match_plain`."""
    test_quant_band_kernels_match_plain(gen, band, family, mode, d=512)


@pytest.mark.parametrize("case", [
    ("local_causal", 8, 0, dict(q_dtype="float8_e4m3fn", d=64)),
    ("block", 0, 250, dict(q_dtype="int8", d=64)),
    ("circulant", 8, 0, dict(q_dtype=None, d=64)),
    ("local", 8, 0, dict(q_dtype="int8", pv_quant=True, d=128))],
    ids=["local_causal-d64", "block-d64", "circulant-d64", "local-pv_quant"])
def test_serving_band_kernel_variants_match_plain(gen, case):
    """B6 at d 64 (the reference's transposed B8 shape) on the band kinds,
    and under pv_quant (int8 P·V, exact max), vs its plain version."""
    from tpu_flash_torch.bench.quant_bands import band_case

    schedule, radius, section, kw = case
    kw = dict(kw)
    q_dtype, d, pvq = kw["q_dtype"], kw["d"], kw.get("pv_quant", False)
    kv_dtype = "int8" if q_dtype in ("int8", None) else q_dtype
    q, k, v = _quant_inputs(gen, 16, 8, 1000, d)
    kernel, plain, _ = band_case(
        "serving", schedule, q, k, v, q_dtype=q_dtype, kv_dtype=kv_dtype,
        bound_max=not pvq, radius=radius, section=section, pv_quant=pvq)
    _assert_quant_close(*kernel(), *plain())


@pytest.mark.parametrize("family", ["serving", "quant"])
@pytest.mark.parametrize("band", _QUANT_BANDS[:4], ids=[
    b[0] for b in _QUANT_BANDS[:4]])
def test_quant_band_faults_rejected(gen, band, family):
    """Planted faults in the plain version (the radius one too large, the
    sections shifted by one row, the circulant without its halo, serving's
    circulant without its phantom rows) fail the kernel-vs-plain check."""
    from tpu_flash_torch.bench.quant_bands import band_case, faults

    schedule, radius, section = band
    q, k, v = _quant_inputs(gen, 16, 8, 1000, 128)
    kernel, plain, _ = band_case(
        family, schedule, q, k, v, q_dtype="float8_e4m3fn",
        kv_dtype="float8_e4m3fn", radius=radius, section=section)
    ko, kl = kernel()
    _assert_quant_close(ko, kl, *plain())
    for fault in faults(family, schedule):
        assert _quant_misses(ko, kl, *plain(fault)), fault


# B6/B7's persistent kernel on every kind it walks: (schedule, options),
# bands wider and narrower than a kv tile, sections several to a tile, a
# shifted hop inside the shard and a wrapped causal one
_PERSISTENT_KINDS = [
    ("dense", {}), ("causal", {}), ("local", dict(radius=200)),
    ("local_causal", dict(radius=8)), ("circulant", dict(radius=150)),
    ("block", dict(section=100)), ("shifted", dict(shift=700, radius=200)),
    ("shifted", dict(shift=900, radius=150, wrap_n=1000,
                     shifted_causal=True))]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", _QUANT_BAND_MODES, ids=[
    f"{m[0] or 'weight_only'}-{m[2]}-{'bound' if m[3] else 'exact'}"
    for m in _QUANT_BAND_MODES])
@pytest.mark.parametrize("family", ["serving", "quant"])
@pytest.mark.parametrize("kind", _PERSISTENT_KINDS, ids=[
    f"{k[0]}-{i}" for i, k in enumerate(_PERSISTENT_KINDS)])
def test_persistent_kernel_every_kind_mode_width(gen, kind, family, mode, d):
    """B6 and B7 on every schedule kind × score mode (int8, e4m3 under the
    norm bound and the exact max, weight-only) × width 64, 128, 256, at a
    ragged n (1000) with GQA 4/2, vs their plain versions as
    :func:`_assert_quant_close`; B6's staged Q bytes equal; two calls equal
    bit for bit (the work list fixes each tile's sums)."""
    from tpu_flash_torch.bench.quant_bands import band_case

    schedule, options = kind
    q_dtype, kv_dtype, kv_scale, bound = mode
    q, k, v = _quant_inputs(gen, 4, 2, 1000, d)
    kernel, plain, staged = band_case(
        family, schedule, q, k, v, q_dtype=q_dtype, kv_dtype=kv_dtype,
        kv_scale=kv_scale, bound_max=bound, **options)
    ko, kl = kernel()
    again = kernel()
    torch.cuda.synchronize()
    assert torch.equal(ko, again[0]) and torch.equal(kl, again[1])
    if staged is not None:
        assert staged()
    _assert_quant_close(ko, kl, *plain())


@pytest.mark.parametrize("family", ["serving", "quant"])
@pytest.mark.parametrize("shape", [(17, 1, 1000, 1000), (3, 3, 100, 100),
                                   (6, 2, 1000, 1300), (2, 1, 129, 129)],
                         ids=["items_past_the_ctas", "n_q_below_a_tile",
                              "ragged_cross", "one_row_tile"])
def test_persistent_kernel_work_counts(gen, shape, family):
    """The persistent kernel where the work items (b·h × q tiles) are no
    multiple of the CTAs (17 × 8 = 136 on 132 SMs), n_q under one q tile,
    a ragged last tile against a longer kv (causal, right-aligned) and a
    last tile of one row: vs the plain version, e4m3 under the bound and
    int8 under the exact max."""
    from tpu_flash_torch.bench.quant_bands import band_case

    hq, hkv, n_q, n_kv = shape
    q = torch.randn(1, hq, n_q, 128, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(1, hkv, n_kv, 128, generator=gen, device="cuda")
            .bfloat16() for _ in "kv")
    for q_dtype, kv_scale, bound in (("float8_e4m3fn", "tensor", True),
                                     ("int8", "token", False)):
        kernel, plain, _ = band_case(
            family, "causal", q, k, v, q_dtype=q_dtype, kv_dtype=q_dtype,
            kv_scale=kv_scale, bound_max=bound)
        _assert_quant_close(*kernel(), *plain())


@pytest.mark.parametrize("family", ["serving", "quant"])
def test_persistent_kernel_graph_replay_matches_eager(gen, family):
    """A CUDA graph of the kernel's calls replays its work list from the
    device: the replay's o and lse equal the eager calls' before and after
    it, bit for bit."""
    from tpu_flash_torch.bench.quant_bands import band_case

    q, k, v = _quant_inputs(gen, 16, 8, 1000, 128)
    kernel, _, _ = band_case(family, "local_causal", q, k, v,
                             q_dtype="float8_e4m3fn",
                             kv_dtype="float8_e4m3fn", radius=200)
    want = kernel()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [kernel() for _ in range(3)]
    graph.replay()
    graph.replay()
    after = kernel()
    torch.cuda.synchronize()
    for o, lse in captured + [after]:
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.fixture(scope="module")
def fresh_quant_names():
    """bench/quant_bench.py --names in a process of its own: the device
    kernels of one call of each timed B6/B7 row's instantiation (a long
    process's traces have come back empty on the card)."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = {}
    for _ in range(3):  # a row whose traces all came back empty: again
        out = subprocess.run(
            [sys.executable, "-m", "tpu_flash_torch.bench.quant_bench",
             "--names"], cwd=root, capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PYTHONPATH=root))
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        names.update({row: n for row, n in got.items()
                      if n or not names.get(row)})
        if all(names.values()):
            break
    return names


@pytest.mark.parametrize("row", [r[0] for r in quant_bench.NAME_ROWS])
def test_quant_kernels_run_the_persistent_kernel(fresh_quant_names, row):
    """B6 and B7 launch csrc/quant_attention.cu's persistent kernel
    (quant_attention_persistent), by its device name under torch.profiler,
    and never the one-CTA-a-tile kernel it replaced
    (quant_attention_kernel), on the instantiation of every timed row
    (the headline's, rows a–e, pv_quant, width 512, B8's shape); B6 runs
    its staging pass (quant_stage_q) before it."""
    names = fresh_quant_names[row]
    assert any("quant_attention_persistent" in n for n in names), names
    assert not any("quant_attention_kernel" in n for n in names), names
    family = next(r[1] for r in quant_bench.NAME_ROWS if r[0] == row)
    assert any("quant_stage_q" in n for n in names) == (family == "serving")


# (schedule, radius or section, n, d, bound_max, dtype): the circulant band
# (halo-extended K/V) and the block-diagonal schedule at d 64 and 128, ragged
# n, sections that are 64-multiples (64, 256), span a 64-row tile boundary
# (192), sit several to a tile (16), are no multiple of a 128-row kv tile
# (96, 320) or straddle a 128-row q tile (320)
_B1_NEW_KINDS = [
    ("circulant", 512, 2048, 128, None, torch.bfloat16),
    ("circulant", 64, 1000, 64, False, torch.bfloat16),
    ("circulant", 100, 777, 128, True, torch.float32),
    ("circulant", 0, 300, 64, None, torch.bfloat16),
    ("block", 64, 1024, 128, None, torch.bfloat16),
    ("block", 192, 960, 64, None, torch.bfloat16),
    ("block", 256, 1000, 128, True, torch.float32),
    ("block", 16, 512, 64, None, torch.bfloat16),
    ("block", 96, 1000, 128, None, torch.bfloat16),
    ("block", 320, 1000, 64, True, torch.bfloat16),
]


@pytest.mark.parametrize("case", _B1_NEW_KINDS, ids=[
    f"{c[0]}-{c[1]}-n{c[2]}-d{c[3]}-{str(c[5])[6:]}" for c in _B1_NEW_KINDS])
def test_flash_kernel_circulant_and_block_match_plain(gen, case):
    """B1's circulant (B11's circulant half) and block-diagonal kinds vs the
    plain version (16 q / 8 kv heads): o bf16 2e-2, f32 1e-4, lse 1e-4
    where finite, as the other B1 cases."""
    schedule, extra, n, d, bound, dtype = case
    hq, hkv = 16, 8
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k = torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
    if schedule == "circulant":
        sched = tflash.build_schedule("circulant", n, n, 512, 1024, radius=extra)
        if extra:
            k = torch.cat([k[:, -extra:], k, k[:, :extra]], dim=1)
            v = torch.cat([v[:, -extra:], v, v[:, :extra]], dim=1)
    else:
        sched = tflash.build_schedule("block", n, n, 1024, 2048, section=extra)
    if bound is None:
        bound = tflash.auto_bound_max(sched)
    before = kernels.LAUNCHES["flash_fwd"]
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True, bound)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    _assert_b1_close(ko, kl, po, pl, dtype)


# The TMA + wgmma kernels' edges: every schedule kind at d 64, 128 and 256
# in bf16, and at d 64, 128, 256 and 512 in float32 (3×TF32; the head dim
# split across a 2- or 4-CTA cluster at 256 and 512), both max modes, at
# (n, batch) = (129, 1) (one partial q tile), (1000, 1) (ragged; bf16 takes
# 64-row q tiles, since 128-row ones would leave SMs idle) and (1024, 3)
# (128-row q tiles at d <= 128); bands of radius 129, the circulant's 100,
# sections of 96 (no multiple of a kv tile)
_TC_KINDS = [("dense", 0), ("causal", 0), ("local", 129), ("local_causal", 129),
             ("circulant", 100), ("block", 96)]
_B1_WIDTHS = [(64, torch.bfloat16), (128, torch.bfloat16),
              (256, torch.bfloat16), (64, torch.float32),
              (128, torch.float32), (256, torch.float32),
              (512, torch.float32)]
_B1_WIDTH_IDS = ["64", "128", "256", "f32-64", "f32-128", "f32-256",
                 "f32-512"]


@pytest.mark.parametrize("n,batch", [(129, 1), (1000, 1), (1024, 3)],
                         ids=["n129", "n1000", "n1024-b3"])
@pytest.mark.parametrize("bound", [False, True], ids=["exact", "bound"])
@pytest.mark.parametrize("d,dtype", _B1_WIDTHS, ids=_B1_WIDTH_IDS)
@pytest.mark.parametrize("kind", _TC_KINDS, ids=[k[0] for k in _TC_KINDS])
def test_flash_kernel_every_kind_matches_plain(gen, kind, d, dtype, bound, n,
                                               batch):
    """B1's kernels vs the exact plain version on every kind, width and max
    mode: o 2e-2 (bf16) or 1e-4 (float32), lse 1e-4 where finite, the same
    rows fully masked."""
    schedule, extra = kind
    hq, hkv = 16, 8
    q = (torch.randn(batch * hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k, v = (torch.randn(batch * hkv, n, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    if schedule == "circulant":
        extra = min(extra, (n - 1) // 2)  # the window fits the sequence
        k, v = (torch.cat([x[:, -extra:], x, x[:, :extra]], dim=1) for x in (k, v))
    sched = tflash.build_schedule(schedule, n, n, 512, 1024, radius=extra
                                  if schedule != "block" else 0,
                                  section=extra if schedule == "block" else 0)
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True, bound)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
    _assert_b1_close(ko, kl, po, pl, dtype)


@pytest.mark.parametrize("bound", [False, True], ids=["exact", "bound"])
@pytest.mark.parametrize("d,dtype", _B1_WIDTHS, ids=_B1_WIDTH_IDS)
def test_flash_kernel_right_aligned_matches_plain(gen, d, dtype, bound):
    """Causal, right-aligned: the last 256 of 1024 queries, every width,
    dtype and max mode."""
    hq, hkv = 16, 8
    q = (torch.randn(hq, 256, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k, v = (torch.randn(hkv, 1024, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    sched = tflash.build_schedule("causal", 256, 1024, 256, 256)
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True, bound)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
    _assert_b1_close(ko, kl, po, pl, dtype)


def _b1_f32_args(gen, d, n=777, hq=8, hkv=2, dv=None):
    """float32 B1 operands at head dim ``d`` (value dim ``dv``), causal,
    GQA 4 at a ragged n."""
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E))
    k = torch.randn(hkv, n, d, generator=gen, device="cuda")
    v = torch.randn(hkv, n, dv or d, generator=gen, device="cuda")
    return q, k, v, tflash.build_schedule("causal", n, n, 256, 256), hq, hkv


_B1_F32_DIMS = [32, 64, 128, 256, 320, 512]
# one float32 B1 call at each of _B1_F32_DIMS traced by torch.profiler in a
# process of its own (a long test process's traces can come back empty):
# the device kernels' names of each, one JSON line
_TRACE_B1_F32 = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from tpu_flash_torch.ops import flash
names = {}
for d in %r:
    q, k, v = (torch.randn(h, 777, d, device="cuda") for h in (8, 2, 2))
    sched = flash.build_schedule("causal", 777, 777, 256, 256)
    flash._flash_fwd_kernel(q, k, v, sched, 8, 2, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        flash._flash_fwd_kernel(q, k, v, sched, 8, 2, True)
        torch.cuda.synchronize()
    names[d] = sorted(e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps(names))
""" % (_B1_F32_DIMS,)


@pytest.fixture(scope="module")
def b1_f32_kernel_names():
    """{d: device kernels of one float32 B1 call} (_TRACE_B1_F32)."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _TRACE_B1_F32], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=root), check=True)
    return {int(d): n for d, n in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize("d", _B1_F32_DIMS)
def test_flash_f32_runs_tf32_kernel(gen, b1_f32_kernel_names, d):
    """float32 B1 at head dims 32 (zero-padded to 64), 64, 128, 256, 320
    (zero-padded to 512) and 512 launches flash_fwd_f32.cuh's 3×TF32 kernel
    (flash_fwd_tf32<columns a CTA, CTAs a cluster>: the whole width at 64
    and 128, a 128-column slice a CTA of a 2- or 4-CTA cluster at 256 and
    512), by its device name under torch.profiler (traced in a process of
    its own), counted once a call, and never the first port's FMA kernel
    (flash_fwd_f32<, deleted) or the bf16 one."""
    width = tflash.kernel_head_dim(d, d)
    want = f"flash_fwd_tf32<{min(width, 128)}, {max(1, width // 128)}>"
    names = b1_f32_kernel_names[d]
    assert any(want in n for n in names), names
    assert not any("flash_fwd_f32<" in n or "flash_fwd_tc" in n
                   for n in names), names
    args = _b1_f32_args(gen, d)
    before = kernels.LAUNCHES["flash_fwd"]
    tflash._flash_fwd_kernel(*args, True)
    assert kernels.LAUNCHES["flash_fwd"] == before + 1


@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (256, 256),
                                  (256, 100), (512, 512), (512, 256)])
@pytest.mark.parametrize("bound", [False, True], ids=["exact", "bound"])
def test_flash_f32_bitwise_repeatable(gen, d, dv, bound):
    """Two float32 B1 calls are equal bit for bit, o and lse (no atomics; at
    256 and 512 the cluster's partial scores are added in rank order), and
    a value dim below the head dim (the slices past it write no o) gives
    the exact plain version's o within 1e-4."""
    args = _b1_f32_args(gen, d, dv=dv)
    a = tflash._flash_fwd_kernel(*args, True, bound)
    b = tflash._flash_fwd_kernel(*args, True, bound)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape[-1] == dv
    _assert_b1_close(*a, *tflash._flash_fwd_plain(*args, bound),
                     torch.float32)


@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("bound", [False, True], ids=["exact", "bound"])
def test_flash_f32_one_tf32_pass_rejected(gen, d, bound):
    """The float32 kernel on one TF32 pass (hi·hi alone, the checks'
    planted fault) misses the 1e-4 kernel-vs-plain check on o or lse at
    every width, so the check tells 3×TF32 from TF32; ``tf32_passes``
    other than 3 and 1, or 1 on bf16, raises."""
    args = _b1_f32_args(gen, d)
    po, pl = tflash._flash_fwd_plain(*args, bound)
    fo, fl = tflash._flash_fwd_kernel(*args, True, bound, tf32_passes=1)
    fin = torch.isfinite(pl)
    assert max(float((fo - po).abs().max()),
               float((fl[fin] - pl[fin]).abs().max())) > 1e-4
    with pytest.raises(ValueError, match="tf32_passes=2"):
        tflash._flash_fwd_kernel(*args, True, bound, tf32_passes=2)
    q, k, v, *rest = args
    with pytest.raises(ValueError, match="tf32_passes=1"):
        tflash._flash_fwd_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 *rest, True, bound, tf32_passes=1)


def test_circulant_and_block_public_calls_match_oracle(gen):
    """circulant_fa and 2-D block_fa on the card vs the f32 oracles
    (circulant_dpa, block_dpa): bf16 2.5e-2, the sweep's gate."""
    from tpu_flash_torch.ops.oracle import block_dpa, circulant_dpa

    q, k, v = (torch.randn(1, 4, 1000, 64, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    o, lse = tflash.circulant_fa(q, k, v, 129, return_lse=True)
    oo, ol = circulant_dpa(q, k, v, 129)
    assert float((o.float() - oo.float()).abs().max()) <= 2.5e-2
    assert float((lse - ol).abs().max()) <= 2.5e-2
    q, k, v = (torch.randn(1, 32, 32, 4, 64, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    got = tflash.block_fa(q, k, v, (8, 16))
    assert float((got.float() - block_dpa(q, k, v, (8, 16)).float())
                 .abs().max()) <= 2.5e-2


# B4/B5's band, circulant and block-diagonal kinds: (schedule, radius or
# section) at a ragged n 300 (1000 for the wider band) with GQA 4/2, in each
# family: (width, dtype) = bf16 64, 128 and 256 (TMA + wgmma), float32
# (3×TF32; 256 a cluster a tile); dp where it applies (widths 128 and 256)
_BWD_KINDS = [("local", 40), ("local_causal", 40), ("circulant", 20),
              ("block", 64), ("local_causal", 512)]
_BWD_FAMILIES = [(64, torch.bfloat16), (128, torch.bfloat16),
                 (256, torch.bfloat16), (64, torch.float32),
                 (128, torch.float32), (256, torch.float32)]


def _kind_args(gen, schedule, width, n, d, dtype, hq=4, hkv=2):
    """Prescaled operands under ``schedule`` (circulant K/V halo-extended),
    the forward kernel's o/lse, a random dO and dlse."""
    sched = tflash.build_schedule(schedule, n, n, 512, 1024,
                                  radius=0 if schedule == "block" else width,
                                  section=width if schedule == "block" else 0)
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k, v = (torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    if schedule == "circulant":
        k, v = (torch.cat([x[:, -width:], x, x[:, :width]], 1) for x in (k, v))
    o, lse = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
    do = torch.randn(hq, n, d, generator=gen, device="cuda").to(dtype)
    dlse = torch.randn(hq, n, generator=gen, device="cuda")
    return (q, k, v, o, lse, do, dlse, sched, hq, hkv)


@pytest.mark.parametrize("dp", [False, True], ids=["exact", "dp"])
@pytest.mark.parametrize("family", _BWD_FAMILIES,
                         ids=[f"{w}_{str(t)[6:]}" for w, t in _BWD_FAMILIES])
@pytest.mark.parametrize("kind", _BWD_KINDS,
                         ids=[f"{k}_{w}" for k, w in _BWD_KINDS])
def test_flash_bwd_kernels_every_kind_match_plain(gen, kind, family, dp):
    """B4/B5 on the local, local_causal, circulant and block-diagonal kinds
    in each family, with and without dp, vs the plain backward under the
    same quant: bf16 1e-2, float32 1e-4 of the largest grad (as
    :func:`test_flash_bwd_kernels_match_plain`); two calls bitwise equal;
    each counter moves by one a call. dp at width 64 is the flag ignored:
    the grads equal the unquantized kernel's."""
    (schedule, width), (d, dtype) = kind, family
    n = 1000 if width == 512 else 300
    args = _kind_args(gen, schedule, width, n, d, dtype)
    quant = "dp" if dp else None
    before = dict(kernels.LAUNCHES)
    got = tflash_bwd._flash_bwd_kernel(*args, quant)
    again = tflash_bwd._flash_bwd_kernel(*args, quant)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 2
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 2
    want = tflash_bwd._flash_bwd_plain(*args, quant)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name} differs between two calls"
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= tol, (name, _rel(a, w))
    if dp and d == 64:
        for a, b in zip(got, tflash_bwd._flash_bwd_kernel(*args)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dp", [False, True], ids=["exact", "dp"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", [("causal", 0), *_BWD_KINDS], ids=[
    "causal", *(f"{k}_{w}" for k, w in _BWD_KINDS)])
def test_flash_bwd_kernels_wide_every_kind_match_plain(gen, kind, dtype, dp):
    """B4/B5 at width 512 on the causal, band, circulant and block kinds,
    with and without dp, as :func:`test_flash_bwd_kernels_every_kind_match_plain`."""
    test_flash_bwd_kernels_every_kind_match_plain(gen, kind, (512, dtype), dp)


@pytest.mark.parametrize("fa", ["sliding", "circulant", "block"])
def test_band_grads_match_oracle(gen, fa):
    """Autograd through ``sliding_fa`` (causal), ``circulant_fa`` (the halo's
    gradient folded back by autograd) and ``block_fa`` (B1 then B4/B5) vs
    autograd through the f32 oracles: bf16 within the reference's gate,
    2.5e-2 of the largest grad."""
    from tpu_flash_torch.ops.oracle import block_dpa, circulant_dpa, sliding_dpa

    q, k, v = (torch.randn(1, 4, 1000, 64, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    w = torch.randn(1, 4, 1000, 64, generator=gen, device="cuda")
    calls = {
        "sliding": (lambda a, b, c: tflash.sliding_fa(a, b, c, 129, causal=True),
                    lambda a, b, c: sliding_dpa(a, b, c, 129, causal=True)[0]),
        "circulant": (lambda a, b, c: tflash.circulant_fa(a, b, c, 129),
                      lambda a, b, c: circulant_dpa(a, b, c, 129)[0]),
        "block": (lambda a, b, c: tflash.block_fa(a, b, c, 200),
                  lambda a, b, c: block_dpa(
                      *(x.transpose(1, 2) for x in (a, b, c)), (200,))
                  .transpose(1, 2)),
    }

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs).float() * w).sum().backward()
        return [x.grad for x in xs]

    before = kernels.LAUNCHES["flash_bwd_dkv"]
    got = grads(calls[fa][0])
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before + 1
    for name, a, b in zip("qkv", got, grads(calls[fa][1])):
        assert _rel(a, b) <= 2.5e-2, (name, _rel(a, b))


# The ring hop's shifted kinds at a shard of n (ragged 1000, 1024): (name,
# shift as (multiple of n, rows), radius, wrap_n as a multiple of n,
# causal): a forward band hop (rows past the band see no key), the hop from
# a later rank (negative shift), the circulant ring's wrapped hop, the wrap
# within one shard (two runs of keys a row), shifted_causal with a band and
# without one (300 rows see no key)
_SHIFTED = [("band_forward", (1, 0), 300, 0, False),
            ("band_backward", (-1, 0), 300, 0, False),
            ("circulant_wrapped", (3, 0), 300, 4, False),
            ("two_runs", (0, 0), 200, 1, False),
            ("causal_band", (0.5, 0), 200, 0, True),
            ("causal_no_band", (0, -300), -1, 0, True)]


def _shifted_sched(hop, n):
    """The shifted Schedule of a hop in ``_SHIFTED`` over shards of n."""
    _, (of_n, rows), radius, wrap, causal = hop
    shift = int(of_n * n) + rows
    return tflash.build_schedule("shifted", n, n, 512, 1024, shift=shift,
                                 radius=radius, wrap_n=wrap * n,
                                 shifted_causal=causal)


@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("bound", [False, True], ids=["exact", "bound"])
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (128, torch.float32)],
                         ids=["64_bf16", "128_bf16", "256_bf16", "128_f32"])
@pytest.mark.parametrize("hop", _SHIFTED, ids=[h[0] for h in _SHIFTED])
def test_flash_kernel_shifted_matches_plain(gen, hop, d, dtype, bound, n):
    """B1 on the shifted kinds (the norm bound at d 64 is B9's shape) vs
    the plain version, 16/8 heads: o bf16 2e-2, f32 1e-4, lse 1e-4 where
    finite, the same rows seeing no key (o 0, lse −inf)."""
    hq, hkv = 16, 8
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k, v = (torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    sched = _shifted_sched(hop, n)
    before = kernels.LAUNCHES["flash_fwd"]
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True, bound)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv, bound)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    _assert_b1_close(ko, kl, po, pl, dtype)
    assert bool((ko[~torch.isfinite(kl)] == 0).all())


_BWD_SHIFTED_FAMILIES = [*_BWD_FAMILIES, (512, torch.float32)]


@pytest.mark.parametrize("family", _BWD_SHIFTED_FAMILIES, ids=[
    f"{w}_{str(t)[6:]}" for w, t in _BWD_SHIFTED_FAMILIES])
@pytest.mark.parametrize("hop", _SHIFTED, ids=[h[0] for h in _SHIFTED])
def test_flash_bwd_kernels_shifted_match_plain(gen, hop, family):
    """B4/B5 on the shifted kinds in each family (bf16 64/128/256 wgmma,
    float32 3×TF32 at 64/128 and, a cluster a tile, 256/512) with an lse
    cotangent, GQA 4/2 at a ragged shard of 1000, vs the plain backward:
    bf16 1e-2, float32 1e-4 of the largest grad; two calls bitwise
    equal."""
    d, dtype = family
    n, hq, hkv = 1000, 4, 2
    sched = _shifted_sched(hop, n)
    q = (torch.randn(hq, n, d, generator=gen, device="cuda")
         * (d ** -0.5 * tflash.LOG2E)).to(dtype)
    k, v = (torch.randn(hkv, n, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    o, lse = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
    do = torch.randn(hq, n, d, generator=gen, device="cuda").to(dtype)
    dlse = torch.randn(hq, n, generator=gen, device="cuda")
    args = (q, k, v, o, lse, do, dlse, sched, hq, hkv)
    got = tflash_bwd._flash_bwd_kernel(*args)
    again = tflash_bwd._flash_bwd_kernel(*args)
    want = tflash_bwd._flash_bwd_plain(*args)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, a2, w in zip("qkv", got, again, want):
        assert torch.equal(a, a2), f"d{name} differs between two calls"
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= tol, (name, _rel(a, w))


# (q_dtype, kv_dtype, d): the quantized families on the shifted kinds: B7
# fp8, int8 and weight-only; B6 (serving) fp8 and int8, and at d 64 (B8)
_SHIFTED_QUANT = [("quant", "float8_e4m3fn", "float8_e4m3fn", 128),
                  ("quant", "int8", "int8", 128),
                  ("quant", None, "int8", 128),
                  ("serving", "float8_e4m3fn", "float8_e4m3fn", 128),
                  ("serving", "int8", "int8", 128),
                  ("serving", "int8", "int8", 64)]


@pytest.mark.parametrize("mode", _SHIFTED_QUANT, ids=[
    f"{m[0]}-{m[1] or 'weight_only'}-d{m[3]}" for m in _SHIFTED_QUANT])
@pytest.mark.parametrize("hop", _SHIFTED, ids=[h[0] for h in _SHIFTED])
def test_quant_shifted_kernels_match_plain(gen, hop, mode):
    """B6/B7 on the shifted kinds under the norm bound (the quantized
    ring's hop) vs their plain versions, 16/8 heads, a ragged shard of
    1000: as :func:`_assert_quant_close`, rows seeing no key o 0 and lse
    −inf; B6's staged Q bytes equal."""
    from tpu_flash_torch.bench.quant_bands import band_case

    family, q_dtype, kv_dtype, d = mode
    sched = _shifted_sched(hop, 1000)
    q, k, v = _quant_inputs(gen, 16, 8, 1000, d)
    kernel, plain, staged = band_case(
        family, "shifted", q, k, v, q_dtype=q_dtype, kv_dtype=kv_dtype,
        radius=sched.radius, shift=sched.shift, wrap_n=sched.wrap_n,
        shifted_causal=sched.causal)
    ko, kl = kernel()
    if staged is not None:
        assert staged()
    _assert_quant_close(ko, kl, *plain())
    assert bool((ko[~torch.isfinite(kl)] == 0).all())


@pytest.mark.parametrize("family", [(512, torch.bfloat16),
                                    (512, torch.float32)],
                         ids=["512_bf16", "512_f32"])
@pytest.mark.parametrize("hop", _SHIFTED, ids=[h[0] for h in _SHIFTED])
def test_flash_bwd_kernels_wide_shifted_match_plain(gen, hop, family):
    """B4/B5 at width 512 on the shifted kinds, as
    :func:`test_flash_bwd_kernels_shifted_match_plain`."""
    test_flash_bwd_kernels_shifted_match_plain(gen, hop, family)


@pytest.mark.parametrize("mode", [m[:3] + (512,) for m in _SHIFTED_QUANT[:5]],
                         ids=[f"{m[0]}-{m[1] or 'weight_only'}"
                              for m in _SHIFTED_QUANT[:5]])
@pytest.mark.parametrize("hop", _SHIFTED, ids=[h[0] for h in _SHIFTED])
def test_quant_shifted_kernels_wide_match_plain(gen, hop, mode):
    """B6/B7 at width 512 on the shifted kinds, as
    :func:`test_quant_shifted_kernels_match_plain`."""
    test_quant_shifted_kernels_match_plain(gen, hop, mode)


@pytest.mark.parametrize("family", ["b1", "serving", "quant"])
@pytest.mark.parametrize("hop", [_SHIFTED[1], _SHIFTED[3]],
                         ids=["band_backward", "two_runs"])
def test_shifted_faults_rejected(gen, hop, family):
    """Planted faults in the plain versions (the shift one row off; the
    wrapped band's second run of keys dropped) fail the kernel-vs-plain
    checks of B1 and of B6/B7."""
    import dataclasses

    from tpu_flash_torch.bench.quant_bands import band_case, faults

    sched = _shifted_sched(hop, 1024)
    if family == "b1":
        hq, hkv, d = 16, 8, 128
        q = (torch.randn(hq, 1024, d, generator=gen, device="cuda")
             * (d ** -0.5 * tflash.LOG2E)).bfloat16()
        k, v = (torch.randn(hkv, 1024, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
        _assert_b1_close(ko, kl, *tflash._flash_fwd_plain(q, k, v, sched, hq,
                                                          hkv), torch.bfloat16)
        for fault in faults("b1", "shifted", sched.wrap_n):
            bad = dataclasses.replace(sched, **(
                dict(shift=sched.shift + 1) if fault == "shift"
                else dict(wrap_n=0)))
            with pytest.raises(AssertionError):
                _assert_b1_close(ko, kl, *tflash._flash_fwd_plain(
                    q, k, v, bad, hq, hkv), torch.bfloat16)
        return
    q, k, v = _quant_inputs(gen, 16, 8, 1024, 128)
    kernel, plain, _ = band_case(
        family, "shifted", q, k, v, q_dtype="float8_e4m3fn",
        kv_dtype="float8_e4m3fn", radius=sched.radius, shift=sched.shift,
        wrap_n=sched.wrap_n, shifted_causal=sched.causal)
    ko, kl = kernel()
    _assert_quant_close(ko, kl, *plain())
    for fault in faults(family, "shifted", sched.wrap_n):
        assert _quant_misses(ko, kl, *plain(fault)), fault


# (shape, axis, dtype, scale): both sides of the one-pass threshold (rows of
# 16384 / 16385, columns of 512 / 513), 3-D inputs, bf16, extreme values
_SOFTMAX_CASES = [
    ((37, 500), -1, torch.float32, 3.0),
    ((64, 16384), -1, torch.float32, 3.0),
    ((64, 16385), -1, torch.float32, 3.0),
    ((8, 70000), -1, torch.float32, 3.0),
    ((300, 40), -2, torch.float32, 3.0),
    ((512, 96), -2, torch.float32, 3.0),
    ((513, 96), -2, torch.float32, 3.0),
    ((2, 5000, 130), -2, torch.float32, 3.0),
    ((3, 5, 300), -1, torch.float32, 3.0),
    ((4, 7, 9), 0, torch.float32, 3.0),
    ((64, 3000), -1, torch.bfloat16, 3.0),
    ((700, 33), -2, torch.bfloat16, 3.0),
    ((16, 70000), -1, torch.float32, 50.0),
    ((5000, 200), 0, torch.float32, 50.0),
]


@pytest.mark.parametrize("case", _SOFTMAX_CASES, ids=[
    f"{'x'.join(map(str, c[0]))}-ax{c[1]}-{str(c[2])[6:]}-s{c[3]:g}"
    for c in _SOFTMAX_CASES])
def test_softmax_kernels_match_plain(gen, case):
    """fused_softmax through the kernels vs its plain versions on the same
    input (f32 2e-6, bf16 1e-2), each kernel called alone vs its own plain
    version, fibers summing to 1 (f32 1e-5) and finite at scale 50."""
    from tpu_flash_torch.ops import softmax as sm

    shape, axis, dtype, scale = case
    x = (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)
    counts = {k: kernels.LAUNCHES[k] for k in ("softmax_onepass",
                                               "softmax_stats", "softmax_norm")}
    got = sm.fused_softmax(x, axis=axis)
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES[k] - c for k, c in counts.items()) >= 1
    tol = 2e-6 if dtype == torch.float32 else 1e-2
    assert torch.isfinite(got).all()
    assert float((got.float() - sm._fused_softmax(x, axis, True).float())
                 .abs().max()) <= tol
    if dtype == torch.float32:
        assert float((got.double().sum(dim=axis) - 1).abs().max()) <= 1e-5
    ax = axis % x.ndim  # the (L, n, m) view fused_softmax takes
    x3 = (x.reshape(-1, *x.shape[-2:]) if ax == x.ndim - 2
          else x.movedim(ax, -1).reshape(-1, x.shape[ax], 1))
    lse = sm._stats_kernel(x3)
    assert float((lse - sm._stats_plain(x3)).abs().max()) <= 1e-5
    assert float((sm._norm_kernel(x3, lse).float()
                  - sm._norm_plain(x3, lse).float()).abs().max()) <= tol
    if sm.onepass_fits(x3.shape[1], x3.shape[2]):
        assert float((sm._onepass_kernel(x3).float()
                      - sm._onepass_plain(x3).float()).abs().max()) <= tol


@pytest.mark.parametrize("m,k,n,dtype", [
    (256, 256, 256, torch.float32), (300, 130, 70, torch.float32),
    (300, 130, 70, torch.bfloat16), (1024, 512, 256, torch.bfloat16),
    (4000, 1000, 3000, torch.bfloat16), (257, 129, None, torch.bfloat16),
    (512, 4096, 512, torch.float32)])
def test_matmul_kernel_matches_plain(gen, m, k, n, dtype):
    """B14 vs its plain version (k-chunked float32 products), square and
    ragged (k and n not multiples of 8 take the element loads), bf16 and
    float32, and a matvec: relative to the largest |plain| entry, bf16
    2^-7 (one bf16 ulp of it: two roundings of float32 sums taken in other
    orders differ by at most that) and float32 1e-5 (summation order)."""
    from tpu_flash_torch.ops import matmul as mm

    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(*((k,) if n is None else (k, n)), generator=gen,
                    device="cuda").to(dtype)
    before = kernels.LAUNCHES["matmul"]
    got = mm.matvec(a, b) if n is None else mm.matmul(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["matmul"] == before + 1
    want = mm._matmul_plain(a, b[:, None] if n is None else b, dtype)
    want = want[:, 0] if n is None else want
    tol = 2 ** -7 + 1e-5 if dtype == torch.bfloat16 else 1e-5
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * top
    f32 = mm.matmul(a, b[:, None] if n is None else b, out_dtype=torch.float32)
    assert f32.dtype == torch.float32


# (m, k, n, in dtype, out dtype, route): the wgmma route at 4096 × 512 ×
# 4096 and the ragged 4000 × 1000 × 3000 (m, k and n no multiples of its
# 128 × 256 × 64 tiles), bf16 and float32 out, and a small ragged shape; the
# wmma route at k % 8 != 0; gemv at 16384 × 4096, at ragged m and k (rows
# that start off 16 bytes) and in float32; the fma route square, at n % 4
# != 0 and with bf16 out; k = 0 on every route
_ROUTE_CASES = [
    (4096, 512, 4096, torch.bfloat16, torch.bfloat16, "wgmma"),
    (4096, 512, 4096, torch.bfloat16, torch.float32, "wgmma"),
    (4000, 1000, 3000, torch.bfloat16, torch.bfloat16, "wgmma"),
    (4000, 1000, 3000, torch.bfloat16, torch.float32, "wgmma"),
    (333, 200, 136, torch.bfloat16, torch.bfloat16, "wgmma"),
    (300, 130, 72, torch.bfloat16, torch.bfloat16, "wmma"),
    (16384, 4096, 1, torch.bfloat16, torch.bfloat16, "gemv"),
    (1001, 4099, 1, torch.bfloat16, torch.float32, "gemv"),
    (777, 333, 1, torch.float32, torch.float32, "gemv"),
    (1000, 500, 300, torch.float32, torch.float32, "fma"),
    (130, 70, 66, torch.float32, torch.float32, "fma"),
    (513, 257, 129, torch.float32, torch.bfloat16, "fma"),
    (64, 0, 64, torch.bfloat16, torch.bfloat16, "wgmma"),
    (64, 0, 66, torch.bfloat16, torch.float32, "wmma"),
    (64, 0, 1, torch.bfloat16, torch.bfloat16, "gemv"),
    (64, 0, 64, torch.float32, torch.float32, "fma"),
]


@pytest.mark.parametrize("m,k,n,dtype,out_dtype,route", _ROUTE_CASES, ids=[
    f"{c[5]}-{c[0]}x{c[1]}x{c[2]}-{str(c[3])[6:]}-{str(c[4])[6:]}"
    for c in _ROUTE_CASES])
def test_matmul_routes_match_plain(gen, m, k, n, dtype, out_dtype, route):
    """B14 on each route vs its plain version, one launch a call: bf16 out
    within 2^-7 of the largest |plain| entry (one ulp of it), float32 out
    within 1e-5 of it (summation order), the sweep's and the smoke's
    limits; k = 0 gives zeros."""
    from tpu_flash_torch.bench.sweep import TOL_MATMUL
    from tpu_flash_torch.ops import matmul as mm

    assert mm._matmul_route(m, n, k, dtype) == route
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
    before = kernels.LAUNCHES["matmul"]
    got = mm.matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["matmul"] == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    if k == 0:
        assert torch.equal(got, torch.zeros_like(got))
        return
    want = mm._matmul_plain(a, b, out_dtype)
    tol = TOL_MATMUL[out_dtype]
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * top


def test_primitive_kernels_reject_what_they_do_not_take(gen):
    from tpu_flash_torch.ops import matmul as mm
    from tpu_flash_torch.ops import softmax as sm

    with pytest.raises(NotImplementedError):
        sm._onepass_kernel(torch.zeros(2, 8, 1, device="cuda",
                                       dtype=torch.float16))
    with pytest.raises(ValueError, match="one-pass"):
        sm._onepass_kernel(torch.zeros(1, 20000, 1, device="cuda"))
    with pytest.raises(NotImplementedError):
        mm.matmul(torch.zeros(4, 4, device="cuda"),
                  torch.zeros(4, 4, device="cuda", dtype=torch.bfloat16))
    # the C entry refuses a route the shape or dtype does not fit: wgmma
    # where TMA cannot describe n (130 bf16 is no 16-byte pitch), gemv for
    # two columns, fma for bf16
    from tpu_flash_torch.kernels import _build

    a = torch.zeros(8, 16, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(16, 130, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(8, 130, device="cuda", dtype=torch.bfloat16)
    stream = kernels.stream_handle(a)
    lib = _build.library()
    for n, route in ((130, "wgmma"), (2, "gemv"), (2, "fma")):
        assert lib.tf_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), 8, n, 16,
                             1, 1, mm.MATMUL_ROUTES[route], stream) != 0
