"""The port's CUDA kernels (B1 flash forward, B2 paged attention, B3 paged
append) against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports only torch and the port, so it also
runs where the reference's framework is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from tpu_flash_torch import kernels
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import paged as tpaged

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
def test_flash_kernel_matches_plain(gen, causal, n_q, n_kv, dtype):
    """B1 kernel vs plain at the serving head layout (16 q heads, 8 kv
    heads, d 128). bf16 2e-2: P rounds to bf16 against the tile's running
    max in the kernel and the row max in the plain version. f32 1e-4:
    summation order only."""
    hq, hkv, d = 16, 8, 128
    q = torch.randn(hq, n_q, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(hkv, n_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(hkv, n_kv, d, generator=gen, device="cuda").to(dtype)
    sched = tflash.build_schedule("causal" if causal else "dense", n_q, n_kv,
                                  256, 256)
    before = kernels.LAUNCHES["flash_fwd"]
    ko, kl = tflash._flash_fwd_kernel(q, k, v, sched, hq, hkv, True)
    po, pl = tflash._flash_fwd_plain(q, k, v, sched, hq, hkv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((ko.float() - po.float()).abs().max()) <= tol
    fin = torch.isfinite(pl)
    assert torch.equal(torch.isfinite(kl), fin)
    assert float((kl[fin] - pl[fin]).abs().max()) <= tol


def _cache(dtype, lens, seed):
    cfg = CacheConfig(num_kv_heads=8, head_dim=128, page_size=64,
                      total_pages=1024, max_seqs=32, max_pages_per_seq=64,
                      dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = PagedKVCache.create(cfg, "cuda")
    perm = torch.randperm(1023, generator=g, device="cuda") + 1
    c.page_tables[: len(lens), :16] = perm[: len(lens) * 16].reshape(-1, 16).int()
    for s, n in enumerate(lens):
        c.write_prompt(s, torch.randn(8, n, 128, generator=g, device="cuda"),
                       torch.randn(8, n, 128, generator=g, device="cuda"))
    return c


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_paged_kernels_match_plain(gen, dtype):
    """B3 then B2 at the serving decode shape (16 lanes, 8 kv heads, G 2,
    d 128, page 64, ~540 tokens, pages_bound 16). Pages and scales after the
    append are bit-exact; outputs within 2e-2 (bf16 P either side,
    summation order)."""
    lens = (530 + torch.randint(0, 20, (16,), generator=gen, device="cuda")).tolist()
    kc, pc = _cache(dtype, lens, 1), _cache(dtype, lens, 1)
    slots = torch.arange(16, dtype=torch.int32, device="cuda")
    kn = torch.randn(16, 8, 128, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(16, 8, 128, generator=gen, device="cuda").bfloat16()

    def append_args(c):
        return (kn, vn, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
                c.lengths, c.page_tables)

    before = dict(kernels.LAUNCHES)
    tpaged._paged_append_kernel(*append_args(kc))
    tpaged._paged_append_plain(*append_args(pc))
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(kc, name), getattr(pc, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    q = torch.randn(16, 8, 2, 128, generator=gen, device="cuda").bfloat16()
    args = (q, kc.k_pages, kc.v_pages, kc.k_scales, kc.v_scales, slots,
            kc.lengths, kc.page_tables, 1, 16, torch.bfloat16, True)
    ko, kl = tpaged._paged_attention_kernel(*args)
    po, pl = tpaged._paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_append"] == before["paged_append"] + 1
    assert kernels.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    assert float((ko.float() - po.float()).abs().max()) <= 2e-2
    assert float((kl - pl).abs().max()) <= 2e-2


def test_kernels_reject_what_they_do_not_take(gen):
    """Unsupported shapes raise instead of falling back to a plain path."""
    q = torch.randn(2, 64, 96, device="cuda")  # head_dim 96
    sched = tflash.build_schedule("causal", 64, 64, 256, 256)
    with pytest.raises(NotImplementedError):
        tflash._flash_fwd_kernel(q, q, q, sched, 1, 1, True)
    with pytest.raises(NotImplementedError):
        tflash._flash_fwd_kernel(q.half(), q.half(), q.half(), sched, 1, 1, True)
