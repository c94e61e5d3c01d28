"""B2 and B3 at the serving shapes, one JSON line each: the device time of
one call (a CUDA graph of 20 calls, ``harness.device_ms``) and its event
time with the host's launches (20 calls after 3).

    python -m tpu_flash_torch.bench.paged_bench

Shapes (``chip_smoke.py``'s): the decode (16 lanes of 530–549 tokens, 8
kv heads, G 2, d 128, page 64, pages_bound 16), the pipelined band (16
lanes of 1100–2031 tokens, radius 512) and the chunk prefix (512 lanes of
one slot, positions 1536–2047, radius 512), each on every page type (the
band and the chunk prefix on the quantized ones). Each is
timed as the kernel's wrapper alone (q prescaled to bf16) and, for the
decode and the band, as the public call that appends the new token and
attends (``paged_attention(new_kv=...)``, ``paged_attention_pipelined``),
and B3 alone (``fused_append``). It calls only what every checkout of the
port has had since the chunk prefix came in (the page type goes to the
wrapper where it takes one; a page type the checkout's cache refuses
prints a ``skipped`` line), so the same script times an older checkout on
``PYTHONPATH`` beside this one. Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import json

import torch


def _cache(dtype, lens, seed, dev):
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache

    cfg = CacheConfig(num_kv_heads=8, head_dim=128, page_size=64,
                      total_pages=1024, max_seqs=32, max_pages_per_seq=64,
                      dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = PagedKVCache.create(cfg, dev)
    perm = torch.randperm(1023, generator=gen, device=dev) + 1
    c.page_tables[: len(lens), :32] = perm[: len(lens) * 32].reshape(-1, 32).int()
    for s, n in enumerate(lens):
        c.write_prompt(s, torch.randn(8, n, 128, generator=gen, device=dev),
                       torch.randn(8, n, 128, generator=gen, device=dev))
    return c


def _call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the page types, in the order they are timed
DTYPES = ("int8", "bfloat16", "int4", "fp8")


def main() -> int:
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.ops import paged

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    kern = paged._paged_attention_kernel
    params = inspect.signature(kern).parameters
    # the chunk prefix's own route, where the checkout has one
    shared = ({"shared_page_table": True} if "shared_page_table" in params
              else {})
    scale = 128 ** -0.5 * paged.LOG2E

    def emit(case, fn):
        print(json.dumps(dict(case=case, ms=device_ms(fn), call_ms=_call_ms(fn),
                              device=torch.cuda.get_device_name(0))),
              flush=True)

    def args(q, c, slots, len_add, bound):
        return (q, c.k_pages, c.v_pages, c.k_scales, c.v_scales, slots,
                c.lengths, c.page_tables, len_add, bound, torch.bfloat16, True)

    def page_kw(c, radius=None):
        # the page type and the split plan's walk (the public call's,
        # plan_pages), where the checkout's wrapper takes them
        kw = ({"page_type": c.config.page_type} if "page_type" in params
              else {})
        if "walk" in params:
            kw["walk"] = paged.plan_pages(c.config, radius)
        return kw

    def cache(dtype, lens, seed):
        try:
            return _cache(dtype, lens, seed, dev)
        except (NotImplementedError, ValueError) as e:
            print(json.dumps(dict(case=dtype, skipped=str(e))), flush=True)
            return None

    with torch.no_grad():
        slots = torch.arange(16, dtype=torch.int32, device=dev)
        q = torch.randn(16, 16, 128, generator=gen, device=dev).bfloat16()
        qg = (q.float() * scale).bfloat16().reshape(16, 8, 2, 128)
        kn, vn = (torch.randn(16, 8, 128, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
        lens = (530 + torch.randint(0, 20, (16,), generator=gen,
                                    device=dev)).tolist()
        band = (1100 + torch.randint(0, 932, (16,), generator=gen,
                                     device=dev)).tolist()
        qp = torch.randn(512, 8, 2, 128, generator=gen, device=dev).bfloat16()
        pos = torch.arange(1536, 2048, dtype=torch.int32, device=dev)
        lanes = torch.zeros(512, dtype=torch.int32, device=dev)
        for dtype in DTYPES:
            c = cache(dtype, lens, 3)
            if c is None:
                continue
            emit(f"decode_{dtype}_kernel",
                 lambda: kern(*args(qg, c, slots, 1, 16), **page_kw(c)))
            emit(f"decode_{dtype}_call", lambda: paged.paged_attention(
                q, c, slots, new_kv=(kn, vn), pages_bound=16, return_lse=True))
            emit(f"append_{dtype}",
                 lambda: paged.fused_append(c, slots, kn, vn))
        for dtype in DTYPES:
            if dtype == "bfloat16":
                continue
            tag = "" if dtype == "int8" else f"_{dtype}"
            c = cache(dtype, band, 10)
            if c is None:
                continue
            emit(f"band_kernel{tag}",
                 lambda: kern(*args(qg, c, slots, 1, 10), radius=512,
                              **page_kw(c, 512)))
            emit(f"band_call{tag}", lambda: paged.paged_attention_pipelined(
                q, c, slots, new_kv=(kn, vn), radius=512, return_lse=True))
            c = cache(dtype, [1536], 9)
            emit(f"chunk_prefix_kernel{tag}",
                 lambda: kern(*args(qp, c, lanes, 0, 10), radius=512,
                              positions=pos, **shared, **page_kw(c, 512)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
