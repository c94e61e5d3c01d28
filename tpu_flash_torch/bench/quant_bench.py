"""B6 and B7 (and B8's shape) at the rows that time them, one JSON line:
the device time of one kernel wrapper call (a CUDA graph of 20 calls,
``harness.device_ms``) of each row, beside one library call of the same
function in bf16 and a hash of the row's o and lse. The library calls are
``chip_smoke.py``'s yardsticks (``sdpa``, ``qb_library``, ``hop_mask``),
imported from the checkout's root: the port itself never calls a library
attention. Without that script the rows carry no library time.

    python -m tpu_flash_torch.bench.quant_bench [--rows a,d,...]
    python -m tpu_flash_torch.bench.quant_bench --names

Rows (``chip_smoke.py``'s shapes):
- the fp8 headline (b 4, h 8, n 8192, d 128, dense): B6 serving fp8 with
  tensor K scales, B6 serving int8 with token K scales, B7 end-to-end fp8
  (tensor K scales); library: bf16 SDPA;
- ``quant_bands`` rows a–e (``bench/quant_bands.py:band_case``): a,
  local_causal radius 512 at the headline's shape, B7 fp8 and int8; b,
  local radius 128 at n 4096, B7 fp8; c, the circulant radius 512 at n
  8192, B7 int8 and weight-only; d, block-diagonal 512, B7 fp8; e, B6
  serving local_causal radius 512 at 16 / 8 heads, n 8192, fp8 and int8
  under pv_quant; library: the same function in bf16 (``qb_library``: the
  flash forward with its window, SDPA under the circulant mask, SDPA over
  the sections);
- the ring's shifted hops (b 1, 32 heads, shard 4096, d 128, radius 512):
  hop 0 (shift 0) and the hop from the previous rank (shift 4096), B6 and
  B7 fp8; library: SDPA under the hop's mask;
- width 512 (b 2, 4 q / 2 kv heads, n 8192, dense, e4m3, tensor K scales),
  B6 and B7; library: SDPA (its math backend at 512);
- B8's shape (d 64, 16 / 8 heads, causal, n 1000, fp8, tensor K scales),
  B6; library: SDPA, causal.

``--names`` prints instead the device kernels (``torch.profiler``) that
one call of each row's instantiation launches, at a small shape
(``NAME_ROWS``): in a process of its own, since a long run's traces have
come back empty on the card. The hash (sha256 of o's and lse's bytes, 16
hex digits) lets two checkouts
be compared bit for bit on the same inputs: the inputs come from a seeded
generator on the card, seeded per group. It calls only what every
checkout of the port has had since the shifted kinds came in (a row the checkout's kernels refuse
prints its error in place of the times), so the same script times an older
checkout on ``PYTHONPATH`` beside this one: run it as a file path from that
checkout's root with ``PYTHONPATH="$PWD"``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import torch

FP8, INT8 = "float8_e4m3fn", "int8"
# quant_bands rows: (name, row, family, (b, hq, hkv, n, d), schedule, radius
# or section, q_dtype, kv_dtype, kv_scale, pv_quant)
BAND_ROWS = [
    ("a_local_causal_fp8", "a", "quant", (4, 8, 8, 8192, 128), "local_causal",
     512, FP8, FP8, "tensor", False),
    ("a_local_causal_int8", "a", "quant", (4, 8, 8, 8192, 128),
     "local_causal", 512, INT8, INT8, "token", False),
    ("b_local_r128_fp8", "b", "quant", (4, 8, 8, 4096, 128), "local", 128,
     FP8, FP8, "token", False),
    ("c_circulant_int8", "c", "quant", (4, 8, 8, 8192, 128), "circulant", 512,
     INT8, INT8, "token", False),
    ("c_circulant_weight_only", "c", "quant", (4, 8, 8, 8192, 128),
     "circulant", 512, None, INT8, "token", False),
    ("d_block512_fp8", "d", "quant", (4, 8, 8, 8192, 128), "block", 512, FP8,
     FP8, "token", False),
    ("e_serving_local_causal_fp8", "e", "serving", (1, 16, 8, 8192, 128),
     "local_causal", 512, FP8, FP8, "token", False),
    ("e_serving_local_causal_int8_pv_quant", "e", "serving",
     (1, 16, 8, 8192, 128), "local_causal", 512, INT8, INT8, "token", True),
]
HOP = (32, 4096, 128, 512)  # heads, shard, d, radius
# each timed row's kernel instantiation at a small shape, whose device
# kernels --names reports: (row, family, schedule, options, q_dtype,
# kv_dtype, kv_scale, pv_quant, d)
NAME_ROWS = [
    ("headline_serving_fp8", "serving", "dense", {}, FP8, FP8, "tensor",
     False, 128),
    ("headline_serving_int8", "serving", "dense", {}, INT8, INT8, "token",
     False, 128),
    ("headline_e2e_fp8", "quant", "dense", {}, FP8, FP8, "tensor", False,
     128),
    ("a_local_causal_fp8", "quant", "local_causal", dict(radius=100), FP8,
     FP8, "tensor", False, 128),
    ("a_local_causal_int8", "quant", "local_causal", dict(radius=100), INT8,
     INT8, "token", False, 128),
    ("b_local_r128_fp8", "quant", "local", dict(radius=64), FP8, FP8,
     "token", False, 128),
    ("c_circulant_int8", "quant", "circulant", dict(radius=50), INT8, INT8,
     "token", False, 128),
    ("c_circulant_weight_only", "quant", "circulant", dict(radius=50), None,
     INT8, "token", False, 128),
    ("d_block512_fp8", "quant", "block", dict(section=100), FP8, FP8,
     "token", False, 128),
    ("e_serving_local_causal_fp8", "serving", "local_causal",
     dict(radius=100), FP8, FP8, "token", False, 128),
    ("e_serving_local_causal_int8_pv_quant", "serving", "local_causal",
     dict(radius=100), INT8, INT8, "token", True, 128),
    ("d512_serving_fp8", "serving", "dense", {}, FP8, FP8, "tensor", False,
     512),
    ("d512_e2e_fp8", "quant", "dense", {}, FP8, FP8, "tensor", False, 512),
    ("b8_d64_causal_fp8", "serving", "causal", {}, FP8, FP8, "tensor",
     False, 64),
]
HOP_SHIFTS = (0, 4096)


def digest(o: torch.Tensor, lse: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in (o.contiguous(), lse.float().contiguous()):
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _yardsticks():
    """The repository root's chip_smoke module, or None."""
    try:
        import chip_smoke
    except ImportError:
        return None
    return chip_smoke


def _row(kernel, library, device_ms) -> dict:
    """Time one row: ``kernel(need_lse)`` → (o, lse), ``library()``."""
    o, lse = kernel(True)
    torch.cuda.synchronize()
    return dict(ms=device_ms(lambda: kernel(False)),
                library_ms=None if library is None else device_ms(library),
                hash=digest(o, lse))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def headline_rows(device_ms) -> dict:
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    b, h, n, d = 4, 8, 8192, 128
    gen = _gen(0)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda")
               .bfloat16() for _ in "qkv")
    sched = flash.build_schedule("dense", n, n, 1024, 2048)
    c = tfq.f32(d ** -0.5 * flash.LOG2E)
    cs = _yardsticks()
    lib = None if cs is None else device_ms(lambda: cs.sdpa(q, k, v, False))
    rows = {}
    for name, dt, kv_scale in (("headline_serving_fp8", FP8, "tensor"),
                               ("headline_serving_int8", INT8, "token")):
        kq, vq = tsa.quantize_kv_cache(k, v, dt, kv_scale=kv_scale)
        args = (*tsa.serving_operands(q, kq, vq, True), sched, h, h,
                "int8" if dt == INT8 else "fp8", c, False)
        rows[name] = dict(_row(lambda need, args=args: tsa.
                               _serving_attention_kernel(*args, need),
                               None, device_ms), library_ms=lib)
    prep = tfq.prepare_quantized(q, k, v, torch.float8_e4m3fn,
                                 torch.float8_e4m3fn, False, d ** -0.5)
    qops = tfq.quant_operands(*prep, False, True)
    rows["headline_e2e_fp8"] = dict(_row(
        lambda need: tfq._quant_attention_kernel(*qops, sched, h, h,
                                                 torch.bfloat16, need),
        None, device_ms), library_ms=lib)
    return rows


def band_rows(device_ms, names) -> dict:
    from tpu_flash_torch.bench.quant_bands import band_case

    cs = _yardsticks()
    rows = {}
    for seed, (name, _, family, shape, schedule, extra, q_dt, kv_dt,
               kv_scale, pvq) in enumerate(BAND_ROWS, 1):
        if names and name[0] not in names:
            continue
        b, hq, hkv, n, d = shape
        gen = _gen(seed)
        q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda")
                   .bfloat16() for h in (hq, hkv, hkv))
        flat = [x.reshape(1, -1, n, d) for x in (q, k, v)]
        band = (dict(section=extra) if schedule == "block"
                else dict(radius=extra))
        try:
            kernel, _, _ = band_case(family, schedule, *flat, q_dtype=q_dt,
                                     kv_dtype=kv_dt, kv_scale=kv_scale,
                                     bound_max=not pvq, pv_quant=pvq, **band)
            rows[name] = _row(kernel, None if cs is None else cs.qb_library(
                schedule, q, k, v, **band)[0], device_ms)
        except (NotImplementedError, RuntimeError, ValueError) as err:
            rows[name] = str(err)
        del q, k, v, flat
    return rows


def hop_rows(device_ms) -> dict:
    from tpu_flash_torch.bench.quant_bands import band_case
    from tpu_flash_torch.ops import flash

    h, nl, d, r = HOP
    gen = _gen(20)
    q, k, v = (torch.randn(1, h, nl, d, generator=gen, device="cuda")
               .bfloat16() for _ in "qkv")
    cs = _yardsticks()
    rows = {}
    for shift in HOP_SHIFTS:
        sched = flash.build_schedule("shifted", nl, nl, 512, 512, shift=shift,
                                     radius=r)
        lib = None if cs is None else device_ms(lambda: cs.sdpa(
            q, k, v, False, cs.hop_mask(sched, nl, q.device)))
        for family in ("serving", "quant"):
            kernel, _, _ = band_case(family, "shifted", q, k, v, q_dtype=FP8,
                                     kv_dtype=FP8, radius=r, shift=shift)
            rows[f"hop_shift{shift}_{family}_fp8"] = dict(
                _row(kernel, None, device_ms), library_ms=lib)
    return rows


def wide_rows(device_ms) -> dict:
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    b, hq, hkv, n, d = 2, 4, 2, 8192, 512
    gen = _gen(30)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda")
               .bfloat16() for h in (hq, hkv, hkv))
    cs = _yardsticks()
    lib = None if cs is None else device_ms(lambda: cs.sdpa(q, k, v, False))
    sched = flash.build_schedule("dense", n, n, 4096, 2048)
    rows = {}
    try:
        kq, vq = tsa.quantize_kv_cache(k, v, FP8, kv_scale="tensor")
        args = (*tsa.serving_operands(q, kq, vq, True), sched, hq, hkv, "fp8",
                tfq.f32(d ** -0.5 * flash.LOG2E), False)
        rows["d512_serving_fp8"] = dict(_row(
            lambda need: tsa._serving_attention_kernel(*args, need), None,
            device_ms), library_ms=lib)
        prep = tfq.prepare_quantized(q, k, v, torch.float8_e4m3fn,
                                     torch.float8_e4m3fn, False, d ** -0.5)
        qops = tfq.quant_operands(*prep, False, True)
        rows["d512_e2e_fp8"] = dict(_row(
            lambda need: tfq._quant_attention_kernel(
                *qops, sched, hq, hkv, torch.bfloat16, need), None,
            device_ms), library_ms=lib)
    except (NotImplementedError, RuntimeError, ValueError) as err:
        rows["d512"] = str(err)
    return rows


def b8_rows(device_ms) -> dict:
    from tpu_flash_torch.ops import flash
    from tpu_flash_torch.quant import flash_q as tfq
    from tpu_flash_torch.quant import serving_attn as tsa

    hq, hkv, n, d = 16, 8, 1000, 64
    gen = _gen(40)
    q, k, v = (torch.randn(1, h, n, d, generator=gen, device="cuda")
               .bfloat16() for h in (hq, hkv, hkv))
    kq, vq = tsa.quantize_kv_cache(k, v, FP8, kv_scale="tensor")
    sched = flash.build_schedule("causal", n, n, 1024, 2048)
    args = (*tsa.serving_operands(q, kq, vq, True), sched, hq, hkv, "fp8",
            tfq.f32(d ** -0.5 * flash.LOG2E), False)
    cs = _yardsticks()
    return {"b8_d64_causal_fp8": _row(
        lambda need: tsa._serving_attention_kernel(*args, need),
        None if cs is None else lambda: cs.sdpa(q, k, v, True), device_ms)}


def device_kernels(fn, tries: int = 5) -> list:
    """Names of the device kernels one ``fn()`` launches (torch.profiler),
    after one call outside the trace. A trace that recorded no device
    activity at all (seen on the card now and then) is taken again, up to
    ``tries`` times; an empty list means none recorded any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    return names


def kernel_names() -> dict:
    """Each NAME_ROWS row's device kernels, on (1, 4 q / 2 kv heads, 300,
    d) inputs through ``bench/quant_bands.py:band_case``."""
    from tpu_flash_torch.bench.quant_bands import band_case

    gen = _gen(50)
    out = {}
    with torch.no_grad():
        for (name, family, schedule, options, q_dt, kv_dt, kv_scale, pvq,
             d) in NAME_ROWS:
            q, k, v = (torch.randn(1, h, 300, d, generator=gen,
                                   device="cuda").bfloat16() for h in (4, 2, 2))
            kernel, _, _ = band_case(family, schedule, q, k, v, q_dtype=q_dt,
                                     kv_dtype=kv_dt, kv_scale=kv_scale,
                                     bound_max=not pvq, pv_quant=pvq,
                                     **options)
            out[name] = device_kernels(kernel)
    return out


def main(argv=None) -> dict:
    from tpu_flash_torch.bench.harness import device_ms
    from tpu_flash_torch.quant import flash_q

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="",
                    help="comma-separated groups: headline, a-e, hop, d512, "
                         "b8 (default: all)")
    ap.add_argument("--names", action="store_true",
                    help="print each row's device kernels instead")
    args = ap.parse_args(argv)
    if args.names:
        out = kernel_names()
        print(json.dumps(out), flush=True)
        return out
    names = {x for x in args.rows.split(",") if x}
    row = dict(device=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), package=flash_q.__file__)
    with torch.no_grad():
        if not names or "headline" in names:
            row.update(headline_rows(device_ms))
        bands = {x for x in names if x in "abcde"}
        if not names or bands:
            row.update(band_rows(device_ms, bands))
        if not names or "hop" in names:
            row.update(hop_rows(device_ms))
        if not names or "d512" in names:
            row.update(wide_rows(device_ms))
        if not names or "b8" in names:
            row.update(b8_rows(device_ms))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
