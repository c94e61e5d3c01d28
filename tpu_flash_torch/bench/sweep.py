"""Full-size sweep suites of the port: counterparts of the reference's
``tpu_flash/bench/sweep.py`` ``suite_softmax`` (:425-468), ``suite_ndim``
(:277-326) and the circulant and block rows of ``suite_attention``
(:123-129) and ``suite_backward`` (:333-422), plus the matmul shapes of
the primitives.

    python -m tpu_flash_torch.bench.sweep
        --suite softmax|matmul|ndim|bands|backward
        [--device cuda] [--tiny] [--quick] [--iters 10]

Each case goes through the port's public entry points (``fused_softmax``,
``matmul``/``matvec``, N-d ``dense_fa``/``block_fa``/``windowed_fa``,
``circulant_fa``/``block_fa``; the backward suite through autograd of
``dense_fa``/``sliding_fa``/``circulant_fa``, B1 then B4/B5), is gated,
then timed (CUDA events on the card), and prints one JSON row on stdout;
details go to stderr. Gates: the
softmax against a float64 softmax (2e-6 float32, 1e-2 bf16; each fiber sums
to 1 within 1e-5) and against its plain version; matmul against its plain
version and a float64 product, relative to the largest output (one bf16
ulp of it, 2^-7; 1e-5 float32); attention against the f32 oracles (``blockwise_dpa``,
``block_dpa``, 2.5e-2 in bf16; the backward's grads against the
checkpointed ``blockwise_dpa``'s, 2.5e-2 of max(|grad|, 1)) and the fp8 rows against the
matched-bit-width oracle (inputs quantized as the kernel quantizes them,
1e-2). Inputs come from ``torch.Generator`` seeds on the device.
``--tiny`` runs CPU-sized shapes that check the suites on the plain paths;
their times are no device metric.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from tpu_flash_torch.bench.harness import device_peaks, roofline, time_fn

# (rows, fiber, axis, dtype): the reference's five float32 shapes, one
# column shape whose fibers take the port's one-pass column kernel (fibers of
# 512; the reference's column shapes both stream), and its bf16 test shape
SOFTMAX_CASES = [
    (8192, 16384, -1, torch.float32),    # row one-pass
    (131072, 2048, -1, torch.float32),   # row one-pass, many fibers
    (2048, 131072, -1, torch.float32),   # row two-pass
    (4096, 16384, -2, torch.float32),    # column two-pass (fiber 4096)
    (8192, 65536, -2, torch.float32),    # column two-pass (fiber 8192)
    (512, 131072, -2, torch.float32),    # column one-pass (fiber 512)
    (64, 3000, -1, torch.bfloat16),
]
SOFTMAX_TINY = [
    (64, 256, -1, torch.float32), (4, 20000, -1, torch.float32),
    (600, 96, -2, torch.float32), (256, 64, -2, torch.float32),
    (8, 300, -1, torch.bfloat16),
]
# (name, m, k, n, dtype): n None is matvec
MATMUL_CASES = [
    ("matmul_4096_bf16", 4096, 4096, 4096, torch.bfloat16),
    ("matmul_4096_f32", 4096, 4096, 4096, torch.float32),
    ("matmul_ragged_bf16", 4000, 1000, 3000, torch.bfloat16),
    ("matmul_k4095_bf16", 4096, 4095, 4096, torch.bfloat16),  # wmma route
    ("matvec_16384_bf16", 16384, 16384, None, torch.bfloat16),
]
MATMUL_TINY = [
    ("matmul_f32", 128, 96, 80, torch.float32),
    ("matmul_ragged_bf16", 100, 30, 70, torch.bfloat16),
    ("matvec_bf16", 200, 150, None, torch.bfloat16),
]
# suite_ndim's non-quick cases at b 1, d 64: (name, spatial, heads, window
# or section); dense3d cut from 16 × 64 × 64 to 16 × 32 × 32 (1.1 TFLOP a
# call at the full grid)
NDIM_CASES = [
    ("dense2d", (128, 128), 8, None),
    ("dense2d_fp8", (128, 128), 8, None),
    ("dense3d", (16, 32, 32), 1, None),
    ("block2d", (256, 256), 8, (16, 16)),
    ("windowed2d_fp8", (64, 64), 8, (16, 16)),
]
NDIM_TINY = [
    ("dense2d", (8, 8), 2, None), ("dense2d_fp8", (8, 8), 2, None),
    ("dense3d", (2, 4, 4), 1, None), ("block2d", (16, 16), 2, (4, 4)),
    ("windowed2d_fp8", (8, 8), 2, (4, 4)),
]
WINDOW_STRIDE = {"windowed2d_fp8": 8}
WINDOW_STRIDE_TINY = {"windowed2d_fp8": 2}
# suite_attention's circulant and block rows at n 8192, d 128: window
# min(n/4 + 1, 1025), section max(n/16, 256)
BANDS = dict(b=1, h=8, n=8192, d=128)
BANDS_TINY = dict(b=1, h=2, n=1024, d=64)
FP8 = "float8_e4m3fn"
TOL_SOFTMAX = {torch.float32: 2e-6, torch.bfloat16: 1e-2}
TOL_SUM = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16: one bf16 ulp of the largest entry (2^-7 of it at most), the most
# two correct roundings of float32 sums taken in other orders can differ
TOL_MATMUL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7 + 1e-5}
TOL_BF16, TOL_QUANT = 2.5e-2, 1e-2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def randn(seed: int, shape, dtype, device) -> torch.Tensor:
    """Standard normal from a ``torch.Generator`` seed, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


def _check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"sweep gate failed for {name}: {err} > {tol}")


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _timing(fn, args, iters, ops, nbytes, peaks, kind="bf16") -> dict:
    """ms per call and the least time the card could take (None off it)."""
    ms = time_fn(fn, *args, iters=iters) * 1e3
    if peaks["hbm_bytes"] is None:
        return dict(ms=ms, bound_ms=None, bound_by=None)
    return dict(ms=ms, **roofline(ops, 0, nbytes, peaks, kind, kind))


# ------------------------------------------------------------------ softmax


def softmax_input(case, device, seed=0):
    rows, n, axis, dtype = case
    return randn(seed, (rows, n), dtype, device)


def softmax_row(x: torch.Tensor, axis: int, iters: int = 10) -> dict:
    """Gate and time ``fused_softmax(x, axis)``."""
    from tpu_flash_torch.ops import softmax as sm

    n, m = (x.shape[-1], 1) if axis == -1 else x.shape[-2:]
    path = (("row" if m == 1 else "column") + "_"
            + ("onepass" if sm.onepass_fits(n, m) else "twopass"))
    name = f"fused_softmax {tuple(x.shape)} axis {axis} {str(x.dtype)[6:]}"
    got = sm.fused_softmax(x, axis=axis)
    x64 = x.double()
    p = torch.exp(x64 - x64.amax(dim=axis, keepdim=True))
    exact = p / p.sum(dim=axis, keepdim=True)
    del x64, p
    row = dict(name="fused_softmax", shape=list(x.shape), axis=axis,
               dtype=str(x.dtype)[6:], path=path, tol=TOL_SOFTMAX[x.dtype],
               max_abs_err=_max_err(got, exact),
               err_vs_plain=_max_err(got, sm._fused_softmax(x, axis, True)),
               max_sum_err=float((got.double().sum(dim=axis) - 1).abs().max()))
    del exact
    _check(name, row["max_abs_err"], TOL_SOFTMAX[x.dtype])
    _check(name + " vs plain", row["err_vs_plain"], TOL_SOFTMAX[x.dtype])
    _check(name + " sums", row["max_sum_err"], TOL_SUM[x.dtype])
    del got
    nbytes = 2 * x.numel() * x.element_size()
    row.update(_timing(lambda t: sm.fused_softmax(t, axis=axis), (x,), iters,
                       0, nbytes, device_peaks(x.device)))
    row["gbps"] = nbytes / row["ms"] / 1e6
    row["plain_ms"] = time_fn(lambda t: sm._fused_softmax(t, axis, True), x,
                              iters=max(iters // 3, 1), warmup=1) * 1e3
    return row


def suite_softmax(device, tiny=False, iters=10):
    rows = []
    for case in SOFTMAX_TINY if tiny else SOFTMAX_CASES:
        row = softmax_row(softmax_input(case, device), case[2], iters)
        rows.append(row)
        log(f"  softmax {row['shape']} ax{row['axis']} {row['path']:15s} "
            f"{row['ms']:8.3f} ms {row['gbps']:8.1f} GB/s  err "
            f"{row['max_abs_err']:.2e}")
    return rows


# ------------------------------------------------------------------- matmul


def matmul_inputs(case, device, seed=0):
    _, m, k, n, dtype = case
    return (randn(seed, (m, k), dtype, device),
            randn(seed + 1, (k,) if n is None else (k, n), dtype, device))


def matmul_row(case, a, b, iters: int = 10) -> dict:
    """Gate and time ``matmul(a, b)`` (``matvec`` for a vector b)."""
    from tpu_flash_torch.ops import matmul as mm

    name, m, k, n, dtype = case
    fn = mm.matvec if b.ndim == 1 else mm.matmul
    got = fn(a, b)
    b2 = b[:, None] if b.ndim == 1 else b
    plain = mm._matmul_plain(a, b2, dtype)
    exact = a.double() @ b2.double()
    top = float(exact.abs().max())
    got2 = got[:, None] if b.ndim == 1 else got
    row = dict(name=name, m=m, k=k, n=n or 1, dtype=str(dtype)[6:],
               route=mm._matmul_route(m, n or 1, k, dtype),
               tol=TOL_MATMUL[dtype],
               max_abs_err=_max_err(got2, exact), rel_err=_max_err(got2, exact) / top,
               rel_err_vs_plain=_max_err(got2, plain) / top)
    del exact, plain
    _check(name, row["rel_err"], TOL_MATMUL[dtype])
    _check(name + " vs plain", row["rel_err_vs_plain"], TOL_MATMUL[dtype])
    esz = a.element_size()
    nbytes = esz * (m * k + k * (n or 1) + m * (n or 1))
    ops = 2 * m * k * (n or 1)
    row.update(_timing(fn, (a, b), iters, ops, nbytes, device_peaks(a.device),
                       "f32" if dtype == torch.float32 else "bf16"))
    row["tflops"] = ops / row["ms"] / 1e9
    row["plain_ms"] = time_fn(lambda x, y: mm._matmul_plain(x, y, dtype), a, b2,
                              iters=max(iters // 3, 1), warmup=1) * 1e3
    return row


def suite_matmul(device, tiny=False, iters=10):
    rows = []
    for case in MATMUL_TINY if tiny else MATMUL_CASES:
        row = matmul_row(case, *matmul_inputs(case, device), iters)
        rows.append(row)
        log(f"  {row['name']:22s} {row['ms']:8.3f} ms {row['tflops']:8.2f} "
            f"TFLOP/s  rel err {row['rel_err']:.2e}")
    return rows


# --------------------------------------------------------------- attention


def _matched(x, axis, scale=None):
    """x as the fp8 quantized route sees it: quantized to e4m3 along
    ``axis`` (after the softmax scale, for q) and decoded, float32."""
    from tpu_flash_torch.quant import qarray

    x = x.float() if scale is None else x.float() * scale
    return qarray.dequantize(qarray.quantize(x, FP8, axis=axis))


def _fp8_oracle(qw, kw, vw):
    from tpu_flash_torch.ops.oracle import blockwise_dpa

    scale = qw.shape[-1] ** -0.5
    o, _ = blockwise_dpa(_matched(qw, -1, scale), _matched(kw, -1),
                         _matched(vw, -2), scale=1.0, chunk=1024)
    return o


def ndim_call(name, window, stride):
    """The public call of an N-d case on ``(b, *spatial, h, d)`` q/k/v."""
    from tpu_flash_torch.ops import flash

    if name in ("dense2d", "dense3d"):
        return flash.dense_fa
    if name == "dense2d_fp8":
        return lambda q, k, v: flash.dense_fa(q, k, v, q_dtype=FP8, kv_dtype=FP8)
    if name == "block2d":
        return lambda q, k, v: flash.block_fa(q, k, v, window)
    return lambda q, k, v: flash.windowed_fa(q, k, v, window, stride=stride,
                                             q_dtype=FP8, kv_dtype=FP8)


def ndim_inputs(spatial, h, d, device, seed=0):
    return [randn(seed + i, (1, *spatial, h, d), torch.bfloat16, device)
            for i in range(3)]


def ndim_row(name, spatial, h, window, stride, q, k, v, iters=2) -> dict:
    """Gate and time one N-d case through its public call."""
    from tpu_flash_torch.ops.oracle import blockwise_dpa, block_dpa
    from tpu_flash_torch.utils.layout import flatten_spatial, windowed

    fn = ndim_call(name, window, stride)
    got = fn(q, k, v)
    d, n = q.shape[-1], math.prod(spatial)
    if name in ("dense2d", "dense3d"):
        flat = [flatten_spatial(x)[0] for x in (q, k, v)]
        want = blockwise_dpa(*flat, chunk=1024)[0]
        err, tol = _max_err(flatten_spatial(got)[0], want), TOL_BF16
    elif name == "dense2d_fp8":
        flat = [flatten_spatial(x)[0] for x in (q, k, v)]
        err = _max_err(flatten_spatial(got)[0], _fp8_oracle(*flat))
        tol = TOL_QUANT
    elif name == "block2d":
        err, tol = _max_err(got, block_dpa(q, k, v, window)), TOL_BF16
    else:
        want = windowed(q, k, v, window, stride=stride, attend=_fp8_oracle,
                        fold_dtype=torch.float32)
        err, tol = _max_err(got, want), TOL_QUANT
    _check(name, err, tol)
    row = dict(name=name, spatial="x".join(map(str, spatial)), n=n, h=h, d=d,
               max_abs_err=err, tol=tol)
    if window is not None:
        row["window" if name.startswith("windowed") else "section"] = list(window)
    pairs = None  # overlapping windows duplicate work: seconds only
    if name.startswith("dense"):
        pairs = n * n
    elif name == "block2d":
        pairs = n * math.prod(window)
    peaks = device_peaks(q.device)
    nbytes = 2 * 4 * h * n * d + 4 * h * n
    kind = "fp8" if name.endswith("fp8") else "bf16"
    row.update(_timing(fn, (q, k, v), iters, 4 * d * h * (pairs or 0),
                       nbytes, peaks, kind))
    if pairs is not None:
        row["visible_pairs"] = pairs * h
        row["tflops"] = 4 * d * h * pairs / row["ms"] / 1e9
    return row


def suite_ndim(device, tiny=False, iters=2, names=None):
    rows = []
    strides = WINDOW_STRIDE_TINY if tiny else WINDOW_STRIDE
    for name, spatial, h, window in NDIM_TINY if tiny else NDIM_CASES:
        if names is not None and name not in names:
            continue
        q, k, v = ndim_inputs(spatial, h, 64, device)
        row = ndim_row(name, spatial, h, window, strides.get(name), q, k, v,
                       iters)
        rows.append(row)
        log(f"  {name:16s} {row['spatial']:10s} {row['ms']:9.3f} ms  err "
            f"{row['max_abs_err']:.2e}")
    return rows


def band_params(n: int) -> dict:
    """suite_attention's window and section at sequence length n."""
    return dict(window=min(n // 4 + 1, 1025), section=max(n // 16, 256))


def band_call(name, n):
    from tpu_flash_torch.ops import flash

    p = band_params(n)
    if name == "circulant":
        return lambda q, k, v: flash.circulant_fa(q, k, v, p["window"])
    return lambda q, k, v: flash.block_fa(q, k, v, p["section"])


def band_row(name, q, k, v, iters=10) -> dict:
    """Gate and time the circulant or block row of suite_attention."""
    from tpu_flash_torch.ops.oracle import blockwise_dpa

    b, h, n, d = q.shape
    p = band_params(n)
    fn = band_call(name, n)
    got = fn(q, k, v)
    mask = (dict(window_size=p["window"], wrap=True) if name == "circulant"
            else dict(block_size=p["section"]))
    err = _max_err(got, blockwise_dpa(q, k, v, chunk=1024, **mask)[0])
    _check(name, err, TOL_BF16)
    width = p["window"] if name == "circulant" else p["section"]
    pairs = b * h * n * width
    row = dict(name=name, b=b, h=h, n=n, d=d, max_abs_err=err, tol=TOL_BF16,
               visible_pairs=pairs,
               **{"window" if name == "circulant" else "section": width})
    row.update(_timing(fn, (q, k, v), iters, 4 * d * pairs,
                       2 * 4 * b * h * n * d + 4 * b * h * n,
                       device_peaks(q.device)))
    row["tflops"] = 4 * d * pairs / row["ms"] / 1e9
    return row


def band_inputs(shape, device, seed=0):
    b, h, n, d = shape["b"], shape["h"], shape["n"], shape["d"]
    return [randn(seed + i, (b, h, n, d), torch.bfloat16, device)
            for i in range(3)]


def suite_bands(device, tiny=False, iters=10, names=("circulant", "block")):
    rows = []
    q, k, v = band_inputs(BANDS_TINY if tiny else BANDS, device)
    for name in names:
        row = band_row(name, q, k, v, iters)
        rows.append(row)
        log(f"  {name:10s} n={row['n']} {row['ms']:8.3f} ms "
            f"{row['tflops']:7.2f} TFLOP/s  err {row['max_abs_err']:.2e}")
    return rows


# ------------------------------------------------------------------ backward

# suite_backward's shapes (tpu_flash/bench/sweep.py:333-422): b 1, h 8, the
# band variants at window 1025 where n exceeds it; quick: n 1024 and 4096
# at d 64. --tiny: CPU-sized shapes that take every variant
BACKWARD = dict(b=1, h=8, seqlens=(1024, 4096, 8192, 16384), dims=(64, 128),
                window=1025)
BACKWARD_QUICK = dict(BACKWARD, seqlens=(1024, 4096), dims=(64,))
BACKWARD_TINY = dict(b=1, h=2, seqlens=(128, 300), dims=(32, 96), window=129)


def backward_variants(n: int, d: int, window: int):
    """(name, attention call, the oracle's mask, coverage) of the
    reference's backward rows at (n, d): dense, dense with the int8 dp
    product (d > 64; the flag is ignored below), causal, and the sliding
    and circulant bands where n exceeds the window."""
    from tpu_flash_torch.ops import flash

    yield "dense_fwd_bwd", (lambda q, k, v: flash.dense_fa(q, k, v)), {}, 1.0
    if d > 64:
        yield ("dense_fwd_bwd_dpq",
               lambda q, k, v: flash.dense_fa(q, k, v, bwd_quant="dp"), {}, 1.0)
    yield ("causal_fwd_bwd",
           lambda q, k, v: flash.dense_fa(q, k, v, causal=True),
           dict(causal=True), 0.5)
    if n > window:
        cov = window / n
        yield ("sliding_fwd_bwd",
               lambda q, k, v: flash.sliding_fa(q, k, v, window),
               dict(window_size=window), cov)
        yield ("circulant_fwd_bwd",
               lambda q, k, v: flash.circulant_fa(q, k, v, window),
               dict(window_size=window, wrap=True), cov)


def _loss_grads(fn, q, k, v):
    """Grads of sum(fn(q, k, v)²) in float32, the reference's loss."""
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    (fn(*xs).float() ** 2).sum().backward()
    return [x.grad for x in xs]


def backward_row(name, fn, mask, cov, q, k, v, iters=5) -> dict:
    """Gate one variant's grads against the checkpointed ``blockwise_dpa``
    oracle's (2.5e-2 of max(|oracle grad|, 1)), then time forward plus
    backward and report covered-pair TFLOP/s."""
    from tpu_flash_torch.bench.harness import attention_bytes, attention_flops
    from tpu_flash_torch.ops.oracle import blockwise_dpa

    b, h, n, d = q.shape
    got = _loss_grads(fn, q, k, v)
    want = _loss_grads(lambda *x: blockwise_dpa(*x, chunk=1024, **mask)[0],
                       q, k, v)
    err = max(float((g.float() - w.float()).abs().max()
                    / max(float(w.float().abs().max()), 1.0))
              for g, w in zip(got, want))
    del got, want
    _check(name, err, TOL_BF16)
    flops = attention_flops(b, h, n, n, d, backward=True, coverage=cov)
    nbytes = attention_bytes(b, h, n, n, d) * 3
    row = dict(name=name, b=b, h=h, n=n, d=d, coverage=cov, max_abs_err=err,
               tol=TOL_BF16)
    row.update(_timing(lambda *x: _loss_grads(fn, *x), (q, k, v), iters,
                       flops, nbytes, device_peaks(q.device)))
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def suite_backward(device, tiny=False, iters=5, quick=False):
    """The reference's suite_backward: grads of sum(o²) through each
    variant at each (n, d), gated against the oracle's, timed."""
    shape = BACKWARD_TINY if tiny else BACKWARD_QUICK if quick else BACKWARD
    b, h, win = shape["b"], shape["h"], shape["window"]
    rows = []
    with torch.enable_grad():
        for n in shape["seqlens"]:
            for d in shape["dims"]:
                q, k, v = (randn(i, (b, h, n, d), torch.bfloat16, device)
                           for i in range(3))
                for name, fn, mask, cov in backward_variants(n, d, win):
                    row = backward_row(name, fn, mask, cov, q, k, v, iters)
                    rows.append(row)
                    log(f"  {name:18s} n={n:6d} d={d:4d} {row['ms']:9.3f} ms"
                        f" {row['tflops']:7.2f} TFLOP/s (covered)"
                        f"  err {row['max_abs_err']:.2e}")
    return rows


SUITES = {"softmax": suite_softmax, "matmul": suite_matmul,
          "ndim": suite_ndim, "bands": suite_bands,
          "backward": suite_backward}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", required=True, choices=sorted(SUITES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized shapes (checks the suite; no device metric)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--quick", action="store_true",
                    help="the backward suite's quick shapes")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device (pass --device cpu --tiny to "
                         "check the plain paths)")
    log(f"device: {device_peaks(dev)['kind']}  suite: {args.suite}")
    kw = {} if args.iters is None else dict(iters=args.iters)
    if args.quick:
        kw["quick"] = True
    with torch.no_grad():
        rows = SUITES[args.suite](dev, tiny=args.tiny, **kw)
    for row in rows:
        print(json.dumps(dict(row, device=device_peaks(dev)["kind"])),
              flush=True)
    return rows


if __name__ == "__main__":
    main()
