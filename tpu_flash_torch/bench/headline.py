"""Headline benchmark of the port: counterpart of the repository's
``bench.py``, on an NVIDIA GPU.

    python -m tpu_flash_torch.bench.headline [--seqlen 8192] [--batch 4]
        [--heads 8] [--head-dim 128]
        [--dtype float8_e4m3fn|float8_e5m2|int8|bf16] [--mode serving|e2e]
        [--iters 10] [--device cuda]

Metric: dense attention TFLOP/s at the headline shape. ``serving`` times
``serving_flash_attention`` on a cache quantized once beforehand (K/V are
cache residents; Q is quantized in the kernel, B6); ``e2e`` times
``quantized_dense_fa`` on bf16 inputs, quantizing inside the timed call
(B7); ``bf16`` times ``dense_fa`` (B1). fp8 takes per-tensor K scales,
int8 per-token ones. Before timing, the output is gated against the f32
``blockwise_dpa`` oracle on inputs quantized at the same granularity (the
matched-bit-width contract): tol 1e-2, 2.5e-2 for e5m2 and bf16.

stdout carries one JSON line (metric, value, unit, vs_baseline against the
reference's 0.47316 TFLOP/s CPU figure); details go to stderr. The numbers
name the device they ran on; ``--device cpu`` runs the plain versions at a
small shape for checking, and its time is no device metric.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpu_flash_torch.bench.harness import (
    attention_bytes,
    attention_flops,
    device_peaks,
    measure,
    roofline,
    time_fn,
)

REFERENCE_BEST_TFLOPS = 0.47316
DTYPES = ["float8_e4m3fn", "float8_e5m2", "int8", "bf16"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_inputs(batch: int, heads: int, seqlen: int, head_dim: int, device,
                seed: int = 0):
    """q, k, v ``(batch, heads, seqlen, head_dim)`` bf16, standard normal
    from numpy's generator ``seed`` (as ``bench.py`` makes them)."""
    rng = np.random.default_rng(seed)
    shape = (batch, heads, seqlen, head_dim)
    return [torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16)
            .to(device) for _ in range(3)]


def run(q, k, v, dtype: str = "float8_e4m3fn", mode: str = "serving",
        iters: int = 10) -> dict:
    """Gate, then time one headline configuration on ``q, k, v``; return
    the JSON line's fields and the details (ms, gate error, bound)."""
    from tpu_flash_torch.ops.flash import dense_fa
    from tpu_flash_torch.ops.oracle import blockwise_dpa
    from tpu_flash_torch.quant import qarray
    from tpu_flash_torch.quant.flash_q import quantized_dense_fa
    from tpu_flash_torch.quant.serving_attn import (
        quantize_kv_cache,
        serving_flash_attention,
    )

    b, h, n, d = q.shape
    sm_scale = 1.0 / float(np.sqrt(d))
    if dtype == "bf16":
        fn, args, tol, o_scale = dense_fa, (q, k, v), 2.5e-2, None
        qf, kf, vf = q, k, v
    else:
        kv_scale = "token" if dtype == "int8" else "tensor"
        k_axis = -1 if kv_scale == "token" else (-2, -1)

        def e2e_fn(q, k, v):
            return quantized_dense_fa(q, k, v, q_dtype=dtype, kv_dtype=dtype,
                                      kv_scale=kv_scale)

        if mode == "serving":
            kq, vq = quantize_kv_cache(k, v, dtype, kv_scale=kv_scale)

            def fn(q, kq, vq):
                return serving_flash_attention(q, kq, vq, q_dtype=dtype)

            args = (q, kq, vq)
            # matched inputs: the dequantized cache contents
            kf, vf = qarray.dequantize(kq), qarray.dequantize(vq)
        else:
            fn, args = e2e_fn, (q, k, v)
            kf = qarray.dequantize(qarray.quantize(k.float(), dtype,
                                                   axis=k_axis))
            vf = qarray.dequantize(qarray.quantize(v.float(), dtype, axis=-2))
        # the serving kernel quantizes Q to e4m3 under an e5m2 cache too;
        # bench.py's gate quantized it to e5m2 and failed its own tol there
        q_dt = ("float8_e4m3fn" if mode == "serving" and dtype != "int8"
                else dtype)
        qf = qarray.dequantize(qarray.quantize(q.float() * sm_scale, q_dt,
                                               axis=-1))
        tol = 2.5e-2 if dtype == "float8_e5m2" else 1e-2
        o_scale = 1.0
    want, _ = blockwise_dpa(qf, kf, vf, scale=o_scale, chunk=1024)
    del qf, kf, vf

    flops = attention_flops(b, h, n, n, d)
    # bytes the timed call must move: q in bf16, the cache at 1 byte
    # (serving) or K/V in bf16 (e2e, bf16), o in bf16
    kv_bytes = 1 if dtype != "bf16" and mode == "serving" else 2
    nbytes = attention_bytes(b, h, n, n, d, q_bytes=2, kv_bytes=kv_bytes)
    peaks = device_peaks(q.device)
    metric = (f"dense_fa {dtype} TFLOP/s, seqlen {n}, 1 {peaks['kind']}"
              + ("" if dtype == "bf16" else f", {mode}"))
    res = measure(metric, fn, args, flops=flops, bytes_moved=nbytes,
                  err_fn=lambda got: (got.float() - want.float()).abs().max(),
                  tol=tol, iters=iters,
                  config=dict(b=b, h=h, n=n, d=d, dtype=dtype, mode=mode))
    err = res.max_abs_err
    qk = "bf16" if dtype == "bf16" else ("int8" if dtype == "int8" else "fp8")
    out = dict(metric=metric, value=res.tflops, unit="TFLOP/s",
               vs_baseline=res.tflops / REFERENCE_BEST_TFLOPS,
               ms=res.seconds * 1e3, max_abs_err=err, tol=tol, flops=flops,
               bytes=nbytes, device=peaks["kind"], roofline_qk=qk,
               roofline_pv="bf16")
    if peaks["hbm_bytes"] is not None:
        out.update(roofline(flops / 2, flops / 2, nbytes, peaks, qk, "bf16"),
                   roofline_frac=res.roofline_fraction(qk, "bf16"))
    log(f"gate: max_abs_err={err:.5f} (tol {tol})")
    log(f"{out['ms']:.3f} ms  {res.tflops:.2f} TFLOP/s  {res.gbps:.1f} GB/s "
        f"on {peaks['kind']}")
    if dtype != "bf16" and mode == "serving":
        out["e2e_ms"] = time_fn(e2e_fn, q, k, v, iters=iters) * 1e3
        log(f"e2e (quantize inside the timed call): {out['e2e_ms']:.3f} ms")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqlen", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--dtype", default="float8_e4m3fn", choices=DTYPES)
    ap.add_argument("--mode", default="serving", choices=["serving", "e2e"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("headline: no CUDA device (pass --device cpu to "
                         "check the plain path)")
    log(f"device: {device_peaks(dev)['kind']}  config: b={args.batch} "
        f"h={args.heads} n={args.seqlen} d={args.head_dim} "
        f"dtype={args.dtype} mode={args.mode}")
    q, k, v = make_inputs(args.batch, args.heads, args.seqlen, args.head_dim,
                          dev)
    with torch.no_grad():
        out = run(q, k, v, args.dtype, args.mode, args.iters)
    print(json.dumps({"metric": out["metric"], "value": out["value"],
                      "unit": "TFLOP/s", "vs_baseline": out["vs_baseline"]}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
