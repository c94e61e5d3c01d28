"""Timing, analytic FLOP/byte models and roofline accounting: port of
``tpu_flash/bench/harness.py``.

The models (``attention_flops``, ``attention_bytes``, ``schedule_coverage``)
are the reference's, unchanged. ``device_peaks`` gives an H100 SXM's
datasheet rates; :func:`time_fn` times with CUDA events on the card and
:func:`device_ms` a CUDA graph of calls, which the host cannot slow. A
quantized call's roofline counts each product at its own type's peak:
QKᵀ in fp8 or int8 at 1979 TFLOP/s, P·V at the bf16 989 (P is bf16), or
at 1979 under ``pv_quant``. (The reference's TPU table has no fp8 unit, so
its ``bench.py`` took the bf16 peak for fp8.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

# NVIDIA H100 SXM datasheet: dense tensor-core rates, float32 outside the
# tensor cores (a float32 matmul runs there with TF32 off), HBM bandwidth
_PEAKS = {
    "NVIDIA H100": {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12,
                    "f32": 67e12, "hbm_bytes": 3.35e12},
}
_NO_PEAKS = {"bf16": None, "fp8": None, "int8": None, "f32": None,
             "hbm_bytes": None}


def device_peaks(device=None) -> dict:
    """{'bf16', 'fp8', 'int8', 'f32' (operations/s), 'hbm_bytes'
    (bytes/s), 'kind'} of a CUDA device. A device with no datasheet entry
    (or the CPU) has no peaks: its rates are None."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return dict(_NO_PEAKS, kind="cpu")
    kind = torch.cuda.get_device_name(device)
    for prefix, peaks in _PEAKS.items():
        if kind.startswith(prefix):
            return dict(peaks, kind=kind)
    return dict(_NO_PEAKS, kind=kind)


def attention_flops(batch: int, heads: int, n_q: int, n_kv: int, d: int,
                    dv: Optional[int] = None, *, coverage: float = 1.0,
                    backward: bool = False) -> int:
    """Matmul FLOPs of one attention call: QKᵀ (2·nq·nkv·d) + PV
    (2·nq·nkv·dv); backward adds ≈ 2.5× forward. ``coverage`` is the
    unmasked fraction of the score matrix."""
    dv = d if dv is None else dv
    fwd = 2 * batch * heads * n_q * n_kv * (d + dv)
    total = fwd * (1 + 5 / 2) if backward else fwd
    return int(total * coverage)


def attention_bytes(batch: int, heads: int, n_q: int, n_kv: int, d: int,
                    dv: Optional[int] = None, *, q_bytes: float = 2,
                    kv_bytes: float = 2, o_bytes: float = 2) -> int:
    """Minimum device-memory traffic: read Q/K/V once, write O (+lse) once."""
    dv = d if dv is None else dv
    return int(batch * heads * (n_q * d * q_bytes + n_kv * (d + dv) * kv_bytes
                                + n_q * dv * o_bytes + n_q * 4))


def schedule_coverage(schedule: str, n: int, *, radius: int = 0,
                      section: int = 0, causal: bool = False) -> float:
    """Unmasked fraction of the score matrix for a 1D schedule."""
    if schedule == "dense":
        return 0.5 if causal else 1.0
    if schedule in ("local", "sliding"):
        w = 2 * radius + 1
        cov = min(w / n, 1.0)
        return cov / 2 if causal else cov
    if schedule == "circulant":
        return min((2 * radius + 1) / n, 1.0)
    if schedule == "block":
        return min(section / n, 1.0)
    raise ValueError(f"unknown schedule {schedule!r}")


def roofline(flops_qk: float, flops_pv: float, nbytes: float, peaks: dict,
             qk: str = "bf16", pv: str = "bf16") -> dict:
    """Least time of an attention call, in ms: its QKᵀ operations at the
    ``qk`` type's peak plus its P·V operations at the ``pv`` type's, or its
    bytes over the memory rate, whichever is larger."""
    t_ops = (flops_qk / peaks[qk] + flops_pv / peaks[pv]) * 1e3
    t_bytes = nbytes / peaks["hbm_bytes"] * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call: CUDA events around ``iters`` back-to-back calls
    after ``warmup`` on the card; the host clock around synchronous calls
    on the CPU."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    if not _on_cuda(args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def device_ms(fn, calls: int = 20, replays: int = 3) -> float:
    """Device time of one ``fn`` call in ms, which the host cannot hide:
    ``calls`` calls captured in a CUDA graph, the graph replayed under CUDA
    events. Everything a call launches counts (a wrapper's padding copies,
    the norm bound's key reduction); the host's Python and launch costs do
    not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def _on_cuda(args) -> bool:
    """Whether the first tensor argument (or QArray's values) is on CUDA."""
    for a in args:
        t = a if isinstance(a, torch.Tensor) else getattr(a, "values", None)
        if isinstance(t, torch.Tensor):
            return t.is_cuda
    return False


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds: float
    flops: int
    bytes_moved: int
    max_abs_err: float
    config: dict
    peaks: dict

    @property
    def tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    def roofline_fraction(self, qk: str = "bf16", pv: str = "bf16",
                          qk_share: float = 0.5) -> Optional[float]:
        """Least time over measured time; ``qk_share`` is QKᵀ's share of
        the FLOPs (d / (d + dv)). None where the device has no peaks."""
        if self.peaks.get("hbm_bytes") is None:
            return None
        bound = roofline(self.flops * qk_share, self.flops * (1 - qk_share),
                         self.bytes_moved, self.peaks, qk, pv)
        return bound["bound_ms"] / 1e3 / self.seconds


def measure(name: str, fn: Callable, args: tuple, *, flops: int,
            bytes_moved: int, err_fn: Optional[Callable] = None,
            tol: Optional[float] = None, iters: int = 10, warmup: int = 2,
            config: Optional[dict] = None) -> BenchResult:
    """Gate with ``err_fn(output) -> max-abs error`` when given, then time.
    Raises if the gate fails: a benchmark of a wrong kernel is worse than
    none."""
    err = float("nan")
    if err_fn is not None:
        err = float(err_fn(fn(*args)))
        if tol is not None and not err <= tol:
            raise AssertionError(
                f"bench gate failed for {name}: max_abs_err={err} > tol={tol}")
    sec = time_fn(fn, *args, iters=iters, warmup=warmup)
    return BenchResult(name=name, seconds=sec, flops=flops,
                       bytes_moved=bytes_moved, max_abs_err=err,
                       config=config or {},
                       peaks=device_peaks("cuda" if _on_cuda(args) else "cpu"))
