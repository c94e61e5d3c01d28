"""The port's bench harness, headline and sweep: analytic models equal to
the reference's, the roofline rule, and the headline and the sweep suites
run end to end on the CPU at tiny shapes (plain paths; their times are no
device metric)."""

import json

import pytest
import torch

from tpu_flash.bench import harness as jh
from tpu_flash_torch.bench import harness as th
from tpu_flash_torch.bench import headline, sweep

torch.set_num_threads(2)


@pytest.mark.parametrize("args,kw", [
    ((4, 8, 8192, 8192, 128), {}), ((1, 2, 100, 300, 64, 32), {}),
    ((2, 16, 1024, 1024, 128), dict(coverage=0.5, backward=True)),
    ((4, 8, 8192, 8192, 128), dict(coverage=0.25))])
def test_attention_flops_match_reference(args, kw):
    assert th.attention_flops(*args, **kw) == jh.attention_flops(*args, **kw)


@pytest.mark.parametrize("kw", [{}, dict(q_bytes=1, kv_bytes=1),
                                dict(q_bytes=2, kv_bytes=1, o_bytes=4)])
def test_attention_bytes_match_reference(kw):
    for args in ((4, 8, 8192, 8192, 128), (1, 3, 77, 200, 64, 32)):
        assert th.attention_bytes(*args, **kw) == jh.attention_bytes(*args, **kw)


@pytest.mark.parametrize("schedule,kw", [
    ("dense", {}), ("dense", dict(causal=True)), ("local", dict(radius=64)),
    ("sliding", dict(radius=64, causal=True)), ("circulant", dict(radius=8)),
    ("block", dict(section=256))])
def test_schedule_coverage_matches_reference(schedule, kw):
    assert th.schedule_coverage(schedule, 1024, **kw) == \
        jh.schedule_coverage(schedule, 1024, **kw)


def test_roofline_counts_each_product_at_its_type():
    """QKᵀ at the fp8 peak plus P·V at the bf16 peak: the headline's bound
    is 0.55 TFLOP / 1979 + 0.55 TFLOP / 989 ≈ 0.83 ms, set by operations."""
    peaks = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12,
             "hbm_bytes": 3.35e12}
    flops = th.attention_flops(4, 8, 8192, 8192, 128)
    nbytes = th.attention_bytes(4, 8, 8192, 8192, 128, kv_bytes=1)
    r = th.roofline(flops / 2, flops / 2, nbytes, peaks, "fp8", "bf16")
    assert r["bound_by"] == "operations"
    assert r["bound_ms"] == pytest.approx(
        (flops / 2 / 1979e12 + flops / 2 / 989e12) * 1e3)
    assert 0.83 < r["bound_ms"] < 0.84
    res = th.BenchResult("x", r["bound_ms"] / 1e3 * 10, flops, nbytes, 0.0,
                         {}, peaks)
    assert res.roofline_fraction("fp8", "bf16") == pytest.approx(0.1)
    assert th.device_peaks("cpu")["hbm_bytes"] is None


def test_time_fn_on_the_cpu():
    x = torch.ones(64, 64)
    assert th.time_fn(torch.matmul, x, x, iters=3, warmup=1) > 0


@pytest.mark.parametrize("argv", [
    ["--dtype", "float8_e4m3fn"], ["--dtype", "int8", "--mode", "e2e"],
    ["--dtype", "float8_e5m2"], ["--dtype", "bf16"]],
    ids=["fp8_serving", "int8_e2e", "e5m2_serving", "bf16"])
def test_headline_runs_on_the_cpu(argv, capsys):
    """The headline at --seqlen 256 --batch 1 --heads 2 --device cpu
    passes its gate and prints exactly one JSON line on stdout."""
    out = headline.main(["--seqlen", "256", "--batch", "1", "--heads", "2",
                         "--device", "cpu", "--iters", "1", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["unit"] == "TFLOP/s" and row["value"] > 0
    assert "cpu" in row["metric"]
    assert out["max_abs_err"] <= out["tol"]


@pytest.mark.parametrize("suite,names", [
    ("softmax", {"row_onepass", "row_twopass", "column_onepass",
                 "column_twopass"}),
    ("matmul", {"matmul_f32", "matmul_ragged_bf16", "matvec_bf16"}),
    ("ndim", {"dense2d", "dense2d_fp8", "dense3d", "block2d",
              "windowed2d_fp8"}),
    ("bands", {"circulant", "block"}),
    ("backward", {"dense_fwd_bwd", "dense_fwd_bwd_dpq", "causal_fwd_bwd",
                  "sliding_fwd_bwd", "circulant_fwd_bwd"})])
def test_sweep_suites_run_on_the_cpu(suite, names, capsys):
    """Each sweep suite at --tiny --device cpu passes its gates and prints
    one JSON row per case (every softmax path taken), naming the CPU."""
    rows = sweep.main(["--suite", suite, "--device", "cpu", "--tiny",
                       "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(rows)
    printed = [json.loads(line) for line in lines]
    key = "path" if suite == "softmax" else "name"
    assert {r[key] for r in printed} == names
    for r in printed:
        assert r["device"] == "cpu" and r["ms"] > 0 and r["bound_ms"] is None
        assert r["rel_err" if suite == "matmul" else "max_abs_err"] <= r["tol"]


def test_float32_peak_bounds_a_float32_matmul():
    """The float32 peak bounds a float32 matmul at 4096³ by operations:
    137 GFLOP / 67 TFLOP/s = 2.05 ms."""
    peaks = dict(th.device_peaks("cpu"), f32=67e12, bf16=989e12,
                 hbm_bytes=3.35e12)
    b = th.roofline(2 * 4096 ** 3, 0, 3 * 4 * 4096 ** 2, peaks, "f32", "f32")
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(2 * 4096 ** 3 / 67e12 * 1e3)
    assert "f32" in th.device_peaks("cpu")
