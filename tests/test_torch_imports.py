"""The port stands alone: it never imports the reference's framework, uses
no library attention or compiler, and CPU tensors never count as kernel
launches."""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_flash_torch import kernels

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "tpu_flash_torch")


def test_port_imports_without_jax():
    """A fresh interpreter (this one already has jax loaded by conftest)
    imports every module of the port and finds no jax in sys.modules."""
    mods = ["tpu_flash_torch"]
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                rel = os.path.relpath(os.path.join(dirpath, f[:-3]), _ROOT)
                mods.append(rel.replace(os.sep, "."))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert 'jax' not in sys.modules, 'jax imported'\n"
            + "assert 'tpu_flash' not in sys.modules, 'reference imported'\n"
            + "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_forbidden_api():
    """No jax, no library attention, no torch.compile anywhere in the
    port's sources (Python and CUDA)."""
    bad = re.compile(r"\bjax\b|scaled_dot_product_attention|torch\.compile")
    hits = []
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    for i, line in enumerate(fh, 1):
                        if bad.search(line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_cpu_tensors_launch_no_kernel():
    """The plain paths that CPU tensors take never touch the launch
    counters, through every wrapper of the serving, training and quantized
    attention paths, fused_softmax, matmul and the circulant and
    block-diagonal attention."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
    from tpu_flash_torch.ops.flash import dense_fa
    from tpu_flash_torch.ops.paged import paged_attention

    kernels.reset_launches()
    g = torch.Generator(device="cpu").manual_seed(0)
    q = torch.randn(1, 4, 40, 32, generator=g)
    kv = torch.randn(1, 2, 40, 32, generator=g)
    qg = q.clone().requires_grad_(True)
    dense_fa(qg, kv, kv, causal=True).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    cfg = CacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                      total_pages=8, max_seqs=2, max_pages_per_seq=4,
                      dtype="int8")
    cache = PagedKVCache.create(cfg, device="cpu")
    cache.page_tables[0] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    cache.write_prompt(0, kv[0], kv[0])
    slots = torch.zeros(1, dtype=torch.int32)
    new = torch.randn(1, 2, 32, generator=g)
    paged_attention(q[:, :, 0], cache, slots, new_kv=(new, new))
    cache.append(slots, new, new)
    from tpu_flash_torch.quant.flash_q import quantized_flash_attention
    from tpu_flash_torch.quant.serving_attn import (
        quantize_kv_cache,
        serving_flash_attention,
    )

    q64 = torch.randn(1, 4, 40, 64, generator=g)
    kv64 = torch.randn(1, 2, 40, 64, generator=g)
    quantized_flash_attention(q64, kv64, kv64, q_dtype="float8_e4m3fn",
                              kv_dtype="float8_e4m3fn")
    serving_flash_attention(q64, *quantize_kv_cache(kv64, kv64, "int8"),
                            q_dtype="int8")
    from tpu_flash_torch.ops.flash import block_fa, circulant_fa
    from tpu_flash_torch.ops.matmul import matmul
    from tpu_flash_torch.ops.softmax import fused_softmax

    fused_softmax(torch.randn(3, 20000, generator=g))  # two-pass
    fused_softmax(torch.randn(30, 40, generator=g), axis=0)  # one-pass
    matmul(q[0, 0], kv[0, 0].T)
    circulant_fa(q, kv, kv, 9)
    block_fa(q, kv, kv, 8)
    assert kernels.LAUNCHES == {"flash_fwd": 0, "paged_attention_split": 0,
                                "paged_attention_shared": 0,
                                "paged_append": 0, "paged_append_fused": 0,
                                "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0, "serving_attention": 0,
                                "quant_attention": 0, "softmax_onepass": 0,
                                "softmax_stats": 0, "softmax_norm": 0,
                                "matmul": 0}
    assert int(cache.lengths[0]) == 42


def test_build_key_follows_the_headers(tmp_path):
    """The kernel library's build key hashes csrc's headers with its
    sources: a byte added to hopper.cuh (which no .cu names in the
    key's source list) gives another key, so a stale library is never
    reused; the same bytes give the same key."""
    import glob
    import shutil

    from tpu_flash_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    srcs = sorted(glob.glob(str(csrc / "*.cu")))
    key = _build.build_key(str(csrc), srcs)
    assert key == _build.build_key(str(csrc), srcs)
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.build_key(str(csrc), srcs) != key


def _entry_points():
    from tpu_flash_torch.cache.paged_cache import PagedKVCache
    from tpu_flash_torch.models.lora import init_lora_bank
    from tpu_flash_torch.models.moe import init_moe_params
    from tpu_flash_torch.models.transformer import init_params
    from tpu_flash_torch.utils import convert

    return {"init_params": init_params, "PagedKVCache.create":
            PagedKVCache.create, "to_torch": convert.to_torch,
            "params_from_tree": convert.params_from_tree,
            "cache_from_reference": convert.cache_from_reference,
            "qarray_from_reference": convert.qarray_from_reference,
            "init_lora_bank": init_lora_bank,
            "init_moe_params": init_moe_params}


@pytest.mark.parametrize("name", ["init_params", "PagedKVCache.create",
                                  "to_torch", "params_from_tree",
                                  "cache_from_reference",
                                  "qarray_from_reference", "init_lora_bank",
                                  "init_moe_params"])
def test_entry_points_default_to_the_card(name):
    """Entry points put their tensors on the card unless the caller asks
    for the CPU (the CPU tests all pass device="cpu")."""
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_never_falls_back_to_the_cpu():
    """A call left at the default lands on the card, or raises where there
    is none; init_params refuses a generator on another device."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
    from tpu_flash_torch.models import transformer as tfm
    from tpu_flash_torch.utils.convert import to_torch

    cfg = CacheConfig(num_kv_heads=1, head_dim=32, page_size=16,
                      total_pages=2, max_seqs=1, max_pages_per_seq=1)
    if torch.cuda.is_available():
        assert PagedKVCache.create(cfg).k_pages.is_cuda
        assert to_torch(np.zeros(3, np.float32)).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            PagedKVCache.create(cfg)
        with pytest.raises((RuntimeError, AssertionError)):
            to_torch(np.zeros(3, np.float32))
    mcfg = tfm.ModelConfig(vocab_size=64, dim=32, num_layers=1,
                           num_q_heads=2, num_kv_heads=1, head_dim=16)
    with pytest.raises(ValueError, match="generator"):
        tfm.init_params(mcfg, torch.Generator(device="cpu"))
