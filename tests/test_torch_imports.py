"""The port stands alone: it never imports the reference's framework, uses
no library attention or compiler, and CPU tensors never count as kernel
launches."""

import os
import re
import subprocess
import sys

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
    counters, through every wrapper of the serving path."""
    from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
    from tpu_flash_torch.ops.flash import dense_fa
    from tpu_flash_torch.ops.paged import paged_attention

    kernels.reset_launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 40, 32, generator=g)
    kv = torch.randn(1, 2, 40, 32, generator=g)
    dense_fa(q, kv, kv, causal=True)
    cfg = CacheConfig(num_kv_heads=2, head_dim=32, page_size=16,
                      total_pages=8, max_seqs=2, max_pages_per_seq=4,
                      dtype="int8")
    cache = PagedKVCache.create(cfg)
    cache.page_tables[0] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    cache.write_prompt(0, kv[0], kv[0])
    slots = torch.zeros(1, dtype=torch.int32)
    new = torch.randn(1, 2, 32, generator=g)
    paged_attention(q[:, :, 0], cache, slots, new_kv=(new, new))
    cache.append(slots, new, new)
    assert kernels.LAUNCHES == {"flash_fwd": 0, "paged_attention": 0,
                                "paged_append": 0}
    assert int(cache.lengths[0]) == 42
