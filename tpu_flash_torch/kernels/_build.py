"""Build and load the port's hand-written CUDA kernels.

``tpu_flash_torch/csrc/*.cu`` compile with ``nvcc`` into one shared library
with a plain C interface, loaded through ``ctypes``. No source includes
PyTorch's headers, so a cold build takes seconds. The library lands in
``build/tpu_flash_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, and is built on first use — never at import. A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "tpu_flash_torch")
# Never --use_fast_math: the append kernel's IEEE divide and rintf must
# match the host quantizer bit for bit.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lib = None

_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# Each entry point returns cudaError_t (an int); 0 is success.
_SIGNATURES = {
    # q, k, v, o, lse, bh_q, n_q, n_kv, hq, hkv, d, causal, offset,
    # dtype, stream
    "tf_flash_fwd": [_vp] * 5 + [_i32] * 9 + [_vp],
    # q, k_pages, v_pages, k_scales, v_scales, slots, lengths, page_tables,
    # out, lse, b, kvh, g, d, page, total_pages, max_pages, pages_bound,
    # len_add, cache_dtype, out_dtype, stream
    "tf_paged_attention": [_vp] * 10 + [_i32] * 11 + [_vp],
    # k_new, v_new, k_pages, v_pages, k_scales, v_scales, slots, lengths,
    # page_tables, b, kvh, d, page, total_pages, max_pages, in_dtype,
    # cache_dtype, stream
    "tf_paged_append": [_vp] * 9 + [_i32] * 8 + [_vp],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libtpu_flash_torch.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
