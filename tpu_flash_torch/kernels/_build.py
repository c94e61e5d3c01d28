"""Build and load the port's hand-written CUDA kernels.

``tpu_flash_torch/csrc/*.cu`` compile with ``nvcc`` into one shared library
with a plain C interface, loaded through ``ctypes``: one ``nvcc -c`` per
source, all started together, then one link. No source includes PyTorch's
headers; the TMA + wgmma and bulk-copy kernels (B1, B2, B4/B5, B6/B7, B14)
share ``csrc/hopper.cuh``.
A cold build takes about two minutes on an H100 machine, nearly all of it
``paged_attention.cu`` (70 instantiations of ``paged_attention.cuh``'s
kernels), the other sources finishing within it (``paged_attention_wide.cu``
compiles the 30 above head dim 256 beside it, ``flash_bwd_wide.cu`` the
bf16 width-512 instantiations of ``flash_bwd_tc.cuh``'s kernels,
``flash_bwd_f32_wide.cu`` the float32 ones of widths 256 and 512 of
``flash_bwd_f32.cuh``'s). The library lands in
``build/tpu_flash_torch/<key>/`` at the repository root, keyed by a hash of
the flags, the sources and the headers (:func:`build_key`), and is built on
first use — never at import. A failed build raises with nvcc's output.
``python -m tpu_flash_torch.kernels._build <source>.cu`` prints each
kernel's registers and spill bytes (ptxas).
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
    "-Xcompiler", "-fPIC",
]

_lib = None

_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# Each entry point returns cudaError_t (an int); 0 is success.
_SIGNATURES = {
    # q, k, v, o, lse, kmax, bh_q, n_q, n_kv, hq, hkv, d, dv, kind, offset,
    # radius, section, dtype, stream
    "tf_flash_fwd": [_vp] * 6 + [_i32] * 12 + [_vp],
    # q, new_k, new_v, k_pages, v_pages, k_scales, v_scales, slots,
    # lengths, lengths_override, positions, page_tables, out, lse, ws_acc,
    # ws_ml, tickets, b, kvh, g, d, page, total_pages, max_pages,
    # pages_bound, len_add, radius, q_dtype, in_dtype, page_type,
    # out_dtype, route, split_pages, n_splits, qscale, stream
    "tf_paged_attention": [_vp] * 17 + [_i32] * 17 + [ctypes.c_float, _vp],
    # k_new, v_new, k_pages, v_pages, k_scales, v_scales, slots, lengths,
    # page_tables, b, kvh, d, page, total_pages, max_pages, in_dtype,
    # page_type, stream
    "tf_paged_append": [_vp] * 9 + [_i32] * 8 + [_vp],
    # q, k, v, dout, lse2, delta, dq, v8, do8, sdo, bh_q, n_q, n_kv, hq,
    # hkv, d, kind, offset, radius, section, dtype, stream
    "tf_flash_bwd_dq": [_vp] * 10 + [_i32] * 11 + [_vp],
    # q, k, v, dout, lse2, delta, dk, dv, v8, do8, qs, bh_kv, n_q, n_kv, hq,
    # hkv, d, dv, kind, offset, radius, section, dtype, stream
    "tf_flash_bwd_dkv": [_vp] * 11 + [_i32] * 12 + [_vp],
    # q, k, v, sk_token, sk_tensor, sv, gk, o, lse, q_out, qs_out, order,
    # bh, n_q, n_kv, hq, hkv, d, kind, offset, radius, section, q_mode,
    # q_f32, kv_dtype, pv_quant, c, stream
    "tf_serving_attention": [_vp] * 12 + [_i32] * 14 + [ctypes.c_float, _vp],
    # q, sq, k, v, sk_token, sv, gk, o, lse, order, bh, n_q, n_kv, hq, hkv,
    # d, kind, offset, radius, section, q_kind, kv_dtype, o_f32, c, stream
    "tf_quant_attention": [_vp] * 10 + [_i32] * 13 + [ctypes.c_float, _vp],
    # x, out, n, fibers, m, dtype, stream
    "tf_softmax_onepass": [_vp] * 2 + [_i32] * 4 + [_vp],
    # x, lse, n, fibers, m, dtype, stream
    "tf_softmax_stats": [_vp] * 2 + [_i32] * 4 + [_vp],
    # x, lse, out, n, fibers, m, dtype, stream
    "tf_softmax_norm": [_vp] * 3 + [_i32] * 4 + [_vp],
    # a, b, out, m, n, k, in_dtype, out_dtype, route, stream
    "tf_matmul": [_vp] * 3 + [_i32] * 6 + [_vp],
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


def build_key(csrc: str, sources) -> str:
    """The build directory's key: a hash of the flags, the named sources
    and every header (``*.cuh``) of ``csrc``, so that a header's edit
    rebuilds every source that may include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(csrc, "*.cuh")))
    for path in [*sorted(sources), *headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    out_dir = os.path.join(_BUILD_ROOT, build_key(_CSRC, srcs))
    so = os.path.join(out_dir, "libtpu_flash_torch.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
        objs = [os.path.join(out_dir, os.path.basename(p) + f".{tag}.o")
                for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        outs = [(p, proc.communicate()[0], proc.returncode)
                for p, proc in zip(srcs, procs)]
        failed = [f"{p}:\n{out}" for p, out, rc in outs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{so}.{tag}"
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        for o in objs:
            os.remove(o)
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


def ptxas_report(source: str) -> list:
    """Registers and spill bytes of each kernel in ``csrc/<source>``, from
    ``nvcc -Xptxas -v`` with the build's flags → [(kernel, line), ...];
    ptxas's warnings and performance notes (a serialized wgmma) come as
    ("ptxas", line)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k.o"), os.path.join(_CSRC, source)],
            capture_output=True, text=True, check=True)
    rows, kernel = [], None
    for line in (out.stdout + out.stderr).splitlines():
        if "Performance Loss" in line or "warning" in line:
            rows.append(["ptxas", line.strip()])  # e.g. serialized wgmma
        elif "Function properties for" in line:
            kernel = [line.split("Function properties for")[-1].strip(), ""]
            rows.append(kernel)
        elif kernel and ("spill" in line or "Used" in line):
            part = line.split(":", 1)[-1].strip() if "Used" in line else line.strip()
            kernel[1] = f"{kernel[1]}; {part}" if kernel[1] else part
    return [tuple(r) for r in rows]


if __name__ == "__main__":  # python -m tpu_flash_torch.kernels._build SOURCE
    import sys

    for kernel, line in ptxas_report(sys.argv[1]):
        print(f"{kernel}: {line}")
