"""Hand-written Hopper kernels: build/load (``_build``) and launch counts.

``LAUNCHES`` counts launches per kernel, and per route where one kernel
file has several (B2: ``paged_attention_split`` and ``_shared``,
``ops/paged.py:paged_route``); ``paged_append_fused`` counts the split
route's launches that carry B3's append (B3's function on the decode path,
in the same launch). Each wrapper adds one right after its kernel
launched, and nowhere else; the plain PyTorch versions never touch it. A
run that resets the counts and reads them afterwards can so show that it
went through the kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = {"flash_fwd": 0, "paged_attention_split": 0,
            "paged_attention_shared": 0, "paged_append": 0,
            "paged_append_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "serving_attention": 0,
            "quant_attention": 0, "softmax_onepass": 0, "softmax_stats": 0,
            "softmax_norm": 0, "matmul": 0}

# Storage type codes shared with the C entry points.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Page type codes of the paged kernels (csrc/paged_page.cuh:PageType), by
# CacheConfig.page_type: int4 pages (halves-packed, d/2 bytes a row) are
# int8 tensors, so a page's type is always passed, never read off its
# dtype.
PAGE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int4": 3, "fp8": 4}
# Quantized cache codes of csrc/quant_attention.cu.
KV_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stream_handle(t: torch.Tensor) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise NotImplementedError(f"no CUDA kernel path for dtype {dtype}")
    return DTYPE_CODES[dtype]
