"""Hand-written Hopper kernels: build/load (``_build``) and launch counts.

``LAUNCHES`` counts launches per kernel. Each wrapper adds one right after
its kernel launched, and nowhere else; the plain PyTorch versions never
touch it. A run that resets the counts and reads them afterwards can so
show that it went through the kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = {"flash_fwd": 0, "paged_attention": 0, "paged_append": 0}

# Storage type codes shared with the C entry points.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
