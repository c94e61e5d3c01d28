"""tpu_flash_torch — tpu_flash on PyTorch and CUDA (Hopper).

A port of ``tpu_flash`` beside it, module for module: the same public
functions on the same layouts (``(batch, heads, seq, dim)`` for attention,
``(batch, *spatial, heads, dim)`` for the N-d wrappers, ``(kv_heads,
total_pages, page, stor)`` for pages), held against the reference by
``tests/test_torch_*.py``. Every TPU kernel of the reference has a
hand-written CUDA counterpart for sm_90a (``csrc/``), built with nvcc at
first use; every kernel keeps a plain PyTorch version that CPU tensors
take. Imports torch and numpy only.
"""

from tpu_flash_torch.ops.oracle import (
    block_dpa,
    blockwise_dpa,
    circulant_dpa,
    dense_dpa,
    sliding_dpa,
    windowed_dpa,
)
from tpu_flash_torch.ops.flash import (
    block_fa,
    circulant_fa,
    dense_fa,
    flash_attention,
    sliding_fa,
    windowed_fa,
)
from tpu_flash_torch.ops.matmul import circulant_matmul, matmul, matvec
from tpu_flash_torch.ops.paged import (
    fused_append,
    paged_attention,
    paged_attention_pipelined,
)
from tpu_flash_torch.ops.schedule import (
    BlockDiagonalSchedule,
    CausalSchedule,
    CirculantSchedule,
    DenseSchedule,
    LocalSchedule,
    Schedule,
)
from tpu_flash_torch.ops.softmax import fused_softmax

__version__ = "0.1.0"

__all__ = [
    "dense_dpa",
    "windowed_dpa",
    "block_dpa",
    "blockwise_dpa",
    "circulant_dpa",
    "sliding_dpa",
    "dense_fa",
    "windowed_fa",
    "block_fa",
    "circulant_fa",
    "sliding_fa",
    "flash_attention",
    "fused_softmax",
    "matmul",
    "matvec",
    "circulant_matmul",
    "fused_append",
    "paged_attention",
    "paged_attention_pipelined",
    "Schedule",
    "DenseSchedule",
    "CausalSchedule",
    "LocalSchedule",
    "BlockDiagonalSchedule",
    "CirculantSchedule",
]
