"""tpu_flash_torch — the tpu_flash serving path on PyTorch and CUDA (Hopper).

A port of ``tpu_flash`` beside it, module for module: the same public
functions on the same layouts (``(batch, heads, seq, dim)`` for attention,
``(kv_heads, total_pages, page, stor)`` for pages), held against the
reference by ``tests/test_torch_*.py``. The reference's TPU kernels on the
serving path are hand-written CUDA kernels for sm_90a (``csrc/``), built
with nvcc at first use; every kernel keeps a plain PyTorch version that CPU
tensors take. Imports torch and numpy only.
"""

from tpu_flash_torch.ops.oracle import dense_dpa, sliding_dpa
from tpu_flash_torch.ops.flash import dense_fa, flash_attention, sliding_fa
from tpu_flash_torch.ops.paged import (
    fused_append,
    paged_attention,
    paged_attention_pipelined,
)
from tpu_flash_torch.ops.schedule import (
    CausalSchedule,
    DenseSchedule,
    LocalSchedule,
    Schedule,
)

__version__ = "0.1.0"

__all__ = [
    "dense_dpa",
    "sliding_dpa",
    "dense_fa",
    "sliding_fa",
    "flash_attention",
    "fused_append",
    "paged_attention",
    "paged_attention_pipelined",
    "Schedule",
    "DenseSchedule",
    "CausalSchedule",
    "LocalSchedule",
]
