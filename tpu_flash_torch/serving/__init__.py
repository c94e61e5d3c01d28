from tpu_flash_torch.serving.engine import (
    Engine,
    EngineConfig,
    FinishedRequest,
    Request,
)
from tpu_flash_torch.serving.seq_engine import SeqShardedEngine
