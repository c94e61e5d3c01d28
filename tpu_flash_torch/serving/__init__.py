from tpu_flash_torch.serving.engine import (
    Engine,
    EngineConfig,
    FinishedRequest,
    Request,
)
from tpu_flash_torch.serving.checkpoint import load_checkpoint, save_checkpoint
from tpu_flash_torch.serving.prefix_cache import PrefixCache
from tpu_flash_torch.serving.seq_engine import SeqShardedEngine
from tpu_flash_torch.serving.supervisor import Supervisor, SupervisorConfig
