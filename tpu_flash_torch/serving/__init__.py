from tpu_flash_torch.serving.engine import (
    Engine,
    EngineConfig,
    FinishedRequest,
    Request,
)
