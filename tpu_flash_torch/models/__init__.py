from tpu_flash_torch.models.transformer import (
    ModelConfig,
    decode_step,
    forward,
    init_params,
    prefill,
)
