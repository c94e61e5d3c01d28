from tpu_flash_torch.models.transformer import (
    ModelConfig,
    decode_step,
    decode_verify,
    forward,
    init_params,
    prefill,
    prefill_chunk,
    quantize_weights,
)
