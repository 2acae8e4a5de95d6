"""Configs the port serves.  Importing this package registers them."""

from repro_torch.configs import (  # noqa: F401  (registration)
    bit_bert,
    deepseek_v2_lite_16b,
    deepseek_v3_671b,
    gemma3_27b,
    granite_8b,
    internvl2_2b,
    mamba2_130m,
    mistral_nemo_12b,
    qwen3_32b,
    recurrentgemma_2b,
    whisper_tiny,
)
from repro_torch.configs.base import (
    ArchConfig,
    EncoderConfig,
    MLAConfig,
    MoEConfig,
    QuantConfig,
    SSMConfig,
    get_config,
    list_configs,
)

__all__ = ["ArchConfig", "EncoderConfig", "MLAConfig", "MoEConfig", "QuantConfig", "SSMConfig", "get_config",
           "list_configs"]
