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

#: The ten assigned architectures (the reference's ``ASSIGNED``: the
#: dry-run's and the verifier's arch rows).
ASSIGNED = (
    "recurrentgemma-2b",
    "internvl2-2b",
    "deepseek-v3-671b",
    "deepseek-v2-lite-16b",
    "whisper-tiny",
    "mistral-nemo-12b",
    "granite-8b",
    "gemma3-27b",
    "qwen3-32b",
    "mamba2-130m",
)

__all__ = ["ASSIGNED", "ArchConfig", "EncoderConfig", "MLAConfig", "MoEConfig", "QuantConfig", "SSMConfig", "get_config",
           "list_configs"]
