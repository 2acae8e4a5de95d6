"""Configs the port serves.  Importing this package registers them."""

from repro_torch.configs import (  # noqa: F401  (registration)
    bit_bert,
    gemma3_27b,
    granite_8b,
    mistral_nemo_12b,
    qwen3_32b,
)
from repro_torch.configs.base import ArchConfig, QuantConfig, get_config

__all__ = ["ArchConfig", "QuantConfig", "get_config"]
