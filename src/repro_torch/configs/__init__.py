"""Configs the port serves.  Importing this package registers them."""

from repro_torch.configs import bit_bert, granite_8b  # noqa: F401  (registration)
from repro_torch.configs.base import ArchConfig, QuantConfig, get_config

__all__ = ["ArchConfig", "QuantConfig", "get_config"]
