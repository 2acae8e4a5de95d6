"""Data layer of the port (``repro.data``'s counterpart)."""

from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
