"""Optimizers of the port (``repro.optim``'s counterpart): AdamW."""

from repro_torch.optim import adamw

__all__ = ["adamw"]
