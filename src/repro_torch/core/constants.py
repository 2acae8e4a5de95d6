"""Scalar constants of the serving step, made once per (value, dtype, device).

``torch.tensor(3.0, device="cuda")`` copies a host value to the card, and a
CUDA graph cannot capture that copy.  So the step glue asks :func:`scalar`
for its constants: the first call makes the 0-d tensor (outside any
capture, on the warm-up call), every later call returns the same tensor.
The value is rounded to ``dtype`` exactly as ``torch.tensor`` rounds it, so
``x * scalar(c, x.dtype, x.device)`` keeps the reference's arithmetic (a
Python float there would compute in float32 with the unrounded value).

The returned tensors are shared: callers must not write to them.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["scalar", "as_scalar"]


@functools.lru_cache(maxsize=None)
def _made(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-d ``dtype`` tensor holding ``value`` on ``device``, made once."""
    return _made(value, dtype, torch.device(device))


def as_scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``, but a Python
    number goes through :func:`scalar` instead of a fresh host copy."""
    if isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=dtype, device=device)
    return scalar(value, dtype, device)
