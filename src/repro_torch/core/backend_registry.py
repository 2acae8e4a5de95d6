"""The port's own QMM backend registry (counterpart of
``repro.core.backend_registry``, which the port never touches).

A backend is a name plus a ``run(x, w, *, w_colsum, out_dtype)`` callable
over :class:`~repro_torch.core.quantization.QuantTensor` operands.
``repro_torch.core.qmm`` registers ``mxu`` and ``popcount``;
``repro_torch.kernels.ops``
registers ``pallas`` and ``fused``.  Enumeration imports both lazily, so
the order of names is the same whichever module is imported first.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Tuple

__all__ = ["QMMBackend", "register", "get_backend", "backend_names"]

_BUILTIN_MODULES = ("repro_torch.core.qmm", "repro_torch.kernels.ops")


@dataclasses.dataclass(frozen=True)
class QMMBackend:
    name: str
    run: Callable
    description: str = ""


_REGISTRY: Dict[str, QMMBackend] = {}


def register(spec: QMMBackend) -> QMMBackend:
    if spec.name in _REGISTRY:
        raise ValueError(f"backend {spec.name!r} is already registered")
    _REGISTRY[spec.name] = spec
    return spec


def _load_builtins() -> None:
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def get_backend(name: str) -> QMMBackend:
    _load_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {tuple(_REGISTRY)}"
        ) from None


def backend_names() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(_REGISTRY)
