"""The port's own QMM backend registry (counterpart of
``repro.core.backend_registry``, which the port never touches).

A backend is one :class:`QMMBackend` spec, registered by name; every
consumer (``qmm(backend=)``, ``QuantConfig`` validation, the measured
dispatcher ``core/dispatch.py``) enumerates the registry.
``repro_torch.core.qmm`` registers ``mxu`` and ``popcount``;
``repro_torch.kernels.ops`` registers ``pallas`` and ``fused`` and the
scores-only ``binary`` and ``float``.  Enumeration imports both lazily, so
the order of names (the autotuner's candidate order) is the same whichever
module is imported first.

Capabilities, as in the reference:

* ``families`` -- ``"qmm"`` (the rank-2 quantized matmul, the ``run``
  contract) and / or ``"scores"`` (rank-4 attention scores, the
  ``run_scores`` contract: packed Q / K planes in, int32 AND-popcount
  counts out, W1A1 only).  ``qmm`` rejects a scores-only backend.
* ``precisions`` -- the ``(act_bits, weight_bits)`` pairs served, None for all;
* ``rank2_only`` -- rank-2 operands only (the kernel backends);
* ``cuda_kernel`` -- launches a hand-written CUDA kernel on CUDA tensors.
  On a card only these are candidates (``candidate_names(on_card=True)``):
  ``"auto"`` never picks a plain PyTorch core there;
* ``traffic_model`` -- optional ``f(m, k, n, act_bits, weight_bits) -> int``,
  the bytes one problem moves to and from device memory as the reference
  models them; ``core/qmm_roofline.py`` places the backend against the
  card's memory roof with it (the packed-operand floor when None).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, FrozenSet, Optional, Tuple

__all__ = [
    "QMMBackend",
    "register",
    "register_backend",
    "unregister",
    "get_backend",
    "backend_names",
    "backend_specs",
    "candidate_names",
]

_BUILTIN_MODULES = ("repro_torch.core.qmm", "repro_torch.kernels.ops")


@dataclasses.dataclass(frozen=True)
class QMMBackend:
    """One integer-core backend: ``run(x, w, *, w_colsum, out_dtype)`` over
    :class:`~repro_torch.core.quantization.QuantTensor` operands, and for
    the scores family ``run_scores(q_planes (B,H,S,dw), k_planes (B,G,T,dw),
    *, dh) -> int32 (B,H,S,T)`` over int32 words carrying the planes' bits."""

    name: str
    run: Callable
    description: str = ""
    precisions: Optional[FrozenSet[Tuple[int, int]]] = None
    rank2_only: bool = False
    cuda_kernel: bool = False
    traffic_model: Optional[Callable[[int, int, int, int, int], int]] = None
    families: FrozenSet[str] = frozenset({"qmm"})
    run_scores: Optional[Callable] = None

    def supports_precision(self, act_bits: int, weight_bits: int) -> bool:
        return self.precisions is None or (int(act_bits), int(weight_bits)) in self.precisions

    def eligible(self, m: int, k: int, n: int, act_bits: int, weight_bits: int, *,
                 rank2: bool = True, family: str = "qmm", on_card: bool = False) -> bool:
        """Can this backend serve this problem (on a card: with its kernel)?"""
        if on_card and not self.cuda_kernel:
            return False
        if family not in self.families:
            return False
        if family == "scores" and self.run_scores is None:
            return False
        if family == "qmm" and self.rank2_only and not rank2:
            return False
        return self.supports_precision(act_bits, weight_bits)


_REGISTRY: Dict[str, QMMBackend] = {}


def register(spec: QMMBackend) -> QMMBackend:
    """Add ``spec``; a name is a backend's identity in configs and autotune
    caches, so duplicates (and the reserved ``"auto"``) are refused."""
    if spec.name in _REGISTRY:
        raise ValueError(f"backend {spec.name!r} is already registered")
    if not spec.name or spec.name == "auto":
        raise ValueError(f"invalid backend name {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def register_backend(name: str, **caps):
    """Decorator form of :func:`register` over the run callable, which it
    returns unchanged."""

    def deco(fn: Callable) -> Callable:
        register(QMMBackend(name=name, run=fn, **caps))
        return fn

    return deco


def unregister(name: str) -> None:
    """Remove a backend (test isolation; no-op if absent)."""
    _REGISTRY.pop(name, None)


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


def backend_names(family: Optional[str] = None) -> Tuple[str, ...]:
    """Every registered name in registration order; with ``family``, those
    serving that operator family."""
    _load_builtins()
    return tuple(n for n, s in _REGISTRY.items() if family is None or family in s.families)


def backend_specs() -> Tuple[QMMBackend, ...]:
    _load_builtins()
    return tuple(_REGISTRY.values())


def candidate_names(m: int, k: int, n: int, act_bits: int, weight_bits: int, *,
                    rank2: bool = True, family: str = "qmm", on_card: bool = False) -> Tuple[str, ...]:
    """Names of every backend eligible for this problem: the availability
    part of an autotune key.  ``on_card``: the hand-written kernels only."""
    _load_builtins()
    return tuple(
        s.name for s in _REGISTRY.values()
        if s.eligible(m, k, n, act_bits, weight_bits, rank2=rank2, family=family, on_card=on_card)
    )
