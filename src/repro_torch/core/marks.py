"""Boundary marks: where packed bit-planes are made and consumed, and where
the kernels are, for the invariant verifier (``repro_torch.analysis.verifier``).

The reference's verifier reads these boundaries off the jaxpr: the named
``pjit``s of ``pack_bits`` / ``pack_bitplanes`` / ``to_bitplanes`` (packed
words out) and ``unpack_bits`` (logical mantissas out), the
``population_count`` primitive (counts out) and ``pallas_call`` (a trusted
kernel).  An eager PyTorch program carries no such names at the operator
level, so the port marks the functions themselves:

* ``PACKED``   -- the outputs are packed bit-planes;
* ``UNPACKED`` -- the outputs are logical mantissas (the mark clears);
* ``COUNTS``   -- the outputs are popcounts of packed words;
* ``KERNEL``   -- a trusted kernel boundary (the five kernel wrappers): its
  integer outputs are counts, and a low-precision float output fed packed
  or counted operands breaks exact accumulation.

A marked function computes exactly what it computes unmarked.  With no
observer (the default) a mark costs one contextvar read; under an observer
(:func:`observing`), the observer runs the function -- the plain version on
CPU tensors, the kernel's launch on CUDA ones, as the function itself
decides -- walks nothing inside it, and tags its outputs.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

__all__ = ["PACKED", "UNPACKED", "COUNTS", "KERNEL", "boundary", "observing"]

PACKED = "packed"
UNPACKED = "unpacked"
COUNTS = "counts"
KERNEL = "kernel"

_OBSERVER: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "boundary_observer", default=None
)


@contextlib.contextmanager
def observing(observer):
    """Route every marked call made while the block runs to
    ``observer.boundary(kind, name, fn, args, kwargs)``, which must call
    ``fn(*args, **kwargs)`` and return its result."""
    token = _OBSERVER.set(observer)
    try:
        yield observer
    finally:
        _OBSERVER.reset(token)


def boundary(kind: str):
    """Mark a function as a boundary of ``kind``, named by the function's
    own name."""
    if kind not in (PACKED, UNPACKED, COUNTS, KERNEL):
        raise ValueError(f"unknown boundary kind {kind!r}")

    def deco(fn):
        @functools.wraps(fn)
        def marked(*args, **kwargs):
            observer = _OBSERVER.get()
            if observer is None:
                return fn(*args, **kwargs)
            return observer.boundary(kind, fn.__name__, fn, args, kwargs)

        return marked

    return deco
