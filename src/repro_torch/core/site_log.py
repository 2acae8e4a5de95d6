"""Serve-mode QMM site log (port of ``repro.core.site_log``): the hook the
invariant verifier listens on.

Every serve-mode QMM site (dense ``qlinear`` projections, attention
act x act products) reports what it is about to execute: the site name,
the activation precision it quantized to, the mantissa dtype it produced,
and the backend configured for it.  Recording is off by default and costs
one contextvar read per site; ``repro_torch.analysis.verifier`` wraps its
prefill / decode runs in :func:`recording` and then checks the collected
sites against the declared ``QuantConfig`` invariants (precision per named
site, mantissa-dtype contract, named-site coverage).

This lives in ``core`` (not ``analysis``) so model code never imports the
analysis package: the dependency points one way, analysis observes models.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional

__all__ = ["recording", "record", "is_recording", "dtype_name"]

_LOG: contextvars.ContextVar[Optional[List[Dict]]] = contextvars.ContextVar(
    "qmm_site_log", default=None
)


def is_recording() -> bool:
    return _LOG.get() is not None


@contextlib.contextmanager
def recording():
    """Collect site records emitted while the block runs.

    Yields the list the sites append to; nested recordings shadow the outer
    one (each verifier run sees only its own sites).
    """
    token = _LOG.set([])
    try:
        yield _LOG.get()
    finally:
        _LOG.reset(token)


def record(**fields) -> None:
    """Append one site record if a recording is active (no-op otherwise).

    Canonical fields (see verifier._site_findings):
      kind: "qlinear" | "attn"
      site: dotted site name ("ffn.up", "attn.qk", ...); "" = unnamed
      bits: activation precision the site actually used
      cfg_bits: the precision QuantConfig declares for this site class
      mantissa_dtype: numpy's name of the quantized mantissa's dtype
        ("uint8", "int8", "int32"; :func:`dtype_name`)
      backend: the backend name configured for the site
    """
    log = _LOG.get()
    if log is not None:
        log.append(dict(fields))


def dtype_name(dtype) -> str:
    """A torch dtype as numpy names it (``torch.uint8`` -> ``"uint8"``), the
    form the reference's records carry."""
    return str(dtype).removeprefix("torch.")
