"""Attention-scores bench on the card's roofs (port of ``repro.core.attn_bench``).

The sibling of :mod:`repro_torch.core.qmm_roofline` for the scores family:
one cell per (backend x attention shape), the model columns beside the
measured time.

* the candidate set is ``backend_registry.backend_names(family="scores")``;
* bytes come from the backend's ``traffic_model``, keyed as the scores
  family keys a problem: ``m = B*H*S``, ``k = dh``, ``n = T``, act = weight =
  1 (the packed-operand floor where a backend has none);
* the useful work is ``2 * B*H*S * dh * T`` operations whatever the core.

The roofs are ``qmm_roofline``'s (the H100 SXM's).  ``measure_cell`` times
``spec.run_scores`` with the autotuner's timer, the operands rotated
through copies on a card as ``qmm_roofline.measure_cell`` rotates them;
a share ``roof_us / measured_us`` over 1.0 is an error.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import backend_registry, packing
from repro_torch.core.qmm_roofline import (
    HBM_BW,
    PEAK_INT_OPS,
    _check_share,
    _roofs,
    _save,
    _timed,
    _title,
    _validate,
    default_traffic,
    make_document,
    rotated,
)

__all__ = [
    "SCHEMA",
    "HBM_BW",
    "PEAK_INT_OPS",
    "DEFAULT_SHAPES",
    "SMOKE_SHAPES",
    "make_planes",
    "cell_model",
    "measure_cell",
    "run_attn_bench",
    "validate_attn_bench",
    "save_attn_bench",
    "load_attn_bench",
    "format_table",
]

SCHEMA = "attn-scores-torch/v1"

#: (B, H, G, S, T, dh): a prefill-shaped cell, a GQA decode against a long
#: cache, and a T past one block of keys (the reference's).
DEFAULT_SHAPES: Tuple[Tuple[int, int, int, int, int, int], ...] = (
    (1, 8, 8, 128, 128, 64),
    (2, 8, 2, 1, 256, 64),
    (1, 4, 2, 16, 384, 128),
)

SMOKE_SHAPES: Tuple[Tuple[int, int, int, int, int, int], ...] = ((1, 4, 2, 8, 16, 32),)

_CELL_NUMERIC_KEYS = (
    "b",
    "h",
    "g",
    "s",
    "t",
    "dh",
    "flops",
    "bytes",
    "intensity",
    "t_compute_us",
    "t_memory_us",
    "roof_us",
    "measured_us",
)


def make_planes(b: int, heads: int, s: int, dh: int, *, seed: int = 0, device="cuda") -> torch.Tensor:
    """Random packed {0,1} planes ``(B, heads, S, dw)``: the reference's
    words bit for bit, held as int32."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(b, heads, s, dh)).astype(np.int32)
    return packing.pack_bits(torch.from_numpy(bits).to(device), 1, axis=-1)


def cell_model(backend: str, b: int, h: int, g: int, s: int, t: int, dh: int) -> Dict:
    """The analytical half of one cell: bytes, intensity, both roofs."""
    spec = backend_registry.get_backend(backend)
    traffic = spec.traffic_model or default_traffic
    m = b * h * s
    cell = {"backend": backend, "b": int(b), "h": int(h), "g": int(g), "s": int(s),
            "t": int(t), "dh": int(dh)}
    cell.update(_roofs(2.0 * m * dh * t, float(traffic(m, dh, t, 1, 1))))
    return cell


def measure_cell(
    backend: str,
    b: int,
    h: int,
    g: int,
    s: int,
    t: int,
    dh: int,
    *,
    warmup: int = 1,
    reps: int = 3,
    device="cuda",
) -> Dict:
    """One cell: the model columns and the measured time of the core on
    ``device``."""
    cell = cell_model(backend, b, h, g, s, t, dh)
    spec = backend_registry.get_backend(backend)
    planes = (make_planes(b, h, s, dh, seed=b * 31 + s, device=device),
              make_planes(b, g, t, dh, seed=g * 37 + t, device=device))

    def call(q_planes, k_planes):
        return spec.run_scores(q_planes, k_planes, dh=dh)

    cell["measured_us"] = _timed(call, rotated(planes, device), warmup=warmup, reps=reps) * 1e6
    return _check_share(cell, f"attn scores cell {backend} {(b, h, g, s, t, dh)}")


def run_attn_bench(
    shapes: Sequence[Tuple[int, int, int, int, int, int]] = DEFAULT_SHAPES,
    backends: Optional[Iterable[str]] = None,
    *,
    warmup: int = 1,
    reps: int = 3,
    device="cuda",
) -> Dict:
    """Measure every (backend x shape) cell on ``device``; returns the document."""
    names = tuple(backends) if backends else backend_registry.backend_names(family="scores")
    cells: List[Dict] = []
    for b, h, g, s, t, dh in shapes:
        for name in names:
            cells.append(measure_cell(name, b, h, g, s, t, dh, warmup=warmup, reps=reps,
                                      device=device))
    return make_document(cells, device, names, schema=SCHEMA)


def validate_attn_bench(doc: Dict) -> Dict:
    """Schema check; raises ValueError on any violation, returns ``doc``.
    Every currently registered scores backend must have a cell."""
    return _validate(doc, SCHEMA, _CELL_NUMERIC_KEYS, "scores", "attn scores")


def save_attn_bench(path: str, doc: Dict) -> None:
    validate_attn_bench(doc)
    _save(path, doc)


def load_attn_bench(path: str) -> Dict:
    with open(path) as f:
        return validate_attn_bench(json.load(f))


def format_table(doc: Dict) -> str:
    """One line a cell, with its share of the roof (``roof_us / measured_us``)."""
    lines = [
        _title(doc, "attn scores"),
        "backend   B  H  G  S    T    dh   bytes      AI       roof_us  bound    measured_us  share",
    ]
    for c in doc["cells"]:
        lines.append(
            f"{c['backend']:<10}{c['b']:<3}{c['h']:<3}{c['g']:<3}{c['s']:<5}"
            f"{c['t']:<5}{c['dh']:<5}"
            f"{c['bytes']:<11.4g}{c['intensity']:<9.1f}"
            f"{c['roof_us']:<9.3f}{c['bound']:<9}{c['measured_us']:<13.3f}"
            f"{c['roof_us'] / c['measured_us']:.4f}"
        )
    return "\n".join(lines)
