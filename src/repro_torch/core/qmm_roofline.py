"""QMM backend roofline on the card's roofs (port of ``repro.core.qmm_roofline``).

One cell places one registered ``qmm`` backend at one problem (M, K, N,
act_bits, weight_bits) against the two roofs of an H100 SXM:

* the candidate set is ``backend_registry.backend_names(family="qmm")``, so
  a newly registered backend shows up with no edit here (the scores family
  has its own bench, ``core/attn_bench.py``);
* each backend's bytes come from its registered ``traffic_model`` (the
  reference's integers; where a port core moves other bytes, its model's
  comment says so), falling back to :func:`default_traffic`, the
  packed-operand floor;
* the useful work is ``2*M*K*N`` operations whatever the datapath, as in the
  reference: the staged and fused kernels and the plain cores compute the
  same logical product and pay different memory bills for it.

Roofs: the H100 SXM data sheet, 3.35 TB/s of HBM3 (``HBM_BW``) and 1,979
dense int8 tensor-core TOP/s at 700 W (``PEAK_INT_OPS``).  A card set below
700 W runs slower under load; a document made on a card records the card's
name and power limit beside the roofs.

``measure_cell`` times ``qmm(backend=)`` on the autotuner's synthetic
problem for the same key (``dispatch.make_problem``) with the autotuner's
timer (``dispatch._best_time``: on a card a CUDA graph of 16 calls replayed
between CUDA events, the fastest of ``reps``), so a cell's ``measured_us``
is comparable with the autotune cache's ``timings_us``.  On a card the 16
calls walk through copies of the operands whose bytes together pass twice
the 50 MB L2, as a decode finds its weights: one operand replayed 16 times
would be read from L2 and undercut the HBM roof.  A cell whose
``roof_us / measured_us`` passes 1.0 is an error, not a result.  On the
CPU the measured numbers are host times of the plain versions and only the
model columns describe the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import backend_registry, dispatch, packing

__all__ = [
    "SCHEMA",
    "HBM_BW",
    "PEAK_INT_OPS",
    "L2_BYTES",
    "DEFAULT_SHAPES",
    "DEFAULT_PRECISIONS",
    "SMOKE_SHAPES",
    "SMOKE_PRECISIONS",
    "default_traffic",
    "cell_model",
    "make_problem",
    "rotation_copies",
    "measure_cell",
    "make_document",
    "run_qmm_roofline",
    "validate_qmm_bench",
    "save_qmm_bench",
    "load_qmm_bench",
    "format_table",
]

SCHEMA = "qmm-roofline-torch/v1"

#: H100 SXM roofs (data sheet): HBM3 bytes/s and dense int8 tensor-core
#: operations/s at the 700 W power limit.
HBM_BW = 3.35e12
PEAK_INT_OPS = 1.979e15
#: The H100 SXM's L2.
L2_BYTES = 50 * 2**20

#: (M, K, N): a prefill-shaped tile and a decode-shaped one (the reference's).
DEFAULT_SHAPES: Tuple[Tuple[int, int, int], ...] = ((64, 512, 512), (8, 512, 512))
#: (act_bits, weight_bits): the paper's W1A1 / W1A8 modes and A8xA8.
DEFAULT_PRECISIONS: Tuple[Tuple[int, int], ...] = ((1, 1), (8, 1), (8, 8))

SMOKE_SHAPES: Tuple[Tuple[int, int, int], ...] = ((8, 128, 128),)
SMOKE_PRECISIONS: Tuple[Tuple[int, int], ...] = ((1, 1), (8, 1), (8, 8))

_CELL_NUMERIC_KEYS = (
    "m",
    "k",
    "n",
    "act_bits",
    "weight_bits",
    "flops",
    "bytes",
    "intensity",
    "t_compute_us",
    "t_memory_us",
    "roof_us",
    "measured_us",
)


def default_traffic(m: int, k: int, n: int, act_bits: int, weight_bits: int) -> int:
    """Packed-operand floor for a backend with no traffic model: both
    operands as 1-bit planes, the float32 result out, the rank-1 correction
    vectors."""
    kw_bytes = 4 * packing.packed_len(k, 1)
    return (
        act_bits * m * kw_bytes
        + weight_bits * kw_bytes * n
        + 4 * m * n
        + 8 * (m + n)
    )


def _roofs(flops: float, nbytes: float) -> Dict:
    t_compute = flops / PEAK_INT_OPS
    t_memory = nbytes / HBM_BW
    return {
        "flops": flops,
        "bytes": nbytes,
        "intensity": flops / nbytes if nbytes else 0.0,
        "t_compute_us": t_compute * 1e6,
        "t_memory_us": t_memory * 1e6,
        "roof_us": max(t_compute, t_memory) * 1e6,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


def cell_model(backend: str, m: int, k: int, n: int, act_bits: int, weight_bits: int) -> Dict:
    """The analytical half of one cell: bytes, intensity, both roofs."""
    spec = backend_registry.get_backend(backend)
    traffic = spec.traffic_model or default_traffic
    cell = {
        "backend": backend,
        "m": int(m),
        "k": int(k),
        "n": int(n),
        "act_bits": int(act_bits),
        "weight_bits": int(weight_bits),
    }
    cell.update(_roofs(2.0 * m * k * n, float(traffic(m, k, n, act_bits, weight_bits))))
    return cell


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _clone(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        })
    if isinstance(obj, tuple):
        return tuple(_clone(o) for o in obj)
    return obj


def rotation_copies(nbytes: int, device) -> int:
    """Operand copies a timed call walks through: on a card enough that
    together they pass twice the L2 (at most the 16 calls of one timed
    graph), on the CPU one."""
    if torch.device(device).type != "cuda":
        return 1
    return max(1, min(dispatch._GRAPH_CALLS, -(-2 * L2_BYTES // max(int(nbytes), 1))))


def rotated(args, device) -> List:
    """``args`` (tensors, QuantTensors, tuples of them) and its clones, as
    many as :func:`rotation_copies` asks for their bytes."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(args))
    return [args] + [_clone(args) for _ in range(rotation_copies(nbytes, device) - 1)]


def _timed(fn, copies: List, *, warmup: int, reps: int) -> float:
    """Seconds a call, the autotuner's timer over calls that cycle through
    ``copies``."""
    turn = itertools.count()

    def call():
        return fn(*copies[next(turn) % len(copies)])

    return dispatch._best_time(call, warmup=warmup, reps=reps)


def _check_share(cell: Dict, what: str) -> Dict:
    share = cell["roof_us"] / cell["measured_us"]
    if share > 1.0:
        raise ValueError(f"{what}: roof {cell['roof_us']:.4f} us over measured "
                         f"{cell['measured_us']:.4f} us (share {share:.3f} > 1): the timing "
                         "read cached operands or the model undercounts bytes")
    return cell


def make_problem(m: int, k: int, n: int, act_bits: int, weight_bits: int, device="cuda"):
    """``(x, w, w_colsum)``: the autotuner's synthetic operands for this
    problem (``dispatch.make_problem``), the same for every backend."""
    return dispatch.make_problem(dispatch.TuneKey(m, k, n, act_bits, weight_bits, ()), device)


def measure_cell(
    backend: str,
    m: int,
    k: int,
    n: int,
    act_bits: int,
    weight_bits: int,
    *,
    warmup: int = 1,
    reps: int = 3,
    device="cuda",
    problem=None,
) -> Dict:
    """One cell: the model columns and the measured time of one
    ``qmm(backend=)`` on the autotuner's synthetic problem for the same key
    (``problem``, :func:`make_problem`'s, when the caller has made it),
    on ``device``."""
    from repro_torch.core import qmm as QE

    cell = cell_model(backend, m, k, n, act_bits, weight_bits)
    problem = problem or make_problem(m, k, n, act_bits, weight_bits, device)
    copies = rotated(problem, device)

    def call(xq, wq, colsum):
        return QE.qmm(xq, wq, backend=backend, w_colsum=colsum)

    cell["measured_us"] = _timed(call, copies, warmup=warmup, reps=reps) * 1e6
    return _check_share(cell, f"qmm roofline cell {backend} {(m, k, n)} A{act_bits}W{weight_bits}")


def card_info(device) -> Dict:
    """The card's name and power limit, as ``nvidia-smi`` gives them (a
    card below its 700 W runs slower under load); empty on the CPU."""
    if torch.device(device).type != "cuda":
        return {}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    name, limit = (s.strip() for s in out[min(index, len(out) - 1)].split(","))
    return {"name": name, "power_limit": limit}


def hardware(device) -> Dict:
    return dict({"hbm_bw": HBM_BW, "peak_int_ops": PEAK_INT_OPS}, **card_info(device))


def make_document(cells: List[Dict], device, backends: Iterable[str], schema: str = SCHEMA) -> Dict:
    """The document around ``cells`` measured on ``device``: the schema,
    the platform, the roofs and the card's name and power limit."""
    return {
        "schema": schema,
        "generated_unix": time.time(),
        "platform": "cuda" if torch.device(device).type == "cuda" else "cpu",
        "hardware": hardware(device),
        "backends": list(backends),
        "cells": cells,
    }


def run_qmm_roofline(
    shapes: Sequence[Tuple[int, int, int]] = DEFAULT_SHAPES,
    precisions: Sequence[Tuple[int, int]] = DEFAULT_PRECISIONS,
    backends: Optional[Iterable[str]] = None,
    *,
    warmup: int = 1,
    reps: int = 3,
    device="cuda",
) -> Dict:
    """Measure every (backend x shape x precision) cell on ``device``;
    returns the document."""
    names = tuple(backends) if backends else backend_registry.backend_names(family="qmm")
    cells: List[Dict] = []
    for m, k, n in shapes:
        for ab, wb in precisions:
            problem = make_problem(m, k, n, ab, wb, device)  # drawn once, on the host
            for b in names:
                cells.append(measure_cell(b, m, k, n, ab, wb, warmup=warmup, reps=reps,
                                          device=device, problem=problem))
            del problem
    return make_document(cells, device, names)


def _validate(doc: Dict, schema: str, numeric: Tuple[str, ...], family: str, what: str) -> Dict:
    if doc.get("schema") != schema:
        raise ValueError(f"{what} schema mismatch: got {doc.get('schema')!r}, want {schema!r}")
    hw = doc.get("hardware")
    if not isinstance(hw, dict) or not all(
        isinstance(hw.get(k), (int, float)) for k in ("hbm_bw", "peak_int_ops")
    ):
        raise ValueError(f"{what} 'hardware' must carry numeric roofs")
    if doc.get("platform") not in ("cuda", "cpu"):
        raise ValueError(f"{what} 'platform' must be 'cuda' or 'cpu'")
    cells = doc.get("cells")
    if not isinstance(cells, list) or not cells:
        raise ValueError(f"{what} 'cells' must be a non-empty list")
    for i, c in enumerate(cells):
        if not isinstance(c.get("backend"), str):
            raise ValueError(f"{what} cell {i} missing 'backend'")
        if c.get("bound") not in ("compute", "memory"):
            raise ValueError(f"{what} cell {i} has invalid 'bound'")
        for key in numeric:
            if not isinstance(c.get(key), (int, float)):
                raise ValueError(f"{what} cell {i} key {key!r} must be numeric")
    covered = {c["backend"] for c in cells}
    missing = set(backend_registry.backend_names(family=family)) - covered
    if missing:
        raise ValueError(f"{what} is stale: registered {family} backends {sorted(missing)} "
                         "have no cells; measure them again")
    return doc


def validate_qmm_bench(doc: Dict) -> Dict:
    """Schema check; raises ValueError on any violation, returns ``doc``.
    Every currently registered ``qmm`` backend must have a cell."""
    return _validate(doc, SCHEMA, _CELL_NUMERIC_KEYS, "qmm", "qmm roofline")


def _save(path: str, doc: Dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def save_qmm_bench(path: str, doc: Dict) -> None:
    validate_qmm_bench(doc)
    _save(path, doc)


def load_qmm_bench(path: str) -> Dict:
    with open(path) as f:
        return validate_qmm_bench(json.load(f))


def _title(doc: Dict, what: str) -> str:
    hw = doc["hardware"]
    card = f"{hw['name']}, {hw['power_limit']}; " if "name" in hw else ""
    return (f"# {what} ({doc['platform']}; {card}HBM {hw['hbm_bw']:.4g} B/s, "
            f"int peak {hw['peak_int_ops']:.4g} op/s)")


def format_table(doc: Dict) -> str:
    """One line a cell, with its share of the roof (``roof_us / measured_us``)."""
    lines = [
        _title(doc, "qmm roofline"),
        "backend   M     K      N      A/W   bytes      AI       roof_us  bound    measured_us  share",
    ]
    for c in doc["cells"]:
        lines.append(
            f"{c['backend']:<10}{c['m']:<6}{c['k']:<7}{c['n']:<7}"
            f"{c['act_bits']}/{c['weight_bits']:<4}"
            f"{c['bytes']:<11.4g}{c['intensity']:<9.1f}"
            f"{c['roof_us']:<9.3f}{c['bound']:<9}{c['measured_us']:<13.3f}"
            f"{c['roof_us'] / c['measured_us']:.4f}"
        )
    return "\n".join(lines)
