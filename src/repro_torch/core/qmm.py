"""The QMM engine entry point (port of ``repro.core.qmm``).

``qmm(x, w, backend=...)`` resolves the backend through the port's
registry and runs it.  This module registers ``mxu``: the plain PyTorch
integer product under the flow abstraction.  The hand-written kernels
register as ``pallas`` and ``fused`` in ``repro_torch.kernels.ops``.
The reference's ``popcount`` backend and ``backend="auto"`` (measured
dispatch) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend_registry, flow_abstraction
from repro_torch.core.precision import PrecisionMode
from repro_torch.core.quantization import QuantTensor

__all__ = ["qmm"]


def qmm(
    x: QuantTensor,
    w: QuantTensor,
    *,
    backend: str = "mxu",
    mode: Optional[PrecisionMode] = None,
    w_colsum: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Quantized matmul through the flow abstraction on a named backend."""
    if mode is not None and (x.bits, w.bits) not in {
        (mode.act_bits, mode.weight_bits),
        (mode.act_bits, mode.act_bits),
    }:
        raise ValueError(
            f"operands W{w.bits}A{x.bits} do not match engine mode {mode.name}"
        )
    spec = backend_registry.get_backend(backend)
    return spec.run(x, w, w_colsum=w_colsum, out_dtype=out_dtype)


def _run_mxu(x: QuantTensor, w: QuantTensor, *, w_colsum=None, out_dtype=torch.float32):
    return flow_abstraction.qmm_flow(x, w, w_colsum=w_colsum, out_dtype=out_dtype)


backend_registry.register(
    backend_registry.QMMBackend(
        name="mxu",
        run=_run_mxu,
        description="plain PyTorch integer product (float64, exact) + flow epilogue",
    )
)
