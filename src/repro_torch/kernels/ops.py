"""QuantTensor entry points over the kernels (port of ``repro.kernels.ops``):
operand preparation for the kernels and the registration of
the ``pallas`` and ``fused`` backends in the port's registry.

The CUDA kernels mask their ragged edges, so nothing here pads to a block
multiple (the reference pads for its TPU blocks; the results are equal).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend_registry, flow_abstraction, packing
from repro_torch.core.quantization import QuantTensor
from repro_torch.kernels import binary_qmm as _bq
from repro_torch.kernels import fused_qmm as _fq

__all__ = ["binary_qmm_int", "qmm_pallas", "qmm_fused"]


def binary_qmm_int(a: torch.Tensor, w_packed: torch.Tensor, k: int) -> torch.Tensor:
    """``a (M, K) int8 @ unpack(w_packed) (K, N)`` -> int32, any M/K/N."""
    return _bq.binary_qmm(a.contiguous(), w_packed.contiguous(), k)


def _rank2(name: str, x: QuantTensor, w: QuantTensor) -> None:
    if len(x.logical_shape) != 2 or len(w.logical_shape) != 2:
        raise ValueError(f"{name} expects rank-2 operands; flatten batch dims")


def _binary_int_matmul(x: QuantTensor, w: QuantTensor) -> torch.Tensor:
    """K1 on re-centered operands: int8 activations x packed 1-bit weights."""
    a8 = x.unpack(dtype=torch.int8).mantissa
    b_packed = w.mantissa if w.packed else packing.pack_bits(w.mantissa, 1, axis=0)
    return binary_qmm_int(a8, b_packed, x.logical_shape[-1])


def qmm_pallas(
    x: QuantTensor,
    w: QuantTensor,
    *,
    w_colsum: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The staged kernel path: K1 returns the integer product, then the
    flow-abstraction epilogue (``qmm_flow``) runs in PyTorch.

    Only the act x weight branch (1-bit weights, 2..8-bit activations) is
    ported; the reference's W1A1 branch (``popcount_qmm``, K3) and multi-bit
    act x act branch (``bitserial_qmm``, K4) are not yet.
    """
    _rank2("qmm_pallas", x, w)
    if w.bits != 1 or x.bits == 1:
        raise NotImplementedError(
            f"qmm_pallas: W{w.bits}A{x.bits} needs popcount_qmm (K3) or "
            "bitserial_qmm (K4), which are not ported yet"
        )
    return flow_abstraction.qmm_flow(
        x, w, w_colsum=w_colsum, out_dtype=out_dtype, int_matmul=_binary_int_matmul
    )


def qmm_fused(
    x: QuantTensor,
    w: QuantTensor,
    *,
    w_colsum: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One K2 launch: raw unsigned mantissa planes in, AND-popcount core and
    affine epilogue in the kernel.  ``w_colsum`` is ignored: the kernel
    counts the weight colsum from the planes it already reads."""
    _rank2("qmm_fused", x, w)
    del w_colsum
    m, k = x.logical_shape
    n = w.logical_shape[-1]
    if x.packed and x.bits == 1:
        a_planes = x.mantissa[None]
    else:
        a_planes = packing.pack_bitplanes(x.unpack(dtype=torch.int32).mantissa, x.bits, axis=-1)
    if w.packed and w.bits == 1:
        b_planes = w.mantissa[None]
    else:
        b_planes = packing.pack_bitplanes(w.unpack(dtype=torch.int32).mantissa, w.bits, axis=-2)
    f32, dev = torch.float32, a_planes.device

    def coeff(v, shape):
        return torch.as_tensor(v, dtype=f32, device=dev).broadcast_to(shape).contiguous()

    out = _fq.fused_qmm(
        a_planes.contiguous(),
        b_planes.contiguous(),
        coeff(x.scale, (m, 1)),
        coeff(x.offset, (m, 1)),
        coeff(w.scale, (1, n)),
        coeff(w.offset, (1, n)),
        k,
    )
    return out if out_dtype == f32 else out.to(out_dtype)


backend_registry.register(
    backend_registry.QMMBackend(
        name="pallas",
        run=qmm_pallas,
        description="staged hand-written CUDA kernel binary_qmm (K1) + PyTorch flow epilogue",
    )
)

backend_registry.register(
    backend_registry.QMMBackend(
        name="fused",
        run=qmm_fused,
        description="hand-written CUDA kernel fused_qmm (K2): AND-popcount core + epilogue",
    )
)
