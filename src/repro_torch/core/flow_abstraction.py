"""Computation-flow abstraction (port of ``repro.core.flow_abstraction``).

``(a1*X1 + g1)(a2*X2 + g2)`` is rewritten so that the cubic term is one
integer matrix product and every float operation is at most quadratic:

    a1*a2 * (X1 @ X2) + a1*g2 * rowsum(X1) + g1*a2 * colsum(X2) + g1*g2*K

The epilogue is evaluated in exactly the reference's term order.

A tensor-parallel step's row-parallel site holds one slice of K: within
``partial_sums_reduced`` its int32 product and row sums are summed over
the ranks first (exact in any order), and the epilogue then runs once with
the global K, so the float output is the one-card product's bit for bit
(summing the ranks' float outputs would not be).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.core import quantization
from repro_torch.core.constants import as_scalar, scalar
from repro_torch.core.quantization import QuantTensor

__all__ = [
    "default_int_matmul",
    "exact_int_matmul",
    "op_counts_abstracted",
    "op_counts_naive",
    "partial_sums_reduced",
    "partial_sums_pending",
    "qmm_dequant_reference",
    "qmm_flow",
    "weight_corrections",
]

# int8 x int8 products over K accumulate in int32; K is chunked when the
# worst-case accumulator |K * max_prod| would pass this bound.
_INT32_SAFE = 2**30
# float64 holds every integer below 2**53 exactly, whatever the summation order.
_F64_EXACT = 2**53


def exact_int_matmul(x: torch.Tensor, y: torch.Tensor, bound: int) -> torch.Tensor:
    """Integer product ``x @ y`` (broadcasting like ``torch.matmul``) through
    float64, exact because every partial sum stays below ``bound`` <= 2**53.

    CUDA has no integer ``matmul`` (``torch._int_mm`` needs M > 16 and
    multiples of 8), and on the CPU ``int8 @ int8`` returns int8 and wraps,
    so the plain integer products of the port run in float64 and come back
    as int64.
    """
    if bound > _F64_EXACT:
        raise ValueError(f"integer product bound {bound} exceeds 2**53")
    return torch.matmul(x.to(torch.float64), y.to(torch.float64)).to(torch.int64)


def default_int_matmul(
    x: torch.Tensor, y: torch.Tensor, x_bits: int, y_bits: int
) -> torch.Tensor:
    """Integer MM of re-centered mantissas with int32 accumulation
    (``(..., M, K) @ (K, N)`` or batched).  K is chunked where int32 could
    overflow; chunk partials combine in float32, as in the reference."""
    k = x.shape[-1]
    max_prod = 2 ** (x_bits - 1 + y_bits - 1) if (x_bits > 1 or y_bits > 1) else 1
    max_prod = max(max_prod, 1)
    if max_prod * k <= _INT32_SAFE:
        return exact_int_matmul(x, y, max_prod * k).to(torch.int32)
    n_chunks = -(-max_prod * k // _INT32_SAFE)
    chunk = -(-k // n_chunks)
    total = None
    for s in range(0, k, chunk):
        e = min(s + chunk, k)
        part = exact_int_matmul(x[..., s:e], y[..., s:e, :], max_prod * (e - s))
        part = part.to(torch.int32).to(torch.float32)
        total = part if total is None else total + part
    return total


def _int_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sum(x.to(torch.int32), dim=dim, dtype=torch.int32)


def weight_corrections(w: QuantTensor) -> torch.Tensor:
    """``colsum`` of the re-centered weight mantissa (precomputed offline)."""
    x2 = quantization.recenter(w).unpack().mantissa
    return _int_sum(x2, dim=-2)


#: ``(xy, row, k) -> (xy, row, k)`` applied before the epilogue while set
_partial_sums = None


@contextlib.contextmanager
def partial_sums_reduced(fn):
    """Within the block ``qmm_flow`` hands its int32 product ``xy``, its
    int32 row sums and its K to ``fn`` before the epilogue, which runs on
    what ``fn`` returns: a row-parallel site's sums over the ranks and the
    global K (``models/tensor_parallel.py``); the weight's colsum must be
    given whole (``w_colsum``).  A backend that applies its epilogue inside
    its kernel cannot take part and raises (``partial_sums_pending``)."""
    global _partial_sums
    prev, _partial_sums = _partial_sums, fn
    try:
        yield
    finally:
        _partial_sums = prev


def partial_sums_pending() -> bool:
    """Whether the product being computed is one rank's part of a sum
    (inside ``partial_sums_reduced``)."""
    return _partial_sums is not None


def qmm_flow(
    x: QuantTensor,
    w: QuantTensor,
    *,
    w_colsum: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
    int_matmul: Optional[Callable[[QuantTensor, QuantTensor], torch.Tensor]] = None,
    recenter: bool = True,
) -> torch.Tensor:
    """Affine x affine QMM via the flow abstraction.

    ``x`` is ``(..., M, K)`` with scalar or ``(..., M, 1)`` coefficients;
    ``w`` is ``(K, N)`` (or batched) with scalar or ``(1, N)`` coefficients.
    With ``recenter`` (the default) mantissas are shifted to the signed
    range first (exact, absorbed into the offsets); without it the raw
    unsigned mantissas go in, as the popcount and bit-serial cores consume
    them, and the epilogue is the same.  ``w_colsum`` is the colsum of the
    right mantissa as the integer product consumes it: re-centered
    (``weight_corrections``) or raw, which coincide at 1 bit.
    ``int_matmul(x, w)`` returns the integer product of the two operands as
    given to it (default, with ``recenter`` only: ``default_int_matmul`` on
    their unpacked mantissas); the kernel backends pass their kernels here,
    so every backend shares this one epilogue.
    """
    if recenter:
        x = quantization.recenter(x)
        w = quantization.recenter(w)
    elif int_matmul is None:
        raise ValueError("qmm_flow(recenter=False) needs an int_matmul for unsigned mantissas")
    x1 = x.unpack().mantissa
    k = x1.shape[-1]
    if w.logical_shape[-2] != k:
        raise ValueError(f"reduction mismatch: {tuple(x1.shape)} @ {w.logical_shape}")
    x2 = w.unpack().mantissa if int_matmul is None or w_colsum is None else None
    dev = x1.device
    a1 = as_scalar(x.scale, out_dtype, dev)
    g1 = as_scalar(x.offset, out_dtype, dev)
    a2 = as_scalar(w.scale, out_dtype, dev)
    g2 = as_scalar(w.offset, out_dtype, dev)

    if int_matmul is None:
        xy = default_int_matmul(x1, x2, x.bits, w.bits)
    else:
        xy = int_matmul(x, w)
    row = _int_sum(x1, dim=-1)
    if _partial_sums is not None:
        if w_colsum is None:  # the colsum of this rank's slice of K is not the site's
            raise NotImplementedError("a row-parallel site's epilogue needs the weight's colsum over the "
                                      "whole K (w_colsum); this rank holds only its slice of the weight")
        xy, row, k = _partial_sums(xy, row, k)
    out = xy.to(out_dtype) * (a1 * a2)
    out = out + (a1 * g2) * row[..., None].to(out_dtype)
    col = w_colsum if w_colsum is not None else _int_sum(x2, dim=-2)
    col = col[..., None, :].to(out_dtype)
    out = out + (g1 * a2) * col
    return out + g1 * g2 * scalar(k, out_dtype, dev)


def qmm_dequant_reference(x: QuantTensor, w: QuantTensor, out_dtype: torch.dtype = torch.float32):
    """The naive flow the paper replaces: dequantize both operands to full
    precision and multiply (N^3 float operations).  The correctness oracle
    and the float baseline of Table II."""
    return torch.matmul(x.dequantize(out_dtype), w.dequantize(out_dtype))


# ---------------------------------------------------------------------------
# Op counting (Fig. 2's complexity accounting, used by the energy model).
# ---------------------------------------------------------------------------

def op_counts_naive(m: int, k: int, n: int) -> dict:
    """Full-precision MM of dequantized operands: M*N dots of length K."""
    return {"fp_ops": 2 * m * k * n, "int_ops": 0}


def op_counts_abstracted(m: int, k: int, n: int, *, weight_static: bool = True) -> dict:
    """Abstracted flow: integer MM + quadratic float epilogue.

    Matches Fig. 2's ``2N^3 Iop + (3N^2 + 2) Op`` for m=k=n, weight_static
    (colsum offline, coefficient products offline).
    """
    int_ops = 2 * m * k * n  # the integer MM (MACs counted as 2 ops)
    int_ops += m * k  # rowsum(X1)
    if not weight_static:
        int_ops += k * n  # colsum(X2) when the right operand is an activation
    fp_ops = m * n  # scale by a1*a2
    fp_ops += m * n  # add rank-1 row correction (broadcast add)
    fp_ops += m * n  # add rank-1 col correction + constant (fused broadcast)
    fp_ops += 2  # offline coefficient products a1*a2, g1*a2 (paper's "+2")
    return {"fp_ops": fp_ops, "int_ops": int_ops}
