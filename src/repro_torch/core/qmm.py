"""The QMM engine entry point (port of ``repro.core.qmm``).

``qmm(x, w, backend=...)`` resolves the backend through the port's
registry and runs it.  This module registers the two plain PyTorch
backends:

* ``mxu``      -- integer product of the re-centered mantissas (float64,
  exact) under the flow abstraction;
* ``popcount`` -- AND-popcount over bit-packed planes of the raw unsigned
  mantissas, bit-serial for multi-bit operands (``sum_ij 2**(i+j)
  popcount-MM(X_i, Y_j)``), under the flow abstraction without
  re-centering.  Plain tensor code in the reference too (jnp, not a
  Pallas kernel).

``mxu`` also serves the attention-scores family (``run_scores``: the
{0, 1} planes unpacked and a grouped float64 product, exact).  The
hand-written kernels register as ``pallas`` and ``fused`` in
``repro_torch.kernels.ops``, beside the scores-only ``binary`` and
``float``, which ``qmm`` refuses.  ``backend="auto"`` resolves through the
measured dispatcher (``repro_torch.core.dispatch``); an explicit name
through its demotion table.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend_registry, flow_abstraction, packing
from repro_torch.core.precision import PrecisionMode
from repro_torch.core.quantization import QuantTensor

__all__ = ["qmm", "and_popcount_matmul", "popcount_int_matmul", "unpacked_scores"]

# Columns of the right operand per popcount sweep: bounds the broadcast
# intermediate to ``M * 256 * Kw`` words, as in the reference.
_POPCOUNT_N_CHUNK = 256


def and_popcount_matmul(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """``out[..., m, n] = sum_w popcount(a[..., m, w] & b[..., w, n])`` -> int32.

    ``a_packed`` is ``(..., M, Kw)`` and ``b_packed`` ``(..., Kw, N)``, int32
    words packed along K.
    """
    n = b_packed.shape[-1]
    chunks = []
    for s in range(0, n, _POPCOUNT_N_CHUNK):
        b_blk = b_packed[..., s : s + _POPCOUNT_N_CHUNK].transpose(-1, -2)
        joint = a_packed[..., :, None, :] & b_blk[..., None, :, :]
        chunks.append(packing.popcount32(joint).sum(dim=-1, dtype=torch.int32))
    return torch.cat(chunks, dim=-1)


def popcount_int_matmul(x: torch.Tensor, y: torch.Tensor, x_bits: int, y_bits: int) -> torch.Tensor:
    """Integer MM of UNSIGNED unpacked mantissas ``x (..., M, K) @ y (..., K, N)``
    from AND-popcount over bit-planes: ``sum_ij 2**(i+j) popcount-MM(X_i, Y_j)``,
    accumulated in int32 as in the reference."""
    a_planes = packing.pack_bitplanes(x, x_bits, axis=-1)
    b_planes = packing.pack_bitplanes(y, y_bits, axis=-2)
    total = None
    for i in range(x_bits):
        for j in range(y_bits):
            part = and_popcount_matmul(a_planes[i], b_planes[j]) << (i + j)
            total = part if total is None else total + part
    return total


def qmm(
    x: QuantTensor,
    w: QuantTensor,
    *,
    backend: str = "mxu",
    mode: Optional[PrecisionMode] = None,
    w_colsum: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Quantized matmul through the flow abstraction on a named backend,
    or on the one ``backend="auto"`` measures fastest for this (M, K, N,
    precisions, tuning phase) on the operands' device."""
    if mode is not None and (x.bits, w.bits) not in {
        (mode.act_bits, mode.weight_bits),
        (mode.act_bits, mode.act_bits),
    }:
        raise ValueError(
            f"operands W{w.bits}A{x.bits} do not match engine mode {mode.name}"
        )
    from repro_torch.core import dispatch

    if backend == "auto":
        x_l, w_l = x.logical_shape, w.logical_shape
        m = 1
        for d in x_l[:-1]:
            m *= int(d)
        backend = dispatch.choose_backend(
            m, int(x_l[-1]), int(w_l[-1]), x.bits, w.bits,
            rank2=len(x_l) == 2 and len(w_l) == 2, device=x.mantissa.device,
        )
    else:
        backend = dispatch.resolve_backend(backend)
    spec = backend_registry.get_backend(backend)
    if "qmm" not in spec.families:
        raise ValueError(
            f"backend {backend!r} serves families {sorted(spec.families)}, not the qmm "
            "family; scores-only backends go through kernels.ops.binary_attn_scores"
        )
    return spec.run(x, w, w_colsum=w_colsum, out_dtype=out_dtype)


def unpacked_scores(q_planes: torch.Tensor, k_planes: torch.Tensor, dh: int, dtype: torch.dtype) -> torch.Tensor:
    """Attention scores as a grouped product of packed planes (int32 words,
    ``(B, H, S, dw)`` and ``(B, G, T, dw)``) unpacked to {0, 1} ``dtype``
    values -> ``(B, H, S, T)`` in ``dtype``; exact wherever ``dtype`` holds
    every integer up to ``dh``."""
    qb = packing.unpack_bits(q_planes, 1, dh, axis=-1, dtype=dtype)
    kb = packing.unpack_bits(k_planes, 1, dh, axis=-1, dtype=dtype)
    b, h, s, _ = qb.shape
    g, t = kb.shape[1], kb.shape[2]
    out = torch.einsum("bgxsd,bgtd->bgxst", qb.reshape(b, g, h // g, s, dh), kb)
    return out.reshape(b, h, s, t)


def _mxu_scores(q_planes: torch.Tensor, k_planes: torch.Tensor, *, dh: int) -> torch.Tensor:
    """Scores-family core of ``mxu``: the integer product of the unpacked
    planes, exact in float64 as the port's ``mxu`` integer products are."""
    return unpacked_scores(q_planes, k_planes, dh, torch.float64).to(torch.int32)


def _mxu_traffic(m, k, n, act_bits, weight_bits) -> int:
    # The reference's model of an integer product on unpacked int8
    # mantissas, the output written once.  The port's plain core moves more:
    # it multiplies in float64 (8 bytes an operand element) and its
    # epilogue is separate PyTorch passes over the output.
    return m * k + k * n + 4 * m * n + 8 * (m + n)


def _popcount_traffic(m, k, n, act_bits, weight_bits) -> int:
    # Bit-serial over packed planes: each (i, j) plane pair re-reads plane i
    # of the activations and plane j of the weights.  The port's plain core
    # moves more: each sweep materialises the AND of a row block with up to
    # 256 columns as int64 words before it counts them.
    kw_bytes = 4 * packing.packed_len(k, 1)
    plane_reads = act_bits * weight_bits
    return (
        plane_reads * m * kw_bytes
        + plane_reads * kw_bytes * n
        + 4 * m * n
        + 8 * (m + n)
    )


def _run_mxu(x: QuantTensor, w: QuantTensor, *, w_colsum=None, out_dtype=torch.float32):
    return flow_abstraction.qmm_flow(x, w, w_colsum=w_colsum, out_dtype=out_dtype)


backend_registry.register(
    backend_registry.QMMBackend(
        name="mxu",
        run=_run_mxu,
        description="plain PyTorch integer product (float64, exact) + flow epilogue",
        traffic_model=_mxu_traffic,
        families=frozenset({"qmm", "scores"}),
        run_scores=_mxu_scores,
    )
)


def _popcount_int(x: QuantTensor, w: QuantTensor) -> torch.Tensor:
    return popcount_int_matmul(x.unpack().mantissa, w.unpack().mantissa, x.bits, w.bits)


def _run_popcount(x: QuantTensor, w: QuantTensor, *, w_colsum=None, out_dtype=torch.float32):
    # raw unsigned planes: a given colsum is valid only where re-centering
    # is a no-op (1-bit weights)
    return flow_abstraction.qmm_flow(
        x,
        w,
        w_colsum=w_colsum if w.bits == 1 else None,
        out_dtype=out_dtype,
        int_matmul=_popcount_int,
        recenter=False,
    )


backend_registry.register(
    backend_registry.QMMBackend(
        name="popcount",
        run=_run_popcount,
        description="plain PyTorch bit-serial AND-popcount over packed planes + flow epilogue",
        traffic_model=_popcount_traffic,
    )
)
