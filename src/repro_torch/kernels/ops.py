"""QuantTensor entry points over the kernels (port of ``repro.kernels.ops``):
operand preparation for the kernels, the registration of the ``pallas``
and ``fused`` backends in the port's registry, and the attention-scores
family: :func:`binary_attn_scores` and its scores-only backends ``binary``
(the hand-written kernel ``binary_attn``) and ``float`` (unpacked float32
planes and a grouped einsum, the reference's differential oracle core).

The CUDA kernels mask their ragged edges, so nothing here pads to a block
multiple (the reference pads for its TPU blocks; the results are equal).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend_registry, flow_abstraction, packing
from repro_torch.core.constants import as_scalar
from repro_torch.core.qmm import unpacked_scores
from repro_torch.core.quantization import QuantTensor
from repro_torch.kernels import binary_attn as _ba
from repro_torch.kernels import binary_qmm as _bq
from repro_torch.kernels import bitserial_qmm as _bs
from repro_torch.kernels import fused_qmm as _fq
from repro_torch.kernels import popcount_qmm as _pq

__all__ = [
    "binary_qmm_int",
    "popcount_qmm_int",
    "bitserial_qmm_int",
    "qmm_pallas",
    "qmm_fused",
    "binary_attn_scores",
]


def binary_qmm_int(
    a: torch.Tensor, w_packed: torch.Tensor, k: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``a (M, K) int8 @ unpack(w_packed) (K, N)`` -> int32, any M/K/N;
    written into ``out`` when given."""
    return _bq.binary_qmm(a.contiguous(), w_packed.contiguous(), k, out)


def popcount_qmm_int(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Binary x binary over packed operands ``(M, Kw) x (Kw, N)`` -> int32."""
    return _pq.popcount_qmm(a_packed.contiguous(), b_packed.contiguous())


def bitserial_qmm_int(a_planes: torch.Tensor, b_planes: torch.Tensor) -> torch.Tensor:
    """Multi-bit act x act from packed planes ``(a_bits, M, Kw) x (b_bits, Kw, N)``
    -> int32."""
    return _bs.bitserial_qmm(a_planes.contiguous(), b_planes.contiguous())


def _rank2(name: str, x: QuantTensor, w: QuantTensor) -> None:
    if len(x.logical_shape) != 2 or len(w.logical_shape) != 2:
        raise ValueError(f"{name} expects rank-2 operands; flatten batch dims")


def _popcount_int_matmul(x: QuantTensor, w: QuantTensor) -> torch.Tensor:
    """K3 on 1-bit operands, fully packed along K."""
    a_packed = x.mantissa if x.packed else packing.pack_bits(x.mantissa, 1, axis=-1)
    b_packed = w.mantissa if w.packed else packing.pack_bits(w.mantissa, 1, axis=0)
    return popcount_qmm_int(a_packed, b_packed)


def _binary_int_matmul(x: QuantTensor, w: QuantTensor) -> torch.Tensor:
    """K1 on re-centered operands: int8 activations x packed 1-bit weights."""
    a8 = x.unpack(dtype=torch.int8).mantissa
    b_packed = w.mantissa if w.packed else packing.pack_bits(w.mantissa, 1, axis=0)
    return binary_qmm_int(a8, b_packed, x.logical_shape[-1])


def _bitserial_int_matmul(x: QuantTensor, w: QuantTensor) -> torch.Tensor:
    """K4 over the bit-planes of the raw unsigned mantissas."""
    a_planes = packing.pack_bitplanes(x.unpack(dtype=torch.int32).mantissa, x.bits, axis=-1)
    b_planes = packing.pack_bitplanes(w.unpack(dtype=torch.int32).mantissa, w.bits, axis=-2)
    return bitserial_qmm_int(a_planes, b_planes)


def qmm_pallas(
    x: QuantTensor,
    w: QuantTensor,
    *,
    w_colsum: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The staged kernel path: a kernel returns the integer product, then the
    flow-abstraction epilogue (``qmm_flow``) runs in PyTorch.

    Dispatch, in the reference's order (BETA's mode table, Fig. 4):

    * 1-bit x 1-bit -> ``popcount_qmm`` (K3) on fully packed operands, the
      epilogue on the un-re-centered operands;
    * 1-bit weights, multi-bit activations -> ``binary_qmm`` (K1) on
      re-centered int8 activations;
    * anything else (multi-bit act x act) -> ``bitserial_qmm`` (K4) over the
      bit-planes of the raw unsigned mantissas, un-re-centered.

    A given ``w_colsum`` is used only for 1-bit ``w``, where re-centering is
    a no-op; for K4 the raw colsum is counted here.
    """
    _rank2("qmm_pallas", x, w)
    if x.bits == 1 and w.bits == 1:
        int_matmul, recenter = _popcount_int_matmul, False
    elif w.bits == 1:
        int_matmul, recenter = _binary_int_matmul, True
    else:
        int_matmul, recenter, w_colsum = _bitserial_int_matmul, False, None
    return flow_abstraction.qmm_flow(
        x, w, w_colsum=w_colsum, out_dtype=out_dtype, int_matmul=int_matmul, recenter=recenter
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
        return as_scalar(v, f32, dev).broadcast_to(shape).contiguous()

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


def _packed_operand_bytes(m, k, n, act_bits, weight_bits):
    """Bytes of both operands as 1-bit planes packed along K."""
    kw_bytes = 4 * packing.packed_len(k, 1)
    return act_bits * m * kw_bytes, weight_bits * kw_bytes * n


def _traffic_pallas(m, k, n, act_bits, weight_bits) -> int:
    # The staged kernels: the int32 product goes out to device memory and
    # comes back for the PyTorch epilogue, which writes the float32 output
    # (12 bytes an output element against the fused kernel's 4).  K3 (W1A1)
    # and K4 (act x act) read packed planes; K1 (W1A2..A8) re-centered int8
    # activations and packed weights.  Not charged, as in the reference:
    # the activation packing or re-centering before the launch, and K1's
    # and K3's split-K, where the partial sums of the K splits meet in the
    # int32 output through atomicAdd on a zeroed output (one more write of
    # it, and an atomic per split).
    if weight_bits == 1 and act_bits > 1:
        a_bytes = m * k
        b_bytes = 4 * packing.packed_len(k, 1) * n
    else:
        a_bytes, b_bytes = _packed_operand_bytes(m, k, n, act_bits, weight_bits)
    return a_bytes + b_bytes + 12 * m * n + 8 * (m + n)


def _traffic_fused(m, k, n, act_bits, weight_bits) -> int:
    # K2: packed planes read once, the float32 output written once, the
    # per-row and per-column coefficients.  Not charged, as in the
    # reference: the activation planes packed in PyTorch before the launch.
    a_bytes, b_bytes = _packed_operand_bytes(m, k, n, act_bits, weight_bits)
    return a_bytes + b_bytes + 4 * m * n + 8 * (m + n)


backend_registry.register(
    backend_registry.QMMBackend(
        name="pallas",
        run=qmm_pallas,
        description="staged hand-written CUDA kernels popcount_qmm (K3), binary_qmm (K1), "
        "bitserial_qmm (K4) + PyTorch flow epilogue",
        rank2_only=True,
        cuda_kernel=True,
        traffic_model=_traffic_pallas,
    )
)

backend_registry.register(
    backend_registry.QMMBackend(
        name="fused",
        run=qmm_fused,
        description="hand-written CUDA kernel fused_qmm (K2): AND-popcount core + epilogue",
        rank2_only=True,
        cuda_kernel=True,
        traffic_model=_traffic_fused,
    )
)


# ---------------------------------------------------------------------------
# the scores family: rank-4 attention-scores cores over packed W1A1 planes.
# ``mxu`` serves it too (core/qmm.py); these two are scores-only, so ``qmm``
# rejects them by family.
# ---------------------------------------------------------------------------


def binary_attn_scores(
    q_planes: torch.Tensor,
    k_planes: torch.Tensor,
    *,
    dh: int,
    backend: str = "auto",
    tag: Optional[str] = None,
) -> torch.Tensor:
    """Attention-scores integer core, backend-dispatched (scores family):
    ``q_planes`` int32 ``(B, H, S, dw)`` x ``k_planes`` ``(B, G, T, dw)`` ->
    int32 AND-popcount counts ``(B, H, S, T)``.

    ``backend="auto"`` consults the autotune cache under the ``"scores"``
    family key (m = B*H*S, k = dh, n = T), timing on the operands' device;
    an explicit name resolves through the demotion table, as ``qmm`` does.
    Every scores core equals ``ref.binary_attn_scores_ref`` bit for bit, so
    neither choice changes a number.
    """
    from repro_torch.core import dispatch

    b, h, s, _ = q_planes.shape
    t = k_planes.shape[2]
    if backend == "auto":
        backend = dispatch.choose_scores_backend(b, h, s, t, dh, tag=tag, device=q_planes.device)
    else:
        backend = dispatch.resolve_backend(backend)
    spec = backend_registry.get_backend(backend)
    if "scores" not in spec.families or spec.run_scores is None:
        raise ValueError(
            f"backend {backend!r} does not serve the scores family; scores backends: "
            f"{', '.join(backend_registry.backend_names(family='scores'))}"
        )
    return spec.run_scores(q_planes, k_planes, dh=dh)


def _float_scores(q_planes: torch.Tensor, k_planes: torch.Tensor, *, dh: int) -> torch.Tensor:
    """Float-dot scores core: the {0, 1} planes unpacked to float32 and a
    grouped einsum; exact, since a count never passes dh << 2**24."""
    return unpacked_scores(q_planes, k_planes, dh, torch.float32).to(torch.int32)


def _traffic_scores_binary(m, k, n, act_bits, weight_bits) -> int:
    # Packed planes in, int32 counts out: m and n rows of ceil(k/32) words.
    # ``binary_attn.cu`` reads each K row once per block of folded query
    # rows, so at many blocks it reads K more than once.
    kw_bytes = 4 * packing.packed_len(k, 1)
    return m * kw_bytes + n * kw_bytes + 4 * m * n


def _traffic_scores_float(m, k, n, act_bits, weight_bits) -> int:
    # Planes unpacked to float32 (the reference's model); the port's core
    # also writes that unpacked copy before it reads it.
    return 4 * (m * k + n * k) + 4 * m * n


backend_registry.register(
    backend_registry.QMMBackend(
        name="binary",
        run=_ba.binary_attn_scores_planes,  # scores-only: qmm rejects by family
        run_scores=_ba.binary_attn_scores_planes,
        description="hand-written CUDA kernel binary_attn: rank-4 AND-popcount attention "
        "scores over packed Q / K planes (Bitformer path)",
        precisions=frozenset({(1, 1)}),
        families=frozenset({"scores"}),
        cuda_kernel=True,
        traffic_model=_traffic_scores_binary,
    )
)

backend_registry.register(
    backend_registry.QMMBackend(
        name="float",
        run=_float_scores,  # scores-only: qmm rejects by family
        run_scores=_float_scores,
        description="float-dot attention scores over unpacked {0,1} planes "
        "(the differential oracle's core)",
        precisions=frozenset({(1, 1)}),
        families=frozenset({"scores"}),
        traffic_model=_traffic_scores_float,
    )
)
