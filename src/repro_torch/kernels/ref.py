"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each states the kernel's semantics in straightforward tensor code.  The
kernel wrappers fall to these only for CPU tensors; the tests hold them
against the reference oracles, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They run on any device.

Packed operands are int32 words carrying the reference's uint32 bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.flow_abstraction import exact_int_matmul

__all__ = [
    "binary_qmm_ref",
    "popcount_qmm_ref",
    "bitserial_qmm_ref",
    "bitserial_bound",
    "fused_qmm_ref",
    "fused_qmm_epilogue",
    "binary_attn_scores_ref",
]

# Key positions per popcount sweep of the scores version: bounds the
# broadcast intermediate to ``G * M * 256 * dw`` words a batch row, as in
# the reference's ``binary_attn_scores_planes``.
_T_CHUNK = 256

# The bit-serial kernels accumulate ``sum_ij 2**(i+j) popcount-MM`` in int32.
_INT32_LIMIT = 2**31


def _check_packed(name: str, x: torch.Tensor, k: int, dim: int) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: packed operand must be int32 words, got {x.dtype}")
    if x.shape[dim] != packing.packed_len(k, 1):
        raise ValueError(
            f"{name}: packed dim {dim} has {x.shape[dim]} words, "
            f"expected ceil({k}/32) = {packing.packed_len(k, 1)}"
        )


def binary_qmm_ref(
    a: torch.Tensor, w_packed: torch.Tensor, k: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``a (M, K) int8 @ unpack(w_packed) (K, N)`` -> int32 ``(M, N)``,
    written into ``out`` when given (as the kernel's wrapper takes it).

    ``w_packed`` is ``(ceil(K/32), N)``: 1-bit mantissas {0, 1} packed along
    the reduction axis.
    """
    if a.dtype != torch.int8 or a.ndim != 2 or a.shape[-1] != k:
        raise ValueError(f"binary_qmm_ref: a must be int8 (M, {k}), got {a.dtype} {tuple(a.shape)}")
    if w_packed.ndim != 2:
        raise ValueError(f"binary_qmm_ref: w_packed must be rank 2, got {w_packed.ndim}")
    _check_packed("binary_qmm_ref", w_packed, k, 0)
    w = packing.unpack_bits(w_packed, 1, k, axis=0, dtype=torch.int8)
    got = exact_int_matmul(a, w, 128 * k).to(torch.int32)
    return got if out is None else out.copy_(got)


def popcount_qmm_ref(a_packed: torch.Tensor, b_packed: torch.Tensor, k: int) -> torch.Tensor:
    """Binary x binary: ``out[m, n] = sum_j a[m, j] * b[j, n]`` with a, b in
    {0, 1} -> int32 ``(M, N)``.

    ``a_packed`` is ``(M, ceil(K/32))`` packed along its last axis,
    ``b_packed`` ``(ceil(K/32), N)`` packed along its first.  Equal to
    ``sum_w popcount(a[m, w] & b[w, n])`` over whole words when the bits past
    K are zero, as packing leaves them.
    """
    if a_packed.ndim != 2 or b_packed.ndim != 2:
        raise ValueError(
            f"popcount_qmm_ref: operands must be rank 2, got {a_packed.ndim} and {b_packed.ndim}"
        )
    _check_packed("popcount_qmm_ref", a_packed, k, 1)
    _check_packed("popcount_qmm_ref", b_packed, k, 0)
    a = packing.unpack_bits(a_packed, 1, k, axis=-1, dtype=torch.int8)
    b = packing.unpack_bits(b_packed, 1, k, axis=0, dtype=torch.int8)
    return exact_int_matmul(a, b, k).to(torch.int32)


def bitserial_bound(a_bits: int, b_bits: int, k: int) -> int:
    """Largest possible ``sum_ij 2**(i+j) popcount-MM`` entry: ``K (2**a - 1)
    (2**b - 1)``.  The bit-serial kernels (and this plain version) refuse
    operands where it reaches 2**31, past which int32 accumulation wraps."""
    bound = k * (2**a_bits - 1) * (2**b_bits - 1)
    if bound >= _INT32_LIMIT:
        raise ValueError(
            f"bit-serial product of {a_bits} x {b_bits} planes over K={k} can reach "
            f"{bound} >= 2**31: the int32 accumulator would wrap"
        )
    return bound


def bitserial_qmm_ref(a_planes: torch.Tensor, b_planes: torch.Tensor, k: int) -> torch.Tensor:
    """Multi-bit act x act from packed bit-planes -> int32 ``(M, N)``:
    ``sum_ij 2**(i+j) A_i @ B_j``, which equals ``X @ W`` for the unsigned
    mantissas ``X = sum_i 2**i A_i``, ``W = sum_j 2**j B_j``; computed so.

    ``a_planes`` is ``(a_bits, M, ceil(K/32))`` packed along its last axis,
    ``b_planes`` ``(b_bits, ceil(K/32), N)`` packed along axis 1.
    """
    if a_planes.ndim != 3 or b_planes.ndim != 3:
        raise ValueError(
            "bitserial_qmm_ref: plane stacks must be rank 3 (bits, ., .), got "
            f"{a_planes.ndim} and {b_planes.ndim}"
        )
    _check_packed("bitserial_qmm_ref", a_planes, k, 2)
    _check_packed("bitserial_qmm_ref", b_planes, k, 1)
    bound = bitserial_bound(a_planes.shape[0], b_planes.shape[0], k)
    x = _plane_value(a_planes, k, -1)  # (M, K)
    w = _plane_value(b_planes, k, 0)  # (K, N)
    return exact_int_matmul(x, w, bound).to(torch.int32)


def _plane_value(planes: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """``sum_i 2**i * unpack(planes[i])`` as int64: the unsigned mantissa."""
    total = None
    for i in range(planes.shape[0]):
        part = packing.unpack_bits(planes[i], 1, k, axis=dim, dtype=torch.int64) << i
        total = part if total is None else total + part
    return total


def fused_qmm_epilogue(xy, row, col, a_scale, a_offset, w_scale, w_offset, k):
    """The fused kernel's float32 epilogue in its exact order:
    ``((t0 + t1) + t2) + t3`` with every product rounded on its own."""
    f32 = torch.float32
    a1, g1 = a_scale.to(f32), a_offset.to(f32)
    a2, g2 = w_scale.to(f32), w_offset.to(f32)
    t0 = xy.to(f32) * (a1 * a2)
    t1 = (a1 * g2) * row.to(f32)
    t2 = (g1 * a2) * col.to(f32)
    t3 = g1 * g2 * torch.tensor(float(k), dtype=f32, device=xy.device)
    return ((t0 + t1) + t2) + t3


def fused_qmm_ref(
    a_planes: torch.Tensor,
    b_planes: torch.Tensor,
    a_scale: torch.Tensor,
    a_offset: torch.Tensor,
    w_scale: torch.Tensor,
    w_offset: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Bit-serial integer core plus affine epilogue -> float32 ``(M, N)``.

    ``a_planes`` ``(a_bits, M, Kw)`` and ``b_planes`` ``(b_bits, Kw, N)`` are
    unsigned mantissa bit-planes.  The integer part
    ``sum_ij 2**(i+j) A_i @ B_j`` equals ``X @ W`` for the mantissas
    ``X = sum_i 2**i A_i``, ``W = sum_j 2**j B_j``, which is how it is computed
    here; ``rowsum(X)`` and ``colsum(W)`` come from the same mantissas.
    """
    if a_planes.ndim != 3 or b_planes.ndim != 3:
        raise ValueError("fused_qmm_ref: plane stacks must be rank 3 (bits, ., .)")
    _check_packed("fused_qmm_ref", a_planes, k, 2)
    _check_packed("fused_qmm_ref", b_planes, k, 1)
    x = _plane_value(a_planes, k, -1)  # (M, K)
    w = _plane_value(b_planes, k, 0)  # (K, N)
    bound = k * (2 ** a_planes.shape[0] - 1) * (2 ** b_planes.shape[0] - 1)
    xy = exact_int_matmul(x, w, bound).to(torch.int32)
    row = x.sum(dim=-1, keepdim=True).to(torch.int32)
    col = w.sum(dim=0, keepdim=True).to(torch.int32)
    return fused_qmm_epilogue(xy, row, col, a_scale, a_offset, w_scale, w_offset, k)


def binary_attn_scores_ref(q_planes: torch.Tensor, k_planes: torch.Tensor, dh: int) -> torch.Tensor:
    """Attention-scores family: ``out[b, h, s, t] = sum_w popcount(q[b, h, s,
    w] & k[b, h // (H/G), t, w])`` -> int32 ``(B, H, S, T)``, the
    bit-exactness contract every scores core meets.

    ``q_planes`` ``(B, H, S, dw)`` and ``k_planes`` ``(B, G, T, dw)`` are int32
    words carrying the {0, 1} bits of ``dh`` values packed little-endian
    along the last axis (``dw = ceil(dh/32)``, zero tail); H is a multiple of
    G (GQA: head ``h`` reads kv head ``h // (H/G)``).  Computed as the
    reference's ``binary_attn_scores_planes``: each kv head's query group
    folded onto the rows, then a SWAR popcount of ``q & k`` over chunks of
    ``_T_CHUNK`` keys.
    """
    for name, x in (("q_planes", q_planes), ("k_planes", k_planes)):
        if x.ndim != 4:
            raise ValueError(f"binary_attn_scores_ref: {name} must be rank 4, got {x.ndim}")
        _check_packed("binary_attn_scores_ref", x, dh, 3)
    b, h, s, dw = q_planes.shape
    g, t = k_planes.shape[1], k_planes.shape[2]
    if k_planes.shape[0] != b or h % g:
        raise ValueError(
            f"binary_attn_scores_ref: q {tuple(q_planes.shape)} and k {tuple(k_planes.shape)} "
            "need the same batch and H a multiple of G"
        )
    qg = q_planes.reshape(b, g, (h // g) * s, dw)
    chunks = [
        packing.popcount32(qg[:, :, :, None, :] & k_planes[:, :, None, t0:t0 + _T_CHUNK, :])
        .sum(dim=-1, dtype=torch.int32)
        for t0 in range(0, t, _T_CHUNK)
    ]
    out = torch.cat(chunks, dim=-1) if chunks else qg.new_zeros((b, g, qg.shape[2], 0))
    return out.reshape(b, h, s, t)
