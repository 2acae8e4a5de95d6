"""Affine quantization (port of ``repro.core.quantization``).

Every QMM operand is ``alpha * x + gamma`` with an unsigned n-bit mantissa
``x``.  Sign-binarized weights ``+-alpha`` are mantissa ``{0, 1}`` with
``scale = 2*alpha, offset = -alpha``.

The straight-through estimators (``ste_round``, ``fake_quant``,
``fake_binarize_weight``) are QAT's float-domain forward: quantize and
dequantize in the input's dtype, op by op as the reference evaluates them,
with the reference's gradients (autograd through the same expressions).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.constants import as_scalar, scalar

__all__ = [
    "QuantTensor",
    "dequantize",
    "quantize_activation",
    "binarize_weight",
    "quantize_weight",
    "recenter",
    "ste_round",
    "fake_quant",
    "fake_binarize_weight",
]


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """An affine-quantized tensor ``scale * mantissa + offset``.

    ``packed`` mantissas are int32 words (the reference's uint32 bits) with
    ``ceil(length / (32 // bits))`` words along ``packed_axis``.
    """

    mantissa: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    bits: int
    packed: bool = False
    packed_axis: int = -1
    length: Optional[int] = None

    @property
    def logical_shape(self) -> tuple:
        if not self.packed:
            return tuple(self.mantissa.shape)
        shape = list(self.mantissa.shape)
        shape[self.packed_axis] = self.length
        return tuple(shape)

    def unpack(self, dtype: torch.dtype = torch.int32) -> "QuantTensor":
        if not self.packed:
            return self
        m = packing.unpack_bits(
            self.mantissa, self.bits, self.length, axis=self.packed_axis, dtype=dtype
        )
        return dataclasses.replace(
            self, mantissa=m, packed=False, packed_axis=-1, length=None
        )

    def pack(self, axis: int) -> "QuantTensor":
        if self.packed:
            return self
        m = packing.pack_bits(self.mantissa, self.bits, axis=axis)
        return dataclasses.replace(
            self, mantissa=m, packed=True, packed_axis=axis,
            length=self.mantissa.shape[axis],
        )

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = self.unpack().mantissa.to(dtype)
        return x * self.scale.to(dtype) + self.offset.to(dtype)


def dequantize(q: QuantTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.dequantize(dtype)


def recenter(q: QuantTensor) -> QuantTensor:
    """Shift an unsigned mantissa to the signed range (exact, affine-absorbed):
    ``a*x + g == a*(x - c) + (g + a*c)`` with ``c = 2**(bits-1)``; every
    mantissa then fits int8.  1-bit operands pass through unchanged."""
    if q.bits <= 1:
        return q
    c = 2 ** (q.bits - 1)
    m = q.unpack(dtype=torch.int32).mantissa - c
    return dataclasses.replace(
        q,
        mantissa=m.to(torch.int8),
        offset=q.offset + q.scale * c,
        packed=False,
        packed_axis=-1,
        length=None,
    )


def quantize_activation(
    x: torch.Tensor,
    bits: int,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    per_channel_axis: Optional[int] = None,
) -> QuantTensor:
    """Elastic affine quantization (BiT section 3.2):
    ``q = round(clip((x - offset) / scale, 0, 2**bits - 1))``, rounding half
    to even as ``jnp.round`` does.  Calibrated from the tensor's own min/max
    when ``scale``/``offset`` are omitted, per ``per_channel_axis`` (kept)
    or per tensor."""
    qmax = float(2**bits - 1)
    if scale is None or offset is None:
        if per_channel_axis is None:
            lo, hi = x.amin(), x.amax()
        else:
            axis = per_channel_axis % x.ndim
            dims = tuple(i for i in range(x.ndim) if i != axis)
            lo = x.amin(dim=dims, keepdim=True)
            hi = x.amax(dim=dims, keepdim=True)
        derived = torch.clamp((hi - lo) / qmax, min=1e-8)
        scale = derived if scale is None else scale
        offset = lo if offset is None else offset
    scale = as_scalar(scale, x.dtype, x.device)
    offset = as_scalar(offset, x.dtype, x.device)
    q = torch.round(torch.clamp((x - offset) / scale, 0.0, qmax))
    mantissa = q.to(torch.uint8 if bits <= 8 else torch.int32)
    return QuantTensor(mantissa=mantissa, scale=scale, offset=offset, bits=bits)


_SUM_WINDOW = 32


def _tree_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis -2 in a fixed order: windows of 32 rows, each added in
    sequence, then the window sums likewise until at most 32 remain, and
    those in sequence.  Where a level's rows are not a multiple of 32, its
    zero padding is split between both ends, ``pad // 2`` rows before the
    data and ``pad - pad // 2`` after, as XLA pads the reduce-window levels
    it rewrites a long reduce into.  This is the order of the reference's
    compiled float32 reduce, so the weight scales come out bit-identical to
    it at every K."""
    while x.shape[-2] > _SUM_WINDOW:
        pad = (-x.shape[-2]) % _SUM_WINDOW
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-2], -1, _SUM_WINDOW, x.shape[-1])
        s = x[..., 0, :]
        for i in range(1, _SUM_WINDOW):
            s = s + x[..., i, :]
        x = s
    s = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        s = s + x[..., i, :]
    return s[..., None, :]


def binarize_weight(w: torch.Tensor) -> QuantTensor:
    """Sign binarization with the analytic scale ``alpha = mean(|w|)`` over
    the reduction axis (-2): mantissa ``w >= 0``, scale ``2*alpha``, offset
    ``-alpha`` -- per output column of a ``(K, N)`` weight, per expert and
    column of stacked ``(E, K, N)`` experts.  The mean is the ordered sum
    times ``1/K`` in float32, as the reference's compiled mean evaluates it
    (at rank 3 too: XLA pads each 32-row level the same way)."""
    inv_k = torch.tensor(1.0 / w.shape[-2], dtype=w.dtype, device=w.device)
    alpha = torch.clamp(_tree_sum_rows(w.abs()) * inv_k, min=1e-8)
    bit = (torch.sign(w) >= 0).to(torch.uint8)
    return QuantTensor(mantissa=bit, scale=2.0 * alpha, offset=-alpha, bits=1)


def quantize_weight(w: torch.Tensor, bits: int) -> QuantTensor:
    """n-bit affine weight quantization (sign binarization when bits=1)."""
    if bits == 1:
        return binarize_weight(w)
    return quantize_activation(w, bits, per_channel_axis=-1)


# ---------------------------------------------------------------------------
# straight-through estimators (QAT)
# ---------------------------------------------------------------------------


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with an identity gradient.  The value is
    ``x + (round(x) - x)`` in ``x.dtype``, as the reference writes it,
    which is not always ``round(x)`` in floating point."""
    return x + (torch.round(x) - x).detach()


def _ste_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``.  Its gradient is 1
    inside ``[lo, hi]``, 0 outside and 0.5 at a tie with either bound
    (``torch.clamp`` would pass 1 there)."""
    lo_t, hi_t = scalar(lo, x.dtype, x.device), scalar(hi, x.dtype, x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradients, calibrated per
    tensor: ``round(clip((x - lo) / s, 0, 2**bits - 1)) * s + lo`` with
    ``lo = min(x)``, ``s = max((max(x) - lo) / (2**bits - 1), 1e-8)``,
    the statistics detached and every step in ``x.dtype`` (bf16
    activations stay bf16).  The tensor's own minimum always sits on the
    lower bound, so its gradient there is halved (``_ste_clip``)."""
    qmax = float(2**bits - 1)
    xd = x.detach()
    lo, hi = xd.amin(), xd.amax()
    scale = torch.maximum((hi - lo) / scalar(qmax, x.dtype, x.device),
                          scalar(1e-8, x.dtype, x.device))
    q = ste_round(_ste_clip((x - lo) / scale, 0.0, qmax))
    return q * scale + lo


def fake_binarize_weight(w: torch.Tensor) -> torch.Tensor:
    """Sign binarization with a straight-through gradient: ``alpha *
    (w + (s - w))`` with ``s = +1`` where ``w >= 0`` else ``-1`` and
    ``alpha = mean(|w|)`` over the reduction axis (-2), detached and not
    clamped.  The gradient is ``g * alpha``.  The mean is
    ``_tree_sum_rows`` (the reference's reduction order) divided by K, as
    the reference evaluates ``jnp.mean`` op by op."""
    wd = w.detach()
    k = scalar(float(w.shape[-2]), w.dtype, w.device)
    alpha = _tree_sum_rows(wd.abs()) / k
    sign = torch.where(wd >= 0, 1.0, -1.0).to(w.dtype)
    return alpha * (w + (sign - wd))
