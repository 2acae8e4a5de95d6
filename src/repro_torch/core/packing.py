"""Bit-packing utilities (port of ``repro.core.packing``).

Same conventions as the reference: unsigned ``bits``-wide mantissas,
``32 // bits`` to a 32-bit word along one axis, little-endian within the
word (value ``i`` occupies bits ``[i*bits, (i+1)*bits)``), zero tail.

Torch has no usable ``uint32`` (shifts on it raise on the CPU), so a packed
word is held as a ``torch.int32`` carrying the same 32 bits: the words are
bit-identical to the reference's ``uint32`` arrays, and
``numpy_array.view(np.int32)`` / ``.view(np.uint32)`` converts between the
two.  Shifts run on int64 copies, where every 32-bit pattern is positive.
"""

from __future__ import annotations

import torch

__all__ = [
    "WORD_BITS",
    "values_per_word",
    "packed_len",
    "pack_bits",
    "unpack_bits",
    "to_bitplanes",
    "pack_bitplanes",
    "words_to_int32",
    "popcount32",
]

WORD_BITS = 32
_SUPPORTED_BITS = (1, 2, 4, 8, 16)


def values_per_word(bits: int) -> int:
    if bits not in _SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {_SUPPORTED_BITS}, got {bits}")
    return WORD_BITS // bits


def packed_len(length: int, bits: int) -> int:
    return -(-length // values_per_word(bits))


def words_to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` -> int32 tensor with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(x: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Pack unsigned ``bits``-wide mantissas along ``axis`` into 32-bit words.

    Returns int32 words (the reference's uint32 bits); ``axis`` shrinks from
    ``L`` to ``ceil(L / (32 // bits))``.
    """
    vpw = values_per_word(bits)
    x = torch.movedim(x, axis, -1).to(torch.int64) & ((1 << bits) - 1)
    length = x.shape[-1]
    n_words = packed_len(length, bits)
    pad = n_words * vpw - length
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], n_words, vpw)
    shifts = torch.arange(vpw, dtype=torch.int64, device=x.device) * bits
    words = (x << shifts).sum(dim=-1)  # the fields do not overlap: sum == or
    return torch.movedim(words_to_int32(words), -1, axis).contiguous()


def unpack_bits(
    packed: torch.Tensor,
    bits: int,
    length: int,
    axis: int = -1,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; ``length`` is the logical length."""
    vpw = values_per_word(bits)
    p = torch.movedim(packed, axis, -1).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(vpw, dtype=torch.int64, device=p.device) * bits
    vals = (p[..., None] >> shifts) & ((1 << bits) - 1)
    vals = vals.reshape(*p.shape[:-1], p.shape[-1] * vpw)[..., :length]
    return torch.movedim(vals.to(dtype), -1, axis)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 words carrying uint32 bits) ->
    int32, by the SWAR reduction: torch has no popcount."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def to_bitplanes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x = sum_i 2**i * plane[i]``: uint8 planes of shape ``(bits,) + x.shape``."""
    x = x.to(torch.int64)
    shifts = torch.arange(bits, dtype=torch.int64, device=x.device)
    shifts = shifts.reshape((bits,) + (1,) * x.ndim)
    return ((x[None] >> shifts) & 1).to(torch.uint8)


def pack_bitplanes(x: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Bit-plane decompose, then 1-bit-pack each plane along ``axis``.

    Output shape ``(bits,) + packed_shape``: the bit-serial operand layout.
    """
    planes = to_bitplanes(x, bits)
    pack_axis = axis if axis < 0 else axis + 1
    return pack_bits(planes, 1, axis=pack_axis)
