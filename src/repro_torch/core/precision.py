"""Precision modes of the configurable QMM engine (paper Fig. 4).

A copy of ``repro.core.precision`` (the port imports nothing of ``repro``).

BETA's PE sequence serves every ``W1 x Aa`` combination plus multi-bit
activation x activation by combining data-packing (several low-bit multiplies
per PE word per cycle) and bit-serial traversal (one activation bit-plane per
cycle).  This registry is the software mirror: each mode fixes the operand
bit-widths, the packing factor the engine claims, and the bit-serial cycle
count — consumed by the QMM dispatcher and the energy/cycle model.

``Wb_w Ab_a`` notation follows BiT [11].
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["PrecisionMode", "MODES", "get_mode", "W1A1", "W1A2", "W1A4", "W1A8"]


@dataclasses.dataclass(frozen=True)
class PrecisionMode:
    """One operating point of the configurable QMM engine.

    Attributes:
      name: e.g. "W1A4".
      weight_bits: weight mantissa width (1 for every binary-Transformer mode).
      act_bits: activation mantissa width.
      pack_factor: multiplies per PE per cycle for act x weight (Fig. 4:
        W1A8 -> 1, W1A4 -> 2, W1A2 -> 4, W1A1 -> 8; the PE output register is
        8 bits wide and holds ``pack_factor`` packed partial products).
      bitserial_cycles: extra serial factor for act x act QMM — one operand is
        traversed bit-plane by bit-plane, so an ``Aa x Aa`` product takes
        ``a`` passes of the binary engine.
    """

    name: str
    weight_bits: int
    act_bits: int
    pack_factor: int
    bitserial_cycles: int

    @property
    def key(self) -> str:
        return self.name


def _mk(act_bits: int) -> PrecisionMode:
    return PrecisionMode(
        name=f"W1A{act_bits}",
        weight_bits=1,
        act_bits=act_bits,
        pack_factor=8 // act_bits,
        bitserial_cycles=act_bits,
    )


W1A1 = _mk(1)
W1A2 = _mk(2)
W1A4 = _mk(4)
W1A8 = _mk(8)

MODES: Dict[str, PrecisionMode] = {m.name: m for m in (W1A1, W1A2, W1A4, W1A8)}


def get_mode(name: str) -> PrecisionMode:
    try:
        return MODES[name]
    except KeyError:
        raise KeyError(f"unknown precision mode {name!r}; have {sorted(MODES)}") from None
