"""K4 ``bitserial_qmm``: multi-bit act x act QMM over packed bit-planes -> int32.

Wrapper of the hand-written CUDA kernel ``csrc/bitserial_qmm.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/bitserial_qmm.py::bitserial_qmm``.
For CUDA tensors it launches the kernel (or raises); for CPU tensors it
runs the plain version ``ref.bitserial_qmm_ref``.  ``bitserial_qmm.launches``
counts kernel launches and nothing else.
On ``meta`` tensors (shape-only, the dry-run's) the plain version gives
the output's shape and dtype.  The wrapper is a trusted kernel boundary
of the invariant verifier (``core/marks.py``).

The kernel rebuilds the unsigned mantissas as bytes in shared memory from
``cp.async``-staged bit-planes (``sum_ij 2**(i+j) A_i @ B_j`` is ``X @ W``)
and multiplies them once on the int8 tensor cores (``mma.sync`` u8 x u8),
whatever the plane counts.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import marks
from repro_torch.kernels import build, ref

__all__ = ["bitserial_qmm"]

_MAX_BITS = 8  # csrc/bitserial_qmm.cu MAX_BITS


def _lib() -> ctypes.CDLL:
    lib = build.load("bitserial_qmm")
    if lib.bitserial_qmm_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.bitserial_qmm_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.bitserial_qmm_launch.restype = ctypes.c_int
    return lib


@marks.boundary(marks.KERNEL)
def bitserial_qmm(a_planes: torch.Tensor, b_planes: torch.Tensor) -> torch.Tensor:
    """``sum_ij 2**(i+j) popcount-MM(A_i, B_j)`` -> int32 ``(M, N)``.

    ``a_planes`` int32 ``(a_bits, M, Kw)`` and ``b_planes`` int32
    ``(b_bits, Kw, N)`` are unsigned mantissa bit-planes packed along K,
    with zero bits past the logical K.  Refuses operands whose largest
    possible sum, ``32 Kw (2**a_bits - 1)(2**b_bits - 1)``, reaches 2**31.
    Ragged shapes need no padding.
    """
    if a_planes.ndim != 3 or b_planes.ndim != 3:
        raise ValueError("bitserial_qmm: plane stacks must be rank 3 (bits, ., .)")
    if a_planes.dtype != torch.int32 or b_planes.dtype != torch.int32:
        raise ValueError("bitserial_qmm: planes must be int32 words")
    a_bits, m, kw = a_planes.shape
    b_bits, kw2, n = b_planes.shape
    if kw != kw2:
        raise ValueError(f"bitserial_qmm: packed K {kw} != {kw2}")
    if not (1 <= a_bits <= _MAX_BITS and 1 <= b_bits <= _MAX_BITS):
        raise ValueError(f"bitserial_qmm: plane counts must be 1..{_MAX_BITS}")
    dev = a_planes.device
    if b_planes.device != dev:
        raise ValueError(f"bitserial_qmm: operands on {dev} and {b_planes.device}")
    if dev.type in ("cpu", "meta"):
        return ref.bitserial_qmm_ref(a_planes, b_planes, 32 * kw)
    if dev.type != "cuda":
        raise ValueError(f"bitserial_qmm: unsupported device {dev}")
    ref.bitserial_bound(a_bits, b_bits, 32 * kw)
    if not (a_planes.is_contiguous() and b_planes.is_contiguous()):
        raise ValueError("bitserial_qmm: operands must be contiguous")
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    err = _lib().bitserial_qmm_launch(
        a_planes.data_ptr(), b_planes.data_ptr(), out.data_ptr(), a_bits, b_bits, m, kw, n,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bitserial_qmm launch failed: cudaError {err}")
    bitserial_qmm.launches += 1
    return out


bitserial_qmm.launches = 0
