"""K2 ``fused_qmm``: bit-serial AND-popcount QMM with the affine epilogue.

Wrapper of the hand-written CUDA kernel ``csrc/fused_qmm.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/fused_qmm.py::fused_qmm``.
For CUDA tensors it launches the kernel (or raises); for CPU tensors it
runs the plain version ``ref.fused_qmm_ref``.  ``fused_qmm.launches``
counts kernel launches and nothing else.
On ``meta`` tensors (shape-only, the dry-run's) the plain version gives
the output's shape and dtype.  The wrapper is a trusted kernel boundary
of the invariant verifier (``core/marks.py``).

The kernel runs the integer core on the int8 tensor cores: it stages the
plane words in shared memory with ``cp.async``, rebuilds the unsigned
mantissas as bytes there (``sum_ij 2**(i+j) A_i @ B_j`` is ``X @ W``), and
multiplies them with ``mma.sync`` u8 x u8 -> int32; tiles are chosen by M
and by the grid's size against the card's SMs.

Exactness: the integer core (MM, rowsum, colsum) equals the plain version
exactly; the float32 epilogue rounds every product and sum on its own in
the plain version's order (no fma), so on the card the two agree bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import marks, packing
from repro_torch.kernels import build, ref

__all__ = ["fused_qmm"]

_MAX_BITS = 8  # csrc/fused_qmm.cu MAX_BITS


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_qmm")
    if lib.fused_qmm_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.fused_qmm_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.fused_qmm_launch.restype = ctypes.c_int
    return lib


@marks.boundary(marks.KERNEL)
def fused_qmm(
    a_planes: torch.Tensor,
    b_planes: torch.Tensor,
    a_scale: torch.Tensor,
    a_offset: torch.Tensor,
    w_scale: torch.Tensor,
    w_offset: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Fused bit-serial QMM -> float32 ``(M, N)``.

    ``a_planes`` int32 ``(a_bits, M, Kw)`` and ``b_planes`` int32
    ``(b_bits, Kw, N)`` are unsigned mantissa bit-planes packed along K;
    ``a_scale``/``a_offset`` are float32 ``(M, 1)``, ``w_scale``/``w_offset``
    float32 ``(1, N)``; ``k`` is the logical K.  Ragged shapes need no
    padding.
    """
    if a_planes.ndim != 3 or b_planes.ndim != 3:
        raise ValueError("fused_qmm: plane stacks must be rank 3 (bits, ., .)")
    if a_planes.dtype != torch.int32 or b_planes.dtype != torch.int32:
        raise ValueError("fused_qmm: planes must be int32 words")
    a_bits, m, kw = a_planes.shape
    b_bits, kw2, n = b_planes.shape
    if kw != kw2 or kw != packing.packed_len(k, 1):
        raise ValueError(f"fused_qmm: packed K {kw} / {kw2} does not hold k={k}")
    for name, t, shape in (
        ("a_scale", a_scale, (m, 1)),
        ("a_offset", a_offset, (m, 1)),
        ("w_scale", w_scale, (1, n)),
        ("w_offset", w_offset, (1, n)),
    ):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"fused_qmm: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    tensors = (a_planes, b_planes, a_scale, a_offset, w_scale, w_offset)
    dev = a_planes.device
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_qmm: operands on different devices")
    if dev.type in ("cpu", "meta"):
        return ref.fused_qmm_ref(*tensors, k)
    if dev.type != "cuda":
        raise ValueError(f"fused_qmm: unsupported device {dev}")
    if not (1 <= a_bits <= _MAX_BITS and 1 <= b_bits <= _MAX_BITS):
        raise ValueError(f"fused_qmm: plane counts must be 1..{_MAX_BITS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_qmm: operands must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    err = _lib().fused_qmm_launch(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        a_bits, b_bits, m, kw, n, k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_qmm launch failed: cudaError {err}")
    fused_qmm.launches += 1
    return out


fused_qmm.launches = 0
