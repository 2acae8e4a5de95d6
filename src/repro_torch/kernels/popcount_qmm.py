"""K3 ``popcount_qmm``: binary x binary AND-popcount over packed operands -> int32.

Wrapper of the hand-written CUDA kernel ``csrc/popcount_qmm.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/popcount_qmm.py::popcount_qmm``.
For CUDA tensors it launches the kernel (or raises); for CPU tensors it
runs the plain version ``ref.popcount_qmm_ref``.  ``popcount_qmm.launches``
counts kernel launches and nothing else.

The kernel multiplies the packed words themselves on the binary tensor
cores (``mma.sync`` m16n8k256 ``.b1 .and.popc``).  Its tile and its split
of K across blocks come from one place, the C function
``popcount_qmm_plan``, which the launch follows and :func:`plan` reads for
logs and tests.  Where the plan splits K the launch zero-fills the output
itself (split partials are added atomically).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

__all__ = ["popcount_qmm", "plan"]


def _lib() -> ctypes.CDLL:
    lib = build.load("popcount_qmm")
    if lib.popcount_qmm_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.popcount_qmm_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        lib.popcount_qmm_launch.restype = ctypes.c_int
        lib.popcount_qmm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.popcount_qmm_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(m: int, k: int, n: int, device: torch.device) -> tuple:
    """``(block rows, block columns, K splits)`` of the launch for ``(m, k, n)``
    (``k`` bits, packed into ``ceil(k/32)`` words) on the CUDA ``device``."""
    out = (ctypes.c_int * 3)()
    _lib().popcount_qmm_plan(m, -(-k // 32), n, _sms(device), ctypes.addressof(out))
    return tuple(out)


def popcount_qmm(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """``out[m, n] = sum_w popcount(a_packed[m, w] & b_packed[w, n])`` -> int32.

    ``a_packed`` is int32 ``(M, Kw)`` and ``b_packed`` int32 ``(Kw, N)``:
    1-bit mantissas packed 32 to a word along K.  Whole words are counted,
    so bits past the logical K must be zero in at least one operand, as
    packing leaves them.  Ragged M / N / Kw need no padding.
    """
    if a_packed.ndim != 2 or b_packed.ndim != 2:
        raise ValueError("popcount_qmm: operands must be rank 2")
    if a_packed.dtype != torch.int32 or b_packed.dtype != torch.int32:
        raise ValueError(
            f"popcount_qmm: operands must be int32 words, got {a_packed.dtype}, {b_packed.dtype}"
        )
    (m, kw), (kw2, n) = a_packed.shape, b_packed.shape
    if kw != kw2:
        raise ValueError(f"popcount_qmm: packed K {kw} != {kw2}")
    dev = a_packed.device
    if b_packed.device != dev:
        raise ValueError(f"popcount_qmm: operands on {dev} and {b_packed.device}")
    if dev.type == "cpu":
        return ref.popcount_qmm_ref(a_packed, b_packed, 32 * kw)
    if dev.type != "cuda":
        raise ValueError(f"popcount_qmm: unsupported device {dev}")
    if not (a_packed.is_contiguous() and b_packed.is_contiguous()):
        raise ValueError("popcount_qmm: operands must be contiguous")
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    err = _lib().popcount_qmm_launch(
        a_packed.data_ptr(), b_packed.data_ptr(), out.data_ptr(), m, kw, n, _sms(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"popcount_qmm launch failed: cudaError {err}")
    popcount_qmm.launches += 1
    return out


popcount_qmm.launches = 0
