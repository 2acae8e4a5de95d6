"""K1 ``binary_qmm``: int8 activations x packed 1-bit weights -> int32.

Wrapper of the hand-written CUDA kernel ``csrc/binary_qmm.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/binary_qmm.py::binary_qmm``.
For CUDA tensors it launches the kernel (or raises); for CPU tensors it
runs the plain version ``ref.binary_qmm_ref``.  ``binary_qmm.launches``
counts kernel launches and nothing else.

The kernel multiplies on the int8 tensor cores (``mma.sync`` s8 x u8: the
activations as they are, the weight bits spread to bytes in shared
memory).  Its tile and its split of K across blocks come from one place,
the C function ``binary_qmm_plan``; :func:`plan` reads it, and the wrapper
zero-fills the output where the plan splits K (split partials are added
atomically).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.kernels import build, ref

__all__ = ["binary_qmm", "plan"]


def _lib() -> ctypes.CDLL:
    lib = build.load("binary_qmm")
    if lib.binary_qmm_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.binary_qmm_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        lib.binary_qmm_launch.restype = ctypes.c_int
        lib.binary_qmm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.binary_qmm_plan.restype = None
    return lib


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(m: int, k: int, n: int, device: torch.device) -> tuple:
    """``(block rows, block columns, K splits)`` of the launch for ``(m, k, n)``
    on the CUDA ``device``."""
    out = (ctypes.c_int * 3)()
    _lib().binary_qmm_plan(m, k, n, _sms(device), ctypes.addressof(out))
    return tuple(out)


def binary_qmm(
    a: torch.Tensor, w_packed: torch.Tensor, k: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``a (M, K) int8 @ unpack(w_packed) (K, N)`` -> int32 ``(M, N)``.

    ``w_packed`` is int32 ``(ceil(K/32), N)`` (1-bit mantissas packed along
    K).  Ragged M / N / K need no padding: the kernel masks its edges.
    ``out``, when given, is a contiguous int32 ``(M, N)`` tensor on the
    operands' device that receives the product (a slice of a larger buffer,
    for example); it is returned.
    """
    if a.dtype != torch.int8 or a.ndim != 2 or a.shape[1] != k:
        raise ValueError(f"binary_qmm: a must be int8 (M, {k}), got {a.dtype} {tuple(a.shape)}")
    if w_packed.dtype != torch.int32 or w_packed.ndim != 2:
        raise ValueError(f"binary_qmm: w_packed must be int32 rank 2, got {w_packed.dtype}")
    kw = packing.packed_len(k, 1)
    if w_packed.shape[0] != kw:
        raise ValueError(f"binary_qmm: w_packed has {w_packed.shape[0]} words, expected {kw}")
    if a.device != w_packed.device:
        raise ValueError(f"binary_qmm: operands on {a.device} and {w_packed.device}")
    m, n = a.shape[0], w_packed.shape[1]
    if out is not None and (out.dtype != torch.int32 or tuple(out.shape) != (m, n)
                            or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"binary_qmm: out must be contiguous int32 ({m}, {n}) on {a.device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if a.device.type == "cpu":
        return ref.binary_qmm_ref(a, w_packed, k, out)
    if a.device.type != "cuda":
        raise ValueError(f"binary_qmm: unsupported device {a.device}")
    if not (a.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("binary_qmm: operands must be contiguous")
    if a.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("binary_qmm: operands must be 16-byte aligned")
    splits = plan(m, k, n, a.device)[2]
    if out is None:
        out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if splits > 1:  # split partials are atomically added, so the output starts at zero
        out.zero_()
    if m == 0 or n == 0:
        return out
    err = _lib().binary_qmm_launch(
        a.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, k, n, _sms(a.device),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"binary_qmm launch failed: cudaError {err}")
    binary_qmm.launches += 1
    return out


binary_qmm.launches = 0
