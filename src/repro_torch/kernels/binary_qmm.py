"""K1 ``binary_qmm``: int8 activations x packed 1-bit weights -> int32.

Wrapper of the hand-written CUDA kernel ``csrc/binary_qmm.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/binary_qmm.py::binary_qmm``.
For CUDA tensors it launches the kernel (or raises); for CPU tensors it
runs the plain version ``ref.binary_qmm_ref``.  ``binary_qmm.launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import build, ref

__all__ = ["binary_qmm"]

_BN = 64  # output columns per block (csrc/binary_qmm.cu)
_MIN_WORDS_PER_SPLIT = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("binary_qmm")
    if lib.binary_qmm_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.binary_qmm_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        lib.binary_qmm_launch.restype = ctypes.c_int
        lib.binary_qmm_rows_per_thread.argtypes = [ctypes.c_int]
        lib.binary_qmm_rows_per_thread.restype = ctypes.c_int
    return lib


def _splits(lib, m: int, n: int, kw: int, device: torch.device) -> int:
    """Split K until the grid covers about two blocks per SM."""
    rows = 4 * lib.binary_qmm_rows_per_thread(m)
    tiles = -(-n // _BN) * -(-m // rows)
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-target // tiles), kw // _MIN_WORDS_PER_SPLIT))


def binary_qmm(a: torch.Tensor, w_packed: torch.Tensor, k: int) -> torch.Tensor:
    """``a (M, K) int8 @ unpack(w_packed) (K, N)`` -> int32 ``(M, N)``.

    ``w_packed`` is int32 ``(ceil(K/32), N)`` (1-bit mantissas packed along
    K).  Ragged M / N / K need no padding: the kernel masks its edges.
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
    if a.device.type == "cpu":
        return ref.binary_qmm_ref(a, w_packed, k)
    if a.device.type != "cuda":
        raise ValueError(f"binary_qmm: unsupported device {a.device}")
    if not (a.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("binary_qmm: operands must be contiguous")
    if a.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("binary_qmm: operands must be 16-byte aligned")
    m, n = a.shape[0], w_packed.shape[1]
    lib = _lib()
    splits = _splits(lib, m, n, kw, a.device)
    # split partials are atomically added, so their output starts at zero
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    err = lib.binary_qmm_launch(
        a.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, k, n, splits,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"binary_qmm launch failed: cudaError {err}")
    binary_qmm.launches += 1
    return out


binary_qmm.launches = 0
