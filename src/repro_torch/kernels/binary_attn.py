"""``binary_attn_scores_planes``: rank-4 AND-popcount attention scores -> int32.

Wrapper of the hand-written CUDA kernel ``csrc/binary_attn.cu``, the
counterpart of the reference's plain jnp core
``repro/kernels/binary_attn.py::binary_attn_scores_planes`` (the ``binary``
entry of the scores backend family; no Pallas kernel).  For CUDA tensors it
launches the kernel (or raises); for CPU tensors it runs the plain version
``ref.binary_attn_scores_ref``.  ``binary_attn_scores_planes.launches``
counts kernel launches and nothing else.
On ``meta`` tensors (shape-only, the dry-run's) the plain version gives
the output's shape and dtype.  The wrapper is a trusted kernel boundary
of the invariant verifier (``core/marks.py``).

The kernel reads both operands through their strides, so the K operand may
be the packed K cache ``(B, T, kvH, dw)`` seen as ``(B, kvH, T, dw)``
(``.permute(0, 2, 1, 3)``) without a copy; only the word axis must be
contiguous.  Its launch plan comes from the C function
``binary_attn_plan``, which :func:`plan` reads for logs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import marks, packing
from repro_torch.kernels import build, ref

__all__ = ["binary_attn_scores_planes", "plan"]


def _lib() -> ctypes.CDLL:
    lib = build.load("binary_attn")
    if lib.binary_attn_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.binary_attn_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        )
        lib.binary_attn_launch.restype = ctypes.c_int
        lib.binary_attn_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.binary_attn_plan.restype = None
    return lib


def plan(b: int, h: int, g: int, s: int, t: int) -> dict:
    """The launch's plan for ``(B, H, S) x (B, G, T)``: folded rows and keys
    a block, and the grid."""
    out = (ctypes.c_int * 5)()
    _lib().binary_attn_plan((h // g) * s, t, b * g, ctypes.addressof(out))
    return dict(rows=out[0], keys=out[1], grid=(out[2], out[3], out[4]))


@marks.boundary(marks.KERNEL)
def binary_attn_scores_planes(q_planes: torch.Tensor, k_planes: torch.Tensor, *, dh: int) -> torch.Tensor:
    """``out[b, h, s, t] = sum_w popcount(q[b, h, s, w] & k[b, h // (H/G), t,
    w])`` -> int32 ``(B, H, S, T)``, contiguous.

    ``q_planes`` ``(B, H, S, dw)`` and ``k_planes`` ``(B, G, T, dw)``: int32
    words carrying ``dh`` {0, 1} bits packed along the last axis
    (``dw = ceil(dh/32)``, zero tail in at least one operand, as packing
    leaves it); H a multiple of G.  Ragged S, T and dw need no padding.
    """
    for name, x in (("q_planes", q_planes), ("k_planes", k_planes)):
        if x.dtype != torch.int32:
            raise TypeError(f"binary_attn_scores_planes: {name} must be int32 words, got {x.dtype}")
        if x.ndim != 4:
            raise ValueError(f"binary_attn_scores_planes: {name} must be rank 4, got {x.ndim}")
        if x.shape[-1] != packing.packed_len(dh, 1):
            raise ValueError(
                f"binary_attn_scores_planes: {name} packed axis holds {x.shape[-1]} words, "
                f"expected ceil({dh}/32) = {packing.packed_len(dh, 1)}"
            )
    b, h, s, dw = q_planes.shape
    g, t = k_planes.shape[1], k_planes.shape[2]
    if k_planes.shape[0] != b or h % g:
        raise ValueError(
            f"binary_attn_scores_planes: q {tuple(q_planes.shape)} and k {tuple(k_planes.shape)} "
            "need the same batch and H a multiple of G"
        )
    dev = q_planes.device
    if k_planes.device != dev:
        raise ValueError(f"binary_attn_scores_planes: operands on {dev} and {k_planes.device}")
    if dev.type in ("cpu", "meta"):
        return ref.binary_attn_scores_ref(q_planes, k_planes, dh)
    if dev.type != "cuda":
        raise ValueError(f"binary_attn_scores_planes: unsupported device {dev}")
    if q_planes.stride(-1) != 1 or k_planes.stride(-1) != 1:
        raise ValueError("binary_attn_scores_planes: the word axis of each operand must be contiguous")
    out = torch.empty((b, h, s, t), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    qst, kst = q_planes.stride(), k_planes.stride()
    err = _lib().binary_attn_launch(
        q_planes.data_ptr(), k_planes.data_ptr(), out.data_ptr(), b, h, g, s, t, dw,
        qst[0], qst[1], qst[2], kst[0], kst[1], kst[2],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"binary_attn_scores_planes launch failed: cudaError {err}")
    binary_attn_scores_planes.launches += 1
    return out


binary_attn_scores_planes.launches = 0
