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
contiguous.  Its launch plan is :func:`plan`, plain Python, which the
wrapper passes to the C launcher: the tile of folded query rows x keys,
the key tiles a block walks and the stages of its ``cp.async`` ring.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import marks, packing
from repro_torch.kernels import build, ref

__all__ = ["binary_attn_scores_planes", "plan"]


def _lib() -> ctypes.CDLL:
    lib = build.load("binary_attn")
    if lib.binary_attn_launch.argtypes is None:  # pointers must not pass as 32-bit ints
        lib.binary_attn_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.binary_attn_launch.restype = ctypes.c_int
    return lib


#: The (folded rows, keys) tiles ``csrc/binary_attn.cu`` is built for,
#: largest first; the most K tiles its ring holds; an H100's SMs and the
#: shared memory a block may take; the most key tiles a block walks.
TILES = tuple(sorted(((r, k) for r in (64, 32, 16, 8) for k in (128, 64, 32)),
                     key=lambda rk: (-rk[0] * rk[1], -rk[0])))
MAX_STAGES = 3
SMS = 132
SMEM_LIMIT = 232_448
MAX_PER = 4


def _warps(rows: int, keys: int):
    wk = min(4, keys // 16)
    return wk, min(4 // wk, rows // 8)


def threads(rows: int, keys: int) -> int:
    """Threads of a block of the ``rows x keys`` tile: a warp per 16-key x
    8-row fragment, at most four warps."""
    wk, wr = _warps(rows, keys)
    return 32 * wk * wr


def smem_bytes(rows: int, keys: int, stages: int, dw: int) -> int:
    """Dynamic shared memory: the Q tile and ``stages`` K tiles, rows of
    ``dw`` rounded up to 8 words plus 4 (the kernel's ``ld``), and each
    warp's 8-row store buffer of its keys plus 4 words."""
    wk, wr = _warps(rows, keys)
    return 4 * ((rows + stages * keys) * (-(-dw // 8) * 8 + 4) + wk * wr * 8 * (keys // wk + 4))


def plan(b: int, h: int, g: int, s: int, t: int, dw: int, sms: int = SMS) -> dict:
    """The launch for ``(B, H, S) x (B, G, T)`` over ``dw`` words: the
    largest tile (``rows`` folded query rows x ``keys`` keys of one (b, g))
    whose count fills ``sms`` SMs, else the one with the most tiles; blocks
    on a grid (key tile groups, row tiles, B * G), each walking
    ``tiles_per_block`` consecutive key tiles through a ring of
    ``min(MAX_STAGES, tiles_per_block)`` K tiles.  A block walks more than
    one (up to ``MAX_PER``) only where one row tile holds every folded row
    -- a decode, whose K tile weighs as much as its output -- and the grid
    still fills the SMs: on an H100 that took a long decode 10-20% faster,
    while every prefill measured ran fastest at one key tile a block
    (``PERF.md``)."""
    m, bg = (h // g) * s, b * g
    cap = 8
    while cap < min(m, 64):
        cap *= 2
    fits = [(r, k) for r, k in TILES if r <= cap and smem_bytes(r, k, 2, dw) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"binary_attn plan: dw = {dw} words leave no tile within {SMEM_LIMIT} B of shared memory")

    def count(rk):
        return -(-m // rk[0]) * -(-t // rk[1]) * bg

    rows, keys = next((rk for rk in fits if count(rk) >= sms), max(fits, key=count))
    row_tiles, key_tiles = -(-m // rows), -(-t // keys)
    per = 1
    while row_tiles == 1 and per < MAX_PER and -(-key_tiles // (2 * per)) * bg >= sms:
        per *= 2
    stages = min(MAX_STAGES, per)
    if smem_bytes(rows, keys, stages, dw) > SMEM_LIMIT:
        stages = 2
    grid = (-(-key_tiles // per), row_tiles, bg)
    return dict(rows=rows, keys=keys, threads=threads(rows, keys), tiles=row_tiles * key_tiles * bg,
                blocks=grid[0] * grid[1] * grid[2], tiles_per_block=per, stages=stages,
                smem=smem_bytes(rows, keys, stages, dw), grid=grid)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    p = plan(b, h, g, s, t, dw, _sms(out.device.index))
    err = _lib().binary_attn_launch(
        q_planes.data_ptr(), k_planes.data_ptr(), out.data_ptr(), b, h, g, s, t, dw,
        qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], p["rows"], p["keys"], p["tiles_per_block"],
        p["stages"], torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"binary_attn_scores_planes launch failed: cudaError {err}")
    binary_attn_scores_planes.launches += 1
    return out


binary_attn_scores_planes.launches = 0
