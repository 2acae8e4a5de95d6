"""int8 error-feedback gradient compression for data parallelism (port of
``repro.optim.compression``).

Each data-parallel step:

    1. residual-corrected gradient:  g' = g + e        (error feedback)
    2. quantize per leaf to int8:    q = round(g' / s), s = max|g'| / 127,
       the scale shared by every rank (an all-reduce MAX of each rank's
       max|g'| first: per-rank scales would bias the integer sum)
    3. all-reduce the payload: the int8 mantissas summed in int32, as
       the reference sums them, so the collective carries as many bytes
       as float32's would (the int8 payload itself is a quarter of them)
    4. new residual:                 e = g' - q * s

The residuals re-enter the next step, so the scheme is unbiased in the
limit.  ``compressed_psum`` is the reference's ``compressed_psum`` over a
process group instead of a ``shard_map`` axis; the reference's
``jax.vmap(..., axis_name=)`` run is its oracle on the CPU.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.constants import scalar
from repro_torch.runtime import collectives as C

__all__ = ["init_error_state", "compress", "decompress", "compressed_psum", "payload_bytes"]


def init_error_state(grads) -> Any:
    return tree.unflatten(grads, [torch.zeros_like(g, dtype=torch.float32) for g in tree.leaves(grads)])


def _quantize(corrected: torch.Tensor, scale: torch.Tensor):
    lo, hi = scalar(-127.0, torch.float32, corrected.device), scalar(127.0, torch.float32, corrected.device)
    q = torch.minimum(torch.maximum(torch.round(corrected / scale), lo), hi).to(torch.int8)
    return q, corrected - q.to(torch.float32) * scale


def _scale(max_abs: torch.Tensor) -> torch.Tensor:
    dev = max_abs.device
    return torch.maximum(max_abs, scalar(1e-12, torch.float32, dev)) / scalar(127.0, torch.float32, dev)


def compress(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 payload, float32 scale, new error residual)."""
    corrected = g.to(torch.float32) + err
    scale = _scale(torch.max(torch.abs(corrected)))
    q, residual = _quantize(corrected, scale)
    return q, scale, residual


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads, err_state, group=None, enabled: bool = True) -> Tuple[Any, Any]:
    """All-reduce a gradient tree over ``group`` with int8 payloads:
    (the ranks' mean gradients, each rank's new error state).  With
    ``enabled=False``, the float32 mean and the error state as it was.

    Per leaf it is the reference's arithmetic; the collectives are
    bucketed over the leaves (one all-reduce MAX of the leaves' maxima,
    one int32 all-reduce of every payload), which sums and takes maxima
    elementwise as one collective a leaf would."""
    flat_g = tree.leaves(grads)
    dev = flat_g[0].device
    n = C.all_reduce(torch.ones((), dtype=torch.float32, device=dev), group=group)
    sizes = [g.numel() for g in flat_g]
    if not enabled:
        total = C.all_reduce(torch.cat([g.to(torch.float32).reshape(-1) for g in flat_g]), group=group)
        avg = [x.view(g.shape) / n for x, g in zip(total.split(sizes), flat_g)]
        return tree.unflatten(grads, avg), err_state

    corrected = [g.to(torch.float32) + e for g, e in zip(flat_g, tree.leaves(err_state))]
    global_max = C.all_reduce(torch.stack([torch.max(torch.abs(c)) for c in corrected]), "max", group=group)
    scales = [_scale(m) for m in global_max.unbind(0)]
    quantized = [_quantize(c, s) for c, s in zip(corrected, scales)]
    q_sum = C.all_reduce(torch.cat([q.to(torch.int32).reshape(-1) for q, _ in quantized]), group=group)
    avg = [(qs.view(g.shape).to(torch.float32) * s / n).to(g.dtype)
           for qs, s, g in zip(q_sum.split(sizes), scales, flat_g)]
    return tree.unflatten(grads, avg), tree.unflatten(err_state, [r for _, r in quantized])


def payload_bytes(grads) -> Tuple[int, int]:
    """(bytes of the int8 payload, bytes of the float32 gradients) of
    ``grads``, one copy each: the sizes, not what the collectives carry
    (``runtime.collectives.BYTES`` counts that)."""
    n = sum(g.numel() for g in tree.leaves(grads))
    return n, 4 * n
