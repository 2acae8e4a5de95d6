"""The collectives of the port's multi-device training, over
``torch.distributed`` process groups (a mesh axis's group,
``DeviceMesh.get_group``).

Each returns a new tensor and leaves its input as it was.  Under NCCL a
CUDA tensor goes to the collective as it is.  Gloo reduces and gathers
host memory: a CUDA tensor is copied to the host (page-locked memory, in
pieces of ``_CHUNK`` elements), reduced there and copied back, explicitly,
and ``STAGED`` counts those calls by op, so a run can say what crossed the
host.  Compute stays on the device.  A group of one
rank still runs its collective, which is then the identity.

``BYTES`` counts, by op, the bytes of the tensors this rank hands to its
collectives (each input's size once, whatever the wire's algorithm), so a
run can say what its collectives carried; ``STAGED_S`` the seconds of the
host-staged calls by op (each such call waits for the device anyway).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["STAGED", "STAGED_S", "BYTES", "group_size", "all_reduce", "all_gather", "gather_to",
           "reduce_scatter", "barrier"]

#: op name -> calls whose CUDA tensor gloo took through host memory
STAGED: Counter = Counter()
#: op name -> seconds spent in those calls
STAGED_S: Counter = Counter()
#: op name -> bytes of the tensors this rank handed to the op
BYTES: Counter = Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# the single-tensor gather / reduce-scatter under their newer names where
# the installed torch has them
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


def _host(t: torch.Tensor, group, op: str) -> bool:
    BYTES[op] += t.numel() * t.element_size()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        STAGED[op] += 1
        return True
    return False


class _Timed:
    """Adds the seconds of a host-staged call to ``STAGED_S[op]``."""

    def __init__(self, op: str):
        self.op = op

    def __enter__(self):
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        STAGED_S[self.op] += time.perf_counter() - self.t


#: elements of a host-staged piece (64 MB of float32): each crosses the
#: host through page-locked memory that the caching host allocator reuses
_CHUNK = 1 << 24


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of ``t``."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _host_empty(n: int, dtype) -> torch.Tensor:
    return torch.empty((n,), dtype=dtype, pin_memory=True)


def _chunks(n: int):
    return ((i, min(n, i + _CHUNK)) for i in range(0, max(n, 1), _CHUNK))


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced elementwise (``sum``, ``max`` or ``min``) over ``group``."""
    if _host(t, group, "all_reduce"):
        with _Timed("all_reduce"):
            flat = t.detach().reshape(-1)
            out = torch.empty_like(flat)
            for i, j in _chunks(flat.numel()):
                h = _pinned(flat[i:j])
                dist.all_reduce(h, op=_OPS[op], group=group)
                out[i:j].copy_(h)
        return out.view(t.shape)
    if not t.is_cuda and dist.get_backend(group) == "nccl":  # a host flag under NCCL
        out = t.detach().to(torch.device("cuda", torch.cuda.current_device()), copy=True)
    else:
        out = t.detach().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out.to(t.device) if out.device != t.device else out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked on a new leading axis in
    the order of the group's ranks."""
    n = group_size(group)
    src = t.detach().reshape(-1)
    if _host(t, group, "all_gather"):
        with _Timed("all_gather"):
            out = torch.empty((n, src.numel()), dtype=src.dtype, device=src.device)
            for i, j in _chunks(src.numel()):
                h = _host_empty(n * (j - i), src.dtype)
                _all_gather_single(h, _pinned(src[i:j]), group=group)
                out[:, i:j].copy_(h.view(n, j - i))
        return out.view((n,) + tuple(t.shape))
    out = torch.empty((n * src.numel(),), dtype=src.dtype, device=src.device)
    _all_gather_single(out, src.contiguous(), group=group)
    return out.view((n,) + tuple(t.shape))


def gather_to(t: torch.Tensor, group=None) -> Optional[torch.Tensor]:
    """Every rank's ``t`` of ``group``, stacked on a new leading axis in the
    order of the group's ranks, on the group's first rank; ``None`` on the
    others.  Only the first rank receives, so only it holds the ranks'
    pieces."""
    n = group_size(group)
    dst = 0 if group is None else dist.get_global_rank(group, 0)
    mine = dist.get_rank() == dst
    src = t.detach().reshape(-1).contiguous()
    out = torch.empty((n, src.numel()), dtype=src.dtype, device=src.device) if mine else None
    if _host(t, group, "gather"):
        with _Timed("gather"):
            for i, j in _chunks(src.numel()):
                h = _host_empty(n * (j - i), src.dtype).view(n, j - i) if mine else None
                dist.gather(_pinned(src[i:j]), list(h.unbind(0)) if mine else None, dst=dst, group=group)
                if mine:
                    out[:, i:j].copy_(h)
    else:
        dist.gather(src, list(out.unbind(0)) if mine else None, dst=dst, group=group)
    return out.view((n,) + tuple(t.shape)) if mine else None


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` of ``t`` (leading axis ``n * k``), of which
    this rank keeps rows ``[r * k, (r + 1) * k)``, ``r`` its index in the
    group."""
    n = group_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter of {tuple(t.shape)} over {n} ranks")
    shape = (t.shape[0] // n,) + tuple(t.shape[1:])
    if _host(t, group, "reduce_scatter"):
        # an all-to-all brings each rank the ranks' pieces of its own rows,
        # summed on the device in the group's order; gloo's reduce-scatter
        # took longer than an all-reduce of the whole tensor (PERF.md)
        with _Timed("reduce_scatter"):
            rows = t.detach().reshape(n, -1)  # rank r's rows, flattened
            out = torch.empty((rows.shape[1],), dtype=t.dtype, device=t.device)
            for i, j in _chunks(rows.shape[1]):
                h = _host_empty(n * (j - i), t.dtype)
                dist.all_to_all_single(h, _pinned(rows[:, i:j].reshape(-1)), group=group)
                pieces = h.view(n, j - i).to(t.device)
                out[i:j].copy_(pieces[0])
                for p in range(1, n):
                    out[i:j] += pieces[p]
        return out.view(shape)
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    _reduce_scatter_single(out, t.detach().contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def barrier(groups, device: Optional[torch.device] = None) -> None:
    """Wait for every rank of each group in turn (an all-reduce of one
    value, so it serves any backend and only the mesh's ranks)."""
    for g in groups:
        all_reduce(torch.zeros((1,), device=device or "cpu"), group=g)
