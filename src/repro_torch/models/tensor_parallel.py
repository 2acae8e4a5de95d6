"""Tensor-parallel serving over a mesh's ``model`` axis (the port's own
module: the reference hands its serving steps the sharding rules and
XLA's partitioner splits the compute).

A serving step over a mesh (``runtime/serve_loop.py``) runs the layer
code unchanged on a rank's config (``local_config``: ``n_heads``,
``n_kv_heads`` and ``d_ff`` divided by the model ranks) and its shards of
the serving params, inside ``sharded(ModelParallel(...))``.  Within that
block the layers read ``current()`` where a rank's part is not the whole:

* a column-parallel site (``attn.q/k/v``, ``ffn.up/gate``) computes its
  own columns from the whole input, nothing to do;
* a row-parallel site (``ROW_SITES``) sees its slice of K: its per-token
  ranges are reduced over the model ranks before the scale is derived
  (``ranges``), and its int32 product and row sums are summed over them
  before the one affine epilogue runs with the global K (``sum_partials``,
  entered through ``flow_abstraction.partial_sums_reduced``).  Integer
  sums and min / max are exact in any order, so every result is the
  one-card step's bit for bit;
* attention runs its local heads; every calibration that spans all heads
  of a batch row (the k / v cache's per-row affine, the query's grid, the
  binary grids) reduces its ranges the same way;
* the vocabulary-sharded embedding takes each token's row from the rank
  that owns it (``lookup``: gathered and selected, never summed, which
  would turn a ``-0.0`` into ``+0.0``), and the unembedding's logits are
  gathered along the vocabulary (``gather_cols``);
* MLA (``attention.mla_attention``) holds the latent cache's columns
  ``[r R/m, (r+1) R/m)`` and the whole rope key: the column-parallel
  ``kv_down`` / ``k_rope`` (and ``q_down``) outputs are gathered whole
  (``gather_cols``) before their rmsnorm and rope, the absorbed decode's
  query heads too; its latent scores' int32 product, row and column sums
  are summed over the ranks before the one epilogue (``sum_ints``), and
  the context's latent columns gathered back (``gather_cols``);
* an MoE layer (``moe.moe_ffn``) runs experts ``[r E/m, (r+1) E/m)`` over
  the whole ``(E, C, D)`` buffer and their outputs are gathered in rank
  order (``gather_rows``: copies, never a sum of zero-padded buffers); the
  shared experts are a dense FFN, column- and row-parallel as above.

``ModelParallel.comm`` carries the collectives: ``all_reduce(t, op,
axis)`` and ``all_gather(t, axis)`` (stacked on a new leading axis in
rank order).  A live step passes the mesh's process groups
(``serve_loop``); the dry-run a stand-in that counts bytes on ``meta``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["ROW_SITES", "ModelParallel", "sharded", "current", "split", "local_config"]

#: the sites whose weights are split along K over ``model``
#: (``runtime/sharding.py``'s row-parallel owners, as the dense blocks name them)
ROW_SITES = frozenset({"attn.o", "ffn.down"})


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """This rank's place on the ``model`` axis (``index`` of ``size``) and
    the collectives over it."""

    comm: Any
    size: int
    index: int

    def ranges(self, lo: torch.Tensor, hi: torch.Tensor):
        """``(lo, hi)`` -> their minimum and maximum over the model ranks:
        one all-reduce MAX of ``(-lo, hi)`` in float32 (exact)."""
        n = lo.numel()
        both = torch.cat([(-lo).reshape(-1), hi.reshape(-1)]).to(torch.float32)
        both = self.comm.all_reduce(both, "max", "model")
        return (-both[:n]).reshape(lo.shape).to(lo.dtype), both[n:].reshape(hi.shape).to(hi.dtype)

    def sum_partials(self, xy: torch.Tensor, row: torch.Tensor, k: int):
        """A row-parallel site's int32 product and row sums summed over the
        model ranks (one int32 all-reduce), and the global K."""
        xy, row = self.sum_ints(xy, row)
        return xy, row, k * self.size

    def gather_cols(self, *ts: torch.Tensor) -> list:
        """Each of ``ts`` (one leading shape) joined along its last axis over
        the model ranks, in rank order: one all-gather of their bytes, so
        every value is a copy (``-0.0`` included)."""
        lead = ts[0].shape[:-1]
        parts = [t.contiguous().view(torch.uint8).reshape(*lead, -1) for t in ts]
        g = self.comm.all_gather(parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1), "model")
        out, o = [], 0
        for t in ts:
            nb = t.shape[-1] * t.element_size()
            piece = g[..., o:o + nb].movedim(0, -2).reshape(*lead, -1).contiguous()
            out.append(piece.view(t.dtype))
            o += nb
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every model rank's ``t`` stacked along its first axis, in rank
        order (one all-gather of its bytes: copies)."""
        g = self.comm.all_gather(t.contiguous().view(torch.uint8), "model")
        return g.view(t.dtype).reshape((-1,) + tuple(t.shape[1:]))

    def sum_ints(self, *ts: torch.Tensor) -> list:
        """Int32 partial sums summed over the model ranks (one int32
        all-reduce): exact in any order."""
        bad = [t.dtype for t in ts if t.dtype != torch.int32]
        if bad:
            raise TypeError(f"partial sums over 'model' must be int32, got {bad}")
        both = self.comm.all_reduce(torch.cat([t.reshape(-1) for t in ts]), "sum", "model")
        out, o = [], 0
        for t in ts:
            out.append(both[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return out

    def cols(self, n: int) -> slice:
        """This rank's columns of a width ``n`` split evenly over the ranks."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def lookup(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of a vocabulary-sharded ``table`` (this rank holds rows
        ``[index * rows, (index + 1) * rows)``) for ``tokens``: each rank
        looks up the tokens it owns, every rank's rows are gathered (as
        bytes) and each token's row is taken from its owner."""
        rows = table.shape[0]
        mine = table[(tokens - self.index * rows).clamp(0, rows - 1)]
        g = self.comm.all_gather(mine.contiguous().view(torch.uint8), "model").view(table.dtype)
        owner = torch.div(tokens, rows, rounding_mode="floor").clamp(0, self.size - 1)
        idx = owner[None, ..., None].expand((1,) + tuple(mine.shape))
        return torch.gather(g, 0, idx)[0]


_current: Optional[ModelParallel] = None


@contextlib.contextmanager
def sharded(mp: ModelParallel):
    """Within the block the layers compute a rank's part over ``mp``."""
    global _current
    prev, _current = _current, mp
    try:
        yield
    finally:
        _current = prev


def current() -> Optional[ModelParallel]:
    """The split the layers compute within, or None (one card)."""
    return _current


def split() -> Optional[ModelParallel]:
    """The split over more than one model rank, or None: MLA and the MoE
    experts compute on a model axis of one rank as on one card."""
    return _current if _current is not None and _current.size > 1 else None


def local_config(cfg: ArchConfig, size: int) -> ArchConfig:
    """``cfg`` with a rank's heads and FFN width over ``size`` model ranks
    (``d_head`` stays: the heads split, not their width).  MLA's heads split
    the same way; its ``kv_lora_rank`` / ``q_lora_rank`` stay the global
    widths that the weights' rows have (the cache's latent columns are
    split apart from them), and ``moe`` stays whole: the router and the
    capacity see every expert."""
    kv = cfg.n_heads // size if cfg.mla is not None else cfg.n_kv_heads // size  # MLA's cache has no kv heads
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // size, n_kv_heads=kv, d_ff=cfg.d_ff // size)
