"""Sharding rules: params / optimizer state / batches / caches -> specs
(port of ``repro.runtime.sharding``), and the placement of a tensor by its
spec on a mesh.

Mesh contract (``launch/mesh.py``): ``(data, model)`` single-pod or
``(pod, data, model)`` multi-pod.  ``pod`` is pure DP; ``data`` is in-pod
DP (+ sequence parallelism fallback) and FSDP storage in training;
``model`` is TP/EP.

A spec is a tuple with the entries of the reference's ``PartitionSpec``,
one per leading dim (missing trailing entries are ``None``): ``None`` (the
dim is whole on every rank), an axis name (the dim split evenly over that
axis) or a tuple of names (split over their product, the first axis
major).  ``NamedSharding`` pairs one with its mesh, as the reference's.

Rules (the reference's, verbatim; Megatron-style, packed-weight aware):

* column-parallel (q/k/v/up/gate/in_*, router-less): shard the OUTPUT dim
  over ``model``.
* row-parallel (o/down/out*): shard the INPUT dim over ``model`` -- for
  bit-packed weights that is the PACKED axis.
* experts (E, K, N): shard E over ``model`` (expert parallelism).
* embeddings (V, D): V over ``model`` (vocab-parallel logits).
* KV caches: batch over ``data`` when divisible; else sequence over
  ``data``.  Heads over ``model`` when divisible, else head_dim, else
  replicate.
* everything 1D/scalar: replicated.
* FSDP (training): a ``data`` shard layered onto the largest still
  unsharded dim that ``data`` divides (``_add_fsdp``).

Every rule is divisibility-guarded.  **Per-layer leaves**: the reference
stacks each position of the repeated period on a leading scan axis and the
port keeps one dict per layer (prefix layers first, then each period in
turn; ``convert.py``).  A port leaf of a period layer takes the spec of the
stacked leaf it comes from with the scan entry dropped -- so a norm gain,
rank 1 here and rank 2 there, is FSDP-sharded over ``data`` as the
reference shards it; where the reference's FSDP chose the scan axis itself
the leaf stays replicated over ``data``.  Prefix layers are not stacked
and keep their own rank's rules; so do an encoder stack's layers' leaves
against the reference's encoder period.  Caches follow the same mapping
(a stacked cache's scan entry is always ``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import tree
from repro_torch.launch.mesh import mesh_axes

__all__ = [
    "NamedSharding",
    "param_pspec",
    "params_shardings",
    "batch_shardings",
    "cache_pspec",
    "cache_shardings",
    "data_axes",
    "logical_batch_spec",
    "ref_path",
    "shard_count",
    "shard_index",
    "shard_slices",
    "coordinates",
    "local_shard",
    "piece_coords",
    "gather_pieces",
    "distinct_pieces",
    "shard_tree",
    "gather_tree",
    "gather_tree_to",
]

_COL_PARALLEL = {
    "q", "k", "v", "up", "gate", "in_proj", "in_x", "in_gate",
    "gate_a", "gate_i", "q_up", "q_down", "kv_down", "k_rope", "k_up",
    "v_up", "q_proj", "proj", "stub_proj",
}
_ROW_PARALLEL = {"o", "down", "out", "out_proj"}
_EMBED = {"embedding", "unembedding"}

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a leaf of a shardings tree, not a container)."""

    mesh: Any
    spec: Spec

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global ``t`` (``local_shard``)."""
        return local_shard(t, self.spec, self.mesh)


def P(*entries) -> Spec:
    return tuple(entries)


def data_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _shard_if(dim: int, size: int, axis: str) -> Optional[str]:
    return axis if size > 1 and dim % size == 0 else None


def param_pspec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> Spec:
    """Spec for one parameter/optimizer leaf, at a path and shape of the
    reference's layout (``ref_path`` maps a port leaf there)."""
    msize = _axis_size(mesh, "model")
    names = [str(p) for p in path]
    stacked = 1 if "period" in names else 0  # scan dim leads
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    owner = parent if leaf in ("w", "w_packed", "w_scale", "w_offset", "w_colsum") else leaf

    def spec(*entries):
        return P(*([None] * stacked + list(entries)))

    ndim = len(shape) - stacked

    if leaf in _EMBED or owner in _EMBED:
        if ndim == 2:
            return spec(_shard_if(shape[stacked], msize, "model"), None)
        return P()

    if leaf == "pos_embedding":
        return P()

    if owner == "router":
        return P()  # tiny + accuracy-critical: replicated

    # Expert stacks carry a leading E dim beyond the 2D (or packed-2D) base:
    #   w/w_packed (E, K[, /32], N), w_scale/offset (E, 1, N), w_colsum (E, N)
    # -- all sharded over E (expert parallelism).
    is_w_leaf = leaf in ("w", "w_packed", "w_scale", "w_offset", "w_colsum")
    if is_w_leaf:
        base = {"w": 2, "w_packed": 2, "w_scale": 2, "w_offset": 2, "w_colsum": 1}[leaf]
        if ndim > base:  # expert-stacked
            return spec(_shard_if(shape[stacked], msize, "model"), *([None] * (ndim - 1)))

    if owner in _COL_PARALLEL:
        if leaf in ("w", "w_packed"):  # (K[, /32], N): shard N
            return spec(None, _shard_if(shape[-1], msize, "model"))
        if leaf in ("w_scale", "w_offset"):  # (1, N)
            return spec(None, _shard_if(shape[-1], msize, "model"))
        if leaf == "w_colsum":  # (N,)
            return spec(_shard_if(shape[-1], msize, "model"))

    if owner in _ROW_PARALLEL:
        if leaf in ("w", "w_packed"):  # (K[, /32], N): shard K
            return spec(_shard_if(shape[stacked], msize, "model"), None)
        return spec(*([None] * ndim))  # scales/colsums over N=d_model: replicate

    # norms, gains, convs, A_log, biases: replicate
    return P()


def _add_fsdp(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Layer a ZeRO/FSDP 'data'-axis shard onto the largest still-unsharded
    dim.  Training-only: latent fp32 weights + two Adam moments are 12
    bytes/param.  Serving params skip this."""
    dsize = _axis_size(mesh, "data")
    if dsize <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [
        (shape[i], i)
        for i in range(len(shape))
        if entries[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize
    ]
    if not candidates:
        return spec
    _, best = max(candidates)
    entries[best] = "data"
    return P(*entries)


def ref_path(path: Tuple[str, ...], shape: Tuple[int, ...], cfg) -> Tuple[Tuple[str, ...], Tuple[int, ...], bool]:
    """A port leaf's (path, shape) -> the reference's stacked leaf it comes
    from: ``(path, shape, stacked)``.  ``("layers", i, ...)`` is prefix
    layer ``i`` or position ``(i - n_prefix) % period`` of the period
    stack, whose leaves carry ``n_periods`` on a leading axis;
    ``("encoder", "layers", i, ...)`` likewise in the encoder's stack (a
    period of one layer, ``encoder.n_layers`` times)."""
    names = tuple(str(p) for p in path)
    if names[:1] == ("layers",):
        i, rest, head = int(names[1]), names[2:], ("stack",)
        n_prefix, period, n = len(cfg.prefix_layers), len(cfg.pattern_period), cfg.n_periods
    elif names[:2] == ("encoder", "layers"):
        i, rest, head = int(names[2]), names[3:], ("encoder", "stack")
        n_prefix, period, n = 0, 1, cfg.encoder.n_layers
    else:
        return names, tuple(shape), False
    if i < n_prefix:
        return head + ("prefix", f"[{i}]") + rest, tuple(shape), False
    j = (i - n_prefix) % period
    return head + ("period", f"[{j}]") + rest, (n,) + tuple(shape), True


def _unstack(spec: Spec, stacked: bool) -> Spec:
    """Drop the scan entry of a stacked leaf's spec; whatever the reference
    put there (FSDP's ``data``, at most) leaves the port leaf replicated
    over it."""
    return tuple(spec[1:]) if stacked else tuple(spec)


def _trim(spec: Spec) -> Spec:
    """A spec in the reference's normal form: a one-axis tuple entry as
    its axis, trailing ``None`` entries dropped."""
    spec = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _paths(params):
    return [(tuple(p.split("/")[1:]), leaf) for p, leaf in tree.leaves_with_paths(params)]


def params_shardings(params, mesh, cfg, fsdp: bool = False):
    """A tree like ``params`` of ``NamedSharding``: each leaf's spec by the
    reference's rules at its stacked leaf (``ref_path``), FSDP over
    ``data`` on every leaf of rank >= 2 there when ``fsdp``."""
    out = []
    for path, leaf in _paths(params):
        names, shape, stacked = ref_path(path, tuple(leaf.shape), cfg)
        spec = param_pspec(names, shape, mesh)
        if fsdp and len(shape) >= 2:
            spec = _add_fsdp(spec, shape, mesh)
        out.append(NamedSharding(mesh, _trim(_unstack(spec, stacked))))
    return tree.unflatten(params, out)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def logical_batch_spec(batch_size: int, seq_len: int, mesh) -> Spec:
    """(B, S) spec: batch over (pod, data) when divisible, else SP over data."""
    dp = list(data_axes(mesh))
    dp_size = _prod(_axis_size(mesh, a) for a in dp) if dp else 1
    if dp and batch_size % dp_size == 0:
        return P(tuple(dp), None)
    # sequence parallelism fallback (long_500k: B=1)
    if "pod" in dp and batch_size % _axis_size(mesh, "pod") == 0:
        return P("pod", _shard_if(seq_len, _axis_size(mesh, "data"), "data"))
    return P(None, _shard_if(seq_len, dp_size and _axis_size(mesh, "data"), "data"))


def batch_shardings(batch_shape: dict, mesh):
    """Shardings for {"tokens": (B,S), optional "frontend": (B,T,D)}."""
    out = {}
    for k, v in batch_shape.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        spec = logical_batch_spec(shape[0], shape[1], mesh)
        if k != "tokens":
            spec = P(*(list(spec) + [None] * (len(shape) - 2)))
        out[k] = NamedSharding(mesh, spec)
    return out


def cache_pspec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh, batch: int) -> Spec:
    """KV/SSM cache leaves. Layouts:
    kv: (B,T,kvH,dh) / mla: (B,T,R) / ssd: (B,H,P,N) / conv: (B,w,C) /
    rglru h: (B,di); scan-stacked versions carry a leading period dim."""
    names = [str(p) for p in path]
    leaf = names[-1]
    stacked = 1 if "period" in names else 0
    msize = _axis_size(mesh, "model")
    dp = data_axes(mesh)
    dp_size = _prod(_axis_size(mesh, a) for a in dp) if dp else 1
    ndim = len(shape) - stacked

    def spec(*entries):
        return P(*([None] * stacked + list(entries)))

    if leaf in ("pos",):
        return P()
    if ndim == 0 or ndim == 1:
        return P()

    b_dim = shape[stacked]
    b_spec = tuple(dp) if (dp and b_dim % dp_size == 0) else None

    if leaf in ("k", "v") and ndim == 4:  # (B,T,kvH,dh)
        kvh, dh = shape[stacked + 2], shape[stacked + 3]
        if kvh % msize == 0 and msize > 1:
            return spec(b_spec, None, "model", None)
        if dh % msize == 0 and msize > 1:
            return spec(b_spec, None, None, "model")
        return spec(b_spec, None, None, None)
    if leaf == "ckv" and ndim == 3:  # (B,T,R): latent over model
        r = shape[stacked + 2]
        return spec(b_spec, None, _shard_if(r, msize, "model"))
    if leaf == "k_rope" and ndim == 3:
        return spec(b_spec, None, None)
    if leaf == "ssm" and ndim == 4:  # (B,H,P,N)
        h = shape[stacked + 1]
        return spec(b_spec, _shard_if(h, msize, "model"), None, None)
    if leaf == "conv" and ndim == 3:  # (B,w,C)
        c = shape[stacked + 2]
        return spec(b_spec, None, _shard_if(c, msize, "model"))
    if leaf == "h" and ndim == 2:  # (B,di)
        return spec(b_spec, _shard_if(shape[stacked + 1], msize, "model"))
    if leaf == "encoder_out" and ndim == 3:
        return spec(b_spec, None, None)
    # scales/offsets and anything else
    return spec(*([None] * ndim))


def cache_shardings(cache, mesh, batch: int, cfg):
    """A tree like ``cache`` of ``NamedSharding`` (each layer's leaves at
    the reference's stacked cache leaf, its scan entry dropped)."""
    out = []
    for path, leaf in _paths(cache):
        names, shape, stacked = ref_path(path, tuple(leaf.shape), cfg)
        spec = cache_pspec(names, shape, mesh, batch)
        out.append(NamedSharding(mesh, _trim(_unstack(spec, stacked))))
    return tree.unflatten(cache, out)


# ---------------------------------------------------------------------------
# placement: the slice of a global leaf that a rank holds, and its gather
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_count(entry, mesh) -> int:
    """How many pieces a dim with spec entry ``entry`` is split into."""
    return _prod(_axis_size(mesh, a) for a in _axes_of(entry))


def shard_index(entry, mesh, coords: dict) -> int:
    """The piece of that dim held at mesh coordinates ``coords`` (``{axis:
    index}``), the entry's first axis major."""
    idx = 0
    for a in _axes_of(entry):
        idx = idx * _axis_size(mesh, a) + coords.get(a, 0)
    return idx


def coordinates(mesh) -> dict:
    """This rank's ``{axis: index}`` on a ``DeviceMesh``."""
    c = mesh.get_coordinate()
    if c is None:
        raise RuntimeError("this rank is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, c))


def shard_slices(spec: Spec, shape, mesh, coords: dict) -> tuple:
    """The index (a slice a dim) of the piece of a global leaf of ``shape``
    held at mesh coordinates ``coords`` under ``spec``."""
    idx = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n = shard_count(entry, mesh)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {entry!r} ({n})")
        k = size // n
        j = shard_index(entry, mesh, coords) if n > 1 else 0
        idx.append(slice(j * k, (j + 1) * k))
    return tuple(idx)


def local_shard(t: torch.Tensor, spec: Spec, mesh, coords: Optional[dict] = None) -> torch.Tensor:
    """The slice of the global ``t`` that the rank at ``coords`` (this rank
    on a ``DeviceMesh`` by default) holds under ``spec``, contiguous."""
    coords = coordinates(mesh) if coords is None else coords
    return t[shard_slices(spec, tuple(t.shape), mesh, coords)].contiguous()


def piece_coords(mesh) -> list:
    """The mesh coordinates of each rank's piece, in the order a gather over
    each mesh axis of more than one rank in turn stacks them
    (``gather_pieces``): the last axis gathered is the outermost.  Any mesh,
    abstract or not."""
    sizes = mesh_axes(mesh)
    coords = [{}]
    for a in (a for a, n in sizes.items() if n > 1):
        coords = [dict(c, **{a: i}) for i in range(sizes[a]) for c in coords]
    return [dict(dict.fromkeys(sizes, 0), **c) for c in coords]


def gather_pieces(buf: torch.Tensor, mesh) -> Tuple[torch.Tensor, list]:
    """Every rank's 1-D ``buf`` (one length on all ranks): an all-gather
    over each mesh axis of more than one rank in turn.  Returns (pieces
    ``(ranks, length)``, the mesh coordinates of each piece)."""
    from repro_torch.runtime import collectives as C

    for a, n in mesh_axes(mesh).items():
        if n > 1:
            buf = C.all_gather(buf, mesh.get_group(a))
    coords = piece_coords(mesh)
    return buf.reshape(len(coords), -1), coords


def distinct_pieces(spec: Spec, coords: list) -> list:
    """The indices into ``coords`` of one piece per distinct slice of a
    leaf under ``spec`` (a replica's copies dropped)."""
    used = {a for e in spec for a in _axes_of(e)}
    return [p for p, c in enumerate(coords) if all(v == 0 for a, v in c.items() if a not in used)]


def gather_tree(tree_, shardings):
    """The global tree from every rank's pieces, a collective every rank of
    the mesh calls: the leaves of one dtype in one bucket, gathered at once
    (``gather_pieces``), each global leaf put together from the pieces by
    their coordinates."""
    leaves, shs = tree.leaves(tree_), tree.leaves(shardings)
    mesh = shs[0].mesh
    out = [None] * len(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        pieces, coords = gather_pieces(torch.cat([leaves[i].reshape(-1) for i in idx]), mesh)
        o = 0
        for i in idx:
            t, spec = leaves[i], shs[i].spec
            shape = tuple(n * shard_count(spec[d] if d < len(spec) else None, mesh) for d, n in enumerate(t.shape))
            full = torch.empty(shape, dtype=t.dtype, device=t.device)
            for p in distinct_pieces(spec, coords):
                full[shard_slices(spec, shape, mesh, coords[p])] = pieces[p, o:o + t.numel()].view(t.shape)
            o += t.numel()
            out[i] = full
    return tree.unflatten(tree_, out)


def gather_tree_to(tree_, shardings, bucket: int = 1 << 26, device="cpu"):
    """The global tree on ``device`` (the host by default) of the mesh's
    first rank (every coordinate 0), ``None`` on the other ranks: a
    collective every rank of the mesh calls (a checkpoint's gather to its
    writer).  The leaves of one dtype go in buckets of about ``bucket``
    elements; a bucket is gathered over each mesh axis of more than one
    rank in turn, to the
    axis's first rank (``collectives.gather_to``; a rank off the first
    along an axis already gathered sits the later ones out), and put
    together on ``device``.  So no rank's device holds more than the ranks'
    pieces of one bucket beside what it puts together there, and only the
    first rank holds those."""
    from repro_torch.runtime import collectives as C

    leaves, shs = tree.leaves(tree_), tree.leaves(shardings)
    mesh = shs[0].mesh
    sizes = mesh_axes(mesh)
    axes = [a for a in mesh.mesh_dim_names if sizes[a] > 1]
    me = coordinates(mesh)
    coords = piece_coords(mesh)
    first = all(v == 0 for v in me.values())
    out = [None] * len(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        while idx:
            take, n = [], 0
            while idx and (not take or n + leaves[idx[0]].numel() <= bucket):
                n += leaves[idx[0]].numel()
                take.append(idx.pop(0))
            buf = torch.cat([leaves[i].reshape(-1) for i in take])
            for k, a in enumerate(axes):
                if any(me[b] for b in axes[:k]):
                    break
                buf = C.gather_to(buf, mesh.get_group(a))
            if not first:
                continue
            pieces, o = buf.reshape(len(coords), -1).to(device), 0
            for i in take:
                t, spec = leaves[i], shs[i].spec
                shape = tuple(m * shard_count(spec[d] if d < len(spec) else None, mesh)
                              for d, m in enumerate(t.shape))
                full = torch.empty(shape, dtype=t.dtype, device=device)
                for p in distinct_pieces(spec, coords):
                    full[shard_slices(spec, shape, mesh, coords[p])] = pieces[p, o:o + t.numel()].view(t.shape)
                o += t.numel()
                out[i] = full
    return tree.unflatten(tree_, out) if first else None


def shard_tree(tree_, shardings, coords: Optional[dict] = None):
    """Each leaf of a global tree sliced to this rank's (or ``coords``')
    piece under the matching ``NamedSharding``."""
    return tree.unflatten(tree_, [local_shard(t, sh.spec, sh.mesh, coords)
                                  for t, sh in zip(tree.leaves(tree_), tree.leaves(shardings))])


