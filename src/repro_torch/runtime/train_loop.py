"""The QAT training step (port of ``repro.runtime.train_loop``): on one
device, over a mesh of ranks, and the compressed data-parallel step.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss's gradients by autograd through the
train-mode forward (``model_zoo.loss_fn``), then one AdamW update
(``optim.adamw``).  The step is functional: it returns new trees and
leaves its inputs as they were.

* **Microbatching**: ``accum_steps`` splits the batch along B into equal
  microbatches (rows past ``micro * accum`` are dropped, as the reference
  drops them) and sums their gradients from zero in float32, one backward
  at a time, so activation memory scales with the microbatch; gradients
  and metrics (``loss``, the MoE balance loss ``aux``, ``nll``) are then
  divided by ``accum``.
* **Remat**: ``TrainConfig.remat`` checkpoints each block, recomputed in
  the backward (``transformer.stack_apply``).

**Over a mesh** (``mesh=``, a ``DeviceMesh`` of ``launch/mesh.py``) the
step computes what the reference's SPMD step computes: the global batch's
step.  XLA derives that from shardings; here each part is written out:

* **Storage**: every latent and both AdamW moments are this rank's shard
  by ``params_shardings(fsdp=True)`` (``train_shardings``;
  ``init_train_state(mesh=)`` draws the whole tree and keeps the shard).
* **Forward**: every leaf is all-gathered before use, in two bucketed
  collectives a step (``_TreePlan``, ``_GatherTree``); with
  ``quant.prebinarize_gather`` a QMM weight is binarized and packed 32
  signs to a word on its shard and the words are gathered, the mesh's
  form of ``prebinarize_params``.  The compute is replicated over ``model``.
* **Batch**: the step takes the global batch and this rank's data index
  ``r`` of ``n`` keeps rows ``[r b/n, (r+1) b/n)`` of each microbatch.
* **Global-batch semantics**: every ``fake_quant``'s range is all-reduced
  (MIN / MAX) over the data ranks, in the forward and in remat's
  recompute (``quantization.ranges_reduced``); the loss and metrics are
  means over the data ranks; the gather's backward sums the gradients
  over the data ranks and keeps this rank's shards (one bucketed
  reduce-scatter, once the model's backward is done), then the step
  divides by the data ranks; AdamW's clip takes the global norm of the
  shards, each element counted once.
* **Not here**: Megatron-style tensor-parallel compute over ``model``, and
  an MoE layer with more than one data rank (its capacity, buffer and
  balance loss are global in the reference; ROADMAP section 1, item 7.4b):
  the mesh step refuses it, and ``make_compressed_dp_step`` trains MoE
  models with each rank's routing local, as the reference's ``shard_map``
  step does.

``make_compressed_dp_step`` is the reference's pure data-parallel step:
params replicated, each rank's gradients of its rows (its ranges and
routing local), averaged by ``optim.compression.compressed_psum`` over each
data axis, then AdamW on every rank alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import packing, tree
from repro_torch.core import quantization as Q
from repro_torch.core.constants import scalar
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw, compression
from repro_torch.runtime import collectives as C
from repro_torch.runtime import sharding as SH

__all__ = [
    "TrainConfig",
    "init_train_state",
    "train_shardings",
    "value_and_grad",
    "prebinarize_params",
    "make_train_step",
    "make_compressed_dp_step",
    "mesh_step_refusal",
    "GATHERED",
]

#: bytes the forward's all-gathers brought to this rank (the gathered
#: leaves less its own shards), by kind: ``"packed"`` (the QMM weights'
#: sign words), ``"latent"`` (float leaves gathered as they are) and
#: ``"latent_equiv"`` (the float32 latents the packed words stand in for)
GATHERED = {"packed": 0, "latent": 0, "latent_equiv": 0}

_QMM_OWNERS = SH._COL_PARALLEL | SH._ROW_PARALLEL | {"up", "gate", "down"}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    accum_steps: int = 1
    remat: bool = True
    aux_weight: float = 0.01


def train_shardings(cfg: ArchConfig, mesh):
    """(params shardings, ``OptState`` shardings) of the training state:
    ``params_shardings(fsdp=True)`` on a shape-only tree (``meta``)."""
    p_sh = SH.params_shardings(Z.init_params(0, cfg, device="meta"), mesh, cfg, fsdp=True)
    return p_sh, adamw.OptState(mu=p_sh, nu=p_sh, step=SH.NamedSharding(mesh, ()))


def init_train_state(seed: int, cfg: ArchConfig, device="cuda", mesh=None):
    """Latent params (``model_zoo.init_params``) and a fresh AdamW state;
    with ``mesh``, this rank's shards of them (every rank draws the same
    tree from ``seed`` and keeps its piece)."""
    params = Z.init_params(seed, cfg, device=device)
    if mesh is not None:
        params = SH.shard_tree(params, train_shardings(cfg, mesh)[0])
    return params, adamw.init_state(params)


def value_and_grad(params: dict, batch: dict, cfg: ArchConfig, tcfg: TrainConfig, prepare=None):
    """(metrics, grads) of ``model_zoo.loss_fn`` at ``params``; the
    metrics detached, the grads a tree like ``params``.  ``prepare`` maps
    the tracked params to the tree the model consumes (a gather, a
    prebinarization)."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    tracked = tree.unflatten(params, leaves)
    used = tracked if prepare is None else prepare(tracked)
    total, metrics = Z.loss_fn(used, batch, cfg, aux_weight=tcfg.aux_weight, remat=tcfg.remat)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, tree.unflatten(params, grads)


# ---------------------------------------------------------------------------
# gathers with their gradient scatter, and the packed-weight gather
# ---------------------------------------------------------------------------


def _alpha(w: torch.Tensor) -> torch.Tensor:
    """``mean(|w|)`` over K (axis -2), in the reference's summation order."""
    return Q._tree_sum_rows(w.abs()) / scalar(float(w.shape[-2]), w.dtype, w.device)


class _PackedBinarize(torch.autograd.Function):
    """``alpha * sign(w)`` in bf16 from a whole latent ``w`` (``(..., K,
    N)``): the signs packed 32 to an int32 word along K and unpacked to
    +-1, scaled by bf16 ``alpha``, as the reference's packed-gather STE
    computes it (its gather is the identity on one device; over a mesh the
    step's ``_GatherTree`` gathers the words).  Backward: the
    straight-through ``g * alpha`` in float32."""

    @staticmethod
    def forward(ctx, w):
        alpha = _alpha(w)
        words = packing.pack_bits((w >= 0).to(torch.int32), 1, axis=-2)
        bits = packing.unpack_bits(words, 1, w.shape[-2], axis=-2, dtype=torch.int8)
        ctx.save_for_backward(alpha)
        return (bits.to(torch.bfloat16) * 2.0 - 1.0) * alpha.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        return g.to(torch.float32) * alpha  # STE through sign


class _TreePlan:
    """How the mesh step gathers a params tree and scatters its gradients:
    each leaf's spec, global and local shapes, and whether it is a QMM
    weight taken through the packed gather.

    ``gather``: every leaf in bucketed all-gathers, one a mesh axis of
    more than one rank (``sharding.gather_pieces``): the float32 shards
    (with each QMM weight's partial ``|w|`` sums over its rows of K) in one
    buffer, the QMM weights' sign words (32 to an int32, packed on the
    shard) in another; each global leaf is put together from the ranks'
    pieces by their coordinates.
    ``scatter``: every gradient, a QMM weight's through the STE (``g *
    alpha``), sliced into the data ranks' pieces and summed to each rank's
    own in one reduce-scatter over ``data``.  A few large collectives
    instead of one per leaf: under gloo each collective of a CUDA tensor
    waits for the device and crosses the host.
    ``traffic``: what one gather and scatter move for this rank, from the
    specs alone; a plan over an abstract mesh of shape-only shards serves
    the dry-run (``launch/dryrun.py``)."""

    def __init__(self, marks, mesh):
        self.mesh = mesh
        self.sizes = mesh_axes(mesh)
        self.order = SH.piece_coords(mesh)
        self.device = marks[0][0].device
        self.leaves = []
        for leaf, sh, is_qmm in marks:
            spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
            shape = tuple(s * SH.shard_count(e, mesh) for s, e in zip(leaf.shape, spec))
            self.leaves.append(("qmm" if is_qmm else "float", spec, shape, tuple(leaf.shape),
                                leaf.element_size()))

    def traffic(self) -> dict:
        """One gather and one scatter of this plan, for this rank: each
        collective's result bytes and count by op (over the mesh axes of
        more than one rank), and the bytes the gather brings in beyond the
        rank's own shards by kind (``GATHERED``'s keys)."""
        gathered = dict.fromkeys(GATHERED, 0)
        buckets = [0, 0]  # bytes of the float32 bucket (shards, row sums) and of the sign words
        scattered = 0
        for kind, spec, shape, local, size in self.leaves:
            others = len(SH.distinct_pieces(spec, self.order)) - 1
            n = math.prod(local)
            scattered += 4 * n  # float32 gradients
            if kind == "float":
                buckets[0] += size * n
                gathered["latent"] += others * n * size
                continue
            n_words = math.prod(local[:-2] + (-(-local[-2] // 32), local[-1]))
            buckets[0] += size * math.prod(local[:-2] + (1, local[-1]))
            buckets[1] += 4 * n_words
            gathered["packed"] += others * n_words * 4
            gathered["latent_equiv"] += others * n * 4
        ops = {"all-gather": {"bytes": 0, "count": 0}, "reduce-scatter": {"bytes": 0, "count": 0}}
        for nbytes in (b for b in buckets if b):
            for n in (n for n in self.sizes.values() if n > 1):
                nbytes *= n
                ops["all-gather"]["bytes"] += nbytes
                ops["all-gather"]["count"] += 1
        if self.sizes.get("data", 1) > 1:
            ops["reduce-scatter"] = {"bytes": scattered, "count": 1}
        return dict(ops, gathered=gathered)

    def gather(self, shards):
        dev = self.device
        floats, partials, words = [], [], []
        for (kind, spec, shape, local, _), s in zip(self.leaves, shards):
            if kind == "qmm":
                partials.append(Q._tree_sum_rows(s.abs()).reshape(-1))
                words.append(packing.pack_bits((s >= 0).to(torch.int32), 1, axis=-2).reshape(-1))
            else:
                floats.append(s.reshape(-1))
        fg, order = SH.gather_pieces(torch.cat(floats + partials), self.mesh)
        wg = SH.gather_pieces(torch.cat(words), self.mesh)[0] if words else None
        outs, alphas = [], []
        fo, po, wo = 0, sum(x.numel() for x in floats), 0
        for kind, spec, shape, local, _ in self.leaves:
            pieces = SH.distinct_pieces(spec, order)
            if kind == "float":
                n = math.prod(local)
                full = torch.empty(shape, dtype=fg.dtype, device=dev)
                for p in pieces:
                    full[SH.shard_slices(spec, shape, self.mesh, order[p])] = fg[p, fo:fo + n].view(local)
                fo += n
                GATHERED["latent"] += (len(pieces) - 1) * n * fg.element_size()
                outs.append(full)
                alphas.append(None)
                continue
            k_loc = local[-2]
            row_local = local[:-2] + (1, local[-1])
            row_shape = shape[:-2] + (1, shape[-1])
            row_spec = spec[:-2] + (None, spec[-1])
            n_words = math.prod(local[:-2] + (-(-k_loc // 32), local[-1]))
            n_row = math.prod(row_local)
            bits = torch.empty(shape, dtype=torch.int8, device=dev)
            sums = torch.zeros(row_shape, dtype=fg.dtype, device=dev)
            for p in pieces:
                c = order[p]
                piece = wg[p, wo:wo + n_words].view(local[:-2] + (-(-k_loc // 32), local[-1]))
                bits[SH.shard_slices(spec, shape, self.mesh, c)] = packing.unpack_bits(
                    piece, 1, k_loc, axis=-2, dtype=torch.int8)
                sums[SH.shard_slices(row_spec, row_shape, self.mesh, c)] += fg[p, po:po + n_row].view(row_local)
            wo += n_words
            po += n_row
            GATHERED["packed"] += (len(pieces) - 1) * n_words * 4
            GATHERED["latent_equiv"] += (len(pieces) - 1) * math.prod(local) * 4
            alpha = sums / scalar(float(shape[-2]), sums.dtype, dev)
            outs.append((bits.to(torch.bfloat16) * 2.0 - 1.0) * alpha.to(torch.bfloat16))
            alphas.append(alpha)
        return outs, alphas

    def scatter(self, grads, alphas):
        n_data = self.sizes.get("data", 1)
        coords = SH.coordinates(self.mesh)
        chunks = [[] for _ in range(n_data)]
        for (kind, spec, shape, local, _), g, alpha in zip(self.leaves, grads, alphas):
            if g is None:
                g = torch.zeros(shape, dtype=torch.float32, device=self.device)
            g = g.to(torch.float32) * alpha if kind == "qmm" else g  # STE through sign
            for d in range(n_data):
                chunks[d].append(SH.local_shard(g, spec, self.mesh, dict(coords, data=d)).reshape(-1))
        mine = C.reduce_scatter(torch.cat([torch.cat(c) for c in chunks]), self.mesh.get_group("data"))
        out, o = [], 0
        for kind, spec, shape, local, _ in self.leaves:
            n = math.prod(local)
            out.append(mine[o:o + n].view(local))
            o += n
        return out


class _GatherTree(torch.autograd.Function):
    """The global leaves (bf16 ``alpha * sign(w)`` for a QMM weight) from
    this rank's shards, ``_TreePlan.gather``; backward: the gradients back
    to the shards, ``_TreePlan.scatter`` (the straight-through ``g * alpha``
    for a QMM weight).  One call per step, so its backward runs once, after
    the model's whole backward."""

    @staticmethod
    def forward(ctx, plan, *shards):
        outs, alphas = plan.gather(shards)
        ctx.plan, ctx.alphas = plan, alphas
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.plan.scatter(grads, ctx.alphas))


def _walk(node, sh, path, qmm, other):
    """Rebuild a params tree: each QMM owner's ``{"w"}`` through ``qmm(w,
    sharding)``, every other leaf through ``other(leaf, sharding)``."""
    if isinstance(node, dict):
        if set(node) == {"w"} and path and path[-1] in _QMM_OWNERS and not any(
                s in path for s in ("router", "stub_proj")) and qmm is not None:
            return {"w": qmm(node["w"], None if sh is None else sh["w"])}
        return {k: _walk(v, None if sh is None else sh[k], path + (k,), qmm, other) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, None if sh is None else sh[i], path + (str(i),), qmm, other)
                          for i, v in enumerate(node))
    return other(node, sh)


def _marks(params, shardings, prebin: bool) -> list:
    """(leaf, sharding, is a QMM weight) in the tree's leaf order."""
    marks = []

    def qmm(w, sh):
        marks.append((w, sh, True))
        return w

    def other(leaf, sh):
        marks.append((leaf, sh, False))
        return leaf

    _walk(params, shardings, (), qmm if prebin else None, other)
    return marks


def prebinarize_params(params, cfg: ArchConfig):
    """Replace every QMM latent ``w`` (the reference's ``_QMM_OWNERS``,
    never a router or the stub projection) with its packed-gather STE
    binarization (``_PackedBinarize``); every other leaf passes through.
    The leaves are whole: the tree is what the model consumes on one
    device with ``quant.prebinarize_gather`` set.  The mesh step packs
    each rank's shards and gathers the words itself (``_gathered``)."""
    return _walk(params, None, (), lambda w, sh: _PackedBinarize.apply(w), lambda leaf, sh: leaf)


def _gathered(params, cfg: ArchConfig, mesh, shardings):
    """The tree the model consumes on a mesh: every leaf gathered, QMM
    weights through the packed gather when ``prebinarize_gather`` is set."""
    prebin = cfg.quant.enabled and cfg.quant.prebinarize_gather
    marks = _marks(params, shardings, prebin)
    outs = _GatherTree.apply(_TreePlan(marks, mesh), *[m[0] for m in marks])
    return tree.unflatten(params, list(outs))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _data_index(mesh):
    """(this rank's index over the data axes, their size)."""
    axes = SH.data_axes(mesh)
    coords = SH.coordinates(mesh)
    sizes = {a: mesh.size(mesh.mesh_dim_names.index(a)) for a in axes}
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def _rows(batch: dict, accum: int, r: int, n: int) -> list:
    """This rank's rows of each microbatch: microbatch ``i`` holds global
    rows ``[i m, (i+1) m)`` (``m = b // accum``), of which data rank ``r``
    of ``n`` keeps ``[i m + r m/n, i m + (r+1) m/n)``."""
    b = batch["tokens"].shape[0]
    micro = b // accum
    if micro % n:
        raise ValueError(f"a microbatch of {micro} rows does not split over {n} data ranks")
    k = micro // n
    return [{key: v[i * micro + r * k:i * micro + (r + 1) * k] for key, v in batch.items()}
            for i in range(accum)]


def _range_reduce(group):
    """``fake_quant``'s (lo, hi) -> the minimum and maximum over ``group``:
    one all-reduce MAX of ``(-lo, hi)`` in float32 (exact for bf16)."""
    def fn(lo, hi):
        both = torch.stack([-lo.to(torch.float32), hi.to(torch.float32)])
        both = C.all_reduce(both, "max", group=group)
        return (-both[0]).to(lo.dtype), both[1].to(hi.dtype)
    return fn


def _owned(spec, mesh) -> bool:
    """Whether this rank counts a leaf's shard in a global sum: the first
    rank along every mesh axis the leaf is replicated over."""
    used = set()
    for e in spec:
        used.update(SH._axes_of(e))
    coords = SH.coordinates(mesh)
    return all(coords[a] == 0 for a in mesh.mesh_dim_names if a not in used)


def _sharded_norm(grads, shardings, mesh) -> torch.Tensor:
    """The global norm of gradients held as shards: each leaf's sum of
    squares over the ranks that own a piece of it, the leaf sums added."""
    own = [_owned(sh.spec, mesh) for sh in tree.leaves(shardings)]

    def reduce(sums):
        w = torch.tensor([1.0 if o else 0.0 for o in own], dtype=sums.dtype, device=sums.device)
        sums = sums * w
        for axis in mesh.mesh_dim_names:
            sums = C.all_reduce(sums, group=mesh.get_group(axis))
        return sums

    return adamw.global_norm(grads, reduce=reduce)


def _is_moe(cfg: ArchConfig) -> bool:
    return cfg.moe is not None and any(k == "Mm" for k in cfg.layer_kinds)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device="cuda", mesh=None):
    """The train step for ``cfg`` on ``device``.  ``batch``: ``{"tokens":
    (B, S)}``, and ``"frontend"`` (B, P, d_input) for a model with one, as
    numpy or tensors (moved to ``device``; microbatches slice every leaf
    along B).  With ``mesh``, the global-batch step over the mesh's ranks:
    ``params`` and ``opt_state`` are this rank's shards (``train_shardings``),
    ``batch`` the global batch."""
    accum = tcfg.accum_steps
    if mesh is not None:
        return _make_mesh_step(cfg, tcfg, device, mesh)
    prepare = None
    if cfg.quant.enabled and cfg.quant.prebinarize_gather:
        def prepare(p):
            return prebinarize_params(p, cfg)

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if accum == 1:
            metrics, grads = value_and_grad(params, batch, cfg, tcfg, prepare)
        else:
            micro = batch["tokens"].shape[0] // accum
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree.leaves(params)]
            metrics = None
            for i in range(accum):
                mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
                m, g = value_and_grad(params, mb, cfg, tcfg, prepare)
                grads = [a + b for a, b in zip(grads, tree.leaves(g))]
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
            grads = tree.unflatten(params, [g / accum for g in grads])
            metrics = {k: v / accum for k, v in metrics.items()}
        params2, opt2, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, tcfg.optimizer, adamw.decay_mask(params, cfg))
        return params2, opt2, dict(metrics, **opt_metrics)

    return step


def mesh_step_refusal(cfg: ArchConfig, mesh) -> Optional[str]:
    """Why the mesh step cannot train ``cfg`` over ``mesh`` (any mesh,
    abstract or not), or None."""
    sizes = mesh_axes(mesh)
    if sizes.get("pod", 1) > 1:
        return (f"the mesh step takes a (data, model) mesh: its fake-quant ranges and gradient "
                f"reduce-scatter reduce over 'data' alone, so a 'pod' axis of {sizes['pod']} ranks "
                "has no step")
    n = math.prod(sizes[a] for a in SH.data_axes(mesh))
    if n > 1 and _is_moe(cfg):
        return (f"{cfg.name}: an MoE layer over {n} data ranks needs global routing (capacity "
                "positions, the expert buffer and the balance loss over the global batch; ROADMAP "
                "section 1, item 7.4b); make_compressed_dp_step trains it with each rank's routing local")
    return None


def _make_mesh_step(cfg: ArchConfig, tcfg: TrainConfig, device, mesh):
    accum = tcfg.accum_steps
    reason = mesh_step_refusal(cfg, mesh)
    if reason is not None:
        raise NotImplementedError(reason)
    r, n = _data_index(mesh)
    p_sh, _ = train_shardings(cfg, mesh)
    group = mesh.get_group("data")
    ranges = _range_reduce(group)

    def prepare(p):
        return _gathered(p, cfg, mesh, p_sh)

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        grads, metrics = None, None
        with Q.ranges_reduced(ranges):
            for mb in _rows(batch, accum, r, n):
                m, g = value_and_grad(params, mb, cfg, tcfg, prepare)
                g = tree.leaves(g)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
        scale = float(n * accum)
        grads = tree.unflatten(params, [g / scale for g in grads])
        metrics = {k: C.all_reduce(v, group=group) / scale for k, v in metrics.items()}
        gnorm = _sharded_norm(grads, p_sh, mesh)
        params2, opt2, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, tcfg.optimizer, adamw.decay_mask(params, cfg), gnorm=gnorm)
        return params2, opt2, dict(metrics, **opt_metrics)

    return step


def make_compressed_dp_step(cfg: ArchConfig, tcfg: TrainConfig, mesh, compress: bool = True,
                            device="cuda"):
    """Pure data-parallel step with the int8 error-feedback all-reduce over
    every data axis in turn (``pod``, then ``data``): ``step(params,
    opt_state, err_state, batch) -> (params, opt_state, err_state,
    metrics)``.  Params and the optimizer state are replicated (whole on
    every rank), ``err_state`` is this rank's (``compression.init_error_state``),
    ``batch`` the global batch, of which this rank takes its data index's
    rows.  Each rank's forward is the single-device one on its rows: its
    fake-quant ranges and MoE routing are its own, as in the reference's
    ``shard_map``.  The metrics are means over the data ranks."""
    axes = SH.data_axes(mesh)
    r, n = _data_index(mesh)
    groups = [mesh.get_group(a) for a in axes]

    def step(params, opt_state, err_state, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        (rows,) = _rows(batch, 1, r, n)
        metrics, grads = value_and_grad(params, rows, cfg, tcfg)
        for g in groups:
            grads, err_state = compression.compressed_psum(grads, err_state, g, enabled=compress)
        params2, opt2, om = adamw.apply_updates(params, grads, opt_state, tcfg.optimizer,
                                                adamw.decay_mask(params, cfg))
        out = {}
        for k, v in dict(metrics, **om).items():
            v = v.to(torch.float32)
            for g in groups:
                v = C.all_reduce(v, group=g) / C.group_size(g)
            out[k] = v
        return params2, opt2, err_state, out

    return step
