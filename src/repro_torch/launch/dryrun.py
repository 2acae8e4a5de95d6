"""Multi-pod dry-run of the port (counterpart of ``repro.launch.dryrun``):
account for every (arch x shape x mesh) cell on shape-only trees.

The reference lowers and compiles each cell for 512 host placeholder
devices and reads XLA's memory and cost analyses.  The port builds every
tree on the ``meta`` device instead (no values, no memory, no card) and
counts what one rank of the production mesh (``launch/mesh.py``:
``make_production_mesh``, (16, 16) or (2, 16, 16)) would hold and do:

  * ``memory.argument_size_in_bytes`` -- rank (0, 0)'s shards of the step's
    arguments under the sharding rules (``runtime/sharding.py``): the
    params (``params_shardings``, FSDP in training), the AdamW state in
    training, the cache in serving (``cache_shardings``) and the whole
    copies a serving rank holds beside its shards
    (``serve_loop.whole_copies``), and the batch (``batch_shardings``);
    ``memory.arguments`` gives each part;
  * ``collectives`` -- training: the bytes the mesh step's gather and
    reduce-scatter move a step, by op, from its ``_TreePlan``
    (``runtime/train_loop.py``), with the bytes gathered into the rank by
    kind (``GATHERED``'s keys: under ``--opt packed_gather`` the QMM
    weights travel as packed sign words); for an MoE model over data
    ranks also its routing's all-gathers and all-reduces (``"routing"``,
    by part: the ``(n, E)`` counts, the buffer exchange, the balance
    statistics and their gradient, each MoE layer and microbatch, remat's
    recompute counted again; ``models/moe.py::routing_traffic``), added to
    the totals by op;
    serving: the bytes the sharded step's collectives carry a call, by op
    (each input's size once, as ``runtime/collectives.py::BYTES`` counts
    them live), counted by a stand-in for the collectives as the step runs
    on ``meta``;
  * ``flops`` -- one rank's step counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on meta tensors (matrix
    products only: the kernels' plain versions, which the wrappers run on
    meta, count their integer products as ``2 M K N``).

Training computes replicated over ``model`` (ROADMAP item 7.7): a rank
takes its data index's rows of the batch and the whole gathered model, so
``flops`` is the model's on ``global_batch / data ranks`` rows, an MoE
layer's experts over the global microbatch's ``E * C`` buffer rows (every
rank runs the experts over the whole buffer).  Serving runs the sharded
step (``runtime/serve_loop.py::MeshStep``): a rank's rows of the batch
over the data axes and its heads, FFN columns and vocabulary shard over
``model``, MLA's latent columns and the routed experts over ``model`` and
an MoE layer's routing over the data ranks, so a serving cell's ``flops``
and ``collectives`` are that step's, the live code path run on ``meta``.
At the production meshes the step counts gemma3-27b's and
deepseek-v3-671b's serving cells (every width divides over 16 model
ranks); it refuses granite-8b's, mistral-nemo-12b's, qwen3-32b's and
bit-bert-base's (their kv heads do not split over 16: ROADMAP item 7.8,
follow-up 5), deepseek-v2-lite-16b's (its dense ``d_ff`` of 10,944 does
not split over 16 ranks on 32-bit words), the recurrent and encoder
families' (follow-ups 3 and 4) and the smoke arch's (one kv head).  XLA's temporary and
generated-code sizes have no counterpart and are not written.  A cell
whose step cannot run records ``status: "error"`` with the reason (a pod
axis in training, a batch that does not split over the data ranks -- the
port has no sequence parallelism --, a serving config or mesh that
``sharding.serve_mesh_refusal`` refuses, an operator with no meta path)
beside the numbers counted before it, never a guessed number.  The reference's ``--opt gqa_expand`` has no counterpart
(the port's attention is always grouped), nor has ``--no-compile``
(nothing compiles).

Artifacts are cached as JSON per cell under --out (schema
``dryrun-torch/v1``); re-runs skip completed cells.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smoke   # CI cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import SHAPES_BY_NAME, ArchConfig, InputShape
from repro_torch.core import tree

__all__ = [
    "SCHEMA",
    "SMOKE_SHAPE",
    "OPT_TRANSFORMS",
    "input_specs",
    "skip_reason",
    "apply_opts",
    "argument_bytes",
    "collective_bytes",
    "serving_counts",
    "step_flops",
    "run_cell",
    "cell_path",
    "main",
]

SCHEMA = "dryrun-torch/v1"

#: The CI cell: reduced config, reduced shape -- accounted for in seconds.
SMOKE_SHAPE = InputShape("smoke", 128, 8, "train")

META = torch.device("meta")

COMPUTE = ("one rank: its data index's rows of the batch; training over the whole (gathered) model, "
           "computed replicated over 'model' (no tensor-parallel training compute, ROADMAP item 7.7), an "
           "MoE layer routing the global microbatch and running its experts over the whole E x C buffer; "
           "serving over its heads, FFN columns, vocabulary shard, MLA latent columns and routed experts on "
           "'model' (the sharded step, Megatron-style, integer partial sums all-reduced in int32), an MoE "
           "layer routing the global batch")

OPT_TRANSFORMS = {
    "scores_bf16": dict(attn_scores_dtype="bf16"),
    "logits_bf16": dict(logits_dtype="bf16"),
    "packed_gather": "quant",  # binarize + pack before the FSDP all-gather
}


def apply_opts(cfg: ArchConfig, opts) -> ArchConfig:
    for o in opts or ():
        if o.startswith("accum"):
            continue  # handled by accum_steps
        if o == "packed_gather":
            cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, prebinarize_gather=True))
            continue
        cfg = dataclasses.replace(cfg, **OPT_TRANSFORMS[o])
    return cfg


def skip_reason(cfg: ArchConfig, shape: InputShape):
    """Documented skips (the reference's)."""
    if shape.name == "long_500k" and not cfg.is_sub_quadratic:
        return "long_500k requires sub-quadratic attention (DESIGN.md §5)"
    if shape.kind == "decode" and not cfg.has_decoder:
        return "encoder-only arch has no decode step"
    return None


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Shape-only inputs of one cell's global batch: the prompt tokens (the
    decode step's one token a row) and a frontend's embeddings."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.encoder is not None:
        d_in = cfg.encoder.d_input or cfg.d_model
        specs["frontend"] = torch.empty((b, cfg.encoder.n_positions, d_in), dtype=torch.float32, device=META)
    return specs


def _local_bytes(tree_, shardings) -> int:
    """Bytes of rank (0, ..., 0)'s pieces of ``tree_``'s leaves."""
    from repro_torch.runtime import sharding as SH

    total = 0
    for t, sh in zip(tree.leaves(tree_), tree.leaves(shardings)):
        pieces = math.prod(SH.shard_count(e, sh.mesh) for e in sh.spec)
        total += t.numel() // pieces * t.element_size()
    return total


def _data_ranks(mesh) -> int:
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.runtime import sharding as SH

    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in SH.data_axes(mesh))


def argument_bytes(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Rank (0, 0)'s bytes of the step's arguments by part: ``params``,
    ``opt_state`` (training: AdamW's two float32 moments and its step),
    ``cache`` and ``whole_copies`` (serving: the leaves a rank holds whole
    beside its shards, ``serve_loop.whole_copies``) and ``batch``."""
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import train_loop as TL
    from repro_torch.runtime.serve_loop import whole_copies

    specs = input_specs(cfg, shape)
    out = {"batch": _local_bytes(specs, SH.batch_shardings(specs, mesh))}
    if shape.kind == "train":
        params = Z.init_params(0, cfg, device=META)
        p_sh, o_sh = TL.train_shardings(cfg, mesh)
        out["params"] = _local_bytes(params, p_sh)
        out["opt_state"] = _local_bytes(adamw.init_state(params), o_sh)
        return out
    params = Z.prepare_serving_params(Z.init_params(0, cfg, device=META), cfg)
    cache = Z.init_cache(shape.global_batch, shape.seq_len, cfg, device=META)
    copies = whole_copies(params, SH.mesh_axes(mesh).get("model", 1))
    out["params"] = _local_bytes(params, SH.params_shardings(params, mesh, cfg))
    out["whole_copies"] = sum(t.numel() * t.element_size() for c in copies for t in tree.leaves(c))
    out["cache"] = _local_bytes(cache, SH.cache_shardings(cache, mesh, shape.global_batch, cfg))
    return out


def collective_bytes(cfg: ArchConfig, mesh, accum_steps: int = 1, shape: InputShape = None) -> dict:
    """What the mesh training step's gathers and reduce-scatter move for
    rank (0, 0) a step (``accum_steps`` microbatches, each gathering the
    tree once), from its plan over shape-only shards; the bytes gathered
    into the rank by kind under ``"gathered"``.  With ``shape``, an MoE
    model's routing collectives too (``"routing"``, by part, and in the
    totals by op)."""
    from repro_torch.models import model_zoo as Z
    from repro_torch.models import moe as M
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import train_loop as TL

    params = Z.init_params(0, cfg, device=META)
    p_sh, _ = TL.train_shardings(cfg, mesh)
    origin = {a: 0 for a in SH.mesh_axes(mesh)}
    shards = tree.unflatten(params, [SH.local_shard(t, sh.spec, mesh, origin)
                                     for t, sh in zip(tree.leaves(params), tree.leaves(p_sh))])
    prebin = cfg.quant.enabled and cfg.quant.prebinarize_gather
    plan = TL._TreePlan(TL._marks(shards, p_sh, prebin), mesh).traffic()
    out = {}
    for op, v in plan.items():
        out[op] = {k: n * accum_steps for k, n in v.items()}
    n_data = _data_ranks(mesh)
    if shape is not None and cfg.moe is not None and n_data > 1:
        tokens = shape.global_batch // accum_steps // n_data * shape.seq_len
        one = torch.zeros((1, 1), dtype=torch.int64, device=META)
        act_bytes = Z._embed_inputs(params, one, cfg, one).element_size()  # the residual stream's
        routing = M.routing_traffic(cfg, tokens, n_data, TL.TrainConfig().remat, act_bytes)
        out["routing"] = {part: dict(v, bytes=v["bytes"] * accum_steps, count=v["count"] * accum_steps)
                          for part, v in routing.items()}
        for v in out["routing"].values():
            op = out.setdefault(v["op"], {"bytes": 0, "count": 0})
            op["bytes"] += v["bytes"]
            op["count"] += v["count"]
    out["total_bytes"] = sum(v["bytes"] for op, v in out.items() if op not in ("gathered", "routing"))
    return out


def _meta_routing(cfg: ArchConfig, mesh):
    """Shape-only stand-ins for the routing collectives of data rank 0
    (``meta`` tensors carry no values), or None where the step routes on
    one rank."""
    from repro_torch.models import moe as M

    n = _data_ranks(mesh)
    if cfg.moe is None or n == 1:
        return None
    return M.GlobalRouting(n=n, r=0, all_gather=lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape)),
                           all_reduce=lambda t: t.clone())


class _CountingComm:
    """Shape-only stand-ins for a serving step's collectives on ``meta``:
    each call's input bytes counted by op, as ``collectives.BYTES`` counts
    a live call's, and a result of the live call's shape."""

    def __init__(self, mesh):
        from repro_torch.launch.mesh import mesh_axes

        self.sizes = mesh_axes(mesh)
        self.ops = {}

    def _count(self, op: str, t: torch.Tensor) -> None:
        rec = self.ops.setdefault(op, {"bytes": 0, "count": 0})
        rec["bytes"] += t.numel() * t.element_size()
        rec["count"] += 1

    def all_reduce(self, t: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        self._count("all-reduce", t)
        return t.clone()

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        self._count("all-gather", t)
        return t.unsqueeze(0).expand((self.sizes[axis],) + tuple(t.shape)).contiguous()


def serving_counts(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Rank (0, ..., 0)'s serving step over ``mesh`` (``serve_loop.MeshStep``:
    a prefill of ``shape.seq_len`` tokens a row, or a decode step over a
    cache of that many rows) run on ``meta``: its ``flops``
    (``FlopCounterMode``) and its collectives' bytes and calls by op, with
    their ``total_bytes``.  A refused config or mesh raises
    ``NotImplementedError`` with ``sharding.serve_mesh_refusal``'s reason."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import model_zoo as Z
    from repro_torch.runtime.serve_loop import MeshStep

    b = shape.global_batch
    prefill = shape.kind == "prefill"
    comm = _CountingComm(mesh)
    step = MeshStep(Z.prefill if prefill else Z.decode_step, cfg, mesh, b, shape.seq_len,
                    (b, shape.seq_len) if prefill else (b,), device=META, comm=comm,
                    coords={a: 0 for a in mesh_axes(mesh)})
    params = step.shard_params(Z.prepare_serving_params(Z.init_params(0, cfg, device=META), cfg))
    tokens = torch.empty(step.tokens_shape, dtype=torch.int64, device=META)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        step(params, tokens, step.init_cache(META))
    coll = dict(comm.ops)
    coll["total_bytes"] = sum(v["bytes"] for v in comm.ops.values())
    return {"flops": counter.get_total_flops(), "collectives": coll}


def step_flops(cfg: ArchConfig, shape: InputShape, mesh, accum_steps: int = 1) -> int:
    """One rank's step's FLOPs (``FlopCounterMode``, matrix products) on
    meta tensors: data rank 0's rows of the global batch, split as the mesh
    step splits them (``train_loop._rows``: ``accum_steps`` microbatches,
    each over the data ranks; a batch that does not split raises), in
    training the forward, the checkpoints' recompute and the backward, an
    MoE layer routing the global microbatch (``moe.routing_global``).  A
    serving shape is counted by ``serving_counts``."""
    import contextlib

    from repro_torch.models import model_zoo as Z
    from repro_torch.models import moe as M
    from repro_torch.runtime import train_loop as TL

    if shape.kind != "train":
        raise ValueError(f"step_flops counts a training step; {shape.name} is a {shape.kind} shape "
                         "(serving_counts)")
    micro = TL._rows(input_specs(cfg, shape), accum_steps, 0, _data_ranks(mesh))
    params = Z.init_params(0, cfg, device=META)
    prepare = None
    if cfg.quant.enabled and cfg.quant.prebinarize_gather:
        def prepare(p):
            return TL.prebinarize_params(p, cfg)
    routing = _meta_routing(cfg, mesh)
    with FlopCounterMode(display=False) as counter, (
            contextlib.nullcontext() if routing is None else M.routing_global(routing)):
        for mb in micro:
            TL.value_and_grad(params, mb, cfg, TL.TrainConfig(), prepare)
    return counter.get_total_flops()


def _cfg(arch: str, opts) -> ArchConfig:
    if arch == "smoke":
        from repro_torch.configs.smoke import smoke_variant

        return apply_opts(smoke_variant(get_config("granite-8b")), opts)
    return apply_opts(get_config(arch), opts)


def run_cell(arch: str, shape_name: str, mesh_kind: str, accum_steps: int = 1, opts=()) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime import train_loop as TL

    cfg = _cfg(arch, opts)
    shape = SMOKE_SHAPE if shape_name == SMOKE_SHAPE.name else SHAPES_BY_NAME[shape_name]
    record: dict = {
        "schema": SCHEMA,
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "opts": list(opts or ()),
        "time": time.time(),
    }
    reason = skip_reason(cfg, shape)
    if reason:
        record.update(status="skip", reason=reason)
        return record

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    record["mesh_shape"] = dict(mesh.shape)
    record["compute"] = COMPUTE
    record["step"] = {"train": "train_step", "prefill": "prefill", "decode": "decode_step"}[shape.kind]
    if shape.kind == "train":
        record["accum"] = accum_steps
    record["data_ranks"] = _data_ranks(mesh)
    t0 = time.time()
    try:
        # the rules' numbers first: they stand whether or not a step runs
        args = argument_bytes(cfg, shape, mesh)
        record["memory"] = {"argument_size_in_bytes": sum(args.values()), "arguments": args}
        if shape.kind == "train":
            refusal = TL.mesh_step_refusal(cfg, mesh)
            if refusal is not None:
                raise NotImplementedError(refusal)
            record["collectives"] = collective_bytes(cfg, mesh, accum_steps, shape)
            record["flops"] = step_flops(cfg, shape, mesh, accum_steps)
        else:
            counts = serving_counts(cfg, shape, mesh)
            record["collectives"], record["flops"] = counts["collectives"], counts["flops"]
        record["count_s"] = round(time.time() - t0, 1)
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- recorded, the sweep continues
        record["count_s"] = round(time.time() - t0, 1)
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def cell_path(out_dir: str, arch: str, shape: str, mesh_kind: str, suffix: str = "") -> str:
    tail = f"__{suffix}" if suffix else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{tail}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ASSIGNED) + ["smoke"], default=None)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME) + [SMOKE_SHAPE.name], default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--out", default="artifacts/dryrun-torch")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--opt", action="append", default=[], choices=list(OPT_TRANSFORMS))
    ap.add_argument("--suffix", default="", help="artifact suffix for variants")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ASSIGNED) if (args.all or args.arch is None) else [args.arch]
    if args.arch == "smoke" and args.shape is None and not args.all:
        shapes = [SMOKE_SHAPE.name]
    else:
        shapes = list(SHAPES_BY_NAME) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(args.out, arch, shape, mesh_kind, args.suffix)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("schema") == SCHEMA and prev.get("status") in ("ok", "skip"):
                        print(f"[cached] {arch} {shape} {mesh_kind}: {prev['status']}")
                        continue
                print(f"[run] {arch} {shape} {mesh_kind} ...", flush=True)
                rec = run_cell(arch, shape, mesh_kind, args.accum_steps, opts=args.opt)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                msg = rec["status"]
                if rec["status"] == "ok":
                    coll = rec.get("collectives", {}).get("total_bytes")
                    msg += (f" args={rec['memory']['argument_size_in_bytes']}B flops={rec['flops']:.3e}"
                            + (f" coll={coll:.3e}B" if coll is not None else "")
                            + f" in {rec['count_s']}s")
                elif rec["status"] == "error":
                    msg += f" ({rec['error'][:200]})"
                print(f"[done] {arch} {shape} {mesh_kind}: {msg}", flush=True)


if __name__ == "__main__":
    main()
