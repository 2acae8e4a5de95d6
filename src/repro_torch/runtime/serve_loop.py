"""Continuous-batching serving engine (port of ``repro.runtime.serve_loop``).

* ``make_prefill`` / ``make_decode_step`` -- the fixed-shape steps, captured
  once as CUDA graphs and replayed (the counterparts of the reference's
  ``jax.jit`` steps); with ``mesh=`` a ``MeshStep`` over a ``(data,
  model)`` mesh of ranks;
* ``ServeEngine`` -- continuous batching over a replayed decode step;
* ``serve_sequential`` -- the eager one-request-at-a-time oracle;
* ``serving_params_shardings`` -- the sharding rules on the serving tree
  (a shape-only template on ``meta``), which a ``MeshStep``'s params follow.

Over a mesh (``MeshStep``) a rank holds its shards of the serving params
(``serving_params_shardings``) and of the cache (``cache_shardings``),
takes its data index's rows of the batch, and computes the dense
attention decoders Megatron-style over ``model``
(``models/tensor_parallel.py``); the deepseek family's MLA with the latent
cache's columns split over ``model`` (the absorbed decode's latent scores
summed in int32 over the ranks) and its MoE layers with the routed
experts split over ``model`` and the batch routed globally over the data
ranks (``moe.routing_global``).  Every integer result and cache leaf is
the one-card step's bit for bit, and every rank returns the whole batch's
logits, as the reference's ``out_shardings=(None, ...)`` does.  What the
step does not compute, ``sharding.serve_mesh_refusal`` refuses.  As in the
reference, ``ServeEngine`` and ``serve_sequential`` take no mesh.

``ServeEngine`` keeps a fixed packed decode batch of ``batch_slots`` rows.
An admitted request is prefilled alone at its exact prompt length (batch
1), copied into a free slot with ``model_zoo.cache_insert`` while the other
slots keep decoding, and its slot is reset and refilled as soon as it
finishes.  ``serve_sequential`` is the one-request-at-a-time oracle.

Numerical contract: activation quantization is per token and cache state
per row, so a request's tokens do not depend on which requests share its
batch -- the engine must equal ``serve_sequential`` token for token.
Sampling uses the host numpy stream ``default_rng([seed, rid])``, as in
the reference.

A model with an encoder stack (whisper) serves through ``make_prefill``
(with its ``frontend``) and ``make_decode_step``; ``ServeEngine`` refuses
it, as the reference's does.  A patch-stub model (internvl2) goes through
the engine text only.

Measured dispatch (``backend="auto"``, ``core/dispatch.py``): a compiled
step resolves every autotune key in the eager warm-up run that precedes its
capture, so the captured graph holds the chosen kernels and a capture never
times (a key that misses while capturing raises).  ``ServeEngine(
autotune_cache_path=)`` loads the process-wide autotune cache at start and
saves it after each ``run``.

Fault tolerance (the reference's policy, ``runtime/faults.py`` injecting
failures deterministically): deadlines, in-place tick retries with
backoff, NaN containment to one request, backend demotion with a new
capture of the decode step, and snapshots through
``checkpoint/manager.py`` from which :meth:`ServeEngine.resume` finishes a
run in a new process.  Unlike the reference's, the port's decode step
writes the engine's cache in place; ``ServeEngine``'s docstring says what
that changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manager as CM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import backend_registry, dispatch, tree
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model_zoo as Z
from repro_torch.models import tensor_parallel as TP
from repro_torch.runtime.faults import BackendFault, FaultInjector, InjectedFault, parse_fault_plan

__all__ = [
    "serving_params_shardings",
    "make_prefill",
    "make_decode_step",
    "CompiledStep",
    "MeshStep",
    "whole_copies",
    "Request",
    "ServeEngine",
    "serve_sequential",
    "STATE_PENDING",
    "STATE_OK",
    "STATE_FAILED",
    "STATE_DEADLINE",
    "TERMINAL_STATES",
]


def serving_params_shardings(cfg: ArchConfig, mesh):
    """(shardings, template): ``runtime/sharding.py``'s rules (no FSDP) on
    the serving params of ``cfg``, a ``meta`` tree of their shapes."""
    from repro_torch.runtime import sharding as SH

    tmpl = Z.prepare_serving_params(Z.init_params(0, cfg, device="meta"), cfg)
    return SH.params_shardings(tmpl, mesh, cfg), tmpl


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """Append the tensors of a tree of dicts, lists and tuples to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


class CompiledStep:
    """A fixed-shape serving step ``fn(params, tokens, cache) -> (logits,
    cache)``, replayed as one CUDA graph: the port's counterpart of
    ``jax.jit`` on the reference's step.  The cache is updated in place and
    returned.

    On CUDA the first call runs the step eagerly on a side stream -- that
    run is the call's result, and it does what must happen outside a
    capture: each kernel's once-per-device setup and the step's constants
    (``core/constants.py``) -- then captures the step on the same stream,
    its tokens read from a static buffer.  Later calls copy their tokens
    into that buffer and replay; the logits come back as a fresh tensor, so
    the next replay does not overwrite what the caller holds.  A call whose
    params or cache tensors differ from the captured ones (address, shape
    or dtype) captures anew: a replay would read the old ones.  The step
    holds the captured tensors, so their memory stays valid.  A failed
    capture raises; nothing falls back to eager on CUDA.  On the CPU, which
    has no graphs, every call runs the step eagerly.

    A step built with ``frontend_shape`` (``make_prefill`` of a model with
    a frontend) takes ``fn(params, tokens, cache, frontend)``: the frontend
    must have that shape, and after a capture the captured buffer's dtype;
    each replay copies it into that buffer, as it does the tokens.

    ``mode`` is ``"graph"`` on CUDA and ``"eager"`` on the CPU, or where
    the step's collectives are host calls a graph cannot record (a
    ``MeshStep`` over gloo groups, decided when the step is made): then
    every call runs the step as it is.

    ``graph`` is the captured ``torch.cuda.CUDAGraph`` (None before the
    first capture, and in ``"eager"`` mode).  ``captures`` / ``replays`` count the
    calls of each kind.  A capturing call goes through the kernel wrappers
    twice (the warm-up run, then the capture, which records each launch
    once); a replay does not call them.  The warm-up run is also where
    every ``"auto"`` dispatch of the step is resolved (timed on a miss), so
    the capture only reads the autotune cache.
    """

    def __init__(self, step: Callable, cfg: ArchConfig, tokens_shape: Tuple[int, ...],
                 cache_rows: Tuple[int, int], device="cuda",
                 frontend_shape: Optional[Tuple[int, ...]] = None, eager: bool = False):
        self._step = step
        self.cfg = cfg
        self.tokens_shape = tuple(tokens_shape)
        self.frontend_shape = None if frontend_shape is None else tuple(frontend_shape)
        self.cache_rows = tuple(cache_rows)
        batch, max_len = self.cache_rows
        # each layer's own rows: a ring layer holds its window, not max_len
        self._layer_rows = [(batch, rows) for rows in Z.cache_rows(max_len, cfg)]
        self.device = torch.device(device)
        self.mode = "graph" if self.device.type == "cuda" and not eager else "eager"
        self.captures = 0
        self.replays = 0
        self.graph = None
        self._held: List[torch.Tensor] = []  # what the graph reads, and their addresses
        self._ptrs: List[int] = []
        self._tokens = self._frontend = self._out = self._stream = None

    def _check(self, tokens: torch.Tensor, cache: dict, frontend) -> None:
        if tuple(tokens.shape) != self.tokens_shape:
            raise ValueError(f"tokens of shape {tuple(tokens.shape)}, step takes {self.tokens_shape}")
        if (frontend is None) != (self.frontend_shape is None):
            raise ValueError(f"step takes a frontend of shape {self.frontend_shape}, got "
                             f"{None if frontend is None else tuple(frontend.shape)}")
        if frontend is not None:
            if tuple(frontend.shape) != self.frontend_shape:
                raise ValueError(f"frontend of shape {tuple(frontend.shape)}, step takes {self.frontend_shape}")
            if self._frontend is not None and frontend.dtype != self._frontend.dtype:
                raise ValueError(f"frontend of dtype {frontend.dtype}, step captured {self._frontend.dtype}")
        got = Z.cache_geometry(cache)
        if got != self._layer_rows:
            raise ValueError(f"cache layers of (batch, rows) {got}, step takes (batch, max_len) "
                             f"{self.cache_rows}: {self._layer_rows}")

    def __call__(self, params: dict, tokens, cache: dict, frontend=None):
        tokens = torch.as_tensor(tokens)
        self._check(tokens, cache, frontend)
        if self.mode == "eager":
            extra = () if frontend is None else (frontend.to(self.device),)
            return self._step(params, tokens.to(self.device), self.cfg, cache, *extra)
        if not self.captured_on(params, cache):
            return self._capture(params, tokens, cache, frontend)
        self._tokens.copy_(tokens)
        if frontend is not None:
            self._frontend.copy_(frontend)
        self.graph.replay()
        self.replays += 1
        return self._out.clone(), cache

    def captured_on(self, params: dict, cache: dict) -> bool:
        """Whether a graph is captured and ``params`` and ``cache`` are the
        tensors it reads: the same addresses, and each the same tensor or one
        of the same shape and dtype."""
        if self.graph is None:
            return False
        leaves = _leaves((params, cache), [])
        if len(leaves) != len(self._held) or [t.data_ptr() for t in leaves] != self._ptrs:
            return False
        return all(map(operator.is_, leaves, self._held)) or all(
            a.shape == b.shape and a.dtype == b.dtype for a, b in zip(leaves, self._held)
        )

    def _capture(self, params, tokens, cache, frontend):
        dev = self.device
        self.graph = self._out = None  # the old graph's memory pool goes first
        self._held, self._ptrs = [], []
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self._tokens = torch.empty(self.tokens_shape, dtype=torch.int64, device=dev)
        self._tokens.copy_(tokens)
        extra = ()
        if frontend is not None:
            self._frontend = torch.empty(self.frontend_shape, dtype=frontend.dtype, device=dev)
            self._frontend.copy_(frontend)
            extra = (self._frontend,)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            logits, _ = self._step(params, self._tokens, self.cfg, cache, *extra)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            out, _ = self._step(params, self._tokens, self.cfg, cache, *extra)
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        torch.cuda.synchronize(dev)
        self.graph, self._out = graph, out
        self._held = _leaves((params, cache), [])
        self._ptrs = [t.data_ptr() for t in self._held]
        self.captures += 1
        return logits, cache


class _GroupComm:
    """A mesh's collectives by axis name (``runtime/collectives.py`` over
    ``DeviceMesh.get_group``)."""

    def __init__(self, mesh):
        self.groups = {a: mesh.get_group(a) for a in mesh.mesh_dim_names}

    def all_reduce(self, t: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        from repro_torch.runtime import collectives as C

        return C.all_reduce(t, op, group=self.groups[axis])

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        from repro_torch.runtime import collectives as C

        return C.all_gather(t, group=self.groups[axis])


def _gloo(mesh) -> bool:
    """Whether any of a ``DeviceMesh``'s axes runs over gloo."""
    import torch.distributed as dist

    return any(dist.get_backend(mesh.get_group(a)) == "gloo" for a in mesh.mesh_dim_names)


class MeshStep(CompiledStep):
    """A serving step ``fn(params, tokens, cache) -> (logits, cache)`` over
    a ``(data, model)`` mesh (``launch/mesh.py::make_host_mesh``; a ``pod``
    axis is more data ranks): ``params`` and ``cache`` are this rank's
    shards (``shard_params``, ``shard_cache``, ``init_cache``), ``tokens``
    the whole batch, of which the rank takes its data index's rows; the
    logits come back whole on every rank.

    Inside, ``step`` (``model_zoo.prefill`` or ``decode_step``) runs on a
    rank's config (``tensor_parallel.local_config``) within
    ``tensor_parallel.sharded``.  The cache leaves that the rules hold
    whole on every data rank (the per-row affines and cursors, spec
    ``()``) are handed to it as views of the rank's rows, and after the
    forward the rows every rank wrote are gathered back into them (one
    all-gather a step), so each rank's copy stays whole.  The step's
    collectives: ``comm`` (the mesh's process groups by default; the
    dry-run passes a counting stand-in on an abstract mesh with
    ``coords``).  An MoE model over more than one data rank routes the
    global batch (``moe.routing_global`` over the data axes: the ``(n, E)``
    counts and the expert buffer gathered), as the reference's SPMD step
    does, and runs its model rank's experts.  On NCCL groups it is
    captured as a CUDA graph with its collectives; on gloo groups it runs
    eagerly (``mode``), as gloo's collectives are host calls.  A config or mesh that
    ``sharding.serve_mesh_refusal`` names raises ``NotImplementedError``."""

    def __init__(self, step: Callable, cfg: ArchConfig, mesh, batch: int, max_len: int,
                 tokens_shape: Tuple[int, ...], device="cuda", comm=None, coords=None):
        from repro_torch.runtime import sharding as SH

        reason = SH.serve_mesh_refusal(cfg, mesh, batch)
        if reason is not None:
            raise NotImplementedError(reason)
        sizes = SH.mesh_axes(mesh)
        self.mesh = mesh
        self.coords = SH.coordinates(mesh) if coords is None else dict(coords)
        self.comm = _GroupComm(mesh) if comm is None else comm
        self.data_axes = SH.data_axes(mesh)
        r, n = 0, 1
        for a in self.data_axes:
            r, n = r * sizes[a] + self.coords[a], n * sizes[a]
        rows = slice(r * (batch // n), (r + 1) * (batch // n))
        self.model = TP.ModelParallel(self.comm, sizes.get("model", 1), self.coords.get("model", 0))
        self.local_cfg = TP.local_config(cfg, self.model.size)
        self.batch, self.max_len = batch, max_len
        tmpl = Z.init_cache(batch, max_len, cfg, device="meta")
        # leaves held whole over the data ranks, by path: a view of the
        # rank's rows goes in, every rank's rows are gathered back after
        # the forward
        whole = {path for (path, t), sh in zip(tree.leaves_with_paths(tmpl),
                                               tree.leaves(SH.cache_shardings(tmpl, mesh, batch, cfg)))
                 if t.ndim and t.shape[0] == batch and not SH._axes_of(sh.spec[0] if sh.spec else None)}
        bad = [t.dtype for path, t in tree.leaves_with_paths(tmpl) if path in whole and t.element_size() != 4]
        if bad:
            raise NotImplementedError(f"whole-batch cache leaves of dtypes {bad}: their rows are gathered as "
                                      "32-bit words")
        eager = not isinstance(mesh, AbstractMesh) and _gloo(mesh)
        from repro_torch.models import moe as M

        glob = None
        if cfg.moe is not None and n > 1:  # serving computes no balance loss: nothing to all-reduce
            glob = M.GlobalRouting(n=n, r=r, all_gather=lambda t: self._gather_rows(t[None]), all_reduce=None)

        def run(params, tokens, _cfg, cache, *extra):
            leaves = tree.leaves_with_paths(cache)
            mine = tree.unflatten(cache, [t[rows] if path in whole else t for path, t in leaves])
            with TP.sharded(self.model), contextlib.nullcontext() if glob is None else M.routing_global(glob):
                logits, _ = step(params, tokens[rows], self.local_cfg, mine, *extra)
            self._share_rows([t for path, t in leaves if path in whole], rows)
            return self._gather_rows(logits), cache

        super().__init__(run, cfg, tokens_shape, (batch // n, max_len), device, eager=eager)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, stacked in the batch's order
        (the first data axis major)."""
        for a in reversed(self.data_axes):
            t = self.comm.all_gather(t, a).reshape((-1,) + tuple(t.shape[1:]))
        return t

    def _share_rows(self, leaves, rows: slice) -> None:
        """Each whole-batch leaf's rows from the rank that wrote them, in
        place: one all-gather of their 32-bit words."""
        if not leaves:
            return
        mine = [t[rows].reshape(-1).view(torch.int32) for t in leaves]
        got = self._gather_rows(torch.cat(mine)[None])  # (data ranks, words)
        o = 0
        for t, m in zip(leaves, mine):
            t.copy_(got[:, o:o + m.numel()].reshape(t.shape).view(t.dtype))
            o += m.numel()

    def shard_params(self, params: dict) -> dict:
        """This rank's shards of the whole serving params (each leaf by the
        rules at its path, ``serving_params_shardings``), and the whole
        copies that ``whole_copies`` names."""
        from repro_torch.runtime import sharding as SH

        out = SH.shard_tree(params, SH.params_shardings(params, self.mesh, self.cfg), self.coords)
        for mine, extra in zip(out["layers"], whole_copies(params, self.model.size)):
            mine["attn"].update(extra)
        return out

    def shard_cache(self, cache: dict) -> dict:
        """This rank's shards of a whole ``(batch, max_len)`` cache
        (``cache_shardings``)."""
        from repro_torch.runtime import sharding as SH

        return SH.shard_tree(cache, SH.cache_shardings(cache, self.mesh, self.batch, self.cfg), self.coords)

    def init_cache(self, device=None) -> dict:
        """This rank's shards of an empty cache, made at their own shapes
        (an MLA layer's ``ckv`` ``(B/d, T, R/m)``, its ``k_rope`` ``(B/d,
        T, dr)``): the whole cache is never built.  Each leaf's fill (zeros,
        or an affine's ones) is read from a one-row cache on the host."""
        dev = self.device if device is None else device
        shards = self.shard_cache(Z.init_cache(self.batch, self.max_len, self.cfg, device="meta"))
        fills = [t.reshape(-1)[0].item() for t in tree.leaves(Z.init_cache(1, 1, self.cfg, device="cpu"))]
        return tree.unflatten(shards, [torch.full(t.shape, f, dtype=t.dtype, device=dev)
                                       for t, f in zip(tree.leaves(shards), fills)])


def whole_copies(params: dict, model_size: int) -> list:
    """Each layer's leaves that a rank over ``model_size`` model ranks holds
    whole beside its shards: over more than one, an MLA layer's packed
    ``k_up`` / ``v_up`` as ``w_uk`` / ``w_uv`` (its attention's own).  The
    absorbed decode folds every head's query and context through them
    (``attention.mla_attention``): cuBLAS sums those float32 products over
    a rank's heads alone in another order at some shapes (ROADMAP section
    3).  ``launch/dryrun.py::argument_bytes`` counts them."""
    copies = []
    for layer in params["layers"]:
        attn = layer.get("attn", {})
        mla = model_size > 1 and "kv_down" in attn
        copies.append({"w_uk": attn["k_up"], "w_uv": attn["v_up"]} if mla else {})
    return copies


def make_prefill(cfg: ArchConfig, batch: int, prompt_len: int, max_len: int,
                 device="cuda", mesh=None) -> CompiledStep:
    """``fn(params, tokens (batch, prompt_len), cache) -> (logits, cache)``:
    ``model_zoo.prefill`` from an empty ``(batch, max_len)`` cache, captured
    once and replayed.  To replay, pass the same cache again, reset
    (``model_zoo.cache_reset``).  A model with a frontend (``cfg.encoder``)
    takes ``fn(params, tokens, cache, frontend)``, the frontend of shape
    ``(batch, n_positions, d_input or d_model)``.  With ``mesh`` a
    ``MeshStep`` over its ranks."""
    Z.check_max_len(cfg, max_len)
    if mesh is not None:
        return MeshStep(Z.prefill, cfg, mesh, batch, max_len, (batch, prompt_len), device)
    enc = cfg.encoder
    frontend = None if enc is None else (batch, enc.n_positions, enc.d_input or cfg.d_model)
    return CompiledStep(Z.prefill, cfg, (batch, prompt_len), (batch, max_len), device, frontend)


def make_decode_step(cfg: ArchConfig, batch: int, max_len: int, device="cuda", mesh=None) -> CompiledStep:
    """``fn(params, tokens (batch,), cache) -> (logits, cache)``:
    ``model_zoo.decode_step`` over a ``(batch, max_len)`` cache, captured
    once and replayed.  With ``mesh`` a ``MeshStep`` over its ranks."""
    Z.check_max_len(cfg, max_len)
    if mesh is not None:
        return MeshStep(Z.decode_step, cfg, mesh, batch, max_len, (batch,), device)
    return CompiledStep(Z.decode_step, cfg, (batch,), (batch, max_len), device)


#: Request states (``Request.state``); the last three are terminal.
STATE_PENDING = "pending"
STATE_OK = "ok"
STATE_FAILED = "failed"
STATE_DEADLINE = "deadline"
TERMINAL_STATES = (STATE_OK, STATE_FAILED, STATE_DEADLINE)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (prompt_len,) int
    max_new_tokens: int = 32
    temperature: float = 0.0
    # open-loop traffic: seconds from run start before the request exists
    arrival_s: float = 0.0
    # optional deadline, seconds from arrival: past it the request ends
    # "deadline", whether queued or generating, and frees its slot
    deadline_s: Optional[float] = None
    # streaming callback; a re-admitted request streams its replayed tokens
    # again (consumers that must not deliver twice key on ``retries``)
    on_token: Optional[Callable[[int], None]] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    rid: Optional[int] = None
    state: str = STATE_PENDING
    retries: int = 0  # re-admissions after failures
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    token_times: Optional[List[float]] = None


def _sample(logits: np.ndarray, temperature: float, rng: np.random.Generator) -> int:
    """Greedy at T <= 0, else softmax sampling on the request's own stream."""
    if temperature <= 0:
        return int(np.argmax(logits))
    z = logits.astype(np.float64) / temperature
    z = z - z.max()
    p = np.exp(z)
    p = p / p.sum()
    return int(rng.choice(len(p), p=p))


def _request_rng(seed: int, rid: int) -> np.random.Generator:
    return np.random.default_rng([seed, rid])


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.detach().to("cpu", torch.float32).numpy()


@dataclasses.dataclass
class _Slot:
    req: Request
    remaining: int
    rng: np.random.Generator


@dataclasses.dataclass
class _EngineState:
    """What ``_serve`` advances besides the engine's own cache, and with it
    what a snapshot holds.  ``requests`` is every request in rid order;
    ``queue`` and ``slots`` refer into it.  ``cur`` is each row's next input
    token; ``tick`` counts successful decode ticks (a retried tick does not
    advance it), ``snaps`` snapshot attempts."""

    requests: List[Request]
    queue: List[Request]
    slots: List[Optional[_Slot]]
    cur: np.ndarray
    tick: int = 0
    snaps: int = 0


def _pack_rng_state(rng: np.random.Generator) -> Dict:
    """PCG64 state as JSON-able strings (the 128-bit ints overflow)."""
    st = rng.bit_generator.state
    return {
        "bit_generator": st["bit_generator"],
        "state": str(st["state"]["state"]),
        "inc": str(st["state"]["inc"]),
        "has_uint32": int(st["has_uint32"]),
        "uinteger": int(st["uinteger"]),
    }


def _unpack_rng_state(d: Dict) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = {
        "bit_generator": d["bit_generator"],
        "state": {"state": int(d["state"]), "inc": int(d["inc"])},
        "has_uint32": int(d["has_uint32"]),
        "uinteger": int(d["uinteger"]),
    }
    return rng


def _device_error(e: BaseException) -> bool:
    """An error of the device (a kernel's launch, or an asynchronous fault
    surfacing at a sync).  It may leave the CUDA context unusable, so no
    retry in this process can succeed: the engine re-raises it, and
    recovery is :meth:`ServeEngine.resume` in a new process."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and not isinstance(e, InjectedFault) and "CUDA" in str(e)


class ServeEngine:
    """Slot-managed continuous batching with a fault-tolerant control loop.

    Each tick: (1) expire -- queued requests past their ``deadline_s`` end
    "deadline"; (2) admit -- while a slot is free and the head of the
    arrival-ordered queue has arrived, prefill it eagerly at its exact
    length and insert it into the free slot; (3) decode -- one packed
    decode step over all slots, through ``decode_fn``
    (:func:`make_decode_step`: the first tick captures it, later ticks
    replay it); active slots sample and stream their token, and a slot
    whose budget is spent is reset and freed; running requests past their
    deadline end "deadline" and free their slots; (4) snapshot -- every
    ``snapshot_every`` ticks the engine's state goes through
    ``CheckpointManager``, so :meth:`resume` can finish the run after a
    crash.  The packed cache lives as long as the engine and is written in
    place, so ``run`` after ``run`` replays the same graph.

    Failure policy (the reference's):

    * A failed decode tick is retried in place with exponential backoff, up
      to ``max_retries`` times.  The step writes the cache in place, so a
      retry is exact only while the failed attempt left the cache as it
      was: an injected fault fires before the replay and NaN corruption
      acts on the host copy of the logits.  A failure that moved the
      cache's cursors (one raised inside the step) loses the tick: every
      request of the batch is re-admitted, and every row reset.
    * A device error (``torch.AcceleratorError``, or a ``RuntimeError``
      naming CUDA) is re-raised at once, from decode, prefill or snapshot
      alike: the context it poisons cannot retry it.
    * A :class:`~repro_torch.runtime.faults.BackendFault` counts against
      the named backend; ``demote_after`` of them pin a process-wide
      demotion (``dispatch.pin_demotion``) to ``demote_to``, and the decode
      step is built anew (the captured graph holds the old backend's
      kernels; the old step and its graph pool are dropped before the new
      capture).  On the card ``demote_to`` must be a hand-written kernel
      (``pallas`` or ``fused``, default ``pallas``); on the CPU it
      defaults to the reference's ``mxu``.
    * Non-finite logits fail the one request in that row: it is re-admitted
      from its prompt under the same ``(seed, rid)`` stream, so its replay
      is token for token an unfailed run; past ``max_retries``
      re-admissions it ends "failed".
    * A failed snapshot write is an event: serving goes on.

    A free row's cursor still advances every tick; before it passes
    ``max_len`` the row is reset (a global layer has ``max_len`` rows).

    ``last_events`` keeps the event trace of the last ``run`` / ``resume``
    (kinds admit/prefill/insert/decode_tick/finish/reset, step_fault/
    retry_tick/backend_fault/demote/nan_logits/requeue/request_failed/
    prefill_fault/deadline_miss/snapshot/snapshot_failed/resume, and the
    port's own compile: a tick that captured the decode step), each
    stamped ``t`` in seconds from the start of the run.  prefill, compile
    and decode_tick also carry ``ms``, the host time of that step,
    synchronised with the device (a tick's ends before its logits are
    copied to the host); snapshot and resume carry the ``ms`` of the write
    and of the restore.

    ``autotune_cache_path``: a JSON file of the autotune cache
    (``core/dispatch.py``), loaded into the process-wide cache when the
    engine starts and written back at the end of each ``run`` /
    ``resume``; it defaults to ``$REPRO_QMM_AUTOTUNE_CACHE`` where that is
    set.  ``fault_plan``: a :class:`~repro_torch.runtime.faults.FaultPlan`
    (or its JSON string or dict), None for none.  ``snapshot_every`` > 0
    snapshots into ``snapshot_dir`` at that tick cadence.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params: dict,
        *,
        batch_slots: int = 4,
        max_len: int = 256,
        seed: int = 0,
        device="cuda",
        autotune_cache_path: Optional[str] = None,
        fault_plan=None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.005,
        demote_after: int = 2,
        demote_to: Optional[str] = None,
        snapshot_every: int = 0,
        snapshot_dir: Optional[str] = None,
    ):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.seed = seed
        self.device = torch.device(device)
        if cfg.encoder is not None and cfg.encoder.n_layers:
            raise NotImplementedError(
                "continuous batching drives decoder-only stacks; a model with an encoder "
                "stack goes through make_prefill / make_decode_step"
            )
        Z.check_max_len(cfg, max_len)
        got = params["embedding"].device
        if got.type != self.device.type:
            raise ValueError(f"params live on {got}, engine device is {self.device}")
        self._next_rid = 0
        self.last_events: List[Dict] = []
        if autotune_cache_path is None:
            autotune_cache_path = os.environ.get(dispatch.CACHE_ENV) or None
        self.autotune_cache_path = autotune_cache_path
        if autotune_cache_path and os.path.exists(autotune_cache_path):
            dispatch.get_cache().load(autotune_cache_path)
        self.fault_plan = parse_fault_plan(fault_plan)
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.demote_after = demote_after
        self.demote_to = self._check_demote_to(demote_to)
        self.snapshot_every = snapshot_every
        self.snapshot_dir = snapshot_dir
        self._backend_failures: Dict[str, int] = {}
        self._demoted: Dict[str, str] = {}
        self.decode_fn = make_decode_step(cfg, batch_slots, max_len, device=self.device)
        self._cache = Z.init_cache(batch_slots, max_len, cfg, device=self.device)
        # host mirror of each row's cursor: a free row still advances every tick
        self._pos = [0] * batch_slots

    def _check_demote_to(self, name: Optional[str]) -> str:
        """The demotion target: a qmm backend, on the card a hand-written one."""
        on_card = self.device.type == "cuda"
        if name is None:
            name = "pallas" if on_card else dispatch.DEFAULT_BACKEND
        spec = backend_registry.get_backend(name)
        if "qmm" not in spec.families:
            raise ValueError(f"demote_to={name!r} serves no qmm family")
        if on_card and not spec.cuda_kernel:
            kernels = [n for n in backend_registry.backend_names("qmm")
                       if backend_registry.get_backend(n).cuda_kernel]
            raise ValueError(f"demote_to={name!r} is a plain PyTorch core; on the card an engine "
                             f"demotes only to a hand-written kernel: {kernels}")
        return name

    # -- internals ----------------------------------------------------------

    def _event(self, kind: str, **kw) -> None:
        self.last_events.append(dict(kind=kind, t=self._clock(), **kw))

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self, req: Request, slot: int) -> np.ndarray:
        """Exact-length batch-1 prefill, then copy into ``slot``."""
        req.t_admitted = self._clock()
        self._event("admit", rid=req.rid, slot=slot, prompt_len=len(req.prompt))
        slot_cache = Z.init_slot_cache(self.max_len, self.cfg, device=self.device)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :], device=self.device)
        t = time.perf_counter()
        logits, slot_cache = Z.prefill(self.params, tokens, self.cfg, slot_cache)
        self._sync()
        self._event("prefill", rid=req.rid, slot=slot, ms=(time.perf_counter() - t) * 1e3)
        Z.cache_insert(self._cache, slot_cache, slot)
        self._pos[slot] = len(req.prompt)
        self._event("insert", rid=req.rid, slot=slot)
        return _host(logits)[0]

    def _reset_row(self, i: int, rid: Optional[int]) -> None:
        Z.cache_reset(self._cache, i, self.cfg, self.max_len)
        self._pos[i] = 0
        self._event("reset", rid=rid, slot=i)

    def _decode(self, st: _EngineState) -> np.ndarray:
        """One packed decode step over every row; the host copy of its logits."""
        captures = self.decode_fn.captures
        t = time.perf_counter()
        out, _ = self.decode_fn(self.params, torch.from_numpy(st.cur), self._cache)
        self._sync()
        ms = (time.perf_counter() - t) * 1e3
        self._pos = [p + 1 for p in self._pos]
        kind = "compile" if self.decode_fn.captures != captures else "decode_tick"
        self._event(kind, rids=[s.req.rid if s else None for s in st.slots], ms=ms)
        return _host(out)

    def _cursors_moved(self) -> bool:
        """Whether any layer's cursors differ from the host's: a failed
        step got far enough to write the cache."""
        want = torch.tensor(self._pos, dtype=torch.int32)
        return any(not torch.equal(layer["pos"].to("cpu", torch.int32), want)
                   for layer in self._cache["layers"])

    def _emit(self, req: Request, token: int) -> None:
        now = self._clock()
        req.output.append(token)
        req.token_times.append(now)
        if req.t_first_token is None:
            req.t_first_token = now
        if req.on_token is not None:
            req.on_token(token)

    @staticmethod
    def _expired(req: Request, now: float) -> bool:
        return req.deadline_s is not None and now - req.arrival_s > req.deadline_s

    @staticmethod
    def _reset_progress(req: Request) -> None:
        """Rewind a request to its prompt (re-admission replays from here)."""
        req.output = []
        req.token_times = []
        req.t_admitted = req.t_first_token = req.t_finished = None

    def _requeue(self, st: _EngineState, req: Request, slot: Optional[int]) -> None:
        """Re-admit ``req`` after a failure, or fail it for good.  The slot
        it held (if any) is reset; the replay is token for token an
        unfailed run (progress rewinds to the prompt, and the next
        admission re-derives the ``(seed, rid)`` stream)."""
        now = self._clock()
        if slot is not None and st.slots[slot] is not None:
            self._reset_row(slot, req.rid)
            st.slots[slot] = None
        req.retries += 1
        if req.retries > self.max_retries:
            req.state = STATE_FAILED
            req.t_finished = now
            self._event("request_failed", rid=req.rid, retries=req.retries)
            return
        self._reset_progress(req)
        st.queue.insert(0, req)
        self._event("requeue", rid=req.rid, retries=req.retries)

    def _finish(self, st: _EngineState, i: int, state: str = STATE_OK) -> None:
        req = st.slots[i].req
        req.state = state
        req.t_finished = self._clock()
        self._event("finish" if state == STATE_OK else "deadline_miss", rid=req.rid, slot=i)
        self._reset_row(i, req.rid)
        st.slots[i] = None

    def _demotion_target(self, backend: str) -> Optional[str]:
        """Where a failing ``backend`` goes: ``demote_to``; where that is the
        failing one, the default core on the CPU and nowhere on the card
        (its default is plain PyTorch)."""
        if self.demote_to != backend:
            return self.demote_to
        return None if self.device.type == "cuda" else dispatch.DEFAULT_BACKEND

    def _note_backend_failure(self, backend: str) -> None:
        """Count a backend-attributed failure; demote the repeat offender."""
        n = self._backend_failures.get(backend, 0) + 1
        self._backend_failures[backend] = n
        self._event("backend_fault", backend=backend, count=n)
        if n < self.demote_after or backend in self._demoted:
            return
        target = self._demotion_target(backend)
        if target is None:
            return
        dispatch.pin_demotion(backend, target)
        self._demoted[backend] = target
        # the captured graph launches the demoted backend's kernels: drop it
        # and its memory pool, and capture anew at the next tick
        self.decode_fn = None
        self.decode_fn = make_decode_step(self.cfg, self.slots, self.max_len, device=self.device)
        self._event("demote", **{"from": backend, "to": target})

    # -- public API ---------------------------------------------------------

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a queue of requests; returns them in submission order, each
        in a terminal state: "ok" (full output), "deadline" (expired before
        completing) or "failed" (past its retry budget)."""
        for r in requests:
            prompt = np.asarray(r.prompt)
            if prompt.ndim != 1:
                raise ValueError(f"prompt must be rank-1, got shape {prompt.shape}")
            if len(prompt) < 1 or r.max_new_tokens < 1:
                raise ValueError("request needs a non-empty prompt and >= 1 new token")
            if len(prompt) + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"prompt_len({len(prompt)}) + max_new_tokens({r.max_new_tokens}) "
                    f"exceeds engine max_len({self.max_len})"
                )
            if r.deadline_s is not None and r.deadline_s <= 0:
                raise ValueError(f"deadline_s must be positive, got {r.deadline_s}")
        for r in requests:
            r.rid = self._next_rid
            self._next_rid += 1
            r.state = STATE_PENDING
            r.retries = 0
            self._reset_progress(r)
        self.last_events = []
        self._t0 = time.perf_counter()
        self._serve(_EngineState(
            requests=list(requests),
            queue=sorted(requests, key=lambda r: (r.arrival_s, r.rid)),
            slots=[None] * self.slots,
            cur=np.zeros((self.slots,), np.int64),
        ))
        return list(requests)

    def _serve(self, st: _EngineState) -> None:
        """Drive ``st`` to completion (``run`` and ``resume``); every
        decision of the failure policy is taken here."""
        inj = FaultInjector(self.fault_plan)
        while st.queue or any(s is not None for s in st.slots):
            # ---- deadline sweep over the waiting queue
            now = self._clock()
            for req in [r for r in st.queue if self._expired(r, now)]:
                st.queue.remove(req)
                req.state = STATE_DEADLINE
                req.t_finished = now
                self._event("deadline_miss", rid=req.rid, slot=None)

            # ---- admission: fill free slots from arrived requests
            while st.queue and st.queue[0].arrival_s <= self._clock() and None in st.slots:
                req = st.queue.pop(0)
                i = st.slots.index(None)
                try:
                    inj.before_prefill(req.rid)
                    logits = self._admit(req, i)
                except Exception as e:  # noqa: BLE001 -- contained to the request
                    if _device_error(e):
                        raise
                    if not isinstance(e, InjectedFault):
                        Z.cache_reset(self._cache, i, self.cfg, self.max_len)  # a partial insert
                        self._pos[i] = 0
                    self._event("prefill_fault", rid=req.rid, error=repr(e))
                    self._requeue(st, req, slot=None)
                    continue
                if not np.all(np.isfinite(logits)):
                    self._event("nan_logits", rid=req.rid, slot=i)
                    self._requeue(st, req, slot=None)
                    continue
                slot = _Slot(req, req.max_new_tokens, _request_rng(self.seed, req.rid))
                tok = _sample(logits, req.temperature, slot.rng)
                self._emit(req, tok)
                slot.remaining -= 1
                st.slots[i] = slot
                st.cur[i] = tok
                if slot.remaining == 0:
                    self._finish(st, i)
            if all(s is None for s in st.slots):
                if st.queue:  # open-loop gap: idle until the next arrival
                    time.sleep(max(0.0, st.queue[0].arrival_s - self._clock()))
                continue

            for i, slot in enumerate(st.slots):
                # a free row's cursor must not run past a global layer's
                # max_len rows (a ring layer's write wraps)
                if slot is None and self._pos[i] >= self.max_len:
                    self._reset_row(i, None)

            # ---- one packed decode tick over every slot, retried in place
            # on failure; a demotion resets the attempt budget (the next
            # attempt is a different step)
            logits = None
            lost = False
            attempt = 0
            while True:
                try:
                    inj.before_decode(st.tick, demoted=self._demoted)
                    logits = inj.corrupt_logits(st.tick, self._decode(st))
                    break
                except BackendFault as e:
                    demoted_before = dict(self._demoted)
                    self._note_backend_failure(e.backend)
                    if self._demoted != demoted_before:
                        attempt = 0
                        continue
                    attempt += 1
                except Exception as e:  # noqa: BLE001 -- step faults are retried
                    if _device_error(e):
                        raise
                    self._event("step_fault", tick=st.tick, error=repr(e))
                    attempt += 1
                    lost = not isinstance(e, InjectedFault) and self._cursors_moved()
                if lost or attempt > self.max_retries:
                    break
                backoff = self.retry_backoff_s * (2 ** (attempt - 1))
                self._event("retry_tick", tick=st.tick, attempt=attempt, backoff_s=backoff)
                if backoff > 0:
                    time.sleep(backoff)
            if logits is None:
                # the batch is lost, its requests are not: each replays from
                # its prompt (or fails for good once its budget is spent)
                for i in range(self.slots):
                    if st.slots[i] is not None:
                        self._requeue(st, st.slots[i].req, slot=i)
                    elif lost:
                        self._reset_row(i, None)
                continue
            st.tick += 1
            for i, slot in enumerate(st.slots):
                if slot is None:
                    continue
                row = logits[i]
                if not np.all(np.isfinite(row)):
                    # contain the numerics escape to this one request
                    self._event("nan_logits", rid=slot.req.rid, slot=i)
                    self._requeue(st, slot.req, slot=i)
                    continue
                tok = _sample(row, slot.req.temperature, slot.rng)
                self._emit(slot.req, tok)
                slot.remaining -= 1
                st.cur[i] = tok
                if slot.remaining == 0:
                    self._finish(st, i)

            # ---- deadline sweep over running slots
            now = self._clock()
            for i in range(self.slots):
                if st.slots[i] is not None and self._expired(st.slots[i].req, now):
                    self._finish(st, i, state=STATE_DEADLINE)

            # ---- periodic crash-recovery snapshot
            if self.snapshot_every and st.tick % self.snapshot_every == 0:
                try:
                    inj.on_snapshot(st.snaps)
                    t = time.perf_counter()
                    self._snapshot(st)
                    self._event("snapshot", tick=st.tick, ordinal=st.snaps,
                                ms=(time.perf_counter() - t) * 1e3)
                except Exception as e:  # noqa: BLE001 -- snapshots are best-effort
                    if _device_error(e):
                        raise
                    self._event("snapshot_failed", tick=st.tick, ordinal=st.snaps, error=repr(e))
                st.snaps += 1

        if self.autotune_cache_path:
            dispatch.get_cache().save(self.autotune_cache_path)

    # -- crash-recoverable engine state -------------------------------------

    def _snapshot_manager(self) -> CheckpointManager:
        if not self.snapshot_dir:
            raise ValueError("snapshot_dir is not configured on this engine")
        return CheckpointManager(self.snapshot_dir, keep=2)

    def _snapshot(self, st: _EngineState) -> None:
        """Persist the engine's state through ``CheckpointManager``: the
        packed cache and each row's next input token as tensors, the
        scheduler's state (queue order, slot budgets, each request's
        progress and PCG64 sampler state) in the manifest's extras.
        Committed atomically: a crash mid-write leaves the previous
        snapshot restorable."""
        tree = {"cache": self._cache, "cur": torch.from_numpy(st.cur)}
        extras = {
            "serve": {
                "arch": self.cfg.name,
                "seed": int(self.seed),
                "batch_slots": int(self.slots),
                "max_len": int(self.max_len),
                "tick": int(st.tick),
                "snaps": int(st.snaps),
                "next_rid": int(self._next_rid),
                "elapsed_s": float(self._clock()),
                "queue_rids": [int(r.rid) for r in st.queue],
                "slots": [
                    None if s is None else {
                        "rid": int(s.req.rid),
                        "remaining": int(s.remaining),
                        "rng": _pack_rng_state(s.rng),
                    }
                    for s in st.slots
                ],
                "requests": [
                    {
                        "rid": int(r.rid),
                        "prompt": [int(t) for t in np.asarray(r.prompt)],
                        "max_new_tokens": int(r.max_new_tokens),
                        "temperature": float(r.temperature),
                        "arrival_s": float(r.arrival_s),
                        "deadline_s": None if r.deadline_s is None else float(r.deadline_s),
                        "state": r.state,
                        "retries": int(r.retries),
                        "output": [int(t) for t in (r.output or [])],
                        "token_times": [float(t) for t in (r.token_times or [])],
                    }
                    for r in st.requests
                ],
            }
        }
        self._snapshot_manager().save(st.tick, tree, extras)

    def resume(self) -> List[Request]:
        """Finish the run recorded in ``snapshot_dir``'s latest snapshot.

        Checks the snapshot's geometry from its manifest before loading any
        array, copies the cache into the engine's own tensors (so a captured
        decode step replays with no new capture), rebuilds the host cursors
        from the cache's ``pos`` leaves, the queue, each slot's budget and
        sampler state, and drives the serve loop to completion: the
        surviving requests' outputs equal an uninterrupted run's token for
        token.  Returns every request of the original run in rid order,
        those finished before the snapshot included."""
        mgr = self._snapshot_manager()
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed snapshot in {self.snapshot_dir}")
        manifest = CM._read_manifest(os.path.join(self.snapshot_dir, f"step_{step:09d}"))
        s = manifest["extras"]["serve"]
        if (s["arch"], s["batch_slots"], s["max_len"]) != (self.cfg.name, self.slots, self.max_len):
            raise ValueError(
                f"snapshot geometry mismatch: snapshot is {s['arch']} "
                f"slots={s['batch_slots']} max_len={s['max_len']}, engine is "
                f"{self.cfg.name} slots={self.slots} max_len={self.max_len}"
            )
        t = time.perf_counter()
        like = {"cache": self._cache, "cur": torch.zeros((self.slots,), dtype=torch.int64)}
        step, tree, extras = mgr.restore(step, like=like)
        for dst, src in zip(_leaves(self._cache, []), _leaves(tree["cache"], [])):
            dst.copy_(src)
        self._pos = [int(p) for p in self._cache["layers"][0]["pos"].tolist()]
        self._sync()
        restore_ms = (time.perf_counter() - t) * 1e3
        s = extras["serve"]

        by_rid: Dict[int, Request] = {}
        for rec in s["requests"]:
            req = Request(
                prompt=np.asarray(rec["prompt"], np.int32),
                max_new_tokens=rec["max_new_tokens"],
                temperature=rec["temperature"],
                arrival_s=rec["arrival_s"],
                deadline_s=rec["deadline_s"],
            )
            req.rid = rec["rid"]
            req.state = rec["state"]
            req.retries = rec["retries"]
            req.output = list(rec["output"])
            req.token_times = list(rec["token_times"])
            if req.token_times:
                req.t_first_token = req.token_times[0]
            by_rid[req.rid] = req
        slots = [
            None if rec is None else _Slot(by_rid[rec["rid"]], rec["remaining"],
                                           _unpack_rng_state(rec["rng"]))
            for rec in s["slots"]
        ]
        state = _EngineState(
            requests=[by_rid[r] for r in sorted(by_rid)],
            queue=[by_rid[r] for r in s["queue_rids"]],
            slots=slots,
            cur=tree["cur"].numpy().astype(np.int64),
            tick=s["tick"],
            snaps=s["snaps"],
        )
        self._next_rid = max(self._next_rid, s["next_rid"])
        self.last_events = []
        # the run's clock goes on where it stopped, so arrivals and deadlines
        # keep their meaning across the restart
        self._t0 = time.perf_counter() - s["elapsed_s"]
        self._event("resume", tick=state.tick, step=step, ms=restore_ms)
        self._serve(state)
        return state.requests


def serve_sequential(
    cfg: ArchConfig,
    params: dict,
    requests: List[Request],
    *,
    max_len: int = 256,
    seed: int = 0,
    device="cuda",
) -> List[Request]:
    """One request at a time, batch 1, no slots, no faults, no deadlines:
    the oracle the engine is held to.  Shares ``_sample`` and the
    per-request RNG keying."""
    Z.check_max_len(cfg, max_len)
    for rid, r in enumerate(requests):
        if len(r.prompt) + r.max_new_tokens > max_len:
            raise ValueError("request exceeds max_len")
        r.rid = rid
        rng = _request_rng(seed, rid)
        cache = Z.init_cache(1, max_len, cfg, device=device)
        tokens = torch.as_tensor(np.asarray(r.prompt, np.int64)[None, :], device=device)
        logits, cache = Z.prefill(params, tokens, cfg, cache)
        tok = _sample(_host(logits)[0], r.temperature, rng)
        r.output = [tok]
        while len(r.output) < r.max_new_tokens:
            step = torch.tensor([tok], dtype=torch.int64, device=device)
            logits, cache = Z.decode_step(params, step, cfg, cache)
            tok = _sample(_host(logits)[0], r.temperature, rng)
            r.output.append(tok)
        r.state = STATE_OK
    return list(requests)
