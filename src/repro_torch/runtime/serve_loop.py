"""Continuous-batching serving engine (port of ``repro.runtime.serve_loop``).

* ``make_prefill`` / ``make_decode_step`` -- the fixed-shape steps, captured
  once as CUDA graphs and replayed (the counterparts of the reference's
  ``jax.jit`` steps; one card, so no mesh);
* ``ServeEngine`` -- continuous batching over a replayed decode step;
* ``serve_sequential`` -- the eager one-request-at-a-time oracle.

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

Not ported yet: fault injection, deadlines and retries, snapshots and
``resume``, and the engine's degradation policy (``dispatch.pin_demotion``
is ported; a demotion changes the kernels a step launches, so the policy
will have to capture the step anew, as the reference rebuilds its jit
wrapper).
"""

from __future__ import annotations

import dataclasses
import operator
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.models import model_zoo as Z

__all__ = [
    "make_prefill",
    "make_decode_step",
    "CompiledStep",
    "Request",
    "ServeEngine",
    "serve_sequential",
    "STATE_PENDING",
    "STATE_OK",
]


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

    ``graph`` is the captured ``torch.cuda.CUDAGraph`` (None before the
    first capture, and on the CPU).  ``captures`` / ``replays`` count the
    calls of each kind.  A capturing call goes through the kernel wrappers
    twice (the warm-up run, then the capture, which records each launch
    once); a replay does not call them.  The warm-up run is also where
    every ``"auto"`` dispatch of the step is resolved (timed on a miss), so
    the capture only reads the autotune cache.
    """

    def __init__(self, step: Callable, cfg: ArchConfig, tokens_shape: Tuple[int, ...],
                 cache_rows: Tuple[int, int], device="cuda",
                 frontend_shape: Optional[Tuple[int, ...]] = None):
        self._step = step
        self.cfg = cfg
        self.tokens_shape = tuple(tokens_shape)
        self.frontend_shape = None if frontend_shape is None else tuple(frontend_shape)
        self.cache_rows = tuple(cache_rows)
        batch, max_len = self.cache_rows
        # each layer's own rows: a ring layer holds its window, not max_len
        self._layer_rows = [(batch, rows) for rows in Z.cache_rows(max_len, cfg)]
        self.device = torch.device(device)
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
        if self.device.type != "cuda":
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


def make_prefill(cfg: ArchConfig, batch: int, prompt_len: int, max_len: int,
                 device="cuda") -> CompiledStep:
    """``fn(params, tokens (batch, prompt_len), cache) -> (logits, cache)``:
    ``model_zoo.prefill`` from an empty ``(batch, max_len)`` cache, captured
    once and replayed.  To replay, pass the same cache again, reset
    (``model_zoo.cache_reset``).  A model with a frontend (``cfg.encoder``)
    takes ``fn(params, tokens, cache, frontend)``, the frontend of shape
    ``(batch, n_positions, d_input or d_model)``."""
    Z.check_max_len(cfg, max_len)
    enc = cfg.encoder
    frontend = None if enc is None else (batch, enc.n_positions, enc.d_input or cfg.d_model)
    return CompiledStep(Z.prefill, cfg, (batch, prompt_len), (batch, max_len), device, frontend)


def make_decode_step(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> CompiledStep:
    """``fn(params, tokens (batch,), cache) -> (logits, cache)``:
    ``model_zoo.decode_step`` over a ``(batch, max_len)`` cache, captured
    once and replayed."""
    Z.check_max_len(cfg, max_len)
    return CompiledStep(Z.decode_step, cfg, (batch,), (batch, max_len), device)


STATE_PENDING = "pending"
STATE_OK = "ok"


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (prompt_len,) int
    max_new_tokens: int = 32
    temperature: float = 0.0
    # open-loop traffic: seconds from run start before the request exists
    arrival_s: float = 0.0
    on_token: Optional[Callable[[int], None]] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    rid: Optional[int] = None
    state: str = STATE_PENDING
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


class ServeEngine:
    """Slot-managed continuous batching over the port's serving datapath.

    Each tick: (1) admit -- while a slot is free and the head of the
    arrival-ordered queue has arrived, prefill it eagerly at its exact
    length and insert it into the free slot; (2) decode -- one packed
    decode step over all slots, through ``decode_fn``
    (:func:`make_decode_step`, built once per engine: the first tick
    captures it, later ticks replay it); active slots sample and stream
    their token, and a slot whose budget is spent is reset and freed.  The
    packed cache lives as long as the engine, so ``run`` after ``run``
    replays the same graph.

    ``last_events`` keeps the event trace of the last ``run`` (kinds
    admit/prefill/insert/compile/decode_tick/finish/reset, each stamped
    ``t`` in seconds from the start of the run).  prefill, compile (a tick
    that captured the decode step) and decode_tick (a replayed tick, or an
    eager one on the CPU) also carry ``ms``, the host time of that step,
    synchronised with the device; a tick's ``ms`` ends before its logits
    are copied to the host.

    ``autotune_cache_path``: a JSON file of the autotune cache
    (``core/dispatch.py``), loaded into the process-wide cache when the
    engine starts (a warm process then times nothing) and written back at
    the end of each ``run``; meaningful where the config uses ``"auto"`` or
    engages bitwise attention with ``"binary"``.  It defaults to
    ``$REPRO_QMM_AUTOTUNE_CACHE`` where that is set.
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
        self.decode_fn = make_decode_step(cfg, batch_slots, max_len, device=self.device)
        self._cache = Z.init_cache(batch_slots, max_len, cfg, device=self.device)
        # host mirror of each row's cursor: a free row still advances every tick
        self._pos = [0] * batch_slots

    def _event(self, kind: str, **kw) -> None:
        self.last_events.append(dict(kind=kind, t=self._clock(), **kw))

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self, req: Request, slot: int, cache: dict) -> np.ndarray:
        """Exact-length batch-1 prefill, then copy into ``slot``."""
        req.t_admitted = self._clock()
        self._event("admit", rid=req.rid, slot=slot, prompt_len=len(req.prompt))
        slot_cache = Z.init_slot_cache(self.max_len, self.cfg, device=self.device)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :], device=self.device)
        t = time.perf_counter()
        logits, slot_cache = Z.prefill(self.params, tokens, self.cfg, slot_cache)
        self._sync()
        self._event("prefill", rid=req.rid, slot=slot, ms=(time.perf_counter() - t) * 1e3)
        Z.cache_insert(cache, slot_cache, slot)
        self._pos[slot] = len(req.prompt)
        self._event("insert", rid=req.rid, slot=slot)
        return _host(logits)[0]

    def _emit(self, req: Request, token: int) -> None:
        now = self._clock()
        req.output.append(token)
        req.token_times.append(now)
        if req.t_first_token is None:
            req.t_first_token = now
        if req.on_token is not None:
            req.on_token(token)

    def _finish(self, slots: List[Optional[_Slot]], cache: dict, i: int) -> None:
        req = slots[i].req
        req.state = STATE_OK
        req.t_finished = self._clock()
        self._event("finish", rid=req.rid, slot=i)
        Z.cache_reset(cache, i, self.cfg, self.max_len)
        self._pos[i] = 0
        self._event("reset", rid=req.rid, slot=i)
        slots[i] = None

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a queue of requests; returns them in submission order."""
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
        for r in requests:
            r.rid = self._next_rid
            self._next_rid += 1
            r.state = STATE_PENDING
            r.output, r.token_times = [], []
            r.t_admitted = r.t_first_token = r.t_finished = None
        self.last_events = []
        self._t0 = time.perf_counter()
        self._serve(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        if self.autotune_cache_path:
            dispatch.get_cache().save(self.autotune_cache_path)
        return list(requests)

    def _serve(self, queue: List[Request]) -> None:
        slots: List[Optional[_Slot]] = [None] * self.slots
        cache = self._cache
        cur = np.zeros((self.slots,), np.int64)
        while queue or any(s is not None for s in slots):
            while queue and queue[0].arrival_s <= self._clock() and None in slots:
                req = queue.pop(0)
                i = slots.index(None)
                logits = self._admit(req, i, cache)
                slot = _Slot(req, req.max_new_tokens, _request_rng(self.seed, req.rid))
                tok = _sample(logits, req.temperature, slot.rng)
                self._emit(req, tok)
                slot.remaining -= 1
                slots[i] = slot
                cur[i] = tok
                if slot.remaining == 0:
                    self._finish(slots, cache, i)
            if all(s is None for s in slots):
                if queue:  # open-loop gap: idle until the next arrival
                    time.sleep(max(0.0, queue[0].arrival_s - self._clock()))
                continue

            for i, slot in enumerate(slots):
                # a free row's cursor must not run past a global layer's
                # max_len rows (a ring layer's write wraps)
                if slot is None and self._pos[i] >= self.max_len:
                    Z.cache_reset(cache, i, self.cfg, self.max_len)
                    self._pos[i] = 0
                    self._event("reset", rid=None, slot=i)
            captures = self.decode_fn.captures
            t = time.perf_counter()
            out, _ = self.decode_fn(self.params, torch.from_numpy(cur), cache)
            self._sync()
            ms = (time.perf_counter() - t) * 1e3
            self._pos = [p + 1 for p in self._pos]
            logits = _host(out)
            kind = "compile" if self.decode_fn.captures != captures else "decode_tick"
            self._event(kind, rids=[s.req.rid if s else None for s in slots], ms=ms)
            for i, slot in enumerate(slots):
                if slot is None:
                    continue
                tok = _sample(logits[i], slot.req.temperature, slot.rng)
                self._emit(slot.req, tok)
                slot.remaining -= 1
                cur[i] = tok
                if slot.remaining == 0:
                    self._finish(slots, cache, i)


def serve_sequential(
    cfg: ArchConfig,
    params: dict,
    requests: List[Request],
    *,
    max_len: int = 256,
    seed: int = 0,
    device="cuda",
) -> List[Request]:
    """One request at a time, batch 1, no slots: the oracle the engine is
    held to.  Shares ``_sample`` and the per-request RNG keying."""
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
