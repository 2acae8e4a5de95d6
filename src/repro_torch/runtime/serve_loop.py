"""Continuous-batching serving engine (port of ``repro.runtime.serve_loop``).

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

Not ported yet: fault injection, deadlines and retries, snapshots and
``resume``, backend demotion and autotuned dispatch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo as Z

__all__ = ["Request", "ServeEngine", "serve_sequential", "STATE_PENDING", "STATE_OK"]

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
    arrival-ordered queue has arrived, prefill it at its exact length and
    insert it into the free slot; (2) decode -- one packed ``decode_step``
    over all slots; active slots sample and stream their token, and a slot
    whose budget is spent is reset and freed.

    ``last_events`` keeps the event trace of the last ``run`` (kinds
    admit/prefill/insert/decode_tick/finish/reset, each stamped ``t`` in
    seconds from the start of the run; prefill and decode_tick also carry
    ``ms``, the host time of that step, synchronised with the device).
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
    ):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.seed = seed
        self.device = torch.device(device)
        Z.check_max_len(cfg, max_len)
        got = params["embedding"].device
        if got.type != self.device.type:
            raise ValueError(f"params live on {got}, engine device is {self.device}")
        self._next_rid = 0
        self.last_events: List[Dict] = []

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
        return list(requests)

    def _serve(self, queue: List[Request]) -> None:
        slots: List[Optional[_Slot]] = [None] * self.slots
        cache = Z.init_cache(self.slots, self.max_len, self.cfg, device=self.device)
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

            t = time.perf_counter()
            out, _ = Z.decode_step(
                self.params, torch.as_tensor(cur, device=self.device), self.cfg, cache
            )
            logits = _host(out)
            self._event(
                "decode_tick",
                rids=[s.req.rid if s else None for s in slots],
                ms=(time.perf_counter() - t) * 1e3,
            )
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
