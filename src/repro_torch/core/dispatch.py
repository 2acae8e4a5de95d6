"""Measured QMM backend dispatch (port of ``repro.core.dispatch``).

Which integer backend is fastest depends on ``(M, K, N)``, the operand
precisions and the device, so ``backend="auto"`` is measured, not fixed.
:class:`AutotuneCache`:

* keys a problem on ``(M, K, N, act_bits, weight_bits, candidate set,
  phase tag, family)``, M rounded up to a power of two (at least 8) so
  ragged prompt lengths share entries;
* on a first miss times every candidate on synthetic operands of the key's
  shape and precision, made on the device of the call, and records the
  winner (the minimum of ``reps`` runs, since contention only ever adds
  time).  On a card a run is the replay of a CUDA graph of 16
  back-to-back calls, timed by CUDA events: device time, what a replayed
  serving step pays, without the host's launch gaps.  On the CPU it is one
  call on the host clock;
* on a card takes only the hand-written kernels as candidates
  (``QMMBackend.cuda_kernel``), and a candidate that fails to build or
  launch there raises: nothing falls back to a plain PyTorch core.  On the
  CPU, as in the reference, a failing candidate just loses;
* serves later lookups from the cache, and never times while a CUDA graph
  is being captured: a miss then raises, naming the key (the compiled steps
  resolve every key in the eager warm-up run that precedes their capture);
* saves and loads its entries as JSON, in the reference's file format
  (``docs/qmm-engine.md``), so a serving process can skip the timing.

Prefill and decode run under distinct :func:`tuning_phase` tags
(``model_zoo.prefill`` / ``decode_step``): their M differ by orders of
magnitude and so may their winners.  The scores family (rank-4 attention
scores, ``kernels.ops.binary_attn_scores``) keys on ``m = B*H*S``,
``k = dh``, ``n = T``.

Demotions (:func:`pin_demotion`) route every dispatch of one backend to
another for the process, explicit names included; the autotune entries
stay as they are.

Environment (the reference's names):

* ``REPRO_QMM_AUTOTUNE=0``      -- no timing: "auto" resolves to ``mxu``
  (``binary`` for the scores family) on the CPU, to the first kernel
  candidate on a card;
* ``REPRO_QMM_AUTOTUNE_CACHE``  -- the default ``autotune_cache_path`` of
  ``runtime.serve_loop.ServeEngine``, which loads and saves the file.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DEFAULT_BACKEND",
    "DEFAULT_SCORES_BACKEND",
    "TuneKey",
    "TuneRecord",
    "AutotuneCache",
    "candidate_backends",
    "make_problem",
    "make_scores_problem",
    "choose_backend",
    "choose_scores_backend",
    "get_cache",
    "reset_cache",
    "autotune_enabled",
    "tuning_phase",
    "current_phase",
    "pin_demotion",
    "clear_demotions",
    "demotions",
    "resolve_backend",
]

#: "auto" on the CPU when autotuning is off or every timing probe failed.
DEFAULT_BACKEND = "mxu"
#: The scores family's: the AND-popcount kernel.
DEFAULT_SCORES_BACKEND = "binary"

CACHE_ENV = "REPRO_QMM_AUTOTUNE_CACHE"
_DISABLE_ENV = "REPRO_QMM_AUTOTUNE"

_PHASE: contextvars.ContextVar = contextvars.ContextVar("qmm_tuning_phase", default="")


def current_phase() -> str:
    """The active tuning tag ("" outside any :func:`tuning_phase` block)."""
    return _PHASE.get()


@contextlib.contextmanager
def tuning_phase(tag: str):
    """Scope a tuning tag ("prefill" / "decode") over the dispatches inside."""
    token = _PHASE.set(tag)
    try:
        yield
    finally:
        _PHASE.reset(token)


# ---------------------------------------------------------------------------
# demotions
# ---------------------------------------------------------------------------

_DEMOTIONS: Dict[str, str] = {}


def pin_demotion(src: str, dst: str) -> None:
    """Route every dispatch of ``src`` to ``dst`` for this process.  Both
    must be registered, and a pin that would close a cycle is refused."""
    from repro_torch.core import backend_registry

    known = set(backend_registry.backend_names())
    for name in (src, dst):
        if name not in known:
            raise ValueError(f"cannot pin demotion {src!r} -> {dst!r}: unknown backend {name!r}")
    if src == dst or resolve_backend(dst) == src:
        raise ValueError(f"demotion {src!r} -> {dst!r} would form a cycle")
    _DEMOTIONS[src] = dst


def clear_demotions() -> None:
    _DEMOTIONS.clear()


def demotions() -> Dict[str, str]:
    """A copy of the demotion table."""
    return dict(_DEMOTIONS)


def resolve_backend(name: str) -> str:
    """Follow the demotion chain from ``name`` to the backend that serves it."""
    seen = set()
    while name in _DEMOTIONS and name not in seen:
        seen.add(name)
        name = _DEMOTIONS[name]
    return name


# ---------------------------------------------------------------------------
# keys and synthetic problems
# ---------------------------------------------------------------------------


def _bucket_m(m: int) -> int:
    """M rounded up to a power of two, at least 8."""
    b = 8
    while b < m:
        b <<= 1
    return b


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def candidate_backends(m: int, k: int, n: int, act_bits: int, weight_bits: int, *,
                       rank2: bool = True, family: str = "qmm", device="cpu") -> Tuple[str, ...]:
    """The backends eligible for this problem on ``device``, from the
    registry: on a card the hand-written kernels only."""
    from repro_torch.core import backend_registry

    return backend_registry.candidate_names(m, k, n, act_bits, weight_bits, rank2=rank2,
                                            family=family, on_card=_on_card(device))


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """One autotune cell; ``m`` is bucketed, ``candidates`` the eligible set
    (a file moved to a host with other backends never serves one it lacks)."""

    m: int
    k: int
    n: int
    act_bits: int
    weight_bits: int
    candidates: Tuple[str, ...]
    tag: str = ""
    family: str = "qmm"


@dataclasses.dataclass
class TuneRecord:
    backend: str
    timings_us: Dict[str, float]
    timed: bool  # False when single-candidate
    # every probe raised: an in-process fallback, never saved
    failed: bool = False


def _seed(key: TuneKey, extra: int) -> int:
    return (key.m * 1000003 + key.k * 10007 + key.n * 101 + extra) % (2**32)


def make_problem(key: TuneKey, device="cpu"):
    """Synthetic operands of the key's shape and precision on ``device``, in
    the serving layout: 1-bit weights binarized, packed along K and with
    their colsum, as ``pack_linear_for_serving`` gives them; a multi-bit
    right operand quantized and left unpacked."""
    from repro_torch.core import flow_abstraction as FA
    from repro_torch.core import quantization as Q

    rng = np.random.default_rng(_seed(key, key.act_bits * 7 + key.weight_bits))
    x = torch.from_numpy(rng.standard_normal((key.m, key.k)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.standard_normal((key.k, key.n)).astype(np.float32)).to(device)
    xq = Q.quantize_activation(x, key.act_bits)
    wq = Q.quantize_weight(w, key.weight_bits)
    if key.weight_bits == 1:
        return xq, wq.pack(axis=0), FA.weight_corrections(wq)
    return xq, wq, None


def make_scores_problem(key: TuneKey, device="cpu"):
    """Synthetic packed Q / K planes of a scores key on ``device``: the
    whole ``m`` on the S axis of one head.  The key keeps ``m = B*H*S``
    only, so this timing is approximate where a core's plan depends on the
    split (``binary_attn.cu`` blocks on the folded rows ``(H/G)*S``).  On a
    card the family has one candidate, the kernel, and is never timed."""
    from repro_torch.core import packing

    rng = np.random.default_rng(_seed(key, 5))
    q_bits = torch.from_numpy(rng.integers(0, 2, size=(1, 1, key.m, key.k), dtype=np.uint8))
    k_bits = torch.from_numpy(rng.integers(0, 2, size=(1, 1, key.n, key.k), dtype=np.uint8))
    return (packing.pack_bits(q_bits.to(device), 1, axis=-1),
            packing.pack_bits(k_bits.to(device), 1, axis=-1))


#: Calls of a candidate captured into the one CUDA graph its timing replays.
_GRAPH_CALLS = 16


def _best_time(fn: Callable[[], object], *, warmup: int = 1, reps: int = 3) -> float:
    """Seconds a call of ``fn``, the fastest of ``reps`` runs after
    ``warmup`` calls.  ``fn`` returns a tensor, whose device decides.  On a
    card ``_GRAPH_CALLS`` calls are captured into one CUDA graph and each
    run is a replay timed by CUDA events, divided by that count: device
    time only, as a replayed serving step pays it.  On the CPU a run is one call on the
    host clock."""
    out = None
    for _ in range(warmup):
        out = fn()
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        dev = out.device
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(_GRAPH_CALLS):
                fn()
        graph.replay()
        torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3 / _GRAPH_CALLS)
        del graph
        return best
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _capturing() -> bool:
    """Whether a CUDA graph is being captured on the current stream."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class AutotuneCache:
    """Backend choice per key, measured once.

    ``timer(fn) -> seconds`` is injectable (tests pass a fake); the default
    is :func:`_best_time`.  ``timing_runs`` counts single backend probes: a
    loaded cache must not grow it.
    """

    def __init__(self, *, timer: Optional[Callable[[Callable[[], object]], float]] = None,
                 warmup: int = 1, reps: int = 3):
        self._entries: Dict[TuneKey, TuneRecord] = {}
        self._timer = timer or functools.partial(_best_time, warmup=warmup, reps=reps)
        self.timing_runs = 0

    def key(self, m: int, k: int, n: int, act_bits: int, weight_bits: int, *,
            tag: Optional[str] = None, rank2: bool = True, family: str = "qmm",
            device="cpu") -> TuneKey:
        mb = _bucket_m(int(m))
        return TuneKey(
            mb, int(k), int(n), int(act_bits), int(weight_bits),
            candidate_backends(mb, k, n, act_bits, weight_bits, rank2=rank2, family=family,
                               device=device),
            current_phase() if tag is None else tag, family,
        )

    def choose(self, m: int, k: int, n: int, act_bits: int, weight_bits: int, *,
               tag: Optional[str] = None, rank2: bool = True, family: str = "qmm",
               device="cpu") -> str:
        """The winning backend for this problem, timed on ``device`` at the
        first miss.  A miss while a CUDA graph is being captured raises."""
        key = self.key(m, k, n, act_bits, weight_bits, tag=tag, rank2=rank2, family=family,
                       device=device)
        rec = self._entries.get(key)
        if rec is None:
            if _capturing():
                raise RuntimeError(
                    f"autotune miss during a CUDA graph capture: {key}; resolve it in the "
                    "eager run before the capture (timing cannot be captured)"
                )
            rec = self._tune(key, torch.device(device))
            self._entries[key] = rec
        return rec.backend

    @property
    def entries(self) -> Dict[TuneKey, TuneRecord]:
        return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def _time_all(self, key: TuneKey, calls: Dict[str, Callable[[], object]], fallback: str,
                  device: torch.device) -> TuneRecord:
        timings: Dict[str, float] = {}
        for name, call in calls.items():
            try:
                timings[name] = self._timer(call)
            except Exception as e:  # noqa: BLE001 -- on the CPU a backend that fails just loses
                if _on_card(device):
                    raise RuntimeError(f"autotune: backend {name!r} failed on {device} for {key}") from e
                continue
            self.timing_runs += 1
        if not timings:
            return TuneRecord(fallback, {}, False, failed=True)
        best = min(timings, key=timings.get)
        return TuneRecord(best, {b: t * 1e6 for b, t in timings.items()}, True)

    def _tune(self, key: TuneKey, device: torch.device) -> TuneRecord:
        if not key.candidates:
            raise ValueError(f"no backend serves {key} on {device}")
        if len(key.candidates) == 1:
            return TuneRecord(key.candidates[0], {}, False)
        if key.family == "scores":
            return self._tune_scores(key, device)
        from repro_torch.core import qmm as QE

        xq, wq, colsum = make_problem(key, device)
        calls = {b: functools.partial(QE.qmm, xq, wq, backend=b, w_colsum=colsum)
                 for b in key.candidates}
        return self._time_all(key, calls, DEFAULT_BACKEND, device)

    def _tune_scores(self, key: TuneKey, device: torch.device) -> TuneRecord:
        """Each candidate's ``run_scores`` on the same planes; every scores
        core is exact, so the winner is a speed verdict only."""
        from repro_torch.core import backend_registry

        q_planes, k_planes = make_scores_problem(key, device)
        calls = {b: functools.partial(backend_registry.get_backend(b).run_scores,
                                      q_planes, k_planes, dh=key.k)
                 for b in key.candidates}
        return self._time_all(key, calls, DEFAULT_SCORES_BACKEND, device)

    # -- persistence (docs/qmm-engine.md) ------------------------------------

    def to_json(self) -> dict:
        return {
            "version": 1,
            "entries": [
                {
                    "m": k.m, "k": k.k, "n": k.n,
                    "act_bits": k.act_bits, "weight_bits": k.weight_bits,
                    "candidates": list(k.candidates), "tag": k.tag, "family": k.family,
                    "backend": r.backend, "timings_us": r.timings_us, "timed": r.timed,
                }
                for k, r in self._entries.items()
                if not r.failed
            ],
        }

    def save(self, path: str) -> None:
        """Write every entry but failed ones, atomically (write, rename)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def load(self, path: str) -> int:
        """Merge the entries of ``path``; returns how many.  An entry naming
        a backend this build lacks is skipped."""
        with open(path) as f:
            blob = json.load(f)
        if blob.get("version") != 1:
            raise ValueError(f"unsupported autotune cache version in {path}")
        from repro_torch.core import backend_registry

        known = set(backend_registry.backend_names())
        loaded = 0
        for e in blob.get("entries", ()):
            if e["backend"] not in known:
                continue
            key = TuneKey(int(e["m"]), int(e["k"]), int(e["n"]), int(e["act_bits"]),
                          int(e["weight_bits"]), tuple(e["candidates"]), e.get("tag", ""),
                          e.get("family", "qmm"))
            self._entries[key] = TuneRecord(e["backend"], dict(e.get("timings_us", {})),
                                            bool(e.get("timed")))
            loaded += 1
        return loaded


# ---------------------------------------------------------------------------
# the process-wide cache that "auto" consults
# ---------------------------------------------------------------------------

_default_cache: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process-wide cache."""
    global _default_cache
    if _default_cache is None:
        _default_cache = AutotuneCache()
    return _default_cache


def reset_cache(cache: Optional[AutotuneCache] = None) -> AutotuneCache:
    """Swap the process-wide cache (a fresh one by default)."""
    global _default_cache
    _default_cache = cache if cache is not None else AutotuneCache()
    return _default_cache


def autotune_enabled() -> bool:
    return os.environ.get(_DISABLE_ENV, "1").lower() not in ("0", "off", "false")


def _untimed(default: str, m, k, n, act_bits, weight_bits, *, rank2=True, family="qmm",
             device="cpu") -> str:
    """"auto" with autotuning off: ``default`` on the CPU, the first kernel
    candidate on a card."""
    if not _on_card(device):
        return default
    names = candidate_backends(_bucket_m(int(m)), k, n, act_bits, weight_bits, rank2=rank2,
                               family=family, device=device)
    if not names:
        raise ValueError(f"no hand-written kernel serves the {family} problem m={m} k={k} n={n} "
                         f"A{act_bits}W{weight_bits} on {device}")
    return names[0]


def choose_backend(m: int, k: int, n: int, act_bits: int, weight_bits: int, *,
                   tag: Optional[str] = None, rank2: bool = True,
                   cache: Optional[AutotuneCache] = None, device="cpu") -> str:
    """Resolve "auto" for one QMM problem, demotions applied."""
    if not autotune_enabled():
        return resolve_backend(_untimed(DEFAULT_BACKEND, m, k, n, act_bits, weight_bits,
                                        rank2=rank2, device=device))
    return resolve_backend((cache or get_cache()).choose(
        m, k, n, act_bits, weight_bits, tag=tag, rank2=rank2, device=device))


def choose_scores_backend(b: int, h: int, s: int, t: int, dh: int, *, tag: Optional[str] = None,
                          cache: Optional[AutotuneCache] = None, device="cpu") -> str:
    """Resolve the scores-family core for one attention-scores problem
    (``m = B*H*S``, ``k = dh``, ``n = T``, W1A1), demotions applied."""
    m = int(b) * int(h) * int(s)
    if not autotune_enabled():
        return resolve_backend(_untimed(DEFAULT_SCORES_BACKEND, m, dh, t, 1, 1, family="scores",
                                        device=device))
    return resolve_backend((cache or get_cache()).choose(
        m, dh, t, 1, 1, tag=tag, family="scores", device=device))
