"""Deterministic fault injection for the serving runtime (port of
``repro.runtime.faults``; NumPy only).

BETA's availability story ("a lost host triggers re-shard + resume rather
than a dead replica") is only testable if every failure mode is
*reproducible*: a chaos run whose faults land at different places on every
execution cannot be diffed against an unfailed oracle.  This module is the
reproducibility layer — a :class:`FaultPlan` names exactly which decode
ticks fail, which logits go NaN, which registry backend raises and how
often, and which snapshot writes crash; :class:`FaultInjector` threads that
plan through ``ServeEngine``'s hook points with one-shot semantics, so the
same plan against the same workload produces the same failure trace, run
after run.

Fault vocabulary (each maps to one hook in ``runtime.serve_loop``):

* ``decode_fail_ticks``    — raise :class:`InjectedFault` before the decode
  step at these tick indices, once per tick (the retry of the same tick
  succeeds: a *transient* step failure).
* ``decode_fail_attempts`` — raise before these decode *attempt* ordinals
  (attempts count retries too, so a long run of ordinals models a
  *persistent* failure that exhausts the retry budget).
* ``backend_fail``         — ``{backend_name: n}``: the next ``n`` decode
  attempts raise :class:`BackendFault` naming that backend, as long as the
  engine has not demoted it — models a kernel (e.g. a kernel that
  fails to launch) that fails every time until dispatch routes around it.
* ``nan_ticks``            — ``{tick: slot}``: overwrite that slot's logits
  row with NaN after the decode at ``tick`` (a numerics escape the engine
  must contain to one request).
* ``delay_ticks``          — ``{tick: seconds}``: sleep before the decode at
  ``tick`` (an injected latency spike; drives deadline-miss paths).
* ``every_tick_delay_s``   — constant per-tick sleep (slows a run down so a
  test can SIGKILL it mid-batch deterministically).
* ``prefill_fail_rids``    — ``{rid: n}``: the next ``n`` admissions of that
  request raise during prefill.
* ``snapshot_fail_at``     — snapshot ordinals whose write raises
  (a checkpoint-write crash; the engine must keep serving).

``FaultPlan()`` (all fields empty) is the no-op default; the injector for it
never fires, so production serving pays one attribute check per hook.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = [
    "InjectedFault",
    "BackendFault",
    "FaultPlan",
    "FaultInjector",
    "parse_fault_plan",
]


class InjectedFault(RuntimeError):
    """A failure placed by a :class:`FaultPlan` (base for all injected kinds)."""


class BackendFault(InjectedFault):
    """A failure attributed to one registry backend.

    Carries ``.backend`` so the engine's degradation policy can count
    failures per backend and demote the repeat offender.  Real kernels may
    raise this too — the engine treats any ``BackendFault`` identically,
    injected or not.
    """

    def __init__(self, backend: str, message: str = ""):
        super().__init__(message or f"backend {backend!r} failed")
        self.backend = backend


def _int_keys(d: Optional[Dict]) -> Dict[int, float]:
    return {int(k): v for k, v in (d or {}).items()}


def _as_map(spec: Dict, key: str) -> Dict:
    """Fetch a mapping-valued plan field, rejecting wrong-shaped JSON loudly."""
    val = spec.get(key, {})
    if not isinstance(val, dict):
        raise ValueError(
            f"fault plan field {key!r} must be a JSON object "
            f"(e.g. {{\"3\": 1}}), got {type(val).__name__}"
        )
    return val


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A complete, deterministic failure schedule for one serving run.

    Frozen so a plan can ride inside a bench config dict unchanged; all
    mutable firing state lives in the :class:`FaultInjector` built from it.
    """

    decode_fail_ticks: Tuple[int, ...] = ()
    decode_fail_attempts: Tuple[int, ...] = ()
    backend_fail: Dict[str, int] = dataclasses.field(default_factory=dict)
    nan_ticks: Dict[int, int] = dataclasses.field(default_factory=dict)
    delay_ticks: Dict[int, float] = dataclasses.field(default_factory=dict)
    every_tick_delay_s: float = 0.0
    prefill_fail_rids: Dict[int, int] = dataclasses.field(default_factory=dict)
    snapshot_fail_at: Tuple[int, ...] = ()

    def is_noop(self) -> bool:
        return not (
            self.decode_fail_ticks
            or self.decode_fail_attempts
            or self.backend_fail
            or self.nan_ticks
            or self.delay_ticks
            or self.every_tick_delay_s
            or self.prefill_fail_rids
            or self.snapshot_fail_at
        )

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["decode_fail_ticks"] = list(self.decode_fail_ticks)
        d["decode_fail_attempts"] = list(self.decode_fail_attempts)
        d["snapshot_fail_at"] = list(self.snapshot_fail_at)
        # JSON objects carry string keys; normalize so to_dict/parse round-trip
        d["nan_ticks"] = {str(k): int(v) for k, v in self.nan_ticks.items()}
        d["delay_ticks"] = {str(k): float(v) for k, v in self.delay_ticks.items()}
        d["prefill_fail_rids"] = {
            str(k): int(v) for k, v in self.prefill_fail_rids.items()
        }
        return d

    @classmethod
    def sample(
        cls,
        seed: int,
        horizon: int,
        *,
        p_decode_fail: float = 0.05,
        p_nan: float = 0.0,
        n_slots: int = 4,
        max_delay_s: float = 0.0,
    ) -> "FaultPlan":
        """A random-but-deterministic chaos plan over ``horizon`` ticks.

        The same seed always yields the same plan — chaos tests stay
        reproducible while still covering varied fault placements.
        """
        rng = np.random.default_rng(seed)
        ticks = np.arange(horizon)
        fail = tuple(int(t) for t in ticks[rng.random(horizon) < p_decode_fail])
        nan = {
            int(t): int(rng.integers(0, n_slots))
            for t in ticks[rng.random(horizon) < p_nan]
        }
        delay: Dict[int, float] = {}
        if max_delay_s > 0:
            spikes = ticks[rng.random(horizon) < 0.1]
            delay = {int(t): float(rng.uniform(0, max_delay_s)) for t in spikes}
        return cls(decode_fail_ticks=fail, nan_ticks=nan, delay_ticks=delay)


def parse_fault_plan(spec) -> FaultPlan:
    """Build a :class:`FaultPlan` from a JSON string, a dict, or ``None``.

    The CLI surface (``--fault-plan '{"decode_fail_ticks": [1]}'``): JSON
    object keys arrive as strings, so integer-keyed maps are normalized.
    Unknown keys are an error — a typo'd fault name must not silently
    become a no-op chaos run.
    """
    if spec is None:
        return FaultPlan()
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, str):
        spec = json.loads(spec)
    if not isinstance(spec, dict):
        raise ValueError(f"fault plan must be a JSON object, got {type(spec).__name__}")
    known = {f.name for f in dataclasses.fields(FaultPlan)}
    unknown = set(spec) - known
    if unknown:
        raise ValueError(f"unknown fault plan keys: {sorted(unknown)}")
    return FaultPlan(
        decode_fail_ticks=tuple(int(t) for t in spec.get("decode_fail_ticks", ())),
        decode_fail_attempts=tuple(
            int(t) for t in spec.get("decode_fail_attempts", ())
        ),
        backend_fail={str(k): int(v) for k, v in _as_map(spec, "backend_fail").items()},
        nan_ticks={int(k): int(v) for k, v in _as_map(spec, "nan_ticks").items()},
        delay_ticks={int(k): float(v) for k, v in _as_map(spec, "delay_ticks").items()},
        every_tick_delay_s=float(spec.get("every_tick_delay_s", 0.0)),
        prefill_fail_rids=_int_keys(_as_map(spec, "prefill_fail_rids")),
        snapshot_fail_at=tuple(int(t) for t in spec.get("snapshot_fail_at", ())),
    )


class FaultInjector:
    """Stateful executor of one :class:`FaultPlan` over one serving run.

    One-shot discipline: a tick-keyed fault fires exactly once per tick
    value (the engine's retry of the same tick proceeds clean), a
    count-keyed fault (``backend_fail``, ``prefill_fail_rids``) decrements
    until exhausted.  ``injected`` counts every fault actually delivered,
    which feeds the availability block of ``runtime.traffic``.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, *, sleep=None):
        import time

        self.plan = plan or FaultPlan()
        self._sleep = sleep or time.sleep
        self._fired: set = set()
        self._backend_left = dict(self.plan.backend_fail)
        self._prefill_left = dict(self.plan.prefill_fail_rids)
        self._attempts = 0
        self.injected = 0

    def _fire_once(self, key) -> bool:
        if key in self._fired:
            return False
        self._fired.add(key)
        self.injected += 1
        return True

    # -- engine hook points --------------------------------------------------

    def before_decode(self, tick: int, demoted: Iterable[str] = ()) -> None:
        """Called before every decode attempt (including retries of a tick).

        May sleep (latency spike) and may raise ``InjectedFault`` /
        ``BackendFault``.  Backend faults stop firing for backends the
        engine already demoted — the failure belongs to the datapath, not
        the tick.
        """
        attempt = self._attempts
        self._attempts += 1
        delay = self.plan.every_tick_delay_s + self.plan.delay_ticks.get(tick, 0.0)
        if delay > 0 and self._fire_once(("delay", tick, attempt)):
            self._sleep(delay)
        demoted = set(demoted)
        for backend, left in self._backend_left.items():
            if left > 0 and backend not in demoted:
                self._backend_left[backend] = left - 1
                self.injected += 1
                raise BackendFault(backend, f"injected failure of {backend!r}")
        if attempt in self.plan.decode_fail_attempts:
            self.injected += 1
            raise InjectedFault(f"injected decode failure (attempt {attempt})")
        if tick in self.plan.decode_fail_ticks and self._fire_once(("tick", tick)):
            raise InjectedFault(f"injected decode failure (tick {tick})")

    def corrupt_logits(self, tick: int, logits: np.ndarray) -> np.ndarray:
        """NaN out one slot's logits row after the decode at ``tick``."""
        slot = self.plan.nan_ticks.get(tick)
        if slot is None or not self._fire_once(("nan", tick)):
            return logits
        out = np.array(logits, copy=True)
        out[slot % out.shape[0]] = np.nan
        return out

    def before_prefill(self, rid: int) -> None:
        left = self._prefill_left.get(rid, 0)
        if left > 0:
            self._prefill_left[rid] = left - 1
            self.injected += 1
            raise InjectedFault(f"injected prefill failure (rid {rid})")

    def on_snapshot(self, ordinal: int) -> None:
        if ordinal in self.plan.snapshot_fail_at and self._fire_once(("snap", ordinal)):
            raise InjectedFault(f"injected snapshot-write crash (ordinal {ordinal})")
