"""Synthetic open-loop serving traffic + the serve-bench record schema
(port of ``repro.runtime.traffic``; NumPy only).

Open-loop means arrivals are independent of service: a Poisson process
(exponential inter-arrival gaps at ``rate_rps``) stamps each request with an
``arrival_s`` the engine honors regardless of how fast it is draining —
queueing delay shows up in the latency percentiles instead of silently
throttling the offered load (closed-loop generators hide saturation).

Everything is seeded: the same ``TrafficConfig`` always produces the same
request set (prompts, lengths, arrival times), which is what lets
``BENCH_serve.json`` act as a perf-trajectory artifact — later PRs rerun the
identical workload and diff rps/p50/p99.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.serve_loop import Request

__all__ = [
    "TrafficConfig",
    "generate_requests",
    "summarize_bench",
    "summarize_availability",
    "validate_bench",
    "save_bench",
    "load_bench",
    "BENCH_SCHEMA_VERSION",
    "BENCH_REQUIRED_KEYS",
]

BENCH_SCHEMA_VERSION = 2
# contract checked by tests + the CI smoke cells.  v2 adds "availability":
# the perf trajectory records robustness (success rate, deadline misses,
# retries, faults survived), not just latency.
BENCH_REQUIRED_KEYS = ("rps", "p50_ms", "p99_ms", "config", "availability")

#: event kinds (ServeEngine.last_events) counted as faults the run absorbed
_FAULT_EVENT_KINDS = (
    "step_fault",
    "backend_fault",
    "nan_logits",
    "prefill_fault",
    "snapshot_failed",
)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Open-loop workload description (all distributions seeded)."""

    n_requests: int = 16
    rate_rps: float = 8.0  # Poisson arrival rate; <=0 -> all arrive at t=0
    prompt_len: Tuple[int, int] = (4, 12)  # inclusive uniform range
    new_tokens: Tuple[int, int] = (4, 16)  # inclusive uniform range
    temperature: float = 0.0
    deadline_s: Optional[float] = None  # per-request deadline from arrival
    seed: int = 0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["prompt_len"] = list(self.prompt_len)
        d["new_tokens"] = list(self.new_tokens)
        return d


def generate_requests(tc: TrafficConfig, vocab_size: int) -> List[Request]:
    """Materialize the workload: deterministic in (tc, vocab_size)."""
    rng = np.random.default_rng(tc.seed)
    if tc.rate_rps > 0:
        gaps = rng.exponential(1.0 / tc.rate_rps, size=tc.n_requests)
        arrivals = np.cumsum(gaps)
    else:
        arrivals = np.zeros(tc.n_requests)
    out: List[Request] = []
    for i in range(tc.n_requests):
        plen = int(rng.integers(tc.prompt_len[0], tc.prompt_len[1] + 1))
        nnew = int(rng.integers(tc.new_tokens[0], tc.new_tokens[1] + 1))
        prompt = rng.integers(0, vocab_size, size=(plen,)).astype(np.int32)
        out.append(
            Request(
                prompt=prompt,
                max_new_tokens=nnew,
                temperature=tc.temperature,
                arrival_s=float(arrivals[i]),
                deadline_s=tc.deadline_s,
            )
        )
    return out


def _percentile_ms(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q) * 1e3) if xs else 0.0


def _terminal_state(r: Request) -> str:
    """The request's terminal state, tolerating pre-robustness callers that
    hand-build requests without driving the engine's state machine."""
    state = getattr(r, "state", None)
    if state in ("ok", "failed", "deadline"):
        return state
    return "ok" if r.output else "failed"


def summarize_availability(
    requests: List[Request], events: Optional[List[Dict]] = None
) -> Dict:
    """The robustness block of BENCH_serve.json.

    ``events`` is ``ServeEngine.last_events`` — the fault/retry/demotion
    trace of the run.  "p99_under_faults_ms" is the p99 token latency of
    THIS run; when the config carries a fault plan, that number is the
    paper-thesis availability metric (tail latency while absorbing faults).
    """
    events = events or []
    states = [_terminal_state(r) for r in requests]
    n = len(requests)
    n_ok = states.count("ok")
    n_deadline = states.count("deadline")
    lats: List[float] = []
    for r in requests:
        if r.token_times:
            lats.append(r.token_times[0] - r.arrival_s)
            lats.extend(np.diff(np.asarray(r.token_times)).tolist())
    kinds = [e.get("kind") for e in events]
    return {
        "n_ok": n_ok,
        "n_failed": states.count("failed"),
        "n_deadline_missed": n_deadline,
        "success_rate": (n_ok / n) if n else 1.0,
        "deadline_miss_rate": (n_deadline / n) if n else 0.0,
        "retries": int(sum(getattr(r, "retries", 0) for r in requests)),
        "faults": sum(kinds.count(k) for k in _FAULT_EVENT_KINDS),
        "demotions": kinds.count("demote"),
        "snapshots": kinds.count("snapshot"),
        "p99_under_faults_ms": _percentile_ms(lats, 99),
    }


def summarize_bench(
    requests: List[Request],
    wall_s: float,
    config: Optional[Dict] = None,
    events: Optional[List[Dict]] = None,
) -> Dict:
    """Condense a served request set into the BENCH_serve.json record.

    Token latency distribution = per-request time-to-first-token (from
    arrival, so queueing delay counts) plus every inter-token gap; ``rps``
    is completed requests over the wall clock of the whole run.  Pass the
    engine's ``last_events`` as ``events`` so the availability block can
    count faults, retries, and backend demotions.
    """
    lats: List[float] = []
    ttfts: List[float] = []
    n_tokens = 0
    for r in requests:
        if not r.token_times:
            continue
        n_tokens += len(r.token_times)
        ttft = r.token_times[0] - r.arrival_s
        ttfts.append(ttft)
        lats.append(ttft)
        lats.extend(np.diff(np.asarray(r.token_times)).tolist())
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "config": dict(config or {}),
        "rps": (len(requests) / wall_s) if wall_s > 0 else 0.0,
        "p50_ms": _percentile_ms(lats, 50),
        "p99_ms": _percentile_ms(lats, 99),
        "ttft_p50_ms": _percentile_ms(ttfts, 50),
        "ttft_p99_ms": _percentile_ms(ttfts, 99),
        "tokens_per_s": (n_tokens / wall_s) if wall_s > 0 else 0.0,
        "n_requests": len(requests),
        "n_tokens": n_tokens,
        "wall_s": wall_s,
        "availability": summarize_availability(requests, events),
    }


def validate_bench(doc: Dict) -> Dict:
    missing = [k for k in BENCH_REQUIRED_KEYS if k not in doc]
    if missing:
        raise ValueError(f"BENCH_serve.json missing keys: {missing}")
    for k in ("rps", "p50_ms", "p99_ms"):
        if not isinstance(doc[k], (int, float)):
            raise ValueError(f"BENCH_serve.json key {k!r} must be numeric")
    if not isinstance(doc["config"], dict):
        raise ValueError("BENCH_serve.json 'config' must be an object")
    avail = doc["availability"]
    if not isinstance(avail, dict):
        raise ValueError("BENCH_serve.json 'availability' must be an object")
    for k in ("success_rate", "deadline_miss_rate", "retries"):
        if not isinstance(avail.get(k), (int, float)):
            raise ValueError(
                f"BENCH_serve.json availability key {k!r} must be numeric"
            )
    return doc


def save_bench(path: str, doc: Dict) -> None:
    validate_bench(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def load_bench(path: str) -> Dict:
    with open(path) as f:
        doc = json.load(f)
    validate_bench(doc)
    return doc
