"""The port's open-loop traffic generator and serve-bench schema
(``repro_torch.runtime.traffic``) against the reference's: the same
requests for a config, the same summaries of the same records."""

import dataclasses
import json

import numpy as np
import pytest

from repro.runtime import serve_loop as JS
from repro.runtime import traffic as JT
from repro_torch.runtime import serve_loop as TS
from repro_torch.runtime import traffic as TT
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

CONFIGS = [
    dict(),
    dict(n_requests=32, rate_rps=50.0, prompt_len=(1, 64), new_tokens=(1, 32), seed=3),
    dict(n_requests=8, rate_rps=0.0, prompt_len=(16, 16), new_tokens=(24, 24), temperature=0.8),
    dict(n_requests=20, rate_rps=2.5, prompt_len=(32, 128), new_tokens=(4, 16), deadline_s=1.5,
         temperature=0.3, seed=11),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_generate_requests_equals_reference(kw):
    got = TT.generate_requests(TT.TrafficConfig(**kw), vocab_size=49152)
    want = JT.generate_requests(JT.TrafficConfig(**kw), vocab_size=49152)
    assert len(got) == len(want) == kw.get("n_requests", 16)
    for g, w in zip(got, want):
        assert isinstance(g, TS.Request)
        assert g.prompt.dtype == w.prompt.dtype and np.array_equal(g.prompt, w.prompt)
        assert (g.max_new_tokens, g.temperature, g.arrival_s, g.deadline_s) == (
            w.max_new_tokens, w.temperature, w.arrival_s, w.deadline_s)
    assert TT.TrafficConfig(**kw).to_dict() == JT.TrafficConfig(**kw).to_dict()


def _records(mod, seed):
    """Finished requests with every terminal state, token stamps, retries."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        r = mod.Request(prompt=np.arange(4, dtype=np.int32), max_new_tokens=6,
                        arrival_s=float(rng.uniform(0, 1)))
        n = int(rng.integers(0, 7))
        r.output = list(range(n))
        r.token_times = sorted(float(t) for t in r.arrival_s + rng.uniform(0.01, 2.0, size=n))
        r.state = ["ok", "failed", "deadline"][i % 3] if n else "failed"
        r.retries = int(rng.integers(0, 3))
        out.append(r)
    return out


EVENTS = [{"kind": k, "t": 0.0} for k in (
    "admit", "step_fault", "retry_tick", "backend_fault", "demote", "nan_logits", "requeue",
    "prefill_fault", "snapshot", "snapshot_failed", "snapshot", "compile", "decode_tick")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summaries_equal_reference(seed, tmp_path):
    got_r, want_r = _records(TS, seed), _records(JS, seed)
    assert TT.summarize_availability(got_r, EVENTS) == JT.summarize_availability(want_r, EVENTS)
    cfg = {"arch": "granite-8b", "seed": seed}
    got = TT.summarize_bench(got_r, 3.5, cfg, EVENTS)
    assert got == JT.summarize_bench(want_r, 3.5, cfg, EVENTS)
    assert TT.validate_bench(got) is got
    path = str(tmp_path / "bench.json")
    TT.save_bench(path, got)
    assert TT.load_bench(path) == json.loads(json.dumps(got))
    assert JT.load_bench(path) == TT.load_bench(path)


def test_schema_constants_and_validation_equal_reference():
    assert TT.BENCH_SCHEMA_VERSION == JT.BENCH_SCHEMA_VERSION
    assert TT.BENCH_REQUIRED_KEYS == JT.BENCH_REQUIRED_KEYS
    doc = TT.summarize_bench([], 0.0)
    assert doc == JT.summarize_bench([], 0.0)
    for bad in ({k: v for k, v in doc.items() if k != "availability"},
                dict(doc, rps="fast"), dict(doc, config=[]),
                dict(doc, availability=dict(doc["availability"], retries=None))):
        with pytest.raises(ValueError) as want:
            JT.validate_bench(bad)
        with pytest.raises(ValueError) as got:
            TT.validate_bench(bad)
        assert str(got.value) == str(want.value)


def test_summaries_of_an_engine_run():
    """The availability block reads the port's engine's requests and events
    (its terminal states and retries) as the reference reads its own."""
    reqs = TT.generate_requests(TT.TrafficConfig(n_requests=3, rate_rps=0.0), vocab_size=16)
    for r, state in zip(reqs, ("ok", "deadline", "failed")):
        r.state, r.output, r.token_times, r.retries = state, [1], [0.5], 1
    avail = TT.summarize_availability(reqs, [{"kind": "demote"}, {"kind": "step_fault"}])
    assert (avail["n_ok"], avail["n_deadline_missed"], avail["n_failed"]) == (1, 1, 1)
    assert (avail["retries"], avail["faults"], avail["demotions"]) == (3, 1, 1)
    assert dataclasses.fields(TS.Request)[3].name == "arrival_s"
