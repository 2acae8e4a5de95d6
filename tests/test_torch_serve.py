"""The port's continuous-batching engine on granite-8b smoke (CPU).

Mirrors tests/test_serve_engine.py and the fault-free baseline of
tests/test_serve_robustness.py: the engine must equal its own one-request-
at-a-time oracle token for token, greedy and sampled, and its greedy
tokens must equal the JAX reference engine's on the same params.  Tokens
are compared exactly (no tolerance): scheduling must be numerically
invisible.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import model_zoo as JZ
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.runtime.serve_loop import Request, ServeEngine, serve_sequential
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

MAX_LEN = 48


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jget("granite-8b"))
    tcfg = tsmoke(tget("granite-8b"))
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, backend="pallas"))
    serving = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    serving_t = convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu")
    return jcfg, serving, tcfg, serving_t


@pytest.fixture(scope="module")
def engine(model):
    _, _, tcfg, serving_t = model
    return ServeEngine(tcfg, serving_t, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu")


def _requests(n=5, seed=42, temperature=0.0, cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(
            prompt=rng.integers(0, 256, size=(int(rng.integers(3, 11)),)).astype(np.int32),
            max_new_tokens=int(rng.integers(3, 7)),
            temperature=temperature,
        )
        for _ in range(n)
    ]


def _oracle(model, temperature):
    _, _, tcfg, serving_t = model
    return serve_sequential(tcfg, serving_t, _requests(temperature=temperature),
                            max_len=MAX_LEN, seed=0, device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 1.1])
def test_engine_matches_sequential_oracle(model, temperature):
    """A fresh engine numbers its requests from 0, as the oracle does, so
    each request samples from the same ``default_rng([seed, rid])`` stream."""
    _, _, tcfg, serving_t = model
    want = _oracle(model, temperature)
    engine = ServeEngine(tcfg, serving_t, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu")
    got = engine.run(_requests(temperature=temperature))
    for g, w in zip(got, want):
        assert g.state == "ok"
        assert g.output == w.output, f"prompt_len={len(g.prompt)}: {g.output} != {w.output}"


def test_engine_greedy_equals_reference_engine(model, engine):
    jcfg, serving, _, _ = model
    want = JS.ServeEngine(jcfg, serving, batch_slots=2, max_len=MAX_LEN, seed=0).run(
        _requests(cls=JS.Request)
    )
    got = engine.run(_requests())
    assert [r.output for r in got] == [r.output for r in want]


def test_engine_serves_a_queue(engine):
    done = engine.run(_requests(n=5, seed=0))
    assert len(done) == 5 and all(r.state == "ok" for r in done)
    assert all(len(r.output) == r.max_new_tokens for r in done)
    assert all(0 <= t < 256 for r in done for t in r.output)
    kinds = {e["kind"] for e in engine.last_events}
    assert {"admit", "prefill", "insert", "decode_tick", "finish", "reset"} <= kinds


def test_invariant_to_arrivals(engine):
    a = engine.run(_requests(n=4, seed=7))
    staggered = _requests(n=4, seed=7)
    for i, r in enumerate(staggered):
        r.arrival_s = 0.05 * i
    b = engine.run(staggered)
    assert [r.output for r in a] == [r.output for r in b]


def test_streaming_callbacks_and_timing(engine):
    seen = []
    reqs = _requests(n=3, seed=3)
    for i, r in enumerate(reqs):
        r.on_token = lambda tok, i=i: seen.append((i, tok))
    for i, r in enumerate(engine.run(reqs)):
        assert [t for j, t in seen if j == i] == r.output
        assert len(r.token_times) == r.max_new_tokens
        assert r.t_admitted <= r.t_first_token <= r.t_finished
        assert r.token_times == sorted(r.token_times)


def test_rejects_requests_past_max_len(engine):
    with pytest.raises(ValueError, match="max_len"):
        engine.run([Request(prompt=np.zeros(40, np.int32), max_new_tokens=9)])


def test_engine_refuses_params_on_another_device(model):
    _, _, tcfg, serving_t = model
    with pytest.raises(ValueError, match="engine device"):
        ServeEngine(tcfg, serving_t, device="meta")


def test_quant_config_backends_and_overrides():
    """Backend names resolve through the port's own registry (never the
    reference's); per-site overrides pick the first matching pattern."""
    from repro_torch.configs.base import QuantConfig

    assert {"mxu", "popcount", "pallas", "fused"} <= set(QuantConfig.known_backends())
    q = QuantConfig(backend="pallas", backend_overrides=(("ffn.*", "fused"), ("ffn.up", "mxu")))
    assert [q.backend_for(s) for s in ("attn.q", "ffn.up", "ffn.down", "")] == [
        "pallas", "fused", "fused", "pallas"]
    for bad in (dict(backend="no-such-backend"), dict(backend_overrides=(("attn.*", "nope"),))):
        with pytest.raises(ValueError, match="unknown backend"):
            QuantConfig(**bad)


def test_site_overrides_reach_the_kernel_paths(model):
    """A config routing the FFN through ``fused`` and attention through
    ``pallas`` serves the same greedy tokens as all-``pallas`` on the CPU."""
    _, _, tcfg, serving_t = model
    mixed = dataclasses.replace(tcfg, quant=dataclasses.replace(
        tcfg.quant, backend_overrides=(("ffn.*", "fused"),)))
    want = serve_sequential(tcfg, serving_t, _requests(n=2), max_len=MAX_LEN, device="cpu")
    got = serve_sequential(mixed, serving_t, _requests(n=2), max_len=MAX_LEN, device="cpu")
    assert [r.output for r in got] == [r.output for r in want]
