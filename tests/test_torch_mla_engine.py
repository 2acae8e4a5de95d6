"""The port's ``ServeEngine`` against the reference's ``ServeEngine`` on
the deepseek-v2-lite-16b smoke variant (MLA + MoE), 4 slots, 6 greedy
requests of staggered lengths: greedy tokens identical, and at every tick
the tokens and cursors of all 4 rows -- free rows included -- equal.

MoE routing depends on the batch: every row of a tick, free or not,
competes for the same capacity (one row per expert at 4 slots, top-2 of 8
experts), so a request's tokens depend on what shares its ticks.  The
one-request-at-a-time ``serve_sequential`` is therefore no oracle for the
engine on this family; the reference's own engine is.  ``ENGINE_MAX_LEN``
exceeds the run's ticks, so no free row's cursor nears ``max_len`` and the
port's reset of such a row (fault 3.2, which the reference does not make)
cannot arise; the test asserts it did not.

``tests/test_torch_mla_v3_engine.py`` runs the same on deepseek-v3-671b's
smoke variant, in a file of its own so the two run side by side under
``--dist loadfile``.
"""

import jax
import numpy as np
import pytest

from repro.models import model_zoo as JZ
from repro.runtime import serve_loop as JS
from repro_torch.runtime.serve_loop import Request, ServeEngine
from test_torch_mla_family import _backend, build
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAME = "deepseek-v2-lite-16b"


# (prompt length, new tokens): two prompt lengths (each a reference
# prefill compiled op by op) and budgets that free and refill slots at
# different ticks, so free rows decode beside live ones
ENGINE_REQUESTS = ((7, 4), (4, 7), (7, 2), (4, 5), (7, 6), (4, 3))
ENGINE_MAX_LEN = 40  # more than the run's ticks: no free row nears max_len


def engine_vs_reference_engine(m) -> None:
    """Both engines, 4 slots, the same greedy requests: equal tokens, and
    at every tick equal inputs (token and cursor) in all 4 rows.  The
    reference's engine runs op by op (``jax.disable_jit``): run as it is,
    its admission prefills call jitted pieces (``jnp.einsum``,
    ``jax.nn.softmax``) whose fused code drifts from the op-by-op run by a
    few 1e-3 on these logits, and at one tick of these requests two
    logits of a row lie closer than that."""
    jcfg, tcfg, serving, serving_t = _backend(m["jcfg"], "mxu"), m["tcfg"], m["serving"], m["serving_t"]

    def requests():
        rng = np.random.default_rng(5)
        return [Request(prompt=rng.integers(0, 256, size=(n,)).astype(np.int32), max_new_tokens=new)
                for n, new in ENGINE_REQUESTS]

    jreqs = [JS.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in requests()]
    jeng = JS.ServeEngine(jcfg, serving, batch_slots=4, max_len=ENGINE_MAX_LEN, seed=0)
    jticks, tticks = [], []
    jdecode = jeng._decode_fn

    def jrecord(params, tokens, cache):
        pos = np.asarray(JZ._cache_pos(cache["stack"], jcfg)).reshape(-1)
        jticks.append((np.asarray(tokens).tolist(), pos.tolist()))
        return jdecode(params, tokens, cache)

    jeng._decode_fn = jrecord
    with jax.disable_jit():
        want = jeng.run(jreqs)

    teng = ServeEngine(tcfg, serving_t, batch_slots=4, max_len=ENGINE_MAX_LEN, seed=0, device="cpu")
    tstep = teng.decode_fn._step

    def trecord(params, tokens, cfg, cache):
        tticks.append((tokens.tolist(), cache["layers"][0]["pos"].tolist()))
        return tstep(params, tokens, cfg, cache)

    teng.decode_fn._step = trecord
    got = teng.run(requests())
    assert all(r.state == "ok" for r in got) and all(r.state == "ok" for r in want)
    assert not any(e["kind"] == "reset" and e["rid"] is None for e in teng.last_events)
    assert max(max(pos) for _, pos in tticks) < ENGINE_MAX_LEN - 1
    assert [r.output for r in got] == [r.output for r in want]
    assert len(tticks) == len(jticks)
    for i, (t, j) in enumerate(zip(tticks, jticks)):
        assert t == j, f"tick {i}: port rows (tokens, cursors) {t} != reference {j}"
    rids = [e["rids"] for e in teng.last_events if e["kind"] in ("compile", "decode_tick")]
    assert any(None in r for r in rids) and any(None not in r for r in rids), \
        "free rows must decode beside live ones"


@pytest.fixture(scope="module")
def model():
    return build(NAME)


def test_engine_equals_reference_engine(model):
    engine_vs_reference_engine(model)
