"""The port's fault plan and injector against the reference's
(``repro.runtime.faults``): the same plans, the same samples for a seed,
and the same firing sequence on the same hook calls.  Host only, no model."""

import dataclasses
import json

import numpy as np
import pytest

from repro.runtime import faults as JF
from repro_torch.runtime import faults as TF
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

PLANS = [
    {},
    {"decode_fail_ticks": [1, 3]},
    {"decode_fail_attempts": [0, 1, 2, 5]},
    {"backend_fail": {"fused": 2}},
    {"backend_fail": {"fused": 1, "pallas": 2}},
    {"nan_ticks": {"2": 1, "4": 0}},
    {"delay_ticks": {"1": 0.25}, "every_tick_delay_s": 0.1},
    {"prefill_fail_rids": {"0": 1, "3": 2}},
    {"snapshot_fail_at": [0, 2]},
    {"decode_fail_ticks": [2, 5], "nan_ticks": {"3": 1}, "prefill_fail_rids": {"5": 1},
     "snapshot_fail_at": [0]},
]


def _as_reference(plan: TF.FaultPlan) -> JF.FaultPlan:
    return JF.FaultPlan(**dataclasses.asdict(plan))


@pytest.mark.parametrize("spec", PLANS, ids=range(len(PLANS)))
def test_parse_and_round_trip_equal_reference(spec):
    got = TF.parse_fault_plan(json.dumps(spec))
    want = JF.parse_fault_plan(json.dumps(spec))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    assert got.is_noop() == want.is_noop() == (spec == {})
    assert TF.parse_fault_plan(json.dumps(got.to_dict())) == got
    assert TF.parse_fault_plan(got) is got
    assert TF.parse_fault_plan(None) == TF.FaultPlan()


@pytest.mark.parametrize("bad", [{"decode_fail_tickz": [1]}, "[1, 2]", {"nan_ticks": [2]},
                                 '{"backend_fail": ["fused"]}'])
def test_parse_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError) as want:
        JF.parse_fault_plan(bad)
    with pytest.raises(ValueError) as got:
        TF.parse_fault_plan(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,kw", [
    (7, dict(horizon=100, p_decode_fail=0.2, p_nan=0.1, max_delay_s=0.5)),
    (8, dict(horizon=100, p_decode_fail=0.2, p_nan=0.1, max_delay_s=0.5)),
    (0, dict(horizon=40)),
    (123, dict(horizon=64, p_decode_fail=0.5, p_nan=0.3, n_slots=2)),
])
def test_sample_equals_reference(seed, kw):
    got = TF.FaultPlan.sample(seed, **kw)
    assert _as_reference(got) == JF.FaultPlan.sample(seed, **kw)
    assert got == TF.FaultPlan.sample(seed, **kw)


def _trace(mod, plan, sleeps):
    """Drive one injector through a fixed script of hook calls; record what
    each call did."""
    inj = mod.FaultInjector(plan, sleep=sleeps.append)
    out = []
    demoted = {}
    for step in range(12):
        tick = step // 2  # every tick is attempted twice, as a retry would
        if step == 6:
            demoted = {"fused": "pallas"}
        try:
            inj.before_decode(tick, demoted=demoted)
            out.append(("decode", tick, "ok"))
        except mod.BackendFault as e:
            out.append(("decode", tick, "backend", e.backend, str(e)))
        except mod.InjectedFault as e:
            out.append(("decode", tick, "fault", str(e)))
        logits = np.arange(8, dtype=np.float32).reshape(2, 4)
        hit = inj.corrupt_logits(tick, logits)
        out.append(("nan", tick, np.isnan(hit).any(axis=1).tolist()))
    for rid in (0, 3, 3, 5, 3):
        try:
            inj.before_prefill(rid)
            out.append(("prefill", rid, "ok"))
        except mod.InjectedFault as e:
            out.append(("prefill", rid, str(e)))
    for ordinal in (0, 0, 1, 2, 2):
        try:
            inj.on_snapshot(ordinal)
            out.append(("snap", ordinal, "ok"))
        except mod.InjectedFault as e:
            out.append(("snap", ordinal, str(e)))
    return out, inj.injected


@pytest.mark.parametrize("spec", PLANS, ids=range(len(PLANS)))
def test_injector_fires_as_reference(spec):
    got_sleeps, want_sleeps = [], []
    got = _trace(TF, TF.parse_fault_plan(spec), got_sleeps)
    want = _trace(JF, JF.parse_fault_plan(spec), want_sleeps)
    assert got == want
    assert got_sleeps == want_sleeps


def test_backend_fault_is_an_injected_runtime_error():
    e = TF.BackendFault("fused")
    assert isinstance(e, TF.InjectedFault) and isinstance(e, RuntimeError)
    assert e.backend == "fused" and str(e) == str(JF.BackendFault("fused"))
