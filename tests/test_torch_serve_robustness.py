"""The port's fault-tolerant serving (``repro_torch.runtime.serve_loop``)
on the granite-8b smoke model (2 slots, max_len 48), on the CPU.

* The reference's 14 tests of ``tests/test_serve_robustness.py``, each
  against the port's own fault-free ``serve_sequential``: a request that
  hits an injected fault is retried or re-admitted under the same
  ``(seed, rid)`` stream, so its tokens equal an unfailed run's, T > 0
  included.  The SIGKILL test kills ``python -m repro_torch.launch.serve``.
* Fault plans through both engines, the reference's run op by op: the same
  terminal states, retries, outputs and event kinds.
* What the port's in-place cache adds: a failed attempt leaves every cache
  leaf as it was; a failure inside the step loses the tick, not the
  requests; a device error is re-raised at once.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.core import dispatch as jdispatch
from repro.models import model_zoo as JZ
from repro.runtime import faults as jfaults
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import dispatch
from repro_torch.launch import serve as cli
from repro_torch.models import model_zoo as Z
from repro_torch.runtime import serve_loop as S
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.runtime.serve_loop import (
    STATE_DEADLINE,
    STATE_FAILED,
    STATE_OK,
    Request,
    ServeEngine,
    serve_sequential,
)
from repro_torch.runtime.traffic import summarize_availability
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

MAX_LEN = 48
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _clean_demotions():
    dispatch.clear_demotions()
    jdispatch.clear_demotions()
    yield
    dispatch.clear_demotions()
    jdispatch.clear_demotions()


@pytest.fixture(scope="module")
def both():
    """The reference's smoke params and the port's copy of them."""
    jcfg = jsmoke(jget("granite-8b"))
    tcfg = tsmoke(tget("granite-8b"))
    serving = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, serving, tcfg, convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu")


@pytest.fixture(scope="module")
def model(both):
    return both[2], both[3]


def _requests(cfg, n=4, temperature=0.8, max_new=6, deadline=None, cls=Request):
    """Deterministic mixed-length requests (fresh objects per call)."""
    rng = np.random.default_rng(1234)
    return [
        cls(
            prompt=rng.integers(0, cfg.vocab_size, size=(3 + 2 * i,)).astype(np.int32),
            max_new_tokens=max_new,
            temperature=temperature,
            deadline_s=deadline,
        )
        for i in range(n)
    ]


def _cross_requests(cls):
    """Four sampled requests with prompts of one length: the reference run
    op by op compiles each of its operations once per shape."""
    rng = np.random.default_rng(99)
    return [cls(prompt=rng.integers(0, 256, size=(5,)).astype(np.int32), max_new_tokens=6,
                temperature=0.8) for _ in range(4)]


def _oracle(model, **kw):
    cfg, params = model
    return serve_sequential(cfg, params, _requests(cfg, **kw), max_len=MAX_LEN, seed=0, device="cpu")


def _engine(model, **kw):
    cfg, params = model
    return ServeEngine(cfg, params, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu", **kw)


def _assert_token_identical(got, want):
    for g, w in zip(got, want):
        assert g.output == w.output, f"rid={g.rid} diverged after faults: {g.output} != {w.output}"


# ---------------------------------------------------------------------------
# the reference's 14 behaviours
# ---------------------------------------------------------------------------


def test_transient_tick_fault_retries_in_place(model):
    want = _oracle(model)
    eng = _engine(model, fault_plan=FaultPlan(decode_fail_ticks=(1, 4)))
    got = eng.run(_requests(model[0]))
    kinds = [e["kind"] for e in eng.last_events]
    assert kinds.count("step_fault") == 2
    assert "retry_tick" in kinds
    assert all(r.state == STATE_OK and r.retries == 0 for r in got)
    _assert_token_identical(got, want)


def test_nan_logits_fail_one_request_and_replay_bit_identical(model):
    want = _oracle(model)
    eng = _engine(model, fault_plan=FaultPlan(nan_ticks={1: 0}))
    got = eng.run(_requests(model[0]))
    kinds = [e["kind"] for e in eng.last_events]
    assert "nan_logits" in kinds and "requeue" in kinds
    assert sum(r.retries for r in got) == 1
    assert all(r.state == STATE_OK for r in got)
    _assert_token_identical(got, want)


def test_prefill_fault_readmits_bit_identical(model):
    want = _oracle(model)
    eng = _engine(model, fault_plan=FaultPlan(prefill_fail_rids={0: 1}))
    got = eng.run(_requests(model[0]))
    assert any(e["kind"] == "prefill_fault" for e in eng.last_events)
    assert got[0].retries == 1 and got[0].state == STATE_OK
    _assert_token_identical(got, want)


def test_retry_exhaustion_is_terminal_but_engine_survives(model):
    eng = _engine(model, fault_plan=FaultPlan(decode_fail_attempts=tuple(range(500))),
                  max_retries=1, retry_backoff_s=0.0)
    got = eng.run(_requests(model[0], n=3))
    assert all(r.state == STATE_FAILED for r in got)
    assert all(r.retries == eng.max_retries + 1 for r in got)
    # a fresh engine serves the same queue clean; so does this one, its
    # plan cleared (greedy: its request ids have moved on)
    again = _engine(model).run(_requests(model[0], n=3))
    assert all(r.state == STATE_OK for r in again)
    _assert_token_identical(again, _oracle(model, n=3))
    eng.fault_plan = FaultPlan()
    greedy = eng.run(_requests(model[0], n=3, temperature=0.0))
    assert all(r.state == STATE_OK for r in greedy)
    _assert_token_identical(greedy, _oracle(model, n=3, temperature=0.0))


def test_repeated_backend_failures_demote_with_zero_lost_requests(model):
    want = _oracle(model)
    eng = _engine(model, fault_plan=FaultPlan(backend_fail={"fused": 2}), demote_after=2)
    first_step = eng.decode_fn
    got = eng.run(_requests(model[0]))
    demotes = [e for e in eng.last_events if e["kind"] == "demote"]
    assert demotes and demotes[0]["from"] == "fused" and demotes[0]["to"] == "mxu"
    assert dispatch.demotions() == {"fused": "mxu"}
    assert dispatch.resolve_backend("fused") == "mxu"
    assert eng.decode_fn is not first_step  # the step is built anew
    assert all(r.state == STATE_OK for r in got)
    _assert_token_identical(got, want)


def test_demotion_pins_dispatch_for_explicit_backends():
    dispatch.pin_demotion("fused", "mxu")
    assert dispatch.resolve_backend("fused") == "mxu"
    assert dispatch.resolve_backend("mxu") == "mxu"
    with pytest.raises(ValueError):
        dispatch.pin_demotion("mxu", "fused")  # would cycle
    dispatch.clear_demotions()
    assert dispatch.resolve_backend("fused") == "fused"


def test_queued_request_past_deadline_is_expired_not_served(model):
    cfg, params = model
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=MAX_LEN, seed=0, device="cpu")
    head = Request(prompt=np.arange(4, dtype=np.int32) % cfg.vocab_size, max_new_tokens=4)
    starved = Request(prompt=np.arange(5, dtype=np.int32) % cfg.vocab_size, max_new_tokens=4,
                      deadline_s=0.01)
    done = eng.run([head, starved])
    assert done[0].state == STATE_OK
    assert done[1].state == STATE_DEADLINE
    assert not done[1].output
    misses = [e for e in eng.last_events if e["kind"] == "deadline_miss"]
    assert [e["rid"] for e in misses] == [done[1].rid]


def test_running_request_past_deadline_frees_its_slot(model):
    cfg, _ = model
    eng = _engine(model, fault_plan=FaultPlan(every_tick_delay_s=0.2))
    done = eng.run(_requests(cfg, n=2, temperature=0.0, max_new=30, deadline=0.5))
    assert all(r.state == STATE_DEADLINE for r in done)
    assert all(len(r.output) < r.max_new_tokens for r in done)
    avail = summarize_availability(done, eng.last_events)
    assert avail["n_deadline_missed"] == 2
    assert avail["deadline_miss_rate"] == 1.0
    assert eng._pos == [0, 0]  # both slots reset


def test_validation_rejects_bad_deadlines_and_shapes(model):
    eng = _engine(model)
    with pytest.raises(ValueError, match="rank-1"):
        eng.run([Request(prompt=np.zeros((2, 3), np.int32), max_new_tokens=2)])
    with pytest.raises(ValueError, match="deadline_s"):
        eng.run([Request(prompt=np.zeros((4,), np.int32), max_new_tokens=2, deadline_s=0.0)])
    with pytest.raises(ValueError, match="non-empty"):
        eng.run([Request(prompt=np.zeros((4,), np.int32), max_new_tokens=0)])


def test_oracle_parity_under_temperature_without_faults(model):
    want = _oracle(model, temperature=1.1)
    got = _engine(model).run(_requests(model[0], temperature=1.1))
    _assert_token_identical(got, want)


def test_snapshot_resume_in_process(model, tmp_path):
    want = _oracle(model)
    snap = str(tmp_path / "snap")
    eng = _engine(model, snapshot_every=2, snapshot_dir=snap)
    eng.run(_requests(model[0]))
    assert any(e["kind"] == "snapshot" for e in eng.last_events)
    fresh = _engine(model, snapshot_every=2, snapshot_dir=snap)
    res = fresh.resume()
    assert [e["kind"] for e in fresh.last_events][0] == "resume"
    _assert_token_identical(sorted(res, key=lambda r: r.rid), want)


def test_resume_rejects_geometry_mismatch(model, tmp_path):
    cfg, params = model
    snap = str(tmp_path / "snap")
    _engine(model, snapshot_every=1, snapshot_dir=snap).run(_requests(cfg, n=2))
    other = ServeEngine(cfg, params, batch_slots=3, max_len=MAX_LEN, seed=0, device="cpu",
                        snapshot_dir=snap)
    with pytest.raises(ValueError, match="geometry mismatch"):
        other.resume()
    empty = ServeEngine(cfg, params, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu",
                        snapshot_dir=str(tmp_path / "nothing-here"))
    with pytest.raises(FileNotFoundError):
        empty.resume()


def test_snapshot_write_crash_is_an_event_not_an_outage(model, tmp_path):
    want = _oracle(model)
    eng = _engine(model, fault_plan=FaultPlan(snapshot_fail_at=(0,)), snapshot_every=2,
                  snapshot_dir=str(tmp_path / "snap"))
    got = eng.run(_requests(model[0]))
    kinds = [e["kind"] for e in eng.last_events]
    assert "snapshot_failed" in kinds
    assert "snapshot" in kinds
    assert all(r.state == STATE_OK for r in got)
    _assert_token_identical(got, want)


def _committed(snap):
    if not os.path.isdir(snap):
        return []
    return [d for d in os.listdir(snap)
            if d.startswith("step_") and os.path.exists(os.path.join(snap, d, "_COMMITTED"))]


def test_sigkill_mid_batch_then_resume_matches_oracle(tmp_path):
    """A serving process (``python -m repro_torch.launch.serve``) is
    SIGKILLed mid-batch; an engine in this process resumes from its last
    committed snapshot and finishes every request as the oracle does."""
    snap = str(tmp_path / "snap")
    argv = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--max-len", str(MAX_LEN), "--max-new", "12", "--prompt-len", "7",
            "--temperature", "0.8", "--snapshot-every", "1", "--snapshot-dir", snap,
            "--fault-plan", '{"every_tick_delay_s": 0.5}']
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None and not _committed(snap):
            time.sleep(0.05)
        assert _committed(snap), "child never committed a snapshot"
        assert proc.poll() is None, "child finished before SIGKILL: " + proc.stdout.read().decode(
            errors="replace")
        time.sleep(0.6)  # land the kill inside the decode loop
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    args = cli.parser().parse_args(argv)
    cfg = cli.serving_config(args.arch, args.smoke, args.device)
    params = Z.init_serving_params(args.seed, cfg, device="cpu")
    want = serve_sequential(cfg, params, cli.fixed_queue(args, cfg.vocab_size), max_len=MAX_LEN,
                            seed=0, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu",
                      snapshot_dir=snap)
    res = sorted(eng.resume(), key=lambda r: r.rid)
    assert eng.last_events[0]["tick"] >= 1
    assert all(r.state == STATE_OK for r in res)
    for got, exp in zip(res, want):
        assert got.output == exp.output, (
            f"rid={got.rid}: resumed run diverged after SIGKILL: {got.output} != {exp.output}")


# ---------------------------------------------------------------------------
# the port's engine against the reference's, under the same plans
# ---------------------------------------------------------------------------

CROSS_PLANS = {
    "transient-nan-prefill": (dict(decode_fail_ticks=(1, 4), nan_ticks={2: 1},
                                   prefill_fail_rids={3: 1}), {}),
    "demotion-snapshots": (dict(backend_fail={"fused": 2}, snapshot_fail_at=(0,)),
                           dict(snapshot_every=2)),
    "persistent-failure": (dict(decode_fail_attempts=tuple(range(3, 9))),
                           dict(max_retries=1, retry_backoff_s=0.0)),
}


@pytest.mark.parametrize("name", sorted(CROSS_PLANS))
def test_engine_matches_reference_engine_under_faults(both, name, tmp_path):
    jcfg, jparams, tcfg, tparams = both
    plan, kw = CROSS_PLANS[name]
    ref_kw = dict(kw)
    if "snapshot_every" in kw:
        kw = dict(kw, snapshot_dir=str(tmp_path / "snap"))
        ref_kw = dict(kw, snapshot_dir=str(tmp_path / "snap-ref"))
    want_eng = JS.ServeEngine(jcfg, jparams, batch_slots=2, max_len=MAX_LEN, seed=0,
                              fault_plan=jfaults.FaultPlan(**plan), **ref_kw)
    with jax.disable_jit():
        want = want_eng.run(_cross_requests(JS.Request))
    jdispatch.clear_demotions()
    got_eng = ServeEngine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu",
                          fault_plan=FaultPlan(**plan), **kw)
    got = got_eng.run(_cross_requests(Request))
    assert [(r.state, r.retries, r.output) for r in got] == [
        (r.state, r.retries, r.output) for r in want]
    assert [e["kind"] for e in got_eng.last_events if e["kind"] != "compile"] == [
        e["kind"] for e in want_eng.last_events]


# ---------------------------------------------------------------------------
# the in-place cache
# ---------------------------------------------------------------------------


def test_failed_attempt_leaves_every_cache_leaf_unchanged(model, monkeypatch):
    """Injected decode and backend faults fire before the step: the cache
    after a failed attempt equals, bit for bit, the cache before it."""
    checks = []

    class Recording(FaultInjector):
        before = None  # the cache as it was before the attempt that failed

        def before_decode(self, tick, demoted=()):
            if self.before is not None:
                checks.append(Z.caches_equal(self.before, eng._cache))
                self.before = None
            snap = Z.cache_copy(eng._cache)
            try:
                super().before_decode(tick, demoted)
            except Exception:
                self.before = snap
                raise

    monkeypatch.setattr(S, "FaultInjector", Recording)
    eng = _engine(model, fault_plan=FaultPlan(decode_fail_ticks=(1, 3), backend_fail={"fused": 1}),
                  retry_backoff_s=0.0)
    got = eng.run(_requests(model[0]))
    # the backend fault at tick 0, the tick faults at 1 and 3
    assert checks == [True, True, True]
    _assert_token_identical(got, _oracle(model))


def test_failure_inside_the_step_loses_the_tick_not_the_requests(model, monkeypatch):
    """A fault raised after the step wrote the cache (its cursors moved)
    cannot be retried in place: the batch's requests are re-admitted and
    every row reset, and the outputs still equal the oracle's."""
    want = _oracle(model)
    eng = _engine(model)
    real = eng.decode_fn
    calls = {"n": 0}

    def flaky(params, tokens, cache):
        out = real(params, tokens, cache)
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("host-side failure after the step ran")
        return out

    monkeypatch.setattr(eng, "decode_fn", flaky, raising=False)
    flaky.captures = 0
    got = eng.run(_requests(model[0]))
    kinds = [e["kind"] for e in eng.last_events]
    assert kinds.count("step_fault") == 1 and "retry_tick" not in kinds
    assert kinds.count("requeue") == 2
    assert all(r.state == STATE_OK for r in got) and sum(r.retries for r in got) == 2
    _assert_token_identical(got, want)


DEVICE_ERRORS = [RuntimeError("CUDA error: an illegal memory access was encountered")]
if hasattr(torch, "AcceleratorError"):
    DEVICE_ERRORS.append(torch.AcceleratorError("device-side assert triggered"))


@pytest.mark.parametrize("where", ["decode", "prefill"])
@pytest.mark.parametrize("err", DEVICE_ERRORS, ids=lambda e: type(e).__name__)
def test_device_error_is_reraised_not_retried(model, monkeypatch, where, err):
    eng = _engine(model, max_retries=3)

    def boom(*a, **k):
        raise err

    if where == "decode":
        monkeypatch.setattr(eng, "decode_fn", boom, raising=False)
        boom.captures = 0
    else:
        monkeypatch.setattr(S.Z, "prefill", boom)
    with pytest.raises(type(err)) as got:
        eng.run(_requests(model[0]))
    assert got.value is err
    kinds = [e["kind"] for e in eng.last_events]
    assert not {"step_fault", "retry_tick", "prefill_fault", "requeue"} & set(kinds)


def test_demote_to_must_serve_the_qmm_family(model):
    with pytest.raises(ValueError, match="qmm family"):
        _engine(model, demote_to="binary")
    with pytest.raises(ValueError, match="unknown backend"):
        _engine(model, demote_to="nope")
    assert _engine(model).demote_to == dispatch.DEFAULT_BACKEND
