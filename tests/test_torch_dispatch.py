"""The port's measured dispatch (``repro_torch.core.dispatch``) against the
reference's (``repro.core.dispatch``): keying, phases, persistence in the
reference's file format, demotions, and ``qmm(backend="auto")``.

The timer is injected (a fake returning fixed seconds in candidate order),
so which backend wins is fixed, as in ``tests/test_dispatch.py``, which
these cases mirror; where both sides are given the same fake timer they
must choose the same backend.  Backend parity takes its inputs from a numpy
seed through the reference's quantizers and the port's, and holds the
port's products to the reference's dequantized product with its tolerance.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core import flow_abstraction as JFA
from repro.core import quantization as JQ
from repro_torch.configs.base import QuantConfig
from repro_torch.core import backend_registry, dispatch
from repro_torch.core import qmm as QE
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops as K_ops
from repro_torch.kernels import ref
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

RNG = np.random.default_rng(99)
QMM_BACKENDS = backend_registry.backend_names(family="qmm")


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Each test starts from empty caches and no demotion, on both sides."""
    dispatch.reset_cache()
    dispatch.clear_demotions()
    JD.reset_cache()
    yield
    dispatch.reset_cache()
    dispatch.clear_demotions()
    JD.reset_cache()


def seq_timer(values):
    it = iter(values)
    return lambda fn: next(it)


def _pair(m, k, n, act_bits, weight_bits=1):
    """The same numpy operands quantized by the port and by the reference."""
    x = RNG.standard_normal((m, k)).astype(np.float32)
    w = RNG.standard_normal((k, n)).astype(np.float32)
    tq = (Q.quantize_activation(torch.from_numpy(x), act_bits),
          Q.quantize_weight(torch.from_numpy(w), weight_bits))
    jq = (JQ.quantize_activation(jnp.asarray(x), act_bits), JQ.quantize_weight(jnp.asarray(w), weight_bits))
    return tq, jq


# ---------------------------------------------------------------------------
# keying
# ---------------------------------------------------------------------------


def test_distinct_shapes_and_precisions_get_distinct_entries():
    cache = dispatch.AutotuneCache(timer=seq_timer([1.0] * 100))
    cache.choose(8, 64, 32, 1, 1)
    cache.choose(8, 64, 32, 1, 1)
    assert len(cache) == 1
    cache.choose(8, 64, 64, 1, 1)
    cache.choose(8, 128, 32, 1, 1)
    cache.choose(8, 64, 32, 8, 1)
    cache.choose(1024, 64, 32, 1, 1)
    cache.choose(8, 64, 32, 1, 1, family="scores")
    assert len(cache) == 6


def test_keys_and_candidates_match_reference():
    """One problem keys alike on both sides: the same bucketed M and the
    same candidates in the same order (qmm and scores families)."""
    for args, fam in (((100, 64, 32, 1, 1), "qmm"), ((8, 64, 32, 8, 1), "qmm"), ((48, 64, 9, 1, 1), "scores")):
        t = dispatch.AutotuneCache(timer=seq_timer([1.0] * 10))
        j = JD.AutotuneCache(timer=seq_timer([1.0] * 10))
        t.choose(*args, family=fam, tag="decode")
        j.choose(*args, family=fam, tag="decode")
        (tk,), (jk,) = t.entries, j.entries
        assert (tk.m, tk.k, tk.n, tk.act_bits, tk.weight_bits, tk.tag, tk.family) == (
            jk.m, jk.k, jk.n, jk.act_bits, jk.weight_bits, jk.tag, jk.family)
        assert tk.candidates == jk.candidates


def test_repeat_lookup_does_not_retime():
    cache = dispatch.AutotuneCache(timer=seq_timer([1.0] * 10))
    cache.choose(8, 64, 32, 1, 1)
    runs = cache.timing_runs
    assert runs == 4
    for _ in range(5):
        cache.choose(8, 64, 32, 1, 1)
    assert cache.timing_runs == runs


def test_m_bucketing_shares_ragged_serving_waves():
    cache = dispatch.AutotuneCache(timer=seq_timer([1.0] * 100))
    cache.choose(100, 64, 32, 1, 1)
    cache.choose(128, 64, 32, 1, 1)
    assert len(cache) == 1
    cache.choose(129, 64, 32, 1, 1)
    assert len(cache) == 2
    assert [dispatch._bucket_m(m) for m in (1, 8, 9, 100, 129)] == [8, 8, 16, 128, 256]


def test_phase_tags_split_prefill_and_decode():
    cache = dispatch.AutotuneCache(timer=seq_timer([1.0] * 100))
    with dispatch.tuning_phase("prefill"):
        cache.choose(8, 64, 32, 1, 1)
    with dispatch.tuning_phase("decode"):
        cache.choose(8, 64, 32, 1, 1)
    assert len(cache) == 2 and {k.tag for k in cache.entries} == {"prefill", "decode"}
    assert dispatch.current_phase() == ""


def test_fake_timer_winner_matches_reference():
    """The same timings make the same winner on both sides."""
    times = [10.0, 1.0, 5.0, 7.0]
    t = dispatch.AutotuneCache(timer=seq_timer(times))
    j = JD.AutotuneCache(timer=seq_timer(times))
    assert t.choose(8, 64, 32, 1, 1) == j.choose(8, 64, 32, 1, 1) == "popcount"
    (rec,) = t.entries.values()
    assert rec.timed and rec.backend == min(rec.timings_us, key=rec.timings_us.get)
    assert rec.timings_us == pytest.approx({"mxu": 1e7, "popcount": 1e6, "pallas": 5e6, "fused": 7e6})


# ---------------------------------------------------------------------------
# qmm(backend="auto")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("times,winner", [([10.0, 1.0, 5.0, 7.0], "popcount"),
                                          ([3.0, 4.0, 1.0, 2.0], "pallas"),
                                          ([3.0, 4.0, 2.0, 1.0], "fused")])
def test_auto_routes_through_default_cache_bitwise_equal_to_choice(times, winner):
    cache = dispatch.reset_cache(dispatch.AutotuneCache(timer=seq_timer(times * 10)))
    (xq, wq), (jx, jw) = _pair(16, 64, 32, 1)
    out = QE.qmm(xq, wq, backend="auto")
    (rec,) = cache.entries.values()
    assert rec.backend == winner
    assert torch.equal(out, QE.qmm(xq, wq, backend=winner))
    want = np.asarray(JFA.qmm_dequant_reference(jx, jw))
    np.testing.assert_allclose(out.numpy(), want, atol=3e-5 * max(1.0, float(np.abs(want).max())))


def test_real_timing_picks_the_fastest_it_measured():
    """The host clock on the CPU: the recorded winner is the argmin of the
    recorded times, each candidate timed once (no device number)."""
    cache = dispatch.AutotuneCache(reps=1)
    chosen = cache.choose(16, 96, 24, 1, 1)
    (rec,) = cache.entries.values()
    assert chosen == min(rec.timings_us, key=rec.timings_us.get)
    assert cache.timing_runs == len(rec.timings_us) == 4


def test_auto_resolves_under_the_model_phases():
    """``model_zoo.prefill`` / ``decode_step`` tag their dispatches, so a
    qmm inside them keys under "prefill" / "decode"."""
    from repro_torch.models import model_zoo as Z

    seen = []
    real = dispatch.AutotuneCache.choose

    def spy(self, *a, **kw):
        seen.append(dispatch.current_phase())
        return real(self, *a, **kw)

    cfg = _tiny_cfg("auto")
    dispatch.reset_cache(dispatch.AutotuneCache(timer=seq_timer([1.0] * 1000)))
    params = Z.init_serving_params(0, cfg, device="cpu")
    cache = Z.init_cache(1, 16, cfg, device="cpu")
    from unittest import mock

    with mock.patch.object(dispatch.AutotuneCache, "choose", spy):
        logits, cache = Z.prefill(params, torch.tensor([[1, 2, 3]]), cfg, cache)
        n_pre = len(seen)
        Z.decode_step(params, logits.argmax(-1), cfg, cache)
    assert n_pre > 0 and set(seen[:n_pre]) == {"prefill"} and set(seen[n_pre:]) == {"decode"}


def _tiny_cfg(backend):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant

    cfg = dataclasses.replace(smoke_variant(get_config("bit-bert-base")), n_layers=1)
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


def test_env_kill_switch_disables_tuning(monkeypatch):
    monkeypatch.setenv("REPRO_QMM_AUTOTUNE", "0")
    cache = dispatch.reset_cache(dispatch.AutotuneCache(timer=seq_timer([1.0] * 10)))
    assert dispatch.choose_backend(8, 64, 32, 1, 1) == dispatch.DEFAULT_BACKEND == JD.DEFAULT_BACKEND
    assert dispatch.choose_scores_backend(1, 4, 2, 9, 64) == dispatch.DEFAULT_SCORES_BACKEND
    assert dispatch.DEFAULT_SCORES_BACKEND == JD.DEFAULT_SCORES_BACKEND
    assert len(cache) == 0 and cache.timing_runs == 0


def test_miss_during_capture_raises_and_hit_does_not(monkeypatch):
    """A miss while a CUDA graph is captured raises, naming the key, and
    times nothing; a key already resolved is served."""
    cache = dispatch.AutotuneCache(timer=seq_timer([1.0] * 10))
    cache.choose(8, 64, 32, 1, 1, tag="decode")
    runs = cache.timing_runs
    monkeypatch.setattr(dispatch, "_capturing", lambda: True)
    assert cache.choose(8, 64, 32, 1, 1, tag="decode") == "mxu"
    with pytest.raises(RuntimeError, match="capture.*m=16"):
        cache.choose(16, 64, 32, 1, 1, tag="decode")
    assert cache.timing_runs == runs and len(cache) == 1


def test_card_candidates_are_the_hand_written_kernels():
    """On a card only the backends that launch a hand-written kernel are
    candidates; the plain cores stay candidates on the CPU."""
    assert dispatch.candidate_backends(8, 64, 32, 1, 1, device="cuda") == ("pallas", "fused")
    assert dispatch.candidate_backends(8, 64, 32, 8, 1, device="cuda") == ("pallas", "fused")
    assert dispatch.candidate_backends(8, 64, 32, 1, 1, family="scores", device="cuda") == ("binary",)
    assert dispatch.candidate_backends(8, 64, 32, 1, 1, rank2=False, device="cuda") == ()
    assert dispatch.candidate_backends(8, 64, 32, 1, 1) == ("mxu", "popcount", "pallas", "fused")
    assert dispatch.candidate_backends(8, 64, 32, 1, 1, family="scores") == ("mxu", "binary", "float")


def test_autotune_off_on_card_resolves_to_a_kernel(monkeypatch):
    """With autotuning off "auto" is ``mxu`` / ``binary`` on the CPU (the
    reference's defaults) and the first kernel candidate on a card; a
    problem no kernel serves there raises."""
    monkeypatch.setenv("REPRO_QMM_AUTOTUNE", "0")
    assert dispatch.choose_backend(8, 64, 32, 1, 1, device="cuda") == "pallas"
    assert dispatch.choose_scores_backend(1, 4, 2, 9, 64, device="cuda") == "binary"
    with pytest.raises(ValueError, match="no hand-written kernel"):
        dispatch.choose_backend(8, 64, 32, 1, 1, rank2=False, device="cuda")


def test_failing_candidate_on_card_raises(monkeypatch):
    """A candidate that fails while it is timed on a card raises, naming
    it and the key, and nothing is recorded; on the CPU it just loses."""
    def exploding_timer(fn):
        raise RuntimeError("launch failed")

    real = dispatch.make_problem
    monkeypatch.setattr(dispatch, "make_problem", lambda key, device: real(key, "cpu"))
    cache = dispatch.AutotuneCache(timer=exploding_timer)
    with pytest.raises(RuntimeError, match="backend 'pallas' failed on cuda"):
        cache.choose(8, 64, 32, 1, 1, device="cuda")
    with pytest.raises(ValueError, match="no backend serves"):
        cache.choose(8, 64, 32, 1, 1, rank2=False, device="cuda")
    assert len(cache) == 0 and cache.timing_runs == 0
    # the scores family has one kernel on a card: chosen untimed, it raises itself
    assert cache.choose(8, 64, 32, 1, 1, family="scores", device="cuda") == "binary"


def test_engine_cache_path_defaults_to_the_environment(monkeypatch, tmp_path):
    """``$REPRO_QMM_AUTOTUNE_CACHE`` names the engine's cache file when no
    path is given; the process-wide cache alone does not read it."""
    from repro_torch.models import model_zoo as Z
    from repro_torch.runtime.serve_loop import ServeEngine

    path = str(tmp_path / "autotune.json")
    saved = dispatch.AutotuneCache(timer=seq_timer([3.0, 1.0, 2.0, 4.0]))
    saved.choose(8, 64, 32, 1, 1)
    saved.save(path)
    monkeypatch.setenv("REPRO_QMM_AUTOTUNE_CACHE", path)
    assert len(dispatch.reset_cache()) == 0 and len(dispatch.get_cache()) == 0
    cfg = _tiny_cfg("pallas")
    engine = ServeEngine(cfg, Z.init_serving_params(0, cfg, device="cpu"), batch_slots=1,
                         max_len=16, device="cpu")
    assert engine.autotune_cache_path == path
    assert dispatch.get_cache().entries == saved.entries


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def test_persist_reload_round_trip_skips_retiming(tmp_path):
    path = str(tmp_path / "autotune.json")
    cache = dispatch.AutotuneCache(timer=seq_timer([3.0, 1.0, 2.0, 4.0] * 10))
    first = cache.choose(8, 64, 32, 1, 1)
    cache.choose(8, 64, 64, 8, 1, tag="decode")
    cache.choose(48, 64, 9, 1, 1, tag="prefill", family="scores")
    cache.save(path)

    fresh = dispatch.AutotuneCache(timer=seq_timer([99.0] * 10))
    assert fresh.load(path) == 3
    assert fresh.choose(8, 64, 32, 1, 1) == first
    assert fresh.choose(8, 64, 64, 8, 1, tag="decode") == "popcount"
    assert fresh.choose(48, 64, 9, 1, 1, tag="prefill", family="scores") == "binary"
    assert fresh.timing_runs == 0

    blob = json.load(open(path))
    assert blob["version"] == 1
    assert set(blob["entries"][0]) == {"m", "k", "n", "act_bits", "weight_bits", "candidates",
                                       "tag", "family", "backend", "timings_us", "timed"}
    # the reference reads the port's file, and serves the same choices
    ref_cache = JD.AutotuneCache(timer=seq_timer([99.0] * 10))
    assert ref_cache.load(path) == 3
    assert ref_cache.choose(8, 64, 32, 1, 1) == first and ref_cache.timing_runs == 0


def test_failed_tuning_falls_back_but_is_never_persisted(tmp_path):
    def exploding_timer(fn):
        raise RuntimeError("transient")

    path = str(tmp_path / "autotune.json")
    cache = dispatch.AutotuneCache(timer=exploding_timer)
    assert cache.choose(8, 64, 32, 1, 1) == dispatch.DEFAULT_BACKEND
    assert cache.choose(8, 64, 32, 1, 1, family="scores") == dispatch.DEFAULT_SCORES_BACKEND
    assert all(r.failed and not r.timed for r in cache.entries.values())
    cache.save(path)
    assert json.load(open(path))["entries"] == []
    fresh = dispatch.AutotuneCache(timer=seq_timer([3.0, 1.0, 2.0, 4.0]))
    fresh.load(path)
    assert fresh.choose(8, 64, 32, 1, 1) == "popcount"


def test_load_skips_unknown_backends(tmp_path):
    path = str(tmp_path / "autotune.json")
    cache = dispatch.AutotuneCache(timer=seq_timer([1.0] * 10))
    cache.choose(8, 64, 32, 1, 1)
    blob = cache.to_json()
    blob["entries"][0]["backend"] = "fpga"
    with open(path, "w") as f:
        json.dump(blob, f)
    assert dispatch.AutotuneCache().load(path) == 0


# ---------------------------------------------------------------------------
# overrides, names and demotions
# ---------------------------------------------------------------------------


def test_backend_for_resolves_overrides():
    q = QuantConfig(backend="auto", backend_overrides=(("ffn.down", "popcount"), ("attn.*", "pallas")))
    assert [q.backend_for(s) for s in ("ffn.down", "ffn.up", "attn.q", "")] == [
        "popcount", "auto", "pallas", "auto"]


def test_quant_config_accepts_the_reference_names_and_no_other():
    from repro.configs.base import QuantConfig as JQuantConfig

    assert QuantConfig.known_backends() == JQuantConfig.known_backends()
    assert QuantConfig.known_backends()[0] == "auto"
    QuantConfig(backend="auto", backend_overrides=(("attn.qk", "binary"), ("attn.qk_latent", "float")))
    with pytest.raises(ValueError, match="unknown backend 'dsp'"):
        QuantConfig(backend="dsp")
    with pytest.raises(ValueError, match="popcnt"):
        QuantConfig(backend_overrides=(("ffn.down", "popcnt"),))


def test_qlinear_threads_forced_backend(monkeypatch):
    from repro_torch.models import layers as L

    seen = []
    real = QE.qmm

    def spy(x, w, **kw):
        seen.append(kw.get("backend"))
        return real(x, w, **kw)

    monkeypatch.setattr(L.QE, "qmm", spy)
    quant = QuantConfig(act_bits=4, backend="mxu", backend_overrides=(("proj", "popcount"),))
    gen = torch.Generator().manual_seed(0)
    sp = L.pack_linear_for_serving(L.init_linear(gen, 64, 32), quant)
    x = torch.from_numpy(RNG.standard_normal((4, 64)).astype(np.float32))
    forced = L.qlinear(sp, x, quant, name="proj")
    default = L.qlinear(sp, x, quant)
    assert seen == ["popcount", "mxu"]
    torch.testing.assert_close(forced, default, rtol=1e-4, atol=1e-3)


def test_demotions_route_names_and_refuse_cycles():
    """A pin reroutes explicit names, "auto" verdicts and scores cores;
    chains resolve to their end; a cycle or an unknown name is refused."""
    dispatch.pin_demotion("fused", "pallas")
    dispatch.pin_demotion("pallas", "mxu")
    assert dispatch.resolve_backend("fused") == "mxu" and dispatch.resolve_backend("popcount") == "popcount"
    with pytest.raises(ValueError, match="cycle"):
        dispatch.pin_demotion("mxu", "fused")
    with pytest.raises(ValueError, match="cycle"):
        dispatch.pin_demotion("mxu", "mxu")
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.pin_demotion("fused", "fpga")
    assert dispatch.demotions() == {"fused": "pallas", "pallas": "mxu"}
    calls = []
    real = backend_registry.get_backend

    def spy(name):
        calls.append(name)
        return real(name)

    (xq, wq), _ = _pair(8, 64, 16, 1)
    from unittest import mock

    with mock.patch.object(backend_registry, "get_backend", spy):
        QE.qmm(xq, wq, backend="fused")
    assert calls == ["mxu"]
    dispatch.reset_cache(dispatch.AutotuneCache(timer=seq_timer([3.0, 4.0, 2.0, 1.0])))
    assert dispatch.choose_backend(8, 64, 16, 1, 1) == "mxu"  # verdict "fused", demoted twice
    dispatch.pin_demotion("binary", "float")
    q = torch.from_numpy(RNG.integers(-2**31, 2**31, size=(1, 2, 3, 2), dtype=np.int64).astype(np.int32))
    k = torch.from_numpy(RNG.integers(-2**31, 2**31, size=(1, 1, 5, 2), dtype=np.int64).astype(np.int32))
    with mock.patch.object(backend_registry, "get_backend", spy):
        K_ops.binary_attn_scores(q, k, dh=64, backend="binary")
    assert calls[-1] == "float"
    dispatch.clear_demotions()
    assert dispatch.demotions() == {}


# ---------------------------------------------------------------------------
# numerical parity: every qmm backend vs the reference's dequantized product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", QMM_BACKENDS + ("auto",))
@pytest.mark.parametrize("act_bits", [1, 4, 8])
def test_backend_parity_act_weight(backend, act_bits):
    dispatch.reset_cache(dispatch.AutotuneCache(timer=seq_timer([4.0, 3.0, 2.0, 1.0] * 10)))
    (xq, wq), (jx, jw) = _pair(16, 96, 24, act_bits)
    expect = np.asarray(JFA.qmm_dequant_reference(jx, jw))
    out = QE.qmm(xq, wq, backend=backend)
    tol = 3e-5 * max(1.0, float(np.abs(expect).max()))
    np.testing.assert_allclose(out.numpy(), expect, atol=tol)


@pytest.mark.parametrize("backend", QMM_BACKENDS)
def test_backend_parity_act_act(backend):
    a = RNG.standard_normal((12, 40)).astype(np.float32)
    b = RNG.standard_normal((40, 20)).astype(np.float32)
    aq, bq = (Q.quantize_activation(torch.from_numpy(v), 4) for v in (a, b))
    expect = np.asarray(JFA.qmm_dequant_reference(JQ.quantize_activation(jnp.asarray(a), 4),
                                                  JQ.quantize_activation(jnp.asarray(b), 4)))
    out = QE.qmm(aq, bq, backend=backend)
    np.testing.assert_allclose(out.numpy(), expect, atol=3e-4 * max(1.0, float(np.abs(expect).max())))


def test_popcount_core_matches_bitserial_plain_version():
    m, k, n, bits = 16, 128, 24, 4
    a = RNG.integers(0, 2**bits, size=(m, k)).astype(np.int32)
    b = RNG.integers(0, 2**bits, size=(k, n)).astype(np.int32)
    core = QE.popcount_int_matmul(torch.from_numpy(a), torch.from_numpy(b), bits, bits)
    from repro_torch.core import packing

    apl = packing.pack_bitplanes(torch.from_numpy(a), bits, axis=-1)
    bpl = packing.pack_bitplanes(torch.from_numpy(b), bits, axis=-2)
    assert torch.equal(core, ref.bitserial_qmm_ref(apl, bpl, k))
    np.testing.assert_array_equal(core.numpy(), a @ b)


def test_make_problem_matches_reference_operands():
    """The synthetic problems are the reference's: the same numpy draws,
    quantized and packed alike (packed words as int32 views)."""
    key = dispatch.TuneKey(8, 64, 32, 1, 1, ("mxu",))
    jkey = JD.TuneKey(8, 64, 32, 1, 1, ("mxu",))
    (xq, wq, colsum), (jx, jw, jcol) = dispatch.make_problem(key), JD.make_problem(jkey)
    np.testing.assert_array_equal(xq.mantissa.numpy(), np.asarray(jx.mantissa))
    np.testing.assert_array_equal(wq.mantissa.numpy(), np.asarray(jw.mantissa).view(np.int32))
    np.testing.assert_array_equal(colsum.numpy(), np.asarray(jcol))
    skey = dispatch.TuneKey(16, 48, 9, 1, 1, ("mxu",), family="scores")
    jskey = JD.TuneKey(16, 48, 9, 1, 1, ("mxu",), family="scores")
    for got, want in zip(dispatch.make_scores_problem(skey), JD.make_scores_problem(jskey)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
