"""The port's measurement modules against the reference's on the CPU:
``core/energy_model.py`` (the paper's ZCU102 model: every float equal
exactly, and the reference's Table II checks on the port's copy),
``core/qmm_roofline.py`` and ``core/attn_bench.py`` (the model columns:
bytes and intensity equal the reference's, the roofs the H100's; the
documents' validation, save and load; a measured cell on the CPU) and
``attn_bench.make_planes`` (the reference's words)."""

import json

import numpy as np
import pytest

from repro.core import attn_bench as JA
from repro.core import energy_model as JE
from repro.core import qmm_roofline as JR
from repro.core.precision import MODES as J_MODES
from repro_torch.core import attn_bench as A
from repro_torch.core import backend_registry as BR
from repro_torch.core import energy_model as E
from repro_torch.core import qmm_roofline as R
from repro_torch.core.precision import MODES
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

OVERHEADS = [None, "BiT", "BinaryBERT", "BiBERT"]


def _pair(name):
    return (None, None) if name is None else (E.BENCHMARK_OVERHEADS[name], JE.BENCHMARK_OVERHEADS[name])


def test_frozen_constants_equal_reference():
    assert E.ZCU102_BETA.__dict__ == JE.ZCU102_BETA.__dict__
    assert E.PAPER_TABLE2 == JE.PAPER_TABLE2 and E.PAPER_TABLE2_BASELINES == JE.PAPER_TABLE2_BASELINES
    assert {k: v.__dict__ for k, v in E.BENCHMARK_OVERHEADS.items()} == {
        k: v.__dict__ for k, v in JE.BENCHMARK_OVERHEADS.items()}
    assert [s.__dict__ for s in E.bert_base_qmm_workload(seq=64)] == [
        s.__dict__ for s in JE.bert_base_qmm_workload(seq=64)]


@pytest.mark.parametrize("overhead", OVERHEADS)
@pytest.mark.parametrize("mode", list(MODES))
def test_energy_model_equals_reference_exactly(mode, overhead):
    m, jm = MODES[mode], J_MODES[mode]
    oh, joh = _pair(overhead)
    wl, jwl = E.bert_base_qmm_workload(), JE.bert_base_qmm_workload()
    hw, jhw = E.ZCU102_BETA, JE.ZCU102_BETA
    assert [E.qmm_cycles(s, m, hw) for s in wl] == [JE.qmm_cycles(s, jm, jhw) for s in jwl]
    assert E.workload_cycles(wl, m, hw, oh) == JE.workload_cycles(jwl, jm, jhw, joh)
    assert E.throughput_gops(wl, m, hw, oh) == JE.throughput_gops(jwl, jm, jhw, joh)
    assert E.power_w(wl, m, hw, oh) == JE.power_w(jwl, jm, jhw, joh)
    assert E.energy_efficiency(wl, m, hw, oh) == JE.energy_efficiency(jwl, jm, jhw, joh)
    for qt in ("act_weight", "act_act"):
        assert hw.peak_gops(m, qt) == jhw.peak_gops(jm, qt)


@pytest.mark.parametrize("name", ["BiT", "BinaryBERT", "BiBERT"])
def test_table2_within_1pct_and_calibration(name):
    wl, mode, oh = E.bert_base_qmm_workload(), MODES["W1A1"], E.BENCHMARK_OVERHEADS[name]
    paper = E.PAPER_TABLE2[name]
    gops, _ = E.throughput_gops(wl, mode, E.ZCU102_BETA, oh)
    assert abs(gops - paper["gops"]) / paper["gops"] < 0.01
    assert abs(E.power_w(wl, mode, E.ZCU102_BETA, oh) - paper["power_w"]) / paper["power_w"] < 0.01
    eff = E.energy_efficiency(wl, mode, E.ZCU102_BETA, oh)
    assert abs(eff - paper["gops_per_w"]) / paper["gops_per_w"] < 0.01
    jwl = JE.bert_base_qmm_workload()
    assert E.calibrate_vpu_passes(paper["gops"], wl, mode) == JE.calibrate_vpu_passes(
        paper["gops"], jwl, J_MODES["W1A1"])


def test_fig5_trend_headline_and_power_fit():
    wl, oh = E.bert_base_qmm_workload(), E.BENCHMARK_OVERHEADS["BiT"]
    effs = [E.energy_efficiency(wl, MODES[m], E.ZCU102_BETA, oh) for m in ("W1A8", "W1A4", "W1A2", "W1A1")]
    assert effs == sorted(effs)
    avg = np.mean([E.energy_efficiency(wl, MODES["W1A1"], E.ZCU102_BETA, o)
                   for o in E.BENCHMARK_OVERHEADS.values()])
    assert abs(avg - 174.0) < 2.0
    pts = [(E.throughput_gops(wl, MODES["W1A1"], E.ZCU102_BETA, o)[0] / 2e3, E.PAPER_TABLE2[n]["power_w"])
           for n, o in E.BENCHMARK_OVERHEADS.items()]
    assert E.calibrate_power(pts) == JE.calibrate_power(pts)
    # the paper's counting of one 128-token BERT-base forward
    assert 2 * sum(s.macs for s in wl) == 2 * 11_173_625_856


QMM_SHAPES = [(8, 128, 128), (4, 4096, 14336), (128, 768, 3072), (128, 64, 128)]
QMM_PRECISIONS = [(1, 1), (8, 1), (2, 1), (8, 8)]


@pytest.mark.parametrize("backend", BR.backend_names(family="qmm"))
def test_roofline_model_columns(backend):
    for m, k, n in QMM_SHAPES:
        for ab, wb in QMM_PRECISIONS:
            got, want = R.cell_model(backend, m, k, n, ab, wb), JR.cell_model(backend, m, k, n, ab, wb)
            for key in ("flops", "bytes", "intensity"):
                assert got[key] == want[key], (backend, m, k, n, ab, wb, key)
            assert got["t_compute_us"] == got["flops"] / 1.979e15 * 1e6
            assert got["t_memory_us"] == got["bytes"] / 3.35e12 * 1e6
            assert got["roof_us"] == max(got["t_compute_us"], got["t_memory_us"])
            assert got["bound"] == ("compute" if got["t_compute_us"] >= got["t_memory_us"] else "memory")
    with pytest.raises(ValueError, match="unknown backend"):
        R.cell_model("fpga", 8, 64, 64, 1, 1)


@pytest.mark.parametrize("backend", BR.backend_names(family="scores"))
def test_attn_model_columns(backend):
    for shape in JA.DEFAULT_SHAPES + ((1, 12, 12, 128, 128, 64), (4, 32, 8, 1, 512, 128)):
        got, want = A.cell_model(backend, *shape), JA.cell_model(backend, *shape)
        for key in ("flops", "bytes", "intensity"):
            assert got[key] == want[key], (backend, shape, key)
        assert got["roof_us"] == max(got["flops"] / 1.979e15, got["bytes"] / 3.35e12) * 1e6


@pytest.mark.parametrize("seed", [0, 7])
def test_make_planes_reference_words(seed):
    for b, heads, s, dh in [(1, 4, 8, 32), (2, 3, 5, 100), (1, 2, 3, 64)]:
        got = A.make_planes(b, heads, s, dh, seed=seed, device="cpu")
        want = np.asarray(JA.make_planes(b, heads, s, dh, seed=seed)).view(np.int32)
        np.testing.assert_array_equal(got.numpy(), want)


def _qmm_doc(backends=None):
    cells = [dict(R.cell_model(b, 8, 128, 128, 1, 1), measured_us=1.0)
             for b in (backends or BR.backend_names(family="qmm"))]
    return {"schema": R.SCHEMA, "generated_unix": 0.0, "platform": "cpu",
            "hardware": R.hardware("cpu"), "backends": [c["backend"] for c in cells], "cells": cells}


def test_roofline_validation_save_load(tmp_path):
    doc = _qmm_doc()
    assert R.validate_qmm_bench(doc) is doc
    with pytest.raises(ValueError, match="schema mismatch"):
        R.validate_qmm_bench(dict(doc, schema="qmm-roofline/v1"))
    with pytest.raises(ValueError, match="non-empty"):
        R.validate_qmm_bench(dict(doc, cells=[]))
    broken = _qmm_doc()
    del broken["cells"][0]["bytes"]
    with pytest.raises(ValueError, match="'bytes' must be numeric"):
        R.validate_qmm_bench(broken)

    @BR.register_backend("tmp-roof", traffic_model=lambda m, k, n, ab, wb: 1)
    def run(x, w, *, w_colsum=None, out_dtype=None):
        return None

    try:
        with pytest.raises(ValueError, match="stale.*tmp-roof"):
            R.validate_qmm_bench(doc)
    finally:
        BR.unregister("tmp-roof")
    path = tmp_path / "sub" / "roof.json"
    R.save_qmm_bench(str(path), doc)
    assert R.load_qmm_bench(str(path)) == json.loads(json.dumps(doc))
    assert "share" in R.format_table(doc).splitlines()[1]


def test_attn_validation_save_load(tmp_path):
    cells = [dict(A.cell_model(b, 1, 4, 2, 8, 16, 32), measured_us=1.0)
             for b in BR.backend_names(family="scores")]
    doc = {"schema": A.SCHEMA, "generated_unix": 0.0, "platform": "cpu",
           "hardware": R.hardware("cpu"), "backends": [c["backend"] for c in cells], "cells": cells}
    with pytest.raises(ValueError, match="schema mismatch"):
        A.validate_attn_bench(dict(doc, schema=JA.SCHEMA))
    with pytest.raises(ValueError, match="stale.*binary"):
        A.validate_attn_bench(dict(doc, cells=[c for c in cells if c["backend"] != "binary"]))
    path = tmp_path / "attn.json"
    A.save_attn_bench(str(path), doc)
    assert A.load_attn_bench(str(path)) == json.loads(json.dumps(doc))


def test_measured_cells_on_cpu():
    doc = R.run_qmm_roofline(R.SMOKE_SHAPES, ((1, 1), (8, 1)), reps=1, device="cpu")
    assert doc["platform"] == "cpu" and set(doc["backends"]) == set(BR.backend_names(family="qmm"))
    assert R.validate_qmm_bench(doc) is doc
    assert all(c["measured_us"] > 0 and c["roof_us"] < c["measured_us"] for c in doc["cells"])
    cell = R.measure_cell("pallas", *R.SMOKE_SHAPES[0], 8, 8, reps=1, device="cpu")
    assert cell["measured_us"] > 0 and R.rotation_copies(10**6, "cpu") == 1
    adoc = A.run_attn_bench(A.SMOKE_SHAPES, reps=1, device="cpu")
    assert A.validate_attn_bench(adoc) is adoc and all(c["measured_us"] > 0 for c in adoc["cells"])
    assert len(A.format_table(adoc).splitlines()) == 2 + len(adoc["cells"])
