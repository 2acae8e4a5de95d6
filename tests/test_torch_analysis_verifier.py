"""The port's invariant verifier (``repro_torch.analysis.verifier``) held
to the reference's verifier tests case by case (``tests/test_analysis_verifier.py``:
each case here yields the rule ids its reference test expects), the three
cache-drift cases also against the reference's own ``check_cache_contract``
findings, and the boundary marks: kernel wrappers (``out=`` included) and
packing functions compute what they computed unmarked, and the walk counts
each kernel boundary it crosses.

The reference's taint walk itself cannot run under jax 0.9.0
(``jax.core.Literal`` is gone), so its findings are compared only where its
code still runs: the cache contract, under ``jax.eval_shape``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import verifier as JV
from repro.analysis.selftest import load_fixture_module as load_reference_fixture
from repro_torch.analysis import verifier
from repro_torch.analysis.findings import render_text
from repro_torch.analysis.selftest import load_fixture_module
from repro_torch.core import backend_registry, marks, packing, site_log
from repro_torch.kernels import binary_qmm as K1
from repro_torch.kernels import ref
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
REFERENCE_FIXTURES = os.path.join(REPO, "analysis", "fixtures")
CPU = "cpu"


def _rules(findings):
    return {f.rule for f in findings}


def _words(*shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32)


@pytest.fixture(scope="module")
def bad_kernel():
    return load_fixture_module(os.path.join(FIXTURES, "bad_kernel.py"))


@pytest.fixture(scope="module")
def reference_bad_kernel():
    return load_reference_fixture(os.path.join(REFERENCE_FIXTURES, "bad_kernel.py"))


# ---------------------------------------------------------------------------
# taint walker on the seeded bad fixtures
# ---------------------------------------------------------------------------


def test_packed_to_float_flagged(bad_kernel):
    found = verifier.check_function(bad_kernel.leak_packed_to_float, _words(8, 2), packed_argnums=(0,))
    assert "INV-PACKED-FLOAT" in _rules(found)


def test_bf16_accumulation_flagged(bad_kernel):
    found = verifier.check_function(bad_kernel.accumulate_in_bf16, _words(8, 2), _words(8, 2, seed=1),
                                    packed_argnums=(0, 1))
    assert "INV-ACCUM-LOWFP" in _rules(found)


def test_kernel_lowfp_output_flagged(bad_kernel):
    """The kernel-boundary arm of INV-ACCUM-LOWFP: a kernel fed packed
    planes may exit int (counts) or f32 (fused epilogue) -- never bf16."""
    found = verifier.check_function(bad_kernel.fused_kernel_lowfp, _words(8, 2), _words(8, 2, seed=1),
                                    packed_argnums=(0, 1))
    assert "INV-ACCUM-LOWFP" in _rules(found)
    assert any("kernel:bad_fused_kernel" in f.message for f in found)


def test_low_precision_int_dot_flagged(bad_kernel):
    a = torch.ones((4, 8), dtype=torch.int8)
    found = verifier.check_function(bad_kernel.int_dot_low_precision, a, a.T.contiguous())
    assert "INV-INT-DOT" in _rules(found)


# ---------------------------------------------------------------------------
# taint walker on clean idioms (no false positives)
# ---------------------------------------------------------------------------


def test_popcount_then_f32_epilogue_clean():
    # the legal datapath: AND -> popcount -> int32 sum -> f32 epilogue
    def good(a, b):
        counts = packing.popcount32(a & b)
        acc = torch.sum(counts.to(torch.int32), dim=-1)
        return acc.to(torch.float32) * 0.5

    found = verifier.check_function(good, _words(8, 2), _words(8, 2, seed=1), packed_argnums=(0, 1))
    assert found == []


def test_unpack_launders_packed_taint():
    def good(p):
        x = packing.unpack_bits(p, 1, 64, axis=0, dtype=torch.int32)
        return x.to(torch.float32)

    found = verifier.check_function(good, _words(2, 16), packed_argnums=(0,))
    assert found == []


def test_pack_output_is_tainted():
    def bad(x):
        p = packing.pack_bits(x, 1, axis=-1)
        return p.to(torch.float32)  # packed words treated as numbers

    x = torch.randint(0, 2, (4, 64), generator=torch.Generator().manual_seed(0), dtype=torch.uint8)
    found = verifier.check_function(bad, x)
    assert "INV-PACKED-FLOAT" in _rules(found)


def test_int32_dot_with_int32_accumulation_clean():
    # the port's legal integer products: int32 accumulation (torch._int_mm's
    # contract; emulated here with int32 operands, which the CPU multiplies
    # in int32) and the exact float64 product of the plain versions
    from repro_torch.core.flow_abstraction import exact_int_matmul

    def good(a, b):
        return torch.matmul(a.to(torch.int32), b.to(torch.int32)), exact_int_matmul(a, b, 8 * 127 * 127)

    a = torch.ones((4, 8), dtype=torch.int8)
    found = verifier.check_function(good, a, a.T.contiguous())
    assert found == []


def test_taint_flows_through_views_and_in_place_writes():
    # packed words survive a view and an in-place write into a buffer (the
    # port's counterpart of the reference's carry through a scan), and leak
    # to float afterwards
    def bad(p):
        buf = torch.zeros((3, 8), dtype=torch.int32)
        for i in range(3):
            buf[i].copy_(p & 7)
        return buf.T.to(torch.float32)

    found = verifier.check_function(bad, _words(8), packed_argnums=(0,))
    assert "INV-PACKED-FLOAT" in _rules(found)


def test_bool_outputs_drop_taint():
    # comparisons on packed words produce masks, not numbers -- selecting
    # floats under such a mask is fine
    def good(p, x):
        mask = (p & 1) > 0
        return torch.where(mask, x, 0.0)

    found = verifier.check_function(good, _words(8), torch.randn(8, generator=torch.Generator().manual_seed(0)),
                                    packed_argnums=(0,))
    assert found == []


# ---------------------------------------------------------------------------
# cache contract (against the reference's own findings too)
# ---------------------------------------------------------------------------


def _reference_cache_findings(reference_bad_kernel, step):
    return JV.check_cache_contract(
        lambda: reference_bad_kernel.init_cache(2, 8, 4), step, jax.ShapeDtypeStruct((2, 4), jnp.float32))


def _same_findings(got, want):
    assert [(f.rule, f.symbol, f.message) for f in got] == [(f.rule, f.symbol, f.message) for f in want]


def test_cache_dtype_drift_caught(bad_kernel, reference_bad_kernel):
    found = verifier.check_cache_contract(lambda: bad_kernel.init_cache(2, 8, 4), bad_kernel.drifting_step,
                                          torch.zeros((2, 4)))
    assert _rules(found) == {"INV-CACHE-DTYPE"}
    assert "conv" not in found[0].symbol  # leaf path names the drifted slot
    assert "'k'" in found[0].symbol
    _same_findings(found, _reference_cache_findings(reference_bad_kernel, reference_bad_kernel.drifting_step))


def test_cache_shape_growth_caught(bad_kernel, reference_bad_kernel):
    found = verifier.check_cache_contract(lambda: bad_kernel.init_cache(2, 8, 4), bad_kernel.growing_step,
                                          torch.zeros((2, 4)))
    assert "INV-CACHE-SHAPE" in _rules(found)
    _same_findings(found, _reference_cache_findings(reference_bad_kernel, reference_bad_kernel.growing_step))


def test_cache_struct_change_caught(bad_kernel, reference_bad_kernel):
    found = verifier.check_cache_contract(lambda: bad_kernel.init_cache(2, 8, 4),
                                          lambda cache, x: {"k": cache["k"]},  # drops the pos leaf
                                          torch.zeros((2, 4)))
    assert _rules(found) == {"INV-CACHE-STRUCT"}
    _same_findings(found, _reference_cache_findings(reference_bad_kernel, lambda cache, x: {"k": cache["k"]}))


def _cfg(name="granite-8b"):
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant

    return smoke_variant(get_config(name))


def _serving_params(cfg):
    from repro_torch.models import model_zoo as Z

    return Z.prepare_serving_params(Z.init_params(0, cfg, device=CPU), cfg)


def test_pr6_drift_reintroduction_caught():
    """Reintroducing the PR 6 bug (an SSM conv window written in bf16 into
    an f32-initialized slot) in a real model step must be flagged."""
    from repro_torch.models import model_zoo as Z

    cfg = _cfg("mamba2-130m")
    sp = _serving_params(cfg)
    tok = torch.zeros((2,), dtype=torch.int64)

    def drifted_decode(cache, tokens, params):
        _, c = Z.decode_step(params, tokens, cfg, cache)
        c["layers"][0]["conv"] = c["layers"][0]["conv"].to(torch.bfloat16)  # the bug
        return c

    def clean_decode(cache, tokens, params):
        return Z.decode_step(params, tokens, cfg, cache)[1]

    def init():
        return Z.init_cache(2, 32, cfg, device=CPU)

    assert verifier.check_cache_contract(init, clean_decode, tok, sp) == []
    found = verifier.check_cache_contract(init, drifted_decode, tok, sp)
    assert "INV-CACHE-DTYPE" in _rules(found)
    assert any("conv" in f.symbol for f in found)


# ---------------------------------------------------------------------------
# site checks
# ---------------------------------------------------------------------------


def test_site_findings_unnamed_and_bits_and_mantissa():
    cfg = _cfg()
    sites = [
        {"kind": "qlinear", "site": "", "bits": 8, "cfg_bits": 8, "mantissa_dtype": "uint8"},
        {"kind": "qlinear", "site": "ffn.up", "bits": 4, "cfg_bits": 8, "mantissa_dtype": "uint8"},
        {"kind": "qlinear", "site": "ffn.down", "bits": 8, "cfg_bits": 8, "mantissa_dtype": "int32"},
        {"kind": "attn", "site": "attn.qk", "bits": cfg.quant.attn_act_bits, "mantissa_dtype": "int8"},
    ]
    found = verifier._site_findings(sites, cfg, "t")
    assert _rules(found) == {"INV-SITE-NAME", "INV-SITE-BITS", "INV-SITE-MANTISSA"}
    # the same site records draw the same rules from the reference's checker
    assert _rules(JV._site_findings(sites, _reference_cfg(), "t")) == _rules(found)


def _reference_cfg():
    from repro.configs import get_config
    from repro.configs.smoke import smoke_variant

    return smoke_variant(get_config("granite-8b"))


def test_arch_trace_records_named_sites():
    from repro_torch.models import model_zoo as Z

    cfg = _cfg()
    sp = _serving_params(cfg)
    cache = Z.init_cache(2, 32, cfg, device=CPU)
    with torch.no_grad(), site_log.recording() as sites:
        Z.decode_step(sp, torch.zeros((2,), dtype=torch.int64), cfg, cache)
    ql = [s for s in sites if s["kind"] == "qlinear"]
    assert ql, "decode trace recorded no qlinear sites"
    assert all(s["site"] for s in ql)
    assert {"attn"} <= {s["kind"] for s in sites}  # act x act sites too


# ---------------------------------------------------------------------------
# the real-engine sweeps the CLI runs (one arch here; the CLI runs all)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", backend_registry.backend_names(family="qmm"))
def test_backend_sweep_clean(backend):
    """Every *registered* QMM backend runs clean -- enumerated from the
    port's registry, so a new backend joins this sweep with zero test edits.
    For "fused" this is the check that the packed planes flowing into K2 and
    its f32 epilogue exit satisfy the taint rules."""
    found = verifier.verify_backends((backend,), device=CPU)
    assert found == [], render_text(found)


def test_arch_sweep_clean_one_arch():
    found = verifier.verify_arch("mamba2-130m", device=CPU)
    assert found == [], render_text(found)


def test_encoder_only_arch_skipped():
    assert verifier.verify_arch("bit-bert-base", device=CPU) == []


# ---------------------------------------------------------------------------
# the boundary marks
# ---------------------------------------------------------------------------


def test_marks_change_no_value_and_no_launch_count():
    """Under a walk a wrapper computes what it computes without one, and
    its ``launches`` count does not move on the CPU (the plain version runs
    inside the mark); ``out=`` receives the product either way."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-128, 128, (5, 70), generator=gen, dtype=torch.int8)
    w = packing.pack_bits(torch.randint(0, 2, (70, 9), generator=gen, dtype=torch.uint8), 1, axis=0)
    want = ref.binary_qmm_ref(a, w, 70)
    before = K1.binary_qmm.launches
    buf = torch.zeros((2, 5, 9), dtype=torch.int32)
    got = {}

    def run():
        got["plain"] = K1.binary_qmm(a, w, 70)
        got["out"] = K1.binary_qmm(a, w, 70, buf[1])
        got["words"] = packing.pack_bits(a.to(torch.int64) & 1, 1, axis=-1)
        return got["out"].to(torch.float32)

    verifier.CROSSED.clear()
    assert verifier.check_function(run, name="marks") == []
    assert torch.equal(got["plain"], want) and torch.equal(buf[1], want)
    assert got["out"].data_ptr() == buf[1].data_ptr()
    assert torch.equal(got["words"], packing.pack_bits(a.to(torch.int64) & 1, 1, axis=-1))
    assert K1.binary_qmm.launches == before
    assert verifier.CROSSED["binary_qmm"] == 2


def test_kernel_output_through_out_is_counts():
    """The mark holds for a wrapper given ``out=``: the buffer it writes
    holds counts, so rounding it through bf16 is flagged, through f32 not."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-128, 128, (3, 40), generator=gen, dtype=torch.int8)
    bits = torch.randint(0, 2, (40, 4), generator=gen, dtype=torch.uint8)

    def step(dtype):
        buf = torch.zeros((2, 3, 4), dtype=torch.int32)
        K1.binary_qmm(a, packing.pack_bits(bits, 1, axis=0), 40, buf[0])
        return buf.to(dtype)

    assert verifier.check_function(step, torch.float32) == []
    assert _rules(verifier.check_function(step, torch.bfloat16)) == {"INV-ACCUM-LOWFP"}


def test_walk_crosses_each_kernel_site_once():
    """granite-8b smoke on ``pallas``: K1 at each of the 7 linear sites of
    its layer, in the prefill and in the decode step."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="pallas"))
    verifier.CROSSED.clear()
    found = verifier.verify_arch("granite-8b", device=CPU, cfg=cfg)
    assert found == [], render_text(found)
    assert verifier.CROSSED == {"binary_qmm": 2 * 7 * cfg.n_layers}


def test_observer_sees_marked_calls_only_while_observing():
    seen = []

    class Spy:
        def boundary(self, kind, name, fn, args, kwargs):
            seen.append((kind, name))
            return fn(*args, **kwargs)

    x = torch.ones((2, 32), dtype=torch.uint8)
    packing.pack_bits(x, 1)
    with marks.observing(Spy()):
        words = packing.pack_bits(x, 1)
        packing.popcount32(words)
    packing.unpack_bits(words, 1, 32)
    assert seen == [(marks.PACKED, "pack_bits"), (marks.COUNTS, "popcount32")]


def test_verifier_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verifier.verify_backends(("mxu",))
