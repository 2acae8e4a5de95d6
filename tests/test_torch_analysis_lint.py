"""The port's AST lint (``repro_torch.analysis.lint``): per-rule fixtures
(``tests/torch_analysis_fixtures/``), each rule's torch form, RNG001 and
MUT001 (unchanged from the reference) equal to the reference's
``lint_source`` on the same source text, allowlist load / match /
staleness, and the gate: the port's tree clean under its allowlist."""

import os
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import findings as F
from repro_torch.analysis import lint

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
ALLOWLIST = os.path.join(REPO, "src", "repro_torch", "analysis", "allowlist.toml")
RULE_IDS = ["RNG001", "RNG002", "TIME001", "TRACE001", "DTYPE001", "MUT001"]


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# fixtures: every rule fires on the bad file, none on the good file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", RULE_IDS)
def test_rule_fires_on_bad_fixture(rule):
    found = lint.lint_file(os.path.join(FIXTURES, "lint_bad.py"), root=REPO)
    assert rule in _rules(found), f"{rule} missed its seeded fixture"


def test_good_fixture_is_clean():
    found = lint.lint_file(os.path.join(FIXTURES, "lint_good.py"), root=REPO)
    assert found == [], [f"{f.rule}:{f.line}" for f in found]


def test_bad_fixture_paths_are_repo_relative():
    found = lint.lint_file(os.path.join(FIXTURES, "lint_bad.py"), root=REPO)
    assert found and all(f.path == "tests/torch_analysis_fixtures/lint_bad.py" for f in found)


def test_rule_catalog_is_the_references():
    assert list(lint.RULES) == list(ref_lint.RULES)


# ---------------------------------------------------------------------------
# targeted rule behavior
# ---------------------------------------------------------------------------


def _lint(src, rules=None):
    return lint.lint_source(textwrap.dedent(src), "t.py", rules)


def test_rng002_meta_draws_exempt():
    found = _lint(
        """
        import torch
        def shapes():
            return torch.randn((4, 4), device="meta")
        def values():
            return torch.randn((4, 4), device="cpu")
        """,
        ["RNG002"],
    )
    assert [f.symbol for f in found] == ["values"]


def test_rng002_generator_threaded_ok():
    found = _lint(
        """
        import torch
        def make(seed, x):
            gen = torch.Generator()
            gen.manual_seed(seed)
            x.normal_(generator=gen)
            return torch.randint(0, 9, (4,), generator=gen), torch.randperm(4, generator=gen)
        """,
        ["RNG002"],
    )
    assert found == []


def test_rng002_global_seed_and_draws():
    found = _lint(
        """
        import torch
        def f(x):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            x.bernoulli_(0.5)
            return torch.rand(3), torch.bernoulli(x), torch.randn_like(x)
        """,
        ["RNG002"],
    )
    assert len(found) == 6


def test_time001_only_inside_a_graph_capture():
    found = _lint(
        """
        import time, torch
        def wall():
            return time.time()
        def captured(g, step, x):
            with torch.cuda.graph(g):
                y = step(x)
                t = time.perf_counter()
            return y, t
        """,
        ["TIME001"],
    )
    assert [f.symbol for f in found] == ["captured"]


def test_trace001_one_finding_per_branch():
    found = _lint(
        """
        import torch
        def f(x):
            if torch.any(x) and torch.all(x):
                return x
        """,
        ["TRACE001"],
    )
    assert len(found) == 1


def test_trace001_flags_item_and_conditional_expressions():
    found = _lint(
        """
        def f(x):
            y = x if x.sum().item() > 0 else -x
            while x.max().item() < 1.0:
                x = x * 2
            return y
        """,
        ["TRACE001"],
    )
    assert len(found) == 2


def test_trace001_ignores_dtype_introspection():
    # dtype and device questions are answered on the host, no sync
    found = _lint(
        """
        import torch
        def f(x):
            if torch.is_floating_point(x) or x.dtype == torch.int8 or x.is_cuda:
                return x
        """,
        ["TRACE001"],
    )
    assert found == []


def test_dtype001_literals_not_derived_dtypes():
    found = _lint(
        """
        import torch
        def f(x, cache):
            return x.to(torch.float16), x.to(cache["k"].dtype), x.to(torch.half)
        """,
        ["DTYPE001"],
    )
    assert len(found) == 2


def test_symbol_is_nested_dotted_chain():
    found = _lint(
        """
        import numpy as np
        def outer():
            def inner():
                np.random.seed(0)
            return inner
        """,
        ["RNG001"],
    )
    assert found[0].symbol == "outer.inner"


def test_mut001_kwonly_defaults():
    found = _lint("def f(x, *, t={}):\n    return t\n", ["MUT001"])
    assert _rules(found) == {"MUT001"}


@pytest.mark.parametrize("source", [
    os.path.join(FIXTURES, "lint_bad.py"),
    os.path.join(REPO, "analysis", "fixtures", "lint_bad.py"),
    os.path.join(REPO, "src", "repro_torch", "runtime", "serve_loop.py"),
], ids=["torch_fixture", "reference_fixture", "serve_loop"])
def test_unchanged_rules_equal_the_references(source):
    """RNG001 and MUT001 are the reference's rules unchanged: on the same
    source text the port's findings are the reference's, field by field."""
    with open(source, encoding="utf-8") as f:
        text = f.read()
    rules = ["RNG001", "MUT001"]
    got = lint.lint_source(text, "x.py", rules)
    want = ref_lint.lint_source(text, "x.py", rules)
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


# ---------------------------------------------------------------------------
# allowlist
# ---------------------------------------------------------------------------


def _entry(**kw):
    base = dict(rule="DTYPE001", file="src/*.py", symbol="*", reason="r")
    base.update(kw)
    return F.AllowEntry(**base)


def _finding(**kw):
    base = dict(rule="DTYPE001", path="src/a.py", line=3, symbol="f", message="m")
    base.update(kw)
    return F.Finding(**base)


def test_allowlist_filter_and_stale():
    allow = F.Allowlist([_entry(), _entry(rule="MUT001", file="never/*")])
    kept, suppressed = allow.filter([_finding(), _finding(rule="RNG001")])
    assert [f.rule for f in kept] == ["RNG001"]
    assert [f.rule for f in suppressed] == ["DTYPE001"]
    assert [e.rule for e in allow.stale_entries()] == ["MUT001"]


def test_allowlist_symbol_pattern():
    allow = F.Allowlist([_entry(symbol="init_*")])
    kept, suppressed = allow.filter([_finding(symbol="init_cache"), _finding(symbol="decode")])
    assert [f.symbol for f in kept] == ["decode"]
    assert [f.symbol for f in suppressed] == ["init_cache"]


def test_allowlist_rejects_missing_reason(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\nrule = "DTYPE001"\nfile = "a"\nsymbol = "b"\n')
    with pytest.raises(ValueError, match="reason"):
        F.Allowlist.load(str(p))


def test_checked_in_allowlist_loads():
    allow = F.Allowlist.load(ALLOWLIST)
    assert allow.entries
    assert all(e.reason for e in allow.entries)


def test_stale_entry_fails_a_full_run(tmp_path, monkeypatch, capsys):
    """An entry that matches nothing fails a full run (it documents a
    justified hit that no longer exists); a subset run does not judge
    staleness.  The verifier's sweeps are stubbed: this is the CLI's
    allowlist handling."""
    from repro_torch.analysis import verifier
    from repro_torch.analysis.__main__ import main

    for name in ("verify_backends", "verify_archs", "verify_binary_attention"):
        monkeypatch.setattr(verifier, name, lambda *a, **k: [])
    stale = tmp_path / "allow.toml"
    with open(ALLOWLIST, encoding="utf-8") as f:
        stale.write_text(f.read() + '\n[[allow]]\nrule = "MUT001"\nfile = "src/repro_torch/nowhere.py"\n'
                         'symbol = "f"\nreason = "gone"\n')
    assert main(["--device", "cpu"]) == 0
    assert main(["--device", "cpu", "--allowlist", str(stale)]) == 1
    assert "stale allowlist entry" in capsys.readouterr().out
    assert main(["--device", "cpu", "--skip-verifier", "--allowlist", str(stale)]) == 0


# ---------------------------------------------------------------------------
# the gate: the port's tree is clean modulo its allowlist
# ---------------------------------------------------------------------------


def test_src_tree_clean_under_allowlist():
    found = lint.lint_paths(os.path.join(REPO, "src", "repro_torch"), root=REPO)
    allow = F.Allowlist.load(ALLOWLIST)
    kept, _ = allow.filter(found)
    assert kept == [], F.render_text(kept)
    assert allow.stale_entries() == [], "stale allowlist entries"
