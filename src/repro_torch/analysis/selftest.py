"""Self-test: prove the checker still detects the seeded known-bad fixtures
(port of ``repro.analysis.selftest``).

A static checker that silently stops finding things is worse than no
checker, so ``python -m repro_torch.analysis --self-test`` fails whenever a
change to the lint rules or the taint walk loses detection power.  The
fixtures live in ``tests/torch_analysis_fixtures/`` (outside
``src/repro_torch``, the lint's default tree); the verifier's cases run on
the device given (the card by default).
"""

from __future__ import annotations

import functools
import importlib.util
import os
from typing import List

import torch

from repro_torch.analysis import lint, verifier

#: every lint rule must fire on lint_bad.py
_EXPECT_LINT = ("RNG001", "RNG002", "TIME001", "TRACE001", "DTYPE001", "MUT001")

FIXTURES = os.path.join("tests", "torch_analysis_fixtures")


def load_fixture_module(path: str):
    """Import a fixture file by path without touching sys.path."""
    spec = importlib.util.spec_from_file_location("torch_analysis_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _words(shape, gen, dev) -> torch.Tensor:
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32, device=dev)


def run(repo_root: str, device=None) -> List[str]:
    """Returns failure messages; an empty list means every seeded bug was
    detected.  ``device`` defaults to the card."""
    dev = verifier._device(device)
    fixtures = os.path.join(repo_root, FIXTURES)
    failures: List[str] = []

    # ---- lint pass detects every rule on the bad fixture ----
    bad = lint.lint_file(os.path.join(fixtures, "lint_bad.py"), root=repo_root)
    fired = {f.rule for f in bad}
    for rule in _EXPECT_LINT:
        if rule not in fired:
            failures.append(f"lint rule {rule} did not fire on lint_bad.py")

    # ---- and stays quiet on the good fixture ----
    good = lint.lint_file(os.path.join(fixtures, "lint_good.py"), root=repo_root)
    for f in good:
        failures.append(f"false positive on lint_good.py: {f.rule} at line {f.line}")

    # ---- the taint walk detects every seeded kernel bug ----
    K = load_fixture_module(os.path.join(fixtures, "bad_kernel.py"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = _words((8, 2), gen, dev)
    # torch has no integer matmul on the card (int8 @ int8 raises there), so
    # the low-precision dot runs shape-only on meta there: the rule reads
    # the operator's operand and result dtypes, not its values
    dot_dev = torch.device("meta") if dev.type == "cuda" else dev
    i8 = dict(dtype=torch.int8, device=dot_dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cases = [
        ("INV-PACKED-FLOAT",
         lambda: verifier.check_function(K.leak_packed_to_float, w, packed_argnums=(0,))),
        ("INV-ACCUM-LOWFP",
         lambda: verifier.check_function(K.accumulate_in_bf16, w, w, packed_argnums=(0, 1))),
        # the same rule at the trusted kernel boundary: a kernel fed packed
        # planes may exit int (counts) or f32 (fused epilogue), never bf16/f16
        ("INV-ACCUM-LOWFP",
         lambda: verifier.check_function(K.fused_kernel_lowfp, w, w, packed_argnums=(0, 1))),
        # the attention-shaped variant: rank-4 packed planes, the score
        # accumulation rounded through bfloat16
        ("INV-ACCUM-LOWFP",
         lambda: verifier.check_function(K.binary_attn_lowfp, _words((1, 2, 4, 2), gen, dev),
                                         _words((1, 2, 3, 2), gen, dev), packed_argnums=(0, 1))),
        ("INV-INT-DOT",
         lambda: verifier.check_function(K.int_dot_low_precision, torch.ones((4, 8), **i8),
                                         torch.ones((8, 4), **i8))),
        ("INV-CACHE-DTYPE",
         lambda: verifier.check_cache_contract(lambda: K.init_cache(2, 8, 4, dev), K.drifting_step,
                                               torch.zeros((2, 4), **f32))),
        ("INV-CACHE-SHAPE",
         lambda: verifier.check_cache_contract(lambda: K.init_cache(2, 8, 4, dev), K.growing_step,
                                               torch.zeros((2, 4), **f32))),
    ]
    for rule, thunk in cases:
        got = {f.rule for f in thunk()}
        if rule not in got:
            failures.append(
                f"verifier did not flag {rule} on the bad_kernel fixture (got: {sorted(got) or 'nothing'})"
            )

    # ---- and the real fused kernel's path passes the taint rules ----
    # (K2 consumes packed planes and exits f32 -- the legal fused-epilogue
    # exit; INV-PACKED-FLOAT / INV-ACCUM-LOWFP stay quiet)
    for f in verifier.verify_backends(("fused",), device=dev):
        failures.append(f"fused kernel path not clean: {f.rule} {f.message}")

    # ---- same for the real bitwise-attention cores: every scores-family
    # backend consumes packed planes and exits int32 counts, cleanly ----
    from repro_torch.core import backend_registry

    q, k = _words((1, 4, 6, 2), gen, dev), _words((1, 2, 5, 2), gen, dev)
    q[..., -1] &= 0xFFFF  # zero bits past dh = 48, as packing leaves them
    k[..., -1] &= 0xFFFF
    for name in backend_registry.backend_names(family="scores"):
        spec = backend_registry.get_backend(name)
        for f in verifier.check_function(functools.partial(spec.run_scores, dh=48), q, k,
                                         name=f"scores:{name}", packed_argnums=(0, 1)):
            failures.append(f"scores core {name} path not clean: {f.rule} {f.message}")
    return failures
