"""CLI: ``python -m repro_torch.analysis`` -- run both passes, exit 1 on
findings (port of ``python -m repro.analysis``).

Default run = AST lint over ``src/repro_torch`` + the invariant verifier
over every registered QMM backend, every assigned model-zoo arch at smoke
size and the bitwise-attention path, on the card, filtered through
``src/repro_torch/analysis/allowlist.toml``.  Any surviving finding (or a
stale allowlist entry) exits nonzero.

Useful subsets:
  --skip-verifier / --skip-lint     run one pass only
  --src PATH                        lint a different tree or a single file
  --backends mxu,pallas             restrict the backend sweep
  --archs granite-8b,whisper-tiny   restrict the arch sweep
  --format json                     machine-readable findings
  --self-test                       prove the checker still detects the seeded
                                    known-bad fixtures
  --device cpu                      verify on the CPU (default: the card)
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import findings as F
from repro_torch.analysis import lint

_REPO_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..")
)


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="quantization-invariant verifier + PyTorch / CUDA-graph lint of the port",
    )
    p.add_argument(
        "--src",
        default=os.path.join(_REPO_ROOT, "src", "repro_torch"),
        help="tree (or single file) to lint [default: src/repro_torch]",
    )
    p.add_argument("--root", default=_REPO_ROOT, help="root that reported paths are made relative to")
    p.add_argument(
        "--allowlist",
        default=os.path.join(_REPO_ROOT, "src", "repro_torch", "analysis", "allowlist.toml"),
        help="allowlist TOML ('' disables) [default: src/repro_torch/analysis/allowlist.toml]",
    )
    p.add_argument("--skip-lint", action="store_true", help="skip the AST pass")
    p.add_argument("--skip-verifier", action="store_true", help="skip the trace pass")
    p.add_argument("--backends", default="", help="comma-separated backend subset for the QMM sweep")
    p.add_argument("--archs", default="", help="comma-separated model-zoo arch subset for the serving sweep")
    p.add_argument("--rules", default="", help="comma-separated lint rule subset (RNG001,...)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--list-rules", action="store_true", help="print the lint rule catalog")
    p.add_argument(
        "--self-test",
        action="store_true",
        help="run the passes against the seeded known-bad fixtures and fail unless every "
        "expected finding class is detected",
    )
    p.add_argument("--device", default="cuda", help="where the verifier runs the traces [default: cuda]")
    return p.parse_args(argv)


def _collect(args):
    all_findings = []
    if not args.skip_lint:
        rules = [r for r in args.rules.split(",") if r] or None
        all_findings.extend(lint.lint_paths(args.src, root=args.root, rules=rules))
    if not args.skip_verifier:
        from repro_torch.analysis import verifier

        backends = tuple(b for b in args.backends.split(",") if b) or None
        archs = tuple(a for a in args.archs.split(",") if a) or None
        all_findings.extend(verifier.verify_backends(backends, device=args.device))
        all_findings.extend(verifier.verify_archs(archs, device=args.device))
        if backends is None and archs is None:
            # full sweep: also the bitwise-attention engagement (the scores
            # backend family has its own calling convention, and
            # bit-bert-base is encoder-family so the arch sweep skips it)
            all_findings.extend(verifier.verify_binary_attention(device=args.device))
    return all_findings


def _self_test(args) -> int:
    """The checker checking itself: the seeded fixtures MUST trip it."""
    from repro_torch.analysis import selftest

    failures = selftest.run(_REPO_ROOT, device=args.device)
    for msg in failures:
        print(f"self-test FAIL: {msg}")
    if failures:
        return 1
    print("self-test OK: all seeded fixtures detected")
    return 0


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)

    if args.list_rules:
        for rid, meta in lint.RULES.items():
            print(f"{rid}  {meta['title']}")
        return 0

    if args.self_test:
        return _self_test(args)

    found = _collect(args)

    stale = []
    suppressed = []
    if args.allowlist and os.path.exists(args.allowlist):
        allow = F.Allowlist.load(args.allowlist)
        found, suppressed = allow.filter(found)
        # staleness is only meaningful on a full run: a subset run (one pass,
        # one rule, one arch...) legitimately produces no hits for most entries
        full_run = not (args.skip_lint or args.skip_verifier or args.rules or args.backends
                        or args.archs)
        if full_run:
            stale = allow.stale_entries()

    if args.format == "json":
        print(F.render_json(found, suppressed))
    else:
        print(F.render_text(found, suppressed, stale))

    # findings fail by default; a stale allowlist entry is also a failure
    # (it means the justified hit it documented no longer exists)
    return 1 if (found or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
