"""Static analysis of the port (counterpart of ``repro.analysis``): the
invariant verifier over the aten operators a forward issues (Pass 1) and an
AST lint for PyTorch / CUDA-graph pitfalls (Pass 2).  ``python -m
repro_torch.analysis`` runs both; docs/static-analysis-torch.md has the
rule catalog and the allowlist format."""

from repro_torch.analysis.findings import AllowEntry, Allowlist, Finding
from repro_torch.analysis.lint import RULES, lint_file, lint_paths, lint_source
from repro_torch.analysis.verifier import (
    check_cache_contract,
    check_function,
    verify_arch,
    verify_archs,
    verify_backends,
    verify_binary_attention,
)

__all__ = [
    "AllowEntry",
    "Allowlist",
    "Finding",
    "RULES",
    "lint_source",
    "lint_file",
    "lint_paths",
    "check_function",
    "check_cache_contract",
    "verify_arch",
    "verify_archs",
    "verify_backends",
    "verify_binary_attention",
]
