"""Pass 2 -- AST lint over the port's library code for PyTorch / CUDA-graph
pitfalls (port of ``repro.analysis.lint``: the same rule ids, each aimed
at its torch form).

Purely syntactic (``ast`` module, no imports of the scanned code), so it can
run on any Python source -- including the known-bad fixture snippets the
tests seed.  Each rule yields :class:`~repro_torch.analysis.findings.Finding`
objects; the CLI filters them through the checked-in allowlist.

Rule catalog (docs/static-analysis-torch.md has the full rationale):

  RNG001   global NumPy RNG call (``np.random.seed/rand/...``) in library code
  RNG002   the global torch RNG: ``torch.manual_seed``, or a draw
           (``torch.rand*`` / ``randint`` / ``randperm`` / ``normal_`` /
           ``bernoulli`` ...) without ``generator=``; a draw on
           ``device="meta"`` (no values) is exempt
  TIME001  wall-clock call inside a ``with torch.cuda.graph(...)`` block
           (it runs once, at capture; a replay never runs it again)
  TRACE001 Python ``if`` / ``while`` on a tensor reduction (``torch.any`` ...)
           or ``.item()``: a host sync, and a capture breaker
  DTYPE001 hardcoded ``torch.bfloat16`` / ``torch.float16`` literal
           (serve / cache dtypes must derive from the initialised leaf;
           the PR 6 drift bug)
  MUT001   mutable default argument
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Sequence

from repro_torch.analysis.findings import Finding

__all__ = ["RULES", "lint_source", "lint_file", "lint_paths"]


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------


def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node  # type: ignore[attr-defined]


def _ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lint_parent", None)


def _symbol(node: ast.AST) -> str:
    """Dotted chain of enclosing function names ("outer.inner"), or
    "<module>" at module level.  Line-number-free, so allowlist entries
    survive unrelated edits."""
    names = [a.name for a in _ancestors(node) if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        names.insert(0, node.name)
    return ".".join(reversed(names)) or "<module>"


def _chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name expression ("torch.cuda.graph"),
    "" when the expression is not a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _finding(rule: str, node: ast.AST, path: str, message: str, hint: str) -> Finding:
    return Finding(
        rule=rule,
        path=path,
        line=getattr(node, "lineno", 0),
        symbol=_symbol(node),
        message=message,
        hint=hint,
    )


def _keyword(call: ast.Call, name: str) -> Optional[ast.AST]:
    return next((k.value for k in call.keywords if k.arg == name), None)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

_GLOBAL_RNG_FNS = {
    "seed",
    "rand",
    "randn",
    "randint",
    "random",
    "normal",
    "uniform",
    "choice",
    "permutation",
    "shuffle",
    "standard_normal",
}


def _rule_rng001(tree: ast.AST, path: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _chain(node.func)
        parts = chain.split(".")
        if (
            len(parts) == 3
            and parts[0] in ("np", "numpy")
            and parts[1] == "random"
            and parts[2] in _GLOBAL_RNG_FNS
        ):
            yield _finding(
                "RNG001",
                node,
                path,
                f"global NumPy RNG call {chain}() — hidden process-wide state",
                "use an explicit np.random.default_rng(seed) Generator",
            )


#: seeding the process-wide torch generators
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
#: ``torch.<fn>(...)`` draws (they take ``generator=``; the ``_like`` ones
#: cannot, and always draw from the global generator)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like", "randint_like",
                "normal", "bernoulli", "multinomial", "poisson"}
#: in-place draws, a method of any tensor
_METHOD_DRAWS = {"normal_", "bernoulli_", "uniform_", "random_", "exponential_", "geometric_",
                 "log_normal_", "cauchy_"}


def _meta_draw(call: ast.Call) -> bool:
    dev = _keyword(call, "device")
    return isinstance(dev, ast.Constant) and dev.value == "meta"


def _rule_rng002(tree: ast.AST, path: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _chain(node.func)
        if chain in _GLOBAL_SEEDS:
            yield _finding(
                "RNG002",
                node,
                path,
                f"{chain}() seeds the process-wide torch generator in library code",
                "make a torch.Generator(device) seeded from the caller's seed and pass it "
                "as generator=",
            )
            continue
        parts = chain.split(".")
        draw = (len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS) or (
            isinstance(node.func, ast.Attribute) and node.func.attr in _METHOD_DRAWS
        )
        if not draw or _keyword(node, "generator") is not None or _meta_draw(node):
            continue
        name = chain or f".{node.func.attr}"
        yield _finding(
            "RNG002",
            node,
            path,
            f"{name}() draws from the process-wide torch generator",
            "pass generator= (a torch.Generator seeded from the caller); draws on "
            "device='meta' are exempt (no values)",
        )


_WALLCLOCK = {"time.time", "time.perf_counter", "time.monotonic", "time.time_ns",
              "time.perf_counter_ns", "time.monotonic_ns"}


def _captures(node: ast.AST) -> bool:
    """Is ``node`` a ``with`` statement that captures a CUDA graph?"""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and _chain(expr.func) in ("torch.cuda.graph", "cuda.graph"):
            return True
    return False


def _rule_time001(tree: ast.AST, path: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _chain(node.func) not in _WALLCLOCK:
            continue
        if any(_captures(a) for a in _ancestors(node)):
            yield _finding(
                "TIME001",
                node,
                path,
                f"{_chain(node.func)}() inside a torch.cuda.graph capture -- it runs once, at "
                "capture; a replay never runs it again",
                "time outside the captured region (callers own the clock, around replays)",
            )


_TENSOR_REDUCERS = {
    "any",
    "all",
    "sum",
    "max",
    "min",
    "mean",
    "isnan",
    "isinf",
    "isfinite",
    "count_nonzero",
    "equal",
    "allclose",
}


def _host_sync(call: ast.Call) -> Optional[str]:
    """The name of a tensor reduction or ``.item()`` the call is, else None."""
    chain = _chain(call.func)
    parts = chain.split(".")
    if len(parts) >= 2 and parts[0] == "torch" and parts[-1] in _TENSOR_REDUCERS:
        return chain
    if isinstance(call.func, ast.Attribute) and call.func.attr == "item" and not call.args:
        return ".item"
    return None


def _rule_trace001(tree: ast.AST, path: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
            continue
        for sub in ast.walk(node.test):
            name = _host_sync(sub) if isinstance(sub, ast.Call) else None
            if name:
                yield _finding(
                    "TRACE001",
                    node,
                    path,
                    f"Python branch on a tensor value {name}(...) -- a host sync, and an "
                    "error while a CUDA graph captures",
                    "use torch.where, or hoist the check out of the step",
                )
                break  # one finding per branch statement


_DTYPE_LITERALS = {"torch.bfloat16", "torch.float16", "torch.half"}


def _rule_dtype001(tree: ast.AST, path: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and _chain(node) in _DTYPE_LITERALS:
            yield _finding(
                "DTYPE001",
                node,
                path,
                f"hardcoded low-precision dtype literal {_chain(node)}",
                "derive the dtype from the tensor it must match (cache[...].dtype / x.dtype) -- "
                "a literal here is how the PR 6 cache-dtype drift happened; allowlist "
                "declaration sites and config gates",
            )


def _rule_mut001(tree: ast.AST, path: str) -> Iterator[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and _chain(d.func) in ("list", "dict", "set")
            )
            if mutable:
                yield _finding(
                    "MUT001",
                    d,
                    path,
                    f"mutable default argument in {node.name}()",
                    "default to None and construct inside the function body",
                )


RULES: Dict[str, dict] = {
    "RNG001": {"title": "global NumPy RNG in library code", "fn": _rule_rng001},
    "RNG002": {"title": "global torch RNG (manual_seed, a draw without generator=)",
               "fn": _rule_rng002},
    "TIME001": {"title": "wall-clock read inside a CUDA-graph capture", "fn": _rule_time001},
    "TRACE001": {"title": "Python branch on a tensor reduction or .item()", "fn": _rule_trace001},
    "DTYPE001": {"title": "hardcoded bf16/f16 dtype literal", "fn": _rule_dtype001},
    "MUT001": {"title": "mutable default argument", "fn": _rule_mut001},
}


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str, rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one source string; ``path`` is the repo-relative name reported."""
    tree = ast.parse(source, filename=path)
    _attach_parents(tree)
    out: List[Finding] = []
    for rid in rules or RULES:
        out.extend(RULES[rid]["fn"](tree, path))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_file(path: str, root: str = ".", rules: Optional[Sequence[str]] = None) -> List[Finding]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), rel, rules)


def lint_paths(src: str, root: str = ".", rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every ``*.py`` under ``src`` (a file path is also accepted)."""
    if os.path.isfile(src):
        return lint_file(src, root, rules)
    out: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(src):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.extend(lint_file(os.path.join(dirpath, name), root, rules))
    return out
