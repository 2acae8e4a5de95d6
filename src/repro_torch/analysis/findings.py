"""Finding / allowlist plumbing shared by the lint and verifier passes
(port of ``repro.analysis.findings``).

A :class:`Finding` is one rule violation: a stable rule id, the file (or
trace) it was found in, a line (0 for trace-level findings, which have no
source line), the enclosing symbol, a message, and a fix hint.

``src/repro_torch/analysis/allowlist.toml`` suppresses *justified* hits so
a run fails only on new ones.  Entries match on ``rule`` + ``file`` (fnmatch) +
``symbol`` (fnmatch) — never on line numbers, which churn with every edit —
and must carry a non-empty ``reason``.  Entries that match nothing are
reported as stale so the allowlist cannot silently rot.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, List, Sequence, Tuple

import tomllib as _toml

__all__ = ["Finding", "AllowEntry", "Allowlist", "render_text", "render_json"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (lint or trace invariant)."""

    rule: str  # "RNG001" | "INV-PACKED-FLOAT" | ...
    path: str  # repo-relative file path, or "trace:<trace>" for the verifier
    line: int  # 1-based source line; 0 for trace findings
    symbol: str  # dotted enclosing function(s), or the trace name
    message: str
    hint: str = ""

    def location(self) -> str:
        if self.line:
            return f"{self.path}:{self.line}"
        return self.path

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    rule: str
    file: str  # fnmatch pattern over Finding.path
    symbol: str  # fnmatch pattern over Finding.symbol
    reason: str

    def matches(self, f: Finding) -> bool:
        return (
            f.rule == self.rule
            and fnmatch.fnmatchcase(f.path, self.file)
            and fnmatch.fnmatchcase(f.symbol, self.symbol)
        )


class Allowlist:
    """Checked-in suppressions (``[[allow]]`` entries in a TOML file)."""

    def __init__(self, entries: Sequence[AllowEntry] = ()):
        self.entries: Tuple[AllowEntry, ...] = tuple(entries)
        self._hits: Dict[AllowEntry, int] = {e: 0 for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        with open(path, "rb") as f:
            data = _toml.load(f)
        raw = data.get("allow", [])
        if not isinstance(raw, list):
            raise ValueError(f"{path}: 'allow' must be an array of tables")
        entries = []
        for i, item in enumerate(raw):
            missing = [
                k for k in ("rule", "file", "symbol", "reason") if not item.get(k)
            ]
            if missing:
                raise ValueError(
                    f"{path}: [[allow]] entry {i} missing/empty field(s): {missing}"
                )
            entries.append(
                AllowEntry(
                    rule=item["rule"],
                    file=item["file"],
                    symbol=item["symbol"],
                    reason=item["reason"],
                )
            )
        return cls(entries)

    def filter(self, findings: Sequence[Finding]) -> Tuple[List[Finding], List[Finding]]:
        """Split findings into (kept, suppressed), recording entry hit counts."""
        kept: List[Finding] = []
        suppressed: List[Finding] = []
        for f in findings:
            entry = next((e for e in self.entries if e.matches(f)), None)
            if entry is None:
                kept.append(f)
            else:
                self._hits[entry] += 1
                suppressed.append(f)
        return kept, suppressed

    def stale_entries(self) -> List[AllowEntry]:
        """Entries that matched nothing across every ``filter`` call so far."""
        return [e for e, n in self._hits.items() if n == 0]


def render_text(
    findings: Sequence[Finding],
    suppressed: Sequence[Finding] = (),
    stale: Sequence[AllowEntry] = (),
) -> str:
    lines: List[str] = []
    for f in findings:
        sym = f" ({f.symbol})" if f.symbol else ""
        lines.append(f"{f.rule} {f.location()}{sym}: {f.message}")
        if f.hint:
            lines.append(f"    hint: {f.hint}")
    if suppressed:
        lines.append(f"-- {len(suppressed)} finding(s) suppressed by allowlist")
    for e in stale:
        lines.append(
            f"-- stale allowlist entry (matched nothing): "
            f"rule={e.rule} file={e.file} symbol={e.symbol}"
        )
    lines.append(
        f"{len(findings)} finding(s)"
        + (f", {len(suppressed)} suppressed" if suppressed else "")
    )
    return "\n".join(lines)


def render_json(
    findings: Sequence[Finding], suppressed: Sequence[Finding] = ()
) -> str:
    return json.dumps(
        {
            "findings": [f.to_dict() for f in findings],
            "suppressed": [f.to_dict() for f in suppressed],
        },
        indent=2,
    )
