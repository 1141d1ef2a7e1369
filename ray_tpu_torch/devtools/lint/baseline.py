"""The ``.graftlint.toml`` suppression baseline.

Accepted violations live in one checked-in file at the repo root so every
exception to an invariant is explicit, reviewed, and diffable::

    version = 1

    [[suppress]]
    check = "retry-gate"
    path = "ray_tpu_torch/_private/worker.py"
    symbol = "ReferenceTracker._ensure_flusher_locked"
    reason = "fixed-cadence background flusher, not a retry loop"

Matching is by ``(check, path)`` plus, when present, ``symbol`` and
``tag`` — line numbers are deliberately NOT part of identity so baselines
survive unrelated edits.  ``reason`` is mandatory: a reasonless entry
fails the load.  Entries that match nothing are reported so the baseline
can only shrink as fixes land.

Python 3.10 has no ``tomllib``; since we also must not add third-party
deps, ``_parse_toml`` implements the small TOML subset the baseline
uses (top-level scalars + ``[[suppress]]`` array-of-tables with string/
int/bool values).  When ``tomllib`` exists it is preferred.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.devtools.lint.core import Violation

__all__ = ["Baseline", "BaselineError", "load", "write"]

DEFAULT_NAME = ".graftlint.toml"


class BaselineError(ValueError):
    pass


_KV_RE = re.compile(r"^([A-Za-z0-9_\-]+)\s*=\s*(.+)$")


def _parse_value(raw: str, lineno: int):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        body = raw[1:-1]
        return re.sub(
            r"\\(.)",
            lambda m: {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(
                m.group(1), m.group(1)
            ),
            body,
        )
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        raise BaselineError(f"line {lineno}: unsupported TOML value: {raw!r}")


def _parse_toml(text: str) -> dict:
    try:
        import tomllib  # Python >= 3.11
    except ModuleNotFoundError:
        tomllib = None
    if tomllib is not None:
        try:
            return tomllib.loads(text)
        except tomllib.TOMLDecodeError as e:
            # Same friendly "bad baseline" path on every Python version.
            raise BaselineError(str(e))
    doc: dict = {}
    current: dict = doc
    for i, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("[[") and stripped.endswith("]]"):
            name = stripped[2:-2].strip()
            current = {}
            doc.setdefault(name, []).append(current)
            continue
        if stripped.startswith("[") and stripped.endswith("]"):
            name = stripped[1:-1].strip()
            current = doc.setdefault(name, {})
            continue
        m = _KV_RE.match(stripped)
        if not m:
            raise BaselineError(f"line {i}: cannot parse: {stripped!r}")
        # Strip a trailing comment from unquoted values.
        val = m.group(2)
        if not val.lstrip().startswith('"') and "#" in val:
            val = val.split("#", 1)[0]
        current[m.group(1)] = _parse_value(val, i)
    return doc


@dataclass
class Entry:
    check: str
    path: str
    reason: str
    symbol: Optional[str] = None
    tag: Optional[str] = None
    used: bool = field(default=False, compare=False)

    def matches(self, v: Violation) -> bool:
        if self.check != v.check or self.path != v.path:
            return False
        if self.symbol is not None and self.symbol != v.symbol:
            return False
        if self.tag is not None and self.tag != v.tag:
            return False
        return True

    def as_dict(self) -> dict:
        d = {"check": self.check, "path": self.path}
        if self.symbol is not None:
            d["symbol"] = self.symbol
        if self.tag is not None:
            d["tag"] = self.tag
        d["reason"] = self.reason
        return d


@dataclass
class Baseline:
    path: Optional[str]
    entries: List[Entry] = field(default_factory=list)

    def apply(self, violations: List[Violation]) -> List[dict]:
        """Mark matching violations suppressed; return the entries that
        matched nothing (as dicts, for the 'stale baseline' report)."""
        for v in violations:
            if v.check == "bad-suppression":
                continue
            for e in self.entries:
                if e.matches(v):
                    v.suppressed_by = "baseline"
                    e.used = True
                    break
        return [e.as_dict() for e in self.entries if not e.used]


def load(path: str) -> Baseline:
    with open(path, "r", encoding="utf-8") as fh:
        doc = _parse_toml(fh.read())
    entries: List[Entry] = []
    for i, raw in enumerate(doc.get("suppress", [])):
        if not isinstance(raw, dict):
            raise BaselineError(f"suppress[{i}]: expected a table")
        check = raw.get("check")
        rel = raw.get("path")
        reason = raw.get("reason")
        if not check or not rel:
            raise BaselineError(f"suppress[{i}]: 'check' and 'path' are required")
        if not isinstance(reason, str) or not reason.strip():
            raise BaselineError(
                f"suppress[{i}] ({check} @ {rel}): every baseline entry must "
                "carry a human-readable 'reason'"
            )
        entries.append(
            Entry(
                check=str(check),
                path=str(rel),
                reason=reason.strip(),
                symbol=raw.get("symbol"),
                tag=raw.get("tag"),
            )
        )
    return Baseline(path=path, entries=entries)


def load_default(root: str) -> Optional[Baseline]:
    p = os.path.join(root, DEFAULT_NAME)
    return load(p) if os.path.exists(p) else None


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def write(path: str, violations: List[Violation], reason: str = "TODO: justify") -> int:
    """Write a baseline covering ``violations`` (bootstrap helper for
    ``--write-baseline``).  Collapses duplicates by suppression key."""
    seen = set()
    lines = [
        "# graftlint suppression baseline — every entry needs a reason.",
        "# Format: docs/static_analysis.md",
        "version = 1",
    ]
    n = 0
    for v in sorted(violations, key=lambda v: (v.path, v.check, v.symbol, v.tag)):
        key = v.key()
        if key in seen:
            continue
        seen.add(key)
        lines += [
            "",
            "[[suppress]]",
            f"check = {_quote(v.check)}",
            f"path = {_quote(v.path)}",
        ]
        if v.symbol != "<module>":
            lines.append(f"symbol = {_quote(v.symbol)}")
        if v.tag:
            lines.append(f"tag = {_quote(v.tag)}")
        lines.append(f"reason = {_quote(reason)}")
        n += 1
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return n
