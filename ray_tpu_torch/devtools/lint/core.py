"""graftlint engine: file walking, AST modules, suppressions, reporting.

Two checker shapes plug in (see ``checkers/__init__.py``):

- **module checkers** — ``check(module) -> Iterable[Violation]``; run once
  per parsed file.  Purely local reasoning (retry loops, thread spawns,
  generation keys, handler reachability within a module).
- **project checkers** — ``check_project(project) -> Iterable[Violation]``;
  run once with every parsed module in hand.  Cross-module reasoning
  (the lock acquisition graph, the metrics catalog diff).

Violations are identified for suppression purposes by
``(check, path, symbol, tag)`` — the *symbol* is the enclosing function/
class qualname and the *tag* a checker-chosen stable discriminator — so
baselines survive unrelated line drift.  Two suppression channels:

- inline: ``# graftlint: disable=<check>[,<check>] -- <reason>`` on the
  flagged line, or standing alone on the line above.  A disable comment
  without a reason is itself a violation (``bad-suppression``).
- baseline: ``[[suppress]]`` entries in ``.graftlint.toml`` at the repo
  root (see baseline.py); every entry must carry a reason.
"""

from __future__ import annotations

import ast
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Violation",
    "Module",
    "Project",
    "LintResult",
    "run_lint",
    "repo_root_for",
]

_DISABLE_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\-* ]+?)\s*(?:--\s*(.*\S))?\s*$"
)


@dataclass
class Violation:
    """One finding.  ``path`` is repo-root-relative with posix separators."""

    check: str
    path: str
    line: int
    message: str
    symbol: str = "<module>"
    tag: str = ""
    # Filled in by the engine: how this violation was suppressed (if it was).
    suppressed_by: Optional[str] = None  # "inline" | "baseline" | None

    def key(self) -> Tuple[str, str, str, str]:
        return (self.check, self.path, self.symbol, self.tag)

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol != "<module>" else ""
        return f"{self.path}:{self.line}: {self.check}:{sym} {self.message}"


class Module:
    """One parsed source file plus the derived maps checkers need."""

    def __init__(self, abspath: str, relpath: str, source: str, tree: ast.AST):
        self.abspath = abspath
        self.relpath = relpath  # posix, relative to the repo root
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        self._qualnames: Optional[Dict[ast.AST, str]] = None
        # line -> (set of check names or {"*"}, reason or None)
        self.inline_disables: Dict[int, Tuple[set, Optional[str]]] = {}
        self.bad_suppressions: List[Violation] = []
        self._scan_inline_suppressions()

    # -- inline suppressions ------------------------------------------------
    def _scan_inline_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(line)
            if not m:
                continue
            checks = {c.strip() for c in m.group(1).split(",") if c.strip()}
            reason = m.group(2)
            # A comment-only line suppresses the next line; a trailing
            # comment suppresses its own line.
            target = i + 1 if line.lstrip().startswith("#") else i
            if not reason:
                self.bad_suppressions.append(
                    Violation(
                        check="bad-suppression",
                        path=self.relpath,
                        line=i,
                        message=(
                            "inline graftlint disable without a reason — use "
                            "'# graftlint: disable=<check> -- <why this is ok>'"
                        ),
                        symbol=self.qualname_at_line(i),
                        tag=",".join(sorted(checks)),
                    )
                )
                continue
            existing = self.inline_disables.get(target)
            if existing:
                existing[0].update(checks)
            else:
                self.inline_disables[target] = (set(checks), reason)

    def is_disabled(self, check: str, line: int) -> bool:
        ent = self.inline_disables.get(line)
        return bool(ent and (check in ent[0] or "*" in ent[0]))

    # -- structural maps ----------------------------------------------------
    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    @property
    def qualnames(self) -> Dict[ast.AST, str]:
        """FunctionDef/AsyncFunctionDef/ClassDef node -> dotted qualname."""
        if self._qualnames is None:
            self._qualnames = {}

            def visit(node: ast.AST, prefix: str) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(
                        child,
                        (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                    ):
                        q = f"{prefix}.{child.name}" if prefix else child.name
                        self._qualnames[child] = q
                        visit(child, q)
                    else:
                        visit(child, prefix)

            visit(self.tree, "")
        return self._qualnames

    def enclosing_qualname(self, node: ast.AST) -> str:
        """Qualname of the innermost function/class containing ``node``."""
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                return self.qualnames.get(cur, cur.name)
            cur = self.parents.get(cur)
        return "<module>"

    def qualname_at_line(self, line: int) -> str:
        """Best-effort qualname for a line (used for suppression records)."""
        best = "<module>"
        best_span = None
        for node, q in self.qualnames.items():
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                span = end - node.lineno
                if best_span is None or span < best_span:
                    best, best_span = q, span
        return best

    def iter_functions(self):
        """Yield (qualname, node) for every function/method, outermost first."""
        for node, q in self.qualnames.items():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield q, node


@dataclass
class Project:
    root: str
    modules: List[Module] = field(default_factory=list)

    def module(self, relpath: str) -> Optional[Module]:
        for m in self.modules:
            if m.relpath == relpath:
                return m
        return None


@dataclass
class LintResult:
    violations: List[Violation]
    parse_errors: List[Violation]
    unused_baseline: List[dict]
    files_checked: int
    elapsed_s: float
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def unsuppressed(self) -> List[Violation]:
        return [v for v in self.violations if v.suppressed_by is None]

    @property
    def suppressed(self) -> List[Violation]:
        return [v for v in self.violations if v.suppressed_by is not None]


def repo_root_for(path: str) -> str:
    """Walk up from ``path`` to the directory holding ``pyproject.toml``
    (or ``.graftlint.toml``); fall back to the path itself."""
    start = os.path.abspath(path if os.path.isdir(path) else os.path.dirname(path))
    cur = start
    while True:
        if any(
            os.path.exists(os.path.join(cur, marker))
            for marker in ("pyproject.toml", ".graftlint.toml", ".git")
        ):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            # No marker anywhere above: the starting DIRECTORY is the
            # root (never the file itself — relpaths must stay filenames
            # so inline/baseline suppression matching keeps working).
            return start
        cur = parent


def _discover(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(os.path.abspath(p))
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.abspath(os.path.join(dirpath, fn)))
    return out


def run_lint(
    paths: Sequence[str],
    root: Optional[str] = None,
    baseline: Optional[object] = None,
    select: Optional[Sequence[str]] = None,
    use_cache: bool = True,
) -> LintResult:
    """Parse every file under ``paths`` and run the checkers.

    ``baseline`` is a ``baseline.Baseline`` (or None to skip baseline
    matching); ``select`` limits to the named checks; ``use_cache``
    memoizes ``ast.parse`` on source content hash (see cache.py).
    """
    from ray_tpu_torch.devtools.lint import checkers as _checkers
    from ray_tpu_torch.devtools.lint.cache import AstCache

    t0 = time.perf_counter()
    root = os.path.abspath(root or repo_root_for(paths[0] if paths else "."))
    files = _discover(paths)
    ast_cache = AstCache(root, enabled=use_cache)
    modules: List[Module] = []
    parse_errors: List[Violation] = []
    for f in files:
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast_cache.parse(src, filename=f)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            parse_errors.append(
                Violation(
                    check="parse-error",
                    path=rel,
                    line=getattr(e, "lineno", 0) or 0,
                    message=f"could not parse: {e}",
                )
            )
            continue
        modules.append(Module(f, rel, src, tree))
    ast_cache.prune()

    project = Project(root=root, modules=modules)
    selected = set(select) if select else None

    violations: List[Violation] = []
    for mod in modules:
        if selected is None or "bad-suppression" in selected:
            violations.extend(mod.bad_suppressions)
    for checker in _checkers.ALL_CHECKERS:
        if selected is not None and checker.name not in selected:
            continue
        if hasattr(checker, "check_project"):
            violations.extend(checker.check_project(project))
        else:
            for mod in modules:
                violations.extend(checker.check(mod))

    # Apply inline suppressions (bad-suppression itself can't be silenced).
    by_path = {m.relpath: m for m in modules}
    for v in violations:
        if v.check == "bad-suppression":
            continue
        mod = by_path.get(v.path)
        if mod is not None and mod.is_disabled(v.check, v.line):
            v.suppressed_by = "inline"

    # Apply the baseline.
    unused: List[dict] = []
    if baseline is not None:
        unused = baseline.apply(violations)

    violations.sort(key=lambda v: (v.path, v.line, v.check))
    return LintResult(
        violations=violations,
        parse_errors=parse_errors,
        unused_baseline=unused,
        files_checked=len(modules),
        elapsed_s=time.perf_counter() - t0,
        cache_hits=ast_cache.hits,
        cache_misses=ast_cache.misses,
    )


# -- small shared AST helpers (imported by checkers) ------------------------

def call_name(node: ast.Call) -> str:
    """Dotted name of a call's callee: ``time.sleep`` -> "time.sleep",
    ``self._kv(...)`` -> "self._kv", bare ``sleep(...)`` -> "sleep"."""
    return dotted(node.func)


def dotted(node: ast.AST) -> str:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Subscript):
        inner = dotted(cur.value)
        parts.append(f"{inner}[*]" if inner else "[*]")
    elif parts:
        parts.append("?")
    return ".".join(reversed(parts))


def is_docstring(mod: Module, node: ast.Constant) -> bool:
    """True when ``node`` is the docstring expression of its scope."""
    parent = mod.parents.get(node)
    if not isinstance(parent, ast.Expr):
        return False
    scope = mod.parents.get(parent)
    body = getattr(scope, "body", None)
    return bool(body) and body[0] is parent
