"""import-cycle: module-level import cycles across the project.

A cycle of **module-scope** imports (``import a`` / ``from a import b``
executed at import time, not inside a function) is a latent crash: it
works only while callers happen to import the participants in one lucky
order, and the first new entry point that starts at the "wrong" module
dies with a partially-initialized module.  The codebase's convention is
to break cycles with function-local imports — this checker enforces
that the convention actually holds by building the module-scope import
graph over every project file and reporting each strongly-connected
component (Tarjan) of size > 1 (or a self-loop).

Imports inside ``if TYPE_CHECKING:`` blocks are ignored (they never run).
One violation is emitted per cycle, anchored at its lexicographically
first module's offending import line, with the full cycle in the
message; the suppression tag is the sorted member list, so a baseline
entry survives line drift and only goes stale when the cycle is
actually broken.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.core import Module, Project, Violation

name = "import-cycle"


def _module_name(relpath: str) -> str:
    """Dotted module name for a project-relative path.
    ``ray_tpu_torch/a/b.py`` -> ``ray_tpu_torch.a.b``; ``__init__.py`` names its
    package."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = p.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _in_type_checking(mod: Module, node: ast.AST) -> bool:
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.If):
            t = cur.test
            if (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
                isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING"
            ):
                return True
        cur = mod.parents.get(cur)
    return False


def _module_scope(mod: Module, node: ast.AST) -> bool:
    """True when the import executes at import time (module scope or a
    module-level ``if``/``try`` — but not inside any function/class-body
    function)."""
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
        cur = mod.parents.get(cur)
    return True


def _edges(mod: Module, known: Dict[str, str]) -> Dict[str, int]:
    """Module-scope import targets of ``mod`` that are project modules:
    target module name -> first import line."""
    out: Dict[str, int] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if not _module_scope(mod, node) or _in_type_checking(mod, node):
            continue
        targets: List[str] = []
        if isinstance(node, ast.Import):
            targets = [a.name for a in node.names]
        else:
            base = node.module or ""
            if node.level:  # relative import: resolve against my package
                pkg_parts = _module_name(mod.relpath).split(".")
                if not mod.relpath.endswith("__init__.py"):
                    pkg_parts = pkg_parts[:-1]
                cut = len(pkg_parts) - (node.level - 1)
                if cut < 0:
                    continue
                base = ".".join(pkg_parts[:cut] + ([base] if base else []))
            # ``from a.b import c``: c may be a submodule or an attribute
            # — prefer the submodule when one exists in the project.
            for a in node.names:
                sub = f"{base}.{a.name}" if base else a.name
                targets.append(sub if sub in known else base)
        for t in targets:
            # Walk up: "import a.b.c" binds a, but EXECUTES a.b.c (and
            # its parents) — the edge goes to the deepest known module.
            while t and t not in known:
                t = t.rsplit(".", 1)[0] if "." in t else ""
            if t and t != _module_name(mod.relpath):
                out.setdefault(t, node.lineno)
    return out


def check_project(project: Project) -> Iterable[Violation]:
    known: Dict[str, str] = {}  # module name -> relpath
    by_rel: Dict[str, Module] = {}
    for mod in project.modules:
        known[_module_name(mod.relpath)] = mod.relpath
        by_rel[mod.relpath] = mod
    graph: Dict[str, Dict[str, int]] = {}
    for mod in project.modules:
        graph[_module_name(mod.relpath)] = _edges(mod, known)

    # Tarjan SCC (iterative).
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(root: str):
        work: List[Tuple[str, Optional[iter]]] = [(root, None)]
        while work:
            node, it = work.pop()
            if it is None:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
                it = iter(graph.get(node, ()))
            recurse = False
            for succ in it:
                if succ not in index:
                    work.append((node, it))
                    work.append((succ, None))
                    recurse = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if recurse:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for n in graph:
        if n not in index:
            strongconnect(n)

    out: List[Violation] = []
    for scc in sccs:
        members = sorted(scc)
        cyclic = len(members) > 1 or (
            members and members[0] in graph.get(members[0], ())
        )
        if not cyclic:
            continue
        anchor = members[0]
        rel = known[anchor]
        # Line: the anchor's first module-scope import into the cycle.
        line = min(
            (ln for t, ln in graph.get(anchor, {}).items() if t in scc),
            default=1,
        )
        out.append(
            Violation(
                check=name,
                path=rel,
                line=line,
                symbol="<module>",
                tag="cycle:" + ">".join(members),
                message=(
                    "module-level import cycle: "
                    + " -> ".join(members + [members[0]])
                    + " — break it with a function-local import"
                ),
            )
        )
    return out
