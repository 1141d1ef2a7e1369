"""lock-order: acquisition-order cycles and locks held across blocking calls.

Builds the lock acquisition graph over every ``threading.Lock``/``RLock``
declaration in the tree:

- **nodes** — declared locks, identified as ``<relpath>::<Class>.<attr>``
  for ``self.x = threading.Lock()`` instance locks (identity is the
  class attribute: all instances share the ordering discipline),
  ``<relpath>::<name>`` for module-level locks, with ``[*]`` marking
  dict-of-locks collections.
- **edges** — ``with A: ... with B:`` static nesting anywhere in the
  tree adds A -> B (nested function bodies do NOT inherit the held set:
  a closure defined under a lock does not run under it).
- **cycles** — any strongly-connected component with two or more locks
  (or a self-edge on a non-RLock) is a potential deadlock: two threads
  taking the locks in opposite orders can each block on the other.

Separately, while at least one lock is statically held, these direct
calls are flagged as *blocking-under-lock*: ``time.sleep(...)`` (non-zero),
RPC ``.call(...)``/``call_idempotent(...)``, and ``<thread>.join(...)``.
A lock held across an RPC couples every thread contending on that lock
to the remote peer's latency (and to its failure/retry budget).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.core import Module, Project, Violation, call_name, dotted

name = "lock-order"

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "Lock",
    "RLock",
}


def _lock_ctor(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Call) and call_name(node) in _LOCK_CTORS:
        return call_name(node)
    return None


def _declared_locks(mod: Module) -> Dict[str, str]:
    """Map local lock handle -> node id.  Handles:
    ``self.attr`` (keyed per enclosing class), module-level names, and
    ``self.attr[...]`` dict-of-locks values."""
    locks: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        ctor = None
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            ctor = _lock_ctor(node.value)
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            ctor = _lock_ctor(node.value)
            targets = [node.target]
        if not ctor:
            continue
        rlock = ctor.endswith("RLock")
        for t in targets:
            if isinstance(t, ast.Name):
                scope = mod.enclosing_qualname(node)
                if scope == "<module>":
                    handle = t.id
                else:
                    # class-body lock (shared across instances) or a
                    # function-local lock; key it under the scope.
                    handle = f"{scope}.{t.id}" if "." not in scope else t.id
                locks[handle] = _node_id(mod, handle, rlock)
            elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                cls = mod.enclosing_qualname(node).split(".")[0]
                handle = f"{cls}.self.{t.attr}"
                locks[handle] = _node_id(mod, f"{cls}.{t.attr}", rlock)
            elif isinstance(t, ast.Subscript):
                base = dotted(t.value)
                if base.startswith("self."):
                    cls = mod.enclosing_qualname(node).split(".")[0]
                    handle = f"{cls}.{base}[*]"
                    locks[handle] = _node_id(mod, f"{cls}.{base[5:]}[*]", rlock)
    return locks


def _node_id(mod: Module, label: str, rlock: bool) -> str:
    return f"{mod.relpath}::{label}" + ("#rlock" if rlock else "")


_BLOCKING_SLEEP = ("time.sleep", "_time.sleep")


def _blocking_kind(node: ast.Call) -> Optional[str]:
    cn = call_name(node)
    if cn in _BLOCKING_SLEEP:
        if node.args and isinstance(node.args[0], ast.Constant) and \
                node.args[0].value == 0:
            return None
        return "time.sleep"
    if cn.endswith(".call") or cn.endswith("call_idempotent") or \
            cn.endswith("call_idempotent_async"):
        return "rpc call"
    if cn.endswith(".join"):
        base = cn[: -len(".join")].lower()
        if "thread" in base or "flusher" in base or "worker" in base:
            return "thread join"
    return None


class _Graph:
    def __init__(self):
        self.edges: Dict[str, Set[str]] = {}
        self.sites: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add(self, a: str, b: str, mod: Module, line: int, symbol: str):
        self.edges.setdefault(a, set()).add(b)
        self.edges.setdefault(b, set())
        self.sites.setdefault((a, b), (mod.relpath, line, symbol))


def _sccs(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan strongly-connected components (iterative)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in edges:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work.pop()
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recursed = False
            succs = sorted(edges.get(node, ()))
            for i in range(pi, len(succs)):
                s = succs[i]
                if s not in index:
                    work.append((node, i + 1))
                    work.append((s, 0))
                    recursed = True
                    break
                if s in on_stack:
                    low[node] = min(low[node], index[s])
            if recursed:
                continue
            for s in succs:
                if s in low and s in on_stack:
                    low[node] = min(low[node], low[s])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def _own_calls(stmt: ast.stmt):
    """Call nodes in this statement's own expressions — pruning nested
    statement bodies (handled by recursion) and nested function bodies
    (they don't run under the lock)."""
    todo = [
        c
        for c in ast.iter_child_nodes(stmt)
        if not isinstance(c, (ast.stmt, ast.ExceptHandler))
    ]
    while todo:
        n = todo.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        todo.extend(
            c for c in ast.iter_child_nodes(n) if not isinstance(c, ast.stmt)
        )


def _walk_withs(
    mod: Module,
    body: List[ast.stmt],
    held: List[str],
    locks: Dict[str, str],
    cls: Optional[str],
    symbol: str,
    graph: _Graph,
    out: List[Violation],
) -> None:
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # closures don't inherit the held set
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in stmt.items:
                node_id = _resolve_lock(item.context_expr, locks, cls)
                if node_id:
                    acquired.append(node_id)
                    for h in held:
                        if h != node_id:
                            graph.add(h, node_id, mod, stmt.lineno, symbol)
            _walk_withs(
                mod, stmt.body, held + acquired, locks, cls, symbol, graph, out
            )
            continue
        if held:
            for sub in _own_calls(stmt):
                kind = _blocking_kind(sub)
                if kind:
                    lock_label = held[-1].split("::", 1)[-1]
                    out.append(
                        Violation(
                            check=name,
                            path=mod.relpath,
                            line=sub.lineno,
                            symbol=symbol,
                            tag=f"blocking:{kind}@{lock_label}",
                            message=(
                                f"{kind} while holding lock "
                                f"{lock_label!r} — every thread contending "
                                "on this lock stalls for the full blocking "
                                "call; move it outside the critical section"
                            ),
                        )
                    )
        # Recurse into compound statements (their With children matter).
        for child_body in _child_bodies(stmt):
            _walk_withs(mod, child_body, held, locks, cls, symbol, graph, out)


def _child_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
    out = []
    for field_name in ("body", "orelse", "finalbody"):
        b = getattr(stmt, field_name, None)
        if b:
            out.append(b)
    for h in getattr(stmt, "handlers", []) or []:
        out.append(h.body)
    return out


def _resolve_lock(
    expr: ast.AST, locks: Dict[str, str], cls: Optional[str]
) -> Optional[str]:
    d = dotted(expr)
    if not d:
        return None
    for prefix in ("self.", "cls."):
        if d.startswith(prefix) and cls:
            bare = d[len(prefix):]
            for key in (f"{cls}.{d}", f"{cls}.self.{bare}", f"{cls}.{bare}"):
                hit = locks.get(key)
                if hit:
                    return hit
            return None
    return locks.get(d)


def check_project(project: Project) -> Iterable[Violation]:
    out: List[Violation] = []
    graph = _Graph()
    for mod in project.modules:
        locks = _declared_locks(mod)
        if not locks:
            continue
        for qual, fn in mod.iter_functions():
            # For methods, the first qualname component is the class —
            # it scopes `self.<attr>` lock handles.  For module-level
            # functions it's the function name, which matches no class
            # handle, so `self.` lookups just miss (harmless).
            _walk_withs(mod, fn.body, [], locks, qual.split(".")[0], qual, graph, out)

    for comp in _sccs(graph.edges):
        self_loop = len(comp) == 1 and comp[0] in graph.edges.get(comp[0], ())
        if len(comp) < 2 and not self_loop:
            continue
        if self_loop and comp[0].endswith("#rlock"):
            continue  # re-entrant by construction
        comp_sorted = sorted(comp)
        site = None
        for (a, b), s in sorted(graph.sites.items()):
            if a in comp and b in comp:
                site = s
                break
        path, line, symbol = site if site else (comp_sorted[0].split("::")[0], 1, "<module>")
        pretty = " -> ".join(c.replace("#rlock", "") for c in comp_sorted)
        out.append(
            Violation(
                check=name,
                path=path,
                line=line,
                symbol=symbol,
                tag=f"cycle:{'|'.join(comp_sorted)}",
                message=(
                    f"lock acquisition cycle (potential deadlock): {pretty} — "
                    "threads taking these locks in different orders can "
                    "deadlock; establish one global order or collapse the locks"
                ),
            )
        )
    return out
