"""shared-state-race: cross-thread attribute access with no shared lock.

Every robustness arc added daemon threads to control-plane classes
(rx/intake loops, flushers, sweeper ticks), and every one of those
threads shares ``self`` with the main thread.  This checker runs a
static lockset analysis over each class that spawns threads:

- **contexts** — one per ``threading.Thread(target=...)`` entry point
  (a ``self.method``, a nested closure, or a lambda calling one), plus
  a single ``main`` context covering every other method.  ``__init__``
  is excluded: construction happens-before ``Thread.start``.
- **sites** — every ``self.attr`` read/write reachable from a context's
  entry point through intra-class ``self.method()`` calls, with the
  statically-held lock set carried through the call graph (a method
  called under ``with self._lock:`` inherits the lock).  Writes are
  attribute stores, subscript stores, ``del``, augmented assigns, and
  mutator calls (``.append``/``.pop``/``.update``/...).
- **violation** — an attribute written in one context and read/written
  in another where the two sites' held-lock sets do not intersect.

Idiom allowlist (these patterns are deliberately lock-free here and in
CPython practice):

- *single-writer flag* — every non-``__init__`` write assigns a
  constant (``self._stop = True``): torn reads are impossible, staleness
  is the accepted semantics.
- *append-only counter* — every write is an augmented assign
  (``self.n += 1``): monotonic stats counters.
- *synchronization primitives* — attributes holding ``Event`` /
  ``Condition`` / ``Semaphore`` / ``Barrier`` / ``queue.*`` / ``deque``
  / ``Thread`` objects are themselves thread-safe hand-off points.

``tests/`` modules are skipped: test helpers spawn throwaway threads
whose lifetimes are controlled by the test body, not a lock discipline.
Identity: ``symbol`` is the class qualname, ``tag`` is
``attr=<Class>.<attr>`` — suppressions go in ``.graftlint.toml`` with a
written justification (see docs/static_analysis.md).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.core import Module, Project, Violation, call_name, dotted

name = "shared-state-race"

_THREAD_CTORS = {"threading.Thread", "Thread"}
_LOCK_CTORS = {"threading.Lock", "Lock", "threading.RLock", "RLock",
               "threading.Condition", "Condition"}
# Attributes holding these are synchronization/hand-off objects — their
# own methods are thread-safe, so accesses to the attribute are not
# shared-state races.
_SAFE_CTORS = _LOCK_CTORS | {
    "threading.Event", "Event",
    "threading.Semaphore", "Semaphore",
    "threading.BoundedSemaphore", "BoundedSemaphore",
    "threading.Barrier", "Barrier",
    "threading.local",
    "queue.Queue", "Queue",
    "queue.SimpleQueue", "SimpleQueue",
    "queue.LifoQueue", "LifoQueue",
    "queue.PriorityQueue", "PriorityQueue",
    "collections.deque", "deque",
    "threading.Thread", "Thread",
}
_MUTATORS = {
    "append", "add", "update", "pop", "setdefault", "clear", "remove",
    "discard", "extend", "appendleft", "popleft", "insert", "put",
    "popitem",
}


@dataclass(frozen=True)
class _Site:
    ctx: str        # context name ("main" or the thread target's name)
    attr: str
    write: bool
    write_kind: str  # "const" | "aug" | "other" | "" (reads)
    locks: FrozenSet[str]
    line: int
    path: str


class _ClassInfo:
    def __init__(self, mod: Module, qualname: str, node: ast.ClassDef):
        self.mod = mod
        self.qualname = qualname
        self.node = node
        self.methods: Dict[str, ast.AST] = {}
        self.lock_attrs: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        self.thread_targets: List[Tuple[str, ast.AST]] = []  # (ctx name, fn)


def _classes(mod: Module) -> List[_ClassInfo]:
    out: List[_ClassInfo] = []
    for node, q in mod.qualnames.items():
        if isinstance(node, ast.ClassDef):
            out.append(_ClassInfo(mod, q, node))
    for ci in out:
        for n, q in mod.qualnames.items():
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and q.startswith(ci.qualname + ".") \
                    and "." not in q[len(ci.qualname) + 1:]:
                ci.methods[q[len(ci.qualname) + 1:]] = n
    return out


def _scan_attr_types(ci: _ClassInfo) -> None:
    """Find lock/safe attributes from ``self.x = <ctor>()`` assignments
    anywhere in the class body."""
    for fn in ci.methods.values():
        for node in ast.walk(fn):
            targets: List[ast.AST] = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if not isinstance(value, ast.Call):
                continue
            ctor = call_name(value)
            for t in targets:
                if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    if ctor in _LOCK_CTORS:
                        ci.lock_attrs.add(t.attr)
                    if ctor in _SAFE_CTORS:
                        ci.safe_attrs.add(t.attr)


def _thread_target_names(call: ast.Call) -> List[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "target":
            return [kw.value]
    return []


def _scan_thread_targets(ci: _ClassInfo) -> None:
    """Thread entry points spawned by this class: ``target=self.m``,
    ``target=<nested def>``, ``target=lambda: self.m()``."""
    for mname, fn in ci.methods.items():
        nested = {
            n.name: n
            for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) \
                    or call_name(node) not in _THREAD_CTORS:
                continue
            for ref in _thread_target_names(node):
                if isinstance(ref, ast.Attribute) \
                        and isinstance(ref.value, ast.Name) \
                        and ref.value.id == "self" \
                        and ref.attr in ci.methods:
                    ci.thread_targets.append((ref.attr, ci.methods[ref.attr]))
                elif isinstance(ref, ast.Name) and ref.id in nested:
                    ci.thread_targets.append(
                        (f"{mname}.{ref.id}", nested[ref.id])
                    )
                elif isinstance(ref, ast.Lambda):
                    for c in ast.walk(ref.body):
                        if isinstance(c, ast.Call):
                            leaf = call_name(c)
                            if leaf.startswith("self.") \
                                    and leaf[5:] in ci.methods:
                                ci.thread_targets.append(
                                    (leaf[5:], ci.methods[leaf[5:]])
                                )


def _own_exprs(stmt: ast.stmt):
    """Non-statement nodes in this statement's own expressions, pruning
    nested statements (visited by the body recursion with the right held
    set) and nested function/lambda bodies (they run elsewhere)."""
    todo = [
        c
        for c in ast.iter_child_nodes(stmt)
        if not isinstance(c, (ast.stmt, ast.ExceptHandler))
    ]
    while todo:
        n = todo.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield n
        todo.extend(
            c for c in ast.iter_child_nodes(n) if not isinstance(c, ast.stmt)
        )


def _child_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
    out = []
    for field_name in ("body", "orelse", "finalbody"):
        b = getattr(stmt, field_name, None)
        if b:
            out.append(b)
    for h in getattr(stmt, "handlers", []) or []:
        out.append(h.body)
    return out


class _Collector:
    def __init__(self, ci: _ClassInfo):
        self.ci = ci
        self.sites: List[_Site] = []
        # (method name, inherited locks) -> visited, to bound recursion
        self._memo: Set[Tuple[str, FrozenSet[str]]] = set()

    def run(self, ctx: str, fn: ast.AST, held: FrozenSet[str]) -> None:
        self._ctx = ctx
        self._walk_fn(fn, held)

    def _walk_fn(self, fn: ast.AST, held: FrozenSet[str]) -> None:
        self._walk_body(fn.body, held)

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        d = dotted(expr)
        if d.startswith("self.") and d[5:] in self.ci.lock_attrs:
            return d[5:]
        return None

    def _walk_body(self, body: List[ast.stmt], held: FrozenSet[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # closures don't inherit the held set
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired = set()
                for item in stmt.items:
                    lock = self._resolve_lock(item.context_expr)
                    if lock:
                        acquired.add(lock)
                self._scan_exprs(stmt, held)
                self._walk_body(stmt.body, held | frozenset(acquired))
                continue
            if isinstance(stmt, ast.Try):
                # manual-acquire idiom: `lock.acquire(); try: ... finally:
                # lock.release()` — the try body runs under the lock
                released = set()
                for fin in stmt.finalbody:
                    for n in ast.walk(fin):
                        if isinstance(n, ast.Call) \
                                and isinstance(n.func, ast.Attribute) \
                                and n.func.attr == "release":
                            lock = self._resolve_lock(n.func.value)
                            if lock:
                                released.add(lock)
                if released:
                    self._scan_exprs(stmt, held)
                    self._walk_body(stmt.body, held | frozenset(released))
                    for h in stmt.handlers:
                        self._walk_body(h.body, held | frozenset(released))
                    self._walk_body(stmt.orelse, held | frozenset(released))
                    self._walk_body(stmt.finalbody, held)
                    continue
            self._scan_exprs(stmt, held)
            for child in _child_bodies(stmt):
                self._walk_body(child, held)

    def _scan_exprs(self, stmt: ast.stmt, held: FrozenSet[str]) -> None:
        ci = self.ci
        parents = ci.mod.parents
        for n in _own_exprs(stmt):
            # intra-class call: propagate the held set into the callee
            if isinstance(n, ast.Call):
                cn = call_name(n)
                if cn.startswith("self.") and cn[5:] in ci.methods:
                    callee = cn[5:]
                    key = (self._ctx, callee, held)
                    if key not in self._memo:
                        self._memo.add(key)
                        self._walk_fn(ci.methods[callee], held)
            if not (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"):
                continue
            attr = n.attr
            if attr in ci.safe_attrs or attr in ci.methods:
                continue
            write = False
            write_kind = ""
            if isinstance(n.ctx, (ast.Store, ast.Del)):
                write = True
                parent = parents.get(n)
                if isinstance(parent, ast.AugAssign) and parent.target is n:
                    write_kind = "aug"
                elif isinstance(parent, ast.Assign) \
                        and isinstance(parent.value, ast.Constant):
                    write_kind = "const"
                else:
                    write_kind = "other"
            else:
                parent = parents.get(n)
                if isinstance(parent, ast.Subscript) \
                        and parent.value is n \
                        and isinstance(parent.ctx, (ast.Store, ast.Del)):
                    write, write_kind = True, "other"
                elif isinstance(parent, ast.Attribute) \
                        and parent.value is n \
                        and parent.attr in _MUTATORS:
                    gp = parents.get(parent)
                    if isinstance(gp, ast.Call) and gp.func is parent:
                        write, write_kind = True, "other"
            self.sites.append(
                _Site(
                    ctx=self._ctx,
                    attr=attr,
                    write=write,
                    write_kind=write_kind,
                    locks=held,
                    line=n.lineno,
                    path=ci.mod.relpath,
                )
            )


def _check_class(ci: _ClassInfo) -> Iterable[Violation]:
    _scan_attr_types(ci)
    _scan_thread_targets(ci)
    if not ci.thread_targets:
        return []

    collector = _Collector(ci)
    target_names = {t for t, _ in ci.thread_targets}
    # Private methods invoked from inside the class are helpers, not
    # entry points — they run in whatever context (and under whatever
    # locks) their callers hold, so walking them as independent "main"
    # roots would fabricate unlocked access paths.
    internally_called: Set[str] = set()
    for fn in ci.methods.values():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                cn = call_name(node)
                if cn.startswith("self.") and cn[5:] in ci.methods:
                    internally_called.add(cn[5:])
    seen_targets = set()
    for tname, fn in ci.thread_targets:
        if tname in seen_targets:
            continue
        seen_targets.add(tname)
        collector.run(tname, fn, frozenset())
    for mname, fn in ci.methods.items():
        if mname == "__init__" or mname in target_names:
            continue
        if mname.endswith("_locked"):
            # convention: *_locked helpers require the caller to hold the
            # class lock — they are analyzed through their callers (where
            # an unlocked call path still surfaces), not as entry points
            continue
        if mname.startswith("_") and mname in internally_called:
            continue
        collector.run("main", fn, frozenset())

    by_attr: Dict[str, List[_Site]] = {}
    for s in collector.sites:
        by_attr.setdefault(s.attr, []).append(s)

    out: List[Violation] = []
    for attr, sites in sorted(by_attr.items()):
        ctxs = {s.ctx for s in sites}
        if len(ctxs) < 2:
            continue
        writes = [s for s in sites if s.write]
        if not writes:
            continue  # set in __init__, read everywhere: immutable config
        if all(w.write_kind == "const" for w in writes):
            continue  # single-writer flag idiom
        if all(w.write_kind == "aug" for w in writes):
            continue  # append-only counter idiom
        offending: Optional[Tuple[_Site, _Site]] = None
        for w in writes:
            for s in sites:
                if s.ctx != w.ctx and not (w.locks & s.locks):
                    offending = (w, s)
                    break
            if offending:
                break
        if not offending:
            continue
        w, s = offending
        other = "written" if s.write else "read"
        out.append(
            Violation(
                check=name,
                path=ci.mod.relpath,
                line=w.line,
                symbol=ci.qualname,
                tag=f"attr={ci.qualname}.{attr}",
                message=(
                    f"self.{attr} is written in thread context "
                    f"{w.ctx!r} (line {w.line}) and {other} in context "
                    f"{s.ctx!r} (line {s.line}) with no common lock held "
                    "at both sites — potential data race; guard both "
                    "sides with one lock, hand off through a queue, or "
                    "baseline with a written justification"
                ),
            )
        )
    return out


def check_project(project: Project) -> Iterable[Violation]:
    out: List[Violation] = []
    for mod in project.modules:
        if mod.relpath.startswith("tests/"):
            continue  # test helpers: thread lifetimes are test-controlled
        for ci in _classes(mod):
            out.extend(_check_class(ci))
    return out
