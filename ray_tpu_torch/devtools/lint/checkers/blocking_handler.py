"""blocking-in-handler: no blocking calls on RPC dispatch / pubsub threads.

Two kinds of latency-critical entry points exist in this codebase
(``_private/rpc.py``):

- **server handlers** — ``async def rpc_<method>`` / ``push_<method>``
  coroutines dispatched by RpcServer on the process's asyncio loop.  A
  ``time.sleep`` (or blocking socket read) there freezes the *entire*
  event loop: every other RPC this process serves stalls behind it.
  (``await asyncio.sleep`` is fine.)
- **client push/close callbacks** — functions wired via ``on_push=`` /
  ``on_close=`` / ``on_reconnect=`` (GCS pubsub deliveries among them)
  run on the RpcClient's reader thread.  Blocking there stalls every
  in-flight reply on that connection — the GCS-restart bug class
  (blocking GCS pushes stalled stream consumption through outages).

The checker collects those entry points per module, builds a
**cross-module call graph**, and flags ``time.sleep`` / blocking
``recv`` reachable from any entry point.  Edges resolved:

- ``self.method()`` within the entry's class and bare ``func()`` within
  the module (as before);
- ``alias.func()`` where ``alias`` imports another module in the linted
  tree (``from ray_tpu_torch._private import rpc`` → ``rpc.call_idempotent``
  lands in rpc.py's ``call_idempotent``) — blocking
  calls reached *through helper modules* used to escape the analysis;
- ``alias.Class(...)`` constructor calls → ``Class.__init__`` in the
  target module.

Method calls on arbitrary objects stay unresolved by design (no type
inference); depth is bounded by ``_MAX_DEPTH``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.core import Module, Project, Violation, call_name

name = "blocking-in-handler"

_CALLBACK_KWARGS = ("on_push", "on_close", "on_reconnect", "on_disconnect")
_MAX_DEPTH = 8

# (relpath, qualname) node in the cross-module call graph
_Node = Tuple[str, str]


def _blocking(node: ast.Call, in_async: bool) -> Optional[str]:
    cn = call_name(node)
    if cn in ("time.sleep", "_time.sleep"):
        if node.args and isinstance(node.args[0], ast.Constant) and \
                node.args[0].value == 0:
            return None
        return "time.sleep"
    if cn.endswith(".recv") or cn.endswith("_recv_exact") or cn.endswith("_recv_msg"):
        return "blocking socket recv"
    if cn.endswith(".accept") and "listener" in cn:
        return "blocking socket accept"
    return None


def _fn_index(mod: Module) -> Dict[str, ast.AST]:
    return {q: fn for q, fn in mod.iter_functions()}


def _own_nodes(fn: ast.AST):
    """Nodes in ``fn``'s own body, pruning nested function/lambda bodies —
    a closure defined in a handler (e.g. a thread target) does not run on
    the handler's thread, so its blocking calls are not the handler's."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        n = todo.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield n
        todo.extend(ast.iter_child_nodes(n))


def _entries(mod: Module, fns: Dict[str, ast.AST]) -> List[str]:
    out: List[str] = []
    for q, fn in fns.items():
        base = q.split(".")[-1]
        if isinstance(fn, ast.AsyncFunctionDef) and (
            base.startswith("rpc_") or base.startswith("push_")
        ):
            out.append(q)
    # Callbacks passed as on_push=self._x / on_close=self._x, as
    # `client.on_push = self._x` assignments, or inside lambdas.
    for node in ast.walk(mod.tree):
        refs: List[ast.AST] = []
        if isinstance(node, ast.Call):
            refs = [kw.value for kw in node.keywords if kw.arg in _CALLBACK_KWARGS]
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and t.attr in _CALLBACK_KWARGS:
                refs = [node.value]
        for ref in refs:
            for target in _callback_targets(ref):
                # Resolve the attr name to any class method in this module.
                for q in fns:
                    if q.split(".")[-1] == target:
                        out.append(q)
    return sorted(set(out))


def _callback_targets(ref: ast.AST) -> List[str]:
    """Method names referenced by a callback expression: `self._x`,
    `lambda ...: self._x(...)`, or a bare function name."""
    if isinstance(ref, ast.Attribute):
        return [ref.attr]
    if isinstance(ref, ast.Name):
        return [ref.id]
    if isinstance(ref, ast.Lambda):
        return [
            call_name(c).split(".")[-1]
            for c in ast.walk(ref.body)
            if isinstance(c, ast.Call)
        ]
    return []


def _module_relpath_index(project: Project) -> Dict[str, str]:
    """Dotted module name -> relpath for every module in the linted tree
    (``ray_tpu_torch/_private/rpc.py`` -> ``ray_tpu_torch._private.rpc``; packages
    map their ``__init__.py`` too)."""
    out: Dict[str, str] = {}
    for mod in project.modules:
        rel = mod.relpath
        if not rel.endswith(".py"):
            continue
        dotted = rel[:-3].replace("/", ".")
        if dotted.endswith(".__init__"):
            dotted = dotted[: -len(".__init__")]
        out[dotted] = rel
    return out


def _import_aliases(
    mod: Module, mod_index: Dict[str, str]
) -> Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]:
    """Alias maps from every import statement in the module (module
    scope AND function-local — this tree imports lazily for cycle
    avoidance, and a lazy import is exactly how helper modules are
    reached from handlers).

    Returns (module_aliases: alias -> relpath,
             symbol_aliases: alias -> (relpath, symbol))."""
    mod_aliases: Dict[str, str] = {}
    sym_aliases: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    # `import a.b as x` binds x to module a.b
                    rel = mod_index.get(a.name)
                    if rel:
                        mod_aliases[a.asname] = rel
                else:
                    # `import a.b` binds the name `a` (the TOP package),
                    # not a.b — resolving `a` to a.b would send alias
                    # lookups into the wrong module.
                    top = a.name.split(".")[0]
                    rel = mod_index.get(top)
                    if rel:
                        mod_aliases[top] = rel
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue  # relative imports: out of scope
            base = node.module or ""
            for a in node.names:
                full = f"{base}.{a.name}" if base else a.name
                rel = mod_index.get(full)
                if rel:
                    # `from ray_tpu_torch._private import rpc` — a module alias
                    mod_aliases[a.asname or a.name] = rel
                elif base in mod_index:
                    # `from ray_tpu_torch._private.rpc import call_idempotent`
                    sym_aliases[a.asname or a.name] = (mod_index[base], a.name)
    return mod_aliases, sym_aliases


def _callees(
    mod: Module,
    q: str,
    fn: ast.AST,
    fns_by_mod: Dict[str, Dict[str, ast.AST]],
    mod_aliases: Dict[str, str],
    sym_aliases: Dict[str, Tuple[str, str]],
) -> Set[_Node]:
    cls = q.split(".")[0] if "." in q else None
    fns = fns_by_mod[mod.relpath]
    out: Set[_Node] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node)
        if cn.startswith("self.") and cls:
            cand = f"{cls}.{cn[5:]}"
            if cand in fns:
                out.add((mod.relpath, cand))
        elif "." not in cn:
            if cn in fns:
                out.add((mod.relpath, cn))
            elif cn in sym_aliases:
                rel, sym = sym_aliases[cn]
                target_fns = fns_by_mod.get(rel, {})
                if sym in target_fns:
                    out.add((rel, sym))
                elif f"{sym}.__init__" in target_fns:
                    out.add((rel, f"{sym}.__init__"))
        else:
            # alias.func(...) / alias.Class(...) through an imported module
            head, rest = cn.split(".", 1)
            rel = mod_aliases.get(head)
            if rel is None or "." in rest:
                continue  # deeper attribute chains: unresolved by design
            target_fns = fns_by_mod.get(rel, {})
            if rest in target_fns:
                out.add((rel, rest))
            elif f"{rest}.__init__" in target_fns:
                out.add((rel, f"{rest}.__init__"))
    return out


def check_project(project: Project) -> Iterable[Violation]:
    mods_by_rel = {m.relpath: m for m in project.modules}
    fns_by_mod = {m.relpath: _fn_index(m) for m in project.modules}
    mod_index = _module_relpath_index(project)
    alias_cache: Dict[str, Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]] = {}

    def aliases(rel: str):
        got = alias_cache.get(rel)
        if got is None:
            got = alias_cache[rel] = _import_aliases(mods_by_rel[rel], mod_index)
        return got

    # Per-function memo of blocking sites + outgoing edges.
    site_cache: Dict[_Node, List[Tuple[str, int]]] = {}
    edge_cache: Dict[_Node, Set[_Node]] = {}

    def sites(node: _Node) -> List[Tuple[str, int]]:
        got = site_cache.get(node)
        if got is None:
            rel, q = node
            fn = fns_by_mod[rel][q]
            in_async = isinstance(fn, ast.AsyncFunctionDef)
            got = []
            for n in _own_nodes(fn):
                if isinstance(n, ast.Call):
                    kind = _blocking(n, in_async)
                    if kind:
                        got.append((kind, n.lineno))
            site_cache[node] = got
        return got

    def edges(node: _Node) -> Set[_Node]:
        got = edge_cache.get(node)
        if got is None:
            rel, q = node
            mod_aliases, sym_aliases = aliases(rel)
            got = edge_cache[node] = _callees(
                mods_by_rel[rel], q, fns_by_mod[rel][q], fns_by_mod,
                mod_aliases, sym_aliases,
            )
        return got

    out: List[Violation] = []
    reported: Set[Tuple[str, str, int]] = set()
    for mod in project.modules:
        fns = fns_by_mod[mod.relpath]
        if not fns:
            continue
        for entry in _entries(mod, fns):
            root: _Node = (mod.relpath, entry)
            seen = {root}
            frontier: List[Tuple[_Node, Tuple[str, ...]]] = [(root, (entry,))]
            depth = 0
            while frontier and depth < _MAX_DEPTH:
                nxt: List[Tuple[_Node, Tuple[str, ...]]] = []
                for node, trail in frontier:
                    rel, q = node
                    for kind, lineno in sites(node):
                        if (rel, q, lineno) in reported:
                            continue
                        reported.add((rel, q, lineno))
                        via = (
                            "" if len(trail) == 1
                            else " via " + " -> ".join(trail[1:])
                        )
                        origin = (
                            "" if rel == mod.relpath
                            else f" (entry in {mod.relpath})"
                        )
                        out.append(
                            Violation(
                                check=name,
                                path=rel,
                                line=lineno,
                                symbol=q,
                                tag=f"{kind}@{entry}",
                                message=(
                                    f"{kind} reachable from handler/pubsub "
                                    f"entry point {entry}{origin}{via} — this "
                                    "blocks the RPC dispatch loop / reader "
                                    "thread; defer to a worker thread or use "
                                    "asyncio.sleep in async handlers"
                                ),
                            )
                        )
                    for callee in edges(node):
                        if callee not in seen:
                            seen.add(callee)
                            nxt.append((callee, trail + (callee[1],)))
                frontier = nxt
                depth += 1
    return out
