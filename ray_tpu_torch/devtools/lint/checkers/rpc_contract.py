"""rpc-contract: cross-process RPC surface conformance.

The control plane is stringly-typed RPC (``_private/rpc.py``): a client
``.call("method", payload)`` reaches ``async def rpc_method`` on whatever
handler object the server was built with, ``.push("method", payload)``
reaches ``push_method`` (server side) or an ``on_push=`` dispatcher
comparing the method name against literals (client side).  Nothing ties
the two ends together at import time, so the contract only breaks at
runtime — on the failure path, usually.  This checker rebuilds the whole
surface statically and enforces five invariants:

- **no-handler** — a literal ``.call("x")`` / ``.push("x")`` /
  ``call_idempotent(_, "x")`` site whose method has no ``rpc_x`` /
  ``push_x`` handler and (for pushes) no dispatcher literal anywhere in
  the linted tree: a typo'd endpoint that raises ``method not found`` at
  runtime.
- **dead-endpoint** — an ``rpc_x``/``push_x`` handler no call site,
  string literal, or direct attribute reference anywhere targets: dead
  code on a live dispatch surface (or the call side was deleted and the
  contract silently halved).
- **payload-drift** — a call site passing a dict *literal* payload that
  is missing a key the handler subscripts without a ``.get`` default or
  ``"k" in payload`` guard: a guaranteed ``KeyError`` inside the handler.
- **retry-unsafe** — a ``call_idempotent``/``call_idempotent_async``
  site targeting a handler that neither consumes an idempotency
  ``token`` payload key nor declares itself read-only (docstring or
  comment marker ``rpc-contract: read-only``): the double-execute
  class — retries of a non-idempotent write execute it twice.
- **fence-missing** — in a class that defines ``_check_fence``, a
  handler that reads ``node_id`` from its payload and writes ``self``
  state without consulting the fence first: the
  zombie-resurrection class — a stale incarnation's write lands on
  liveness-adjacent state.

Identity: ``symbol`` is the call-site/handler qualname, ``tag`` is
``method=<name>`` (payload-drift adds ``:missing=<keys>``), so baselines
survive line drift.  Declare a genuinely read-only endpoint by putting
``rpc-contract: read-only`` in the handler's docstring (or a comment on
the ``def`` line); see docs/static_analysis.md.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.core import Module, Project, Violation, call_name

name = "rpc-contract"

_READONLY_MARKER = "rpc-contract: read-only"
_CALLBACK_KWARGS = ("on_push", "on_close", "on_reconnect", "on_disconnect")
_MUTATORS = {
    "append", "add", "update", "pop", "setdefault", "clear", "remove",
    "discard", "extend", "appendleft", "popleft", "insert", "put",
}


@dataclass
class _Handler:
    mod: Module
    qualname: str
    fn: ast.AST  # FunctionDef / AsyncFunctionDef
    kind: str  # "rpc" | "push"
    method: str


@dataclass
class _CallSite:
    mod: Module
    qualname: str
    node: ast.Call
    kind: str  # "call" | "push" | "idempotent"
    method: str
    payload: Optional[ast.AST]


@dataclass
class _Surface:
    rpc: Dict[str, List[_Handler]] = field(default_factory=dict)
    push: Dict[str, List[_Handler]] = field(default_factory=dict)
    # method names a client-side on_push dispatcher compares against
    dispatch_literals: Set[str] = field(default_factory=set)
    sites: List[_CallSite] = field(default_factory=list)
    # weak liveness evidence: every string literal / attribute name in
    # the tree (wrapper helpers pass method names as strings; tests and
    # delegating handlers reference `rpc_x` as an attribute)
    strings: Set[str] = field(default_factory=set)
    attr_refs: Set[str] = field(default_factory=set)


def _first_param(fn: ast.AST) -> Optional[str]:
    args = [a.arg for a in fn.args.args if a.arg not in ("self", "cls")]
    return args[0] if args else None


def _collect_handlers(mod: Module, surface: _Surface) -> None:
    for q, fn in mod.iter_functions():
        base = q.split(".")[-1]
        if "." not in q:
            continue  # handlers are methods on a server class
        for prefix, kind, table in (
            ("rpc_", "rpc", surface.rpc),
            ("push_", "push", surface.push),
        ):
            if base.startswith(prefix) and len(base) > len(prefix):
                method = base[len(prefix):]
                table.setdefault(method, []).append(
                    _Handler(mod, q, fn, kind, method)
                )


def _dispatcher_literals(mod: Module, fns: Dict[str, ast.AST]) -> Set[str]:
    """Method-name literals an ``on_push=`` dispatcher compares its
    method parameter against (``if method == "preempt_job": ...`` /
    ``elif m in ("a", "b")``)."""
    targets: Set[str] = set()
    for node in ast.walk(mod.tree):
        refs: List[ast.AST] = []
        if isinstance(node, ast.Call):
            refs = [kw.value for kw in node.keywords if kw.arg in _CALLBACK_KWARGS]
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and t.attr in _CALLBACK_KWARGS:
                refs = [node.value]
        for ref in refs:
            if isinstance(ref, ast.Attribute):
                targets.add(ref.attr)
            elif isinstance(ref, ast.Name):
                targets.add(ref.id)
            elif isinstance(ref, ast.Lambda):
                for c in ast.walk(ref.body):
                    if isinstance(c, ast.Call):
                        targets.add(call_name(c).split(".")[-1])
    out: Set[str] = set()
    for q, fn in fns.items():
        if q.split(".")[-1] not in targets:
            continue
        params = {a.arg for a in fn.args.args} - {"self", "cls"}
        if not params:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Compare) or len(node.comparators) != 1:
                continue
            if not (isinstance(node.left, ast.Name) and node.left.id in params):
                continue
            comp = node.comparators[0]
            if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
                out.add(comp.value)
            elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for el in comp.elts:
                    if isinstance(el, ast.Constant) and isinstance(el.value, str):
                        out.add(el.value)
    return out


def _collect_sites(mod: Module, surface: _Surface) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            surface.strings.add(node.value)
        elif isinstance(node, ast.Attribute):
            surface.attr_refs.add(node.attr)
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node)
        leaf = cn.split(".")[-1]
        kind = None
        method_arg = payload_arg = None
        if leaf in ("call", "push") and "." in cn:
            kind = "call" if leaf == "call" else "push"
            if node.args:
                method_arg = node.args[0]
                payload_arg = node.args[1] if len(node.args) > 1 else None
        elif leaf in ("call_idempotent", "call_idempotent_async"):
            kind = "idempotent"
            if len(node.args) > 1:
                method_arg = node.args[1]
                payload_arg = node.args[2] if len(node.args) > 2 else None
        if kind is None:
            continue
        if not (isinstance(method_arg, ast.Constant)
                and isinstance(method_arg.value, str)):
            continue  # dynamic method name: out of scope
        for kw in node.keywords:
            if kw.arg == "payload":
                payload_arg = kw.value
        surface.sites.append(
            _CallSite(
                mod,
                mod.enclosing_qualname(node),
                node,
                kind,
                method_arg.value,
                payload_arg,
            )
        )


def _required_keys(fn: ast.AST, param: str) -> Set[str]:
    """Keys the handler subscripts off its payload param without a
    guard.  A key is *guarded* (not required from every call site) when
    the handler also reads it via ``param.get("k")`` anywhere (the
    ``if payload.get("k"): ... payload["k"]`` idiom) or tests
    ``"k" in param``."""
    subscripted: Set[str] = set()
    guarded: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == param \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str) \
                and isinstance(node.ctx, ast.Load):
            subscripted.add(node.slice.value)
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and isinstance(node.comparators[0], ast.Name) \
                and node.comparators[0].id == param \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str):
            guarded.add(node.left.value)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == param \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            guarded.add(node.args[0].value)
    return subscripted - guarded


def _literal_payload_keys(payload: Optional[ast.AST]) -> Optional[Set[str]]:
    """Keys of a pure dict-literal payload; None when the payload is
    dynamic (a variable, ``**`` expansion, or computed keys) — those
    sites cannot be checked for drift."""
    if not isinstance(payload, ast.Dict):
        return None
    keys: Set[str] = set()
    for k in payload.keys:
        if k is None:  # ** expansion
            return None
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        keys.add(k.value)
    return keys


def _reads_payload_key(fn: ast.AST, param: str, key: str) -> bool:
    """Does the handler read ``param[key]`` / ``param.get(key)``?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == param \
                and isinstance(node.slice, ast.Constant) \
                and node.slice.value == key:
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == param \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == key:
            return True
    return False


def _is_read_only(h: _Handler) -> bool:
    doc = ast.get_docstring(h.fn, clean=False) or ""
    if _READONLY_MARKER in doc:
        return True
    # comment marker on the def line or the line above it
    for lineno in (h.fn.lineno - 1, h.fn.lineno - 2):
        if 0 <= lineno < len(h.mod.lines) \
                and _READONLY_MARKER in h.mod.lines[lineno]:
            return True
    return False


def _self_state_writes(fn: ast.AST, mod: Module) -> List[int]:
    """Line numbers where the handler mutates ``self`` state: attribute
    stores, subscript stores on a self attribute, or mutator method
    calls on a self attribute.  Nested function bodies are pruned (they
    run elsewhere)."""
    out: List[int] = []
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        n = todo.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id == "self" \
                and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.append(n.lineno)
        elif isinstance(n, ast.Subscript) and isinstance(n.ctx, (ast.Store, ast.Del)):
            v = n.value
            if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                    and v.value.id == "self":
                out.append(n.lineno)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _MUTATORS:
            v = n.func.value
            if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                    and v.value.id == "self":
                out.append(n.lineno)
        todo.extend(ast.iter_child_nodes(n))
    return sorted(out)


def _fence_call_line(fn: ast.AST) -> Optional[int]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                call_name(node) in ("self._check_fence", "cls._check_fence"):
            return node.lineno
    return None


def check_project(project: Project) -> Iterable[Violation]:
    surface = _Surface()
    fence_classes: Dict[Tuple[str, str], bool] = {}  # (relpath, class) -> True
    fns_by_mod: Dict[str, Dict[str, ast.AST]] = {}
    for mod in project.modules:
        fns = {q: fn for q, fn in mod.iter_functions()}
        fns_by_mod[mod.relpath] = fns
        _collect_handlers(mod, surface)
        _collect_sites(mod, surface)
        surface.dispatch_literals |= _dispatcher_literals(mod, fns)
        for q in fns:
            if q.endswith("._check_fence") and q.count(".") == 1:
                fence_classes[(mod.relpath, q.split(".")[0])] = True

    out: List[Violation] = []

    # -- no-handler: literal call sites with no handler anywhere --------
    for site in surface.sites:
        m = site.method
        if site.kind in ("call", "idempotent"):
            ok = m in surface.rpc
        else:  # push: server-side push_ handler OR client-side dispatcher
            ok = m in surface.push or m in surface.dispatch_literals
        if not ok:
            want = "rpc_" + m if site.kind != "push" else "push_" + m
            out.append(
                Violation(
                    check=name,
                    path=site.mod.relpath,
                    line=site.node.lineno,
                    symbol=site.qualname,
                    tag=f"no-handler:method={m}",
                    message=(
                        f"RPC {site.kind} targets method {m!r} but no "
                        f"{want} handler (or push dispatcher literal) exists "
                        "anywhere in the linted tree — typo'd or deleted "
                        "endpoint; this fails at runtime with 'method not "
                        "found'"
                    ),
                )
            )

    # -- dead-endpoint: handlers nothing references ---------------------
    called: Dict[str, Set[str]] = {"rpc": set(), "push": set()}
    for site in surface.sites:
        if site.kind in ("call", "idempotent"):
            called["rpc"].add(site.method)
        else:
            called["push"].add(site.method)
    for kind, table in (("rpc", surface.rpc), ("push", surface.push)):
        for method, handlers in table.items():
            if method in called[kind]:
                continue
            if method in surface.strings:
                continue  # wrapper helpers pass method names as strings
            if f"{kind}_{method}" in surface.attr_refs:
                continue  # direct delegation / tests call the method
            for h in handlers:
                out.append(
                    Violation(
                        check=name,
                        path=h.mod.relpath,
                        line=h.fn.lineno,
                        symbol=h.qualname,
                        tag=f"dead-endpoint:method={method}",
                        message=(
                            f"handler {h.qualname} serves method {method!r} "
                            "but no call site, push, string reference, or "
                            "direct attribute reference targets it anywhere "
                            "in the linted tree — dead endpoint; delete it "
                            "or wire the client side"
                        ),
                    )
                )

    # -- payload-drift: dict-literal sites missing required keys --------
    for site in surface.sites:
        table = surface.rpc if site.kind in ("call", "idempotent") else surface.push
        handlers = table.get(site.method)
        if not handlers:
            continue  # no-handler already fired
        provided = _literal_payload_keys(site.payload)
        if provided is None:
            continue
        # every handler for the method must be satisfiable from this site
        for h in handlers:
            param = _first_param(h.fn)
            if param is None:
                continue
            missing = sorted(_required_keys(h.fn, param) - provided)
            if missing:
                out.append(
                    Violation(
                        check=name,
                        path=site.mod.relpath,
                        line=site.node.lineno,
                        symbol=site.qualname,
                        tag=(
                            f"payload-drift:method={site.method}"
                            f":missing={'+'.join(missing)}"
                        ),
                        message=(
                            f"payload for {site.method!r} is missing "
                            f"key(s) {', '.join(repr(k) for k in missing)} "
                            f"that handler {h.qualname} subscripts without "
                            "a .get default — guaranteed KeyError on the "
                            "serving side"
                        ),
                    )
                )

    # -- retry-unsafe: idempotent calls into non-idempotent handlers ----
    for site in surface.sites:
        if site.kind != "idempotent":
            continue
        for h in surface.rpc.get(site.method, ()):
            param = _first_param(h.fn)
            consumes_token = bool(
                param and _reads_payload_key(h.fn, param, "token")
            )
            if consumes_token or _is_read_only(h):
                continue
            out.append(
                Violation(
                    check=name,
                    path=site.mod.relpath,
                    line=site.node.lineno,
                    symbol=site.qualname,
                    tag=f"retry-unsafe:method={site.method}",
                    message=(
                        f"call_idempotent targets {site.method!r} but handler "
                        f"{h.qualname} neither consumes an idempotency "
                        "'token' payload key nor declares itself read-only "
                        f"({_READONLY_MARKER!r} in its docstring) — a retried "
                        "delivery executes the write twice (the "
                        "double-execute class)"
                    ),
                )
            )

    # -- fence-missing: unfenced node_id-bearing write handlers ---------
    for kind, table in (("rpc", surface.rpc), ("push", surface.push)):
        for method, handlers in table.items():
            for h in handlers:
                cls = h.qualname.split(".")[0]
                if not fence_classes.get((h.mod.relpath, cls)):
                    continue
                param = _first_param(h.fn)
                if not param or not _reads_payload_key(h.fn, param, "node_id"):
                    continue
                writes = _self_state_writes(h.fn, h.mod)
                if not writes:
                    continue
                fence_at = _fence_call_line(h.fn)
                if fence_at is not None and fence_at <= writes[0]:
                    continue
                out.append(
                    Violation(
                        check=name,
                        path=h.mod.relpath,
                        line=h.fn.lineno,
                        symbol=h.qualname,
                        tag=f"fence-missing:method={method}",
                        message=(
                            f"handler {h.qualname} reads 'node_id' from its "
                            "payload and writes self state "
                            + (
                                f"(first write line {writes[0]}, fence "
                                f"consulted only at line {fence_at}) "
                                if fence_at is not None
                                else f"(first write line {writes[0]}) "
                            )
                            + "without consulting self._check_fence first — "
                            "a zombie incarnation's write lands on "
                            "liveness-adjacent state (the zombie-resurrection class)"
                        ),
                    )
                )

    return out
