"""trace-orphan: ``record_span`` calls must pin their context explicitly.

``tracing.record_span()`` records at the AMBIENT contextvar when no
``context=`` keyword is given.  Every dataplane consumer (serve replica
dispatch, compiled-DAG executor loops, podracer intake) runs on a
long-lived thread or task whose ambient context is whatever the LAST
inbound frame installed — an implicit-context ``record_span`` there is
a latent orphan: it silently parents one request's span under another
request's (or a stale actor-start) context, and the timeline shows a
broken or cross-wired trace.  That is exactly the resident-executor
re-parenting bug this checker pins: passing ``context=
tracing.current_context()`` is the same single contextvar read, but it
states at the call site that the author CHOSE the ambient context, and
it survives a refactor that moves the call off the frame-scoped path.

Flagged: any call named ``record_span`` (bare or attribute) without an
explicit ``context=`` keyword.  Allowed: ``record_event_span`` (a
deliberate fresh-root event) and ``start_span`` (mints and restores its
own context), plus the tracing module itself (it owns the default).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ray_tpu_torch.devtools.lint.core import Module, Violation

name = "trace-orphan"

_EXEMPT_FILES = ("ray_tpu_torch/util/tracing/__init__.py",)


def check(mod: Module) -> Iterable[Violation]:
    if mod.relpath in _EXEMPT_FILES:
        return []
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            fname = func.id
        elif isinstance(func, ast.Attribute):
            fname = func.attr
        else:
            continue
        if fname != "record_span":
            continue
        if any(kw.arg == "context" for kw in node.keywords):
            continue
        out.append(
            Violation(
                check=name,
                path=mod.relpath,
                line=node.lineno,
                symbol=mod.enclosing_qualname(node),
                tag="record_span",
                message=(
                    "record_span() without an explicit context= falls back "
                    "to the ambient contextvar — on a long-lived executor "
                    "thread that orphans or cross-wires the span under "
                    "whatever frame installed context last; pass context= "
                    "(tracing.current_context() if the ambient context is "
                    "truly what you mean)"
                ),
            )
        )
    return out
