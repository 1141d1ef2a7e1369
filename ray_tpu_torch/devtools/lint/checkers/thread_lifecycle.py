"""thread-lifecycle: every spawned thread needs a daemon flag or a join path.

The bug this guards shipped once: survivors' session loop threads
were never retired before the elastic group re-formed, so a stale loop
thread raced the new generation's rendezvous.  The rule: every
``threading.Thread(...)`` spawn site must satisfy one of

- ``daemon=True`` passed to the constructor (fire-and-forget helper that
  must not block interpreter exit), or
- the created thread handle (``self._x = threading.Thread(...)`` or a
  local/module name) has ``.daemon = True`` assigned, or a ``.join(``
  call on the same handle somewhere in the module — i.e. a retire path
  exists.

A thread that is neither daemonized nor joined outlives its owner
silently: it pins interpreter shutdown and keeps mutating state its
owner already tore down.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional

from ray_tpu_torch.devtools.lint.core import Module, Violation, call_name

name = "thread-lifecycle"


def _thread_ctor(node: ast.Call) -> bool:
    return call_name(node) in ("threading.Thread", "Thread")


def _daemon_kwarg_true(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return kw.value.value is True
    return False


def _assign_target(mod: Module, call: ast.Call) -> Optional[str]:
    """The handle the Thread object lands in: 'self.X' / bare name, or
    None for an anonymous spawn (``threading.Thread(...).start()``)."""
    parent = mod.parents.get(call)
    # threading.Thread(...).start() — anonymous but started immediately;
    # walk up through the Attribute/Call chain.
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        t = parent.targets[0]
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and \
                t.value.id == "self":
            return f"self.{t.attr}"
    return None


def _module_has_join_or_daemon(mod: Module, handle: str) -> bool:
    """Any `<handle>.join(` call or `<handle>.daemon = True` assignment in
    the module.  Matched on the attribute name for self-handles so the
    join may live in another method (stop/close/retire)."""
    attr = handle.split(".")[-1]
    join_pat = re.compile(
        r"(?:self\.|\b)" + re.escape(attr) + r"\s*\.\s*join\s*\("
    )
    daemon_pat = re.compile(
        r"(?:self\.|\b)" + re.escape(attr) + r"\s*\.\s*daemon\s*=\s*True"
    )
    return bool(join_pat.search(mod.source) or daemon_pat.search(mod.source))


def check(mod: Module) -> Iterable[Violation]:
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not _thread_ctor(node):
            continue
        if _daemon_kwarg_true(node):
            continue
        handle = _assign_target(mod, node)
        if handle and _module_has_join_or_daemon(mod, handle):
            continue
        what = f"thread handle {handle!r}" if handle else "anonymous thread"
        out.append(
            Violation(
                check=name,
                path=mod.relpath,
                line=node.lineno,
                symbol=mod.enclosing_qualname(node),
                tag=f"handle={handle or '<anonymous>'}",
                message=(
                    f"threading.Thread spawn with no lifecycle: {what} is "
                    "neither daemon=True nor joined anywhere in this module — "
                    "daemonize it or give it a retire/join path (the "
                    "survivor-loop bug class)"
                ),
            )
        )
    return out
