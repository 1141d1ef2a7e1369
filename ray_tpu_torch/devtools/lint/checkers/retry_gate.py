"""retry-gate: every retry/poll loop must ride a ``_private/retry.py`` policy.

The runtime replaced the fixed-interval ``time.sleep`` retry loops scattered
across the core with the unified decorrelated-jitter policies; this
checker keeps new ones from creeping back in.  Two patterns are flagged:

1. ``time.sleep(<non-zero numeric constant>)`` lexically inside a
   ``while``/``for`` loop.  Policy-driven loops sleep a *variable*
   (``bo.next_delay()``), so a constant interval in a loop is either a
   hand-rolled retry/poll loop (fix: ``retry.<POLICY>.start()``) or a
   deliberate fixed-cadence background loop (baseline it with a reason).
   ``time.sleep(0)`` — a bare scheduler yield — is exempt.

2. a ``while`` loop wrapping a ``try``/``except`` whose handler retries
   (``continue``/``pass``-falls-through) around a direct RPC ``.call(``,
   in a function that never consults a ``Backoff`` (``next_delay``) and
   doesn't route through ``call_idempotent``.  That's an unbounded
   hand-rolled RPC retry without jitter or a deadline budget.

``_private/retry.py`` itself is exempt (it is the policy layer and its
docstring shows the canonical loop shape).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ray_tpu_torch.devtools.lint.core import Module, Violation, call_name

name = "retry-gate"

_EXEMPT_FILES = ("ray_tpu_torch/_private/retry.py",)


def _sleep_callee(node: ast.Call, mod: Module) -> bool:
    cn = call_name(node)
    if cn in ("time.sleep", "_time.sleep"):
        return True
    # `from time import sleep` style
    return cn == "sleep" and "from time import sleep" in mod.source


def _const_seconds(node: ast.Call):
    if node.args and isinstance(node.args[0], ast.Constant):
        v = node.args[0].value
        if isinstance(v, (int, float)):
            return v
    return None


def _loops_enclosing(mod: Module, node: ast.AST) -> bool:
    """Is ``node`` inside a while/for loop without an intervening
    function boundary?"""
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.While, ast.For, ast.AsyncFor)):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
        cur = mod.parents.get(cur)
    return False


def _function_uses_backoff(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            cn = call_name(sub)
            if cn.endswith(".next_delay") or cn.endswith("call_idempotent") or (
                cn.endswith(".start") and ".".join(cn.split(".")[:-1]).isupper()
            ):
                return True
        if isinstance(sub, ast.Attribute) and sub.attr == "next_delay":
            return True
    return False


def _handler_retries(handler: ast.ExceptHandler) -> bool:
    """except-block that loops again: contains continue, or neither
    raise/return/break (falls through to the next iteration)."""
    terminal = (ast.Raise, ast.Return, ast.Break)
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Continue):
            return True
    return not any(
        isinstance(stmt, terminal) for stmt in ast.walk(handler)
    )


def check(mod: Module) -> Iterable[Violation]:
    if mod.relpath in _EXEMPT_FILES:
        return []
    out: List[Violation] = []

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not _sleep_callee(node, mod):
            continue
        secs = _const_seconds(node)
        if secs is None or secs == 0:
            continue
        if not _loops_enclosing(mod, node):
            continue
        out.append(
            Violation(
                check=name,
                path=mod.relpath,
                line=node.lineno,
                symbol=mod.enclosing_qualname(node),
                tag=f"sleep={secs}",
                message=(
                    f"fixed-interval time.sleep({secs}) in a loop — route the "
                    "delay through a _private/retry.py policy "
                    "(bo = retry.<POLICY>.start(); time.sleep(bo.next_delay()))"
                ),
            )
        )

    # Pattern 2: while > try/except-retry around a direct rpc .call(...)
    for qual, fn in mod.iter_functions():
        if _function_uses_backoff(fn):
            continue
        for loop in ast.walk(fn):
            if not isinstance(loop, ast.While):
                continue
            for stmt in ast.walk(loop):
                if not isinstance(stmt, ast.Try):
                    continue
                has_rpc_call = any(
                    isinstance(c, ast.Call) and call_name(c).endswith(".call")
                    for body_stmt in stmt.body
                    for c in ast.walk(body_stmt)
                )
                if not has_rpc_call:
                    continue
                if any(_handler_retries(h) for h in stmt.handlers):
                    out.append(
                        Violation(
                            check=name,
                            path=mod.relpath,
                            line=stmt.lineno,
                            symbol=qual,
                            tag="handrolled-rpc-retry",
                            message=(
                                "hand-rolled retry loop around an RPC .call() "
                                "without a retry.py policy — use "
                                "retry.<POLICY>.start() for jitter + deadline "
                                "budget, or rpc.call_idempotent for reads"
                            ),
                        )
                    )
                    break  # one report per loop
    return out
