"""Per-request identity context (tenant + SLO class).

The serving plane threads a small ``request_meta`` dict — ``{"tenant":
..., "slo": ...}`` — from the proxy header / handle kwarg through the
router's replica call into the replica, which
sets it here (a contextvar, same pattern as multiplex's model-id
context) before dispatching user code.  ``serve.get_request_tenant()`` /
``serve.get_request_slo()`` read it from anywhere under the request,
and ``LLMServer`` folds it into engine admission so quotas, the fair
queue, preemption, and brownout all see the same identity.

Identity is advisory routing metadata, not authentication: the proxy
trusts the ``x-serve-tenant`` header the same way the job plane trusts
a submitted job's tenant field (docs/tenancy.md threat model).
"""

from __future__ import annotations

import contextvars
from typing import Any, Dict, Optional

_request_meta_ctx: contextvars.ContextVar[Optional[Dict[str, Any]]] = (
    contextvars.ContextVar("ray_tpu_serve_request_meta", default=None)
)


def _set_request_meta(meta: Optional[Dict[str, Any]]) -> None:
    """Replica-internal: bind the current request's identity (or None)."""
    _request_meta_ctx.set(dict(meta) if meta else None)


def get_request_meta() -> Optional[Dict[str, Any]]:
    """The current request's identity dict, or None outside a request."""
    meta = _request_meta_ctx.get()
    return dict(meta) if meta else None


def get_request_tenant() -> str:
    """The current request's tenant ("default" when unset)."""
    meta = _request_meta_ctx.get()
    t = (meta or {}).get("tenant")
    return str(t) if t else "default"


def get_request_slo() -> str:
    """The current request's SLO class ("standard" when unset/unknown)."""
    from ray_tpu_torch.serve.llm.overload import normalize_slo

    meta = _request_meta_ctx.get()
    return normalize_slo((meta or {}).get("slo"))
