"""Tenant identity and DRF dominant-share math for the serving engine.

The port's own copy of the part of ``ray_tpu/_private/tenants.py`` the
engine uses: the default tenant, tenant normalisation, the bounded metric
label and the dominant share (Ghodsi et al.: the maximum over resources of
usage / total, divided by the tenant's weight).  The job-plane quota and
lease-queue code stays with the runtime, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

DEFAULT_TENANT = "default"


def normalize_tenant(tenant: Optional[str]) -> str:
    t = (tenant or "").strip()
    return t if t else DEFAULT_TENANT


def tenant_label(tenant: Optional[str], registered: Iterable[str]) -> str:
    """Bounded-cardinality metric label for a tenant: registered tenants
    (and the default) keep their name, anything else folds into
    ``other``."""
    t = normalize_tenant(tenant)
    if t == DEFAULT_TENANT or t in set(registered):
        return t
    return "other"


def dominant_share(
    usage: Optional[Dict[str, float]],
    totals: Optional[Dict[str, float]],
    weight: float = 1.0,
) -> float:
    """DRF dominant share: max over resources of usage/total, divided by
    the tenant's weight.  Resources absent from ``totals`` are ignored."""
    if not usage or not totals:
        return 0.0
    share = 0.0
    for r, used in usage.items():
        cap = totals.get(r, 0.0)
        if cap > 0 and used > 0:
            share = max(share, used / cap)
    return share / (weight if weight > 0 else 1.0)
