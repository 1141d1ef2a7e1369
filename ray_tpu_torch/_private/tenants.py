"""Multi-tenant job plane: tenant model, DRF fair-share math, quota checks.

"Millions of users" means many concurrent *jobs*, not one big one.  Every
job carries a ``tenant`` (a billing/isolation domain — defaults to
``"default"``) and a ``priority`` class within that tenant.  A tenant may
register a resource **quota** (CPU/GPU/memory/...) in the GCS; admission
(actors, placement groups) and the raylet lease path enforce it:
over-quota requests *park* with backpressure instead of queueing
unboundedly or failing.

Scheduling across tenants is DRF-style (dominant resource fairness,
Ghodsi et al.): each tenant's **dominant share** is the maximum over
resources of ``usage[r] / cluster_total[r]`` divided by the tenant's
weight; the scheduler always serves the tenant with the lowest dominant
share first, which converges on weighted fair shares without any central
assignment.  Within a tenant, higher ``priority`` wins, then FIFO.

This module is pure model + math shared by the GCS (admission, pending
ordering, preemption victim selection) and every raylet (lease-queue
ordering, quota gating) — no RPC, no asyncio, unit-testable in
isolation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private.common import ResourceSet

DEFAULT_TENANT = "default"

# Resources considered for dominant-share computation and quota checks.
# Custom resources flow through quota enforcement too (a quota may name
# any resource), but only these appear as metric label values — see
# resource_label() — so label cardinality stays bounded.
_LABELLED_RESOURCES = ("CPU", "GPU", "memory")


@dataclass
class TenantSpec:
    """One registered tenant: quota + scheduling weight + default
    priority.  Unregistered tenants implicitly get (no quota, weight 1.0,
    priority 0) — they compete on fair share alone."""

    name: str
    quota: ResourceSet = field(default_factory=ResourceSet)
    weight: float = 1.0
    priority: int = 0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "quota": dict(self.quota),
            "weight": self.weight,
            "priority": self.priority,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        return cls(
            name=d["name"],
            quota=ResourceSet.of(d.get("quota")),
            weight=float(d.get("weight", 1.0)) or 1.0,
            priority=int(d.get("priority", 0)),
        )


def normalize_tenant(tenant: Optional[str]) -> str:
    t = (tenant or "").strip()
    return t if t else DEFAULT_TENANT


def tenant_label(tenant: Optional[str], registered: Iterable[str]) -> str:
    """Bounded-cardinality metric label for a tenant: registered tenants
    (and the default) keep their name, anything else folds into
    ``other`` so a stream of ad-hoc tenant strings can't mint unbounded
    time series."""
    t = normalize_tenant(tenant)
    if t == DEFAULT_TENANT or t in set(registered):
        return t
    return "other"


def resource_label(resource: str) -> str:
    """Bounded-cardinality label for a resource name (custom resources
    fold into ``other``)."""
    return resource if resource in _LABELLED_RESOURCES else "other"


def dominant_share(
    usage: Optional[Dict[str, float]],
    totals: Optional[Dict[str, float]],
    weight: float = 1.0,
) -> float:
    """DRF dominant share: max over resources of usage/total, divided by
    the tenant's weight.  Resources absent from ``totals`` are ignored
    (nothing to be fair about for a resource the cluster doesn't have)."""
    if not usage or not totals:
        return 0.0
    share = 0.0
    for r, used in usage.items():
        cap = totals.get(r, 0.0)
        if cap > 0 and used > 0:
            share = max(share, used / cap)
    return share / (weight if weight > 0 else 1.0)


def over_quota(
    usage: Optional[Dict[str, float]],
    extra: Optional[Dict[str, float]],
    quota: Optional[Dict[str, float]],
) -> bool:
    """True iff ``usage + extra`` exceeds ``quota`` in any resource the
    quota names.  An empty/None quota never rejects (unlimited)."""
    if not quota:
        return False
    for r, cap in quota.items():
        have = (usage or {}).get(r, 0.0) + (extra or {}).get(r, 0.0)
        if have > cap + 1e-9:
            return True
    return False


def add_usage(into: Dict[str, Dict[str, float]], tenant: str, res: Dict[str, float]):
    """Accumulate ``res`` into ``into[tenant]`` (plain dicts, callers own
    the container)."""
    acc = into.setdefault(tenant, {})
    for k, v in res.items():
        if v:
            acc[k] = acc.get(k, 0.0) + v


@dataclass
class LeaseWaiter:
    """One parked worker-lease request in a raylet's fair-share queue."""

    res: ResourceSet
    fut: object  # asyncio.Future granted with True
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    seq: int = 0
    enqueued: float = field(default_factory=time.monotonic)


def pick_next(
    waiters: Iterable[LeaseWaiter],
    available: ResourceSet,
    usage: Dict[str, Dict[str, float]],
    totals: Dict[str, float],
    tenants: Dict[str, TenantSpec],
    enforce_quota: bool = True,
) -> Optional[LeaseWaiter]:
    """Fair-share selection for one grant.

    Per tenant, only the *best* waiter is a candidate (highest priority,
    then FIFO) — no intra-tenant queue-jumping, so a stream of small
    requests can never starve a parked large one of the same tenant.
    Across tenants, candidates are served in ascending dominant-share
    order (weighted DRF); a candidate whose tenant is over quota, or
    whose shape doesn't fit ``available``, is skipped — other tenants
    keep the node busy (work conservation)."""
    heads: Dict[str, LeaseWaiter] = {}
    for w in waiters:
        fut = w.fut
        if fut is not None and getattr(fut, "done", None) and fut.done():
            continue
        cur = heads.get(w.tenant)
        if cur is None or (-w.priority, w.seq) < (-cur.priority, cur.seq):
            heads[w.tenant] = w
    if not heads:
        return None

    def order_key(item: Tuple[str, LeaseWaiter]):
        tenant, w = item
        spec = tenants.get(tenant)
        weight = spec.weight if spec else 1.0
        return (
            dominant_share(usage.get(tenant), totals, weight),
            -w.priority,
            w.seq,
        )

    for tenant, w in sorted(heads.items(), key=order_key):
        if not w.res.fits_in(available):
            continue
        if enforce_quota:
            spec = tenants.get(tenant)
            if spec is not None and over_quota(usage.get(tenant), w.res, spec.quota):
                continue
        return w
    return None


def fair_dispatch_order(
    entries: List[Tuple[str, int, int, object]],
    usage: Dict[str, Dict[str, float]],
    totals: Dict[str, float],
    tenants: Dict[str, TenantSpec],
) -> List[object]:
    """Tenant-fair ordering for a raylet's mediated dispatch queue —
    the same rule the lease queue applies per grant, adapted to a whole
    queue pass: within a tenant strictly (priority desc, FIFO), so no
    intra-tenant queue-jumping; across tenants round-robin in ascending
    weighted dominant share, so the low-share tenant's head runs first
    but a burst from one tenant can't monopolize an entire pass (the
    lease path re-evaluates share per grant; the round-robin is that
    re-evaluation's queue-pass approximation).

    ``entries`` are ``(tenant, priority, seq, item)``; returns items.
    """
    by_tenant: Dict[str, List[Tuple[int, int, object]]] = {}
    for tenant, priority, seq, item in entries:
        by_tenant.setdefault(tenant, []).append((-priority, seq, item))
    for lst in by_tenant.values():
        lst.sort(key=lambda t: (t[0], t[1]))

    def tenant_key(tenant: str):
        spec = tenants.get(tenant)
        weight = spec.weight if spec else 1.0
        head = by_tenant[tenant][0]
        return (dominant_share(usage.get(tenant), totals, weight), head[0], head[1])

    order = sorted(by_tenant, key=tenant_key)
    out: List[object] = []
    depth = 0
    while True:
        emitted = False
        for tenant in order:
            lst = by_tenant[tenant]
            if depth < len(lst):
                out.append(lst[depth][2])
                emitted = True
        if not emitted:
            return out
        depth += 1


def preemption_victim_order(
    jobs: List[dict],
    usage: Dict[str, Dict[str, float]],
    totals: Dict[str, float],
    tenants: Dict[str, TenantSpec],
) -> List[dict]:
    """Order candidate victim jobs for priority preemption: over-quota
    tenants first, then highest dominant share, then lowest priority,
    then youngest job (least sunk work).  Each ``job`` dict needs
    ``tenant``, ``priority`` and ``start_time``."""

    def key(job: dict):
        tenant = normalize_tenant(job.get("tenant"))
        spec = tenants.get(tenant)
        over = (
            spec is not None
            and bool(spec.quota)
            and over_quota(usage.get(tenant), None, spec.quota)
        )
        share = dominant_share(
            usage.get(tenant), totals, spec.weight if spec else 1.0
        )
        return (
            0 if over else 1,  # over-quota tenants first
            -share,
            int(job.get("priority", 0)),
            -float(job.get("start_time", 0.0)),  # youngest first
        )

    return sorted(jobs, key=key)
