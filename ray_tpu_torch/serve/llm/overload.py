"""Overload-resilient serving: SLO classes, token-rate quotas, brownout.

Pure model + math for the serving plane's overload armor (the serving
counterpart of ``_private/tenants.py``, which owns the job plane's DRF
math — the engine reuses that module's ``dominant_share`` for its fair
waiting queue; this one owns what is serving-specific):

- **SLO classes** map request intent to a priority the engine's fair
  queue and lane preemption understand: ``interactive`` (latency-bound,
  never shed by brownout) > ``standard`` (the default) > ``batch``
  (throughput traffic, first to degrade).
- **TokenBucket** is the proxy's per-tenant token-rate quota over
  prompt + generated tokens: admission charges the request's worst-case
  cost up front, completion/disconnect refunds the unused part, so a
  tenant's sustained rate converges on its quota regardless of how many
  requests it opens.
- **DegradationController** is the brownout ladder: observed TTFT /
  queue-depth SLO violation steps service down one level at a time
  (shrink batch-class ``max_new_tokens`` -> shed batch -> shed
  standard — NEVER interactive) and back up, with hysteresis on both
  edges so the control loop converges instead of flapping.

No engine, no asyncio, no torch: the HTTP proxy imports it.  The port's
copy of ``ray_tpu/serve/llm/overload.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

# SLO class -> engine priority.  Higher wins the intra-tenant queue and
# may preempt running lanes of strictly lower priority.
SLO_PRIORITY: Dict[str, int] = {"interactive": 2, "standard": 1, "batch": 0}
SLO_CLASSES = tuple(SLO_PRIORITY)
DEFAULT_SLO = "standard"


def normalize_slo(slo: Optional[str]) -> str:
    """Fold any request-supplied SLO string to a known class (unknown /
    empty -> ``standard``) — SLO strings come off the wire, so they must
    never mint unbounded label values or KeyError the engine."""
    s = (slo or "").strip().lower()
    return s if s in SLO_PRIORITY else DEFAULT_SLO


def slo_priority(slo: Optional[str]) -> int:
    return SLO_PRIORITY[normalize_slo(slo)]


class TokenBucket:
    """Token-rate quota: ``rate`` tokens/s refill up to ``burst``.

    ``charge`` is admission (deduct the request's worst-case token cost;
    refuse without deducting when the bucket can't cover it), ``refund``
    returns the unused part of a charge (completion knows the actual
    generated count; disconnect knows how much streamed).  Negative
    balance is impossible by construction, so a refund bug can only
    under-throttle one burst, never wedge a tenant permanently."""

    def __init__(self, rate: float, burst: float):
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._t_last = time.monotonic()

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self._t_last)
        self._t_last = now
        self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def level(self, now: Optional[float] = None) -> float:
        self._refill(now if now is not None else time.monotonic())
        return self._tokens

    def charge(self, n: float, now: Optional[float] = None) -> bool:
        """Deduct ``n`` tokens; False (and no deduction) when short."""
        self._refill(now if now is not None else time.monotonic())
        if n > self._tokens:
            return False
        self._tokens -= n
        return True

    def refund(self, n: float) -> None:
        if n > 0:
            self._tokens = min(self.burst, self._tokens + n)

    def retry_after(self, n: float, now: Optional[float] = None) -> float:
        """Seconds until ``n`` tokens will be available (the 429's
        Retry-After), floored at 1s so clients back off meaningfully."""
        self._refill(now if now is not None else time.monotonic())
        deficit = max(0.0, min(n, self.burst) - self._tokens)
        if deficit <= 0.0:
            return 1.0
        if self.rate <= 0.0:
            return 60.0
        return max(1.0, deficit / self.rate)


class TenantBuckets:
    """Per-tenant token buckets from a ``{tenant: {"rate", "burst"}}``
    quota table (the deployment's ``tenant_quotas``).  Tenants without a
    quota are unlimited — quotas are opt-in armor, not a registration
    requirement."""

    def __init__(self, quotas: Optional[Dict[str, dict]] = None):
        self.quotas = dict(quotas or {})
        self._buckets: Dict[str, TokenBucket] = {}

    def registered(self):
        """Quota'd tenant names — the bounded metric-label domain."""
        return self.quotas.keys()

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        q = self.quotas.get(tenant)
        if not q:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                float(q.get("rate", 0.0)),
                float(q.get("burst", max(1.0, float(q.get("rate", 0.0))))),
            )
        return b

    def charge(self, tenant: str, n: float,
               now: Optional[float] = None) -> Tuple[bool, float]:
        """(admitted, retry_after_s) for charging ``n`` tokens."""
        b = self._bucket(tenant)
        if b is None:
            return True, 0.0
        if b.charge(n, now):
            return True, 0.0
        return False, b.retry_after(n, now)

    def refund(self, tenant: str, n: float) -> None:
        b = self._bucket(tenant)
        if b is not None:
            b.refund(n)


# Brownout ladder levels (docs/serving.md):
#   0  normal service
#   1  batch-class max_new_tokens clamped (cheapest degradation first)
#   2  batch class shed (429/typed RequestShedError)
#   3  standard class shed too — interactive is NEVER shed by brownout
LEVEL_MAX = 3


class DegradationController:
    """Hysteresis brownout ladder driven by observed TTFT + queue depth.

    One ``tick`` per control interval (the engine ticks it at its 1 Hz
    metrics cadence).  A tick is a *violation* when TTFT p95 exceeds
    ``ttft_slo_s`` or the waiting queue exceeds ``queue_high``; it is
    *healthy* only when both signals are inside the recovery margin
    (``recover_margin`` x the bound).  Ticks in the band between count
    as neither — the level holds.  ``down_ticks`` consecutive violations
    step DOWN one level (degrade further); ``up_ticks`` consecutive
    healthy ticks step UP one level (recover).  Both counters reset on
    any opposing tick, so the loop converges monotonically under a
    sustained condition and cannot flap on a boundary oscillation.

    ``ttft_slo_s <= 0`` disables the ladder entirely (level pinned 0)."""

    def __init__(
        self,
        ttft_slo_s: float,
        queue_high: int,
        down_ticks: int = 3,
        up_ticks: int = 5,
        recover_margin: float = 0.7,
        batch_max_tokens: int = 8,
    ):
        self.ttft_slo_s = float(ttft_slo_s)
        self.queue_high = max(1, int(queue_high))
        self.down_ticks = max(1, int(down_ticks))
        self.up_ticks = max(1, int(up_ticks))
        self.recover_margin = min(1.0, max(0.0, float(recover_margin)))
        self.batch_max_tokens = max(1, int(batch_max_tokens))
        self.level = 0
        self.transitions = 0
        self._viol = 0
        self._ok = 0

    @property
    def enabled(self) -> bool:
        return self.ttft_slo_s > 0.0

    def tick(self, ttft_p95: Optional[float], queue_depth: int) -> int:
        """One control interval; returns the (possibly new) level."""
        if not self.enabled:
            return self.level
        violating = bool(
            (ttft_p95 is not None and ttft_p95 > self.ttft_slo_s)
            or queue_depth > self.queue_high
        )
        healthy = (
            (ttft_p95 is None or ttft_p95 <= self.ttft_slo_s * self.recover_margin)
            and queue_depth <= self.queue_high * self.recover_margin
        )
        if violating:
            self._ok = 0
            self._viol += 1
            if self._viol >= self.down_ticks and self.level < LEVEL_MAX:
                self.level += 1
                self.transitions += 1
                self._viol = 0
        elif healthy:
            self._viol = 0
            self._ok += 1
            if self._ok >= self.up_ticks and self.level > 0:
                self.level -= 1
                self.transitions += 1
                self._ok = 0
        else:
            # hysteresis band: hold the level, restart both streaks
            self._viol = 0
            self._ok = 0
        return self.level

    def should_shed(self, slo: str) -> bool:
        """True when the current level sheds this class.  Interactive is
        never shed by brownout — by construction, not by configuration."""
        s = normalize_slo(slo)
        if s == "interactive":
            return False
        if s == "batch":
            return self.level >= 2
        return self.level >= 3  # standard

    def max_tokens_cap(self, slo: str, requested: int) -> int:
        """Level >= 1 shrinks batch-class generation budgets — the
        cheapest degradation: batch work completes, just shorter."""
        if self.level >= 1 and normalize_slo(slo) == "batch":
            return min(int(requested), self.batch_max_tokens)
        return int(requested)
