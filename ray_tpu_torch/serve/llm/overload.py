"""SLO classes and the brownout ladder for the serving engine.

The port's own copy of the engine's half of
``ray_tpu/serve/llm/overload.py``: SLO classes map request intent to a
priority the engine's fair queue and lane preemption understand
(``interactive`` > ``standard`` > ``batch``), and ``DegradationController``
steps service down under TTFT / queue-depth SLO violation (shrink
batch-class ``max_new_tokens`` -> shed batch -> shed standard, never
interactive) and back up, with hysteresis on both edges.  The proxy's
token-rate quotas stay with the serve control plane, not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

# SLO class -> engine priority.  Higher wins the intra-tenant queue and
# may preempt running lanes of strictly lower priority.
SLO_PRIORITY: Dict[str, int] = {"interactive": 2, "standard": 1, "batch": 0}
DEFAULT_SLO = "standard"

# Brownout ladder levels:
#   0  normal service
#   1  batch-class max_new_tokens clamped (cheapest degradation first)
#   2  batch class shed
#   3  standard class shed too — interactive is NEVER shed by brownout
LEVEL_MAX = 3


def normalize_slo(slo: Optional[str]) -> str:
    """Fold any request-supplied SLO string to a known class (unknown /
    empty -> ``standard``)."""
    s = (slo or "").strip().lower()
    return s if s in SLO_PRIORITY else DEFAULT_SLO


class DegradationController:
    """Hysteresis brownout ladder driven by observed TTFT + queue depth.

    One ``tick`` per control interval.  A tick is a *violation* when TTFT
    p95 exceeds ``ttft_slo_s`` or the waiting queue exceeds
    ``queue_high``; it is *healthy* only when both signals are inside the
    recovery margin (``recover_margin`` x the bound); ticks in between
    hold the level.  ``down_ticks`` consecutive violations step down one
    level, ``up_ticks`` consecutive healthy ticks step up one level, and
    any opposing tick resets both counters.

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
        never shed by brownout."""
        s = normalize_slo(slo)
        if s == "interactive":
            return False
        if s == "batch":
            return self.level >= 2
        return self.level >= 3  # standard

    def max_tokens_cap(self, slo: str, requested: int) -> int:
        """Level >= 1 shrinks batch-class generation budgets."""
        if self.level >= 1 and normalize_slo(slo) == "batch":
            return min(int(requested), self.batch_max_tokens)
        return int(requested)
