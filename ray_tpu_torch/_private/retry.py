"""Unified retry/backoff policy for every hardened RPC path.

One policy object replaces the fixed-interval ``time.sleep`` loops that
used to be scattered across rpc.py, raylet.py, worker.py, direct.py and
object_store.py.  Semantics follow the reference's retryable gRPC client
(reference: src/ray/rpc/retryable_grpc_client.h — bounded retries with
backoff against a restarting GCS) plus the "decorrelated jitter" scheme
from the AWS architecture blog: each delay is drawn from
``uniform(base, prev * 3)`` capped at ``cap_s``, which spreads synchronized
retry storms (a whole pod's workers reconnecting to a restarted GCS at
once) far better than exponential-with-full-jitter.

A policy is cheap and immutable; ``start()`` mints a ``Backoff`` cursor
carrying the attempt counter and the deadline budget.  Loops follow the
attempt-first shape::

    bo = POLICY.start()
    while True:
        try:
            return attempt()
        except TransientError:
            delay = bo.next_delay()
            if delay is None:        # budget exhausted
                raise
            time.sleep(delay)

When the chaos plane is seeded (``testing_chaos_seed`` >= 0) delays come
from a deterministically seeded stream so a fault drill replays with the
same timing decisions (see chaos.py).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch._private.config import CONFIG

_rng_lock = threading.Lock()
_rng: Optional[random.Random] = None
_rng_seeded_for: Optional[int] = None


def _shared_rng() -> random.Random:
    """Process-wide jitter source; reseeded whenever the chaos seed
    config changes so seeded drills get reproducible delays."""
    global _rng, _rng_seeded_for
    try:
        seed = int(CONFIG.testing_chaos_seed)
    except Exception:
        seed = -1
    with _rng_lock:
        if _rng is None or seed != _rng_seeded_for:
            _rng = random.Random(seed) if seed >= 0 else random.Random()
            _rng_seeded_for = seed
        return _rng


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with decorrelated jitter and a deadline budget.

    base_s:       first/minimum delay.
    cap_s:        per-delay ceiling.
    deadline_s:   total wall-clock budget across attempts and sleeps;
                  None = unbounded (max_attempts governs).
    max_attempts: total attempts allowed; None = unbounded (deadline
                  governs).  At least one of the two should be set.
    jitter:       "decorrelated" (default), "full", or "none".
    """

    base_s: float = 0.05
    cap_s: float = 5.0
    deadline_s: Optional[float] = None
    max_attempts: Optional[int] = None
    jitter: str = "decorrelated"
    # Metric label for retry_backoff_total; "" = not counted.
    name: str = ""

    def start(self, deadline_s: Optional[float] = None,
              rng: Optional[random.Random] = None) -> "Backoff":
        """New attempt cursor; deadline_s overrides the policy's budget
        (callers often carve it from a caller-supplied timeout)."""
        budget = self.deadline_s if deadline_s is None else deadline_s
        return Backoff(self, budget, rng or _shared_rng())


class Backoff:
    """One retry sequence: attempt counter + deadline + jittered delays."""

    __slots__ = ("policy", "attempt", "_deadline", "_prev", "_rng")

    def __init__(self, policy: RetryPolicy, deadline_s: Optional[float],
                 rng: random.Random):
        self.policy = policy
        self.attempt = 0
        self._deadline = None if deadline_s is None else time.monotonic() + deadline_s
        self._prev = policy.base_s
        self._rng = rng

    def remaining(self) -> Optional[float]:
        """Seconds left in the deadline budget (None = unbounded)."""
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def next_delay(self) -> Optional[float]:
        """Delay before the next attempt, or None when the budget (either
        attempts or deadline) is exhausted.  Delays never overshoot the
        deadline: the last sleep is clipped to what remains."""
        self.attempt += 1
        p = self.policy
        if p.max_attempts is not None and self.attempt >= p.max_attempts:
            return None
        if p.jitter == "decorrelated":
            delay = min(p.cap_s, self._rng.uniform(p.base_s, self._prev * 3))
            self._prev = delay
        elif p.jitter == "full":
            delay = self._rng.uniform(0, min(p.cap_s, p.base_s * (2 ** (self.attempt - 1))))
        else:
            delay = min(p.cap_s, p.base_s * (2 ** (self.attempt - 1)))
        rem = self.remaining()
        if rem is not None:
            if rem <= 0:
                return None
            delay = min(delay, rem)
        if p.name:
            from ray_tpu_torch._private import telemetry

            telemetry.count_retry(p.name)
        return delay


# ----------------------------------------------------------------------
# Shared policies for the hardened paths.  Tuned once here instead of
# per-call-site magic numbers; deadline budgets usually come from the
# caller via start(deadline_s=...).
# ----------------------------------------------------------------------

# Connect loops (rpc clients dialing a server that is still binding).
# Low cap: connect latency gates every startup path, so the jitter only
# decorrelates — it must not grow into whole-second stalls.
CONNECT = RetryPolicy(base_s=0.05, cap_s=0.25, name="connect")

# Readiness polls (wait-for-node/raylet registration).  Latency-critical:
# whoever awaits this gates scheduling decisions (e.g. the autoscaler's
# launch accounting), so delays stay near the base.
POLL = RetryPolicy(base_s=0.02, cap_s=0.1, name="poll")

# Reconnect loops against a restarting service (GCS).  Budget supplied
# by the caller from gcs_reconnect_timeout_s.
RECONNECT = RetryPolicy(base_s=0.25, cap_s=5.0, name="reconnect")

# Best-effort control-plane pushes (location reports etc.).
GCS_PUSH = RetryPolicy(base_s=0.1, cap_s=2.0, max_attempts=4, name="gcs_push")

# Local store re-reads racing spilling/eviction.
STORE_GET = RetryPolicy(base_s=0.02, cap_s=0.5, max_attempts=4, name="store_get")

# Argument resolution racing lineage reconstruction.
ARG_RESOLVE = RetryPolicy(base_s=0.2, cap_s=2.0, max_attempts=4, name="arg_resolve")

# KV reads racing an upload that is in flight.
KV_STAGING = RetryPolicy(base_s=0.1, cap_s=1.0, name="kv_staging")

# Idempotent submit/lease RPCs whose reply was lost in flight (the
# server dedupes redeliveries by token — see docs/failure_semantics.md).
SUBMIT = RetryPolicy(base_s=0.1, cap_s=1.0, max_attempts=4, name="submit")

# Owner-side stream-item polls (push path fallback probes).
STREAM_POLL = RetryPolicy(base_s=0.01, cap_s=0.1, name="stream_poll")

# Raylet object-manager pull probes against a not-yet-sealed object.
PULL_PROBE = RetryPolicy(base_s=0.05, cap_s=1.0, name="pull_probe")

# bench.py chip probe: attempts are whole subprocesses, so delays are
# coarse.
BENCH_PROBE = RetryPolicy(base_s=1.0, cap_s=15.0, name="bench_probe")

# Idempotent GCS reads (kv_get, object locations) whose reply was lost in
# flight: re-asking has no side effects, so a CallTimeout gets a bounded
# retry instead of failing the caller (see rpc.call_idempotent).  Callers
# MUST pass a short per-attempt timeout — retrying multiplies it.
GCS_READ = RetryPolicy(base_s=0.1, cap_s=1.0, max_attempts=4, name="gcs_read")

# Variant for bulk reads whose single attempt is already expensive (large
# runtime_env packages): one retry only, so the worst case stays near the
# pre-retry budget instead of quadrupling it.
GCS_READ_BULK = RetryPolicy(base_s=0.25, cap_s=1.0, max_attempts=2, name="gcs_read_bulk")

# Serve long-poll listener re-dials a controller that may be mid-restart
# (or gone: serve.shutdown killed it).  Wall-clock budget, not attempt
# count: failures against a dead handle return near-instantly, so an
# attempt cap would shrink the restart grace window to whatever the
# jitter draws.  8 s rides out a controller crash-restart; after that
# the listener exits instead of retrying a dead host forever.
SERVE_LONG_POLL = RetryPolicy(base_s=0.25, cap_s=2.0, deadline_s=8.0,
                              name="serve_long_poll")

# Streaming-executor idle backoff: nothing dispatchable and nothing in
# flight, so the scheduler loop parks briefly.  Tight cap — this gates
# pipeline latency the moment upstream produces — but jittered so many
# concurrent executors don't tick in lockstep.  Unnamed on purpose: an
# idle tick is not a retry, and counting it would turn the
# retry_backoff_total "flapping dependency" signal into noise.
DATA_IDLE = RetryPolicy(base_s=0.002, cap_s=0.02)

# Collective-group rendezvous polls against the GCS KV (cpu_group).
# Latency-critical like POLL (every group member blocks on it at
# formation and elastic re-formation), but capped a little higher since
# a straggler rank may be a whole actor restart away.  The deadline
# budget comes from the caller (collective_rendezvous_timeout_s or the
# init_collective_group timeout).
RENDEZVOUS = RetryPolicy(base_s=0.02, cap_s=0.25, name="rendezvous")
