"""Flight-recorder instrumentation for the core hot paths.

One place defines every built-in metric (catalog: docs/observability.md)
so names/tags stay consistent across layers: RPC latency on both client
and server sides, task phase transitions (submit -> lease -> queue ->
exec -> e2e), object-store put/get, retry/backoff activity, chaos
injections, and Train step timing.  Everything funnels through
``ray_tpu_torch.util.metrics`` and rides its per-process flusher to the GCS
metrics table.

The module is deliberately lazy: nothing imports ``ray_tpu_torch.util`` until
the first instrumented event fires, because rpc.py (imported at the very
bottom of the package import graph) pulls this module in at import time.
The per-event fast path when telemetry is off is a single cached boolean
check.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.config import CONFIG

_enabled: Optional[bool] = None
_m = None

# Finer low-end than the Prometheus defaults: local-socket RPCs and store
# ops sit well under 5 ms, and the interesting regressions are 100 us
# shifts, not whole buckets.
_LATENCY_BUCKETS = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
]


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        try:
            _enabled = bool(CONFIG.telemetry_enabled)
        except Exception:
            _enabled = True
    return _enabled


def refresh() -> None:
    """Re-read CONFIG.telemetry_enabled (tests toggle it)."""
    global _enabled
    _enabled = None


class _Metrics:
    """Lazily-constructed metric instances (shared registry lives in
    util.metrics; constructing twice under race is harmless — instances
    are just views onto (name, tags) records)."""

    def __init__(self):
        from ray_tpu_torch.util import metrics as m

        self.rpc_latency = m.Histogram(
            "rpc_latency_seconds",
            "RPC latency: side=client is full round-trip, side=server is handler time",
            boundaries=_LATENCY_BUCKETS,
            tag_keys=("method", "side"),
        )
        self.rpc_errors = m.Counter(
            "rpc_errors_total",
            "RPC failures by kind (timeout, connection_lost, handler)",
            tag_keys=("method", "kind"),
        )
        self.retries = m.Counter(
            "retry_backoff_total",
            "retries scheduled by the unified backoff policies",
            tag_keys=("policy",),
        )
        self.chaos = m.Counter(
            "chaos_injections_total",
            "fault injections fired by the chaos plane",
            tag_keys=("pattern", "action"),
        )
        self.chaos_net = m.Counter(
            "chaos_net_injections_total",
            "link-level (net:<src>-><dst>) fault injections fired: frames "
            "blackholed by cut/flaky or delayed by slow, per rule",
            tag_keys=("pattern", "action"),
        )
        self.task_phase = m.Histogram(
            "task_phase_seconds",
            "task lifecycle phases: submit (driver push), lease (worker grant), "
            "queue (raylet wait), exec (worker run), e2e (submit->result)",
            boundaries=_LATENCY_BUCKETS,
            tag_keys=("phase",),
        )
        self.store_latency = m.Histogram(
            "object_store_op_seconds",
            "object store client op latency",
            boundaries=_LATENCY_BUCKETS,
            tag_keys=("op",),
        )
        self.store_bytes = m.Counter(
            "object_store_bytes_total",
            "bytes moved through the object store client",
            tag_keys=("op",),
        )
        self.train_step = m.Histogram(
            "train_step_seconds",
            "wall time between consecutive train.report calls per rank",
            boundaries=[0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0],
            tag_keys=("rank",),
        )
        self.drain_events = m.Counter(
            "drain_events_total",
            "node drains initiated, by reason (PREEMPTION, IDLE_TERMINATION)",
            tag_keys=("reason",),
        )
        self.drain_migration = m.Histogram(
            "drain_migration_seconds",
            "time from drain start until actors are migrated and sole-copy "
            "objects are re-replicated off the draining node",
            boundaries=[0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0],
        )
        self.train_resize_events = m.Counter(
            "train_resize_events_total",
            "elastic worker-group resizes, by direction (shrink, grow) and "
            "trigger (drain, worker_death, capacity_return)",
            tag_keys=("direction", "trigger"),
        )
        self.train_resize = m.Histogram(
            "train_resize_seconds",
            "wall time of one elastic resize: teardown of affected ranks, "
            "generation-bumped re-rendezvous, session restart",
            boundaries=[0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0],
            tag_keys=("direction",),
        )
        # --- multi-tenant job plane (tenant label values are clamped to
        # registered tenants + "default"/"other" via tenants.tenant_label
        # so cardinality stays bounded) ---
        self.tenant_usage = m.Gauge(
            "tenant_usage",
            "cluster-wide resources in use per tenant (GCS aggregation "
            "over raylet reports)",
            tag_keys=("tenant", "resource"),
        )
        self.tenant_dominant_share = m.Gauge(
            "tenant_dominant_share",
            "DRF dominant share per tenant: max over resources of "
            "usage/cluster_total, divided by the tenant's weight",
            tag_keys=("tenant",),
        )
        self.tenant_lease_wait = m.Histogram(
            "tenant_lease_wait_seconds",
            "time a worker-lease request spent parked in the raylet's "
            "fair-share queue before its grant",
            boundaries=_LATENCY_BUCKETS,
            tag_keys=("tenant",),
        )
        self.tenant_parked = m.Counter(
            "tenant_parked_total",
            "admissions/leases parked by the tenant plane, by reason "
            "(quota, fair_share)",
            tag_keys=("tenant", "reason"),
        )
        self.tenant_preemptions = m.Counter(
            "tenant_preemptions_total",
            "priority preemptions by victim tenant and action (notice, "
            "shrink, actor_restart)",
            tag_keys=("tenant", "action"),
        )
        self.span_table_evictions = m.Counter(
            "span_table_evictions_total",
            "records evicted from the GCS span/profile flight-recorder "
            "tables, by tenant (per-tenant quota clamp or global ring cap)",
            tag_keys=("tenant",),
        )
        # --- per-node drain budget (no node label: each raylet reports
        # through its own channel, keyed by node id at the GCS) ---
        self.drain_deadline_remaining = m.Gauge(
            "drain_deadline_remaining_seconds",
            "seconds left in this node's drain notice window (0 when not "
            "draining); reported per node via the raylet report channel",
        )
        self.drain_inflight_tasks = m.Gauge(
            "drain_inflight_tasks",
            "tasks still running on this draining node (racing the "
            "deadline); 0 when not draining",
        )
        self.lost_capacity_records = m.Counter(
            "lost_capacity_records_total",
            "preempted/lost worker-node capacity records published to the "
            "autoscaler replacement feed, by reason",
            tag_keys=("reason",),
        )
        self.node_suspicion = m.Gauge(
            "node_suspicion_score",
            "GCS suspicion score per node (0 = healthy .. 1 = presumed "
            "dead), blended from heartbeat gap, RPC error/latency and "
            "channel-health signals; crossing the suspect threshold "
            "soft-cordons the node (SUSPECT), sustained suspicion "
            "escalates to QUARANTINED or DEAD",
            tag_keys=("node",),
        )
        self.node_fence_rejections = m.Counter(
            "node_fence_rejections_total",
            "raylet-originated RPCs rejected because they carried a stale "
            "(node_id, incarnation) — writes from a fenced zombie can "
            "never admit work or resurrect freed object copies",
            tag_keys=("method",),
        )
        self.node_quarantine = m.Counter(
            "node_quarantine_total",
            "node quarantine transitions (direction = enter, exit); "
            "reason = gray_failure on entry, recovered / flap_budget on "
            "exit decisions",
            tag_keys=("reason", "direction"),
        )
        self.telemetry_dropped = m.Counter(
            "telemetry_dropped_total",
            "client-side records dropped instead of delivered to the GCS "
            "(bounded buffers tripping across an outage), by reason",
            tag_keys=("reason",),
        )
        # --- LLM serving plane (deployment label values are deployment
        # names — operator-chosen and bounded) ---
        self.serve_queue_depth = m.Gauge(
            "serve_queue_depth",
            "requests waiting in a replica's engine queue (not yet in a "
            "decode lane) — the autoscaling signal",
            tag_keys=("deployment",),
        )
        self.serve_tokens_per_s = m.Gauge(
            "serve_tokens_per_s",
            "tokens generated per second by a replica's engine (5 s "
            "sliding window)",
            tag_keys=("deployment",),
        )
        self.serve_ttft = m.Histogram(
            "serve_ttft_seconds",
            "time to first token: request admission -> first sampled "
            "token (queue wait + prefill)",
            boundaries=_LATENCY_BUCKETS,
            tag_keys=("deployment",),
        )
        self.serve_kv_blocks = m.Gauge(
            "serve_kv_blocks_in_use",
            "KV cache blocks currently allocated to live sequences; must "
            "return to 0 when the engine drains (leak signal)",
            tag_keys=("deployment",),
        )
        self.serve_shed = m.Counter(
            "serve_shed_total",
            "requests shed by overload protection, by where (proxy = "
            "per-deployment in-flight bound, quota = per-tenant token "
            "bucket, engine = waiting-queue bound, brownout = degradation "
            "ladder) and tenant (clamped to quota'd tenants + default/other)",
            tag_keys=("deployment", "where", "tenant"),
        )
        self.serve_preemptions = m.Counter(
            "serve_preemptions_total",
            "decode lanes preempted-by-recompute so a higher-priority "
            "request could run, by the VICTIM's SLO class",
            tag_keys=("deployment", "slo"),
        )
        self.serve_degradation_level = m.Gauge(
            "serve_degradation_level",
            "brownout ladder level (0 normal, 1 batch max_tokens clamped, "
            "2 batch shed, 3 standard shed; interactive is never shed)",
            tag_keys=("deployment",),
        )
        self.serve_tenant_tokens_per_s = m.Gauge(
            "serve_tenant_tokens_per_s",
            "tokens generated per second attributed to one tenant (5 s "
            "sliding window; tenant clamped to quota'd + default/other)",
            tag_keys=("deployment", "tenant"),
        )
        self.serve_multiplex_evictions = m.Counter(
            "serve_multiplex_evictions_total",
            "multiplexed model variants evicted from a replica's LRU cache "
            "to admit a different model_id",
            tag_keys=("deployment",),
        )
        # --- profiling & bottleneck-attribution plane ---
        self.profile_sessions = m.Counter(
            "profile_sessions_total",
            "sampling-profiler sessions by outcome (completed, conflict)",
            tag_keys=("state",),
        )
        self.device_memory = m.Gauge(
            "device_memory_bytes",
            "per-device memory from torch.cuda.memory_stats() "
            "(kind = in_use, peak, limit); absent in processes without "
            "torch or without a card",
            tag_keys=("device", "kind"),
        )
        # --- compiled-DAG dataplane (experimental/channel.py + dag/) ---
        self.channel_ops = m.Counter(
            "channel_ops_total",
            "seqlock ring-channel operations (op = read, write); flushed "
            "in batches off the hot path",
            tag_keys=("op",),
        )
        self.channel_blocked = m.Counter(
            "channel_blocked_seconds_total",
            "seconds channel ops spent blocked waiting on the peer "
            "(write = reader hasn't acked, read = writer hasn't published; "
            "transport = ring, the same-host shm ring, or socket, the "
            "cross-host link)",
            tag_keys=("op", "transport"),
        )
        self.channel_timeouts = m.Counter(
            "channel_timeouts_total",
            "channel ops that hit their timeout (the caller's retry "
            "signal), by op",
            tag_keys=("op",),
        )
        self.dag_op = m.Histogram(
            "dag_op_seconds",
            "execution time of one op (actor method body) inside a "
            "compiled-DAG resident loop",
            boundaries=_LATENCY_BUCKETS,
            tag_keys=("method",),
        )
        self.dag_executions = m.Counter(
            "dag_executions_total",
            "compiled-DAG executions submitted by drivers",
        )
        self.dag_inflight = m.Gauge(
            "dag_inflight",
            "compiled-DAG executions in flight (submitted, result not yet "
            "read) — channel-plane occupancy as seen by the driver",
        )
        self.channel_corruption = m.Counter(
            "channel_corruption_total",
            "frames whose CRC32 trailer (or record framing) failed "
            "validation on read — the frame is consumed and the typed "
            "ChannelCorruptionError raised; user code never sees the "
            "payload.  Nonzero outside chaos drills means shm/network "
            "corruption or a torn writer",
        )
        self.channel_reattach = m.Counter(
            "channel_reattach_total",
            "epoch-bumped channel reattach attempts after a peer-death "
            "signal (result = ok, failed); ok means the edge resumed "
            "with seq-replay instead of tearing down its consumer",
            tag_keys=("result",),
        )
        self.channel_shm_reclaimed = m.Counter(
            "channel_shm_reclaimed_total",
            "orphaned ring/fan-out shm files reclaimed by the raylet "
            "sweeper because every registered owner PID was dead — the "
            "tmpfs-leak-after-SIGKILL backstop",
        )
        self.channel_fanout_evictions = m.Counter(
            "channel_fanout_evictions_total",
            "fan-out reader cursors evicted because the reader's "
            "registered PID was dead — a SIGKILLed reader no longer "
            "wedges the broadcast writer",
        )
        self.socket_connects = m.Counter(
            "socket_channel_connects_total",
            "cross-host socket-channel dial outcomes (result = ok, "
            "refused); refused after the retry budget means a consumed "
            "or dead listener — the compiled edge must be rebuilt",
            tag_keys=("result",),
        )
        self.serve_dataplane_requests = m.Counter(
            "serve_dataplane_requests_total",
            "serve router→replica requests carried over compiled channels "
            "instead of per-call actor RPC (kind = call, stream); compare "
            "with serve_queue_depth-era RPC volume for adoption",
            tag_keys=("kind",),
        )
        self.serve_dataplane_items = m.Counter(
            "serve_dataplane_stream_items_total",
            "stream items (e.g. generated tokens) returned over serve "
            "compiled channels — each one replaces an object-store hop",
        )
        # --- podracer RLlib streaming plane (rllib/core/stream.py) ---
        self.rllib_queue_depth = m.Gauge(
            "rllib_trajectory_queue_depth",
            "trajectory fragments buffered in the learner-side intake "
            "queue — sustained full = learner-bound, empty = runner-bound",
        )
        self.rllib_learner_idle = m.Gauge(
            "rllib_learner_idle_fraction",
            "fraction of the learner loop's wall time spent waiting for "
            "trajectory fragments since the last update",
        )
        self.rllib_weight_lag = m.Histogram(
            "rllib_weight_lag_generations",
            "weight generations a consumed fragment trailed the learner "
            "by (off-policy staleness; bounded by max_weight_lag)",
            boundaries=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
        )
        self.rllib_env_steps = m.Counter(
            "rllib_env_steps_total",
            "valid environment steps collected by streaming env runners "
            "(counted runner-side per fragment)",
        )
        # --- sharded training plane (train/sharding/) ---
        self.pipeline_stage = m.Histogram(
            "pipeline_stage_seconds",
            "per-step compute-busy seconds of one MPMD pipeline stage "
            "(channel wait excluded) — the stage-balance signal",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                        10.0, 30.0, 60.0],
            tag_keys=("stage",),
        )
        self.pipeline_bubble = m.Gauge(
            "pipeline_bubble_fraction",
            "fraction of a pipeline stage's step wall time spent idle "
            "(1 - busy/wall); floor is (S-1)/(S-1+M) under 1F1B",
            tag_keys=("stage",),
        )
        self.grow_hints = m.Counter(
            "train_grow_hints_total",
            "elastic-trainer grow intents published to the autoscaler "
            "feed, by action (publish, clear)",
            tag_keys=("action",),
        )
        # --- durable checkpoint plane (train/checkpoint_plane.py) ---
        self.checkpoint_write = m.Histogram(
            "checkpoint_write_seconds",
            "serialize+CRC+write+commit seconds for one checkpoint "
            "persist (mode = sync: the train step stalled for it; "
            "async: a background writer paid it off the train loop)",
            boundaries=[0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                        30.0, 60.0, 120.0],
            tag_keys=("mode",),
        )
        self.checkpoint_commit = m.Counter(
            "checkpoint_commit_total",
            "checkpoint manifest commit attempts (result = committed, "
            "failed); only a committed manifest makes a checkpoint "
            "adoptable — anything short of it is GC-eligible debris",
            tag_keys=("result",),
        )
        self.checkpoint_restore_fallbacks = m.Counter(
            "checkpoint_restore_fallbacks_total",
            "restore candidates rejected by manifest/CRC32 verification "
            "(CheckpointCorruptionError) before a verified checkpoint "
            "loaded — nonzero outside chaos drills means storage "
            "corruption or a writer SIGKILLed mid-commit",
        )
        self.checkpoint_gc_reclaimed = m.Counter(
            "checkpoint_gc_reclaimed_total",
            "checkpoint directories reclaimed by retention GC: committed "
            "ones past the keep-K window plus uncommitted debris past "
            "the grace period (the mid-write-SIGKILL residue backstop)",
        )


def _metrics() -> _Metrics:
    global _m
    if _m is None:
        _m = _Metrics()
    return _m


# ----------------------------------------------------------------------
# event helpers — each is a no-op (one boolean check) when telemetry is
# off, and one pre-bound histogram/counter write when on.  Bound
# instruments (series resolved once per label combo, cached here) keep
# the per-event cost at lock + record update; label cardinality is
# bounded by (method x side), so the cache can't grow unboundedly.
# ----------------------------------------------------------------------
# Per-helper caches keyed directly by the label values (flat keys) so
# the hot path is one dict lookup + one bound write; the shared miss
# path binds the series once per label combo.
_rpc_bound: dict = {}
_rpc_err_bound: dict = {}
_retry_bound: dict = {}
_chaos_bound: dict = {}
_chaos_net_bound: dict = {}
_phase_bound: dict = {}
_store_bound: dict = {}
_store_bytes_bound: dict = {}
_train_bound: dict = {}


def _bind(cache: dict, key, metric_attr: str, tags: dict):
    """Cache-miss path: resolve the (metric, tags) series once.  Off the
    hot path by construction — callers only land here on a new label
    combo."""
    return cache.setdefault(key, getattr(_metrics(), metric_attr).bound(tags))


def observe_rpc(method: str, side: str, seconds: float) -> None:
    if not enabled():
        return
    b = _rpc_bound.get((method, side)) or _bind(
        _rpc_bound, (method, side), "rpc_latency", {"method": method, "side": side}
    )
    b.observe(seconds)


def count_rpc_error(method: str, kind: str) -> None:
    if not enabled():
        return
    b = _rpc_err_bound.get((method, kind)) or _bind(
        _rpc_err_bound, (method, kind), "rpc_errors", {"method": method, "kind": kind}
    )
    b.inc(1.0)


def count_retry(policy: str) -> None:
    if not enabled():
        return
    policy = policy or "anonymous"
    b = _retry_bound.get(policy) or _bind(
        _retry_bound, policy, "retries", {"policy": policy}
    )
    b.inc(1.0)


def count_chaos(pattern: str, action: str) -> None:
    if not enabled():
        return
    b = _chaos_bound.get((pattern, action)) or _bind(
        _chaos_bound, (pattern, action), "chaos", {"pattern": pattern, "action": action}
    )
    b.inc(1.0)


def count_chaos_net(pattern: str, action: str) -> None:
    if not enabled():
        return
    b = _chaos_net_bound.get((pattern, action)) or _bind(
        _chaos_net_bound, (pattern, action), "chaos_net",
        {"pattern": pattern, "action": action},
    )
    b.inc(1.0)


def observe_task_phase(phase: str, seconds: float) -> None:
    if not enabled():
        return
    b = _phase_bound.get(phase) or _bind(
        _phase_bound, phase, "task_phase", {"phase": phase}
    )
    b.observe(seconds if seconds > 0.0 else 0.0)


def observe_store(op: str, seconds: float, nbytes: Optional[int] = None) -> None:
    if not enabled():
        return
    b = _store_bound.get(op) or _bind(_store_bound, op, "store_latency", {"op": op})
    b.observe(seconds)
    if nbytes:
        count_store_bytes(op, nbytes)


def count_store_bytes(op: str, nbytes: int) -> None:
    if not enabled() or not nbytes:
        return
    b = _store_bytes_bound.get(op) or _bind(
        _store_bytes_bound, op, "store_bytes", {"op": op}
    )
    b.inc(float(nbytes))


def observe_train_step(rank: int, seconds: float) -> None:
    if not enabled():
        return
    rank_s = str(rank)
    b = _train_bound.get(rank_s) or _bind(
        _train_bound, rank_s, "train_step", {"rank": rank_s}
    )
    b.observe(seconds)


_drain_bound: dict = {}
_resize_bound: dict = {}
_resize_hist_bound: dict = {}


def count_resize_event(direction: str, trigger: str) -> None:
    if not enabled():
        return
    b = _resize_bound.get((direction, trigger)) or _bind(
        _resize_bound, (direction, trigger), "train_resize_events",
        {"direction": direction, "trigger": trigger},
    )
    b.inc(1.0)


def observe_resize(direction: str, seconds: float) -> None:
    if not enabled():
        return
    b = _resize_hist_bound.get(direction) or _bind(
        _resize_hist_bound, direction, "train_resize", {"direction": direction}
    )
    b.observe(max(0.0, seconds))


def count_drain_event(reason: str) -> None:
    if not enabled():
        return
    b = _drain_bound.get(reason) or _bind(
        _drain_bound, reason, "drain_events", {"reason": reason}
    )
    b.inc(1.0)


def observe_drain_migration(seconds: float) -> None:
    if not enabled():
        return
    _metrics().drain_migration.observe(max(0.0, seconds))


# ----------------------------------------------------------------------
# multi-tenant job plane.  Callers pass tenant labels ALREADY clamped via
# tenants.tenant_label() (registered tenants + "default"/"other"), so
# the bound caches below stay bounded.
# ----------------------------------------------------------------------
_tenant_wait_bound: dict = {}
_tenant_parked_bound: dict = {}
_tenant_preempt_bound: dict = {}
_lost_capacity_bound: dict = {}


def set_tenant_usage(tenant: str, resource: str, value: float) -> None:
    if not enabled():
        return
    # Gauges are last-value-wins and set on a publish cadence, not per
    # event — the unbound set() path is fine here.
    _metrics().tenant_usage.set(value, tags={"tenant": tenant, "resource": resource})


def set_tenant_dominant_share(tenant: str, share: float) -> None:
    if not enabled():
        return
    _metrics().tenant_dominant_share.set(share, tags={"tenant": tenant})


def observe_tenant_lease_wait(tenant: str, seconds: float) -> None:
    if not enabled():
        return
    b = _tenant_wait_bound.get(tenant) or _bind(
        _tenant_wait_bound, tenant, "tenant_lease_wait", {"tenant": tenant}
    )
    b.observe(max(0.0, seconds))


def count_tenant_parked(tenant: str, reason: str) -> None:
    if not enabled():
        return
    b = _tenant_parked_bound.get((tenant, reason)) or _bind(
        _tenant_parked_bound, (tenant, reason), "tenant_parked",
        {"tenant": tenant, "reason": reason},
    )
    b.inc(1.0)


def count_tenant_preemption(tenant: str, action: str) -> None:
    if not enabled():
        return
    b = _tenant_preempt_bound.get((tenant, action)) or _bind(
        _tenant_preempt_bound, (tenant, action), "tenant_preemptions",
        {"tenant": tenant, "action": action},
    )
    b.inc(1.0)


_span_evict_bound: dict = {}


def count_span_table_eviction(tenant: str, n: int = 1) -> None:
    if not enabled():
        return
    b = _span_evict_bound.get(tenant) or _bind(
        _span_evict_bound, tenant, "span_table_evictions", {"tenant": tenant}
    )
    b.inc(float(n))


def count_lost_capacity(reason: str) -> None:
    if not enabled():
        return
    b = _lost_capacity_bound.get(reason) or _bind(
        _lost_capacity_bound, reason, "lost_capacity_records", {"reason": reason}
    )
    b.inc(1.0)


# ----------------------------------------------------------------------
# Membership plane: suspicion scoring, incarnation fencing, quarantine.
# Node labels are short (8-hex) node-id prefixes — bounded by cluster
# size; method labels come from the fixed fenced-handler set.
# ----------------------------------------------------------------------
_fence_bound: dict = {}
_quarantine_bound: dict = {}
_tele_dropped_bound: dict = {}


def set_node_suspicion(node: str, score: float) -> None:
    if not enabled():
        return
    # Gauge: last-value-wins on the health-loop cadence — the unbound
    # set() path is fine here (matches the tenant gauges).
    _metrics().node_suspicion.set(float(score), tags={"node": node})


def count_fence_rejection(method: str) -> None:
    if not enabled():
        return
    b = _fence_bound.get(method) or _bind(
        _fence_bound, method, "node_fence_rejections", {"method": method}
    )
    b.inc(1.0)


def count_quarantine(reason: str, direction: str) -> None:
    if not enabled():
        return
    b = _quarantine_bound.get((reason, direction)) or _bind(
        _quarantine_bound, (reason, direction), "node_quarantine",
        {"reason": reason, "direction": direction},
    )
    b.inc(1.0)


def count_telemetry_dropped(reason: str, n: int = 1) -> None:
    if not enabled():
        return
    b = _tele_dropped_bound.get(reason) or _bind(
        _tele_dropped_bound, reason, "telemetry_dropped", {"reason": reason}
    )
    b.inc(float(n))


# ----------------------------------------------------------------------
# LLM serving plane.  Deployment label values are deployment names
# (operator-chosen, bounded cardinality).
# ----------------------------------------------------------------------
_serve_ttft_bound: dict = {}
_serve_shed_bound: dict = {}


def set_serve_queue_depth(deployment: str, depth: int) -> None:
    if not enabled():
        return
    _metrics().serve_queue_depth.set(float(depth), tags={"deployment": deployment})


def set_serve_tokens_per_s(deployment: str, rate: float) -> None:
    if not enabled():
        return
    _metrics().serve_tokens_per_s.set(max(0.0, rate), tags={"deployment": deployment})


def set_serve_kv_blocks(deployment: str, blocks: int) -> None:
    if not enabled():
        return
    _metrics().serve_kv_blocks.set(float(blocks), tags={"deployment": deployment})


def observe_serve_ttft(deployment: str, seconds: float) -> None:
    if not enabled():
        return
    b = _serve_ttft_bound.get(deployment) or _bind(
        _serve_ttft_bound, deployment, "serve_ttft", {"deployment": deployment}
    )
    b.observe(max(0.0, seconds))


def count_serve_shed(deployment: str, where: str, n: int = 1,
                     tenant: str = "default") -> None:
    if not enabled():
        return
    key = (deployment, where, tenant)
    b = _serve_shed_bound.get(key) or _bind(
        _serve_shed_bound, key, "serve_shed",
        {"deployment": deployment, "where": where, "tenant": tenant},
    )
    b.inc(float(n))


_serve_preempt_bound: dict = {}
_serve_tenant_tok_bound: dict = {}
_serve_mx_evict_bound: dict = {}


def count_serve_preemption(deployment: str, slo: str, n: int = 1) -> None:
    if not enabled():
        return
    key = (deployment, slo)
    b = _serve_preempt_bound.get(key) or _bind(
        _serve_preempt_bound, key, "serve_preemptions",
        {"deployment": deployment, "slo": slo},
    )
    b.inc(float(n))


def set_serve_degradation(deployment: str, level: int) -> None:
    if not enabled():
        return
    _metrics().serve_degradation_level.set(
        float(level), tags={"deployment": deployment}
    )


def set_serve_tenant_tokens_per_s(deployment: str, tenant: str,
                                  rate: float) -> None:
    if not enabled():
        return
    key = (deployment, tenant)
    b = _serve_tenant_tok_bound.get(key) or _bind(
        _serve_tenant_tok_bound, key, "serve_tenant_tokens_per_s",
        {"deployment": deployment, "tenant": tenant},
    )
    b.set(max(0.0, rate))


def count_serve_multiplex_eviction(deployment: str, n: int = 1) -> None:
    if not enabled():
        return
    b = _serve_mx_evict_bound.get(deployment) or _bind(
        _serve_mx_evict_bound, deployment, "serve_multiplex_evictions",
        {"deployment": deployment},
    )
    b.inc(float(n))


# ----------------------------------------------------------------------
# profiling & bottleneck-attribution plane.  Function labels are
# instrumentation-site names (literal strings at the call sites —
# bounded); device labels enumerate local accelerators (bounded).
# ----------------------------------------------------------------------
_profile_bound: dict = {}
_chan_ops_bound: dict = {}
_chan_blocked_bound: dict = {}
_chan_timeout_bound: dict = {}
_dag_op_bound: dict = {}
_socket_connect_bound: dict = {}
_serve_dataplane_bound: dict = {}


def count_profile_session(state: str) -> None:
    if not enabled():
        return
    b = _profile_bound.get(state) or _bind(
        _profile_bound, state, "profile_sessions", {"state": state}
    )
    b.inc(1.0)


def set_device_memory(device: str, kind: str, value: float) -> None:
    if not enabled():
        return
    _metrics().device_memory.set(value, tags={"device": device, "kind": kind})


def count_channel_ops(op: str, n: int) -> None:
    """Batched (callers accumulate locally and flush every N ops) so
    the channel hot path stays at dict increments."""
    if not enabled() or n <= 0:
        return
    b = _chan_ops_bound.get(op) or _bind(
        _chan_ops_bound, op, "channel_ops", {"op": op}
    )
    b.inc(float(n))


def add_channel_blocked(op: str, seconds: float, transport: str) -> None:
    if not enabled() or seconds <= 0.0:
        return
    key = (op, transport)
    b = _chan_blocked_bound.get(key) or _bind(
        _chan_blocked_bound, key, "channel_blocked",
        {"op": op, "transport": transport},
    )
    b.inc(seconds)


def count_channel_timeout(op: str, n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    b = _chan_timeout_bound.get(op) or _bind(
        _chan_timeout_bound, op, "channel_timeouts", {"op": op}
    )
    b.inc(float(n))


def count_channel_corruption(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _metrics().channel_corruption.inc(float(n))


_chan_reattach_bound: dict = {}


def count_channel_reattach(result: str) -> None:
    if not enabled():
        return
    b = _chan_reattach_bound.get(result) or _bind(
        _chan_reattach_bound, result, "channel_reattach", {"result": result}
    )
    b.inc(1.0)


def count_shm_reclaimed(n: int) -> None:
    if not enabled() or n <= 0:
        return
    _metrics().channel_shm_reclaimed.inc(float(n))


def count_fanout_eviction(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _metrics().channel_fanout_evictions.inc(float(n))


def count_socket_connect(result: str) -> None:
    if not enabled():
        return
    b = _socket_connect_bound.get(result) or _bind(
        _socket_connect_bound, result, "socket_connects", {"result": result}
    )
    b.inc(1.0)


def count_serve_dataplane_request(kind: str) -> None:
    if not enabled():
        return
    b = _serve_dataplane_bound.get(kind) or _bind(
        _serve_dataplane_bound, kind, "serve_dataplane_requests", {"kind": kind}
    )
    b.inc(1.0)


def count_serve_dataplane_items(n: int) -> None:
    """Batched (the router's rx thread accumulates locally)."""
    if not enabled() or n <= 0:
        return
    _metrics().serve_dataplane_items.inc(float(n))


def observe_dag_op(method: str, seconds: float) -> None:
    if not enabled():
        return
    b = _dag_op_bound.get(method) or _bind(
        _dag_op_bound, method, "dag_op", {"method": method}
    )
    b.observe(max(0.0, seconds))


def count_dag_execution(n: int = 1) -> None:
    if not enabled():
        return
    _metrics().dag_executions.inc(float(n))


def set_dag_inflight(n: int) -> None:
    if not enabled():
        return
    _metrics().dag_inflight.set(float(n))


def set_drain_budget(deadline_remaining_s: float, inflight_tasks: int) -> None:
    """Per-node drain budget gauges, updated from the raylet report loop
    while draining (and zeroed when not)."""
    if not enabled():
        return
    m = _metrics()
    m.drain_deadline_remaining.set(max(0.0, deadline_remaining_s))
    m.drain_inflight_tasks.set(float(inflight_tasks))


def set_rllib_queue_depth(n: int) -> None:
    if not enabled():
        return
    _metrics().rllib_queue_depth.set(float(n))


def set_rllib_learner_idle(fraction: float) -> None:
    if not enabled():
        return
    _metrics().rllib_learner_idle.set(min(1.0, max(0.0, fraction)))


def observe_rllib_weight_lag(generations: int) -> None:
    if not enabled():
        return
    _metrics().rllib_weight_lag.observe(max(0.0, float(generations)))


def count_rllib_env_steps(n: int) -> None:
    """Batched: runners count once per fragment, not per env step."""
    if not enabled() or n <= 0:
        return
    _metrics().rllib_env_steps.inc(float(n))


_pipeline_stage_bound: dict = {}
_grow_hint_bound: dict = {}


def observe_pipeline_stage(stage: int, seconds: float) -> None:
    """Per-step busy seconds of one MPMD pipeline stage (stage label
    cardinality is bounded by the pipeline depth)."""
    if not enabled():
        return
    stage_s = str(stage)
    b = _pipeline_stage_bound.get(stage_s) or _bind(
        _pipeline_stage_bound, stage_s, "pipeline_stage", {"stage": stage_s}
    )
    b.observe(max(0.0, seconds))


def set_pipeline_bubble(stage: int, fraction: float) -> None:
    if not enabled():
        return
    _metrics().pipeline_bubble.set(
        min(1.0, max(0.0, fraction)), tags={"stage": str(stage)}
    )


def count_grow_hint(action: str) -> None:
    if not enabled():
        return
    b = _grow_hint_bound.get(action) or _bind(
        _grow_hint_bound, action, "grow_hints", {"action": action}
    )
    b.inc(1.0)


_ckpt_write_bound: dict = {}
_ckpt_commit_bound: dict = {}


def observe_checkpoint_write(mode: str, seconds: float) -> None:
    """One checkpoint persist (mode = sync, async) — serialize + CRC +
    write + manifest commit, end to end."""
    if not enabled():
        return
    b = _ckpt_write_bound.get(mode) or _bind(
        _ckpt_write_bound, mode, "checkpoint_write", {"mode": mode}
    )
    b.observe(max(0.0, seconds))


def count_checkpoint_commit(result: str) -> None:
    if not enabled():
        return
    b = _ckpt_commit_bound.get(result) or _bind(
        _ckpt_commit_bound, result, "checkpoint_commit", {"result": result}
    )
    b.inc(1.0)


def count_checkpoint_restore_fallback(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _metrics().checkpoint_restore_fallbacks.inc(float(n))


def count_checkpoint_gc_reclaimed(n: int) -> None:
    if not enabled() or n <= 0:
        return
    _metrics().checkpoint_gc_reclaimed.inc(float(n))
