"""Single-source config/flag table.

Equivalent of the reference's RAY_CONFIG macro table (reference:
src/ray/common/ray_config_def.h — 220 entries, overridable via RAY_<name>
env vars and `_system_config` at init).  Here the table is a dict of typed
defaults; every entry is overridable via the ``RAY_TPU_TORCH_<name>`` environment
variable and via ``ray_tpu_torch.init(_system_config={...})``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_CONFIG_DEFS: Dict[str, Any] = {
    # --- core object store ---
    # Objects smaller than this are stored inline (in the owner / control
    # plane) instead of in the shared-memory store.
    "max_direct_call_object_size": 100 * 1024,
    # Default object store capacity as a fraction of system memory.
    "object_store_memory_fraction": 0.3,
    # Absolute cap on default object store size (bytes).
    "object_store_memory_cap": 8 * 1024**3,
    # Low-region arena bytes populated at startup (0 disables); capped so
    # multi-raylet boxes don't make capacity x raylets resident.
    "arena_prefault_bytes": 2 * 1024**3,
    # Chunk size for node-to-node object transfer.
    "object_manager_chunk_size": 4 * 1024**2,
    # Parallel in-flight chunks per object pull.
    "object_manager_max_parallel_chunks": 4,
    # Spill LRU objects to disk under memory pressure instead of evicting
    # (reference: external_storage.py + local_object_manager.h).
    "object_spilling_enabled": True,
    # Spill directory ("" = <store_dir>/spill).
    "object_spilling_dir": "",
    # Background spilling starts above the high watermark and stops at
    # the low one; file IO runs off the raylet loop.
    "object_spill_high_watermark": 0.8,
    "object_spill_low_watermark": 0.6,
    "object_spill_check_period_ms": 200,
    # --- scheduling ---
    "worker_lease_timeout_ms": 30_000,
    # Top-k fraction of nodes considered by the hybrid scheduling policy.
    "scheduler_top_k_fraction": 0.2,
    "scheduler_spread_threshold": 0.5,
    # Workers prestarted per node (0 = num_cpus).
    "num_prestart_workers": 0,
    # A runtime_env whose staging failed is considered broken for this
    # long; tasks needing it fail fast with RuntimeEnvSetupError.
    "runtime_env_error_ttl_s": 30,
    # A spawned worker that hasn't registered within this window (runtime
    # env staging included) is presumed wedged and killed.
    "worker_register_timeout_s": 900,
    # HOST-wide cap on concurrently-STARTING workers (flock token pool
    # shared by all raylets of a session on one machine): actor bursts
    # queue at the gate instead of forking more interpreters than the
    # machine can register within the lease window. 0 = auto
    # (2 x cpu count, min 4 — see spawn_gate.default_slots).
    "max_concurrent_worker_starts": 0,
    # Max idle workers kept around per node.
    "idle_worker_pool_size": 8,
    "idle_worker_killing_time_ms": 300_000,
    # --- dashboard (reference: dashboard/dashboard.py; -1 disables,
    # 0 picks a free port) ---
    "dashboard_host": "127.0.0.1",
    "dashboard_port": 0,
    # Ray Client server (ray:// remote drivers); -1 disables (reference
    # default port 10001 — enable with RAY_TPU_TORCH_ray_client_server_port).
    # Bind 0.0.0.0 to accept drivers from other hosts.
    "ray_client_server_host": "127.0.0.1",
    "ray_client_server_port": -1,
    # --- memory monitor / OOM killing (reference: memory_monitor.h:52,
    # worker_killing_policy_group_by_owner.cc) ---
    "memory_monitor_enabled": True,
    "memory_monitor_refresh_ms": 500,
    # System policy: kill when MemAvailable < (1-threshold) * MemTotal.
    "memory_usage_threshold": 0.95,
    # Explicit budget for the sum of worker RSS on this node (bytes);
    # 0 = use the system MemAvailable policy instead.
    "memory_limit_bytes": 0,
    # --- health / failure detection ---
    "health_check_period_ms": 1_000,
    "health_check_timeout_ms": 10_000,
    "health_check_failure_threshold": 5,
    # --- gray-failure suspicion ladder (ALIVE -> SUSPECT -> QUARANTINED)
    # Suspicion score (0..1) at which a node is soft-cordoned SUSPECT;
    # below the clear threshold it returns to ALIVE (hysteresis band).
    "suspect_score_threshold": 0.5,
    "suspect_clear_threshold": 0.2,
    # Raylet-measured GCS report RTT (ewma, ms) that saturates the gray
    # score component; likewise consecutive failed report calls.
    "suspect_rtt_ms": 2_000.0,
    "suspect_rpc_errors": 5,
    # Worker-channel degradation rates that saturate the gray component:
    # blocked-seconds per wall second, and failed reattaches per window.
    "suspect_channel_blocked_ratio": 0.5,
    "suspect_channel_reattach_fails": 3,
    # Sustained-SUSPECT duration before escalation to QUARANTINED (rides
    # the drain machinery: migrate actors, re-replicate sole copies).
    "quarantine_after_s": 5.0,
    "quarantine_drain_deadline_s": 10.0,
    # A QUARANTINED node must look healthy this long before it is
    # readmitted ALIVE, and may recover at most node_flap_budget times —
    # past the budget it stays quarantined until operator action.
    "unquarantine_hysteresis_s": 5.0,
    "node_flap_budget": 3,
    # An asymmetric partition (raylet->gcs frames dropped, TCP conn still
    # open) never closes the connection: heartbeat silence past
    # timeout * this factor declares the node DEAD anyway.
    "dead_conn_open_factor": 2.0,
    "task_retry_delay_ms": 100,
    # Default max retries for normal tasks.
    "task_max_retries": 3,
    # Lineage reconstruction: rebuild lost objects by resubmitting their
    # creating task (reference: core_worker/object_recovery_manager.h).
    "lineage_reconstruction_enabled": True,
    # Per-get cap on recovery round-trips before giving up.
    "max_object_recovery_attempts": 10,
    # --- direct task submission (reference: core_worker/transport/
    # normal_task_submitter.h:74 — lease workers from the raylet, push task
    # specs worker-to-worker with the raylet out of the data path) ---
    "direct_task_submission": True,
    "direct_actor_calls": True,
    # A granted lease kept past this idle time is returned to the raylet.
    "lease_idle_timeout_ms": 1_000,
    # Max workers leased per scheduling key (resource shape) per submitter.
    "max_leases_per_scheduling_key": 16,
    # Task specs pipelined to one leased worker ahead of completion (used
    # once the lease cap is reached; below it, work spreads 1-per-worker).
    "lease_pipeline_depth": 32,
    # Tasks whose EWMA duration exceeds this are "long": lease count grows
    # toward max_leases_per_scheduling_key for real parallelism.  Shorter
    # tasks stay on ~cpu_count leases and pipeline instead — more workers
    # than cores just thrash.
    "lease_grow_task_ms": 10.0,
    # How long a recovery resubmission suppresses duplicate resubmits of
    # the same creating task (seconds); retried with backoff after.
    "object_recovery_inflight_window_s": 30.0,
    # --- rpc ---
    "rpc_connect_timeout_s": 30,
    "rpc_call_timeout_s": 120,
    # Chaos testing (legacy): "method:kind:N" drop list, folded into the
    # chaos plane (reference: src/ray/rpc/rpc_chaos.h).
    "testing_rpc_failure": "",
    # Chaos testing: composable fault spec consulted by every RPC
    # dispatch and by process fault points — see chaos.py for the
    # grammar (drop/delay/dup by method glob, kill at task N).
    "testing_chaos_spec": "",
    # Seed for the chaos plane's per-rule RNG streams and retry jitter;
    # >= 0 makes the fault schedule replayable, -1 = unseeded.
    "testing_chaos_seed": -1,
    # This process's identity for directional net:<src>-><dst> chaos
    # rules.  Env-propagated, so a raylet spawned with
    # RAY_TPU_TORCH_chaos_net_name=node2 passes the name to its workers —
    # every process on the drilled "node" shares one host-granularity
    # link identity.  Empty = role default (gcs / raylet-<id8> / ...).
    "chaos_net_name": "",
    # Artificial delay injected into every rpc handler, microseconds.
    "testing_asio_delay_us": 0,
    # --- task events / observability ---
    "task_events_buffer_size": 10_000,
    "metrics_report_interval_ms": 5_000,
    # Flight recorder: core-path metric/span instrumentation (rpc latency,
    # task phases, object store, retries, chaos injections).  Off = the
    # instrumentation sites become a single boolean check.
    "telemetry_enabled": True,
    # GCS-side buffer of finished spans shipped by the per-process span
    # flusher (util/tracing); oldest spans are dropped past this.
    "span_buffer_size": 50_000,
    # Period of the background span flusher in every traced process.
    "span_flush_interval_ms": 1_000,
    # Per-flush cap on spans shipped to the GCS in one span_report batch;
    # the remainder waits for the next interval (sustained load must not
    # produce unbounded report frames).
    "span_flush_max_batch": 2_048,
    # Head-sampling rate for spans, applied per trace id at record time
    # (1.0 = keep everything).  Deterministic in the trace id, so every
    # process keeps or drops the SAME traces and trees stay whole.
    "span_sample_rate": 1.0,
    # Per-tenant clamp on the GCS span and profile tables: no single
    # tenant's records may hold more than this fraction of the ring, so
    # one chatty tenant cannot evict every other tenant's flight-recorder
    # history.  1.0 disables the clamp (only the global cap applies).
    "span_table_tenant_share": 0.5,
    # --- sampling profiler (profiling.py) ---
    # Default sampling rate for on-demand profile sessions.  67 Hz keeps
    # the attached overhead well inside the <5% telemetry budget while
    # still resolving ~15 ms of exclusive time per second of capture.
    "profile_default_hz": 67,
    # Hard cap on one session's duration: a driver that dies after
    # profile_start cannot leave a sampler running forever.
    "profile_max_duration_s": 600.0,
    # Frames kept per sampled stack (deepest are dropped).
    "profile_max_stack_depth": 64,
    # GCS profile-table depth (capture records shipped at end of
    # capture).  Must comfortably exceed the process count of one
    # cluster-wide capture or late arrivals evict earlier records and
    # break died-mid-capture recovery.
    "profile_table_size": 512,
    # --- compiled-DAG dataplane (dag/ + experimental/channel.py) ---
    # Unacked-message window per cross-host socket channel: the socket
    # analog of the ring's free-space bound, sized to hide the network
    # RTT (flow control counts CONSUMED messages, so reader-side
    # buffering stays bounded at ~window frames).
    "socket_channel_window": 8,
    # How long a compiled edge's writer retries dialing its reader's
    # listener at loop start before the typed ChannelConnectionError.
    "dag_socket_connect_timeout_s": 15.0,
    # Default timeout for channel write/read paths whose caller didn't
    # pass one — ONE knob so chaos drills can tighten every edge of the
    # dataplane uniformly (was a hard-coded 30.0 at each call site).
    # None-equivalent (block forever) is still expressed per call site
    # with an explicit timeout=None.
    "channel_default_timeout_s": 30.0,
    # How long one reattach() attempt waits for the peer after a
    # connection-level channel death (reader: re-accept window for the
    # writer's epoch-bumped dial; writer: dial + handshake budget).
    # Bounds the latency of the heavy per-consumer recovery when the
    # peer is truly gone, so keep it a few RTTs, not a retry budget.
    "channel_reattach_timeout_s": 5.0,
    # Cadence of the raylet-side sweeper that reclaims ring/fan-out shm
    # files whose registered owner PIDs are all dead (the tmpfs leak
    # after SIGKILL).  0 disables the sweep.
    "channel_shm_sweep_period_s": 30.0,
    # A ring directory younger than this is never swept even if its
    # owners look dead — covers the window between mkdir/create_file
    # and the first endpoint registering its PID.
    "channel_shm_orphan_grace_s": 60.0,
    # Route serve router→replica calls and token streams over compiled
    # per-replica channels instead of per-call actor RPC / per-token
    # object-store items.  Any attach failure falls back to the RPC path
    # per replica; off = always the RPC path.
    "serve_channel_dataplane": True,
    # Floor (KB) for one podracer trajectory ring (rllib/core/stream.py):
    # the plane sizes each ring at max(floor, 2x the estimated fragment
    # + slack) — about two fragments in flight per runner edge.  Deep
    # rings are NOT free capacity: every buffered fragment ages one
    # weight generation per learner update.
    "rllib_stream_min_buffer_kb": 256,
    # --- drain / preemption (reference: gcs DrainNode + autoscaler drain
    # API; RLAX-style planned-interruption handling) ---
    # Fallback drain notice window when a drain_node call carries none.
    "drain_deadline_s_default": 30.0,
    # Notice window the autoscaler grants an idle node before terminating
    # it (idle scale-down goes ALIVE -> DRAINING -> terminate).
    "idle_drain_deadline_s": 30.0,
    # Poll period of the GCS drain task waiting for actor migration and
    # object re-replication to finish.
    "drain_poll_ms": 100,
    # How long a preempted node's lost-capacity record stays in the
    # autoscaler feed.  Consumption is tracked per-autoscaler in memory,
    # so the TTL bounds duplicate replacement launches after an
    # autoscaler restart to entries younger than this.
    "lost_capacity_ttl_s": 600.0,
    # How long an elastic trainer's published grow intent stays in the
    # autoscaler feed without a refresh.  The executor re-publishes on
    # every failed grow attempt, so a live shrunken trainer keeps its
    # hint warm and a dead one ages out within this window.
    "grow_hint_ttl_s": 300.0,
    # --- gcs ---
    # "file": periodically snapshot GCS state (actors/PGs/KV/jobs) to the
    # session dir so a restarted GCS resumes the cluster (reference: redis
    # persistence, redis_store_client.h:106).  "memory": no persistence.
    "gcs_storage": "file",
    # External snapshot destination for head-NODE-loss recovery
    # (reference: redis_store_client.h): "redis://[:pw@]host:port[/key]"
    # or "file:///shared/mount/path"; "" = session-dir file.
    "gcs_external_storage": "",
    "gcs_snapshot_interval_ms": 500,
    # How long raylets/drivers/workers retry reconnecting to a down GCS
    # before declaring it fatal (reference: gcs_rpc_server_reconnect_timeout_s).
    "gcs_reconnect_timeout_s": 60,
    # Jobs restored from a snapshot whose driver doesn't reattach within
    # this window are cleaned up.
    "gcs_job_reattach_grace_s": 60,
    "maximum_gcs_dead_node_cache": 100,
    # --- collectives ---
    "collective_chunk_bytes": 16 * 1024**2,
    # Rendezvous deadline budget for collective group formation: how long
    # a member polls the GCS KV for its peers before raising a typed
    # RendezvousTimeoutError naming the missing ranks.
    "collective_rendezvous_timeout_s": 60.0,
    # --- elastic training ---
    # How long the elastic backend executor waits for a replacement
    # worker lease before concluding capacity has NOT returned and
    # continuing at the current (shrunken) size.
    "elastic_grow_lease_timeout_s": 15.0,
    # Minimum seconds between grow attempts (each failed attempt costs a
    # lease timeout; don't spin on a capacity-starved cluster).
    "elastic_grow_backoff_s": 5.0,
    # Shared liveness-ping budget when partitioning survivors from
    # casualties at shrink time.  Must exceed one train step: a survivor
    # whose actor is busy finishing an abandoned next_report only answers
    # the ping at its next report boundary — a too-small budget
    # misclassifies slow-but-alive ranks as casualties.
    "elastic_ping_timeout_s": 60.0,
    # --- durable checkpoint plane (train/checkpoint_plane.py) ---
    # Persist session.report(checkpoint=...) on the bounded background
    # writer (the train step pays host-snapshot time only; the next
    # report back-pressures while a write is in flight).  Off = every
    # report stalls for the full serialize+CRC+write+commit.
    "train_checkpoint_async": True,
    # Retention: keep the newest K COMMITTED checkpoints (the restore
    # fallback chain) plus pinned ones; older ones are reclaimed.
    "train_checkpoint_keep": 3,
    # Uncommitted checkpoint directories (no manifest — a writer died
    # mid-save) are reclaimed only once older than this, so GC never
    # races a live in-flight writer.
    "train_checkpoint_gc_grace_s": 300.0,
    # --- multi-tenant job plane (tenants.py; quotas + DRF fair share +
    # priority preemption) ---
    # Enforce registered per-tenant quotas at admission (GCS actors/PGs)
    # and at raylet lease grants.  Off = tenants still get fair-share
    # ordering and usage accounting, but no request is ever parked for
    # quota.
    "tenant_quota_enforcement": True,
    # Backpressure bound: per-tenant cap on admissions parked for quota
    # (actors waiting in the GCS quota queue).  Beyond it, registration
    # fails fast with QuotaExceededError instead of queueing unboundedly.
    "tenant_max_parked": 256,
    # Cadence of the GCS "tenant_usage" publish (cluster-wide per-tenant
    # usage + quotas + totals) that raylets use for DRF ordering.
    "tenant_usage_publish_ms": 500,
    # Priority preemption: how long higher-priority demand must sit
    # starved (unplaceable) before the GCS preempts lower-priority /
    # over-quota jobs through the drain+elastic path.
    "preemption_grace_s": 5.0,
    "preemption_check_period_ms": 500,
    # Notice window a preempted job gets to checkpoint-and-shrink before
    # the GCS escalates to graceful actor kill + restart-elsewhere.
    "preemption_notice_deadline_s": 15.0,
    # --- logging ---
    "log_to_driver": True,
    # Worker-log tail period for the per-node log monitor.
    "log_monitor_period_ms": 500,
}


class _Config:
    """Process-wide config; values resolved env > system_config > default."""

    def __init__(self):
        self._overrides: Dict[str, Any] = {}

    def initialize(self, system_config: Dict[str, Any] | None):
        if not system_config:
            return
        for k, v in system_config.items():
            if k not in _CONFIG_DEFS:
                raise ValueError(f"Unknown system config: {k}")
            self._overrides[k] = v

    def get(self, name: str):
        if name not in _CONFIG_DEFS:
            raise KeyError(name)
        env = os.environ.get(f"RAY_TPU_TORCH_{name}")
        if env is not None:
            default = _CONFIG_DEFS[name]
            if isinstance(default, bool):
                return env.lower() in ("1", "true", "yes")
            if isinstance(default, int):
                return int(env)
            if isinstance(default, float):
                return float(env)
            return env
        if name in self._overrides:
            return self._overrides[name]
        return _CONFIG_DEFS[name]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    def dump(self) -> str:
        return json.dumps({k: self.get(k) for k in _CONFIG_DEFS})

    def load_overrides(self, dumped: str):
        data = json.loads(dumped)
        for k, v in data.items():
            if k in _CONFIG_DEFS and v != _CONFIG_DEFS[k]:
                self._overrides[k] = v


CONFIG = _Config()
