"""GCS — cluster control plane.

Equivalent of the reference's gcs_server (reference:
src/ray/gcs/gcs_server/gcs_server.h:88 wiring ~15 managers): node
membership (gcs_node_manager.h), actor directory + fault tolerance
(gcs_actor_manager.h, gcs_actor_scheduler.h), placement groups with
two-phase Prepare/Commit (gcs_placement_group_scheduler.h:283), KV store
(gcs_kv_manager.h), pubsub, health checks (gcs_health_check_manager.h),
object directory (the reference uses owner-based location tracking;
here the GCS tracks locations reported by raylets on seal/evict), and
job management.

One asyncio process.  All state in memory; with gcs_storage="file" (the
default) a periodic-on-mutation snapshot of the durable tables (actors,
placement groups, KV, jobs) is written to the session dir, and a
restarted GCS reloads it — raylets, drivers and workers reconnect with
backoff and resync (reference: redis persistence,
gcs/store_client/redis_store_client.h:106, gcs_redis_failure_detector.cc).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import rpc, telemetry
from ray_tpu_torch._private import tenants as tenants_mod
from ray_tpu_torch._private.chaos import CHAOS
from ray_tpu_torch._private.common import (
    ActorInfo,
    Bundle,
    NodeInfo,
    PlacementGroupInfo,
    ResourceSet,
    TaskSpec,
)
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID
from ray_tpu_torch.exceptions import NodeFencedError

# Node states whose raylet is up and serving: its object copies are
# readable and its reported usage counts.  SUSPECT/QUARANTINED nodes are
# degraded-but-alive (soft-cordoned from NEW placement, which considers
# only ALIVE) — treating them as dead here is exactly the false-DEAD
# failure mode the gray-failure ladder exists to avoid.
_LIVE_STATES = ("ALIVE", "SUSPECT", "DRAINING", "QUARANTINED")


class _TenantTable:
    """Bounded flight-recorder table with a per-tenant quota.

    Entries append under a tenant label; each tenant may hold at most
    ``share * size`` entries (its own oldest evicts first), and the
    table overall holds at most ``size`` (globally-oldest evicts) — one
    chatty tenant saturates only its own quota instead of flushing
    every other tenant's records out of the ring.  Every eviction is
    counted per tenant through ``on_evict``
    (span_table_evictions_total).  Iteration yields records oldest-
    first in global arrival order, so ``list()``/``islice()`` consumers
    keep their newest-last semantics."""

    def __init__(self, size: int, share: float, on_evict=None):
        self._size = max(1, int(size))
        share = min(1.0, max(0.0, float(share)))
        self._quota = max(1, int(self._size * share))
        self._seq = 0
        self._total = 0
        self._by_tenant: Dict[str, deque] = {}
        self._on_evict = on_evict

    def __len__(self) -> int:
        return self._total

    def __iter__(self):
        import heapq

        return (rec for _seq, rec in heapq.merge(*self._by_tenant.values()))

    def _evict(self, tenant: str, d: "deque") -> None:
        d.popleft()
        self._total -= 1
        if not d:
            del self._by_tenant[tenant]
        if self._on_evict is not None:
            try:
                self._on_evict(tenant, 1)
            except Exception:  # noqa: BLE001 — accounting must not drop writes
                pass

    def append(self, tenant: str, rec: Any) -> None:
        d = self._by_tenant.get(tenant)
        if d is None:
            d = self._by_tenant[tenant] = deque()
        self._seq += 1
        d.append((self._seq, rec))
        self._total += 1
        if len(d) > self._quota:
            self._evict(tenant, d)
        while self._total > self._size:
            oldest_tenant, oldest = min(
                self._by_tenant.items(), key=lambda kv: kv[1][0][0]
            )
            self._evict(oldest_tenant, oldest)

    def extend(self, tenant: str, recs) -> None:
        for rec in recs:
            self.append(tenant, rec)

logger = logging.getLogger(__name__)


class GcsServer:
    def __init__(self, address: str, session_info: dict, loop=None):
        self.address = address
        self.session_info = session_info  # session_dir, etc.
        self.loop = loop or asyncio.get_event_loop()
        self.server = rpc.RpcServer(self, address, self.loop)

        # --- node manager ---
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.node_conns: Dict[NodeID, rpc.ClientConn] = {}
        self.node_clients: Dict[NodeID, rpc.AsyncRpcClient] = {}
        self.available: Dict[NodeID, ResourceSet] = {}  # latest reported
        self.last_heartbeat: Dict[NodeID, float] = {}
        # Membership incarnations: monotonic per node_id, ACROSS deaths —
        # the fence that rejects a zombie raylet's writes after a healed
        # partition.  Never popped on death (a dead incarnation must stay
        # fenceable until the node re-registers with a higher one).
        self.node_incarnations: Dict[NodeID, int] = {}
        # Gray-failure ladder inputs: raylet-reported health from each
        # resource_report ({"gcs_rtt_ms", "gcs_errors"}), and channel
        # blocked/reattach totals snooped from worker metric snapshots
        # (node -> worker_id -> (blocked_s, reattach_failed)).
        self.node_health: Dict[NodeID, dict] = {}
        self._chan_stats: Dict[NodeID, Dict[bytes, Tuple[float, float]]] = {}
        # Per-node (prev_blocked_sum, prev_reattach_sum, t) for windowed
        # channel-degradation rates in the suspicion score.
        self._chan_prev: Dict[NodeID, Tuple[float, float, float]] = {}
        # Monotonic time a QUARANTINED/SUSPECT node has looked healthy
        # (score below the clear threshold) — the unquarantine hysteresis.
        self._recover_since: Dict[NodeID, float] = {}

        # --- actor manager ---
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # (ns, name)
        self.pending_actors: List[ActorID] = []

        # --- kv ---
        self.kv: Dict[str, Dict[bytes, bytes]] = defaultdict(dict)

        # --- object directory ---
        self.object_locations: Dict[bytes, Set[NodeID]] = defaultdict(set)
        # Objects that were sealed at least once: an oid here with no live
        # location is LOST (eviction or node death), which owners repair by
        # lineage reconstruction (reference: object_recovery_manager.h).
        self.sealed_ever: Set[bytes] = set()

        # --- placement groups ---
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self.named_pgs: Dict[str, PlacementGroupID] = {}

        # --- jobs ---
        self.jobs: Dict[JobID, dict] = {}
        self.next_job_int = 1
        self.driver_conns: Dict[JobID, rpc.ClientConn] = {}

        # --- multi-tenant job plane (tenants.py) ---
        # Registered tenants (quota/weight/priority); persisted.
        self.tenants: Dict[str, tenants_mod.TenantSpec] = {}
        # Per-node per-tenant usage from raylet resource reports
        # (ground truth: leases + actor workers + PG reservations).
        self.tenant_usage_by_node: Dict[NodeID, Dict[str, dict]] = {}
        # Parked lease demand per node, tenant/priority-tagged (the
        # preemption monitor's direct-path starvation signal).
        self.pending_tenant_demand: Dict[NodeID, list] = {}
        # Optimistic admission ledger: (tenant, ResourceSet, time) for
        # admissions granted since the last raylet reports landed —
        # closes the report-lag window where two over-quota actors could
        # both pass the usage check.  Entries decay after ~2 report
        # periods.
        self._tenant_admit_delta: List[Tuple[str, ResourceSet, float]] = []
        # Charge-at-admission lease ledger: raylets
        # report every lease GRANT the moment they debit resources, so
        # the cluster quota view converges in RPC latency instead of
        # report cadence — closing the ~1 s cross-raylet over-admission
        # race the cooperative-revocation path existed to mop up.
        # Node-keyed; a node's entries drop when its next resource_report
        # lands (reconcile on report: the report then carries the lease
        # in tenant_usage), with a time cap for nodes that die first.
        self._lease_charges: Dict[NodeID, List[Tuple[str, ResourceSet, float]]] = {}
        self._last_usage_publish = 0.0
        # Actors parked at admission because their tenant is over quota
        # (actor_id -> parked-since); subset of pending_actors.
        self._quota_parked: Dict[ActorID, float] = {}
        # First-seen time of each resource-starved pending actor (the
        # preemption monitor's actor-path starvation signal).
        self._pending_since: Dict[ActorID, float] = {}
        # Priority preemption: per-victim-job notice time (escalation to
        # graceful actor restart happens past the notice deadline).
        self._preempt_notices: Dict[JobID, float] = {}

        # --- pubsub: channel -> set of conns ---
        self.subs: Dict[str, Set[rpc.ClientConn]] = defaultdict(set)

        # --- observability (reference: gcs_task_manager.h:86 task events;
        # stats/metric_exporter.h metric aggregation) ---
        self.task_events: "deque" = deque(maxlen=int(CONFIG.task_events_buffer_size))
        self.metrics: Dict[bytes, list] = {}  # worker_id -> latest snapshot
        # Flight recorder: finished spans from every process's span
        # flusher (util/tracing.flush); merged cluster-wide by
        # util.state.timeline() and the dashboard /api/timeline.
        # Per-tenant clamp (span_table_tenant_share): a chatty tenant
        # evicts its own history, never another tenant's.
        self.spans = _TenantTable(
            int(CONFIG.span_buffer_size),
            float(CONFIG.span_table_tenant_share),
            on_evict=telemetry.count_span_table_eviction,
        )
        # Profile captures shipped by profiled processes at end of
        # capture (profiling.py _ship_finished) — rides the same report
        # path as spans, so a capture survives its driver AND its
        # target process.  Depth must exceed one cluster-wide capture's
        # process count (profile_table_size) or eviction breaks the
        # died-mid-capture recovery path.
        self.profiles = _TenantTable(
            int(CONFIG.profile_table_size),
            float(CONFIG.span_table_tenant_share),
            on_evict=telemetry.count_span_table_eviction,
        )
        self.pending_shapes: Dict[NodeID, list] = {}  # autoscaler demand
        # Capacity-return signal: preempted nodes whose resources the
        # autoscaler should replace even when no task demand is pending
        # (an elastic trainer running shrunken generates none — it adapts
        # instead of queueing).  Each entry is consumed once per
        # autoscaler via its node_id key (get_load_metrics exposes it);
        # entries expire after lost_capacity_ttl_s.
        self.lost_capacity: "deque" = deque(maxlen=256)
        # Grow-intent signal: an elastic trainer running
        # BELOW its target size publishes how much capacity it wants back
        # so the autoscaler warms replacements BEFORE the epoch-boundary
        # grow attempt, instead of discovering the gap from task demand
        # it never queues.  Keyed by experiment name; entries expire
        # after grow_hint_ttl_s (a dead trainer must not pin launches).
        self.grow_hints: Dict[str, dict] = {}

        self.server.on_disconnect = self._on_disconnect
        self._bg_tasks: List[asyncio.Task] = []
        self.start_time = time.time()

        # Per-PG creation events (waiters in _schedule_actor); kept out
        # of PlacementGroupInfo so snapshots stay picklable.
        self._pg_events: Dict[PlacementGroupID, asyncio.Event] = {}

        # --- persistence (reference: redis_store_client.h:106) ---
        self._snapshot_dirty = False
        # Jobs restored from a snapshot wait for their driver to reattach;
        # job_id -> deadline for cleanup.
        self._job_reattach_deadline: Dict[JobID, float] = {}
        # Restored ALIVE actors wait for their node to re-register; actors
        # whose node never returns are failed (restart elsewhere or DEAD).
        self._actor_node_deadline: Dict[ActorID, float] = {}

    async def start(self):
        from ray_tpu_torch._private.chaos import set_net_role

        set_net_role("gcs")
        if CONFIG.gcs_storage == "file":
            self._load_snapshot()
        # This process's own metric/span reports (rpc handler latency,
        # chaos counters) go straight into the tables — no RPC to self.
        from ray_tpu_torch.util import metrics as metrics_mod

        metrics_mod.set_report_channel(self._local_report, b"__gcs__")
        await self.server.start()
        self._bg_tasks.append(self.loop.create_task(self._health_loop()))
        self._bg_tasks.append(self.loop.create_task(self._tenant_usage_loop()))
        self._bg_tasks.append(self.loop.create_task(self._preemption_loop()))
        if CONFIG.gcs_storage == "file":
            store = self._store()
            if store is not None:
                logger.info("GCS persistence backend: %s", store.describe())
            self._bg_tasks.append(self.loop.create_task(self._snapshot_loop()))
        from ray_tpu_torch._private.common import event_loop_lag_loop

        self._bg_tasks.append(
            self.loop.create_task(event_loop_lag_loop(self, self.loop))
        )
        logger.info("GCS listening on %s", self.address)

    async def rpc_gcs_stats(self, payload, conn):
        return {
            "event_loop_lag_ms": round(getattr(self, "event_loop_lag_ms", 0.0), 3),
            "event_loop_lag_max_ms": round(getattr(self, "event_loop_lag_max_ms", 0.0), 3),
            "num_nodes": sum(1 for n in self.nodes.values() if n.state == "ALIVE"),
            "num_actors": sum(
                1 for a in self.actors.values() if a.state != "DEAD"
            ),
            "num_placement_groups": sum(
                1 for pg in self.placement_groups.values() if pg.state != "REMOVED"
            ),
        }

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _store(self):
        """Pluggable persistence backend (reference:
        redis_store_client.h:106): external Redis/shared-file via the
        ``gcs_external_storage`` URI, else the session-dir file."""
        if getattr(self, "_store_backend", None) is None:
            from ray_tpu_torch._private.gcs_store import make_snapshot_store

            self._store_backend = make_snapshot_store(
                getattr(CONFIG, "gcs_external_storage", ""),
                self.session_info.get("session_dir"),
            )
        return self._store_backend

    def _dirty(self):
        self._snapshot_dirty = True

    async def _snapshot_loop(self):
        from ray_tpu_torch._private.chaos import CHAOS

        interval = CONFIG.gcs_snapshot_interval_ms / 1000
        while True:
            await asyncio.sleep(interval)
            # Chaos fault point: "@gcs.tick:kill:at=N" crashes the GCS on
            # the N-th snapshot tick — drills restart it against the same
            # session dir (reference: redis-backed GCS restart).
            if CHAOS.active and CHAOS.maybe_kill("gcs.tick"):
                logger.warning("chaos: killing GCS at snapshot tick")
                import os as _os

                _os._exit(1)
            if self._snapshot_dirty:
                self._snapshot_dirty = False
                try:
                    self._write_snapshot()
                except Exception:
                    logger.exception("GCS snapshot write failed")

    def _write_snapshot(self):
        import pickle

        store = self._store()
        if store is None:
            return
        state = {
            "actors": self.actors,
            "named_actors": self.named_actors,
            "placement_groups": self.placement_groups,
            "named_pgs": self.named_pgs,
            "kv": dict(self.kv),
            "jobs": self.jobs,
            "next_job_int": self.next_job_int,
            "tenants": {n: s.to_dict() for n, s in self.tenants.items()},
        }
        store.save(pickle.dumps(state, protocol=5))

    def _load_snapshot(self):
        import pickle

        store = self._store()
        if store is None:
            return
        try:
            blob = store.load()
            if blob is None:
                return
            state = pickle.loads(blob)
        except Exception:
            logger.exception(
                "GCS snapshot load from %s failed; starting fresh",
                store.describe(),
            )
            return
        self.actors = state.get("actors", {})
        self.named_actors = state.get("named_actors", {})
        self.placement_groups = state.get("placement_groups", {})
        self.named_pgs = state.get("named_pgs", {})
        self.kv = defaultdict(dict, state.get("kv", {}))
        self.jobs = state.get("jobs", {})
        self.next_job_int = state.get("next_job_int", 1)
        self.tenants = {
            n: tenants_mod.TenantSpec.from_dict(d)
            for n, d in state.get("tenants", {}).items()
        }
        grace = time.monotonic() + CONFIG.gcs_job_reattach_grace_s
        for job_id in self.jobs:
            self._job_reattach_deadline[job_id] = grace
        # Actors caught mid-scheduling are re-queued; they dispatch once
        # their nodes re-register.  ALIVE actors wait bounded time for
        # their node to come back — nodes aren't persisted, so without a
        # deadline an actor on a node that died with the GCS would stay
        # "ALIVE" forever and its callers would hang.
        node_grace = time.monotonic() + CONFIG.health_check_timeout_ms / 1000 + 10
        for actor_id, info in self.actors.items():
            if info.state in ("PENDING_CREATION", "RESTARTING"):
                self.pending_actors.append(actor_id)
            elif info.state == "ALIVE":
                self._actor_node_deadline[actor_id] = node_grace
        logger.info(
            "GCS restored snapshot: %d actors, %d pgs, %d jobs",
            len(self.actors), len(self.placement_groups), len(self.jobs),
        )

    async def stop(self):
        for t in self._bg_tasks:
            t.cancel()
        if CONFIG.gcs_storage == "file" and self._snapshot_dirty:
            try:
                self._write_snapshot()
            except Exception:
                pass
        await self.server.stop()
        for c in self.node_clients.values():
            c.close()

    # ------------------------------------------------------------------
    # pubsub
    # ------------------------------------------------------------------
    def publish(self, channel: str, message: Any):
        # Every actor/PG state transition is published; piggyback snapshot
        # dirtying here so persistence can't drift from visible state.
        if channel == "actors" or channel.startswith("actor:") or channel == "placement_groups":
            self._dirty()
        # Chaos on the pubsub plane (ROADMAP PR-1 follow-up): one decision
        # per published message, pattern "pubsub:<channel>" — so drain and
        # death notices can themselves be dropped/delayed/duplicated in
        # drills and the reactive heartbeat path is exercised as the
        # fallback.  Decisions stay deterministic in the per-rule match
        # ordinal, like every other chaos site.
        if CHAOS.active:
            d = CHAOS.decide(f"pubsub:{channel}", "req")
            if d.drop:
                return
            if d.delay_s > 0:
                self.loop.call_later(
                    d.delay_s, self._deliver_publish, channel, message
                )
                if not d.dup:
                    return
            elif d.dup:
                self._deliver_publish(channel, message)
        self._deliver_publish(channel, message)

    def _deliver_publish(self, channel: str, message: Any):
        dead = []
        for conn in self.subs.get(channel, ()):
            if conn.closed:
                dead.append(conn)
            else:
                conn.push("pubsub", (channel, message))
        for c in dead:
            self.subs[channel].discard(c)

    async def rpc_subscribe(self, payload, conn):
        channel = payload
        self.subs[channel].add(conn)
        return True

    async def rpc_unsubscribe(self, payload, conn):
        self.subs.get(payload, set()).discard(conn)
        return True

    async def push_publish(self, payload, conn):
        """Fan a node-originated message out to channel subscribers
        (raylet log monitors publish worker log batches this way)."""
        channel, message = payload
        self.publish(channel, message)

    # ------------------------------------------------------------------
    # cluster / session info
    # ------------------------------------------------------------------
    async def rpc_get_session_info(self, payload, conn):
        return self.session_info

    async def rpc_get_cluster_info(self, payload, conn):
        return {
            "nodes": {n.hex(): self._node_dict(i) for n, i in self.nodes.items()},
        }

    def _node_dict(self, info: NodeInfo) -> dict:
        return {
            "node_id": info.node_id.binary(),
            "raylet_address": info.raylet_address,
            "object_store_dir": info.object_store_dir,
            "resources_total": dict(info.resources_total),
            "available": dict(self.available.get(info.node_id, info.resources_total)),
            "state": info.state,
            "labels": info.labels,
            "is_head": info.is_head,
            "hostname": info.hostname,
            "start_time": info.start_time,
            "drain_reason": info.drain_reason,
            "drain_deadline": info.drain_deadline,
            "drain_complete": info.drain_complete,
            "incarnation": info.incarnation,
            "suspicion": round(info.suspicion, 3),
            "flap_count": info.flap_count,
        }

    # ------------------------------------------------------------------
    # node manager
    # ------------------------------------------------------------------
    def _check_fence(self, method: str, node_id, incarnation) -> None:
        """Reject a raylet-originated write carrying a stale (node_id,
        incarnation).  Fenced when the stamp is below the current
        incarnation, or equal to it but the node was declared DEAD at
        that incarnation — the zombie-on-the-far-side-of-a-partition
        case.  Unstamped payloads (workers, legacy callers) pass."""
        if node_id is None or incarnation is None:
            return
        if not isinstance(node_id, NodeID):
            node_id = NodeID(bytes(node_id))
        cur = self.node_incarnations.get(node_id)
        if cur is None:
            return
        incarnation = int(incarnation)
        info = self.nodes.get(node_id)
        dead = info is None or info.state == "DEAD"
        if incarnation < cur or (incarnation == cur and dead):
            telemetry.count_fence_rejection(method)
            logger.warning(
                "fenced %s from node %s: incarnation %d (current %d%s)",
                method, node_id.hex()[:8], incarnation, cur,
                ", DEAD" if dead else "",
            )
            raise NodeFencedError(
                f"{method} from node {node_id.hex()[:8]} fenced: "
                f"incarnation {incarnation} is stale (current {cur})",
                node_id=node_id.binary(),
                incarnation=incarnation,
            )
    # graftlint: disable=rpc-contract -- registration MINTS the incarnation the fence checks against; there is no prior incarnation to validate, and fencing here would deadlock every (re)join
    async def rpc_register_node(self, payload, conn):
        info = NodeInfo(
            node_id=NodeID(payload["node_id"]),
            raylet_address=payload["raylet_address"],
            object_store_dir=payload["object_store_dir"],
            resources_total=ResourceSet.of(payload["resources_total"]),
            labels=payload.get("labels", {}),
            is_head=payload.get("is_head", False),
            hostname=payload.get("hostname", ""),
            net_name=payload.get("net_name", ""),
        )
        # Stamp a fresh incarnation: strictly above every prior one for
        # this node_id, and wall-clock-derived so monotonicity survives a
        # GCS restart that lost the map (a rebooted GCS must never hand
        # out an incarnation a zombie from before the crash still holds).
        prev = self.nodes.get(info.node_id)
        inc = max(self.node_incarnations.get(info.node_id, 0) + 1, int(time.time()))
        self.node_incarnations[info.node_id] = inc
        info.incarnation = inc
        if prev is not None:
            # Re-registration carries over the flap history: quarantine's
            # flap budget must not reset just because the raylet bounced.
            info.flap_count = prev.flap_count
        self.nodes[info.node_id] = info
        self.available[info.node_id] = info.resources_total.copy()
        self.node_conns[info.node_id] = conn
        self.last_heartbeat[info.node_id] = time.monotonic()
        self.node_health.pop(info.node_id, None)
        self._chan_stats.pop(info.node_id, None)
        self._chan_prev.pop(info.node_id, None)
        self._recover_since.pop(info.node_id, None)
        conn.meta["node_id"] = info.node_id
        conn.meta["incarnation"] = inc
        client = rpc.AsyncRpcClient(info.raylet_address, peer_name=info.net_name)
        await client.connect()
        self.node_clients[info.node_id] = client
        self.publish("nodes", ("ALIVE", self._node_dict(info)))
        logger.info(
            "node %s registered (%s, incarnation %d)",
            info.node_id.hex()[:8], info.raylet_address, inc,
        )
        # Reconciliation for re-registration after a GCS restart: the
        # raylet reports which actors it still hosts and which objects it
        # holds; actors this GCS believes live on that node but the raylet
        # no longer hosts have died during the outage.
        live_actors = {bytes(a) for a in payload.get("live_actors", ())}
        for actor in list(self.actors.values()):
            if actor.node_id != info.node_id or actor.state != "ALIVE":
                continue
            self._actor_node_deadline.pop(actor.actor_id, None)
            if actor.actor_id.binary() not in live_actors:
                await self._on_actor_failure(actor, "actor lost during GCS outage")
        # ... and the other way: an actor the raylet still hosts that this
        # GCS has dead was killed while the raylet was away (a ray.kill
        # between a GCS restart and this registration finds no client to
        # push to), and its worker would hold its resources for good
        for aid in live_actors:
            actor = self.actors.get(ActorID(aid))
            if actor is not None and actor.state == "DEAD":
                try:
                    await client.push("kill_actor", {"actor_id": aid})
                except Exception:
                    logger.warning("kill of dead actor %s on node %s failed",
                                   actor.actor_id.hex()[:8], info.node_id.hex()[:8])
        for oid in payload.get("sealed_objects", ()):
            self.object_locations[bytes(oid)].add(info.node_id)
            self.sealed_ever.add(bytes(oid))
        # Re-schedule anything that was waiting for resources.
        self._kick_pending()
        return {"session_info": self.session_info, "incarnation": inc}

    async def rpc_resource_report(self, payload, conn):
        """Periodic per-raylet load report (reference: ray_syncer)."""
        node_id = NodeID(payload["node_id"])
        # Fence BEFORE the heartbeat touch: a zombie incarnation must not
        # keep its successor's liveness fresh (or resurrect a DEAD entry).
        self._check_fence("resource_report", node_id, payload.get("incarnation"))
        self.last_heartbeat[node_id] = time.monotonic()
        # Raylet-measured health (report RTT ewma, consecutive GCS call
        # failures) feeds the gray-failure suspicion score; accepted in
        # every live state — a SUSPECT node recovering must be heard.
        if node_id in self.nodes and self.nodes[node_id].state != "DEAD":
            self.node_health[node_id] = payload.get("health") or {}
        if node_id in self.nodes and self.nodes[node_id].state in ("ALIVE", "SUSPECT"):
            self.pending_shapes[node_id] = payload.get("pending_shapes", [])
            self.tenant_usage_by_node[node_id] = payload.get("tenant_usage", {})
            # Reconcile the lease-admission ledger: this report's
            # tenant_usage now carries the node's granted leases itself
            # (the raylet charges them to its local in-flight view).
            # Entries younger than one report period survive one cycle —
            # a report that raced past its grant must not uncharge it.
            entries = self._lease_charges.get(node_id)
            if entries is not None:
                cutoff = time.monotonic() - 0.3
                entries[:] = [e for e in entries if e[2] > cutoff]
                if not entries:
                    self._lease_charges.pop(node_id, None)
            self.pending_tenant_demand[node_id] = payload.get(
                "pending_tenant_demand", []
            )
            self.available[node_id] = ResourceSet.of(payload["available"])
            if payload.get("total"):
                self.nodes[node_id].resources_total = ResourceSet.of(payload["total"])
            # Broadcast the updated view so raylets can make spillback
            # decisions locally (reference: ray_syncer resource view sync).
            self.publish("resources", (node_id.binary(), payload["available"]))
            if (
                payload.get("has_pending")
                or self.pending_actors
                or any(pg.state == "PENDING" for pg in self.placement_groups.values())
            ):
                self._kick_pending()
        return True

    def _suspicion_score(self, node_id: NodeID, now: float, threshold: float) -> float:
        """Blended gray-failure suspicion for one node (0..1).

        Hard silence — the heartbeat gap against the death threshold —
        is the only component allowed to reach 1.0.  Gray signals
        (raylet-measured GCS report RTT/consecutive errors, worker-
        reported cross-host channel blocked-seconds and failed-reattach
        rates) cap
        at 0.9: a slow-but-alive link can push a node to SUSPECT and
        QUARANTINED, but never to a false DEAD."""
        gap = now - self.last_heartbeat.get(node_id, now)
        score = min(1.0, gap / threshold) if threshold > 0 else 0.0
        gray = 0.0
        h = self.node_health.get(node_id) or {}
        if float(CONFIG.suspect_rtt_ms) > 0:
            gray = max(gray, float(h.get("gcs_rtt_ms", 0.0)) / float(CONFIG.suspect_rtt_ms))
        if int(CONFIG.suspect_rpc_errors) > 0:
            gray = max(gray, float(h.get("gcs_errors", 0)) / int(CONFIG.suspect_rpc_errors))
        stats = self._chan_stats.get(node_id)
        if stats:
            blocked = sum(b for b, _ in stats.values())
            refail = sum(r for _, r in stats.values())
            pb, pr, pt = self._chan_prev.get(node_id, (blocked, refail, now))
            dt = now - pt
            if dt > 0:
                rate = max(0.0, blocked - pb) / dt
                if float(CONFIG.suspect_channel_blocked_ratio) > 0:
                    gray = max(gray, rate / float(CONFIG.suspect_channel_blocked_ratio))
                if int(CONFIG.suspect_channel_reattach_fails) > 0:
                    gray = max(
                        gray,
                        max(0.0, refail - pr) / int(CONFIG.suspect_channel_reattach_fails),
                    )
            self._chan_prev[node_id] = (blocked, refail, now)
        return max(score, min(0.9, gray))

    async def _health_loop(self):
        period = CONFIG.health_check_period_ms / 1000
        threshold = CONFIG.health_check_timeout_ms / 1000
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node_id, info in list(self.nodes.items()):
                # DRAINING/SUSPECT/QUARANTINED nodes stay under heartbeat
                # watch: the reactive path is the fallback when the drain
                # notice (or the whole drain) is lost — a preempted node
                # that dies at its deadline is detected here like any
                # other death.
                if info.state == "DEAD":
                    continue
                conn = self.node_conns.get(node_id)
                gap = now - self.last_heartbeat.get(node_id, now)
                score = self._suspicion_score(node_id, now, threshold)
                info.suspicion = score
                telemetry.set_node_suspicion(node_id.hex()[:12], score)
                # Hard-silence death.  An asymmetric partition (this
                # node's frames dropped, TCP conn still open at our end)
                # never closes the connection — sustained silence past
                # dead_conn_open_factor x timeout kills it anyway.
                if gap > threshold and (
                    conn is None
                    or conn.closed
                    or gap > threshold * float(CONFIG.dead_conn_open_factor)
                ):
                    await self._mark_node_dead(node_id, "health check: heartbeat timeout")
                    continue
                if info.state == "DRAINING":
                    continue  # the drain task owns the next transition
                if info.state == "ALIVE":
                    if score >= float(CONFIG.suspect_score_threshold):
                        info.state = "SUSPECT"
                        info.suspect_since = now
                        self._recover_since.pop(node_id, None)
                        logger.warning(
                            "node %s SUSPECT (score %.2f): soft-cordoned",
                            node_id.hex()[:8], score,
                        )
                        self.publish("nodes", ("SUSPECT", self._node_dict(info)))
                elif info.state == "SUSPECT":
                    if score < float(CONFIG.suspect_clear_threshold):
                        info.state = "ALIVE"
                        info.suspect_since = 0.0
                        logger.info(
                            "node %s recovered from SUSPECT (score %.2f)",
                            node_id.hex()[:8], score,
                        )
                        self.publish("nodes", ("ALIVE", self._node_dict(info)))
                        self._kick_pending()
                    elif score < float(CONFIG.suspect_score_threshold):
                        # Dipped into the hysteresis band: hold SUSPECT
                        # but restart the escalation clock.
                        info.suspect_since = now
                    elif now - info.suspect_since >= float(CONFIG.quarantine_after_s):
                        await self._quarantine_node(info, "gray_failure")
                elif info.state == "QUARANTINED":
                    self._maybe_unquarantine(info, score, now)
            # Jobs restored from a snapshot whose driver never reattached.
            for job_id, deadline in list(self._job_reattach_deadline.items()):
                if now > deadline:
                    self._job_reattach_deadline.pop(job_id, None)
                    await self._on_driver_exit(job_id)
            # Restored ALIVE actors whose node never re-registered.
            for actor_id, deadline in list(self._actor_node_deadline.items()):
                if now > deadline:
                    self._actor_node_deadline.pop(actor_id, None)
                    actor = self.actors.get(actor_id)
                    if actor is not None and actor.state == "ALIVE":
                        await self._on_actor_failure(
                            actor, "actor's node never returned after GCS restart"
                        )

    async def _on_disconnect(self, conn):
        node_id = conn.meta.get("node_id")
        if node_id is not None and node_id in self.nodes:
            await self._mark_node_dead(node_id, "raylet connection closed")
        job_id = conn.meta.get("job_id")
        if job_id is not None:
            await self._on_driver_exit(job_id)

    async def _mark_node_dead(self, node_id: NodeID, reason: str):
        info = self.nodes.get(node_id)
        if info is None or info.state == "DEAD":
            return
        info.state = "DEAD"
        logger.warning("node %s dead: %s", node_id.hex()[:8], reason)
        # Capacity-return feed: preemption notices AND notice-less worker-
        # node deaths (heartbeat-timeout DEAD) — both are capacity the
        # cluster wants back.  Only planned idle scale-down
        # (IDLE_TERMINATION) is excluded: that capacity left on purpose.
        lost_reason = info.drain_reason or "NODE_DEATH"
        if not info.is_head and lost_reason != "IDLE_TERMINATION":
            # Surface it to the autoscaler so a replacement launches even
            # when no task demand is pending (an elastic trainer running
            # shrunken queues nothing — it adapted instead of stalling).
            telemetry.count_lost_capacity(lost_reason)
            if len(self.lost_capacity) == self.lost_capacity.maxlen:
                evicted = self.lost_capacity[0]
                logger.warning(
                    "lost_capacity log full (%d): dropping record for "
                    "preempted node %s — its replacement will NOT be "
                    "auto-launched", self.lost_capacity.maxlen,
                    evicted.get("node_id", "?")[:8],
                )
            self.lost_capacity.append(
                {
                    "node_id": node_id.hex(),
                    "resources_total": dict(info.resources_total),
                    "reason": lost_reason,
                    "time": time.time(),
                }
            )
        self.available.pop(node_id, None)
        self.pending_shapes.pop(node_id, None)
        self.tenant_usage_by_node.pop(node_id, None)
        self.pending_tenant_demand.pop(node_id, None)
        # Suspicion-plane state dies with the node; node_incarnations
        # survives on purpose — the fence outlives the corpse.
        self.node_health.pop(node_id, None)
        self._chan_stats.pop(node_id, None)
        self._chan_prev.pop(node_id, None)
        self._recover_since.pop(node_id, None)
        info.suspicion = 1.0
        telemetry.set_node_suspicion(node_id.hex()[:12], 1.0)
        client = self.node_clients.pop(node_id, None)
        if client:
            client.close()
        # Drop object locations on that node.
        for oid, locs in list(self.object_locations.items()):
            locs.discard(node_id)
            if not locs:
                del self.object_locations[oid]
        self.publish("nodes", ("DEAD", self._node_dict(info)))
        # Actors on that node die (maybe restart).
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in ("ALIVE", "PENDING_CREATION", "RESTARTING"):
                await self._on_actor_failure(actor, f"node {node_id.hex()[:8]} died")
        # PG bundles on that node need rescheduling.
        for pg in self.placement_groups.values():
            if pg.state == "CREATED" and any(b.node_id == node_id for b in pg.bundles):
                pg.state = "RESCHEDULING"
                self.loop.create_task(self._schedule_pg(pg))

    # ------------------------------------------------------------------
    # drain plane (reference: gcs_node_manager DrainNode; the autoscaler
    # and preemption notices turn planned node loss into a cheap,
    # proactive path instead of a heartbeat-timeout + lineage repair)
    # ------------------------------------------------------------------
    # graftlint: disable=rpc-contract -- drain originates from the driver/autoscaler, not the node: payload node_id names the TARGET, so a sender-incarnation fence does not apply; stale drains are bounded by the state check below
    async def rpc_drain_node(self, payload, conn):
        """Start draining a node: ALIVE -> DRAINING.  The node stops
        receiving new work (its raylet rejects leases and bundle
        reservations; this GCS stops placing actors there), restartable
        actors are migrated ahead of the kill, and objects whose only
        live copy sits on the draining node are re-replicated so lineage
        reconstruction is never needed on the happy path.  Idempotent —
        a duplicate drain joins the in-flight one."""
        node_id = NodeID(payload["node_id"])
        info = self.nodes.get(node_id)
        if info is None or info.state == "DEAD":
            return {"accepted": False, "state": info.state if info else None}
        reason = payload.get("reason") or "PREEMPTION"
        deadline_s = float(payload.get("deadline_s") or CONFIG.drain_deadline_s_default)
        if info.state == "DRAINING":
            # Keep the earliest deadline (a second, tighter notice wins).
            info.drain_deadline = min(info.drain_deadline, time.time() + deadline_s)
            return {"accepted": True, "state": "DRAINING"}
        info.state = "DRAINING"
        info.drain_reason = reason
        info.drain_deadline = time.time() + deadline_s
        info.drain_complete = False
        self.available.pop(node_id, None)
        self.pending_shapes.pop(node_id, None)
        telemetry.count_drain_event(reason)
        logger.warning(
            "node %s draining (%s, deadline in %.1fs)",
            node_id.hex()[:8], reason, deadline_s,
        )
        # Direct push to the raylet (not only pubsub, which drills may
        # chaos-drop): it must stop granting leases immediately.
        client = self.node_clients.get(node_id)
        if client is not None:
            try:
                await client.push(
                    "drain", {"reason": reason, "deadline": info.drain_deadline}
                )
            except Exception:
                pass
        self.publish("nodes", ("DRAINING", self._node_dict(info)))
        # CREATED placement groups with a bundle on the doomed node are
        # rescheduled AHEAD of the kill (the reactive path at node death
        # still covers notice-less losses).  Only the AFFECTED bundles
        # move: bundles on healthy nodes keep their reservations and the
        # actors running in them.
        for pg in self.placement_groups.values():
            if pg.state == "CREATED" and any(
                b.node_id == node_id for b in pg.bundles
            ):
                logger.info(
                    "PG %s has bundle(s) on draining node %s: rescheduling "
                    "them ahead of the kill", pg.pg_id.hex()[:8], node_id.hex()[:8],
                )
                self.loop.create_task(
                    self._reschedule_pg_bundles(pg, node_id)
                )
        self.loop.create_task(self._drain_node_task(info))
        return {"accepted": True, "state": "DRAINING"}

    async def _drain_node_task(self, info: NodeInfo):
        """Background migration for one draining node: restart-capable
        actors are restarted elsewhere NOW (reusing the idempotent
        lease/submit machinery), and sole-copy objects are pulled to a
        live node via the object manager, then the node is marked
        drain-complete."""
        node_id = info.node_id
        t0 = time.monotonic()
        # Actor kills run CONCURRENTLY with object replication: a slow
        # actor __init__ on the new host (restart is awaited inside
        # _kill_actor -> _schedule_actor) must not stall the sole-copy
        # scan past the deadline.
        kill_tasks = []
        for actor in list(self.actors.values()):
            if actor.node_id != node_id or actor.state not in ("ALIVE", "PENDING_CREATION"):
                continue
            if actor.max_restarts == -1 or actor.num_restarts < actor.max_restarts:
                # no_restart=False: kill the old worker, then the normal
                # restart path schedules the actor on a non-draining node
                # (_pick_node only considers ALIVE nodes).
                kill_tasks.append(
                    self.loop.create_task(
                        self._kill_actor(
                            actor,
                            f"node {node_id.hex()[:8]} draining ({info.drain_reason})",
                            no_restart=False,
                        )
                    )
                )
        # Objects whose every live location is draining: replicate to the
        # most-available ALIVE node.  DRAINING locations still serve
        # reads, so the pull path can fetch from the doomed node.  The
        # doomed set is RECOMPUTED on every pass — in-flight work is
        # allowed to run to completion during the notice, and anything it
        # seals on the draining node becomes a new sole copy.
        requested: set = set()
        replication_failed = False

        def current_doomed():
            return [
                bytes(oid)
                for oid, locs in self.object_locations.items()
                if node_id in locs
                and not any(
                    (ni := self.nodes.get(n)) is not None and ni.state == "ALIVE"
                    for n in locs
                )
            ]

        async def replicate_new():
            """Ask a live node to pull any not-yet-requested sole copies;
            returns the currently-doomed set."""
            nonlocal replication_failed
            doomed = current_doomed()
            new = [o for o in doomed if o not in requested]
            if not new:
                return doomed
            targets = [n for n, i in self.nodes.items() if i.state == "ALIVE"]
            tclient = (
                self.node_clients.get(
                    max(
                        targets,
                        key=lambda n: sum(self.available.get(n, ResourceSet()).values()),
                    )
                )
                if targets
                else None
            )
            if tclient is None:
                replication_failed = True  # nowhere to put the only copies
                return doomed
            try:
                await tclient.push("replicate_objects", {"oids": new})
                requested.update(new)
            except Exception:
                replication_failed = True
            return doomed

        poll = CONFIG.drain_poll_ms / 1000
        while info.state == "DRAINING" and time.time() < info.drain_deadline:
            if not await replicate_new():
                break
            await asyncio.sleep(poll)
        # Bound the wait on actor restarts by the notice window; a wait
        # (not gather+wait_for) so a timeout doesn't cancel the restarts.
        if kill_tasks:
            await asyncio.wait(
                kill_tasks, timeout=max(0.1, info.drain_deadline - time.time())
            )
        # Final sweep: anything sealed while the actors were restarting.
        while (
            info.state == "DRAINING"
            and time.time() < info.drain_deadline
            and await replicate_new()
        ):
            await asyncio.sleep(poll)
        if info.state != "DRAINING":
            return  # died mid-drain; _mark_node_dead already handled it
        elapsed = time.monotonic() - t0
        migrated = sum(1 for t in kill_tasks if t.done())
        if replication_failed or current_doomed():
            # drain_complete stays False: the node still holds the only
            # copy of something.  The autoscaler's terminate-by deadline
            # is the (pre-drain-plane) fallback; a preempted node dies
            # regardless and lineage reconstruction repairs reactively.
            logger.warning(
                "node %s drain incomplete after %.2fs: %d sole-copy "
                "object(s) still unreplicated",
                node_id.hex()[:8], elapsed, len(current_doomed()),
            )
            # A quarantine drain still parks the node: nothing is about
            # to kill it, and its copies keep serving reads from
            # QUARANTINED exactly as they did from DRAINING.
            self._finish_quarantine(info)
            return
        info.drain_complete = True
        telemetry.observe_drain_migration(elapsed)
        logger.info(
            "node %s drain complete in %.2fs: %d actor(s) migrated, "
            "%d sole-copy object(s) replicated",
            node_id.hex()[:8], elapsed, migrated, len(requested),
        )
        self.publish("nodes", ("DRAINING", self._node_dict(info)))
        self._finish_quarantine(info)

    # ------------------------------------------------------------------
    # quarantine plane: sustained gray failure rides the drain machinery
    # (stop placement, migrate restartable actors, re-replicate sole
    # copies) but parks in QUARANTINED instead of being terminated, and
    # is readmitted with hysteresis under a bounded flap budget.
    # ------------------------------------------------------------------
    async def _quarantine_node(self, info: NodeInfo, reason: str):
        node_id = info.node_id
        telemetry.count_quarantine(reason, "enter")
        logger.warning(
            "node %s QUARANTINED (%s, score %.2f): draining work off it",
            node_id.hex()[:8], reason, info.suspicion,
        )
        await self.rpc_drain_node(
            {
                "node_id": node_id.binary(),
                "reason": "QUARANTINE",
                "deadline_s": float(CONFIG.quarantine_drain_deadline_s),
            },
            None,
        )

    def _finish_quarantine(self, info: NodeInfo):
        """A completed (or deadline-expired) QUARANTINE drain parks the
        node in QUARANTINED; other drains end in termination instead."""
        if info.drain_reason != "QUARANTINE" or info.state != "DRAINING":
            return
        info.state = "QUARANTINED"
        info.quarantined_since = time.monotonic()
        self._recover_since.pop(info.node_id, None)
        logger.warning("node %s parked in QUARANTINED", info.node_id.hex()[:8])
        self.publish("nodes", ("QUARANTINED", self._node_dict(info)))

    def _maybe_unquarantine(self, info: NodeInfo, score: float, now: float):
        node_id = info.node_id
        if score >= float(CONFIG.suspect_clear_threshold):
            self._recover_since.pop(node_id, None)  # hysteresis resets
            return
        since = self._recover_since.setdefault(node_id, now)
        if now - since < float(CONFIG.unquarantine_hysteresis_s):
            return
        if info.flap_count >= int(CONFIG.node_flap_budget):
            # Budget exhausted: a link that oscillates every few seconds
            # must not keep yanking the node in and out of the placement
            # pool.  Stays quarantined until re-registration/operator.
            return
        info.flap_count += 1
        info.state = "ALIVE"
        info.suspect_since = 0.0
        info.quarantined_since = 0.0
        info.drain_reason = None
        info.drain_deadline = 0.0
        info.drain_complete = False
        self._recover_since.pop(node_id, None)
        telemetry.count_quarantine("gray_failure", "exit")
        logger.warning(
            "node %s un-quarantined (flap %d/%d)",
            node_id.hex()[:8], info.flap_count, int(CONFIG.node_flap_budget),
        )
        # The raylet was told to drain when quarantine entered — tell it
        # to resume granting leases (best-effort; its next lease attempt
        # would otherwise be rejected forever).
        client = self.node_clients.get(node_id)
        if client is not None:
            async def _undrain():
                try:
                    await client.push("undrain", {})
                except Exception:
                    pass
            self.loop.create_task(_undrain())
        self.publish("nodes", ("ALIVE", self._node_dict(info)))
        self._kick_pending()

    # ------------------------------------------------------------------
    # job manager
    # ------------------------------------------------------------------
    async def rpc_register_driver(self, payload, conn):
        job_id = JobID.from_int(self.next_job_int)
        self.next_job_int += 1
        config = payload.get("config", {})
        tenant = tenants_mod.normalize_tenant(config.get("tenant"))
        # Priority resolution: an explicit per-job priority wins; a job
        # that didn't set one inherits its tenant's registered default.
        if config.get("priority") is not None:
            priority = int(config["priority"])
        else:
            spec = self.tenants.get(tenant)
            priority = spec.priority if spec is not None else 0
        self.jobs[job_id] = {
            "job_id": job_id.binary(),
            "state": "RUNNING",
            "start_time": time.time(),
            "namespace": payload.get("namespace") or f"anon_{job_id.hex()}",
            "entrypoint": payload.get("entrypoint", ""),
            "config": config,
            "tenant": tenant,
            "priority": priority,
        }
        conn.meta["job_id"] = job_id
        self.driver_conns[job_id] = conn
        self._dirty()
        self.publish("jobs", ("RUNNING", job_id.binary()))
        return {
            "job_id": job_id.binary(),
            "namespace": self.jobs[job_id]["namespace"],
            "session_info": self.session_info,
            # Effective tenant identity (tenant-default priority applied)
            # so the driver stamps the SAME priority on its lease requests
            # that the GCS uses for preemption decisions.
            "tenant": tenant,
            "priority": priority,
        }

    async def rpc_reattach_driver(self, payload, conn):
        """A driver's reconnecting GCS client re-binds its job after a GCS
        restart so disconnect-driven job cleanup keeps working."""
        job_id = JobID(payload["job_id"])
        job = self.jobs.get(job_id)
        if job is None or job["state"] == "FINISHED":
            return False
        conn.meta["job_id"] = job_id
        self.driver_conns[job_id] = conn
        self._job_reattach_deadline.pop(job_id, None)
        return True

    async def _on_driver_exit(self, job_id: JobID):
        job = self.jobs.get(job_id)
        if not job or job["state"] == "FINISHED":
            return
        job["state"] = "FINISHED"
        job["end_time"] = time.time()
        self.driver_conns.pop(job_id, None)
        self._job_reattach_deadline.pop(job_id, None)
        self._preempt_notices.pop(job_id, None)
        self._dirty()
        self.publish("jobs", ("FINISHED", job_id.binary()))
        # Kill this job's non-detached actors.
        for actor in list(self.actors.values()):
            if actor.actor_id.job_id() == job_id and not actor.detached and actor.state != "DEAD":
                await self._kill_actor(actor, "the job driver exited", no_restart=True)
        # Remove this job's non-detached placement groups.
        for pg in list(self.placement_groups.values()):
            if pg.creator_job == job_id and pg.state not in ("REMOVED",):
                await self._remove_pg(pg)
        # Tell raylets to reap workers and stored objects of this job.
        for client in self.node_clients.values():
            try:
                await client.push("job_finished", job_id.binary())
            except Exception:
                pass
        # Drop directory entries for the job's objects (job id is embedded
        # in every object id).
        for oid in list(self.object_locations):
            try:
                if ObjectID(oid).job_id() == job_id:
                    self.object_locations.pop(oid, None)
            except Exception:
                pass
        for oid in list(self.sealed_ever):
            try:
                if ObjectID(oid).job_id() == job_id:
                    self.sealed_ever.discard(oid)
            except Exception:
                pass

    async def rpc_get_job_config(self, payload, conn):
        job = self.jobs.get(JobID(payload))
        if not job:
            return {}
        # Overlay the EFFECTIVE tenant identity (tenant-default priority
        # resolved at registration) so raylets that fetch the config for
        # remote-node worker spawns stamp the same values the scheduler
        # uses.
        return dict(
            job["config"],
            tenant=job.get("tenant", "default"),
            priority=job.get("priority", 0),
        )

    async def rpc_list_jobs(self, payload, conn):
        return [dict(j, job_id=j["job_id"]) for j in self.jobs.values()]

    # ------------------------------------------------------------------
    # multi-tenant job plane: quota registry, usage aggregation, fair
    # shares, priority preemption (tenants.py holds the pure math)
    # ------------------------------------------------------------------
    def _job_tenant_priority(self, job_id: Optional[JobID]) -> Tuple[str, int]:
        job = self.jobs.get(job_id) if job_id is not None else None
        if not job:
            return tenants_mod.DEFAULT_TENANT, 0
        return (
            tenants_mod.normalize_tenant(job.get("tenant")),
            int(job.get("priority", 0)),
        )

    def _cluster_totals(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for info in self.nodes.values():
            if info.state in _LIVE_STATES:
                for k, v in info.resources_total.items():
                    totals[k] = totals.get(k, 0.0) + v
        return totals

    def _aggregate_tenant_usage(self) -> Dict[str, Dict[str, float]]:
        """Cluster-wide per-tenant usage: the sum of raylet-reported
        usage over live nodes, plus the optimistic ledger of admissions
        younger than one report period (closes the window where two
        over-quota admissions could both pass the check against a stale
        report)."""
        usage: Dict[str, Dict[str, float]] = {}
        for node_id, per_tenant in self.tenant_usage_by_node.items():
            info = self.nodes.get(node_id)
            if info is None or info.state not in _LIVE_STATES:
                continue
            for tenant, res in per_tenant.items():
                tenants_mod.add_usage(usage, tenant, res)
        now = time.monotonic()
        self._tenant_admit_delta = [
            (t, r, ts) for (t, r, ts) in self._tenant_admit_delta if now - ts < 1.0
        ]
        for tenant, res, _ts in self._tenant_admit_delta:
            tenants_mod.add_usage(usage, tenant, res)
        # Lease-admission charges: counted until the granting node's next
        # report carries the lease itself.  (The charging raylet briefly
        # sees its own lease twice — ledger + live local view — which is
        # the conservative direction: it can transiently under-admit,
        # never over-admit.)
        for node_id, entries in list(self._lease_charges.items()):
            info = self.nodes.get(node_id)
            if info is None or info.state not in _LIVE_STATES:
                self._lease_charges.pop(node_id, None)
                continue
            entries[:] = [e for e in entries if now - e[2] < 5.0]
            for tenant, res, _ts in entries:
                tenants_mod.add_usage(usage, tenant, res)
        return usage

    def _tenant_over_quota(
        self, tenant: str, extra: Optional[dict], usage: Optional[dict] = None
    ) -> bool:
        """``usage`` lets per-tick loops aggregate once and pass it down
        (aggregation walks every node's report; it's identical within a
        tick)."""
        if not CONFIG.tenant_quota_enforcement:
            return False
        spec = self.tenants.get(tenant)
        if spec is None or not spec.quota:
            return False
        if usage is None:
            usage = self._aggregate_tenant_usage()
        return tenants_mod.over_quota(usage.get(tenant), extra, spec.quota)

    def _note_admission(self, tenant: str, res: ResourceSet):
        if res:
            self._tenant_admit_delta.append((tenant, res.copy(), time.monotonic()))

    async def rpc_tenant_charge_lease(self, payload, conn):
        """Atomic check-and-charge against the lease-admission ledger: a
        raylet about to grant a quota'd tenant's lease asks HERE first.
        The GCS event loop is the single serialization point, so two
        raylets racing the same quota headroom can never both pass — the
        cross-raylet over-admission window the cooperative-revocation
        path existed to mop up is closed at admission time.  The charge
        is reconciled away when the granting node's next resource_report
        arrives carrying the lease (and time-capped for nodes that die
        first)."""
        # Fence BEFORE the enforcement short-circuit: a zombie raylet's
        # lease confirmation must fail typed (the raylet reacts by
        # tearing down), never silently succeed.
        self._check_fence(
            "tenant_charge_lease", payload.get("node_id"), payload.get("incarnation")
        )
        if not CONFIG.tenant_quota_enforcement:
            return {"ok": True}
        node_id = NodeID(payload["node_id"])
        tenant = tenants_mod.normalize_tenant(payload.get("tenant"))
        res = ResourceSet.of(payload.get("resources") or {})
        if not res:
            return {"ok": True}
        if payload.get("check") and self._tenant_over_quota(tenant, dict(res)):
            return {"ok": False}
        self._lease_charges.setdefault(node_id, []).append(
            (tenant, res, time.monotonic())
        )
        # prompt (throttled) publish so peer raylets' own local checks
        # converge too, not just callers of this RPC
        if time.monotonic() - self._last_usage_publish >= 0.05:
            self._publish_tenant_usage()
        return {"ok": True}

    async def rpc_tenant_set_quota(self, payload, conn):
        """Register (or update) a tenant: quota resources, DRF weight,
        default priority.  Idempotent; publishing the refreshed view
        wakes parked admissions and raylet lease queues."""
        name = tenants_mod.normalize_tenant(payload.get("tenant"))
        spec = self.tenants.get(name) or tenants_mod.TenantSpec(name=name)
        if payload.get("quota") is not None:
            spec.quota = ResourceSet.of(payload["quota"])
        if payload.get("weight") is not None:
            spec.weight = float(payload["weight"]) or 1.0
        if payload.get("priority") is not None:
            spec.priority = int(payload["priority"])
        self.tenants[name] = spec
        self._dirty()
        self._publish_tenant_usage()
        self._kick_pending()
        return spec.to_dict()

    async def rpc_get_tenant(self, payload, conn):
        name = tenants_mod.normalize_tenant(payload)
        spec = self.tenants.get(name)
        usage = self._aggregate_tenant_usage()
        out = spec.to_dict() if spec else {
            "name": name, "quota": {}, "weight": 1.0, "priority": 0,
        }
        out["usage"] = usage.get(name, {})
        out["dominant_share"] = tenants_mod.dominant_share(
            usage.get(name), self._cluster_totals(), out["weight"]
        )
        return out

    async def rpc_list_tenants(self, payload, conn):
        usage = self._aggregate_tenant_usage()
        totals = self._cluster_totals()
        names = set(self.tenants) | set(usage)
        out = []
        for name in sorted(names):
            spec = self.tenants.get(name)
            d = spec.to_dict() if spec else {
                "name": name, "quota": {}, "weight": 1.0, "priority": 0,
            }
            d["usage"] = usage.get(name, {})
            d["dominant_share"] = tenants_mod.dominant_share(
                usage.get(name), totals, d["weight"]
            )
            d["parked"] = sum(
                1
                for aid in self._quota_parked
                if aid in self.actors
                and self._job_tenant_priority(aid.job_id())[0] == name
            )
            out.append(d)
        return out

    def _publish_tenant_usage(self):
        """Broadcast the cluster-wide tenant view (usage + specs +
        totals) so raylets converge on the same DRF ordering and quota
        decisions; also exports the tenant gauges."""
        self._last_usage_publish = time.monotonic()
        usage = self._aggregate_tenant_usage()
        totals = self._cluster_totals()
        self.publish(
            "tenant_usage",
            {
                "usage": usage,
                "totals": totals,
                "tenants": {n: s.to_dict() for n, s in self.tenants.items()},
            },
        )
        # Aggregate per LABEL before setting the gauges: multiple
        # unregistered tenants share the "other" label, and last-write-
        # wins gauges would otherwise report one arbitrary tenant's
        # value instead of their sum.
        registered = set(self.tenants)
        label_usage: Dict[str, Dict[str, float]] = {}
        for tenant in set(usage) | registered:
            label = tenants_mod.tenant_label(tenant, registered)
            acc = label_usage.setdefault(label, {})
            for r, v in (usage.get(tenant) or {}).items():
                rl = tenants_mod.resource_label(r)
                acc[rl] = acc.get(rl, 0.0) + v
        for label, by_res in label_usage.items():
            spec = self.tenants.get(label)
            telemetry.set_tenant_dominant_share(
                label,
                tenants_mod.dominant_share(
                    by_res, totals, spec.weight if spec else 1.0
                ),
            )
            for rl, v in by_res.items():
                telemetry.set_tenant_usage(label, rl, v)

    async def _tenant_usage_loop(self):
        period = CONFIG.tenant_usage_publish_ms / 1000
        while True:
            await asyncio.sleep(period)
            try:
                self._publish_tenant_usage()
            except Exception:
                logger.exception("tenant usage publish failed")

    # ---- priority preemption ----------------------------------------
    def _starved_demands(self) -> List[dict]:
        """Demand that has sat unplaceable past the preemption grace:
        resource-starved pending actors (not quota-parked — a tenant over
        its own quota earned its wait) and tenant-tagged lease demand
        reported by raylets."""
        now = time.monotonic()
        grace = float(CONFIG.preemption_grace_s)
        out: List[dict] = []
        usage = self._aggregate_tenant_usage()  # once per tick, passed down
        for actor_id, since in self._pending_since.items():
            if now - since < grace or actor_id in self._quota_parked:
                continue
            info = self.actors.get(actor_id)
            if info is None or info.state not in ("PENDING_CREATION", "RESTARTING"):
                continue
            if info.node_id is not None:
                # Placed, creation in flight (possibly a long __init__):
                # not starved — only actors BETWEEN homes count.
                continue
            tenant, priority = self._job_tenant_priority(actor_id.job_id())
            if self._tenant_over_quota(
                tenant,
                dict(info.creation_spec.resources) if info.creation_spec else None,
                usage=usage,
            ):
                continue
            out.append(
                {"tenant": tenant, "priority": priority,
                 "resources": dict(info.creation_spec.resources)
                 if info.creation_spec else {}}
            )
        for node_id, demands in self.pending_tenant_demand.items():
            info = self.nodes.get(node_id)
            if info is None or info.state != "ALIVE":
                continue
            for d in demands:
                if float(d.get("age_s", 0.0)) < grace:
                    continue
                tenant = tenants_mod.normalize_tenant(d.get("tenant"))
                if self._tenant_over_quota(tenant, d.get("shape"), usage=usage):
                    continue
                out.append(
                    {"tenant": tenant, "priority": int(d.get("priority", 0)),
                     "resources": d.get("shape", {})}
                )
        return out

    async def _preemption_loop(self):
        period = CONFIG.preemption_check_period_ms / 1000
        while True:
            await asyncio.sleep(period)
            try:
                await self._preemption_tick()
            except Exception:
                logger.exception("preemption tick failed")

    async def _preemption_tick(self):
        starved = self._starved_demands()
        if not starved:
            # Episode over: clear notice state so the NEXT starvation
            # starts with a fresh cooperative notice — a stale timestamp
            # would make it skip straight to the actor-kill escalation.
            if self._preempt_notices:
                self._preempt_notices.clear()
            return
        top = max(s["priority"] for s in starved)
        # Victims: RUNNING jobs whose priority is strictly below the
        # starved demand's.  Over-quota tenants first, then highest
        # dominant share, then lowest priority, then youngest job.
        victims = [
            dict(j, _job_id=jid)
            for jid, j in self.jobs.items()
            if j.get("state") == "RUNNING" and int(j.get("priority", 0)) < top
        ]
        if not victims:
            return
        usage = self._aggregate_tenant_usage()
        totals = self._cluster_totals()
        ordered = tenants_mod.preemption_victim_order(
            victims, usage, totals, self.tenants
        )
        registered = set(self.tenants)
        now = time.monotonic()
        notice_deadline = float(CONFIG.preemption_notice_deadline_s)
        for job in ordered:
            job_id = job["_job_id"]
            tenant = tenants_mod.normalize_tenant(job.get("tenant"))
            label = tenants_mod.tenant_label(tenant, registered)
            noticed = self._preempt_notices.get(job_id)
            if noticed is None:
                # Phase 1: cooperative notice.  An elastic trainer
                # checkpoints and shrinks (releasing workers); anything
                # else gets the escalation below after the deadline.
                release = max(1, sum(1 for s in starved if s["priority"] == top))
                conn = self.driver_conns.get(job_id)
                if conn is not None and not conn.closed:
                    try:
                        conn.push(
                            "preempt_job",
                            {
                                "reason": (
                                    f"priority-{top} demand starved; this job "
                                    f"(priority {job.get('priority', 0)}) is "
                                    "being preempted"
                                ),
                                "deadline_s": notice_deadline,
                                "release_workers": release,
                                # Clamped against the registry HERE so the
                                # driver-side shrink counter lands on the
                                # same label as notice/actor_restart.
                                "tenant_label": label,
                            },
                        )
                    except Exception:
                        pass
                self._preempt_notices[job_id] = now
                telemetry.count_tenant_preemption(label, "notice")
                logger.warning(
                    "preempting job %s (tenant %s, priority %s): notice "
                    "pushed, escalation in %.0fs",
                    job_id.hex()[:8], tenant, job.get("priority", 0),
                    notice_deadline,
                )
                return  # one victim per tick: give the notice time to act
            if now - noticed < notice_deadline:
                return  # notice still pending; don't pile on
            # Phase 2: escalation — graceful kill + restart-elsewhere of
            # ONE restartable actor per tick (never a raw kill: the
            # restart re-enters admission, where fair-share/quota decide
            # where — and whether — it lands).
            for actor in list(self.actors.values()):
                if (
                    actor.actor_id.job_id() == job_id
                    and actor.state == "ALIVE"
                    and (
                        actor.max_restarts == -1
                        or actor.num_restarts < actor.max_restarts
                    )
                ):
                    telemetry.count_tenant_preemption(label, "actor_restart")
                    logger.warning(
                        "preemption escalation: restarting actor %s of job "
                        "%s elsewhere", actor.actor_id.hex()[:8],
                        job_id.hex()[:8],
                    )
                    self._preempt_notices[job_id] = now  # re-arm the pacing
                    await self._kill_actor(
                        actor,
                        "preempted by higher-priority demand",
                        no_restart=False,
                    )
                    return
        # All victims noticed and nothing left to escalate: let notices
        # expire naturally (demand may clear via other capacity).

    # ------------------------------------------------------------------
    # kv store (function table, runtime envs, user internal kv)
    # ------------------------------------------------------------------
    async def rpc_kv_put(self, payload, conn):
        ns, key, value, overwrite = payload
        table = self.kv[ns]
        if not overwrite and key in table:
            return False
        table[key] = value
        self._dirty()
        return True

    async def rpc_kv_get(self, payload, conn):
        """rpc-contract: read-only — pure KV lookup, safe to retry."""
        ns, key = payload
        return self.kv.get(ns, {}).get(key)

    async def rpc_kv_multi_get(self, payload, conn):
        ns, keys = payload
        table = self.kv.get(ns, {})
        return {k: table[k] for k in keys if k in table}

    async def rpc_kv_put_max(self, payload, conn):
        """Monotonic integer cell: store max(current, value) and return
        the stored value.  Atomic (single handler on the GCS loop) — the
        collective generation marker uses this so a stale joiner's write
        can never regress a newer generation bump."""
        ns, key, value = payload
        table = self.kv[ns]
        try:
            cur = int(table.get(key, b"").decode() or -1)
        except ValueError:
            cur = -1
        new = max(cur, int(value))
        table[key] = str(new).encode()
        self._dirty()
        return new

    async def rpc_kv_del(self, payload, conn):
        ns, key = payload
        self._dirty()
        return self.kv.get(ns, {}).pop(key, None) is not None

    async def rpc_kv_keys(self, payload, conn):
        ns, prefix = payload
        return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]

    async def rpc_kv_exists(self, payload, conn):
        ns, key = payload
        return key in self.kv.get(ns, {})

    # ------------------------------------------------------------------
    # object directory
    # ------------------------------------------------------------------
    async def rpc_object_location_add(self, payload, conn):
        # (oid, node_id[, incarnation]) — a fenced add can never
        # resurrect a freed/re-owned copy from a zombie raylet.
        oid, node_bytes = payload[0], payload[1]
        inc = payload[2] if len(payload) > 2 else None
        self._check_fence("object_location_add", node_bytes, inc)
        self.object_locations[oid].add(NodeID(node_bytes))
        self.sealed_ever.add(bytes(oid))
        self.publish(f"obj:{oid.hex() if isinstance(oid, ObjectID) else bytes(oid).hex()}", True)
        return True

    async def rpc_object_location_remove(self, payload, conn):
        oid, node_bytes = payload[0], payload[1]
        inc = payload[2] if len(payload) > 2 else None
        self._check_fence("object_location_remove", node_bytes, inc)
        locs = self.object_locations.get(oid)
        if locs:
            locs.discard(NodeID(node_bytes))
            if not locs:
                self.object_locations.pop(oid, None)
        return True

    async def rpc_object_locations_get(self, payload, conn):
        """rpc-contract: read-only — location lookup, safe to retry."""
        oid = payload
        locs = self.object_locations.get(oid, set())
        out = []
        for n in locs:
            info = self.nodes.get(n)
            # DRAINING / SUSPECT / QUARANTINED nodes still serve reads:
            # their copies are valid while the raylet is up, and drain-
            # time re-replication pulls FROM them.
            if info and info.state in _LIVE_STATES:
                out.append({"node_id": n.binary(), "raylet_address": info.raylet_address})
        return out

    async def rpc_object_free(self, payload, conn):
        """Owner released all refs: delete everywhere.  Inline objects are
        not in the directory, so the free is broadcast to every node.

        The id stays in sealed_ever: a freed object must read as LOST
        (not never-sealed) so a dependent task resubmitted by lineage
        reconstruction can recover the freed arg via its own lineage
        instead of waiting forever for a seal that won't come.  Per-job
        GC reclaims the entries at job end."""
        oids = payload
        for oid in oids:
            self.object_locations.pop(oid, None)
        for client in self.node_clients.values():
            try:
                await client.push("store_free", oids)
            except Exception:
                pass
        return True

    async def rpc_object_lost_check(self, payload, conn):
        """True iff the object was sealed at some point but no live node
        holds a copy now — i.e. it needs lineage reconstruction."""
        oid = bytes(payload)
        if oid not in self.sealed_ever:
            return False
        locs = self.object_locations.get(oid) or ()
        return not any(
            (info := self.nodes.get(n)) is not None
            and info.state in _LIVE_STATES
            for n in locs
        )

    async def rpc_objects_resubmitted(self, payload, conn):
        """Owner is resubmitting the creating task for these objects:
        clear their lost state and purge any stale copies (incl. sealed
        error placeholders) so re-execution can seal fresh values."""
        oids = [bytes(o) for o in payload]
        for oid in oids:
            self.sealed_ever.discard(oid)
            self.object_locations.pop(oid, None)
        for client in self.node_clients.values():
            try:
                await client.push("store_free", oids)
            except Exception:
                pass
        return True

    async def push_free_objects(self, payload, conn):
        await self.rpc_object_free(payload, conn)

    # ------------------------------------------------------------------
    # actor manager (reference: gcs_actor_manager.h:308 + scheduler :111)
    # ------------------------------------------------------------------
    async def rpc_register_actor(self, payload, conn):
        spec: TaskSpec = payload["spec"]
        # Tenant backpressure: an over-quota tenant's actors PARK (the
        # quota queue) — but only up to tenant_max_parked of them.
        # Beyond that the registration fails fast with a typed error
        # instead of queueing unboundedly.
        tenant, _prio = self._job_tenant_priority(spec.job_id)
        if (
            CONFIG.tenant_quota_enforcement
            and spec.scheduling_strategy.kind != "PLACEMENT_GROUP"
            and self._tenant_over_quota(tenant, dict(spec.resources))
        ):
            parked = sum(
                1
                for aid in self._quota_parked
                if aid in self.actors
                and self._job_tenant_priority(aid.job_id())[0] == tenant
            )
            if parked >= int(CONFIG.tenant_max_parked):
                from ray_tpu_torch import exceptions

                raise exceptions.QuotaExceededError(
                    f"tenant {tenant!r} is over quota with "
                    f"{parked} admission(s) already parked "
                    f"(tenant_max_parked={CONFIG.tenant_max_parked})"
                )
        info = ActorInfo(
            actor_id=spec.actor_id,
            name=spec.actor_name,
            namespace=spec.namespace or "default",
            class_name=spec.name,
            max_restarts=spec.max_restarts,
            creation_spec=spec,
            detached=spec.detached,
        )
        if info.name:
            key = (info.namespace, info.name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing and existing.state != "DEAD":
                    raise ValueError(f"Actor name '{info.name}' already taken in namespace '{info.namespace}'")
            self.named_actors[key] = info.actor_id
        self.actors[info.actor_id] = info
        self.loop.create_task(self._schedule_actor(info))
        return True

    def _pick_node(self, resources: ResourceSet, strategy=None) -> Optional[NodeID]:
        """Actor/bundle placement: hybrid pack-then-spread over the GCS
        resource view (reference: hybrid_scheduling_policy.cc)."""
        if strategy is not None and strategy.kind == "NODE_AFFINITY":
            info = self.nodes.get(strategy.node_id)
            if info and info.state == "ALIVE" and resources.fits_in(self.available.get(strategy.node_id, ResourceSet())):
                return strategy.node_id
            if strategy is not None and not strategy.soft:
                return None
        required_labels = (
            strategy.labels if strategy is not None and strategy.kind == "NODE_LABEL" else None
        )
        candidates = []
        for node_id, info in self.nodes.items():
            if info.state != "ALIVE":
                continue
            if required_labels and any(
                info.labels.get(k) != v for k, v in required_labels.items()
            ):
                continue
            avail = self.available.get(node_id, ResourceSet())
            if resources.fits_in(avail):
                total = sum(info.resources_total.values()) or 1.0
                util = 1.0 - sum(avail.values()) / total
                candidates.append((util, node_id.binary(), node_id))
        if not candidates:
            return None
        # Pack: prefer the most utilized node that still fits.
        candidates.sort(reverse=True)
        return candidates[0][2]

    def _park_pending(self, info: ActorInfo):
        """Park an actor between homes (resource- or quota-starved): it
        waits in pending_actors for the next _kick_pending.  Clearing the
        placement keeps a dead node's sweep (or a stale death report)
        from failing it while it waits."""
        info.node_id = None
        info.raylet_address = None
        if info.actor_id not in self.pending_actors:
            self.pending_actors.append(info.actor_id)
        self._pending_since.setdefault(info.actor_id, time.monotonic())

    def _unpark_pending(self, info: ActorInfo):
        self._pending_since.pop(info.actor_id, None)
        self._quota_parked.pop(info.actor_id, None)

    async def _schedule_actor(self, info: ActorInfo, usage: Optional[dict] = None):
        spec = info.creation_spec
        strategy = spec.scheduling_strategy
        resources = spec.resources
        tenant, _prio = self._job_tenant_priority(info.actor_id.job_id())
        # Quota admission (non-PG actors only: a PG-scheduled actor's
        # resources were already charged to the tenant at bundle
        # reservation — gating it again would double-count).  Over-quota
        # actors PARK with backpressure; usage falling below quota (or a
        # raised quota) re-schedules them via _kick_pending, which
        # aggregates usage once per kick and passes it in.
        if (
            strategy.kind != "PLACEMENT_GROUP"
            and self._tenant_over_quota(tenant, dict(resources), usage=usage)
        ):
            if info.actor_id not in self._quota_parked:
                self._quota_parked[info.actor_id] = time.monotonic()
                telemetry.count_tenant_parked(
                    tenants_mod.tenant_label(tenant, self.tenants), "quota"
                )
                logger.info(
                    "actor %s parked: tenant %r over quota",
                    info.actor_id.hex()[:8], tenant,
                )
            self._park_pending(info)
            return
        self._quota_parked.pop(info.actor_id, None)
        if strategy.kind == "PLACEMENT_GROUP" and strategy.placement_group_id is not None:
            pg = self.placement_groups.get(strategy.placement_group_id)
            if pg is None:
                await self._fail_actor(info, "placement group removed before actor creation")
                return
            # Wait for PG creation — event-driven, not a poll:
            # _schedule_pg/_remove_pg signal state changes.
            deadline = time.monotonic() + 60
            while pg.state != "CREATED":
                if pg.state == "REMOVED":
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                ev = self._pg_event(pg.pg_id)
                try:
                    await asyncio.wait_for(ev.wait(), timeout=min(remaining, 10))
                except asyncio.TimeoutError:
                    pass
            idx = strategy.bundle_index
            node_id = pg.bundles[idx if idx >= 0 else 0].node_id
            if node_id is None or self.nodes.get(node_id, None) is None or self.nodes[node_id].state != "ALIVE":
                await self._fail_actor(info, "placement group bundle node unavailable")
                return
        else:
            node_id = self._pick_node(resources, strategy)
        if node_id is None:
            # No node fits now — queue and retry when resources change.
            self._park_pending(info)
            return
        client = self.node_clients.get(node_id)
        if client is None:
            await self._fail_actor(info, "chosen node vanished")
            return
        info.node_id = node_id
        info.raylet_address = self.nodes[node_id].raylet_address
        info.state = "PENDING_CREATION"
        # Optimistically deduct from the GCS view so concurrent scheduling
        # decisions don't over-commit one node; the next resource report
        # replaces the view with the raylet's ground truth.  The tenant
        # admission ledger gets the same optimistic entry so a burst of
        # admissions can't all pass the quota check against stale usage.
        avail = self.available.get(node_id)
        if avail is not None and spec.scheduling_strategy.kind != "PLACEMENT_GROUP":
            avail.subtract(resources)
        if spec.scheduling_strategy.kind != "PLACEMENT_GROUP":
            self._note_admission(tenant, resources)
            if usage is not None:
                # The kick batch shares this snapshot: later actors in
                # the same batch must see this admission or a burst of
                # one tenant's parked actors would all pass the quota
                # check against the pre-batch usage.
                tenants_mod.add_usage(usage, tenant, dict(resources))
        try:
            # Unbounded: actor __init__ may legitimately take a long time;
            # worker death is reported separately.
            result = await client.call(
                "create_actor", {"spec": spec, "tenant": tenant}, timeout=None
            )
            info.pid = result.get("pid", 0)
            info.worker_address = result.get("worker_address")
            info.state = "ALIVE"
            self._unpark_pending(info)
            self.publish("actors", self._actor_dict(info))
            self.publish(f"actor:{info.actor_id.hex()}", self._actor_dict(info))
        except Exception as e:  # creation failed
            msg = str(e)
            transient = (
                "insufficient resources" in msg
                or "bundle cannot host" in msg
                or "spawn gate saturated" in msg
                or "draining" in msg  # raced a drain notice: place elsewhere
            )
            if "failed to start" in msg:
                # a start timeout under machine load is transient: retry
                # a few times before declaring the actor dead
                info.creation_attempts = getattr(info, "creation_attempts", 0) + 1
                transient = transient or info.creation_attempts <= 3
            if transient:
                # The GCS view was stale (resources not yet freed on the
                # node).  Queue and retry when the view refreshes — the
                # reference never fails an actor for transient resource
                # shortage (gcs_actor_scheduler retries leases).
                self._park_pending(info)
                self.loop.call_later(0.2, self._kick_pending)
                return
            await self._on_actor_failure(info, f"creation failed: {e}")

    def _kick_pending(self):
        pending, self.pending_actors = self.pending_actors, []
        # Fair-share scheduling order across tenants: ascending DRF
        # dominant share first (weighted), then priority class within,
        # then FIFO.  The tenant with the least of its fair share gets
        # the freed resources — this is what makes shares converge
        # cluster-wide instead of first-come-first-served.  Usage is
        # aggregated ONCE here and passed down: _kick_pending fires on
        # every resource report while actors are pending, and each
        # _schedule_actor re-walking every node report would be
        # O(actors x nodes) per tick.
        usage = self._aggregate_tenant_usage() if pending else None
        if len(pending) > 1:
            totals = self._cluster_totals()
            order = {aid: i for i, aid in enumerate(pending)}

            def fair_key(actor_id):
                tenant, priority = self._job_tenant_priority(actor_id.job_id())
                spec = self.tenants.get(tenant)
                return (
                    tenants_mod.dominant_share(
                        usage.get(tenant), totals, spec.weight if spec else 1.0
                    ),
                    -priority,
                    order[actor_id],
                )

            pending.sort(key=fair_key)
        for actor_id in pending:
            info = self.actors.get(actor_id)
            if info and info.state in ("PENDING_CREATION", "RESTARTING"):
                self.loop.create_task(self._schedule_actor(info, usage=usage))
        for pg in self.placement_groups.values():
            if pg.state == "PENDING" and getattr(pg, "_queued", False):
                pg._queued = False
                self.loop.create_task(self._schedule_pg(pg))

    def _actor_dict(self, info: ActorInfo) -> dict:
        return {
            "actor_id": info.actor_id.binary(),
            "state": info.state,
            "node_id": info.node_id.binary() if info.node_id else None,
            "raylet_address": info.raylet_address,
            "name": info.name,
            "namespace": info.namespace,
            "class_name": info.class_name,
            "num_restarts": info.num_restarts,
            "death_cause": info.death_cause,
            "pid": info.pid,
            "worker_address": info.worker_address,
            # Tenant attribution for per-actor profiling/metrics views
            # (merged cluster flamegraphs key on actor:<tenant>/<name>).
            "tenant": self._job_tenant_priority(info.actor_id.job_id())[0],
            "max_task_retries": (
                info.creation_spec.max_task_retries if info.creation_spec else 0
            ),
        }

    async def _on_actor_failure(self, info: ActorInfo, reason: str):
        if info.state == "DEAD":
            return
        restarts_left = info.max_restarts == -1 or info.num_restarts < info.max_restarts
        if restarts_left:
            info.num_restarts += 1
            info.state = "RESTARTING"
            self.publish("actors", self._actor_dict(info))
            self.publish(f"actor:{info.actor_id.hex()}", self._actor_dict(info))
            await self._schedule_actor(info)
        else:
            await self._fail_actor(info, reason)

    async def _fail_actor(self, info: ActorInfo, reason: str):
        info.state = "DEAD"
        info.death_cause = reason
        self._unpark_pending(info)
        self.publish("actors", self._actor_dict(info))
        self.publish(f"actor:{info.actor_id.hex()}", self._actor_dict(info))

    async def _kill_actor(self, info: ActorInfo, reason: str, no_restart: bool):
        if info.state == "DEAD":
            return
        if info.node_id is not None:
            client = self.node_clients.get(info.node_id)
            if client:
                try:
                    await client.push("kill_actor", {"actor_id": info.actor_id.binary()})
                except Exception:
                    pass
        if no_restart:
            await self._fail_actor(info, reason)
        else:
            await self._on_actor_failure(info, reason)

    async def rpc_actor_death_report(self, payload, conn):
        """Raylet reports an actor's worker exited."""
        self._check_fence(
            "actor_death_report", payload.get("node_id"), payload.get("incarnation")
        )
        actor_id = ActorID(payload["actor_id"])
        info = self.actors.get(actor_id)
        if info is None:
            return False
        reporter = conn.meta.get("node_id")
        if (
            reporter is not None
            and info.node_id is not None
            and reporter != info.node_id
        ):
            # Stale report from a node the actor already left (drain-time
            # migration kills the old worker AFTER rescheduling): the old
            # host's death report must not restart the actor again at its
            # new home.
            return False
        if info.state == "RESTARTING" and info.node_id is None:
            # Parked between homes (no worker exists anywhere): any death
            # report is from the previous host and must not double-charge
            # num_restarts or fail the actor outright.
            return False
        if payload.get("intended"):
            await self._fail_actor(info, payload.get("reason", "ray.kill / __ray_terminate__"))
        else:
            await self._on_actor_failure(info, payload.get("reason", "worker died"))
        return True

    async def rpc_kill_actor(self, payload, conn):
        actor_id = ActorID(payload["actor_id"])
        info = self.actors.get(actor_id)
        if info is None:
            raise ValueError(f"no such actor {actor_id}")
        await self._kill_actor(info, "ray.kill", no_restart=payload.get("no_restart", True))
        return True

    async def rpc_get_actor_info(self, payload, conn):
        actor_id = ActorID(payload)
        info = self.actors.get(actor_id)
        return self._actor_dict(info) if info else None

    async def rpc_get_named_actor(self, payload, conn):
        ns, name = payload
        actor_id = self.named_actors.get((ns, name))
        if actor_id is None:
            return None
        info = self.actors.get(actor_id)
        if info is None or info.state == "DEAD":
            return None
        return {"actor_id": actor_id.binary(), "spec": info.creation_spec, "info": self._actor_dict(info)}

    async def rpc_list_named_actors(self, payload, conn):
        """rpc-contract: read-only — registry scan, safe to retry."""
        all_namespaces, ns_filter = payload
        out = []
        for (ns, name), aid in self.named_actors.items():
            if not all_namespaces and ns != ns_filter:
                continue
            info = self.actors.get(aid)
            if info and info.state != "DEAD":
                out.append({"namespace": ns, "name": name})
        return out

    async def rpc_list_actors(self, payload, conn):
        return [self._actor_dict(i) for i in self.actors.values()]

    # ------------------------------------------------------------------
    # placement groups (reference: gcs_placement_group_manager.h:228,
    # two-phase commit in gcs_placement_group_scheduler.h:283)
    # ------------------------------------------------------------------
    async def rpc_create_placement_group(self, payload, conn):
        pg = PlacementGroupInfo(
            pg_id=PlacementGroupID(payload["pg_id"]),
            name=payload.get("name"),
            strategy=payload["strategy"],
            bundles=[Bundle(resources=ResourceSet.of(b)) for b in payload["bundles"]],
            creator_job=conn.meta.get("job_id"),
        )
        self.placement_groups[pg.pg_id] = pg
        if pg.name:
            self.named_pgs[pg.name] = pg.pg_id
        # Scheduling runs in the background: a slow/retrying 2-phase
        # commit (node churn, dropped RPCs) must not stall the creating
        # client's call — it polls the state via get_placement_group
        # (reference: gcs_placement_group_manager.h async creation).
        self.loop.create_task(self._schedule_pg(pg))
        return {"pg_id": pg.pg_id.binary(), "state": pg.state}

    def _pg_node_assignment(self, pg: PlacementGroupInfo) -> Optional[List[NodeID]]:
        """Pick a node per bundle honoring the strategy, against a copy of
        the availability view (reference: bundle_scheduling_policy.cc)."""
        avail = {n: rs.copy() for n, rs in self.available.items() if self.nodes[n].state == "ALIVE"}
        nodes_sorted = sorted(avail, key=lambda n: -sum(avail[n].values()))
        assignment: List[Optional[NodeID]] = []

        def fits(n, rs):
            return rs.fits_in(avail[n])

        if pg.strategy in ("PACK", "STRICT_PACK"):
            for b in pg.bundles:
                placed = None
                preferred = assignment[-1] if assignment else None
                order = ([preferred] if preferred else []) + [n for n in nodes_sorted if n != preferred]
                for n in order:
                    if n is not None and fits(n, b.resources):
                        placed = n
                        break
                if placed is None:
                    return None
                if pg.strategy == "STRICT_PACK" and assignment and placed != assignment[0]:
                    return None
                avail[placed].subtract(b.resources)
                assignment.append(placed)
        else:  # SPREAD | STRICT_SPREAD
            used: Set[NodeID] = set()
            for b in pg.bundles:
                placed = None
                fresh = [n for n in nodes_sorted if n not in used]
                order = fresh + ([n for n in nodes_sorted if n in used] if pg.strategy == "SPREAD" else [])
                for n in order:
                    if fits(n, b.resources):
                        placed = n
                        break
                if placed is None:
                    return None
                avail[placed].subtract(b.resources)
                used.add(placed)
                assignment.append(placed)
        return assignment

    async def _schedule_pg(self, pg: PlacementGroupInfo):
        if pg.state == "REMOVED":
            return  # removed while queued
        # Quota admission: the whole group's reservation charges its
        # creator's tenant.  Over quota -> the PG parks PENDING (the
        # creating client polls/waits; placement_group.wait is the
        # backpressure surface) and retries via _kick_pending when usage
        # falls or the quota rises.
        tenant, _prio = self._job_tenant_priority(pg.creator_job)
        pg_total: Dict[str, float] = {}
        for b in pg.bundles:
            for k, v in b.resources.items():
                pg_total[k] = pg_total.get(k, 0.0) + v
        if self._tenant_over_quota(tenant, pg_total):
            if not getattr(pg, "_quota_parked", False):
                pg._quota_parked = True
                telemetry.count_tenant_parked(
                    tenants_mod.tenant_label(tenant, self.tenants), "quota"
                )
                logger.info(
                    "PG %s parked: tenant %r over quota",
                    pg.pg_id.hex()[:8], tenant,
                )
            pg._queued = True  # retried by _kick_pending
            return
        pg._quota_parked = False
        assignment = self._pg_node_assignment(pg)
        if assignment is None:
            pg._queued = True  # retried by _kick_pending
            return
        # Phase 1: prepare (reserve) on every node; all-or-nothing.
        prepared: List[Tuple[NodeID, int]] = []
        ok = True
        for idx, node_id in enumerate(assignment):
            client = self.node_clients.get(node_id)
            if client is None:
                ok = False
                break
            try:
                res = await client.call(
                    "prepare_bundle",
                    {"pg_id": pg.pg_id.binary(), "bundle_index": idx,
                     "resources": dict(pg.bundles[idx].resources),
                     "tenant": tenant},
                )
                if not res:
                    ok = False
                    break
                prepared.append((node_id, idx))
            except Exception:
                ok = False
                break
        if not ok or pg.state == "REMOVED":
            await self._rollback_bundles(pg, prepared)
            if pg.state != "REMOVED":
                pg._queued = True
            return
        self._note_admission(tenant, ResourceSet.of(pg_total))
        # Phase 2: commit.  A failed/lost commit (node died, reply dropped)
        # must not leave the PG wedged in PENDING: roll every bundle back
        # and requeue the whole group (commit_bundle and return_bundle are
        # both idempotent on the raylet side).
        try:
            for (node_id, idx) in prepared:
                client = self.node_clients.get(node_id)
                if client is None:
                    raise rpc.RpcError(f"node {node_id.hex()[:8]} vanished before commit")
                await client.call(
                    "commit_bundle", {"pg_id": pg.pg_id.binary(), "bundle_index": idx}
                )
                pg.bundles[idx].node_id = node_id
        except Exception:
            logger.exception("PG %s commit failed; rolling back", pg.pg_id.hex()[:8])
            await self._rollback_bundles(pg, prepared)
            if pg.state != "REMOVED":
                pg._queued = True
                self.loop.call_later(0.5, self._kick_pending)
            return
        if pg.state == "REMOVED":
            # remove_placement_group raced the commit (creation runs in
            # the background since it stopped blocking the create call):
            # the group must not resurrect, and every committed bundle
            # must go back to its node.
            await self._rollback_bundles(pg, prepared)
            return
        pg.state = "CREATED"
        self._signal_pg(pg.pg_id)
        self.publish("placement_groups", {"pg_id": pg.pg_id.binary(), "state": "CREATED"})
        self.publish(f"pg:{pg.pg_id.hex()}", {"state": "CREATED"})

    async def _reschedule_pg_bundles(self, pg: PlacementGroupInfo,
                                     from_node: NodeID):
        """Drain-ahead partial reschedule: move ONLY the bundles sitting
        on `from_node` to live nodes, two-phase, while unaffected bundles
        (and the actors running in them) stay put.  On any failure the
        group returns to CREATED with its old placement — the reactive
        whole-group reschedule at node death remains the fallback."""
        if pg.state != "CREATED":
            return
        affected = [i for i, b in enumerate(pg.bundles) if b.node_id == from_node]
        if not affected:
            return
        pg.state = "RESCHEDULING"
        avail = {
            n: rs.copy()
            for n, rs in self.available.items()
            if self.nodes[n].state == "ALIVE"
        }
        used = {
            b.node_id for b in pg.bundles
            if b.node_id is not None and b.node_id != from_node
        }
        prepared: List[Tuple[NodeID, int]] = []
        ok = True
        pack_node: Optional[NodeID] = None  # STRICT_PACK co-location target
        for idx in affected:
            res = pg.bundles[idx].resources
            cands = sorted(avail, key=lambda n: -sum(avail[n].values()))
            if pg.strategy == "STRICT_SPREAD":
                cands = [n for n in cands if n not in used]
            elif pg.strategy == "STRICT_PACK":
                # All bundles of a STRICT_PACK group are co-located (so a
                # drain affects all of them): every move must land on ONE
                # node or the co-location contract silently breaks.  No
                # single node fits -> fail into the reactive fallback,
                # which re-places the whole group strategy-aware.
                cands = [pack_node] if pack_node is not None else cands
            placed = None
            for n in cands:
                if not res.fits_in(avail[n]):
                    continue
                client = self.node_clients.get(n)
                if client is None:
                    continue
                try:
                    r = await client.call(
                        "prepare_bundle",
                        {"pg_id": pg.pg_id.binary(), "bundle_index": idx,
                         "resources": dict(res),
                         "tenant": self._job_tenant_priority(pg.creator_job)[0]},
                    )
                except Exception:
                    continue
                if r:
                    placed = n
                    prepared.append((n, idx))
                    avail[n].subtract(res)
                    used.add(n)
                    if pg.strategy == "STRICT_PACK":
                        pack_node = n
                    break
            if placed is None:
                ok = False
                break
        if not ok or pg.state == "REMOVED":
            # Return the new reservations, KEEP the old placement (the
            # affected bundles still sit on the draining node until its
            # death triggers the reactive path).
            for n, idx in prepared:
                client = self.node_clients.get(n)
                if client:
                    try:
                        await client.call(
                            "return_bundle",
                            {"pg_id": pg.pg_id.binary(), "bundle_index": idx},
                        )
                    except Exception:
                        pass
            if pg.state != "REMOVED":
                pg.state = "CREATED"
                logger.info(
                    "PG %s drain-ahead reschedule found no placement; "
                    "falling back to reschedule at node death",
                    pg.pg_id.hex()[:8],
                )
                self._reschedule_if_node_dead(pg, from_node)
            return
        # Commit the moves; free the doomed reservations best-effort (the
        # draining raylet still accepts return_bundle).
        old_client = self.node_clients.get(from_node)
        committed: set = set()
        for n, idx in prepared:
            client = self.node_clients.get(n)
            try:
                if client is None:
                    raise rpc.RpcError(f"node {n.hex()[:8]} vanished before commit")
                await client.call(
                    "commit_bundle",
                    {"pg_id": pg.pg_id.binary(), "bundle_index": idx},
                )
            except Exception:
                # Same posture as the prepare failure: return the not-yet-
                # committed reservations — INCLUDING the one whose commit
                # just failed (return_bundle is idempotent; if the commit
                # actually applied and only the reply was lost, this frees
                # it rather than leaking a reservation forever) — keep
                # what already moved, and let node death redo the rest
                # reactively.
                logger.exception(
                    "PG %s drain-ahead commit failed; deferring to the "
                    "reactive path", pg.pg_id.hex()[:8],
                )
                for n2, idx2 in prepared:
                    if idx2 in committed:
                        continue
                    c2 = self.node_clients.get(n2)
                    if c2:
                        try:
                            await c2.call(
                                "return_bundle",
                                {"pg_id": pg.pg_id.binary(), "bundle_index": idx2},
                            )
                        except Exception:
                            pass
                if pg.state != "REMOVED":
                    pg.state = "CREATED"
                    self._reschedule_if_node_dead(pg, from_node)
                return
            committed.add(idx)
            pg.bundles[idx].node_id = n
            if old_client is not None:
                try:
                    await old_client.call(
                        "return_bundle",
                        {"pg_id": pg.pg_id.binary(), "bundle_index": idx},
                    )
                except Exception:
                    pass
        if pg.state == "REMOVED":
            await self._rollback_bundles(pg, prepared)
            return
        pg.state = "CREATED"
        self._signal_pg(pg.pg_id)
        self.publish("placement_groups", {"pg_id": pg.pg_id.binary(), "state": "CREATED"})
        self.publish(f"pg:{pg.pg_id.hex()}", {"state": "CREATED"})
        logger.info(
            "PG %s: %d bundle(s) moved off draining node %s pre-kill",
            pg.pg_id.hex()[:8], len(prepared), from_node.hex()[:8],
        )

    def _reschedule_if_node_dead(self, pg: PlacementGroupInfo, node_id: NodeID):
        """Drain-ahead fallback closing a race: the draining node died
        WHILE the partial move was in flight.  _mark_node_dead's reactive
        sweep only matches CREATED groups, so a group restored to CREATED
        here with bundles still on the now-dead node would be wedged
        forever — re-trigger the full reschedule ourselves."""
        info = self.nodes.get(node_id)
        if (info is None or info.state == "DEAD") and any(
            b.node_id == node_id for b in pg.bundles
        ):
            logger.info(
                "PG %s: draining node %s died mid-move; rescheduling "
                "reactively", pg.pg_id.hex()[:8], node_id.hex()[:8],
            )
            pg.state = "RESCHEDULING"
            self.loop.create_task(self._schedule_pg(pg))

    def _pg_event(self, pg_id: PlacementGroupID) -> asyncio.Event:
        return self._pg_events.setdefault(pg_id, asyncio.Event())

    def _signal_pg(self, pg_id: PlacementGroupID):
        ev = self._pg_events.get(pg_id)
        if ev is not None:
            ev.set()
            # Re-arm for the next transition (waiters re-check state).
            self._pg_events[pg_id] = asyncio.Event()

    async def _rollback_bundles(self, pg: PlacementGroupInfo, prepared):
        for node_id, idx in prepared:
            client = self.node_clients.get(node_id)
            if client:
                try:
                    await client.call(
                        "return_bundle",
                        {"pg_id": pg.pg_id.binary(), "bundle_index": idx},
                    )
                except Exception:
                    pass
            pg.bundles[idx].node_id = None

    async def _remove_pg(self, pg: PlacementGroupInfo):
        pg.state = "REMOVED"
        self._signal_pg(pg.pg_id)
        self._pg_events.pop(pg.pg_id, None)
        for idx, b in enumerate(pg.bundles):
            if b.node_id is not None:
                client = self.node_clients.get(b.node_id)
                if client:
                    try:
                        await client.call("return_bundle", {"pg_id": pg.pg_id.binary(), "bundle_index": idx})
                    except Exception:
                        pass
                b.node_id = None
        if pg.name:
            self.named_pgs.pop(pg.name, None)
        self.publish("placement_groups", {"pg_id": pg.pg_id.binary(), "state": "REMOVED"})
        self.publish(f"pg:{pg.pg_id.hex()}", {"state": "REMOVED"})

    async def rpc_remove_placement_group(self, payload, conn):
        pg = self.placement_groups.get(PlacementGroupID(payload))
        if pg is None:
            return False
        # Kill actors scheduled into this PG.
        for actor in list(self.actors.values()):
            strat = actor.creation_spec.scheduling_strategy if actor.creation_spec else None
            if (
                strat is not None
                and strat.kind == "PLACEMENT_GROUP"
                and strat.placement_group_id == pg.pg_id
                and actor.state != "DEAD"
            ):
                await self._kill_actor(actor, "placement group removed", no_restart=True)
        await self._remove_pg(pg)
        return True

    async def rpc_get_placement_group(self, payload, conn):
        pg_id = PlacementGroupID(payload)
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return None
        return {
            "pg_id": pg.pg_id.binary(),
            "name": pg.name,
            "strategy": pg.strategy,
            "state": pg.state,
            "bundles": [
                {"resources": dict(b.resources), "node_id": b.node_id.binary() if b.node_id else None}
                for b in pg.bundles
            ],
        }

    async def rpc_list_placement_groups(self, payload, conn):
        return [await self.rpc_get_placement_group(pg_id.binary(), conn) for pg_id in self.placement_groups]

    # ------------------------------------------------------------------
    # cluster resources API
    # ------------------------------------------------------------------
    async def rpc_cluster_resources(self, payload, conn):
        total: Dict[str, float] = {}
        for info in self.nodes.values():
            if info.state == "ALIVE":
                for k, v in info.resources_total.items():
                    total[k] = total.get(k, 0.0) + v
        return total

    async def rpc_available_resources(self, payload, conn):
        total: Dict[str, float] = {}
        for node_id, avail in self.available.items():
            info = self.nodes.get(node_id)
            if info and info.state == "ALIVE":
                for k, v in avail.items():
                    total[k] = total.get(k, 0.0) + v
        return total

    async def rpc_get_load_metrics(self, payload, conn):
        """Aggregate demand/usage view for the autoscaler (reference:
        gcs_autoscaler_state_manager.h:30 GetClusterResourceState)."""
        demands = []
        for shapes in self.pending_shapes.values():
            demands.extend(shapes)
        for actor_id in self.pending_actors:
            info = self.actors.get(actor_id)
            if info is not None and info.creation_spec is not None:
                demands.append(dict(info.creation_spec.resources))
        for pg in self.placement_groups.values():
            if pg.state in ("PENDING", "RESCHEDULING"):
                demands.extend(dict(b.resources) for b in pg.bundles)
        nodes = {}
        for node_id, info in self.nodes.items():
            # DRAINING/SUSPECT/QUARANTINED nodes stay visible (state-
            # tagged) so the autoscaler can poll drain progress before
            # terminating; consumers must not count them as free capacity.
            if info.state not in _LIVE_STATES:
                continue
            nodes[node_id.hex()] = {
                "total": dict(info.resources_total),
                "available": dict(self.available.get(node_id, ResourceSet())),
                "is_head": info.is_head,
                "raylet_address": info.raylet_address,
                "state": info.state,
                "drain_complete": info.drain_complete,
            }
        # Expire stale lost-capacity records: the consumed-once set lives
        # in the autoscaler process, so without a TTL an autoscaler
        # restart would replay every retained entry as a fresh launch.
        ttl = float(CONFIG.lost_capacity_ttl_s)
        now = time.time()
        while self.lost_capacity and now - self.lost_capacity[0]["time"] > ttl:
            self.lost_capacity.popleft()
        hint_ttl = float(CONFIG.grow_hint_ttl_s)
        for name in [
            n for n, h in self.grow_hints.items()
            if now - h["time"] > hint_ttl
        ]:
            del self.grow_hints[name]
        return {
            "pending_demands": demands,
            "nodes": nodes,
            "lost_capacity": list(self.lost_capacity),
            "grow_hints": list(self.grow_hints.values()),
        }

    async def rpc_train_grow_hint(self, payload, conn):
        """Publish/refresh (count > 0) or clear (count == 0) an elastic
        trainer's pending grow intent.  The autoscaler folds live hints
        into its demand view so replacement capacity is already booting
        when the trainer's epoch-boundary try_grow runs."""
        name = str(payload.get("name") or "")
        if not name:
            return False
        count = max(0, int(payload.get("count") or 0))
        if count == 0:
            self.grow_hints.pop(name, None)
            return True
        self.grow_hints[name] = {
            "name": name,
            "count": count,
            "resources": dict(payload.get("resources") or {}),
            "time": time.time(),
        }
        return True

    # ------------------------------------------------------------------
    # observability (reference: gcs_task_manager.h:86, metric export
    # pipeline SURVEY.md §5)
    # ------------------------------------------------------------------
    async def rpc_task_event_report(self, payload, conn):
        """Batched task events from a worker's event buffer (reference:
        core_worker/task_event_buffer.h)."""
        self._check_fence(
            "task_event_report", payload.get("node_id"), payload.get("incarnation")
        )
        for e in payload.get("events", ()):
            self.task_events.append(e)
        return True

    async def rpc_list_task_events(self, payload, conn):
        limit = (payload or {}).get("limit", 10000)
        events = list(self.task_events)
        return events[-limit:]

    async def rpc_metrics_report(self, payload, conn):
        self._check_fence(
            "metrics_report", payload.get("node_id"), payload.get("incarnation")
        )
        self.metrics[payload.get("worker_id", b"")] = payload.get("metrics", [])
        nid = payload.get("node_id")
        if nid is not None:
            self._note_channel_health(
                NodeID(bytes(nid)),
                payload.get("worker_id", b""),
                payload.get("metrics", []),
            )
        return True

    def _note_channel_health(self, node_id: NodeID, worker_id: bytes, metrics):
        """Snoop channel blocked-seconds / failed-reattach totals out of
        a node's worker metric snapshots — the dataplane's contribution
        to that node's gray-failure suspicion score.

        Only cross-host socket channels count their blocked time: a
        same-host shm ring has no link to be slow, and its blocked time
        is its peer's compute (a pipeline's stages wait on each other by
        design), so counting it flapped a busy pipeline's node SUSPECT
        and, held, quarantined the node under its own placement group."""
        if node_id not in self.nodes:
            return
        blocked = refail = 0.0
        seen = False
        for rec in metrics:
            name = rec.get("name")
            if name == "channel_blocked_seconds_total":
                if rec.get("tags", {}).get("transport") == "socket":
                    blocked += float(rec.get("value", 0.0))
                    seen = True
            elif (
                name == "channel_reattach_total"
                and rec.get("tags", {}).get("result") == "failed"
            ):
                refail += float(rec.get("value", 0.0))
                seen = True
        if seen:
            self._chan_stats.setdefault(node_id, {})[worker_id] = (blocked, refail)

    def _local_report(self, method: str, payload: dict):
        """In-process report channel for the GCS's own flusher threads.
        Mutations hop onto the event loop: handlers iterate self.spans /
        self.metrics, and a flusher-thread extend mid-iteration would
        raise 'mutated during iteration' inside rpc_list_spans /
        rpc_metrics_get."""

        def apply():
            if method == "metrics_report":
                self.metrics[payload.get("worker_id", b"")] = payload.get("metrics", [])
            elif method == "span_report":
                self.spans.extend(
                    self._report_tenant(payload), payload.get("spans", ())
                )
            elif method == "profile_report":
                rec = payload.get("profile")
                if rec:
                    self.profiles.append(self._report_tenant(payload), rec)

        self.loop.call_soon_threadsafe(apply)

    def _report_tenant(self, payload) -> str:
        """Clamped tenant label of a span/profile report (registered
        tenants + "default"/"other", so table keys and the eviction
        counter's tag values stay bounded)."""
        return tenants_mod.tenant_label((payload or {}).get("tenant"), self.tenants)

    async def rpc_span_report(self, payload, conn):
        """Batched finished spans from a process's span flusher
        (util/tracing.flush — the off-box half of the flight recorder)."""
        self._check_fence(
            "span_report", payload.get("node_id"), payload.get("incarnation")
        )
        self.spans.extend(self._report_tenant(payload), payload.get("spans", ()))
        return True

    async def rpc_profile_report(self, payload, conn):
        """A finished sampling-profiler capture shipped by the profiled
        process (profiling.py) — recoverable by session_id even after
        the process dies."""
        self._check_fence(
            "profile_report", payload.get("node_id"), payload.get("incarnation")
        )
        rec = payload.get("profile")
        if rec:
            self.profiles.append(self._report_tenant(payload), rec)
        return True

    async def rpc_list_profiles(self, payload, conn):
        sid = (payload or {}).get("session_id")
        out = [p for p in self.profiles if not sid or p.get("session_id") == sid]
        return out

    # Sampling-profiler surface for the GCS process itself (workers and
    # raylets expose the same three methods — util.profiling attaches to
    # any of them).  handle_* never block: start spawns a daemon sampler
    # thread, stop/dump snapshot under a short lock.
    async def rpc_profile_start(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_start(payload)

    async def rpc_profile_stop(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_stop(payload)

    async def rpc_profile_dump(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_dump(payload)

    async def rpc_list_spans(self, payload, conn):
        limit = (payload or {}).get("limit", 100_000)
        n = len(self.spans)
        if limit >= n:
            return list(self.spans)
        # Newest `limit` spans without materializing the whole ring.
        from itertools import islice

        return list(islice(self.spans, n - limit, n))

    async def rpc_chaos_stats(self, payload, conn):
        """This process's chaos-plane view (the dashboard merges raylet
        views from node_stats on top)."""
        from ray_tpu_torch._private.chaos import CHAOS

        return CHAOS.stats()

    async def rpc_metrics_get(self, payload, conn):
        """Aggregate metric records across workers: counters/histograms sum,
        gauges last-write-wins per (name, tags)."""
        merged: Dict[tuple, dict] = {}
        for snapshot in self.metrics.values():
            for m in snapshot:
                key = (m["name"], tuple(sorted((m.get("tags") or {}).items())))
                cur = merged.get(key)
                if cur is None:
                    merged[key] = {k: (list(v) if isinstance(v, list) else v) for k, v in m.items()}
                elif m["type"] == "counter":
                    cur["value"] += m["value"]
                elif m["type"] == "gauge":
                    cur["value"] = m["value"]
                elif m["type"] == "histogram":
                    cur["counts"] = [a + b for a, b in zip(cur["counts"], m["counts"])]
                    cur["sum"] += m["sum"]
                    cur["count"] += m["count"]
        return list(merged.values())
