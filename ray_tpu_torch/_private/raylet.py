"""Raylet — per-node agent: scheduler, worker pool, object manager.

Equivalent of the reference raylet (reference: src/ray/raylet/
node_manager.h:119, worker_pool.h:216, local_task_manager.h:58,
scheduling/cluster_task_manager.h:42) plus the object-manager pull path
(reference: src/ray/object_manager/pull_manager.h:52).  The default task
path is direct submission: submitters lease workers per scheduling key
(rpc_request_worker_lease) and push specs worker-to-worker (direct.py),
matching reference normal_task_submitter.cc:295; raylet-mediated dispatch
remains for non-DEFAULT scheduling strategies and actor creation.

Scheduling is two-level like the reference: a cluster decision (run here
vs. spill to another node, using the GCS-synced availability view) and a
local dispatch loop (match queued tasks to free resources + idle workers).
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import subprocess
import sys
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import retry, rpc, runtime_env as runtime_env_mod, serialization, telemetry
from ray_tpu_torch._private import tenants as tenants_mod
from ray_tpu_torch._private.chaos import CHAOS
from ray_tpu_torch._private.common import ResourceSet, TaskSpec
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, WorkerID
from ray_tpu_torch._private.object_store import ObjectStoreCore
from ray_tpu_torch.exceptions import NodeFencedError

logger = logging.getLogger(__name__)


def _labels_match(required, node_labels) -> bool:
    return all(node_labels.get(k) == v for k, v in (required or {}).items())


class WorkerHandle:
    __slots__ = (
        "worker_id", "pid", "proc", "conn", "job_id", "state", "actor_id",
        "running", "spawn_time", "idle_since", "resources_held", "bundle_key",
        "direct_address", "lease_owner", "lease_blocked", "reserved",
        "env_hash", "log_path", "spawn_token", "tenant", "detached",
    )

    def __init__(self, worker_id: WorkerID, proc, job_id: JobID):
        self.worker_id = worker_id
        self.proc = proc
        self.pid = proc.pid if proc else 0
        self.conn: Optional[rpc.ClientConn] = None
        self.job_id = job_id
        self.state = "STARTING"  # STARTING | IDLE | BUSY | ACTOR | LEASED | DEAD
        self.actor_id: Optional[ActorID] = None
        self.running: Dict[bytes, TaskSpec] = {}  # task_id bytes -> spec
        self.spawn_time = time.monotonic()
        self.idle_since = time.monotonic()
        self.resources_held = ResourceSet()
        # Set for actors placed inside a placement-group bundle: resources
        # must be returned to the bundle, not the node pool.
        self.bundle_key: Optional[Tuple[bytes, int]] = None
        # Direct RPC endpoint of the worker (submitters push tasks here).
        self.direct_address: Optional[str] = None
        # Connection of the submitter holding this worker's lease; leases
        # are swept when the holder disconnects.
        self.lease_owner = None
        self.lease_blocked = False
        # Claimed by an in-progress lease grant (worker still starting):
        # keeps the dispatch loop and other grants off it.
        self.reserved = False
        # Runtime-env identity this worker was spawned with ('' = default);
        # the idle pool is keyed by (job, env_hash) so tasks only reuse
        # workers whose environment matches (reference: worker_pool.h:216
        # keys its pools by runtime_env_hash too).
        self.env_hash = ""
        # Worker stdout/stderr file; tailed by the log monitor and
        # streamed to the job's driver (reference: log_monitor.py).
        self.log_path: Optional[str] = None
        # held host-wide spawn-gate slot fd while STARTING (actors only)
        self.spawn_token: Optional[int] = None
        # Tenant the resources this worker holds are charged to (the
        # job's tenant; leases override with the lease request's).
        self.tenant: str = tenants_mod.DEFAULT_TENANT
        # Detached-actor worker: survives its creating job's teardown.
        self.detached = False


class Raylet:
    def __init__(
        self,
        node_id: NodeID,
        address: str,
        gcs_address: str,
        store_dir: str,
        resources: Dict[str, float],
        labels: Dict[str, str] = None,
        is_head: bool = False,
        session_dir: str = None,
        loop=None,
    ):
        self.node_id = node_id
        self.address = address
        self.gcs_address = gcs_address
        self.loop = loop or asyncio.get_event_loop()
        self.server = rpc.RpcServer(self, address, self.loop)
        self.server.on_disconnect = self._on_disconnect
        self.is_head = is_head
        self.labels = labels or {}
        self.session_dir = session_dir or os.path.dirname(store_dir)
        # Invoked (from the event loop) when the GCS connection is lost —
        # service mains wire this to process shutdown.
        self.on_fatal = None

        self.resources_total = ResourceSet.of(resources)
        self.resources_available = self.resources_total.copy()
        # SPREAD's round-robin position over this node and its peers
        self._spread_next = 0

        cap = int(CONFIG.object_store_memory_cap)
        self.store = ObjectStoreCore(
            store_dir, cap, on_seal=self._on_object_sealed, on_evict=self._on_object_evicted
        )
        # In-flight object_location_add pushes, by object id (see
        # _on_object_sealed for why seal RPCs await these).
        self._seal_reports: Dict[bytes, asyncio.Task] = {}
        # Tail of the per-object location add/remove push chain (ordering
        # guard — see _push_location_ordered).
        self._loc_chain: Dict[bytes, asyncio.Task] = {}

        # Worker pool; idle queues keyed by (job_id, runtime-env hash).
        self.workers: Dict[WorkerID, WorkerHandle] = {}
        self.idle_workers: Dict[Tuple[JobID, str], deque] = defaultdict(deque)
        # env_hash -> (error message, monotonic time): envs whose staging
        # failed recently; tasks requiring them fail fast with
        # RuntimeEnvSetupError instead of spawn-looping.
        self.bad_runtime_envs: Dict[str, Tuple[str, float]] = {}
        # task ids cancelled while running here: worker death for them is
        # final (TaskCancelledError), never a retry.
        self.cancelled_tasks: Set[bytes] = set()
        # FIFO tickets for the actor-creation spawn gate; the event fires
        # whenever a worker leaves STARTING so parked creations wake
        # without busy-polling the worker table.  The slot pool itself is
        # HOST-wide (shared across the session's raylets via flock).
        self._spawn_ticket_next = 0
        self._spawn_ticket_serving = 0
        self._spawn_tickets_abandoned: Set[int] = set()
        self._spawn_gate_event: Optional[asyncio.Event] = None
        from ray_tpu_torch._private.node import RAY_TPU_TORCH_TMP
        from ray_tpu_torch._private.spawn_gate import HostSpawnGate

        self._spawn_gate = HostSpawnGate(
            os.path.join(self.session_dir or RAY_TPU_TORCH_TMP, "spawn_gate"),
            slots=CONFIG.max_concurrent_worker_starts or None,
        )
        # Lease shapes this node couldn't serve or spill (direct-path
        # demand the autoscaler must see); key = shape signature, value =
        # (ResourceSet, last-seen monotonic).  TTL-pruned.
        self._unmet_lease_demand: Dict[tuple, tuple] = {}
        self.actor_workers: Dict[ActorID, WorkerHandle] = {}
        self.job_configs: Dict[JobID, dict] = {}

        # Task queues
        self.queue: deque[TaskSpec] = deque()
        self.infeasible: List[TaskSpec] = []
        self._dispatch_scheduled = False
        # Monotonic stamp backing the dispatch queue's per-tenant FIFO.
        self._dispatch_seq = 0

        # Cluster view (node_id bytes -> {"raylet_address", "available"})
        self.cluster_view: Dict[bytes, dict] = {}
        self.gcs: Optional[rpc.AsyncRpcClient] = None
        self.peer_clients: Dict[str, rpc.AsyncRpcClient] = {}
        # Membership incarnation, stamped by the GCS at registration and
        # carried on every raylet-originated write.  A NodeFencedError
        # reply means the GCS declared this incarnation dead while we
        # were partitioned: tear down and re-register fresh (see
        # _fenced_teardown).
        self.incarnation = 0
        self._fencing_task: Optional[asyncio.Task] = None
        # Raylet-measured GCS health: resource_report round-trip ewma and
        # the current consecutive-failure streak, shipped back to the GCS
        # inside every report as its gray-failure suspicion input (a
        # sustained `slow` link shows up here long before heartbeats die).
        self._gcs_rtt_ms = 0.0
        self._gcs_call_errors = 0

        # Placement group bundles: (pg_id bytes, idx) -> reservation state
        self.bundles: Dict[Tuple[bytes, int], dict] = {}

        # Objects being pulled: oid bytes -> future
        self.pulls: Dict[bytes, asyncio.Future] = {}

        # Parked worker-lease requests (tenants.LeaseWaiter), granted as
        # resources free up in weighted-DRF fair-share order: per tenant
        # only the best (priority, FIFO) waiter is a candidate, tenants
        # are served ascending dominant share, and a tenant over its
        # registered quota is skipped until usage falls (reference: the
        # lease request queue in cluster_task_manager, upgraded from
        # pure FIFO for the multi-tenant job plane).
        self.lease_waiters: deque = deque()
        self._lease_seq = 0
        # Cluster-wide tenant view from the GCS "tenant_usage" publish:
        # per-tenant usage, resource totals, registered tenant specs.
        self.tenant_specs: Dict[str, tenants_mod.TenantSpec] = {}
        self.cluster_tenant_usage: Dict[str, dict] = {}
        self.cluster_resource_totals: Dict[str, float] = {}
        # This node's contribution to the last usage report, replaced by
        # live local truth when computing effective usage (so local
        # grants are visible immediately, not one publish later).
        self._published_tenant_usage: Dict[str, dict] = {}
        # Leases already asked back by quota reconciliation (one revoke
        # push per lease; cleared when the lease returns or dies).
        self._revoked_leases: Set[WorkerID] = set()
        self._reconcile_tick = 0
        # In-flight lease grants per tenant: resources debited from the
        # pool but not yet visible as a LEASED worker's resources_held
        # (the grant awaits worker readiness in between).  Without this,
        # a burst of concurrent requests all pass the quota check
        # against the same pre-burst usage.
        self._inflight_lease_usage: Dict[str, ResourceSet] = {}

        # Idempotency (at-least-once RPC discipline — see
        # docs/failure_semantics.md).  A duplicated submit_task must not
        # queue a second execution of the same attempt, and a duplicated
        # lease request must join the original grant instead of leasing
        # (and leaking) a second worker.
        self._seen_submits: Set[Tuple[bytes, int, int]] = set()
        self._seen_submits_order: deque = deque()
        # token -> (grant future, expiry monotonic time); swept by the
        # idle reaper once the submitter's retry horizon has passed.
        self._lease_grants: Dict[bytes, Tuple[asyncio.Future, float]] = {}

        # Drain plane: set by the GCS "drain" push (preemption notice or
        # autoscaler idle scale-down).  A draining raylet grants no new
        # leases, refuses bundle reservations and actor creations, and
        # spills queued work to peers; in-flight tasks run to completion
        # inside the deadline.
        self.draining = False
        self.drain_reason: Optional[str] = None
        self.drain_deadline = 0.0

        # Metrics
        self.num_tasks_dispatched = 0
        self.num_tasks_spilled = 0
        self.event_loop_lag_ms = 0.0
        self.event_loop_lag_max_ms = 0.0
        self._infeasible_tick = 0
        # Last orphaned-shm sweep (channel ring/fan-out files whose
        # owner PIDs died without teardown); swept from the idle reaper
        # on a channel_shm_sweep_period_s cadence.
        self._last_shm_sweep = 0.0
        self._bg: List[asyncio.Task] = []
        self._stopping = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self):
        from ray_tpu_torch._private.chaos import set_net_role

        set_net_role(f"raylet-{self.node_id.hex()[:8]}")
        await self.server.start()
        await self._connect_gcs(first=True)
        # Route this process's metric/span reports through the raylet's
        # own GCS client (there is no connected worker here); keyed by
        # node id in the GCS metrics table.
        from ray_tpu_torch.util import metrics as metrics_mod

        metrics_mod.set_report_channel(
            self._telemetry_channel, b"raylet:" + self.node_id.binary()
        )
        self._bg.append(self.loop.create_task(self._report_loop()))
        self._bg.append(self.loop.create_task(self._idle_reaper_loop()))
        if CONFIG.memory_monitor_enabled:
            self._bg.append(self.loop.create_task(self._memory_monitor_loop()))
        if CONFIG.object_spilling_enabled:
            self._bg.append(self.loop.create_task(self._spill_pressure_loop()))
        if CONFIG.log_to_driver:
            self._bg.append(self.loop.create_task(self._log_monitor_loop()))
        self._bg.append(self.loop.create_task(self._event_loop_lag_loop()))
        logger.info("raylet %s listening on %s", self.node_id.hex()[:8], self.address)

    async def _log_monitor_loop(self):
        """Tail this node's worker logs and publish new lines to the
        owning job's log channel (reference: log_monitor.py tailing →
        pubsub → driver printing).  Infra-formatted lines are skipped —
        the stream carries user prints/stderr.  Exited workers get one
        final tail (their last prints matter most) before their state is
        pruned."""
        offsets: Dict[bytes, int] = {}
        # key -> (log_path, job hex, pid, worker hex): survives the worker
        # leaving self.workers for exactly one final tail.
        tracked: Dict[bytes, tuple] = {}
        while not self._stopping:
            await asyncio.sleep(CONFIG.log_monitor_period_ms / 1000)
            if self.gcs is None or not self.gcs._connected:
                continue
            live_keys = set()
            for w in list(self.workers.values()):
                if w.log_path:
                    key = w.worker_id.binary()
                    live_keys.add(key)
                    tracked[key] = (
                        w.log_path, w.job_id.hex(), w.pid, w.worker_id.hex()[:12]
                    )
            for key, (log_path, job_hex, pid, worker_hex) in list(tracked.items()):
                final = key not in live_keys
                await self._tail_one_log(offsets, key, log_path, job_hex, pid, worker_hex)
                if final:
                    tracked.pop(key, None)
                    offsets.pop(key, None)

    async def _tail_one_log(self, offsets, key, log_path, job_hex, pid, worker_hex):
        try:
            size = os.path.getsize(log_path)
        except OSError:
            return
        off = offsets.get(key, 0)
        if size <= off:
            return
        cap = 256 * 1024
        try:
            with open(log_path, "rb") as f:
                f.seek(off)
                chunk = f.read(min(size - off, cap))
        except OSError:
            return
        nl = chunk.rfind(b"\n")
        if nl < 0:
            if len(chunk) < cap:
                return  # partial line: wait for its newline
            nl = len(chunk) - 1  # one giant line: ship it split, keep moving
        offsets[key] = off + nl + 1
        lines = [
            ln.decode("utf-8", "replace")
            for ln in chunk[: nl + 1].splitlines()
            if not ln.startswith(b"[worker ")  # infra log format
        ]
        if not lines:
            return
        try:
            await self.gcs.push(
                "publish",
                (
                    f"logs:{job_hex}",
                    {
                        "pid": pid,
                        "worker": worker_hex,
                        "node": os.uname().nodename,
                        "lines": lines,
                    },
                ),
            )
        except rpc.RpcError:
            pass

    async def _spill_pressure_loop(self):
        period = CONFIG.object_spill_check_period_ms / 1000
        while not self._stopping:
            await asyncio.sleep(period)
            try:
                await self.store.spill_pressure_async(self.loop)
            except Exception:
                logger.exception("background spill failed")

    # ------------------------------------------------------------------
    # memory monitor / OOM worker killing (reference:
    # src/ray/common/memory_monitor.h:52 UsageAboveThreshold +
    # raylet/worker_killing_policy_group_by_owner.cc — kill the newest
    # retriable work first so long-running work survives)
    # ------------------------------------------------------------------
    async def _memory_monitor_loop(self):
        period = CONFIG.memory_monitor_refresh_ms / 1000
        while not self._stopping:
            await asyncio.sleep(period)
            try:
                self._check_memory_once()
            except Exception:
                logger.exception("memory monitor check failed")

    @staticmethod
    def _proc_rss(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                return int(f.read().split()[1]) * 4096
        except (OSError, ValueError, IndexError):
            return 0

    def _workers_rss(self) -> Dict[WorkerID, int]:
        return {
            w.worker_id: self._proc_rss(w.pid)
            for w in self.workers.values()
            if w.proc is not None and w.proc.poll() is None
        }

    def _check_memory_once(self):
        limit = int(CONFIG.memory_limit_bytes)
        if limit > 0:
            # Explicit per-node worker-memory budget (sum of worker RSS) —
            # deterministic, unaffected by other tenants of the host.
            rss = self._workers_rss()
            used = sum(rss.values())
            if used <= limit:
                return
            detail = (
                f"workers use {used >> 20} MiB, over the node's "
                f"{limit >> 20} MiB worker-memory limit"
            )
        else:
            # System policy: MemAvailable below (1 - threshold) of MemTotal.
            total, avail = self._read_meminfo()
            if total <= 0 or avail >= (1.0 - CONFIG.memory_usage_threshold) * total:
                return
            rss = self._workers_rss()
            detail = (
                f"node memory critical: {avail >> 20} MiB available of "
                f"{total >> 20} MiB ({CONFIG.memory_usage_threshold:.0%} threshold)"
            )
        victim = self._pick_oom_victim(rss)
        if victim is not None:
            self._oom_kill_worker(
                victim, f"{detail}; killed worker rss={rss.get(victim.worker_id, 0) >> 20} MiB"
            )

    @staticmethod
    def _read_meminfo() -> Tuple[int, int]:
        total = avail = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1]) * 1024
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
                    if total and avail:
                        break
        except OSError:
            pass
        return total, avail

    def _pick_oom_victim(self, rss: Dict[WorkerID, int]) -> Optional[WorkerHandle]:
        """Newest working (task-running) worker first, normal tasks before
        actors (tasks are retriable by default, actors are stateful); idle
        workers last — killing them frees memory without failing work."""
        working, idle = [], []
        for w in self.workers.values():
            if w.proc is None or w.proc.poll() is not None or w.state == "DEAD":
                continue
            (working if w.state in ("BUSY", "LEASED", "ACTOR") else idle).append(w)
        if working:
            working.sort(key=lambda w: (w.actor_id is not None, -w.spawn_time))
            return working[0]
        if idle and rss.get(max(idle, key=lambda w: rss.get(w.worker_id, 0)).worker_id, 0) > 0:
            return max(idle, key=lambda w: rss.get(w.worker_id, 0))
        return None

    def _oom_kill_worker(self, w: WorkerHandle, detail: str):
        logger.warning(
            "OOM-killing worker %s (%s): %s", w.worker_id.hex()[:12], w.state, detail
        )
        # Tell the lease holder first: the direct submitter owns the specs
        # the raylet can't see, and uses this to surface OutOfMemoryError
        # instead of a generic worker-crash.
        if w.lease_owner is not None and not w.lease_owner.closed:
            try:
                w.lease_owner.push(
                    "oom_kill", {"worker_id": w.worker_id.binary(), "message": detail}
                )
            except Exception:
                pass
        for _tb, spec in list(w.running.items()):
            self._handle_failed_execution(spec, f"oom: {detail}")
        w.running.clear()
        actor_id = w.actor_id
        if w.proc is not None and w.proc.poll() is None:
            try:
                w.proc.kill()  # SIGKILL: a thrashing process may not die to SIGTERM
            except Exception:
                pass
        self._kill_worker_proc(w)
        if actor_id is not None and self.gcs is not None:
            self.loop.create_task(
                self._safe_gcs_push(
                    "actor_death_report",
                    self._stamped(
                        {"actor_id": actor_id.binary(), "intended": False, "reason": f"oom: {detail}"}
                    ),
                )
            )
        self._schedule_dispatch()

    def _register_payload(self) -> dict:
        from ray_tpu_torch._private.chaos import net_name

        return {
            "node_id": self.node_id.binary(),
            "raylet_address": self.address,
            "object_store_dir": self.store.store_dir,
            "resources_total": dict(self.resources_total),
            "labels": self.labels,
            "is_head": self.is_head,
            "hostname": os.uname().nodename,
            # Directional-chaos identity: lets the GCS consult net:
            # rules for its node-client frames (gcs -> this raylet).
            "net_name": net_name(),
            # Resync state for (re-)registration after a GCS restart.
            "live_actors": [a.binary() for a in self.actor_workers],
            "sealed_objects": [o.binary() for o in self.store.objects],
        }

    async def _connect_gcs(self, first: bool = False):
        client = rpc.AsyncRpcClient(self.gcs_address, peer_name="gcs")
        client.on_push = self._on_gcs_push
        client.on_close = self._on_gcs_lost
        await client.connect()
        reply = await client.call("register_node", self._register_payload())
        # The GCS stamps a fresh incarnation at every registration; all
        # raylet-originated writes carry it so a fenced zombie's reports
        # are rejected typed (see _fenced_teardown).
        if isinstance(reply, dict):
            self.incarnation = int(reply.get("incarnation", self.incarnation))
        await client.call("subscribe", "resources")
        await client.call("subscribe", "nodes")
        await client.call("subscribe", "tenant_usage")
        self.gcs = client

    def _stamped(self, payload: dict) -> dict:
        """Stamp a raylet-originated write with this node's membership
        identity so the GCS can fence it if the incarnation went stale."""
        payload["node_id"] = self.node_id.binary()
        payload["incarnation"] = self.incarnation
        return payload

    def _on_fenced(self):
        """A GCS reply carried NodeFencedError: this raylet's incarnation
        was declared dead while it was partitioned, and a successor view
        of the cluster no longer includes it.  Tear down exactly once
        (concurrent fenced replies from the report loop, location pushes
        and telemetry flushers all funnel here)."""
        if self._stopping or (
            self._fencing_task is not None and not self._fencing_task.done()
        ):
            return
        self._fencing_task = self.loop.create_task(self._fenced_teardown())

    async def _fenced_teardown(self):
        fenced_inc = self.incarnation
        logger.warning(
            "raylet %s fenced (incarnation %d was declared dead): killing "
            "workers, reaping channel shm, re-registering fresh",
            self.node_id.hex()[:8], fenced_inc,
        )
        # 1. Everything admitted under the dead incarnation is void: the
        # GCS already restarted those actors elsewhere and failed the
        # tasks — a surviving worker here would be a split-brain zombie.
        for w in list(self.workers.values()):
            self._kill_worker_proc(w)
        self.queue.clear()
        self.infeasible.clear()
        while self.lease_waiters:
            waiter = self.lease_waiters.popleft()
            if not waiter.fut.done():
                waiter.fut.set_result("draining")
        self.bundles.clear()
        self.resources_available = self.resources_total.copy()
        self._inflight_lease_usage.clear()
        self.draining = False
        self.drain_reason = None
        self.drain_deadline = 0.0
        # 2. Reap orphaned dataplane shm the killed workers left behind
        # (same sweeper the idle reaper runs on cadence).
        try:
            from ray_tpu_torch.experimental.channel import sweep_orphan_ring_dirs

            reclaimed = sweep_orphan_ring_dirs()
            if reclaimed:
                logger.info(
                    "fenced teardown reclaimed %d orphaned channel shm files",
                    reclaimed,
                )
        except Exception:
            logger.exception("fenced shm sweep failed")
        # 3. Re-register as a fresh incarnation.  The old client must not
        # fire its on_close reconnect path on top of this one.
        old = self.gcs
        if old is not None:
            old.on_close = None
            old.close()
        bo = retry.RECONNECT.start(deadline_s=CONFIG.gcs_reconnect_timeout_s)
        while not self._stopping:
            try:
                await self._connect_gcs()
                logger.info(
                    "raylet %s re-registered after fencing: incarnation %d -> %d",
                    self.node_id.hex()[:8], fenced_inc, self.incarnation,
                )
                return
            except Exception:
                delay = bo.next_delay()
                if delay is None:
                    break
                await asyncio.sleep(delay)
        if not self._stopping and self.on_fatal:
            self.on_fatal()

    def _on_gcs_lost(self):
        """GCS connection dropped: retry with backoff — the GCS restarts
        against its snapshot (reference: clients retry against a
        redis-backed GCS, gcs_redis_failure_detector.cc).  Only after the
        reconnect window expires is this fatal."""
        if self._stopping:
            return
        self.loop.create_task(self._gcs_reconnect_loop())

    async def _gcs_reconnect_loop(self):
        bo = retry.RECONNECT.start(deadline_s=CONFIG.gcs_reconnect_timeout_s)
        logger.warning("GCS connection lost; reconnecting")
        while not self._stopping:
            try:
                await self._connect_gcs()
                logger.info("GCS reconnected")
                return
            except Exception:
                delay = bo.next_delay()
                if delay is None:
                    break
                await asyncio.sleep(delay)
        if not self._stopping and self.on_fatal:
            self.on_fatal()

    async def stop(self):
        self._stopping = True
        try:
            for t in self._bg:
                t.cancel()
            for w in list(self.workers.values()):
                self._kill_worker_proc(w)
            await self.server.stop()
            if self.gcs:
                self.gcs.close()
            for c in self.peer_clients.values():
                c.close()
        finally:
            # Always reclaim the shm arena, even if the graceful teardown
            # above raised or was cancelled by raylet_main's stop timeout —
            # a leaked /dev/shm arena outlives the process.
            self.cleanup_store_files()

    def cleanup_store_files(self):
        import shutil

        shutil.rmtree(self.store.spill_dir, ignore_errors=True)
        shutil.rmtree(self.store.store_dir, ignore_errors=True)
        try:  # remove the per-session parent when the last store leaves
            os.rmdir(os.path.dirname(self.store.store_dir))
        except OSError:
            pass

    def _kick_spawn_gate(self):
        """Wake parked actor creations (a worker left STARTING or a gate
        turn advanced)."""
        if self._spawn_gate_event is not None:
            self._spawn_gate_event.set()

    def _release_spawn_token(self, w: "WorkerHandle"):
        token = getattr(w, "spawn_token", None)
        if token is not None:
            w.spawn_token = None
            from ray_tpu_torch._private.spawn_gate import HostSpawnGate

            HostSpawnGate.release(token)

    def _kill_worker_proc(self, w: WorkerHandle):
        w.state = "DEAD"
        self._revoked_leases.discard(w.worker_id)
        self._release_spawn_token(w)
        self._kick_spawn_gate()
        self.workers.pop(w.worker_id, None)
        if w.actor_id is not None:
            self.actor_workers.pop(w.actor_id, None)
        self._release_resources(w)
        if w.proc is not None and w.proc.poll() is None:
            try:
                w.proc.terminate()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # GCS pushes
    # ------------------------------------------------------------------
    def _on_gcs_push(self, method: str, payload):
        if method == "pubsub":
            channel, msg = payload
            if channel == "resources":
                node_bytes, available = msg
                if node_bytes != self.node_id.binary() and node_bytes in self.cluster_view:
                    self.cluster_view[node_bytes]["available"] = available
            elif channel == "nodes":
                state, node = payload[1]
                nb = node["node_id"]
                if state == "ALIVE" and nb != self.node_id.binary():
                    self.cluster_view[nb] = {
                        "raylet_address": node["raylet_address"],
                        "available": node.get("available", {}),
                        "total": node.get("resources_total", {}),
                        "labels": node.get("labels", {}),
                    }
                elif state in ("DEAD", "DRAINING"):
                    # A DRAINING peer grants no leases and takes no spills
                    # — drop it from the spill/spillback candidate view
                    # (objects are still pulled from it via GCS locations).
                    self.cluster_view.pop(nb, None)
            elif channel == "tenant_usage":
                # Cluster-wide tenant view: refresh and re-run the grant
                # loop — usage falling (or a raised quota) elsewhere may
                # unblock parked waiters here.
                self.cluster_tenant_usage = msg.get("usage", {})
                self.cluster_resource_totals = msg.get("totals", {})
                self.tenant_specs = {
                    n: tenants_mod.TenantSpec.from_dict(d)
                    for n, d in msg.get("tenants", {}).items()
                }
                self._grant_lease_waiters()
                self._schedule_dispatch()
        # NOTE: kill_actor/job_finished/store_free arrive via the GCS's
        # node client as push_* handlers below, not on this channel.

    # ------------------------------------------------------------------
    # resource reporting (reference: ray_syncer)
    # ------------------------------------------------------------------
    async def _report_loop(self):
        while not self._stopping:
            # Chaos fault point: "@raylet.tick:kill:at=N" dies on the
            # N-th report tick — the raylet-death axis of the fault plane.
            if CHAOS.active and CHAOS.maybe_kill("raylet.tick"):
                logger.warning("chaos: killing raylet at report tick")
                os._exit(1)
            # "@raylet.tick:preempt:at=N:ms=K": on the N-th tick this node
            # receives a K-ms preemption notice — it asks the GCS to drain
            # it, then hard-dies at the deadline, modeling a spot/
            # preemptible host (seed-replayable like every fault).
            if CHAOS.active and not self.draining:
                notice = CHAOS.maybe_preempt("raylet.tick")
                if notice is not None:
                    self._begin_chaos_preemption(notice)
            now = time.monotonic()
            self._unmet_lease_demand = {
                k: v
                for k, v in self._unmet_lease_demand.items()
                if now - v[1] < 15.0  # retries refresh live demand
            }
            # Per-node drain budget gauges (this process's report channel
            # is keyed by node id at the GCS — no node label needed).
            if self.draining:
                telemetry.set_drain_budget(
                    self.drain_deadline - time.time(),
                    sum(len(w.running) for w in self.workers.values()),
                )
            self._reconcile_tick += 1
            if self._reconcile_tick % 5 == 0:  # ~1 s cadence on 0.2 s ticks
                try:
                    self._reconcile_tenant_quotas()
                except Exception:
                    logger.exception("tenant quota reconciliation failed")
            local_tenant_usage = self._local_tenant_usage()
            t_report = time.monotonic()
            try:
                await self.gcs.call(
                    "resource_report",
                    {
                        "node_id": self.node_id.binary(),
                        "incarnation": self.incarnation,
                        # Self-measured GCS link health (previous ticks):
                        # the suspicion score's gray-failure input.
                        "health": {
                            "gcs_rtt_ms": round(self._gcs_rtt_ms, 1),
                            "gcs_errors": self._gcs_call_errors,
                        },
                        "available": dict(self.resources_available),
                        "total": dict(self.resources_total),
                        "has_pending": bool(self.queue or self.infeasible),
                        # Per-tenant resources held here (leases + actor
                        # workers + PG reservations): the GCS aggregates
                        # these into the cluster-wide fair-share view.
                        "tenant_usage": local_tenant_usage,
                        # Tenant/priority-tagged parked lease demand: the
                        # preemption monitor's starvation signal for the
                        # direct submission path.
                        "pending_tenant_demand": [
                            {
                                "shape": dict(w.res),
                                "tenant": w.tenant,
                                "priority": w.priority,
                                "age_s": now - w.enqueued,
                            }
                            for w in list(self.lease_waiters)[:32]
                        ],
                        # resource shapes of queued/infeasible work — the
                        # autoscaler's demand signal (reference:
                        # resource_load_by_shape in ray_syncer reports)
                        "pending_shapes": [
                            dict(self._task_resources(s))
                            for s in list(self.queue)[:64] + self.infeasible[:64]
                        ]
                        # direct-submission demand is queued in the
                        # SUBMITTER, not this raylet: unmet lease shapes
                        # (infeasible here and unspillable) must still
                        # reach the autoscaler or it never sees them
                        + [
                            dict(shape)
                            for shape, _t in self._unmet_lease_demand.values()
                        ][:32]
                        + [dict(w.res) for w in list(self.lease_waiters)[:32]],
                    },
                    timeout=10,
                )
                self._published_tenant_usage = local_tenant_usage
                rtt_ms = (time.monotonic() - t_report) * 1000
                self._gcs_rtt_ms = 0.7 * self._gcs_rtt_ms + 0.3 * rtt_ms
                self._gcs_call_errors = 0
            except NodeFencedError:
                self._on_fenced()
            except rpc.RpcError:
                self._gcs_call_errors += 1
            # Periodically retry infeasible tasks (cluster membership or
            # resources may have changed); doing this here rather than in
            # _dispatch avoids a hot requeue loop for never-satisfiable
            # tasks.
            self._infeasible_tick += 1
            if self.infeasible and self._infeasible_tick % 10 == 0:
                infeasible, self.infeasible = self.infeasible, []
                for spec in infeasible:
                    self._queue_and_schedule(spec)
            await asyncio.sleep(0.2)

    def _begin_chaos_preemption(self, notice_s: float):
        """Deliver the preemption notice (drain_node to the GCS) and
        schedule the hard kill at the deadline.  The drain itself may be
        chaos-dropped — then the cluster only finds out via the reactive
        heartbeat path when the process dies."""
        logger.warning(
            "chaos: preemption notice on %s — draining, killing in %.1fs",
            self.node_id.hex()[:8], notice_s,
        )

        async def deliver():
            try:
                await self.gcs.call(
                    "drain_node",
                    {
                        "node_id": self.node_id.binary(),
                        "reason": "PREEMPTION",
                        "deadline_s": notice_s,
                    },
                    timeout=min(10.0, max(1.0, notice_s)),
                )
            except rpc.RpcError:
                logger.warning("chaos: preemption drain notice lost")

        self.loop.create_task(deliver())
        self.loop.call_later(notice_s, os._exit, 1)

    async def _idle_reaper_loop(self):
        while not self._stopping:
            await asyncio.sleep(5)
            limit = CONFIG.idle_worker_pool_size
            kill_after = CONFIG.idle_worker_killing_time_ms / 1000
            now = time.monotonic()
            # Sweep idempotent lease grants past their retry horizon.
            for token in [
                t for t, (_f, exp) in self._lease_grants.items() if exp < now
            ]:
                self._lease_grants.pop(token, None)
            for pool_key, dq in self.idle_workers.items():
                while len(dq) > limit:
                    w = dq.popleft()
                    self._kill_worker_proc(w)
                for w in list(dq):
                    if now - w.idle_since > kill_after:
                        dq.remove(w)
                        self._kill_worker_proc(w)
            # Orphaned dataplane shm: ring/fan-out files under the
            # shared ring base whose registered owner PIDs are ALL dead
            # (a SIGKILLed writer/reader skipped every teardown path)
            # are reclaimed so tmpfs (RAM) doesn't leak.  Safe with
            # multiple raylets per host: unlink succeeds exactly once.
            sweep_period = float(CONFIG.channel_shm_sweep_period_s)
            if sweep_period > 0 and now - self._last_shm_sweep >= sweep_period:
                self._last_shm_sweep = now
                try:
                    from ray_tpu_torch.experimental.channel import (
                        sweep_orphan_ring_dirs,
                    )

                    reclaimed = sweep_orphan_ring_dirs()
                    if reclaimed:
                        logger.info(
                            "reclaimed %d orphaned channel shm files",
                            reclaimed,
                        )
                except Exception:
                    logger.exception("orphaned channel shm sweep failed")
            # STARTING workers that never registered (wedged staging, a
            # hung pip, a crashed interpreter that left the handle) are
            # reaped by age so they don't leak forever.
            for w in list(self.workers.values()):
                if (
                    w.state == "STARTING"
                    and now - w.spawn_time > CONFIG.worker_register_timeout_s
                ):
                    logger.warning(
                        "reaping worker %s: not registered after %.0fs",
                        w.worker_id.hex()[:12], now - w.spawn_time,
                    )
                    self._kill_worker_proc(w)

    # ------------------------------------------------------------------
    # worker pool (reference: raylet/worker_pool.h:216)
    # ------------------------------------------------------------------
    def _spawn_worker(
        self,
        job_id: JobID,
        actor_id: Optional[ActorID] = None,
        runtime_env: Optional[dict] = None,
    ) -> WorkerHandle:
        worker_id = WorkerID.from_random()
        from ray_tpu_torch._private.node import child_env

        env = child_env()
        env["RAY_TPU_TORCH_RAYLET_ADDRESS"] = self.address
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_TORCH_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_TORCH_JOB_ID"] = job_id.hex()
        env["RAY_TPU_TORCH_GCS_ADDRESS"] = self.gcs_address
        env["RAY_TPU_TORCH_STORE_DIR"] = self.store.store_dir
        # Unbuffered so user prints reach the log file (and the driver's
        # log stream) as they happen, not at process exit.
        env["PYTHONUNBUFFERED"] = "1"
        # Tenant isolation: the worker inherits its job's tenant so work
        # it submits (nested tasks, leases) is charged to the same
        # tenant as the driver's.
        job_tenant = (self.job_configs.get(job_id) or {}).get("tenant")
        if job_tenant:
            env["RAY_TPU_TORCH_TENANT"] = str(job_tenant)
            env["RAY_TPU_TORCH_TENANT_PRIORITY"] = str(
                (self.job_configs.get(job_id) or {}).get("priority") or 0
            )
        if self.session_dir:
            env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        if runtime_env:
            import json as _json

            env["RAY_TPU_TORCH_RUNTIME_ENV"] = _json.dumps(runtime_env)
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{worker_id.hex()[:12]}.log")
        out = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.default_worker"],
            env=env,
            stdout=out,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        out.close()
        w = WorkerHandle(worker_id, proc, job_id)
        w.actor_id = actor_id
        w.env_hash = runtime_env_mod.env_hash(runtime_env)
        w.log_path = log_path
        w.tenant = tenants_mod.normalize_tenant(job_tenant)
        self.workers[worker_id] = w
        return w

    async def rpc_register_worker(self, payload, conn):
        worker_id = WorkerID(payload["worker_id"])
        w = self.workers.get(worker_id)
        if w is None:
            # Driver registering as a worker-like client, or unknown.
            return {"ok": False}
        if payload.get("runtime_env_error"):
            # The worker failed to stage its runtime env: remember the bad
            # env, fail every queued task that needs it, and refuse the
            # registration — letting the worker die without this would
            # respawn it in a loop (reference: runtime-env agent surfaces
            # RuntimeEnvSetupError the same way).
            msg = payload["runtime_env_error"]
            self.bad_runtime_envs[w.env_hash] = (msg, time.monotonic())
            self._fail_queued_for_env(w.env_hash, msg)
            self._kill_worker_proc(w)
            return {"ok": False}
        if w.job_id not in self.job_configs:
            # Worker of a job whose driver registered at another raylet:
            # the job config (incl. driver_sys_path) lives in the GCS.
            try:
                self.job_configs[w.job_id] = await self.gcs.call(
                    "get_job_config", w.job_id.binary(), timeout=10
                )
            except rpc.RpcError:
                pass
        w.conn = conn
        w.direct_address = payload.get("address")
        w.state = "IDLE"
        self._release_spawn_token(w)
        self._kick_spawn_gate()  # one STARTING slot just freed
        conn.meta["worker_id"] = worker_id
        if w.actor_id is None and not w.reserved:
            self.idle_workers[(w.job_id, w.env_hash)].append(w)
        self._schedule_dispatch()
        return {"ok": True, "job_config": self.job_configs.get(w.job_id, {})}

    async def rpc_register_client(self, payload, conn):
        """Drivers register so the raylet can clean up on disconnect."""
        conn.meta["is_driver"] = True
        if payload and payload.get("job_id"):
            job_id = JobID(payload["job_id"])
            conn.meta["job_id"] = job_id
            self.job_configs[job_id] = payload.get("job_config", {})
            # Prestart workers for the job (with its default runtime env,
            # so the common case reuses them instead of spawning again).
            job_env = self.job_configs[job_id].get("runtime_env") or None
            n = CONFIG.num_prestart_workers or min(2, int(self.resources_total.get("CPU", 1)))
            for _ in range(n):
                self._spawn_worker(job_id, runtime_env=job_env)
        return {"node_id": self.node_id.binary(), "store_dir": self.store.store_dir}

    async def push_task_blocked(self, payload, conn):
        """A worker blocked in ray.get releases its task's CPU so nested
        tasks can run (reference: CoreWorker NotifyDirectCallTaskBlocked)."""
        worker_id = conn.meta.get("worker_id")
        w = self.workers.get(worker_id) if worker_id else None
        if w is None:
            return
        if w.state == "LEASED":
            # A leased worker blocked in ray.get: release the lease's
            # resources so nested work can run (re-acquired on unblock).
            if not w.lease_blocked and w.resources_held:
                w.lease_blocked = True
                self.resources_available.add(w.resources_held)
                self._grant_lease_waiters()
                self._schedule_dispatch()
            return
        spec = w.running.get(payload["task_id"])
        if spec is not None and not spec.is_actor_task:
            self._release_task_resources(spec)
            w.resources_held.subtract(self._task_resources(spec))
            self._schedule_dispatch()

    async def push_task_unblocked(self, payload, conn):
        worker_id = conn.meta.get("worker_id")
        w = self.workers.get(worker_id) if worker_id else None
        if w is None:
            return
        if w.state == "LEASED":
            if w.lease_blocked:
                w.lease_blocked = False
                # May transiently oversubscribe, like the reference.
                self.resources_available.subtract(w.resources_held)
            return
        spec = w.running.get(payload["task_id"])
        if spec is not None and not spec.is_actor_task:
            # May transiently oversubscribe, like the reference.
            bk = self._bundle_key(spec)
            if bk is not None:
                b = self.bundles.get(bk)
                if b is not None:
                    b["available"].subtract(self._task_resources(spec))
            else:
                self.resources_available.subtract(self._task_resources(spec))
            w.resources_held.add(self._task_resources(spec))

    async def _on_disconnect(self, conn):
        worker_id = conn.meta.get("worker_id")
        if worker_id is not None:
            w = self.workers.get(worker_id)
            if w is not None and w.state != "DEAD":
                await self._on_worker_death(w)
        # Sweep leases held by a vanished submitter (driver or worker).
        for w in list(self.workers.values()):
            if w.state == "LEASED" and w.lease_owner is conn:
                await self.push_return_worker_lease(
                    {"worker_id": w.worker_id.binary()}, conn
                )

    async def _on_worker_death(self, w: WorkerHandle):
        w.state = "DEAD"
        self._revoked_leases.discard(w.worker_id)
        self.workers.pop(w.worker_id, None)
        for dq in self.idle_workers.values():
            if w in dq:
                dq.remove(w)
        self._release_resources(w)
        # Fail or retry the tasks it was running.
        for task_bytes, spec in list(w.running.items()):
            self._handle_failed_execution(spec, "worker process died")
        w.running.clear()
        if w.actor_id is not None:
            self.actor_workers.pop(w.actor_id, None)
            try:
                await self.gcs.call(
                    "actor_death_report",
                    self._stamped(
                        {"actor_id": w.actor_id.binary(), "intended": False, "reason": "actor worker process died"}
                    ),
                )
            except NodeFencedError:
                self._on_fenced()
            except rpc.RpcError:
                pass
        self._schedule_dispatch()

    def _handle_failed_execution(self, spec: TaskSpec, reason: str):
        from ray_tpu_torch import exceptions

        if spec.task_id.binary() in self.cancelled_tasks:
            self.cancelled_tasks.discard(spec.task_id.binary())
            self._fail_spec_with_error(
                spec, exceptions.TaskCancelledError(f"Task {spec.name} was cancelled")
            )
            return
        if spec.max_retries < 0 or spec.attempt_number < spec.max_retries:
            spec.attempt_number += 1
            logger.info("retrying task %s (attempt %d): %s", spec.name, spec.attempt_number, reason)
            self.loop.call_later(
                CONFIG.task_retry_delay_ms / 1000, lambda: (self._enqueue_local(spec), self._schedule_dispatch())
            )
            return
        if reason.startswith("oom:"):
            err = exceptions.OutOfMemoryError(f"Task {spec.name} failed: {reason}")
        elif spec.is_actor_task:
            err = exceptions.RayActorError(f"The actor died while running {spec.name}: {reason}")
        else:
            err = exceptions.WorkerCrashedError(f"Task {spec.name} failed: {reason}")
        blob = serialization.serialize_to_bytes(err, tag=serialization.TAG_ERROR)
        for oid in spec.return_ids():
            self.store.create_from_bytes(oid, blob)

    def _fail_spec_with_error(self, spec: TaskSpec, err: Exception):
        blob = serialization.serialize_to_bytes(err, tag=serialization.TAG_ERROR)
        for oid in spec.return_ids():
            self.store.create_from_bytes(oid, blob)

    def _fail_queued_for_env(self, env_hash: str, msg: str):
        from ray_tpu_torch import exceptions

        err = exceptions.RuntimeEnvSetupError(f"runtime_env setup failed: {msg}")
        kept = deque()
        for spec in self.queue:
            if runtime_env_mod.spec_env_hash(spec) == env_hash:
                self._fail_spec_with_error(spec, err)
            else:
                kept.append(spec)
        self.queue = kept

    def _on_job_finished(self, job_id: JobID):
        for w in list(self.workers.values()):
            # Detached-actor workers outlive their creating job (their
            # lifetime belongs to the namespace, not the driver; the GCS
            # kills them only via an explicit ray.kill) — everything
            # else of the job is reaped.
            if w.job_id == job_id and not (w.actor_id is not None and w.detached):
                self._kill_worker_proc(w)
        for key in [k for k in self.idle_workers if k[0] == job_id]:
            self.idle_workers.pop(key, None)
        self.job_configs.pop(job_id, None)
        self.queue = deque(s for s in self.queue if s.job_id != job_id)
        self.infeasible = [s for s in self.infeasible if s.job_id != job_id]
        # Per-job object GC: every object id embeds its job id.
        for oid in list(self.store.objects):
            try:
                if oid.job_id() == job_id:
                    self.store.delete(oid)
            except Exception:
                pass

    # ------------------------------------------------------------------
    # task scheduling (reference: cluster_task_manager.cc:44 QueueAndScheduleTask)
    # ------------------------------------------------------------------
    async def rpc_cancel_task(self, payload, conn):
        """Cancel a raylet-queued task (error returns, never runs) or
        forward the cancel to the worker running it (reference:
        node_manager HandleCancelTask)."""
        from ray_tpu_torch import exceptions

        tid = payload["task_id"]
        force = payload.get("force", False)
        for coll in (self.queue, self.infeasible):
            for spec in list(coll):
                if spec.task_id.binary() == tid:
                    coll.remove(spec)
                    self._fail_spec_with_error(
                        spec,
                        exceptions.TaskCancelledError(f"Task {spec.name} was cancelled"),
                    )
                    return True
        for w in self.workers.values():
            if tid in w.running and w.conn is not None and not w.conn.closed:
                # Remembered so a force-kill's worker death doesn't send
                # the cancelled spec around the retry loop.
                self.cancelled_tasks.add(tid)
                w.conn.push("cancel_task", {"task_id": tid, "force": force})
                return True
        # Not here: the task may have spilled to a peer raylet — fan the
        # cancel out once (forwarded guard stops ping-pong).
        if not payload.get("forwarded"):
            for view in self.cluster_view.values():
                addr = view.get("raylet_address")
                if not addr or addr == self.address:
                    continue
                try:
                    peer = await self._peer(addr)
                    if await peer.call(
                        "cancel_task",
                        {"task_id": tid, "force": force, "forwarded": True},
                        timeout=10,
                    ):
                        return True
                except rpc.RpcError:
                    continue
        return False

    async def rpc_submit_task(self, payload, conn):
        spec: TaskSpec = payload["spec"]
        spilled = payload.get("spilled", False)
        # Idempotency: a duplicated delivery (retry after a lost reply,
        # chaos dup) must not queue the same attempt twice.  The key
        # includes `reconstructions` because lineage recovery legitimately
        # resubmits the SAME (task_id, attempt) with a bumped
        # reconstruction counter (worker._recover_object).  Spilled
        # deliveries are exempt: raylet-to-raylet forwards are internal
        # moves, not client retries — a task spilled away and later
        # forwarded back (infeasible-retry re-spill) must re-queue, and
        # the forwarder never retries a submit (it falls back to running
        # locally on RpcError).
        key = None
        if not spilled:
            key = (spec.task_id.binary(), spec.attempt_number, spec.reconstructions)
            if key in self._seen_submits:
                return True
        # The key is recorded only AFTER the submit side effect lands: if
        # the handler raises, a retry must re-attempt, not get falsely
        # acked by the dedupe.  The body below never awaits, so the
        # check-work-record sequence is atomic per event-loop task even
        # under chaos-duplicated concurrent deliveries.
        if spec.is_actor_task:
            result = self._submit_actor_task(spec)
        else:
            self._queue_and_schedule(spec, allow_spill=not spilled)
            result = True
        if key is not None:
            self._seen_submits.add(key)
            self._seen_submits_order.append(key)
            while len(self._seen_submits_order) > 8192:
                self._seen_submits.discard(self._seen_submits_order.popleft())
        return result

    def _queue_and_schedule(self, spec: TaskSpec, allow_spill: bool = True):
        strategy = spec.scheduling_strategy
        if allow_spill and strategy.kind in ("DEFAULT", "SPREAD"):
            target = self._cluster_decision(spec)
            if target is not None:
                self.num_tasks_spilled += 1
                self.loop.create_task(self._forward_task(spec, target))
                return
        elif allow_spill and strategy.kind == "NODE_AFFINITY":
            if strategy.node_id != self.node_id:
                view = self.cluster_view.get(strategy.node_id.binary())
                if view is not None:
                    self.loop.create_task(self._forward_task(spec, view["raylet_address"]))
                    return
                if not strategy.soft:
                    from ray_tpu_torch import exceptions

                    self._fail_spec_with_error(
                        spec,
                        exceptions.RaySystemError(
                            f"NODE_AFFINITY target {strategy.node_id.hex()[:8]} is not alive"
                        ),
                    )
                    return
                # soft: fall through and run wherever (here)
        elif allow_spill and strategy.kind == "NODE_LABEL":
            if not _labels_match(strategy.labels, self.labels):
                for view in self.cluster_view.values():
                    if _labels_match(strategy.labels, view.get("labels", {})):
                        self.loop.create_task(
                            self._forward_task(spec, view["raylet_address"])
                        )
                        return
                from ray_tpu_torch import exceptions

                self._fail_spec_with_error(
                    spec,
                    exceptions.RaySystemError(
                        f"no alive node matches labels {strategy.labels}"
                    ),
                )
                return
        self._enqueue_local(spec)
        self._schedule_dispatch()

    def _enqueue_local(self, spec: TaskSpec):
        """Every local-queue insertion goes through here so queued_at is
        (re)stamped: retries and failed forwards re-enter the queue, and
        a stale stamp would fold execution + retry delay into the
        task_phase_seconds{phase=queue} signal."""
        spec.queued_at = time.monotonic()
        # FIFO stamp for tenant-fair dispatch ordering; survives requeues
        # (a retried task keeps its place within its tenant's FIFO).
        if getattr(spec, "dispatch_seq", None) is None:
            self._dispatch_seq += 1
            spec.dispatch_seq = self._dispatch_seq
        self.queue.append(spec)

    def _spec_tenant_priority(self, spec: TaskSpec) -> Tuple[str, int]:
        cfg = self.job_configs.get(spec.job_id) or {}
        try:
            priority = int(cfg.get("priority") or 0)
        except (TypeError, ValueError):
            priority = 0
        return tenants_mod.normalize_tenant(cfg.get("tenant")), priority

    def _fair_queue_order(self, queue) -> deque:
        """Tenant-aware ordering for the raylet-mediated dispatch queue:
        the same (priority, FIFO)-per-tenant rule the lease queue
        already applies, tenants served ascending dominant share
        (plain FIFO would let one tenant's task burst delay every other
        tenant's queued work)."""
        entries = [
            (*self._spec_tenant_priority(spec), spec.dispatch_seq, spec)
            for spec in queue
        ]
        usage = self._effective_tenant_usage()
        totals = self.cluster_resource_totals or self._cluster_totals_view()
        return deque(
            tenants_mod.fair_dispatch_order(
                entries, usage, totals, self.tenant_specs
            )
        )

    def _cluster_decision(self, spec: TaskSpec) -> Optional[str]:
        """Return a peer raylet address to spill to, or None to keep local.

        Hybrid policy: keep local while local available resources fit
        (pack); otherwise pick the least-utilized remote that fits
        (reference: hybrid_scheduling_policy.cc top-k pack-then-spread).
        A draining node inverts the bias: spill whenever any peer fits,
        keep local only as a last resort (the work would race the drain
        deadline)."""
        res = spec.resources
        if spec.scheduling_strategy.kind == "SPREAD" and not self.draining:
            return self._spread_decision(res)
        if not self.draining and res.fits_in(self.resources_available):
            return None
        best = None
        best_avail = -1.0
        for nb, view in self.cluster_view.items():
            avail = view.get("available", {})
            if all(avail.get(k, 0.0) + 1e-9 >= v for k, v in res.items()):
                score = sum(avail.values())
                if score > best_avail:
                    best_avail = score
                    best = view["raylet_address"]
        return best

    def _spread_decision(self, res: ResourceSet) -> Optional[str]:
        """SPREAD: round-robin over this node and the peers the task fits,
        those with the resources free now first (reference:
        spread_scheduling_policy.cc).  Returns a peer raylet address, or
        None to keep the task here.  The hybrid policy would keep every
        task here while this node's view still shows it free, which a
        burst submitted before the first dispatch always sees."""
        nodes = [(self.node_id.binary(), None, self.resources_available, self.resources_total)]
        nodes += [(nb, view["raylet_address"], view.get("available", {}), view.get("total", {}))
                  for nb, view in sorted(self.cluster_view.items())]
        feasible = [n for n in nodes if res.fits_in(n[3])]
        candidates = [n for n in feasible if res.fits_in(n[2])] or feasible
        if not candidates:
            return None
        pick = candidates[self._spread_next % len(candidates)]
        self._spread_next += 1
        return pick[1]

    async def _forward_task(self, spec: TaskSpec, address: str):
        try:
            client = await self._peer(address)
            await client.call("submit_task", {"spec": spec, "spilled": True})
        except rpc.RpcError:
            # Peer vanished: schedule locally/queue.
            self._enqueue_local(spec)
            self._schedule_dispatch()

    async def _peer(self, address: str) -> rpc.AsyncRpcClient:
        client = self.peer_clients.get(address)
        if client is None or not client._connected:
            client = rpc.AsyncRpcClient(address, peer_name="raylet")
            await client.connect()
            self.peer_clients[address] = client
        return client

    def _schedule_dispatch(self):
        if not self._dispatch_scheduled:
            self._dispatch_scheduled = True
            self.loop.call_soon(self._dispatch)

    def _task_resources(self, spec: TaskSpec) -> ResourceSet:
        return spec.resources

    def _bundle_key(self, spec: TaskSpec) -> Optional[Tuple[bytes, int]]:
        s = spec.scheduling_strategy
        if s.kind == "PLACEMENT_GROUP" and s.placement_group_id is not None:
            return (s.placement_group_id.binary(), max(s.bundle_index, 0))
        return None

    def _try_acquire(self, spec: TaskSpec) -> bool:
        res = self._task_resources(spec)
        bk = self._bundle_key(spec)
        if bk is not None:
            bundle = self.bundles.get(bk)
            if bundle is None or not bundle["committed"]:
                return False
            if not res.fits_in(bundle["available"]):
                return False
            bundle["available"].subtract(res)
            return True
        if not res.fits_in(self.resources_available):
            return False
        self.resources_available.subtract(res)
        return True

    def _release_task_resources(self, spec: TaskSpec):
        res = self._task_resources(spec)
        bk = self._bundle_key(spec)
        if bk is not None:
            bundle = self.bundles.get(bk)
            if bundle is not None:
                bundle["available"].add(res)
            return
        self.resources_available.add(res)

    def _release_resources(self, w: WorkerHandle):
        if w.lease_blocked:
            # The lease's resources were already returned to the pool when
            # the worker reported blocked — don't double-release.
            w.resources_held = ResourceSet()
            w.lease_blocked = False
            return
        if not w.resources_held:
            return
        if w.bundle_key is not None:
            b = self.bundles.get(w.bundle_key)
            if b is not None:
                b["available"].add(w.resources_held)
        else:
            self.resources_available.add(w.resources_held)
        w.resources_held = ResourceSet()

    def _dispatch(self):
        """Local dispatch loop (reference: local_task_manager.cc:74)."""
        self._dispatch_scheduled = False
        if self._stopping:
            return
        self._grant_lease_waiters()
        remaining = deque()
        if len(self.queue) > 1 and len(self.job_configs) > 1:
            # Multiple jobs queued: apply tenant-fair ordering (a single
            # job's queue is already (priority, FIFO) by construction).
            self.queue = self._fair_queue_order(self.queue)
        while self.queue:
            spec = self.queue.popleft()
            if not self._locally_feasible(spec):
                # Can never run here: spill or park as infeasible.
                target = self._cluster_decision(spec)
                if target is not None:
                    self.loop.create_task(self._forward_task(spec, target))
                else:
                    self.infeasible.append(spec)
                continue
            eh = runtime_env_mod.spec_env_hash(spec)
            bad = self.bad_runtime_envs.get(eh)
            if bad is not None:
                if time.monotonic() - bad[1] < CONFIG.runtime_env_error_ttl_s:
                    from ray_tpu_torch import exceptions

                    self._fail_spec_with_error(
                        spec,
                        exceptions.RuntimeEnvSetupError(
                            f"runtime_env setup failed: {bad[0]}"
                        ),
                    )
                    continue
                self.bad_runtime_envs.pop(eh, None)
            if not self._try_acquire(spec):
                remaining.append(spec)
                continue
            w = self._pop_idle_worker(spec.job_id, eh)
            if w is None:
                self._release_task_resources(spec)
                remaining.append(spec)
                # Make sure a worker with the right (job, env) is coming —
                # a worker starting for a *different* env can never serve
                # this task, so it must not suppress the spawn.
                # exclude_reserved: a STARTING worker claimed by a lease
                # request will be LEASED on registration and never serve
                # this queue — it must not suppress the spawn.
                if not self._worker_starting_for(spec.job_id, eh, exclude_reserved=True):
                    self._spawn_worker(spec.job_id, runtime_env=spec.runtime_env)
                continue
            self._push_task_to_worker(w, spec)
        self.queue = remaining

    def _worker_starting_for(
        self, job_id: JobID, env_hash: str, exclude_reserved: bool = False
    ) -> Optional["WorkerHandle"]:
        """The single STARTING-worker-matching predicate shared by the
        dispatch loop (spawn suppression) and the lease path (reuse).
        Returns a matching worker (truthy) or None."""
        for w in self.workers.values():
            if (
                w.state == "STARTING"
                and w.actor_id is None  # dedicated actor workers don't count
                and w.job_id == job_id
                and w.env_hash == env_hash
                and not (exclude_reserved and w.reserved)
            ):
                return w
        return None

    def _locally_feasible(self, spec: TaskSpec) -> bool:
        bk = self._bundle_key(spec)
        if bk is not None:
            return bk in self.bundles
        return self._task_resources(spec).fits_in(self.resources_total)

    def _pop_idle_worker(self, job_id: JobID, env_hash: str = "") -> Optional[WorkerHandle]:
        dq = self.idle_workers.get((job_id, env_hash))
        while dq:
            w = dq.popleft()
            if w.state == "IDLE" and w.conn is not None and not w.conn.closed:
                return w
        return None

    def _push_task_to_worker(self, w: WorkerHandle, spec: TaskSpec):
        if spec.job_id != w.job_id:
            # Tenant/job isolation invariant: a worker process only ever
            # executes its own job's code (the idle pools are keyed by
            # (job, env) so this cannot happen structurally — this guard
            # keeps a future pooling bug from becoming a cross-tenant
            # code-execution hole instead of an error).
            from ray_tpu_torch import exceptions

            logger.error(
                "isolation violation blocked: task %s of job %s routed to "
                "worker %s of job %s", spec.name, spec.job_id.hex()[:8],
                w.worker_id.hex()[:12], w.job_id.hex()[:8],
            )
            self._fail_spec_with_error(
                spec,
                exceptions.RaySystemError(
                    f"scheduler isolation violation: task {spec.name} routed "
                    "to a worker of another job"
                ),
            )
            return
        w.state = "BUSY" if w.actor_id is None else "ACTOR"
        w.running[spec.task_id.binary()] = spec
        w.resources_held.add(self._task_resources(spec)) if w.actor_id is None else None
        self.num_tasks_dispatched += 1
        queued_at = getattr(spec, "queued_at", None)
        if queued_at is not None:
            telemetry.observe_task_phase("queue", time.monotonic() - queued_at)
        w.conn.push("execute_task", {"spec": spec})

    async def rpc_task_done(self, payload, conn):
        """Worker finished a task (success or user exception — either way
        the results are already in the store)."""
        worker_id = conn.meta.get("worker_id")
        w = self.workers.get(worker_id) if worker_id else None
        if w is None:
            return False
        spec = w.running.pop(payload["task_id"], None)
        # A non-force cancel that lost the race with completion leaves its
        # entry behind; prune here so the set doesn't grow forever.
        self.cancelled_tasks.discard(payload["task_id"])
        if spec is not None and w.actor_id is None:
            self._release_task_resources(spec)
            w.resources_held.subtract(self._task_resources(spec))
        if w.actor_id is None and w.state != "DEAD":
            w.state = "IDLE"
            w.idle_since = time.monotonic()
            self.idle_workers[(w.job_id, w.env_hash)].append(w)
        self._schedule_dispatch()
        return True

    # ------------------------------------------------------------------
    # multi-tenant accounting (tenants.py holds the DRF/quota math)
    # ------------------------------------------------------------------
    def _local_tenant_usage(self) -> Dict[str, dict]:
        """Resources held on this node per tenant: PG reservations (by
        the reserving tenant) plus non-bundle worker holds (leases,
        actor workers, dispatch-path tasks).  Bundle-hosted workers hold
        bundle resources already counted by the reservation."""
        usage: Dict[str, dict] = {}
        for b in self.bundles.values():
            tenants_mod.add_usage(
                usage,
                b.get("tenant", tenants_mod.DEFAULT_TENANT),
                dict(b["reserved"]),
            )
        for w in self.workers.values():
            if (
                w.bundle_key is None
                and w.resources_held
                and not w.lease_blocked
                and w.state != "DEAD"
            ):
                tenants_mod.add_usage(usage, w.tenant, dict(w.resources_held))
        for tenant, res in self._inflight_lease_usage.items():
            if res:
                tenants_mod.add_usage(usage, tenant, dict(res))
        return usage

    def _charge_inflight_lease(self, tenant: str, res: ResourceSet):
        self._inflight_lease_usage.setdefault(tenant, ResourceSet()).add(res)

    def _tenant_quota_registered(self, tenant: str) -> bool:
        spec = self.tenant_specs.get(tenant)
        return bool(
            CONFIG.tenant_quota_enforcement and spec is not None and spec.quota
        )

    async def _gcs_confirm_lease(self, tenant: str, res: ResourceSet) -> bool:
        """Charge-at-admission: atomic check-and-charge against the GCS
        lease-admission ledger BEFORE granting a quota'd tenant's lease.
        The GCS loop serializes concurrent raylets' grants, closing the
        ~1 s cross-raylet over-admission window the cooperative-
        revocation path existed to mop up (reconcile: the charge drops
        when this node's next resource_report carries the lease).  GCS
        trouble → optimistic True: availability over strictness, and
        reconciliation/revocation still bound any excess."""
        try:
            out = await self.gcs.call(
                "tenant_charge_lease",
                {
                    "node_id": self.node_id.binary(),
                    "incarnation": self.incarnation,
                    "tenant": tenant,
                    "resources": dict(res),
                    "check": True,
                },
                timeout=2,
            )
            return bool(out.get("ok", True)) if isinstance(out, dict) else True
        except NodeFencedError:
            # This incarnation was declared dead behind a partition: the
            # optimistic-True fallback would admit work the GCS already
            # restarted elsewhere.  Refuse the grant and tear down.
            self._on_fenced()
            return False
        except Exception:  # noqa: BLE001 — reconcile/revocation mop up
            return True

    def _release_inflight_lease(self, tenant: str, res: ResourceSet):
        held = self._inflight_lease_usage.get(tenant)
        if held is not None:
            held.subtract(res)
            if not any(v > 1e-9 for v in held.values()):
                self._inflight_lease_usage.pop(tenant, None)

    def _effective_tenant_usage(self) -> Dict[str, dict]:
        """Cluster-wide per-tenant usage for fair-share/quota decisions:
        the GCS-published aggregate with this node's (stale) contribution
        replaced by live local truth, so a grant made here is visible to
        the next decision immediately instead of one publish later."""
        local = self._local_tenant_usage()
        if not self.cluster_tenant_usage:
            return local
        eff = {t: dict(r) for t, r in self.cluster_tenant_usage.items()}
        for t, r in self._published_tenant_usage.items():
            acc = eff.setdefault(t, {})
            for k, v in r.items():
                acc[k] = acc.get(k, 0.0) - v
        for t, r in local.items():
            tenants_mod.add_usage(eff, t, r)
        return eff

    def _cluster_totals_view(self) -> Dict[str, float]:
        """Fallback totals when no tenant_usage publish has arrived yet
        (fresh cluster): this node + the resource-view peers."""
        totals = dict(self.resources_total)
        for view in self.cluster_view.values():
            for k, v in (view.get("total") or {}).items():
                totals[k] = totals.get(k, 0.0) + v
        return totals

    def _tenant_over_quota(self, tenant: str, res: ResourceSet) -> bool:
        if not CONFIG.tenant_quota_enforcement:
            return False
        spec = self.tenant_specs.get(tenant)
        if spec is None or not spec.quota:
            return False
        return tenants_mod.over_quota(
            self._effective_tenant_usage().get(tenant), res, spec.quota
        )

    def _tenant_label(self, tenant: str) -> str:
        return tenants_mod.tenant_label(tenant, self.tenant_specs)

    def _reconcile_tenant_quotas(self):
        """Self-correction for the distributed lease race: two raylets
        granting from views a publish apart can transiently over-admit a
        tenant, and a busy lease never idles out — so a tenant over its
        quota gets cooperative revoke_lease pushes (newest lease first)
        until the excess is covered.  The submitter drains the lease
        (in-flight tasks finish) and returns it; replacement demand
        re-parks under the quota gate."""
        if not CONFIG.tenant_quota_enforcement or not self.tenant_specs:
            return
        # Phase-stagger across nodes: every raylet sees the SAME
        # cluster-wide excess, so acting simultaneously would revoke it
        # once per node.  A deterministic per-node phase over 3 reconcile
        # ticks lets the first actor's revocation propagate (publish
        # cadence < tick) before the others re-check — residual
        # over-revocation is bounded to the nodes sharing a phase.
        if (self._reconcile_tick // 5) % 3 != self.node_id.binary()[0] % 3:
            return
        usage = self._effective_tenant_usage()
        for tenant, spec in self.tenant_specs.items():
            if not spec.quota or not tenants_mod.over_quota(
                usage.get(tenant), None, spec.quota
            ):
                continue
            used = usage.get(tenant) or {}
            over = {
                r: used.get(r, 0.0) - cap
                for r, cap in spec.quota.items()
                if used.get(r, 0.0) > cap + 1e-9
            }
            leased = [
                w
                for w in self.workers.values()
                if w.state == "LEASED"
                and w.tenant == tenant
                and w.worker_id not in self._revoked_leases
                and w.lease_owner is not None
                and not w.lease_owner.closed
            ]
            # Newest first: the most recently granted lease has the least
            # sunk warmth to lose.  At most ONE revocation per tenant per
            # tick: every raylet sees the same cluster-wide excess, so an
            # uncoordinated "cover it all" would revoke it N times over —
            # the 1/tick damper converges in a few ticks without the
            # revoke/re-grant churn.
            leased.sort(key=lambda w: -w.spawn_time)
            for w in leased:
                if not any(
                    w.resources_held.get(r, 0.0) > 0 and v > 0
                    for r, v in over.items()
                ):
                    continue
                try:
                    w.lease_owner.push(
                        "revoke_lease", {"worker_id": w.worker_id.binary()}
                    )
                except Exception:
                    continue
                logger.info(
                    "quota reconciliation: revoking lease %s of tenant %r",
                    w.worker_id.hex()[:12], tenant,
                )
                self._revoked_leases.add(w.worker_id)
                break

    # ------------------------------------------------------------------
    # worker leases — direct task submission (reference:
    # normal_task_submitter.cc:295 RequestNewWorkerIfNeeded → raylet
    # HandleRequestWorkerLease; the submitter then pushes task specs
    # straight to the leased worker)
    # ------------------------------------------------------------------
    async def rpc_request_worker_lease(self, payload, conn):
        token = payload.get("token")
        if token is None:
            return await self._request_worker_lease_inner(payload, conn)
        # Idempotency: a duplicated delivery joins the original grant's
        # future instead of leasing a second worker that nobody would
        # ever use or return.
        ent = self._lease_grants.get(token)
        if ent is not None:
            return await asyncio.shield(ent[0])
        fut = self.loop.create_future()
        # Grants must outlive the submitter's full retry horizon (up to
        # retry.SUBMIT.max_attempts lease-timeout-bounded attempts) —
        # expiring earlier would let a late retry miss the table and
        # lease a second worker, leaking the first grant LEASED forever.
        # Expired entries are swept by _idle_reaper_loop (one periodic
        # pass, not one call_later timer per lease request).
        horizon = (
            CONFIG.worker_lease_timeout_ms / 1000
            * (retry.SUBMIT.max_attempts or 1)
            + 60
        )
        self._lease_grants[token] = (fut, time.monotonic() + horizon)
        try:
            reply = await self._request_worker_lease_inner(payload, conn)
            if not fut.done():
                fut.set_result(reply)
            return reply
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # consumed: a lone dup must not warn
            raise

    async def _request_worker_lease_inner(self, payload, conn):
        res = ResourceSet.of(payload["resources"])
        job_id = JobID(payload["job_id"])
        tenant = tenants_mod.normalize_tenant(payload.get("tenant"))
        priority = int(payload.get("priority") or 0)
        if self.draining:
            # A draining node grants no new leases (reference: raylet
            # lease rejection while draining): point the submitter at a
            # live peer, or reject outright so it re-asks elsewhere.
            target = self._spill_target(res) if not payload.get("spilled") else None
            return {"spill": target, "draining": True} if target else {"draining": True}
        lease_env = payload.get("runtime_env")
        lease_env_hash = runtime_env_mod.env_hash(lease_env)
        bad = self.bad_runtime_envs.get(lease_env_hash)
        if bad is not None:
            if time.monotonic() - bad[1] < CONFIG.runtime_env_error_ttl_s:
                return {"runtime_env_error": bad[0]}
            self.bad_runtime_envs.pop(lease_env_hash, None)
        allow_spill = not payload.get("spilled", False)
        if not res.fits_in(self.resources_total):
            target = self._spill_target(res) if allow_spill else None
            if target is None:
                # nowhere in the cluster fits this shape: ledger it so
                # the heartbeat surfaces the demand to the autoscaler
                sig = tuple(sorted(dict(res).items()))
                self._unmet_lease_demand[sig] = (res.copy(), time.monotonic())
            return {"spill": target} if target else None
        # The whole grant (park + spawn) must finish inside the client's
        # call timeout, or the reply lands on a request the client already
        # abandoned and the LEASED worker leaks until its conn closes.
        deadline = time.monotonic() + CONFIG.worker_lease_timeout_ms / 1000 - 5
        # Fairness: an incoming request may not jump ahead of parked
        # waiters even if it happens to fit right now — the fair-share
        # grant loop decides who goes next (weighted DRF across tenants,
        # priority then FIFO within one).  A request whose tenant is
        # over its registered quota parks too (backpressure: it waits
        # for usage to fall, it doesn't fail), and never spills — the
        # quota is cluster-wide, so another node can't grant it either.
        over_quota = self._tenant_over_quota(tenant, res)
        if (
            not over_quota
            and not self.lease_waiters
            and res.fits_in(self.resources_available)
            and self._tenant_quota_registered(tenant)
        ):
            # About to grant a quota'd tenant: authoritative check-and-
            # charge at the GCS ledger first (the await is an
            # interleaving point — every grant condition is re-checked
            # below; a charge stranded by a lost race reconciles away on
            # the next report).
            if not await self._gcs_confirm_lease(tenant, res):
                over_quota = True
        if self.lease_waiters or over_quota or not res.fits_in(self.resources_available):
            if (
                allow_spill
                and not over_quota
                and not res.fits_in(self.resources_available)
            ):
                target = self._spill_target(res)
                if target is not None:
                    return {"spill": target}
            # Park until resources free up (event-driven, fair-share).
            fut = self.loop.create_future()
            self._lease_seq += 1
            waiter = tenants_mod.LeaseWaiter(
                res=res, fut=fut, tenant=tenant, priority=priority,
                seq=self._lease_seq,
            )
            self.lease_waiters.append(waiter)
            telemetry.count_tenant_parked(
                self._tenant_label(tenant),
                "quota" if over_quota else "fair_share",
            )
            self._grant_lease_waiters()  # may grant immediately (first in line)
            # A SPILLED request parks only briefly: it was sent here
            # because capacity looked available — if that's gone, bounce
            # it back to the submitter quickly so the demand re-enters
            # the HOME raylet's fair queue instead of sitting in a
            # remote queue for the whole client timeout (a tenant's
            # entire in-flight demand parked remotely would otherwise
            # starve it of capacity freeing up elsewhere).
            park_budget = (
                min(2.0, max(0.5, deadline - time.monotonic()))
                if payload.get("spilled")
                else max(1.0, deadline - time.monotonic())
            )
            try:
                verdict = await asyncio.wait_for(fut, park_budget)
                if verdict is not True:
                    # Drain flush woke us without granting (no resources
                    # were debited): send the submitter elsewhere.
                    target = self._spill_target(res)
                    return {"spill": target, "draining": True} if target else None
            except asyncio.TimeoutError:
                # wait_for cancelled the future, so it can never have been
                # granted (a granted future makes wait_for return instead):
                # no resources were debited for it; just drop the entry.
                try:
                    self.lease_waiters.remove(waiter)
                except ValueError:
                    pass  # already swept by _grant_lease_waiters' done-check
                return None
        else:
            self.resources_available.subtract(res)
            self._charge_inflight_lease(tenant, res)
        # Resources are debited from here on: ANY exit that doesn't grant
        # must re-credit them or the node's capacity leaks.
        granted = False
        try:
            # Find or spawn a worker with a direct endpoint.
            w = self._pop_idle_worker_for_lease(job_id, lease_env_hash)
            if w is None:
                # Reuse a worker already STARTING for this (job, env) —
                # during slow runtime_env staging (pip install) each ~30s
                # lease retry would otherwise spawn another duplicate that
                # just queues behind the same staging flock.
                w = self._worker_starting_for(
                    job_id, lease_env_hash, exclude_reserved=True
                )
            if w is None:
                w = self._spawn_worker(job_id, runtime_env=lease_env)
            w.reserved = True  # keep dispatch + concurrent grants off it
            try:
                ok = await self._wait_worker_ready(w, deadline)
            finally:
                w.reserved = False
            if not ok:
                bad = self.bad_runtime_envs.get(lease_env_hash)
                if bad is not None:
                    return {"runtime_env_error": bad[0]}
            if not ok or conn.closed:
                if ok:  # requester vanished: put the worker back
                    w.state = "IDLE"
                    w.idle_since = time.monotonic()
                    self.idle_workers[(w.job_id, w.env_hash)].append(w)
                return None
            w.state = "LEASED"
            w.resources_held = res.copy()
            w.tenant = tenant
            w.lease_owner = conn
            w.lease_blocked = False
            granted = True
            return {"worker_id": w.worker_id.binary(), "address": w.direct_address}
        finally:
            # The grant is no longer in flight: either it's now visible
            # as the worker's resources_held (granted, set in the same
            # event-loop tick) or the resources go back to the pool.
            self._release_inflight_lease(tenant, res)
            if not granted:
                self.resources_available.add(res)
                self._grant_lease_waiters()
                self._schedule_dispatch()

    def _spill_target(self, res: ResourceSet) -> Optional[str]:
        best, best_avail = None, -1.0
        for nb, view in self.cluster_view.items():
            avail = view.get("available", {})
            if all(avail.get(k, 0.0) + 1e-9 >= v for k, v in res.items()):
                score = sum(avail.values())
                if score > best_avail:
                    best_avail = score
                    best = view["raylet_address"]
        return best

    def _pop_idle_worker_for_lease(
        self, job_id: JobID, env_hash: str = ""
    ) -> Optional["WorkerHandle"]:
        dq = self.idle_workers.get((job_id, env_hash))
        found = None
        rejected = []
        while dq:
            w = dq.popleft()
            if w.state != "IDLE" or w.conn is None or w.conn.closed:
                continue  # dead entry, drop
            if w.direct_address:
                found = w
                break
            # Live worker without a direct endpoint: unusable for leases
            # but still fine for raylet-mediated dispatch — keep it.
            rejected.append(w)
        for w in rejected:
            dq.append(w)
        return found

    async def _wait_worker_ready(self, w: "WorkerHandle", deadline: float = None) -> bool:
        if deadline is None:
            deadline = time.monotonic() + CONFIG.worker_lease_timeout_ms / 1000
        while w.conn is None or w.direct_address is None:
            if w.state == "DEAD" or (w.proc is not None and w.proc.poll() is not None):
                self._kill_worker_proc(w)
                return False
            if time.monotonic() > deadline:
                # Deadline expired but the worker process is alive: it is
                # still staging its runtime env (pip install can take
                # minutes).  Do NOT kill it — it will join the idle pool
                # when it registers and the requester's retry picks it up.
                # Truly wedged STARTING workers are reaped by age in
                # _idle_reaper_loop.
                return False
            await asyncio.sleep(0.005)
        # The pool may have routed the freshly-registered worker to the
        # idle queue; claim it.
        for dq in self.idle_workers.values():
            if w in dq:
                dq.remove(w)
        return True

    def _grant_lease_waiters(self):
        """Serve parked lease requests in weighted-DRF fair-share order
        (tenants.pick_next): per tenant only its best (priority, FIFO)
        waiter is a candidate — no intra-tenant queue-jumping, so small
        requests can't starve a parked large one — tenants go ascending
        dominant share, over-quota tenants are skipped (their waiters
        stay parked: backpressure, not failure), and an unfittable head
        doesn't block OTHER tenants (work conservation)."""
        if self.draining:
            return  # push_drain flushes the queue; no new grants
        if not self.lease_waiters:
            return
        # Sweep abandoned entries (timed-out requesters).
        self.lease_waiters = deque(
            w for w in self.lease_waiters if not w.fut.done()
        )
        usage = self._effective_tenant_usage()
        totals = self.cluster_resource_totals or self._cluster_totals_view()
        now = time.monotonic()
        while self.lease_waiters:
            w = tenants_mod.pick_next(
                self.lease_waiters,
                self.resources_available,
                usage,
                totals,
                self.tenant_specs,
                enforce_quota=bool(CONFIG.tenant_quota_enforcement),
            )
            if w is None:
                break
            self.lease_waiters.remove(w)
            self.resources_available.subtract(w.res)
            # Count the grant as in-flight until the requester's worker
            # is LEASED (or the grant unwinds) so concurrent quota
            # checks see it; update the working view so a batch of
            # grants in one pass stays fair too.
            self._charge_inflight_lease(w.tenant, w.res)
            tenants_mod.add_usage(usage, w.tenant, dict(w.res))
            telemetry.observe_tenant_lease_wait(
                self._tenant_label(w.tenant), now - w.enqueued
            )
            if self._tenant_quota_registered(w.tenant):
                # resources stay debited while the GCS ledger confirms;
                # a denial unwinds and re-parks under the quota gate
                self.loop.create_task(self._confirm_grant_waiter(w))
            else:
                w.fut.set_result(True)

    async def _confirm_grant_waiter(self, w) -> None:
        """Finish a fair-queue grant for a quota'd tenant: atomic
        check-and-charge at the GCS lease-admission ledger, then release
        the waiter.  Denied → unwind the local debit and re-park the
        waiter (backpressure, not failure — exactly the over-quota park
        semantics of the request path)."""
        ok = await self._gcs_confirm_lease(w.tenant, w.res)
        if ok and not w.fut.done():
            w.fut.set_result(True)
            return
        # denied, or the requester abandoned the wait: unwind
        self.resources_available.add(w.res)
        self._release_inflight_lease(w.tenant, w.res)
        if not ok and not w.fut.done():
            self.lease_waiters.append(w)
            telemetry.count_tenant_parked(self._tenant_label(w.tenant), "quota")
            # Denial means the GCS ledger is ahead of our published
            # usage view: re-running the grant loop NOW would re-pick
            # the same waiter and busy-loop deny RPCs until the publish
            # lands — give it one publish interval.
            self.loop.call_later(0.25, self._grant_lease_waiters)
            return
        self._grant_lease_waiters()

    async def push_return_worker_lease(self, payload, conn):
        w = self.workers.get(WorkerID(payload["worker_id"]))
        self._revoked_leases.discard(WorkerID(payload["worker_id"]))
        if w is None or w.state != "LEASED":
            return
        w.lease_owner = None
        self._release_resources(w)  # handles the lease_blocked case itself
        w.state = "IDLE"
        w.idle_since = time.monotonic()
        self.idle_workers[(w.job_id, w.env_hash)].append(w)
        self._grant_lease_waiters()
        self._schedule_dispatch()

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    async def rpc_create_actor(self, payload, conn):
        """From GCS: spawn a dedicated worker and run the creation task."""
        spec: TaskSpec = payload["spec"]
        res = spec.resources
        if self.draining:
            # The GCS treats this as transient and re-schedules the actor
            # on a live node (its view may lag the drain by one tick).
            raise RuntimeError("node is draining; retry actor creation elsewhere")
        # Spawn flow control FIRST — before any resources are reserved,
        # so a parked creation can't block task leases on the node.  A
        # creation burst (many actors at once) must not fork more
        # interpreters than the MACHINE can register within the lease
        # window; the gate is host-wide (flock token pool shared across
        # every raylet of the session — see spawn_gate.py) so packed
        # test topologies don't multiply the cap, while a single
        # raylet's small population still starts fully concurrently.
        # FIFO tickets (like _grant_lease_waiters) keep this raylet's
        # creations starvation-free; bounded wait — on timeout the GCS
        # re-queues the actor and retries (_schedule_actor's handler).
        my_ticket = self._spawn_ticket_next
        self._spawn_ticket_next += 1
        deadline = time.monotonic() + CONFIG.worker_lease_timeout_ms / 1000
        if self._spawn_gate_event is None:
            self._spawn_gate_event = asyncio.Event()
        spawn_token = None
        try:
            while True:
                # skip over tickets whose waiters gave up or were
                # cancelled, so a dead waiter can't wedge the queue
                while self._spawn_ticket_serving in self._spawn_tickets_abandoned:
                    self._spawn_tickets_abandoned.discard(self._spawn_ticket_serving)
                    self._spawn_ticket_serving += 1
                if my_ticket == self._spawn_ticket_serving:
                    spawn_token = self._spawn_gate.try_acquire()
                    if spawn_token is not None:
                        break
                if time.monotonic() > deadline:
                    raise RuntimeError("spawn gate saturated; retry actor creation")
                # woken when a worker leaves STARTING on THIS raylet (or
                # a turn advances); the timeout also re-polls the
                # host-wide pool for slots freed by other raylets
                self._spawn_gate_event.clear()
                try:
                    await asyncio.wait_for(self._spawn_gate_event.wait(), timeout=0.2)
                except asyncio.TimeoutError:
                    pass
        except BaseException:
            self._spawn_tickets_abandoned.add(my_ticket)
            self._kick_spawn_gate()
            raise
        self._spawn_ticket_serving += 1
        self._kick_spawn_gate()
        # From here until the token is parked on the worker handle, ANY
        # raise must release it — the GCS retries these errors, and each
        # retry would otherwise leak one host-wide slot until the pool
        # drains and every creation on the machine wedges.
        try:
            bk = self._bundle_key(spec)
            if bk is not None:
                bundle = self.bundles.get(bk)
                if bundle is None or not bundle["committed"] or not res.fits_in(bundle["available"]):
                    raise RuntimeError("placement group bundle cannot host actor")
                bundle["available"].subtract(res)
            else:
                if not res.fits_in(self.resources_available):
                    raise RuntimeError("insufficient resources for actor")
                self.resources_available.subtract(res)
            w = self._spawn_worker(
                spec.job_id, actor_id=spec.actor_id, runtime_env=spec.runtime_env
            )
        except BaseException:
            from ray_tpu_torch._private.spawn_gate import HostSpawnGate

            HostSpawnGate.release(spawn_token)
            raise
        w.spawn_token = spawn_token  # released when it leaves STARTING
        w.resources_held = res.copy()
        w.tenant = tenants_mod.normalize_tenant(payload.get("tenant"))
        w.detached = bool(spec.detached)
        w.bundle_key = bk
        self.actor_workers[spec.actor_id] = w
        # Wait for the worker to register.
        deadline = time.monotonic() + CONFIG.worker_lease_timeout_ms / 1000
        while w.conn is None:
            if time.monotonic() > deadline or w.proc.poll() is not None:
                self._kill_worker_proc(w)
                bad = self.bad_runtime_envs.get(w.env_hash)
                if bad is not None:
                    from ray_tpu_torch import exceptions

                    raise exceptions.RuntimeEnvSetupError(
                        f"runtime_env setup failed: {bad[0]}"
                    )
                raise RuntimeError("actor worker failed to start")
            await asyncio.sleep(0.01)
        self._push_task_to_worker(w, spec)
        # Wait for creation task to finish (success = __init__ ran).
        while spec.task_id.binary() in w.running:
            if w.state == "DEAD":
                raise RuntimeError("actor worker died during creation")
            await asyncio.sleep(0.005)
        # Creation errors are reported via the return object; check it.
        ret = spec.return_ids()[0]
        meta = self.store.get_meta(ret)
        if meta is not None:
            data = self.store.read_bytes(ret)
            if data is not None and data[0] == serialization.TAG_ERROR:
                raise RuntimeError("actor __init__ raised; see creation task return")
        return {"pid": w.pid, "worker_address": w.direct_address}

    def _submit_actor_task(self, spec: TaskSpec):
        w = self.actor_workers.get(spec.actor_id)
        if w is None or w.state == "DEAD" or w.conn is None or w.conn.closed:
            from ray_tpu_torch import exceptions

            err = exceptions.RayActorError(f"Actor {spec.actor_id.hex()[:8]} is not on this node or died")
            blob = serialization.serialize_to_bytes(err, tag=serialization.TAG_ERROR)
            for oid in spec.return_ids():
                self.store.create_from_bytes(oid, blob)
            return False
        w.running[spec.task_id.binary()] = spec
        w.conn.push("execute_task", {"spec": spec})
        return True

    def _kill_actor_local(self, actor_id: ActorID, intended: bool):
        w = self.actor_workers.get(actor_id)
        if w is None:
            return
        # Push a graceful exit; escalate with SIGKILL shortly after.
        if w.conn is not None and not w.conn.closed:
            w.conn.push("exit", {"reason": "ray.kill"})

        def _hard_kill():
            if w.proc is not None and w.proc.poll() is None:
                try:
                    os.kill(w.pid, signal.SIGKILL)
                except OSError:
                    pass

        self.loop.call_later(2.0, _hard_kill)

    # ------------------------------------------------------------------
    # placement group bundles (reference: placement_group_resource_manager.h)
    # ------------------------------------------------------------------
    async def rpc_prepare_bundle(self, payload, conn):
        key = (payload["pg_id"], payload["bundle_index"])
        res = ResourceSet.of(payload["resources"])
        if key in self.bundles:
            return True
        if self.draining:
            return False  # no new reservations on a node about to vanish
        if not res.fits_in(self.resources_available):
            return False
        self.resources_available.subtract(res)
        self.bundles[key] = {
            "reserved": res,
            "available": res.copy(),
            "committed": False,
            # Reservation charges the creating job's tenant (quota +
            # fair-share accounting rides the tenant_usage report).
            "tenant": tenants_mod.normalize_tenant(payload.get("tenant")),
        }
        return True

    async def rpc_commit_bundle(self, payload, conn):
        key = (payload["pg_id"], payload["bundle_index"])
        b = self.bundles.get(key)
        if b is None:
            return False
        b["committed"] = True
        self._schedule_dispatch()
        return True

    async def rpc_return_bundle(self, payload, conn):
        key = (payload["pg_id"], payload["bundle_index"])
        b = self.bundles.pop(key, None)
        if b is not None:
            self.resources_available.add(b["reserved"])
        self._schedule_dispatch()
        return True

    # ------------------------------------------------------------------
    # object store RPCs
    # ------------------------------------------------------------------
    def _on_object_sealed(self, object_id: ObjectID):
        if self.gcs is not None and self.gcs._connected:
            key = object_id.binary()
            # The returned task is kept so the seal RPC handlers can await
            # the GCS ack before replying: a ref must not escape this node
            # (e.g. in a direct worker->driver task result) before the GCS
            # knows the object exists, or losing the node makes
            # object_lost_check report "never sealed" and the borrower's
            # get hangs to timeout instead of raising ObjectLostError.
            task = self._push_location_ordered(key, "object_location_add")
            self._seal_reports[key] = task
            task.add_done_callback(lambda _t, k=key: self._seal_reports.pop(k, None))

    def _on_object_evicted(self, object_id: ObjectID):
        if self.gcs is not None and self.gcs._connected:
            self._push_location_ordered(object_id.binary(), "object_location_remove")

    def _push_location_ordered(self, key: bytes, method: str) -> asyncio.Task:
        """Location add/remove pushes for one object are chained so a
        retried add can never land AFTER the remove that followed it
        (seal -> evict must leave the GCS with no location, not a stale
        one)."""
        prev = self._loc_chain.get(key)

        async def run():
            if prev is not None:
                await prev
            await self._safe_gcs_push(
                method, (key, self.node_id.binary(), self.incarnation)
            )

        task = self.loop.create_task(run())
        self._loc_chain[key] = task

        def _cleanup(_t, k=key, me=task):
            if self._loc_chain.get(k) is me:
                del self._loc_chain[k]

        task.add_done_callback(_cleanup)
        return task

    async def _safe_gcs_push(self, method, payload):
        """Best-effort GCS call with bounded retries — object location
        add/remove must survive transient drops (a location report lost
        forever makes a live object look 'never sealed' to lost-object
        checks, wedging cross-node gets)."""
        bo = retry.GCS_PUSH.start()
        while True:
            try:
                await self.gcs.call(method, payload, timeout=10)
                return
            except NodeFencedError:
                # Typed rejection, not a transient drop: retrying a
                # fenced write can never succeed.
                self._on_fenced()
                return
            except rpc.RpcError:
                delay = bo.next_delay()
                if delay is None:
                    return
                await asyncio.sleep(delay)

    async def _await_seal_report(self, oid_bytes: bytes):
        task = self._seal_reports.get(oid_bytes)
        if task is not None:
            # Bounded: during a GCS outage the full retry budget is ~30s
            # and the ack is lost anyway — don't stall every put on the
            # task-result hot path for it (availability over the escape-
            # ordering guarantee while the GCS is down).
            try:
                await asyncio.wait_for(asyncio.shield(task), timeout=10)
            except asyncio.TimeoutError:
                pass

    async def rpc_store_put_inline(self, payload, conn):
        oid_bytes, data = payload
        ok = self.store.put_inline(ObjectID(oid_bytes), data)
        if ok:
            await self._await_seal_report(oid_bytes)
        return ok

    async def push_store_put_inline(self, payload, conn):
        """Fire-and-forget variant used by memory-store → shm promotion."""
        oid_bytes, data = payload
        self.store.put_inline(ObjectID(oid_bytes), data)

    async def rpc_store_seal(self, payload, conn):
        oid_bytes, size = payload
        ok = self.store.seal_file(ObjectID(oid_bytes), size)
        if ok:
            await self._await_seal_report(oid_bytes)
        return ok

    async def rpc_store_contains(self, payload, conn):
        return self.store.contains(ObjectID(payload))

    async def rpc_store_get(self, payload, conn):
        """Get meta for one object, pulling from a remote node if needed.

        Returns {"lost": True} when the object was sealed somewhere once
        but no live copy exists (node death or eviction) — the owner then
        repairs it via lineage reconstruction (reference:
        core_worker/object_recovery_manager.h)."""
        oid_bytes, timeout = payload
        oid = ObjectID(oid_bytes)
        meta = self.store.get_meta(oid)
        if meta is not None:
            return meta
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            pull_fut = self._start_pull(oid)
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            seal_task = asyncio.ensure_future(self.store.wait_sealed(oid, remaining))
            await asyncio.wait({seal_task, pull_fut}, return_when=asyncio.FIRST_COMPLETED)
            if pull_fut.done() and pull_fut.result() == "lost":
                seal_task.cancel()
                return {"lost": True}
            if seal_task.done():
                meta = self.store.get_meta(oid)
                if meta is not None:
                    return meta
                if not seal_task.result():
                    return None  # timed out
                # sealed then evicted between wakeups: retry
            else:
                seal_task.cancel()
            # pull finished (object arrived) or transient: loop re-checks

    async def rpc_store_wait(self, payload, conn):
        oid_bytes_list, num_returns, timeout = payload
        oids = [ObjectID(b) for b in oid_bytes_list]
        deadline = time.monotonic() + timeout if timeout is not None else None

        async def wait_one(oid):
            if not self.store.contains(oid):
                self._start_pull(oid)
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            await self.store.wait_sealed(oid, remaining)
            return oid

        pending = {asyncio.ensure_future(wait_one(o)) for o in oids}
        ready: List[bytes] = []
        try:
            while pending and len(ready) < num_returns:
                remaining = None if deadline is None else max(0.001, deadline - time.monotonic())
                done, pending = await asyncio.wait(
                    pending, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
                )
                for d in done:
                    oid = d.result()
                    if self.store.contains(oid):
                        ready.append(oid.binary())
                if deadline is not None and time.monotonic() >= deadline:
                    break
        finally:
            for p in pending:
                p.cancel()
        return ready

    async def push_store_free(self, payload, conn):
        for oid in payload:
            self.store.delete(ObjectID(oid))

    async def push_kill_actor(self, payload, conn):
        """From GCS over its node client (reference: raylet KillActor rpc)."""
        self._kill_actor_local(ActorID(payload["actor_id"]), intended=True)

    async def push_drain(self, payload, conn):
        """From GCS: this node is draining (preemption notice or idle
        scale-down).  Stop granting leases, reject new reservations, and
        spill queued work; running tasks finish inside the deadline."""
        if self.draining:
            return
        self.draining = True
        self.drain_reason = payload.get("reason")
        self.drain_deadline = payload.get("deadline", 0.0)
        logger.warning(
            "raylet %s draining (%s): rejecting new leases/reservations",
            self.node_id.hex()[:8], self.drain_reason,
        )
        # Parked lease requests can never be granted here anymore — wake
        # them with a non-grant verdict so their submitters re-lease on
        # another node instead of waiting out the lease timeout.
        while self.lease_waiters:
            waiter = self.lease_waiters.popleft()
            if not waiter.fut.done():
                waiter.fut.set_result("draining")
        # Queued tasks re-run the spill decision (now drain-aware).
        self._schedule_dispatch()

    async def push_undrain(self, payload, conn):
        """From GCS: the quarantine that drained this node lifted — the
        node is ALIVE again and must resume granting leases."""
        if not self.draining:
            return
        logger.warning(
            "raylet %s un-drained: resuming lease grants", self.node_id.hex()[:8]
        )
        self.draining = False
        self.drain_reason = None
        self.drain_deadline = 0.0
        self._schedule_dispatch()

    async def push_replicate_objects(self, payload, conn):
        """From GCS during a peer node's drain: pull the listed objects
        here so the cluster keeps a live copy after the draining node
        dies.  Pinned on arrival so eviction can't immediately undo the
        migration (per-job GC still reclaims them at job end)."""
        for oid_bytes in payload.get("oids", ()):
            oid = ObjectID(oid_bytes)
            if self.store.contains(oid):
                self.store.pin(oid)
                continue
            fut = self._start_pull(oid)

            def _pin(_f, o=oid):
                if self.store.contains(o):
                    self.store.pin(o)

            fut.add_done_callback(_pin)

    async def push_job_finished(self, payload, conn):
        self._on_job_finished(JobID(payload))

    async def rpc_store_free(self, payload, conn):
        for oid in payload:
            self.store.delete(ObjectID(oid))
        return True

    async def rpc_store_reserve(self, payload, conn):
        """Client-side arena alloc failed: evict LRU objects to make room
        (reference: plasma create-request queue + eviction policy)."""
        return self.store.reserve(int(payload))

    async def rpc_store_stats(self, payload, conn):
        return self.store.stats()

    # ------------------------------------------------------------------
    # object manager: pull from peers (reference: pull_manager.h:52)
    # ------------------------------------------------------------------
    def _start_pull(self, oid: ObjectID) -> asyncio.Future:
        """Idempotently start pulling `oid`; the returned future resolves
        to "lost" (sealed once, no live copy anywhere) or None (arrived /
        loop retired)."""
        key = oid.binary()
        fut = self.pulls.get(key)
        if fut is not None:
            return fut
        fut = self.loop.create_future()
        self.pulls[key] = fut
        self.loop.create_task(self._pull_loop(oid, fut))
        return fut

    async def _pull_loop(self, oid: ObjectID, fut: asyncio.Future):
        key = oid.binary()
        # Jittered poll: a whole node's waiters re-probing a not-yet-sealed
        # object decorrelate instead of stampeding the GCS in lockstep.
        bo = retry.PULL_PROBE.start()
        try:
            while not self.store.contains(oid):
                try:
                    # One retry only: the surrounding pull loop already
                    # re-asks on its own backoff cadence.
                    locations = await rpc.call_idempotent_async(
                        self.gcs, "object_locations_get", key, timeout=10,
                        policy=retry.GCS_READ_BULK,
                    )
                except rpc.RpcError:
                    locations = []
                pulled = False
                for loc in locations:
                    if loc["node_id"] == self.node_id.binary():
                        continue
                    try:
                        client = await self._peer(loc["raylet_address"])
                        if await self._fetch_from_peer(client, oid):
                            pulled = True
                            break
                    except rpc.RpcError:
                        continue
                if pulled:
                    break
                if not locations:
                    # Nowhere to pull from: either the creating task hasn't
                    # sealed it yet (keep waiting) or every copy is gone
                    # (lost → owner must reconstruct).
                    try:
                        lost = await self.gcs.call("object_lost_check", key, timeout=10)
                    except rpc.RpcError:
                        lost = False
                    if lost:
                        if not fut.done():
                            fut.set_result("lost")
                        return
                await asyncio.sleep(bo.next_delay() or 1.0)
        finally:
            self.pulls.pop(key, None)
            if not fut.done():
                fut.set_result(None)

    async def _fetch_from_peer(self, client: rpc.AsyncRpcClient, oid: ObjectID) -> bool:
        """Pull one object in bounded-parallel chunks (reference:
        push_manager.h:30 chunked parallel transfer).  The first chunk
        reply carries the total size; large objects are written straight
        into a store allocation so no full-object frame ever crosses the
        wire or the event loop."""
        key = oid.binary()
        chunk = int(CONFIG.object_manager_chunk_size)
        first = await client.call("om_fetch_chunk", (key, 0, chunk), timeout=60)
        if first is None:
            return False
        total, data0 = first
        if total <= len(data0):
            return bool(self.store.create_from_bytes(oid, data0)) or self.store.contains(oid)
        writer = self.store.begin_create(oid, total)
        if writer is None:
            # Raced with another pull/seal, or no space even after spill.
            return self.store.contains(oid)
        try:
            writer[: len(data0)] = data0
            sem = asyncio.Semaphore(int(CONFIG.object_manager_max_parallel_chunks))

            async def fetch(off: int):
                async with sem:
                    r = await client.call(
                        "om_fetch_chunk", (key, off, min(chunk, total - off)), timeout=60
                    )
                    if r is None:
                        raise rpc.RpcError(f"peer dropped object {oid.hex()[:12]} mid-pull")
                    writer[off : off + len(r[1])] = r[1]

            await asyncio.gather(*(fetch(off) for off in range(len(data0), total, chunk)))
        except Exception:
            del writer
            self.store.abort_create(oid)
            return False
        del writer
        self.store.commit_create(oid, total)
        return True

    async def rpc_om_fetch_chunk(self, payload, conn):
        """Peer raylet requests an object byte range; reply is
        (total_size, bytes) so the first chunk also conveys the size."""
        oid_bytes, offset, length = payload
        return self.store.read_chunk(ObjectID(oid_bytes), offset, length)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    async def _event_loop_lag_loop(self):
        """Sample the event loop's scheduling lag (reference: per-event-
        loop stats in src/ray/stats; shared impl in common.py)."""
        from ray_tpu_torch._private.common import event_loop_lag_loop

        await event_loop_lag_loop(self, self.loop, stop_pred=lambda: self._stopping)

    def _telemetry_channel(self, method: str, payload: dict):
        """Report delivery for util.metrics/tracing flusher threads: hop
        onto the raylet loop and through its GCS client.  Fails fast
        when the loop is stopped/stopping — the atexit flush must not
        park a coroutine on a dead loop and stall raylet shutdown."""
        gcs = self.gcs
        if (
            gcs is None
            or not gcs._connected
            or self._stopping
            or not self.loop.is_running()
        ):
            raise rpc.ConnectionLost("gcs not reachable for telemetry report")
        payload = self._stamped(dict(payload))
        fut = asyncio.run_coroutine_threadsafe(gcs.call(method, payload), self.loop)
        try:
            fut.result(timeout=5)
        except NodeFencedError:
            # Runs on a flusher thread: the teardown must hop to the loop.
            self.loop.call_soon_threadsafe(self._on_fenced)
            raise
        except Exception:
            fut.cancel()
            raise

    async def rpc_node_stats(self, payload, conn):
        return {
            "node_id": self.node_id.binary(),
            "resources_total": dict(self.resources_total),
            "resources_available": dict(self.resources_available),
            "draining": self.draining,
            "drain_reason": self.drain_reason,
            "drain_deadline": self.drain_deadline,
            "num_workers": len(self.workers),
            "queue_len": len(self.queue),
            "infeasible": len(self.infeasible),
            "lease_waiters": len(self.lease_waiters),
            "tenant_usage": self._local_tenant_usage(),
            "store": self.store.stats(),
            "num_tasks_dispatched": self.num_tasks_dispatched,
            "num_tasks_spilled": self.num_tasks_spilled,
            "event_loop_lag_ms": round(self.event_loop_lag_ms, 3),
            "event_loop_lag_max_ms": round(self.event_loop_lag_max_ms, 3),
            "chaos": CHAOS.stats(),
            "running_tasks": [
                {"task_id": tb, "name": s.name, "worker_pid": w.pid}
                for w in self.workers.values()
                for tb, s in w.running.items()
            ],
            # Worker roster incl. direct RPC endpoints: the profiling
            # orchestrator fans a node-wide capture out to these.  Ids
            # are hex (the JSON-API convention — these records flow out
            # of /api/workers and state.list_workers unchanged).
            "workers": [
                {
                    "worker_id": w.worker_id.hex(),
                    "pid": w.pid,
                    "state": w.state,
                    "direct_address": w.direct_address,
                    "actor_id": w.actor_id.hex() if w.actor_id else None,
                    "tenant": w.tenant,
                }
                for w in self.workers.values()
            ],
        }

    # Sampling-profiler surface for the raylet process itself (see
    # profiling.py; handlers never block the dispatch loop).
    async def rpc_profile_start(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_start(payload)

    async def rpc_profile_stop(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_stop(payload)

    async def rpc_profile_dump(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_dump(payload)
