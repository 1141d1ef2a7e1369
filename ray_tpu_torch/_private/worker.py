"""The per-process runtime for drivers and workers.

This is the equivalent of the reference's CoreWorker + python worker
(reference: src/ray/core_worker/core_worker.h:166,
python/ray/_private/worker.py:427 Worker singleton): object put/get/wait,
task and actor-task submission, the task-execution loop on workers,
client-side reference counting, and actor-handle routing.
"""

from __future__ import annotations

import hashlib
import inspect
import logging
import os
import queue
import threading
import time
import traceback
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import retry, rpc, serialization, telemetry
from ray_tpu_torch._private.chaos import CHAOS
from ray_tpu_torch._private.common import ResourceSet, SchedulingStrategy, TaskSpec
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import StoreClient

logger = logging.getLogger(__name__)

FUNCTION_KV_NS = "fn"


class ReferenceCounter:
    """Owner-side local reference counts; frees cluster-wide at zero.

    Borrowing-lite (reference: src/ray/core_worker/reference_count.h:64):
    a ref passed as a direct-path task arg registers a *borrow* that is
    returned when the task completes — an object whose local refs died
    while borrows were outstanding is freed the moment the last borrow
    returns, instead of leaking until job end.  Refs that escape through
    generic pickling (nested in other objects) or down paths with no
    completion signal (raylet-mediated submission, actor creation) fall
    back to the *escaped* set: reclaimed by per-job GC when the job ends
    (the job id is embedded in the object id)."""

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self._counts: Dict[ObjectID, int] = {}
        self._escaped: set = set()
        self._lock = threading.Lock()
        self._to_free: List[bytes] = []
        self._flusher = None
        self._stopped = False
        # Outstanding borrow count per object, the task->borrowed-oids
        # binding, and objects whose local refs died while borrowed.
        self._borrows: Dict[ObjectID, int] = {}
        self._task_borrows: Dict[bytes, List[ObjectID]] = {}
        self._deferred: set = set()
        # ObjectRef.__del__ lands here, NEVER on self._lock: the cyclic
        # GC can fire inside ANY allocating statement of a critical
        # section below, and a __del__ that then blocks on the same
        # (non-reentrant) lock deadlocks the whole process.  deque
        # append/popleft are atomic, so __del__ needs no lock at all.
        import collections

        self._pending_removals = collections.deque()

    def _drain_removals_locked(self):
        while self._pending_removals:
            self._remove_owned_locked(self._pending_removals.popleft())

    def add_owned(self, object_id: ObjectID):
        with self._lock:
            self._drain_removals_locked()
            self._counts[object_id] = self._counts.get(object_id, 0) + 1

    def mark_escaped(self, object_id: ObjectID):
        with self._lock:
            self._escaped.add(object_id)

    # -- borrowing-lite ----------------------------------------------------
    def hold(self, object_id: ObjectID):
        """Register one borrow immediately (called while serializing args,
        BEFORE the task id exists — the caller's temporary refs may die as
        soon as serialization returns)."""
        with self._lock:
            self._drain_removals_locked()
            self._borrows[object_id] = self._borrows.get(object_id, 0) + 1

    def bind_borrows(self, task_id: bytes, oids: List[ObjectID]):
        """Associate already-held borrows with the submitted task."""
        if not oids:
            return
        with self._lock:
            self._task_borrows[task_id] = list(oids)

    def return_borrows(self, task_id: bytes):
        """The task completed (result, error, or gave up retrying): its
        borrows return; objects whose local refs already died free now."""
        with self._lock:
            self._drain_removals_locked()
            oids = self._task_borrows.pop(task_id, None)
            if not oids:
                return
            for oid in oids:
                self._drop_borrow_locked(oid)

    def escalate_to_escape(self, task_id: bytes, oids: Optional[List[ObjectID]] = None):
        """The spec went down a path with no completion signal: convert
        its borrows to permanent escapes (job-end GC reclaims them).
        With oids=None, escalates whatever was bound to the task."""
        with self._lock:
            bound = self._task_borrows.pop(task_id, None)
            if oids is None:
                oids = bound or []
            for oid in oids:
                self._escaped.add(oid)
                self._drop_borrow_locked(oid, escaped=True)

    def _drop_borrow_locked(self, oid: ObjectID, escaped: bool = False):
        c = self._borrows.get(oid, 0) - 1
        if c > 0:
            self._borrows[oid] = c
            return
        self._borrows.pop(oid, None)
        if oid in self._deferred:
            self._deferred.discard(oid)
            if not escaped and oid not in self._escaped and oid not in self._counts:
                # Keep the lineage: live dependents (the borrower's own
                # results) may still need this task for transitive
                # reconstruction; per-job GC reclaims the entry.
                self._worker.memory_store.free(oid.binary())
                self._to_free.append(oid.binary())
                self._ensure_flusher_locked()
                if len(self._to_free) >= 100:
                    self._flush_locked()

    def remove_owned(self, object_id: ObjectID):
        """Called from ObjectRef.__del__ — possibly INSIDE a GC pass that
        interrupted a thread already holding self._lock.  Enqueue, then
        drain opportunistically: blocking here is the deadlock (see
        __init__); if the lock is busy, whoever holds it drains."""
        self._pending_removals.append(object_id)
        if not self._lock.acquire(blocking=False):
            return
        try:
            self._drain_removals_locked()
        finally:
            self._lock.release()

    def _remove_owned_locked(self, object_id: ObjectID):
        c = self._counts.get(object_id)
        if c is None:
            return
        if c <= 1:
            del self._counts[object_id]
            if object_id in self._escaped:
                # The ref escaped into other tasks/objects: keep its
                # lineage for transitive reconstruction (reclaimed by
                # per-job GC, like the object itself).  The memory-store
                # blob is redundant once settled — every escape path
                # promoted it to the shm store — but an in-flight direct
                # result must keep its pending/promote state so arrival
                # still triggers promotion.
                self._escaped.discard(object_id)
                self._worker.memory_store.free_if_settled(object_id.binary())
                return
            if self._borrows.get(object_id, 0) > 0:
                # In-flight tasks still use it as an arg: free when the
                # last borrow returns (reference: borrower count in
                # reference_count.h).
                self._deferred.add(object_id)
                self._worker.memory_store.free_if_settled(object_id.binary())
                return
            self._worker.memory_store.free(object_id.binary())
            # No dependents can exist: drop lineage with the ref
            # (reference: task_manager.h lineage pinning).
            self._worker.lineage.pop(object_id.binary(), None)
            self._to_free.append(object_id.binary())
            self._ensure_flusher_locked()
            if len(self._to_free) >= 100:
                self._flush_locked()
        else:
            self._counts[object_id] = c - 1

    def _flush_locked(self):
        batch, self._to_free = self._to_free, []
        try:
            if self._worker.gcs_client and not self._worker.gcs_client.closed:
                self._worker.gcs_client.push("free_objects", batch)
        except Exception:
            # GCS unreachable (e.g. reconnecting): keep the batch for the
            # background flusher to retry — frees must not silently vanish
            # across a GCS restart.  Bounded so a permanently dead GCS
            # can't grow this without limit; records the bound sheds are
            # counted (telemetry_dropped_total) so an outage that trips
            # it is visible instead of a silent free leak.
            merged = batch + self._to_free
            shed = len(merged) - 100_000
            if shed > 0:
                telemetry.count_telemetry_dropped("gcs_outage_bound", shed)
            self._to_free = merged[:100_000]
            self._ensure_flusher_locked()

    def _ensure_flusher_locked(self):
        """Freed ids batch up to amortize the GCS push, but a trickle of
        frees (the common case) must still go out promptly — a lazy
        background flusher drains the batch every 200 ms."""
        if self._flusher is not None:
            return

        def run():
            while not self._stopped:
                time.sleep(0.2)
                with self._lock:
                    self._drain_removals_locked()
                    if self._to_free:
                        self._flush_locked()

        self._flusher = threading.Thread(target=run, daemon=True, name="ref-free-flush")
        self._flusher.start()

    def stop(self):
        """End the flusher (the counter is being replaced on disconnect;
        a 'while True' loop would leak one thread per init/shutdown cycle
        and pin the old Worker graph through its closure)."""
        self._stopped = True

    def flush(self):
        with self._lock:
            if self._to_free:
                self._flush_locked()

    def owned_count(self) -> int:
        with self._lock:
            return len(self._counts)


class ActorStateCache:
    """Tracks actor liveness from GCS pubsub; flushes queued submissions."""

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self._info: Dict[ActorID, dict] = {}
        self._pending: Dict[ActorID, List[TaskSpec]] = defaultdict(list)
        # Actors whose queued specs are mid-flush: new submissions must
        # queue BEHIND the flush or they'd take send-time sequence numbers
        # ahead of earlier-submitted specs.
        self._flushing: set = set()
        self._lock = threading.Lock()

    def cancel_pending(self, tid: bytes) -> Optional[TaskSpec]:
        """Remove (and return) a queued spec waiting for its actor to come
        alive — a cancel must not let it run when the actor appears."""
        with self._lock:
            for specs in self._pending.values():
                for spec in specs:
                    if spec.task_id.binary() == tid:
                        specs.remove(spec)
                        return spec
        return None

    def on_update(self, info: dict):
        actor_id = ActorID(info["actor_id"])
        with self._lock:
            self._info[actor_id] = info
            pending = None
            if info["state"] in ("ALIVE", "DEAD"):
                pending = self._pending.pop(actor_id, None)
                if info["state"] == "ALIVE" and pending:
                    self._flushing.add(actor_id)
        if not pending:
            return
        if info["state"] == "ALIVE":
            try:
                while pending:
                    for spec in pending:
                        self._worker._send_actor_task(spec, info)
                    with self._lock:
                        pending = self._pending.pop(actor_id, None)
                        if not pending:
                            self._flushing.discard(actor_id)
            finally:
                with self._lock:
                    self._flushing.discard(actor_id)
        else:
            for spec in pending:
                self._worker._store_error_returns(
                    spec, exceptions.ActorDiedError(f"Actor died: {info.get('death_cause')}")
                )

    def get(self, actor_id: ActorID) -> Optional[dict]:
        with self._lock:
            return self._info.get(actor_id)

    def set_initial(self, actor_id: ActorID, info: dict):
        """Seed from an RPC lookup — never overwrite pubsub-fed state,
        which is always at least as fresh."""
        with self._lock:
            self._info.setdefault(actor_id, info)

    def mark_unavailable(self, actor_id: ActorID):
        """A direct channel to the actor dropped: park submissions until
        pubsub reports the actor's real state (ALIVE elsewhere, RESTARTING
        or DEAD)."""
        with self._lock:
            info = self._info.get(actor_id)
            if info is not None and info["state"] == "ALIVE":
                self._info[actor_id] = dict(info, state="UNAVAILABLE")

    def submit_or_queue(self, actor_id: ActorID, spec: TaskSpec) -> Optional[dict]:
        """Atomically: if the actor is in a terminal-ish state return its
        info (caller sends or errors); otherwise queue the spec for the
        flush in on_update.  Closes the read-then-queue race with pubsub.
        While a flush is draining, new specs queue behind it so send-order
        (and thus sequence numbers) matches submission order."""
        with self._lock:
            info = self._info.get(actor_id)
            if (
                info is not None
                and info["state"] in ("ALIVE", "DEAD")
                and actor_id not in self._flushing
            ):
                return info
            self._pending[actor_id].append(spec)
            return None


class Worker:
    """One per process.  mode is "driver" or "worker"."""

    def __init__(self):
        self.mode: Optional[str] = None
        self.connected = False
        self.job_id: Optional[JobID] = None
        self.worker_id = WorkerID.from_random()
        self.node_id: Optional[NodeID] = None
        self.namespace: str = "default"
        self.session_info: dict = {}
        # Multi-tenant job plane: the tenant this process's job belongs
        # to and its priority class — stamped on lease requests so
        # raylets do fair-share/quota accounting per tenant.
        self.tenant: str = "default"
        self.tenant_priority: int = 0
        # Job-level default runtime env (normalized); merged under any
        # per-task/actor runtime_env at submit time.
        self.job_runtime_env: Optional[dict] = None
        # (session, canonical-json raw env) -> normalized env; avoids
        # re-zipping/re-uploading working_dirs on every .remote().
        self._runtime_env_norm_cache: Dict[Tuple[str, str], dict] = {}
        self.gcs_client: Optional[rpc.RpcClient] = None
        self.raylet_client: Optional[rpc.RpcClient] = None
        self.store: Optional[StoreClient] = None
        self.reference_counter = ReferenceCounter(self)
        self.actor_cache = ActorStateCache(self)
        self._raylet_clients: Dict[str, rpc.RpcClient] = {}
        self._task_counter = 0
        self._actor_seq: Dict[ActorID, int] = defaultdict(int)
        self._actor_send_inc: Dict[ActorID, int] = {}
        self._lock = threading.RLock()
        self._pushed_functions: set = set()
        # Worker-mode execution state
        self.current_task_id: Optional[TaskID] = None
        self.current_spec: Optional[TaskSpec] = None
        self._function_cache: Dict[bytes, Any] = {}
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self._exec_queue: "queue.Queue" = queue.Queue()
        self._async_loop = None
        self._async_loop_thread = None
        self._exec_pool = None
        # Named concurrency groups: group -> bounded thread pool (sync
        # actors) / asyncio semaphore (async actors).
        self._group_pools: Dict[str, Any] = {}
        self._async_group_sems: Dict[str, Any] = {}
        self._shutdown_event = threading.Event()
        self._task_events: list = []
        self._task_event_flusher = None
        self._task_event_lock = threading.Lock()
        self._intended_exit = False
        self.runtime_context_info: dict = {}
        # Lineage for owned task returns: oid bytes -> creating TaskSpec.
        # Used to resubmit the creating task when every copy of an object
        # is lost (reference: core_worker/object_recovery_manager.h,
        # task_manager.h:212).  Entries are dropped when the ref dies.
        self.lineage: Dict[bytes, TaskSpec] = {}
        self._recovery_lock = threading.Lock()
        self._recovery_inflight: Dict[bytes, float] = {}
        # Direct task submission (reference: normal_task_submitter.h:74).
        self.memory_store = MemoryStore()
        self._direct_submitter = None
        self._direct_server = None
        self._direct_loop = None
        self.direct_address: Optional[str] = None
        # Receiver-side actor-task ordering: per-caller contiguous admission
        # by sequence_number (reference: sequential_actor_submit_queue.h).
        self._admit_lock = threading.Lock()
        self._actor_expected: Dict[bytes, int] = {}
        self._actor_buffer: Dict[bytes, Dict[int, tuple]] = {}
        self._actor_caller_inc: Dict[bytes, int] = {}
        # Normal-task dedupe for duplicated exec_direct deliveries:
        # (task_id, attempt, reconstructions) already admitted here.
        self._direct_admitted: set = set()
        self._direct_admitted_order: "deque" = deque()
        # Direct channels to actor workers: actor_id -> _ActorChannel.
        self._actor_channels: Dict[ActorID, Any] = {}
        # Owner-side streaming-generator state: task_id bytes -> _StreamState
        # (reference: core_worker ObjectRefGenerator bookkeeping).
        self._streams: Dict[bytes, Any] = {}
        # worker_id bytes -> reason, for leased workers the raylet
        # OOM-killed (consumed by DirectTaskSubmitter._on_lease_lost).
        self._oom_worker_kills: Dict[bytes, str] = {}
        # Owner side: task ids cancelled via ray_tpu_torch.cancel — retry paths
        # consult this to fail instead of resubmitting.
        self._cancelled_tasks: set = set()
        # Node lifecycle listeners (drain plane): callbacks invoked with
        # (state, node_dict) for every "nodes" pubsub event.  The direct
        # submitter uses this to proactively re-lease off DRAINING nodes;
        # the train backend executor uses it to trigger a pre-preemption
        # checkpoint.
        self._node_listeners: list = []
        # Job-preemption listeners (multi-tenant plane): callbacks
        # invoked with the GCS "preempt_job" notice payload.  The train
        # backend executor uses this to checkpoint-and-shrink instead of
        # waiting for the escalation (graceful actor restart).
        self._job_preempt_listeners: list = []
        # Guards both listener lists: registration happens on user
        # threads while dispatch runs on the pubsub reader thread.
        self._listener_lock = threading.Lock()
        self.job_preempt_notice: Optional[dict] = None
        # Executor side: cancel requests for tasks queued/running here,
        # plus live execution registries so a cancel targets exactly the
        # right thread / asyncio task (a shared "current thread" would
        # misfire on concurrent actors).
        self._cancel_requested: set = set()
        self._running_threads: Dict[bytes, int] = {}  # task_id -> thread ident
        self._running_async: Dict[bytes, Any] = {}  # task_id -> asyncio.Task
        self._cancel_signal_tid: Optional[bytes] = None

    # ------------------------------------------------------------------
    # connection
    # ------------------------------------------------------------------
    def connect_driver(self, gcs_address: str, raylet_address: str, namespace: Optional[str], job_config: dict):
        self.mode = "driver"
        import sys as _sys

        from ray_tpu_torch._private.chaos import set_net_role

        set_net_role("driver")
        job_config = dict(job_config, driver_sys_path=[p for p in _sys.path if p])
        self.gcs_client = rpc.ReconnectingRpcClient(
            gcs_address, on_push=self._on_gcs_push,
            on_reconnect=self._on_gcs_reconnected, peer_name="gcs"
        )
        reply = self.gcs_client.call(
            "register_driver",
            {"namespace": namespace, "entrypoint": " ".join(os.sys.argv), "config": job_config},
        )
        self.job_id = JobID(reply["job_id"])
        self.namespace = reply["namespace"]
        self.session_info = reply["session_info"]
        # Effective identity from the GCS (tenant-default priority
        # applied there), falling back to what we sent for older GCS.
        self.tenant = reply.get("tenant") or job_config.get("tenant") or "default"
        self.tenant_priority = int(
            reply.get("priority")
            if reply.get("priority") is not None
            else (job_config.get("priority") or 0)
        )
        self.gcs_client.call("subscribe", "actors")
        # Node lifecycle events: owners react to DRAINING targets by
        # re-leasing proactively instead of waiting for RPC failure.
        self.gcs_client.call("subscribe", "nodes")
        if CONFIG.log_to_driver:
            # Worker stdout/stderr of this job streams here (reference:
            # log_monitor.py → driver printing with worker prefixes).
            self.gcs_client.call("subscribe", f"logs:{self.job_id.hex()}")
        self.raylet_client = rpc.RpcClient(raylet_address, on_push=self._on_raylet_push,
                                           peer_name="raylet")
        # Workers mirror the driver's import paths (driver_sys_path, set
        # above) so functions pickled by reference resolve there too; the
        # same config is stored in the GCS job table for other raylets.
        job_config = dict(
            job_config,
            session_dir=self.session_info.get("session_dir"),
            # Effective identity (tenant-default priority resolved by the
            # GCS) — worker spawns inherit it via the raylet's env stamp.
            tenant=self.tenant,
            priority=self.tenant_priority,
        )
        r = self.raylet_client.call(
            "register_client",
            {"job_id": self.job_id.binary(), "job_config": job_config},
        )
        self.node_id = NodeID(r["node_id"])
        self.store = StoreClient(self.raylet_client, r["store_dir"])
        self.connected = True
        if CONFIG.direct_task_submission:
            from ray_tpu_torch._private.direct import DirectTaskSubmitter

            self._direct_submitter = DirectTaskSubmitter(self)

    def connect_worker(self):
        """Called from default_worker.py using env vars set by the raylet."""
        self.mode = "worker"
        raylet_address = os.environ["RAY_TPU_TORCH_RAYLET_ADDRESS"]
        self.worker_id = WorkerID.from_hex(os.environ["RAY_TPU_TORCH_WORKER_ID"])
        self.job_id = JobID.from_hex(os.environ["RAY_TPU_TORCH_JOB_ID"])
        self.node_id = NodeID.from_hex(os.environ["RAY_TPU_TORCH_NODE_ID"])
        from ray_tpu_torch._private.chaos import set_net_role

        set_net_role(f"worker-{self.node_id.hex()[:8]}")
        self.gcs_client = rpc.ReconnectingRpcClient(
            os.environ["RAY_TPU_TORCH_GCS_ADDRESS"],
            on_push=self._on_gcs_push,
            on_reconnect=self._on_gcs_reconnected,
            peer_name="gcs",
        )
        self.gcs_client.call("subscribe", "actors")
        self.gcs_client.call("subscribe", "nodes")
        # The raylet owns this worker's lifetime: if it dies, exit
        # (reference: workers suicide when their raylet disappears).
        self.raylet_client = rpc.RpcClient(
            raylet_address, on_push=self._on_raylet_push, on_close=self._on_raylet_lost,
            peer_name="raylet",
        )
        # Stage this worker's runtime env (set by the raylet at spawn)
        # BEFORE registering: a staging failure is reported in the
        # registration so the raylet can fail the waiting tasks instead
        # of respawning us in a loop.
        runtime_env_error = None
        renv_json = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
        if renv_json:
            import json as _json
            import tempfile

            from ray_tpu_torch._private import runtime_env as runtime_env_mod

            try:
                runtime_env_mod.stage_and_apply(
                    _json.loads(renv_json),
                    self.gcs_client,
                    os.environ.get("RAY_TPU_TORCH_SESSION_DIR") or tempfile.gettempdir(),
                )
            except Exception as e:
                runtime_env_error = f"{type(e).__name__}: {e}"
        # Host a direct RPC endpoint before registering so the raylet can
        # hand our address to lease holders (reference: CoreWorkerService).
        self._start_direct_server(raylet_address)
        self._install_cancel_signal_handler()
        payload = {"worker_id": self.worker_id.binary(), "address": self.direct_address}
        if runtime_env_error:
            payload["runtime_env_error"] = runtime_env_error
        reply = self.raylet_client.call("register_worker", payload)
        if runtime_env_error:
            raise RuntimeError(f"runtime_env setup failed: {runtime_env_error}")
        if not reply.get("ok"):
            raise RuntimeError("raylet rejected worker registration")
        job_config = reply.get("job_config", {})
        import sys as _sys

        for p in reversed(job_config.get("driver_sys_path") or []):
            if p not in _sys.path:
                _sys.path.insert(0, p)
        self.namespace = job_config.get("namespace", "default")
        self.session_info = {"session_dir": job_config.get("session_dir")}
        # Tenant inheritance: the raylet stamps the job's tenant into the
        # spawn env (isolation: nested work is charged like the driver's).
        self.tenant = (
            os.environ.get("RAY_TPU_TORCH_TENANT")
            or job_config.get("tenant")
            or "default"
        )
        try:
            self.tenant_priority = int(
                os.environ.get("RAY_TPU_TORCH_TENANT_PRIORITY")
                or job_config.get("priority")
                or 0
            )
        except ValueError:
            self.tenant_priority = 0
        # Nested tasks inherit THIS worker's env (already job-env-merged
        # by the parent submitter), not the bare job env — matching the
        # reference's parent-inheritance semantics.
        if renv_json:
            import json as _json

            self.job_runtime_env = _json.loads(renv_json) or None
        else:
            self.job_runtime_env = job_config.get("runtime_env") or None
        self.store = StoreClient(self.raylet_client, os.environ["RAY_TPU_TORCH_STORE_DIR"])
        self.connected = True
        if CONFIG.direct_task_submission:
            from ray_tpu_torch._private.direct import DirectTaskSubmitter

            self._direct_submitter = DirectTaskSubmitter(self)

    def _start_direct_server(self, raylet_address: str):
        """Run an RpcServer for direct task pushes on a dedicated asyncio
        loop thread.  The socket lives next to the raylet's."""
        import asyncio

        sock_dir = os.path.dirname(raylet_address.split("unix:", 1)[-1])
        path = os.path.join(sock_dir, f"w_{self.worker_id.hex()[:16]}.sock")
        address = f"unix:{path}"
        loop = asyncio.new_event_loop()
        self.direct_address = address
        self._direct_loop = loop
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            self._direct_server = rpc.RpcServer(self, address, loop)
            loop.run_until_complete(self._direct_server.start())
            started.set()
            loop.run_forever()

        threading.Thread(target=run, daemon=True, name="direct-server").start()
        if not started.wait(10):
            self.direct_address = None

    # Sampling-profiler surface on the worker's direct server: any
    # submitter/driver with the worker's direct address can attach
    # (util.state.profile resolves actors to these endpoints).  The
    # handlers never block — start spawns a daemon sampler thread,
    # stop/dump snapshot under a short lock (see profiling.py).
    async def rpc_profile_start(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_start(payload)

    async def rpc_profile_stop(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_stop(payload)

    async def rpc_profile_dump(self, payload, conn):
        from ray_tpu_torch._private import profiling

        return profiling.handle_profile_dump(payload)

    async def push_exec_direct(self, payload, conn):
        """Direct task push from a submitter (runs on the server loop)."""
        spec: TaskSpec = payload["spec"]
        if spec.is_actor_task:
            self._admit_actor_task(spec, conn)
        else:
            # Idempotency: a duplicated delivery (resend after reconnect,
            # chaos dup) of the same attempt must not run the task twice.
            # Reconstruction resubmits bump spec.reconstructions, so a
            # legitimate re-execution of a recovered task still admits.
            key = (spec.task_id.binary(), spec.attempt_number, spec.reconstructions)
            with self._admit_lock:
                if key in self._direct_admitted:
                    return
                self._direct_admitted.add(key)
                self._direct_admitted_order.append(key)
                while len(self._direct_admitted_order) > 8192:
                    self._direct_admitted.discard(self._direct_admitted_order.popleft())
            self._exec_queue.put((spec, conn))

    def _admit_actor_task(self, spec: TaskSpec, conn):
        """Admit actor tasks per caller strictly in sequence_number order,
        starting from 1 per (caller, actor incarnation): early arrivals
        buffer, duplicate redeliveries and stale-incarnation specs drop
        (reference: transport/sequential_actor_submit_queue.h)."""
        with self._admit_lock:
            caller = spec.owner_worker_id.binary() if spec.owner_worker_id else b""
            inc = spec.actor_incarnation
            cur_inc = self._actor_caller_inc.get(caller, 0)
            if inc < cur_inc:
                return  # stale delivery from before a restart the caller saw
            if inc > cur_inc:
                self._actor_caller_inc[caller] = inc
                self._actor_expected[caller] = 1
                self._actor_buffer.pop(caller, None)
            exp = self._actor_expected.get(caller, 1)
            if spec.sequence_number < exp:
                return  # duplicate (resend after a reconnect)
            buf = self._actor_buffer.setdefault(caller, {})
            buf[spec.sequence_number] = (spec, conn)
            while exp in buf:
                self._exec_queue.put(buf.pop(exp))
                exp += 1
            self._actor_expected[caller] = exp

    def disconnect(self):
        if not self.connected:
            return
        self.reference_counter.flush()
        self.connected = False
        # Drop pubsub registrations explicitly: a clean shutdown should
        # not leave the GCS fanning events at a half-closed connection
        # until its next push notices the dead socket.
        if self.gcs_client is not None:
            for channel in ("actors", "nodes", f"logs:{self.job_id.hex()}"):
                try:
                    self.gcs_client.call("unsubscribe", channel, timeout=2)
                except Exception:
                    break
        if self._direct_submitter is not None:
            try:
                self._direct_submitter.shutdown()
            except Exception:
                pass
            self._direct_submitter = None
        for ch in list(self._actor_channels.values()):
            try:
                ch.close()
            except Exception:
                pass
        self._actor_channels.clear()
        if self._direct_loop is not None:
            try:
                self._direct_loop.call_soon_threadsafe(self._direct_loop.stop)
            except Exception:
                pass
        for c in [self.gcs_client, self.raylet_client, *self._raylet_clients.values()]:
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass
        self._raylet_clients.clear()
        self.gcs_client = None
        self.raylet_client = None
        self.store = None
        # Reset session-scoped state: the Worker instance is reused across
        # shutdown()+init(), and a fresh GCS restarts job ids at 1 — so a
        # (job_id + blob-hash) function key from the OLD session collides
        # with the new one and _push_function would silently skip the
        # upload ("function missing from GCS" on the new cluster).
        self._pushed_functions.clear()
        self._function_cache.clear()
        self.lineage.clear()
        self._streams.clear()
        self._recovery_inflight.clear()
        self._actor_seq.clear()
        self._actor_send_inc.clear()
        self._direct_admitted.clear()
        self._direct_admitted_order.clear()
        self._runtime_env_norm_cache.clear()
        self._oom_worker_kills.clear()
        self._cancelled_tasks.clear()
        self._cancel_requested.clear()
        with self._listener_lock:
            self._node_listeners.clear()
            self._job_preempt_listeners.clear()
        self.job_preempt_notice = None
        self.job_runtime_env = None
        self.memory_store = MemoryStore()
        self.actor_cache = ActorStateCache(self)
        self.reference_counter.stop()
        self.reference_counter = ReferenceCounter(self)

    # ------------------------------------------------------------------
    # pushes
    # ------------------------------------------------------------------
    def _on_gcs_push(self, method: str, payload):
        if method == "preempt_job":
            # Priority preemption notice (multi-tenant plane): this job
            # should release capacity gracefully — an elastic trainer
            # checkpoints and shrinks; past the notice deadline the GCS
            # escalates to graceful actor restarts.  Listeners run off
            # the RPC read thread (they issue actor calls).
            self.job_preempt_notice = payload
            threading.Thread(
                target=self._on_job_preempt, args=(payload,),
                daemon=True, name="job-preempt",
            ).start()
            return
        if method == "pubsub":
            channel, msg = payload
            if channel == "actors":
                self.actor_cache.on_update(msg)
            elif channel == "nodes":
                # Off the RPC read thread: listeners may issue synchronous
                # GCS/actor calls (drain handoffs do), and a call from the
                # read loop would deadlock on its own reply.  Node events
                # are rare (lifecycle only), so a thread per event is fine.
                threading.Thread(
                    target=self._on_node_event, args=(msg,),
                    daemon=True, name="node-event",
                ).start()
            elif channel.startswith("logs:"):
                import sys as _sys

                prefix = f"({msg.get('worker', '?')} pid={msg.get('pid', '?')})"
                for line in msg.get("lines", ()):
                    print(f"{prefix} {line}", file=_sys.stderr)

    def _on_node_event(self, msg):
        """A "nodes" pubsub event (ALIVE/DRAINING/DEAD).  Fan out to the
        drain-aware subsystems: the direct submitter stops feeding leases
        on a draining node and re-leases elsewhere; registered listeners
        (train's backend executor) get the raw event."""
        try:
            state, node = msg
        except (TypeError, ValueError):
            return
        if state == "DRAINING" and self._direct_submitter is not None:
            try:
                self._direct_submitter.on_node_draining(node.get("raylet_address"))
            except Exception:
                logger.exception("drain handoff to direct submitter failed")
        with self._listener_lock:
            listeners = list(self._node_listeners)
        for cb in listeners:
            try:
                cb(state, node)
            except Exception:
                logger.exception("node event listener failed")

    def add_node_listener(self, cb) -> None:
        """Register cb(state, node_dict) for cluster node lifecycle
        events (every connected process subscribes to "nodes")."""
        with self._listener_lock:
            self._node_listeners.append(cb)

    def remove_node_listener(self, cb) -> None:
        with self._listener_lock:
            try:
                self._node_listeners.remove(cb)
            except ValueError:
                pass

    def _on_job_preempt(self, payload: dict):
        logger.warning(
            "job preemption notice: %s (deadline %.0fs, release %s worker(s))",
            payload.get("reason"), float(payload.get("deadline_s") or 0),
            payload.get("release_workers"),
        )
        with self._listener_lock:
            listeners = list(self._job_preempt_listeners)
        for cb in listeners:
            try:
                cb(payload)
            except Exception:
                logger.exception("job preempt listener failed")

    def add_job_preempt_listener(self, cb) -> None:
        """Register cb(notice_dict) for GCS priority-preemption notices
        targeting this driver's job."""
        with self._listener_lock:
            self._job_preempt_listeners.append(cb)

    def remove_job_preempt_listener(self, cb) -> None:
        with self._listener_lock:
            try:
                self._job_preempt_listeners.remove(cb)
            except ValueError:
                pass

    def _on_gcs_reconnected(self):
        """The GCS restarted: re-subscribe and re-bind this driver's job so
        disconnect-driven cleanup keeps working."""
        try:
            self.gcs_client.call("subscribe", "actors")
            self.gcs_client.call("subscribe", "nodes")
            if self.mode == "driver" and self.job_id is not None:
                if CONFIG.log_to_driver:
                    self.gcs_client.call("subscribe", f"logs:{self.job_id.hex()}")
                self.gcs_client.call("reattach_driver", {"job_id": self.job_id.binary()})
        except Exception:
            pass

    def _on_raylet_push(self, method: str, payload):
        if method == "execute_task":
            spec = payload["spec"]
            if spec.is_actor_task:
                # Raylet-mediated actor tasks share the same per-caller
                # ordering state as direct pushes, so mixed transports
                # (e.g. across an actor restart) stay sequenced.
                self._admit_actor_task(spec, None)
            else:
                self._exec_queue.put((spec, None))
        elif method == "cancel_task":
            self._handle_cancel_request(payload)
        elif method == "oom_kill":
            # The raylet OOM-killed a worker we hold a lease on; remember
            # why so the lease-lost handler raises OutOfMemoryError
            # instead of a generic crash (reference: memory_monitor.h).
            self._oom_worker_kills[payload["worker_id"]] = payload["message"]
        elif method == "revoke_lease":
            # Tenant-quota reconciliation: our tenant is over quota, the
            # raylet asks for this lease back.  Cooperative — in-flight
            # tasks finish, no new specs are assigned, then the worker is
            # returned (same machinery as a drain).
            if self._direct_submitter is not None:
                self._direct_submitter.revoke(payload["worker_id"])
        elif method == "exit":
            self._intended_exit = True
            self._shutdown_event.set()
            self._exec_queue.put(None)

    def _on_raylet_lost(self):
        if self.mode == "worker" and not self._intended_exit:
            # Hard exit: the main thread may be blocked inside a task
            # (e.g. a long queue.get), so a cooperative flag isn't enough.
            os._exit(1)

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        self._check_connected()
        if isinstance(value, ObjectRef):
            raise TypeError("Calling ray.put on an ObjectRef is not allowed.")
        object_id = ObjectID.for_put(self.job_id)
        meta, buffers = serialization.serialize(value)
        self.store.put_serialized(object_id, meta, buffers)
        return ObjectRef(object_id, owned=True)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        self._check_connected()
        self._notify_blocked(True)
        try:
            deadline = time.monotonic() + timeout if timeout is not None else None
            return [self._get_one(ref.id, deadline) for ref in refs]
        finally:
            self._notify_blocked(False)

    def _get_one(self, object_id: ObjectID, deadline: Optional[float]) -> Any:
        recovery_rounds = 0
        while True:
            # Owner fast path: small direct-task results live in the
            # in-process memory store; pending ones arrive on the
            # task-finished push — no RPC either way.
            key = object_id.binary()
            if self.memory_store.is_tracked(key):
                blob = self.memory_store.get_wait(key, deadline)
                if blob is not None:
                    tag, value = serialization.deserialize(memoryview(blob))
                    if tag != serialization.TAG_ERROR:
                        return value
                    action = self._handle_error_result(object_id, value, recovery_rounds)
                    if action == "retry":
                        # The resubmitted task seals into the shm store:
                        # drop the stale error blob so the retry waits there.
                        self.memory_store.free(key)
                        recovery_rounds += 1
                        continue
                    # unreachable: _handle_error_result raises otherwise
                elif deadline is not None and time.monotonic() >= deadline:
                    raise exceptions.GetTimeoutError(f"timed out getting {object_id}")
                # resolved to the shm store: fall through
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                tag, value = self.store.get_serialized(object_id, remaining)
            except exceptions.ObjectLostError:
                recovery_rounds += 1
                if recovery_rounds > CONFIG.max_object_recovery_attempts or not self._recover_object(
                    object_id
                ):
                    raise
                continue
            if tag == serialization.TAG_ERROR:
                if self._handle_error_result(object_id, value, recovery_rounds) == "retry":
                    recovery_rounds += 1
                    continue
            return value

    def _handle_error_result(self, object_id: ObjectID, value, recovery_rounds: int) -> str:
        """A get resolved to a stored error.  A task that failed because one
        of ITS args was lost stored an ObjectLostError-caused error; the
        owner (us) holds the lineage for both the arg and this task:
        reconstruct the chain and retry instead of surfacing the transient
        error (reference: object_recovery_manager recovers borrowed args via
        the owner).  Returns "retry" or raises."""
        cause = value.cause if isinstance(value, exceptions.RayTaskError) else value
        if isinstance(cause, exceptions.ObjectLostError):
            if recovery_rounds < CONFIG.max_object_recovery_attempts and self._recover_object(
                object_id
            ):
                return "retry"
        if isinstance(value, exceptions.RayTaskError):
            raise value.as_instanceof_cause()
        raise value

    def _recover_object(self, object_id: ObjectID, _depth: int = 0) -> bool:
        """Lineage reconstruction: resubmit the task that created this
        object, transitively recovering lost arguments first (reference:
        core_worker/object_recovery_manager.h — RecoverObject resubmits
        via TaskResubmissionInterface).  Returns True if a resubmission
        was issued (caller retries the get), False if unrecoverable
        (ray.put object, foreign ref, or retries exhausted)."""
        if not CONFIG.lineage_reconstruction_enabled or _depth > 64:
            return False
        key = object_id.binary()
        spec = self.lineage.get(key)
        if spec is None:
            return False
        if spec.max_retries == 0:
            # Explicitly non-retryable (side-effecting) task: its objects
            # are unrecoverable, matching the reference's semantics.
            return False
        allowed = spec.max_retries if spec.max_retries >= 0 else (1 << 30)
        # Backoff: each reconstruction attempt widens the window in which
        # duplicate resubmits are suppressed, so a repeatedly-failing chain
        # doesn't hot-loop.
        window = CONFIG.object_recovery_inflight_window_s * (1 + spec.reconstructions)
        with self._recovery_lock:
            # Another thread's resubmission for this task is still fresh:
            # don't double-submit, just let the caller retry its get.
            last = self._recovery_inflight.get(spec.task_id.binary(), 0.0)
            if time.monotonic() - last < window:
                return True
            if spec.reconstructions >= allowed:
                return False
        # Recover lost arguments first so the re-executed task can fetch
        # them (workers wait for in-flight reconstructions).
        for kind, payload in spec.args:
            if kind == "ref" and self.gcs_client.call("object_lost_check", payload):
                if not self._recover_object(ObjectID(payload), _depth + 1):
                    return False
        with self._recovery_lock:
            last = self._recovery_inflight.get(spec.task_id.binary(), 0.0)
            if time.monotonic() - last < window:
                return True
            spec.reconstructions += 1
            self._recovery_inflight[spec.task_id.binary()] = time.monotonic()
        logger.info(
            "lineage reconstruction: resubmitting %s (attempt %d) for lost object %s",
            spec.name, spec.reconstructions, object_id.hex()[:12],
        )
        try:
            # Clear lost state + purge stale copies (incl. error
            # placeholders) cluster-wide, then resubmit.
            self.gcs_client.call(
                "objects_resubmitted", [o.binary() for o in spec.return_ids()]
            )
            self._submit_with_retry(self.raylet_client, spec)
        except rpc.RpcError:
            return False
        return True

    def _submit_with_retry(self, client, spec: TaskSpec):
        """submit_task is at-least-once: the raylet dedupes deliveries by
        (task_id, attempt, reconstructions), so a lost reply is safely
        retried — the duplicate acks without queueing a second run."""
        bo = retry.SUBMIT.start()
        while True:
            try:
                return client.call("submit_task", {"spec": spec})
            except rpc.CallTimeout:
                delay = bo.next_delay()
                if delay is None:
                    raise
                time.sleep(delay)

    async def get_async(self, ref: ObjectRef):
        """Used by `await ref` inside async actors."""
        import asyncio

        loop = asyncio.get_event_loop()
        return (await loop.run_in_executor(None, lambda: self.get([ref])))[0]

    def wait(self, refs: Sequence[ObjectRef], num_returns: int, timeout: Optional[float], fetch_local: bool = True):
        self._check_connected()
        if len(set(refs)) != len(refs):
            raise ValueError("ray.wait requires a list of unique object refs.")
        ms = self.memory_store
        self._notify_blocked(True)
        try:
            if any(ms.is_tracked(r.id.binary()) for r in refs):
                ready_ids = self._wait_hybrid(refs, num_returns, timeout)
            else:
                ready_ids, _ = self.store.wait(
                    [r.id for r in refs], num_returns, timeout if timeout is not None else None
                )
        finally:
            self._notify_blocked(False)
        ready = [r for r in refs if r.id in ready_ids][:num_returns]
        ready_set = set(ready)
        not_ready = [r for r in refs if r not in ready_set]
        return ready, not_ready

    def _wait_hybrid(self, refs, num_returns, timeout):
        """Wait over a mix of memory-store (direct in-flight) and shm-store
        refs: memory-store readiness is push-driven; the shm store is
        polled with zero-timeout batch waits."""
        ms = self.memory_store
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            ready = set()
            store_ids = []
            for r in refs:
                key = r.id.binary()
                if ms.contains(key):
                    ready.add(r.id)
                elif not ms.is_pending(key):
                    store_ids.append(r.id)
            if store_ids:
                # Let the raylet block briefly instead of zero-timeout
                # polling — same RPC cadence, but the server wakes us the
                # moment something seals.
                got, _ = self.store.wait(store_ids, len(store_ids), 0.05)
                ready.update(got)
            if len(ready) >= num_returns:
                return ready
            if deadline is not None and time.monotonic() >= deadline:
                return ready
            if not store_ids:
                ms.wait_any(0.1)

    def _notify_blocked(self, blocked: bool):
        """Release/reacquire this task's resources during blocking calls
        (reference: CoreWorker NotifyDirectCallTaskBlocked)."""
        if self.mode == "worker" and self.current_spec is not None and not self.current_spec.is_actor_task:
            try:
                self.raylet_client.push(
                    "task_blocked" if blocked else "task_unblocked",
                    {"task_id": self.current_spec.task_id.binary()},
                )
            except Exception:
                pass

    # ------------------------------------------------------------------
    # function table
    # ------------------------------------------------------------------
    def _push_function(self, blob: bytes) -> bytes:
        key = self.job_id.binary() + hashlib.sha1(blob).digest()
        if key not in self._pushed_functions:
            self.gcs_client.call("kv_put", (FUNCTION_KV_NS, key, blob, True))
            self._pushed_functions.add(key)
        return key

    def _fetch_function(self, key: bytes):
        fn = self._function_cache.get(key)
        if fn is None:
            # Function blobs can be large (cloudpickled closures), so the
            # per-attempt timeout must leave room for a slow-but-moving
            # transfer; one retry keeps the worst case at the old
            # single-call budget (2 x 60s ~= rpc_call_timeout_s=120).
            blob = rpc.call_idempotent(
                self.gcs_client, "kv_get", (FUNCTION_KV_NS, key), timeout=60,
                policy=retry.GCS_READ_BULK,
            )
            if blob is None:
                raise exceptions.RaySystemError(f"function {key.hex()} missing from GCS")
            fn = serialization.loads_function(blob)
            self._function_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # task submission
    # ------------------------------------------------------------------
    def _serialize_args(self, args: Tuple, kwargs: Dict) -> Tuple[List[Tuple[str, Any]], List[ObjectID]]:
        """Pack args for a TaskSpec.  Returns (packed, borrowed_oids):
        every "ref" arg registers a *borrow* (held immediately — temporary
        refs like auto-put large values die when this scope exits); the
        submit path binds the borrows to the task for return at
        completion, or escalates them to escapes on paths with no
        completion signal (reference: reference_count.h:64 borrowing)."""
        packed = []
        borrowed: List[ObjectID] = []
        try:
            return self._serialize_args_inner(args, kwargs, packed, borrowed)
        except BaseException:
            # Failing mid-pack must not leak the holds already taken —
            # escalate them to escapes (job-end GC) and surface the error.
            self.reference_counter.escalate_to_escape(b"", borrowed)
            raise

    def _serialize_args_inner(self, args, kwargs, packed, borrowed):
        for a in list(args) + ([kwargs] if kwargs else []):
            if isinstance(a, ObjectRef):
                key = a.id.binary()
                blob = self.memory_store.get(key)
                if blob is None:
                    # In-flight direct result: atomically either flag it for
                    # promotion on arrival or learn it just arrived (racing
                    # here without the atomic op would skip both paths and
                    # strand the consumer).
                    blob = self.memory_store.mark_promote(key)
                if blob is not None and blob[0] == serialization.TAG_NORMAL:
                    # Owned small result living in our memory store: inline
                    # the value into the spec — the executor never touches
                    # the object store (reference: dependency_resolver.h
                    # inlines memory-store args).
                    packed.append(("v", blob))
                    continue
                if blob is not None:
                    # Error result (TAG_ERROR): can't inline as a value —
                    # promote so the consumer's fetch finds (and raises) it.
                    self.promote_blob(key, blob)
                self.reference_counter.hold(a.id)
                borrowed.append(a.id)
                packed.append(("ref", key))
            else:
                blob = serialization.serialize_to_bytes(a)
                if len(blob) > CONFIG.max_direct_call_object_size:
                    ref = self.put(a)
                    self.reference_counter.hold(ref.id)
                    borrowed.append(ref.id)
                    packed.append(("ref", ref.id.binary()))
                else:
                    packed.append(("v", blob))
        packed.append(("haskw", bool(kwargs)))
        return packed, borrowed

    def _next_task_id(self) -> TaskID:
        base_actor = self.actor_id or ActorID.nil_of(self.job_id)
        return TaskID.of(base_actor)

    def _effective_runtime_env(self, options: dict) -> Optional[dict]:
        """Normalize the per-task runtime_env (zipping + uploading local
        dirs once per distinct env per session — .remote() passes a fresh
        copy of the options dict each call, so the cache lives on the
        worker, keyed by the env's canonical JSON) and merge it over the
        job env.  Local dir contents are snapshotted at first use in a
        session, like the reference's upload-at-decoration semantics."""
        import json as _json

        from ray_tpu_torch._private import runtime_env as runtime_env_mod

        raw = options.get("runtime_env")
        if not raw:
            return self.job_runtime_env
        # Key includes the session: a RemoteFunction reused across
        # shutdown()+init() must re-upload its packages to the new GCS.
        key = (
            self.session_info.get("session_dir") or "",
            _json.dumps(raw, sort_keys=True, default=str),
        )
        with self._lock:
            norm = self._runtime_env_norm_cache.get(key)
        if norm is None:
            norm = runtime_env_mod.normalize_uploaded(
                raw,
                lambda uri, blob: runtime_env_mod.finish_uploads(
                    self.gcs_client, [(uri, blob)]
                ),
            )
            with self._lock:
                self._runtime_env_norm_cache[key] = norm
        return runtime_env_mod.merge(self.job_runtime_env, norm or None)

    def submit_task(self, fn_blob: bytes, name: str, args, kwargs, options: dict):
        """Returns the List[ObjectRef] of the task's returns, or an
        ObjectRefGenerator when num_returns="streaming"."""
        self._check_connected()
        key = self._push_function(fn_blob)
        num_returns = options.get("num_returns", 1)
        is_streaming = num_returns == "streaming"
        if is_streaming:
            num_returns = 1  # return 0 is the end-of-stream sentinel
        resources = _resolve_resources(options, default_cpu=1.0)
        # Anything that can raise must run BEFORE _serialize_args holds
        # borrows — an exception in the hold→bind window would leak them
        # (the object would defer frees forever).
        strategy = _resolve_strategy(options)
        runtime_env = self._effective_runtime_env(options)
        packed_args, borrowed = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=self._next_task_id(),
            job_id=self.job_id,
            name=name,
            function_key=key,
            args=packed_args,
            num_returns=num_returns,
            resources=resources,
            max_retries=options.get("max_retries", CONFIG.task_max_retries),
            retry_exceptions=options.get("retry_exceptions", False),
            scheduling_strategy=strategy,
            owner_worker_id=self.worker_id,
            runtime_env=runtime_env,
            is_streaming=is_streaming,
            trace_parent=_current_traceparent(),
        )
        generator = None
        if is_streaming:
            # Register before submitting: items can start arriving the
            # moment the spec is pushed.  Yielded items are not covered by
            # lineage reconstruction (stream state is consumed as it
            # arrives), so streaming tasks are not retried for lost items.
            from ray_tpu_torch._private.streaming import ObjectRefGenerator

            generator = ObjectRefGenerator(self, spec)
        if CONFIG.lineage_reconstruction_enabled and not is_streaming:
            for oid in spec.return_ids():
                self.lineage[oid.binary()] = spec
        tid = spec.task_id.binary()
        submit_t0 = time.perf_counter()
        if (
            self._direct_submitter is not None
            and spec.scheduling_strategy.kind == "DEFAULT"
        ):
            oids = [o.binary() for o in spec.return_ids()]
            self.memory_store.add_pending(oids)
            # Direct path has a completion signal (task_finished /
            # _fail_spec): arg borrows return then, freeing args eagerly.
            self.reference_counter.bind_borrows(tid, borrowed)
            try:
                self._direct_submitter.submit(spec)
            except Exception:
                self.memory_store.resolve_stored(oids)
                self.reference_counter.escalate_to_escape(tid, borrowed)
                self._submit_with_retry(self.raylet_client, spec)
        else:
            # Raylet-mediated: no owner-side completion signal — args
            # stay pinned until job-end GC (escaped).
            self.reference_counter.escalate_to_escape(tid, borrowed)
            self._submit_with_retry(self.raylet_client, spec)
        telemetry.observe_task_phase("submit", time.perf_counter() - submit_t0)
        if generator is not None:
            return generator
        return [ObjectRef(oid, owned=True) for oid in spec.return_ids()]

    # ------------------------------------------------------------------
    # task cancellation (reference: core_worker.cc CancelTask)
    # ------------------------------------------------------------------
    def cancel_task(self, object_id: ObjectID, force: bool = False):
        tid = object_id.task_id().binary()
        self._cancelled_tasks.add(tid)
        if self._direct_submitter is not None and self._direct_submitter.cancel(tid, force):
            return
        # Actor task in flight on a direct channel?
        with self._lock:
            channels = list(self._actor_channels.values())
        for ch in channels:
            if tid in ch.inflight:
                try:
                    ch.client.push("cancel_task", {"task_id": tid, "force": force})
                except rpc.RpcError:
                    pass
                return
        # The set is only consulted by the direct-path lease/channel loss
        # handlers (which also prune it on completion); the remaining
        # branches resolve elsewhere, so keep the entry out of the set or
        # it would leak one tid per cancel for the life of the driver.
        self._cancelled_tasks.discard(tid)
        # Actor task parked waiting for a restarting/not-yet-alive actor.
        parked = self.actor_cache.cancel_pending(tid)
        if parked is not None:
            self._store_error_returns(
                parked, exceptions.TaskCancelledError(f"Task {parked.name} was cancelled")
            )
            return
        # Raylet-mediated (queued or running on a raylet-dispatched worker).
        try:
            self.raylet_client.call("cancel_task", {"task_id": tid, "force": force})
        except rpc.RpcError:
            pass

    def _handle_cancel_request(self, payload: dict):
        """Executor side: a cancel arrived for a task queued or running in
        THIS process."""
        import ctypes
        import signal

        tid = payload["task_id"]
        force = payload.get("force", False)
        self._cancel_requested.add(tid)
        ident = self._running_threads.get(tid)
        if ident is not None:
            if force:
                os._exit(1)
            if ident == threading.main_thread().ident:
                # Normal tasks run on the worker's main thread: a signal
                # interrupts even C-level blocking calls (time.sleep,
                # socket reads) — SetAsyncExc would wait for the next
                # Python bytecode that may never come (reference: the
                # worker raises KeyboardInterrupt off SIGINT the same
                # way).  The handler re-checks the target tid before
                # raising, so a cancel racing completion is a no-op.
                self._cancel_signal_tid = tid
                try:
                    signal.pthread_kill(ident, signal.SIGUSR1)
                except (OSError, ValueError):
                    pass
                return
            # Pool-thread tasks (concurrent actors): best-effort async
            # exception at the next bytecode boundary.  Re-check the
            # registry right before injecting to shrink the window where
            # a finished task's thread could be poisoned.
            if self._running_threads.get(tid) == ident:
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(ident),
                    ctypes.py_object(exceptions.TaskCancelledError),
                )
            return
        atask = self._running_async.get(tid)
        if atask is not None:
            if force:
                os._exit(1)
            if self._async_loop is not None:
                self._async_loop.call_soon_threadsafe(atask.cancel)

    def _install_cancel_signal_handler(self):
        """SIGUSR1 → TaskCancelledError in the main thread, iff the task
        it was aimed at is still the one running there."""
        import signal

        def handler(_sig, _frame):
            tid = self._cancel_signal_tid
            spec = self.current_spec
            if (
                tid is not None
                and spec is not None
                and spec.task_id.binary() == tid
                and self._running_threads.get(tid) == threading.get_ident()
            ):
                self._cancel_signal_tid = None
                raise exceptions.TaskCancelledError()

        try:
            signal.signal(signal.SIGUSR1, handler)
        except ValueError:
            pass  # not the main thread (embedded use); cancel stays best-effort

    def push_cancel_task(self, payload, conn):
        """Direct push from the owner (worker's RPC server)."""
        self._handle_cancel_request(payload)

    def _maybe_drop_cancelled(self, spec: TaskSpec, sink) -> bool:
        """Before execution: a task cancelled while queued stores
        TaskCancelledError and never runs."""
        if spec.task_id.binary() not in self._cancel_requested:
            return False
        self._cancel_requested.discard(spec.task_id.binary())
        self._store_error_returns(
            spec, exceptions.TaskCancelledError(f"Task {spec.name} was cancelled"), sink
        )
        return True

    # ------------------------------------------------------------------
    # streaming generators (owner side)
    # ------------------------------------------------------------------
    def _register_stream(self, spec: TaskSpec):
        from ray_tpu_torch._private.streaming import _StreamState

        state = _StreamState()
        with self._lock:
            self._streams[spec.task_id.binary()] = state
        return state

    def _drop_stream(self, task_id):
        with self._lock:
            self._streams.pop(task_id.binary() if hasattr(task_id, "binary") else task_id, None)

    def _on_stream_item(self, payload: dict):
        """A yielded item arrived from the executing worker (pushed on the
        direct/actor channel, before its task_finished)."""
        tid = payload["task_id"]
        state = self._streams.get(tid)
        if state is None:
            # Generator abandoned: discard — retaining blobs nobody will
            # ever consume leaks the owner's memory store for the rest of
            # the stream.
            return
        blob = payload.get("inline")
        if blob is not None:
            oid = payload["oid"]
            ms = self.memory_store
            ms.add_pending([oid])
            if ms.put(oid, blob):
                self.promote_blob(oid, blob)
        state.on_item(payload["index"])

    def _notify_stream_finished(self, task_id_bytes: bytes):
        state = self._streams.get(task_id_bytes)
        if state is not None:
            state.on_finished()

    def promote_blob(self, oid_bytes: bytes, blob: bytes):
        """Copy a memory-store object into the shm store so non-owners can
        fetch it (reference: memory-store → plasma promotion)."""
        try:
            self.raylet_client.push("store_put_inline", (oid_bytes, blob))
        except Exception:
            pass

    def on_ref_serialized(self, object_id: ObjectID):
        """An ObjectRef is being pickled (escaping into another object or
        process): promote its memory-store value and exempt it from eager
        free (reference: reference_count.h borrowing)."""
        key = object_id.binary()
        ms = self.memory_store
        if ms.is_tracked(key):
            blob = ms.get(key)
            if blob is not None:
                self.promote_blob(key, blob)
            else:
                ready = ms.mark_promote(key)
                if ready is not None:
                    self.promote_blob(key, ready)
        self.reference_counter.mark_escaped(object_id)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(self, cls_blob: bytes, class_name: str, args, kwargs, options: dict) -> ActorID:
        self._check_connected()
        key = self._push_function(cls_blob)
        actor_id = ActorID.of(self.job_id)
        resources = _resolve_resources(options, default_cpu=0.0)
        # Actor creation flows through the GCS with no owner-side
        # completion signal: creation args escape until job end.
        packed_args, borrowed = self._serialize_args(args, kwargs)
        self.reference_counter.escalate_to_escape(b"", borrowed)
        spec = TaskSpec(
            task_id=TaskID.of(actor_id),
            job_id=self.job_id,
            name=class_name,
            function_key=key,
            args=packed_args,
            num_returns=1,
            resources=resources,
            is_actor_creation=True,
            actor_id=actor_id,
            max_restarts=options.get("max_restarts", 0),
            max_task_retries=options.get("max_task_retries", 0),
            max_concurrency=options.get("max_concurrency", 1),
            concurrency_groups=options.get("concurrency_groups"),
            actor_name=options.get("name"),
            namespace=options.get("namespace") or self.namespace,
            detached=options.get("lifetime") == "detached",
            scheduling_strategy=_resolve_strategy(options),
            owner_worker_id=self.worker_id,
            runtime_env=self._effective_runtime_env(options),
            trace_parent=_current_traceparent(),
        )
        self.gcs_client.call("register_actor", {"spec": spec})
        return actor_id

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs, options: dict):
        self._check_connected()
        num_returns = options.get("num_returns", 1)
        is_streaming = num_returns == "streaming"
        if is_streaming:
            num_returns = 1
        # sequence_number is assigned at SEND time (_send_actor_task), per
        # actor incarnation, so queued/retried specs renumber consistently.
        packed_args, borrowed = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.of(actor_id),
            job_id=self.job_id,
            name=method_name,
            function_key=b"",
            args=packed_args,
            num_returns=num_returns,
            resources=ResourceSet(),
            is_actor_task=True,
            actor_id=actor_id,
            method_name=method_name,
            owner_worker_id=self.worker_id,
            is_streaming=is_streaming,
            trace_parent=_current_traceparent(),
            concurrency_group=options.get("concurrency_group"),
        )
        # Completion flows back through the actor channel / stored error
        # paths in this process, all of which return the borrows.
        self.reference_counter.bind_borrows(spec.task_id.binary(), borrowed)
        generator = None
        refs = []
        if is_streaming:
            from ray_tpu_torch._private.streaming import ObjectRefGenerator

            # the generator holds the sentinel's owned ref — building the
            # usual refs list too would add a second owned ref that dies
            # at return and (before the generator existed) freed the
            # sentinel cluster-wide at submit
            generator = ObjectRefGenerator(self, spec)
        else:
            refs = [ObjectRef(oid, owned=True) for oid in spec.return_ids()]
        if CONFIG.direct_actor_calls:
            # Mark returns in-flight now: gets wait on the memory store
            # until a completion path resolves them (inline result, stored
            # result, legacy handoff, or stored error).
            self.memory_store.add_pending([o.binary() for o in spec.return_ids()])
        if self.actor_cache.get(actor_id) is None:
            info = self.gcs_client.call("get_actor_info", actor_id.binary())
            if info is not None:
                self.actor_cache.set_initial(actor_id, info)
        info = self.actor_cache.submit_or_queue(actor_id, spec)
        if info is None:
            pass  # queued; flushed by the next pubsub state change
        elif info["state"] == "DEAD":
            self._store_error_returns(
                spec, exceptions.ActorDiedError(f"Actor is dead: {info.get('death_cause')}")
            )
        else:
            self._send_actor_task(spec, info)
        return generator if generator is not None else refs

    def _send_actor_task(self, spec: TaskSpec, info: dict):
        oids = [o.binary() for o in spec.return_ids()]
        self._assign_actor_seq(spec, info)
        worker_address = info.get("worker_address")
        if CONFIG.direct_actor_calls and worker_address:
            ch = self._get_actor_channel(spec.actor_id, worker_address)
            if ch is not None:
                self.memory_store.add_pending(oids)
                try:
                    ch.send(spec)
                    return
                except rpc.RpcError:
                    pass  # fall through to the raylet-mediated path
        address = info["raylet_address"]
        try:
            client = self._get_raylet_client(address)
            # No owner-side completion signal on this path: the spec's arg
            # borrows escape until job-end GC.
            self.reference_counter.escalate_to_escape(spec.task_id.binary())
            self._submit_with_retry(client, spec)
            # Results will be sealed in the shm store: stop gets from
            # waiting on the memory store for them.
            self.memory_store.resolve_stored(oids)
        except rpc.RpcError:
            self._store_error_returns(
                spec, exceptions.ActorUnavailableError("Could not reach the actor's node")
            )

    def _assign_actor_seq(self, spec: TaskSpec, info: dict):
        """Assign (incarnation, sequence_number) atomically at send time.
        The per-actor counter resets when a newer incarnation is first
        seen, so the restarted actor's fresh receiver state sees sequences
        starting at 1 again; a spec resent on the SAME incarnation keeps
        its number (the receiver dedupes redeliveries)."""
        actor_id = spec.actor_id
        with self._lock:
            inc = max(info.get("num_restarts", 0), self._actor_send_inc.get(actor_id, 0))
            if inc > self._actor_send_inc.get(actor_id, 0) or actor_id not in self._actor_send_inc:
                self._actor_send_inc[actor_id] = inc
                if inc > 0:
                    self._actor_seq[actor_id] = 0
            if spec.sequence_number == 0 or spec.actor_incarnation != inc:
                self._actor_seq[actor_id] += 1
                spec.sequence_number = self._actor_seq[actor_id]
                spec.actor_incarnation = inc

    def _get_actor_channel(self, actor_id: ActorID, address: str):
        from ray_tpu_torch._private.direct import ActorDirectChannel

        with self._lock:
            ch = self._actor_channels.get(actor_id)
            if ch is not None and ch.address == address and not ch.closed:
                return ch
            if ch is not None:
                try:
                    ch.close()
                except Exception:
                    pass
            try:
                ch = ActorDirectChannel(self, actor_id, address)
            except rpc.RpcError:
                self._actor_channels.pop(actor_id, None)
                return None
            self._actor_channels[actor_id] = ch
            return ch

    def _on_actor_channel_closed(self, ch):
        """Direct channel to an actor dropped (its worker died or is
        restarting).  In-flight specs may have executed before the drop, so
        they are retried only when the actor's max_task_retries allows it
        (reference: max_task_retries semantics — actor methods are NOT
        retried by default); otherwise their returns get a RayActorError.
        Retriable specs reroute through the actor state cache so pubsub
        decides — resend on ALIVE, error on DEAD."""
        with self._lock:
            if self._actor_channels.get(ch.actor_id) is ch:
                del self._actor_channels[ch.actor_id]
        inflight = sorted(ch.inflight.values(), key=lambda s: s.sequence_number)
        ch.inflight.clear()
        if not inflight:
            return
        cached = self.actor_cache.get(ch.actor_id) or {}
        allowed_retries = cached.get("max_task_retries", 0)
        retriable = []
        for spec in inflight:
            tid = spec.task_id.binary()
            if tid in self._cancelled_tasks:
                # A force-cancel killed the actor worker mid-task: resolve
                # as cancelled (not actor-death) and prune the entry.
                self._cancelled_tasks.discard(tid)
                self._store_error_returns(
                    spec,
                    exceptions.TaskCancelledError(f"Task {spec.name} was cancelled"),
                )
            elif allowed_retries == -1 or spec.attempt_number < allowed_retries:
                spec.attempt_number += 1
                retriable.append(spec)
            else:
                self._store_error_returns(
                    spec,
                    exceptions.RayActorError(
                        f"The actor died while {spec.name}.{spec.method_name} was in flight"
                    ),
                )
        if not retriable:
            return
        self.actor_cache.mark_unavailable(ch.actor_id)
        for spec in retriable:
            info = self.actor_cache.submit_or_queue(ch.actor_id, spec)
            if info is None:
                continue  # queued; pubsub flush will resend or error
            if info["state"] == "DEAD":
                self._store_error_returns(
                    spec, exceptions.ActorDiedError(f"Actor died: {info.get('death_cause')}")
                )
            else:
                self._send_actor_task(spec, info)

    def _get_raylet_client(self, address: str) -> rpc.RpcClient:
        with self._lock:
            c = self._raylet_clients.get(address)
            if c is None or c.closed:
                if address == self.raylet_client.address:
                    return self.raylet_client
                # Same push handler as the home raylet: spilled leases are
                # owned through these connections, and their raylet must
                # be able to reach us (oom_kill, revoke_lease).
                c = rpc.RpcClient(address, on_push=self._on_raylet_push)
                self._raylet_clients[address] = c
            return c

    def _store_error_returns(self, spec: TaskSpec, err: Exception, sink=None):
        blob_meta, bufs = serialization.serialize(err, tag=serialization.TAG_ERROR)
        small = serialization.total_size(blob_meta, bufs) <= CONFIG.max_direct_call_object_size
        if sink is not None and small:
            blob = bytearray(serialization.total_size(blob_meta, bufs))
            serialization.write_into(memoryview(blob), blob_meta, bufs)
            for oid in spec.return_ids():
                sink["inline"].append((oid.binary(), bytes(blob)))
            return
        for oid in spec.return_ids():
            self.store.put_serialized(oid, blob_meta, bufs)
            if sink is not None:
                sink["stored"].append(oid.binary())
        # The owner may be blocked on these as in-flight direct results
        # (e.g. an actor died and errors were stored on its behalf).
        self.memory_store.resolve_stored([o.binary() for o in spec.return_ids()])
        # Owner-side finalization: the task will never run (or gave up),
        # so its arg borrows return.  No-op in the executing worker's
        # process, where the spec was never bound.
        self.reference_counter.return_borrows(spec.task_id.binary())

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.gcs_client.call("kill_actor", {"actor_id": actor_id.binary(), "no_restart": no_restart})

    def get_named_actor(self, name: str, namespace: Optional[str]):
        ns = namespace or self.namespace
        reply = self.gcs_client.call("get_named_actor", (ns, name))
        if reply is None:
            raise ValueError(f"Failed to look up actor '{name}' in namespace '{ns}'")
        return reply

    # ------------------------------------------------------------------
    # worker-mode execution loop
    # ------------------------------------------------------------------
    def main_loop(self):
        """Blocks forever executing tasks pushed by the raylet or direct
        submitters (queue items are (spec, reply_conn-or-None))."""
        while not self._shutdown_event.is_set():
            try:
                item = self._exec_queue.get(timeout=1.0)
            except queue.Empty:
                continue
            except exceptions.TaskCancelledError:
                # Stray cancel signal that raced its task's completion:
                # the loop itself must survive.
                continue
            if item is None:
                break
            spec, conn = item
            if spec.is_actor_task and self._exec_pool is not None:
                pool = self._exec_pool
                if spec.concurrency_group and self._group_pools:
                    pool = self._group_pools.get(spec.concurrency_group, pool)
                pool.submit(self._execute_task_guarded, spec, conn)
            elif spec.is_actor_task and self._async_loop is not None:
                import asyncio

                asyncio.run_coroutine_threadsafe(
                    self._execute_task_async(spec, conn), self._async_loop
                )
            else:
                self._execute_task_guarded(spec, conn)
        self.disconnect()

    def _execute_task_guarded(self, spec: TaskSpec, conn=None):
        # Chaos fault point: "@worker.exec:kill:at=N" hard-kills this
        # worker process on its N-th task execution (reference:
        # test_utils RayletKiller generalized to the worker plane).  The
        # exit is deliberately os._exit — no atexit, no socket teardown —
        # matching a SIGKILL/OOM death.
        if CHAOS.active and CHAOS.maybe_kill("worker.exec"):
            logger.warning("chaos: killing worker before task %s", spec.name)
            os._exit(1)
        start = time.time()
        error = None
        # enter a child span of the submitter's trace context, so spans
        # nest across task hops (reference: tracing_helper.py)
        from ray_tpu_torch.util import tracing as _tracing

        _tracing.install_context(getattr(spec, "trace_parent", None))
        try:
            self._execute_task(spec, conn)
        except BaseException as e:  # pragma: no cover — never crash the loop
            error = repr(e)
            traceback.print_exc()
        end = time.time()
        # The installed context's span id is what child submissions were
        # stamped with — record THAT id as the task span so the tree
        # reassembles across the process hop.
        _tracing.record_span(
            "task::" + spec.name,
            start,
            end,
            {"task_id": spec.task_id.hex(), "ok": error is None},
            context=_tracing.current_context(),
        )
        telemetry.observe_task_phase("exec", end - start)
        self._record_task_event(spec, start, end, error)

    def _record_task_event(self, spec: TaskSpec, start: float, end: float, error):
        """Buffer a task event; a background thread flushes batches to the
        GCS task table (reference: core_worker/task_event_buffer.h →
        gcs_task_manager.h:86)."""
        try:
            event = {
                "task_id": spec.task_id.hex(),
                "name": spec.name,
                "state": "FAILED" if error else "FINISHED",
                "error": error,
                "start_time": start,
                "end_time": end,
                "worker_id": self.worker_id.hex() if self.worker_id else "",
                "node_id": self.node_id.hex() if self.node_id else "",
                "job_id": spec.job_id.hex(),
                "actor_id": spec.actor_id.hex() if spec.is_actor_task else None,
            }
            from ray_tpu_torch.util import tracing as _tracing

            if _tracing.get_trace_id() is not None:
                event["trace_id"] = _tracing.get_trace_id()
                event["span_id"] = _tracing.get_span_id()
            with self._task_event_lock:
                self._task_events.append(event)
                if self._task_event_flusher is None:
                    self._task_event_flusher = threading.Thread(
                        target=self._task_event_flush_loop, daemon=True, name="task-events"
                    )
                    self._task_event_flusher.start()
        except Exception:
            pass

    def _task_event_flush_loop(self):
        while not self._shutdown_event.is_set():
            time.sleep(1.0)
            if self.gcs_client is None:
                continue
            with self._task_event_lock:
                events, self._task_events = self._task_events, []
            if not events:
                continue
            try:
                self.gcs_client.call("task_event_report", {"events": events})
            except Exception:
                pass

    def _resolve_args(self, spec: TaskSpec):
        packed = spec.args
        has_kwargs = False
        values = []
        for kind, payload in packed:
            if kind == "haskw":
                has_kwargs = payload
                continue
            if kind == "v":
                _, value = serialization.deserialize(memoryview(payload))
            elif kind == "ref":
                oid = ObjectID(payload)
                bo = retry.ARG_RESOLVE.start()
                while True:
                    try:
                        tag, value = self.store.get_serialized(oid, None)
                        break
                    except exceptions.ObjectLostError:
                        # This worker may own the arg (nested task) and can
                        # reconstruct.  Otherwise fail fast: the stored
                        # ObjectLostError-caused error routes recovery to
                        # the owner's get (Worker._get_one).
                        if self._recover_object(oid):
                            continue
                        delay = bo.next_delay()
                        if delay is None:
                            raise
                        time.sleep(delay)
                if tag == serialization.TAG_ERROR:
                    raise value if not isinstance(value, exceptions.RayTaskError) else value.as_instanceof_cause()
            values.append(value)
        if has_kwargs:
            kwargs = values.pop()
        else:
            kwargs = {}
        return values, kwargs

    def _execute_task(self, spec: TaskSpec, conn=None):
        self.current_spec = spec
        self.current_task_id = spec.task_id
        sink = None if conn is None else {"inline": [], "stored": []}
        self._running_threads[spec.task_id.binary()] = threading.get_ident()
        try:
            if self._maybe_drop_cancelled(spec, sink):
                pass
            elif spec.is_actor_creation:
                self._execute_actor_creation(spec, sink)
            elif spec.is_actor_task:
                self._execute_actor_method(spec, sink, conn)
            else:
                self._execute_normal_task(spec, sink, conn)
        finally:
            self._running_threads.pop(spec.task_id.binary(), None)
            self._cancel_requested.discard(spec.task_id.binary())
            self.current_spec = None
            self.current_task_id = None
            if conn is not None:
                self._send_task_finished(spec, conn, sink)
            else:
                try:
                    self.raylet_client.call("task_done", {"task_id": spec.task_id.binary()})
                except rpc.RpcError:
                    pass

    def _send_task_finished(self, spec: TaskSpec, conn, sink):
        """Reply to a direct push: small results ride inline, the rest are
        announced as stored.  Every return id is accounted for so the
        owner's pending-set always resolves."""
        accounted = {o for o, _ in sink["inline"]} | set(sink["stored"])
        missing = [o.binary() for o in spec.return_ids() if o.binary() not in accounted]
        if missing:
            # System failure before results were produced: store an error
            # so gets surface it (and non-owners can see it too).
            err = exceptions.RaySystemError(f"task {spec.name} produced no result")
            blob = serialization.serialize_to_bytes(err, tag=serialization.TAG_ERROR)
            for ob in missing:
                try:
                    self.store.put_blob(ObjectID(ob), blob)
                except Exception:
                    pass
                sink["stored"].append(ob)
        payload = {
            "task_id": spec.task_id.binary(),
            "inline": sink["inline"],
            "stored": sink["stored"],
        }
        try:
            self._direct_loop.call_soon_threadsafe(conn.push, "task_finished", payload)
        except RuntimeError:
            pass  # server loop already stopped (process exiting)

    def _store_returns(self, spec: TaskSpec, result: Any, sink=None):
        n = spec.num_returns
        if n == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != n:
                raise ValueError(f"Task {spec.name} returned {len(results)} values, expected {n}")
        for oid, value in zip(spec.return_ids(), results):
            meta, bufs = serialization.serialize(value)
            if sink is not None and serialization.total_size(meta, bufs) <= CONFIG.max_direct_call_object_size:
                blob = bytearray(serialization.total_size(meta, bufs))
                serialization.write_into(memoryview(blob), meta, bufs)
                sink["inline"].append((oid.binary(), bytes(blob)))
            else:
                self.store.put_serialized(oid, meta, bufs)
                if sink is not None:
                    sink["stored"].append(oid.binary())

    def _execute_normal_task(self, spec: TaskSpec, sink=None, conn=None):
        try:
            fn = self._fetch_function(spec.function_key)
            args, kwargs = self._resolve_args(spec)
            result = fn(*args, **kwargs)
            if spec.is_streaming:
                self._drain_stream(spec, result, sink, conn)
            else:
                self._store_returns(spec, result, sink)
        except exceptions.TaskCancelledError:
            # Injected by ray_tpu_torch.cancel: stored unwrapped so the owner's
            # get raises TaskCancelledError itself, not RayTaskError.
            self._store_error_returns(
                spec, exceptions.TaskCancelledError(f"Task {spec.name} was cancelled"), sink
            )
        except Exception as e:  # noqa: BLE001
            self._store_error_returns(
                spec, exceptions.RayTaskError.from_exception(e, spec.name), sink
            )

    def _emit_stream_item(self, spec: TaskSpec, index: int, value, conn) -> None:
        """Seal one yielded item and announce it to the owner immediately
        (reference: generator_waiter.h — report before continuing)."""
        oid = spec.stream_item_id(index)
        meta, bufs = serialization.serialize(value)
        size = serialization.total_size(meta, bufs)
        payload = {"task_id": spec.task_id.binary(), "index": index, "oid": oid.binary()}
        if conn is not None and size <= CONFIG.max_direct_call_object_size:
            blob = bytearray(size)
            serialization.write_into(memoryview(blob), meta, bufs)
            payload["inline"] = bytes(blob)
        else:
            self.store.put_serialized(oid, meta, bufs)
        if conn is not None:
            try:
                # Same loop as the eventual task_finished push: FIFO per
                # connection, so the owner sees every item first.
                self._direct_loop.call_soon_threadsafe(conn.push, "stream_item", payload)
            except RuntimeError:
                pass  # server loop stopped (process exiting)

    def _drain_stream(self, spec: TaskSpec, result, sink, conn) -> None:
        from ray_tpu_torch._private.streaming import StreamEnd

        if not hasattr(result, "__next__") and not hasattr(result, "__iter__"):
            raise TypeError(
                f"Task {spec.name} has num_returns='streaming' but returned "
                f"{type(result).__name__}, not a generator/iterable"
            )
        count = 0
        for item in result:
            self._emit_stream_item(spec, count, item, conn)
            count += 1
        self._store_returns(spec, StreamEnd(count), sink)

    def _execute_actor_creation(self, spec: TaskSpec, sink=None):
        try:
            cls = self._fetch_function(spec.function_key)
            args, kwargs = self._resolve_args(spec)
            self.actor_instance = cls(*args, **kwargs)
            self.actor_id = spec.actor_id
            # Set up concurrency: thread pool or asyncio loop.
            has_async = any(
                inspect.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
                for _, m in inspect.getmembers(type(self.actor_instance), inspect.isfunction)
            )
            if has_async:
                import asyncio

                loop = asyncio.new_event_loop()
                self._async_loop = loop
                self._async_sem = None
                mc = spec.max_concurrency if spec.max_concurrency > 1 else 1000
                self._async_concurrency = mc

                def run_loop():
                    asyncio.set_event_loop(loop)
                    loop.run_forever()

                self._async_loop_thread = threading.Thread(target=run_loop, daemon=True, name="actor-async-loop")
                self._async_loop_thread.start()
            elif spec.max_concurrency > 1 or spec.concurrency_groups:
                from concurrent.futures import ThreadPoolExecutor

                self._exec_pool = ThreadPoolExecutor(
                    max_workers=max(1, spec.max_concurrency), thread_name_prefix="actor-exec"
                )
            # Named concurrency groups: a dedicated bounded pool per group
            # (reference: core_worker/concurrency_group_manager.h — one
            # thread/fiber pool per group).  For async actors the bound is
            # a per-group semaphore on the actor loop instead.
            if spec.concurrency_groups:
                if self._async_loop is not None:
                    import asyncio as _aio

                    # Loop-agnostic since 3.10: safe to construct off-loop.
                    self._async_group_sems = {
                        g: _aio.Semaphore(max(1, int(n)))
                        for g, n in spec.concurrency_groups.items()
                    }
                else:
                    from concurrent.futures import ThreadPoolExecutor

                    self._group_pools = {
                        g: ThreadPoolExecutor(
                            max_workers=max(1, int(n)),
                            thread_name_prefix=f"actor-cg-{g}",
                        )
                        for g, n in spec.concurrency_groups.items()
                    }
            # The creation return is checked by the raylet/GCS as well as
            # the owner: always seal it in the store, never inline-only.
            self._store_returns(spec, None, None)
        except Exception as e:  # noqa: BLE001
            self._store_error_returns(spec, exceptions.RayTaskError.from_exception(e, f"{spec.name}.__init__"))

    def _run_actor_method(self, spec: TaskSpec):
        args, kwargs = self._resolve_args(spec)
        if spec.method_name == "__ray_call__":
            fn, *rest = args
            return fn(self.actor_instance, *rest, **kwargs)
        method = getattr(self.actor_instance, spec.method_name)
        return method(*args, **kwargs)

    def _execute_actor_method(self, spec: TaskSpec, sink=None, conn=None):
        try:
            if spec.method_name == "__ray_terminate__":
                self._store_returns(spec, None, sink)
                self._intended_exit = True
                self._shutdown_event.set()
                self._exec_queue.put(None)
                return
            result = self._run_actor_method(spec)
            if spec.is_streaming:
                self._drain_stream(spec, result, sink, conn)
            else:
                self._store_returns(spec, result, sink)
        except exceptions.TaskCancelledError:
            self._store_error_returns(
                spec,
                exceptions.TaskCancelledError(
                    f"Task {spec.name}.{spec.method_name} was cancelled"
                ),
                sink,
            )
        except Exception as e:  # noqa: BLE001
            self._store_error_returns(
                spec, exceptions.RayTaskError.from_exception(e, f"{spec.name}.{spec.method_name}"), sink
            )

    async def _execute_task_async(self, spec: TaskSpec, conn=None):
        """Async-actor path: methods run as coroutines on the actor loop
        (reference: core_worker/transport/fiber.h — fibers → asyncio)."""
        import asyncio

        tid = spec.task_id.binary()
        self._running_async[tid] = asyncio.current_task()
        try:
            sem = (
                self._async_group_sems.get(spec.concurrency_group)
                if spec.concurrency_group
                else None
            )
            if sem is not None:
                async with sem:
                    return await self._execute_task_async_inner(spec, conn)
            return await self._execute_task_async_inner(spec, conn)
        finally:
            self._running_async.pop(tid, None)
            self._cancel_requested.discard(tid)

    async def _execute_task_async_inner(self, spec: TaskSpec, conn=None):
        from ray_tpu_torch.util import tracing as _tracing

        _tracing.install_context(getattr(spec, "trace_parent", None))
        self.current_spec = spec
        sink = None if conn is None else {"inline": [], "stored": []}
        if self._maybe_drop_cancelled(spec, sink):
            if conn is not None:
                self._send_task_finished(spec, conn, sink)
            self.current_spec = None
            return
        exec_start = time.time()
        try:
            if spec.method_name == "__ray_terminate__":
                self._store_returns(spec, None, sink)
                self._intended_exit = True
                self._shutdown_event.set()
                self._exec_queue.put(None)
                return
            result = self._run_actor_method(spec)
            if inspect.iscoroutine(result):
                result = await result
            if spec.is_streaming:
                if hasattr(result, "__aiter__"):
                    from ray_tpu_torch._private.streaming import StreamEnd

                    count = 0
                    async for item in result:
                        self._emit_stream_item(spec, count, item, conn)
                        count += 1
                    self._store_returns(spec, StreamEnd(count), sink)
                else:
                    self._drain_stream(spec, result, sink, conn)
            else:
                self._store_returns(spec, result, sink)
        except BaseException as e:  # noqa: BLE001
            import asyncio

            if isinstance(e, asyncio.CancelledError):
                # ray_tpu_torch.cancel on a running coroutine: store the typed
                # error (NOT wrapped in RayTaskError, so user code can
                # `except TaskCancelledError`) and swallow the cancel so
                # the finally still reports completion.
                self._store_error_returns(
                    spec,
                    exceptions.TaskCancelledError(
                        f"Task {spec.name}.{spec.method_name} was cancelled"
                    ),
                    sink,
                )
            elif isinstance(e, Exception):
                self._store_error_returns(
                    spec, exceptions.RayTaskError.from_exception(e, f"{spec.name}.{spec.method_name}"), sink
                )
            else:
                raise
        finally:
            exec_end = time.time()
            _tracing.record_span(
                "task::" + spec.name + "." + (spec.method_name or ""),
                exec_start,
                exec_end,
                {"task_id": spec.task_id.hex()},
                context=_tracing.current_context(),
            )
            telemetry.observe_task_phase("exec", exec_end - exec_start)
            self.current_spec = None
            if conn is not None:
                self._send_task_finished(spec, conn, sink)
            else:
                try:
                    self.raylet_client.call("task_done", {"task_id": spec.task_id.binary()})
                except rpc.RpcError:
                    pass

    def _check_connected(self):
        if not self.connected:
            raise exceptions.RaySystemError(
                "ray_tpu_torch has not been initialized. Call ray_tpu_torch.init() first."
            )


def _resolve_resources(options: dict, default_cpu: float) -> ResourceSet:
    res = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    res["CPU"] = default_cpu if num_cpus is None else num_cpus
    if options.get("num_gpus") is not None:
        res["GPU"] = options["num_gpus"]
    if options.get("memory") is not None:
        res["memory"] = options["memory"]
    return ResourceSet.of(res)


def _resolve_strategy(options: dict) -> SchedulingStrategy:
    strategy = options.get("scheduling_strategy")
    if strategy is None:
        pg = options.get("placement_group")
        if pg is not None:
            from ray_tpu_torch.util.placement_group import PlacementGroup

            assert isinstance(pg, PlacementGroup)
            return SchedulingStrategy(
                kind="PLACEMENT_GROUP",
                placement_group_id=pg.id,
                bundle_index=options.get("placement_group_bundle_index", -1),
            )
        return SchedulingStrategy()
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return SchedulingStrategy(kind="SPREAD")
        if strategy == "DEFAULT":
            return SchedulingStrategy()
        raise ValueError(f"unknown scheduling strategy {strategy}")
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=strategy.placement_group.id,
            bundle_index=strategy.placement_group_bundle_index,
            capture_child_tasks=strategy.placement_group_capture_child_tasks,
        )
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(
            kind="NODE_AFFINITY", node_id=NodeID(bytes.fromhex(strategy.node_id)), soft=strategy.soft
        )
    from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy

    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return SchedulingStrategy(kind="NODE_LABEL", labels=dict(strategy.hard))
    raise ValueError(f"unknown scheduling strategy {strategy!r}")


_global_worker: Optional[Worker] = None
def _current_traceparent():
    """Trace context to stamp onto outgoing specs (None when the caller
    isn't inside a span or a traced task)."""
    from ray_tpu_torch.util import tracing

    return tracing.current_traceparent()


_worker_lock = threading.Lock()


def get_global_worker() -> Worker:
    global _global_worker
    with _worker_lock:
        if _global_worker is None:
            _global_worker = Worker()
        return _global_worker


def global_worker_maybe() -> Optional[Worker]:
    return _global_worker
