"""Direct worker-to-worker task submission.

The submitter leases workers from the raylet per *scheduling key* (resource
shape) and pushes task specs straight to the leased worker's RPC endpoint —
the raylet is out of the per-task data path.  Results small enough to
inline come back on the task-finished push and land in the owner's
MemoryStore (reference: src/ray/core_worker/transport/
normal_task_submitter.h:74 — lease request normal_task_submitter.cc:295,
direct push :542; lease reuse per SchedulingKey).

Wire protocol (submitter <-> leased worker, framed-pickle rpc.py):
    -> push "exec_direct"   {"spec": TaskSpec}
    <- push "task_finished" {"task_id": bytes,
                             "inline": [(oid_bytes, blob)], # small results
                             "stored": [oid_bytes]}         # sealed in shm
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private import retry, rpc, telemetry
from ray_tpu_torch._private.common import TaskSpec
from ray_tpu_torch._private.config import CONFIG

logger = logging.getLogger(__name__)


class _Lease:
    __slots__ = (
        "worker_id", "address", "client", "inflight", "started",
        "idle_since", "key", "dead", "raylet", "draining",
    )

    def __init__(self, worker_id: bytes, address: str, client: rpc.RpcClient, key, raylet):
        self.worker_id = worker_id
        self.address = address
        self.client = client
        self.inflight: Dict[bytes, TaskSpec] = {}  # task_id bytes -> spec
        self.started: Dict[bytes, float] = {}  # task_id bytes -> dispatch time
        self.idle_since = time.monotonic()
        self.key = key
        self.dead = False
        # The raylet client that granted this lease — returns must go back
        # to it (a spilled lease belongs to the REMOTE node's raylet).
        self.raylet = raylet
        # Set when the lease's node enters DRAINING: no new specs are
        # assigned; the lease is returned once its in-flight work drains.
        self.draining = False


class _KeyState:
    __slots__ = (
        "key", "resources", "runtime_env", "pending", "leases",
        "requests_inflight", "ewma_ms",
    )

    def __init__(self, key, resources, runtime_env=None):
        self.key = key
        self.resources = resources
        self.runtime_env = runtime_env
        self.pending: deque = deque()
        self.leases: Dict[bytes, _Lease] = {}
        self.requests_inflight = 0
        # EWMA task duration for this key; None until the first completion.
        # Long tasks want many workers, short tasks want few + pipelining.
        self.ewma_ms: Optional[float] = None


class DirectTaskSubmitter:
    """One per Worker process; submits normal (non-actor) tasks directly."""

    def __init__(self, worker):
        self._worker = worker
        self._lock = threading.Lock()
        self._keys: Dict[Tuple, _KeyState] = {}
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="lease-req")
        self._closed = False
        # More leased workers than cores just thrash the scheduler; spread
        # work 1-per-worker up to this cap, then pipeline deeper instead.
        self._lease_cap = max(
            1, min(CONFIG.max_leases_per_scheduling_key, os.cpu_count() or 1)
        )
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True, name="lease-reaper")
        self._reaper.start()

    # ------------------------------------------------------------------
    def scheduling_key(self, spec: TaskSpec) -> Tuple:
        from ray_tpu_torch._private import runtime_env as runtime_env_mod

        return (
            tuple(sorted(spec.resources.items())),
            spec.job_id.binary(),
            runtime_env_mod.spec_env_hash(spec),
        )

    def submit(self, spec: TaskSpec) -> None:
        """Queue a spec; dispatches to an idle lease or requests one."""
        with self._lock:
            if self._closed:
                raise rpc.ConnectionLost("submitter closed")
            key = self.scheduling_key(spec)
            ks = self._keys.get(key)
            if ks is None:
                ks = self._keys[key] = _KeyState(key, spec.resources, spec.runtime_env)
            ks.pending.append(spec)
            self._assign_locked(ks)
            self._maybe_request_leases_locked(ks)

    # ------------------------------------------------------------------
    def _dynamic_cap(self, ks: _KeyState) -> int:
        """Lease cap for this key.  Short tasks: ~one lease per core and
        pipeline (more workers than cores just thrash).  Long tasks (EWMA
        above lease_grow_task_ms): grow to the configured max — the raylet's
        resource accounting is the real bound."""
        if ks.ewma_ms is not None and ks.ewma_ms > CONFIG.lease_grow_task_ms:
            return CONFIG.max_leases_per_scheduling_key
        return self._lease_cap

    @staticmethod
    def _live_leases(ks: _KeyState) -> int:
        # Draining leases take no new work — they must not suppress
        # replacement lease requests.
        return sum(1 for l in ks.leases.values() if not l.dead and not l.draining)

    def _assign_locked(self, ks: _KeyState) -> None:
        # While more leases can still be granted, keep one task per worker
        # (parallelism first); once at the cap, pipeline deeper so workers
        # never sit idle waiting on the submit round trip.  Until the first
        # completion calibrates the key, stay at depth 1 so long tasks
        # aren't queued behind each other on one worker.
        live = self._live_leases(ks)
        saturated = live + ks.requests_inflight >= self._dynamic_cap(ks)
        short_tasks = ks.ewma_ms is not None and ks.ewma_ms <= CONFIG.lease_grow_task_ms
        depth = CONFIG.lease_pipeline_depth if (saturated and short_tasks) else 1
        # Round-robin: give each lease one spec per pass for balance.
        progress = True
        while ks.pending and progress:
            progress = False
            for lease in ks.leases.values():
                if (
                    lease.dead
                    or lease.draining
                    or len(lease.inflight) >= depth
                    or not ks.pending
                ):
                    continue
                spec = ks.pending.popleft()
                tid = spec.task_id.binary()
                lease.inflight[tid] = spec
                # (dispatch time, queue position) — the position divides the
                # observed latency so pipelined queue-wait doesn't read as
                # long task execution.
                lease.started[tid] = (time.monotonic(), len(lease.inflight))
                try:
                    lease.client.push("exec_direct", {"spec": spec})
                    progress = True
                except rpc.RpcError:
                    # Connection died between checks; on_close requeues.
                    lease.inflight.pop(tid, None)
                    lease.started.pop(tid, None)
                    ks.pending.appendleft(spec)

    def _maybe_request_leases_locked(self, ks: _KeyState) -> None:
        if self._closed or not ks.pending:
            return
        live = self._live_leases(ks)
        # One outstanding request per pending task, up to the cap — the
        # raylet parks requests it can't grant yet, so over-requesting is
        # cheap and under-requesting serializes the whole queue.
        want = min(len(ks.pending), self._dynamic_cap(ks) - live - ks.requests_inflight)
        for _ in range(max(0, want)):
            ks.requests_inflight += 1
            self._pool.submit(self._request_lease, ks)

    def _request_lease(self, ks: _KeyState, raylet_client=None, hops: int = 0):
        reply = None
        client = raylet_client or self._worker.raylet_client
        # Idempotency token, stable across retries: a redelivered or
        # retried request joins the original grant on the raylet side
        # instead of leasing a second worker that would leak LEASED.
        token = os.urandom(16)
        bo = retry.SUBMIT.start()
        lease_t0 = time.perf_counter()
        while True:
            try:
                reply = client.call(
                    "request_worker_lease",
                    {
                        "resources": dict(ks.resources),
                        "job_id": self._worker.job_id.binary(),
                        "spilled": hops > 0,
                        "runtime_env": ks.runtime_env,
                        "token": token,
                        # Tenant plane: the raylet's fair-share queue
                        # orders and quota-gates by these.
                        "tenant": self._worker.tenant,
                        "priority": self._worker.tenant_priority,
                    },
                    timeout=CONFIG.worker_lease_timeout_ms / 1000,
                )
                break
            except rpc.CallTimeout:
                # Reply lost in flight (the grant may be parked on the
                # raylet): re-ask with the SAME token — we either join
                # the in-flight grant or start one.
                delay = bo.next_delay()
                if delay is None:
                    reply = None
                    break
                time.sleep(delay)
            except Exception:
                # Raylet-side errors cross the wire as their original type
                # (e.g. OSError from a failed worker spawn) — any failure
                # here must still decrement requests_inflight via
                # _on_lease_reply or the scheduling key wedges permanently.
                reply = None
                break
        if reply and reply.get("runtime_env_error"):
            self._fail_pending_env(ks, reply["runtime_env_error"])
            reply = None
        if reply and reply.get("spill") and hops < 4:
            try:
                peer = self._worker._get_raylet_client(reply["spill"])
                return self._request_lease(ks, raylet_client=peer, hops=hops + 1)
            except rpc.RpcError:
                reply = None
        if reply and reply.get("worker_id"):
            telemetry.observe_task_phase("lease", time.perf_counter() - lease_t0)
        self._on_lease_reply(ks, reply, client)

    def _on_lease_reply(self, ks: _KeyState, reply: Optional[dict], raylet_client) -> None:
        lease = None
        if reply and reply.get("worker_id") and reply.get("address"):
            try:
                wid, address = reply["worker_id"], reply["address"]
                client = rpc.RpcClient(
                    address,
                    on_push=lambda m, p: self._on_worker_push(wid, ks, m, p),
                    on_close=lambda: self._on_lease_lost(wid, ks),
                )
                lease = _Lease(wid, address, client, ks.key, raylet_client)
            except rpc.RpcError:
                self._return_lease_to_raylet(reply["worker_id"], raylet_client)
        surplus = None
        with self._lock:
            ks.requests_inflight = max(0, ks.requests_inflight - 1)
            if lease is not None:
                if self._closed or (not ks.pending and not ks.leases):
                    # Granted after the queue drained: hand it back rather
                    # than holding resources we have no work for.
                    surplus = lease
                else:
                    ks.leases[lease.worker_id] = lease
                    lease.idle_since = time.monotonic()
                    self._assign_locked(ks)
            # On failure with work remaining, do NOT re-request inline —
            # an unsatisfiable shape (too big for every node) would turn
            # that into a hot submitter<->raylet RPC loop.  The reaper
            # re-kicks stranded queues on its 100 ms tick instead.
        if surplus is not None:
            try:
                surplus.client.close()
            except Exception:
                pass
            self._return_lease_to_raylet(surplus.worker_id, surplus.raylet)

    # ------------------------------------------------------------------
    def _on_worker_push(self, wid: bytes, ks: _KeyState, method: str, payload) -> None:
        if method == "stream_item":
            self._worker._on_stream_item(payload)
            return
        if method != "task_finished":
            return
        ms = self._worker.memory_store
        for oid, blob in payload.get("inline", ()):
            if ms.put(oid, blob):
                self._worker.promote_blob(oid, blob)
        ms.resolve_stored(payload.get("stored", ()))
        self._worker._notify_stream_finished(payload["task_id"])
        self._worker.reference_counter.return_borrows(payload["task_id"])
        self._worker._cancelled_tasks.discard(payload["task_id"])
        retire = None
        with self._lock:
            lease = ks.leases.get(wid)
            if lease is None:
                return
            tid = payload["task_id"]
            lease.inflight.pop(tid, None)
            started = lease.started.pop(tid, None)
            if started is not None:
                t0, qpos = started
                telemetry.observe_task_phase("e2e", time.monotonic() - t0)
                dt_ms = (time.monotonic() - t0) * 1000 / max(1, qpos)
                ks.ewma_ms = dt_ms if ks.ewma_ms is None else 0.8 * ks.ewma_ms + 0.2 * dt_ms
            self._assign_locked(ks)
            self._maybe_request_leases_locked(ks)
            if not lease.inflight:
                lease.idle_since = time.monotonic()
                if lease.draining:
                    # Last in-flight task on a draining node finished:
                    # hand the worker back before the node disappears.
                    ks.leases.pop(wid, None)
                    lease.dead = True
                    retire = lease
        if retire is not None:
            try:
                retire.client.close()
            except Exception:
                pass
            self._return_lease_to_raylet(retire.worker_id, retire.raylet)

    def on_node_draining(self, raylet_address: Optional[str]) -> None:
        """The named node entered DRAINING (nodes pubsub): stop feeding
        its leases, return idle ones now, and request replacement leases
        for queued work — the proactive path, instead of waiting for the
        node to die under our in-flight tasks."""
        if raylet_address is None:
            return
        to_return = []
        with self._lock:
            for ks in self._keys.values():
                for wid, lease in list(ks.leases.items()):
                    if lease.dead or lease.draining:
                        continue
                    if getattr(lease.raylet, "address", None) != raylet_address:
                        continue
                    lease.draining = True
                    if not lease.inflight:
                        ks.leases.pop(wid, None)
                        lease.dead = True
                        to_return.append(lease)
                if ks.pending:
                    self._maybe_request_leases_locked(ks)
        for lease in to_return:
            try:
                lease.client.close()
            except Exception:
                pass
            self._return_lease_to_raylet(lease.worker_id, lease.raylet)

    def revoke(self, worker_id: bytes) -> None:
        """Tenant-quota revocation from a raylet: stop feeding the named
        lease and return it once its in-flight work drains (exactly the
        draining-lease path — cooperative, never kills running tasks).
        Replacement demand re-parks at the raylet under the quota gate,
        so the queue keeps the pressure visible without re-acquiring."""
        retire = None
        with self._lock:
            for ks in self._keys.values():
                lease = ks.leases.get(worker_id)
                if lease is None or lease.dead:
                    continue
                lease.draining = True
                if not lease.inflight:
                    ks.leases.pop(worker_id, None)
                    lease.dead = True
                    retire = lease
                break
        if retire is not None:
            try:
                retire.client.close()
            except Exception:
                pass
            self._return_lease_to_raylet(retire.worker_id, retire.raylet)

    def _on_lease_lost(self, wid: bytes, ks: _KeyState) -> None:
        """The leased worker's connection dropped (worker crash, exit, or
        an OOM kill by the raylet)."""
        oom_msg = self._worker._oom_worker_kills.pop(wid, None)
        with self._lock:
            lease = ks.leases.pop(wid, None)
            if lease is None:
                return
            lease.dead = True
            retry, failed, cancelled = [], [], []
            for spec in lease.inflight.values():
                if spec.task_id.binary() in self._worker._cancelled_tasks:
                    cancelled.append(spec)  # force-cancel killed the worker
                elif spec.max_retries < 0 or spec.attempt_number < spec.max_retries:
                    spec.attempt_number += 1
                    retry.append(spec)
                else:
                    failed.append(spec)
            lease.inflight.clear()
            lease.started.clear()
            for spec in retry:
                ks.pending.appendleft(spec)
            if ks.pending and not self._closed:
                self._assign_locked(ks)
                self._maybe_request_leases_locked(ks)
        if failed and oom_msg is None:
            # The oom_kill push rides the raylet connection while the
            # close event comes from the worker's own (killed) socket —
            # give the push a beat to arrive before picking the error.
            time.sleep(0.15)
            oom_msg = self._worker._oom_worker_kills.pop(wid, None)
        for spec in failed:
            self._fail_spec(spec, oom_msg)
        from ray_tpu_torch import exceptions

        for spec in cancelled:
            self._worker._cancelled_tasks.discard(spec.task_id.binary())
            try:
                self._worker._store_error_returns(
                    spec, exceptions.TaskCancelledError(f"Task {spec.name} was cancelled")
                )
            finally:
                self._worker.memory_store.resolve_stored(
                    [o.binary() for o in spec.return_ids()]
                )

    def _fail_spec(self, spec: TaskSpec, oom_msg: Optional[str] = None) -> None:
        from ray_tpu_torch import exceptions

        if oom_msg is not None:
            err = exceptions.OutOfMemoryError(
                f"Task {spec.name} was killed by the memory monitor: {oom_msg}"
            )
        else:
            err = exceptions.WorkerCrashedError(
                f"Task {spec.name} failed: the worker executing it died"
            )
        try:
            self._worker._store_error_returns(spec, err)
        finally:
            self._worker.memory_store.resolve_stored(
                [o.binary() for o in spec.return_ids()]
            )

    def cancel(self, tid: bytes, force: bool) -> bool:
        """Cancel a submitted task: drop it from a pending queue (storing
        TaskCancelledError), or forward the cancel to the leased worker
        running it.  Returns False if this submitter doesn't know the
        task (caller falls through to the raylet path)."""
        from ray_tpu_torch import exceptions

        doomed = None
        target = None
        with self._lock:
            for ks in self._keys.values():
                for spec in ks.pending:
                    if spec.task_id.binary() == tid:
                        doomed = spec
                        break
                if doomed is not None:
                    ks.pending.remove(doomed)
                    break
                for lease in ks.leases.values():
                    if tid in lease.inflight:
                        target = lease
                        break
                if target is not None:
                    break
        if doomed is not None:
            # Resolved right here — the task never runs, so no completion
            # or lease-loss handler will ever prune the owner's entry.
            self._worker._cancelled_tasks.discard(tid)
            try:
                self._worker._store_error_returns(
                    doomed,
                    exceptions.TaskCancelledError(f"Task {doomed.name} was cancelled"),
                )
            finally:
                self._worker.memory_store.resolve_stored(
                    [o.binary() for o in doomed.return_ids()]
                )
            return True
        if target is not None:
            try:
                target.client.push("cancel_task", {"task_id": tid, "force": force})
            except rpc.RpcError:
                pass
            return True
        return False

    def _fail_pending_env(self, ks: _KeyState, msg: str) -> None:
        """The raylet reported this key's runtime_env failed to stage:
        fail every queued spec with RuntimeEnvSetupError."""
        from ray_tpu_torch import exceptions

        with self._lock:
            doomed = list(ks.pending)
            ks.pending.clear()
        err = exceptions.RuntimeEnvSetupError(f"runtime_env setup failed: {msg}")
        for spec in doomed:
            try:
                self._worker._store_error_returns(spec, err)
            finally:
                self._worker.memory_store.resolve_stored(
                    [o.binary() for o in spec.return_ids()]
                )

    # ------------------------------------------------------------------
    def _reap_loop(self) -> None:
        while not self._closed:
            time.sleep(0.1)
            timeout = CONFIG.lease_idle_timeout_ms / 1000
            now = time.monotonic()
            to_return = []
            with self._lock:
                for ks in self._keys.values():
                    for wid, lease in list(ks.leases.items()):
                        if not lease.inflight and not ks.pending and now - lease.idle_since > timeout:
                            ks.leases.pop(wid)
                            lease.dead = True
                            to_return.append(lease)
                    # Kick requests for queues stranded by failed grants.
                    if ks.pending and not ks.requests_inflight and not ks.leases:
                        self._maybe_request_leases_locked(ks)
                    # Growth for long tasks: an in-flight task stuck past
                    # the threshold recalibrates the key so queued work
                    # fans out to more workers instead of waiting in line.
                    elif ks.pending:
                        # A lease with a SINGLE in-flight task stuck past the
                        # threshold means the task itself runs long (deep
                        # pipelines are excluded — there, age is queue wait):
                        # recalibrate so queued work fans out to more workers.
                        threshold = CONFIG.lease_grow_task_ms / 1000
                        oldest = min(
                            (
                                t0
                                for l in ks.leases.values()
                                if len(l.inflight) == 1
                                for t0, _ in l.started.values()
                            ),
                            default=None,
                        )
                        if oldest is not None and now - oldest > max(0.05, threshold):
                            age_ms = (now - oldest) * 1000
                            if ks.ewma_ms is None or ks.ewma_ms < age_ms:
                                ks.ewma_ms = age_ms
                            self._maybe_request_leases_locked(ks)
            for lease in to_return:
                try:
                    lease.client.close()
                except Exception:
                    pass
                self._return_lease_to_raylet(lease.worker_id, lease.raylet)

    def _return_lease_to_raylet(self, worker_id: bytes, raylet_client=None) -> None:
        try:
            (raylet_client or self._worker.raylet_client).push(
                "return_worker_lease", {"worker_id": worker_id}
            )
        except Exception:
            pass

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            leases = [l for ks in self._keys.values() for l in ks.leases.values()]
            self._keys.clear()
        for lease in leases:
            try:
                lease.client.close()
            except Exception:
                pass
            self._return_lease_to_raylet(lease.worker_id, lease.raylet)
        self._pool.shutdown(wait=False)


class ActorDirectChannel:
    """Caller-side direct connection to one actor's worker process.

    Method invocations are pushed in sequence_number order under a send
    lock (socket FIFO then guarantees in-order delivery); the receiver
    additionally buffers by sequence number, so ordering survives retries
    and reconnects (reference: transport/actor_task_submitter.h:75 +
    sequential_actor_submit_queue.h)."""

    def __init__(self, worker, actor_id, address: str):
        self.worker = worker
        self.actor_id = actor_id
        self.address = address
        self.inflight: Dict[bytes, TaskSpec] = {}
        self.send_lock = threading.Lock()
        self.closed = False
        self.client = rpc.RpcClient(address, on_push=self._on_push, on_close=self._on_close)

    def send(self, spec: TaskSpec) -> None:
        with self.send_lock:
            if self.closed:
                raise rpc.ConnectionLost(f"channel to actor {self.actor_id.hex()[:8]} closed")
            self.inflight[spec.task_id.binary()] = spec
            try:
                self.client.push("exec_direct", {"spec": spec})
            except rpc.RpcError:
                self.inflight.pop(spec.task_id.binary(), None)
                raise

    def _on_push(self, method: str, payload) -> None:
        if method == "stream_item":
            self.worker._on_stream_item(payload)
            return
        if method != "task_finished":
            return
        ms = self.worker.memory_store
        for oid, blob in payload.get("inline", ()):
            if ms.put(oid, blob):
                self.worker.promote_blob(oid, blob)
        ms.resolve_stored(payload.get("stored", ()))
        self.worker._notify_stream_finished(payload["task_id"])
        self.worker.reference_counter.return_borrows(payload["task_id"])
        self.worker._cancelled_tasks.discard(payload["task_id"])
        self.inflight.pop(payload["task_id"], None)

    def _on_close(self) -> None:
        self.closed = True
        try:
            self.worker._on_actor_channel_closed(self)
        except Exception:
            logger.exception("actor channel close handler failed")

    def close(self) -> None:
        self.closed = True
        try:
            self.client.close()
        except Exception:
            pass
