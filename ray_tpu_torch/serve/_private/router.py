"""Replica router: power-of-two-choices on queue length (reference:
serve/_private/replica_scheduler/pow_2_scheduler.py:52
PowerOfTwoChoicesReplicaScheduler + serve/_private/router.py)."""

from __future__ import annotations

import random
import time
import threading
from typing import Any, Dict, List, Optional

# Sentinels: this replica's dataplane attach failed (stay on the RPC
# path) / is in progress on another thread (use RPC for this call).
_DP_FAILED = object()
_DP_ATTACHING = object()

# Node states that demote a replica: still alive and kept in the set
# (its node may recover), but only routed to when no replica on a
# healthy node remains.
_DEMOTED_NODE_STATES = ("SUSPECT", "QUARANTINED")


class Router:
    """Caches the replica set from the controller; picks replicas by
    sampling two and routing to the shorter queue."""

    REFRESH_S = 1.0

    def __init__(self, controller, deployment_name: str):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        self.controller = controller
        self.deployment_name = deployment_name
        self._replicas: List[dict] = []
        self._queue_estimate: Dict[str, int] = {}
        self._last_refresh = 0.0
        self._lock = threading.Lock()
        # Channel dataplane: one ChannelClient per replica (attached
        # lazily on first route), replacing per-call actor RPC and
        # per-token object-store hops.  _DP_FAILED marks replicas whose
        # attach failed (old replica class, config off): they stay on
        # the RPC path without re-attempting every call.
        self._dataplanes: Dict[str, Any] = {}
        self._dp_lock = threading.Lock()
        self._rng = random.Random()
        self._reported = 0.0
        # multiplexing: soft model→replica affinity learned from routing
        # decisions (reference: multiplexed model id routing)
        self._model_locations: Dict[str, set] = {}
        # long-poll push: replica-set changes arrive in one RTT instead
        # of the REFRESH_S polling interval (the poll stays as fallback)
        from ray_tpu_torch.serve._private.controller import lp_replicas_key
        from ray_tpu_torch.serve._private.long_poll import LongPollClient

        self._long_poll = LongPollClient(
            controller, {lp_replicas_key(deployment_name): self._on_replicas_pushed}
        )

    def _on_replicas_pushed(self, snapshot: List[dict]):
        """Apply a pushed replica-set snapshot."""
        new = self._apply_snapshot(snapshot)
        live = {r["replica_id"] for r in new}
        with self._lock:
            for mid, rids in list(self._model_locations.items()):
                rids &= live
                if not rids:
                    del self._model_locations[mid]
        with self._dp_lock:
            gone = [rid for rid in self._dataplanes if rid not in live]
        for rid in gone:
            self._drop_dataplane(rid)

    def _apply_snapshot(self, snapshot: List[dict]) -> List[dict]:
        """Merge a controller snapshot into the cached replica set,
        keeping existing records (their actor handles) and refreshing
        each replica's host-node state — the demotion signal."""
        with self._lock:
            by_id = {r["replica_id"]: r for r in self._replicas}
        new = []
        for rinfo in snapshot:
            cur = by_id.get(rinfo["replica_id"])
            if cur is not None:
                cur["node_state"] = rinfo.get("node_state", "ALIVE")
                new.append(cur)
            else:
                try:
                    actor = self._ray.get_actor(rinfo["actor_name"], "serve")
                    new.append({
                        "replica_id": rinfo["replica_id"],
                        "actor": actor,
                        "node_state": rinfo.get("node_state", "ALIVE"),
                    })
                except Exception:
                    pass
        with self._lock:
            self._replicas = new
            self._last_refresh = time.monotonic()
        return new

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < self.REFRESH_S:
            return
        # The blocking controller get happens OUTSIDE the lock — route()/
        # done() on other proxy threads must never wait on this RPC.
        replicas = self._ray.get(
            self.controller.get_replicas.remote(self.deployment_name)
        )
        self._apply_snapshot(replicas)
        # report average load for autoscaling
        if self._replicas:
            avg = sum(self._queue_estimate.get(r["replica_id"], 0) for r in self._replicas) / len(self._replicas)
            try:
                self.controller.record_load.remote(self.deployment_name, avg)
            except Exception:
                pass

    def pick(self, multiplexed_model_id: str = "") -> dict:
        from ray_tpu_torch._private import retry

        self._refresh()
        bo = None
        while not self._replicas:
            bo = bo or retry.POLL.start(deadline_s=30)
            delay = bo.next_delay()
            if delay is None:
                raise RuntimeError(f"no running replicas for deployment {self.deployment_name}")
            time.sleep(delay)
            self._refresh(force=True)
        # Gray-failure demotion: replicas on SUSPECT/QUARANTINED nodes
        # stay in the set (the node is alive and may recover) but only
        # take traffic when no replica on a healthy node remains — a
        # re-promotion is just the next snapshot marking the node ALIVE.
        with self._lock:
            replicas = list(self._replicas)
        healthy = [
            r for r in replicas
            if r.get("node_state", "ALIVE") not in _DEMOTED_NODE_STATES
        ]
        pool = healthy or replicas
        if multiplexed_model_id:
            # soft affinity: among replicas that already hold the model,
            # pick the shortest queue; fall through when none do
            with self._lock:
                rids = set(self._model_locations.get(multiplexed_model_id, ()))
            holders = [r for r in pool if r["replica_id"] in rids]
            if holders:
                return min(
                    holders, key=lambda r: self._queue_estimate.get(r["replica_id"], 0)
                )
        if len(pool) == 1:
            return pool[0]
        a, b = self._rng.sample(pool, 2)
        qa = self._queue_estimate.get(a["replica_id"], 0)
        qb = self._queue_estimate.get(b["replica_id"], 0)
        return a if qa <= qb else b

    def _dataplane(self, r: dict):
        """The replica's ChannelClient, attaching lazily on first use.
        Returns None when the dataplane is off, attach failed, or the
        channel died (the caller falls back to the RPC path; a dead
        client is dropped so the next call re-attaches)."""
        from ray_tpu_torch._private.config import CONFIG

        if not CONFIG.serve_channel_dataplane:
            return None
        rid = r["replica_id"]
        with self._dp_lock:
            dp = self._dataplanes.get(rid)
            if dp is _DP_FAILED or dp is _DP_ATTACHING:
                # attach failed, or another thread is mid-attach: this
                # call takes the RPC path (never wait on a slow attach)
                return None
            if dp is not None:
                if dp.dead:
                    self._dataplanes.pop(rid, None)
                    try:
                        dp.close()
                    except Exception:  # noqa: BLE001
                        pass
                    return None
                return dp
            # claim the attach slot, then do the blocking work OUTSIDE
            # the lock — attach can take seconds (actor RTT + dial +
            # accept) and must not stall routing to healthy replicas
            self._dataplanes[rid] = _DP_ATTACHING
        from ray_tpu_torch.serve._private.dataplane import ChannelClient

        try:
            dp = ChannelClient.attach(rid, r["actor"])
        except Exception:  # noqa: BLE001 — RPC path keeps working
            dp = _DP_FAILED
        with self._dp_lock:
            if self._dataplanes.get(rid) is _DP_ATTACHING:
                self._dataplanes[rid] = dp
            elif dp is not _DP_FAILED:
                dp.close()  # replica evicted mid-attach: discard
                return None
        return dp if dp is not _DP_FAILED else None

    def _drop_dataplane(self, replica_id: str) -> None:
        with self._dp_lock:
            dp = self._dataplanes.pop(replica_id, None)
        if dp is not None and dp is not _DP_FAILED and dp is not _DP_ATTACHING:
            try:
                dp.close()
            except Exception:  # noqa: BLE001
                pass

    def route(self, method: str, args: tuple, kwargs: dict,
              multiplexed_model_id: str = "", request_meta: Optional[dict] = None):
        """Dispatch to the chosen replica; returns (ObjectRef-or-
        ChannelFuture, replica_id).  Callers MUST call `done(replica_id)`
        when the response resolves so the in-flight estimate stays
        honest.  ``request_meta`` is the request's identity dict
        ({"tenant", "slo"}), carried on the wire to the replica."""
        from ray_tpu_torch.util import tracing

        if tracing.current_context() is not None:
            # Traced request: the pick + send ride a router span so the
            # request frame's channel.write parents here and the
            # timeline shows the router_queue segment.  Untraced
            # requests pay one contextvar read.
            with tracing.start_span("serve.router", {"method": method}):
                return self._route(method, args, kwargs, multiplexed_model_id,
                                   request_meta)
        return self._route(method, args, kwargs, multiplexed_model_id, request_meta)

    def _route(self, method: str, args: tuple, kwargs: dict,
               multiplexed_model_id: str = "", request_meta: Optional[dict] = None):
        r = self.pick(multiplexed_model_id)
        rid = r["replica_id"]
        # route()/done() run concurrently from proxy executor threads:
        # the read-modify-write must be atomic or increments get lost.
        with self._lock:
            self._queue_estimate[rid] = self._queue_estimate.get(rid, 0) + 1
            if multiplexed_model_id:
                self._model_locations.setdefault(multiplexed_model_id, set()).add(rid)
        dp = self._dataplane(r)
        if dp is not None:
            try:
                return dp.call(method, args, kwargs, multiplexed_model_id,
                               request_meta), rid
            except Exception:  # noqa: BLE001 — channel died mid-send
                self._drop_dataplane(rid)
        ref = r["actor"].handle_request.remote(
            method, args, kwargs, multiplexed_model_id, request_meta
        )
        return ref, rid

    def route_stream(self, method: str, args: tuple, kwargs: dict,
                     multiplexed_model_id: str = "",
                     request_meta: Optional[dict] = None):
        """Streaming dispatch: returns (stream, replica_id) — a
        ChannelStream multiplexed over the replica's dataplane when
        attached (one frame per token, no object-store hops), else an
        item-ref generator via the actor streaming plane."""
        from ray_tpu_torch.util import tracing

        if tracing.current_context() is not None:
            with tracing.start_span("serve.router", {"method": method}):
                return self._route_stream(method, args, kwargs,
                                          multiplexed_model_id, request_meta)
        return self._route_stream(method, args, kwargs, multiplexed_model_id,
                                  request_meta)

    def _route_stream(self, method: str, args: tuple, kwargs: dict,
                      multiplexed_model_id: str = "",
                      request_meta: Optional[dict] = None):
        r = self.pick(multiplexed_model_id)
        rid = r["replica_id"]
        with self._lock:
            self._queue_estimate[rid] = self._queue_estimate.get(rid, 0) + 1
            if multiplexed_model_id:
                self._model_locations.setdefault(multiplexed_model_id, set()).add(rid)
        dp = self._dataplane(r)
        if dp is not None:
            try:
                return dp.stream(method, args, kwargs, multiplexed_model_id,
                                 request_meta), rid
            except Exception:  # noqa: BLE001
                self._drop_dataplane(rid)
        gen = r["actor"].handle_request_stream.options(num_returns="streaming").remote(
            method, args, kwargs, multiplexed_model_id, request_meta
        )
        return gen, rid

    def done(self, replica_id: str):
        with self._lock:
            self._queue_estimate[replica_id] = max(0, self._queue_estimate.get(replica_id, 1) - 1)

    def get_replica_actor(self, replica_id: str):
        """The actor handle for one replica, or None if it left the set
        (used for replica-targeted calls like disconnect-cancel, which
        must NOT be load-balanced to a peer)."""
        with self._lock:
            for r in self._replicas:
                if r["replica_id"] == replica_id:
                    return r["actor"]
        return None

    def evict(self, replica_id: str):
        """Drop a replica observed dead (ActorDiedError surfaced through
        a response) so the very next pick avoids it — one RTT faster
        than waiting for the controller's health check + long-poll push."""
        with self._lock:
            self._replicas = [r for r in self._replicas if r["replica_id"] != replica_id]
            self._queue_estimate.pop(replica_id, None)
            for rids in self._model_locations.values():
                rids.discard(replica_id)
        self._drop_dataplane(replica_id)

    def close(self):
        self._long_poll.stop()
        with self._dp_lock:
            dps, self._dataplanes = list(self._dataplanes.items()), {}
        for _rid, dp in dps:
            if dp is not _DP_FAILED and dp is not _DP_ATTACHING:
                try:
                    dp.close()
                except Exception:  # noqa: BLE001
                    pass


# One router (→ one long-poll thread) per deployment per process, shared
# by every handle targeting it — per-handle routers would each hold a
# blocking listen_for_change slot on the controller and leak a thread
# per handle (reference: handles share the router keyed by deployment).
_routers: Dict[str, Router] = {}
_routers_lock = threading.Lock()


def get_or_create_router(controller, deployment_name: str) -> Router:
    with _routers_lock:
        r = _routers.get(deployment_name)
        if r is None:
            r = _routers[deployment_name] = Router(controller, deployment_name)
        return r


def shutdown_routers():
    with _routers_lock:
        routers = dict(_routers)
        _routers.clear()
    for r in routers.values():
        r.close()
