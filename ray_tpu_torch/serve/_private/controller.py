"""ServeController actor (reference: serve/_private/controller.py +
deployment_state.py): reconciles desired deployment configs against live
replica actors; rolling updates on version change; queue-depth
autoscaling.

Port of ``ray_tpu/serve/_private/controller.py``.  A deployment's
``ray_actor_options`` pass to its replica actors as they are, so
``{"num_gpus": 1}`` leases one ``GPU`` from the raylet."""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve._private.long_poll import LongPollHost

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"

# long-poll keys (reference: long_poll.py LongPollNamespace)
LP_ROUTE_TABLE = "route_table"


def lp_replicas_key(deployment: str) -> str:
    return f"replicas::{deployment}"


class ServeController(LongPollHost):
    # cadence of the per-replica stats poll (doubles as the RUNNING
    # health check); consecutive failures before a replica is declared
    # DEAD (one failure may be a transient under load)
    STATS_INTERVAL_S = 1.0
    STATS_FAILS_TO_DEAD = 2
    STOP_GRACE_S = 2.0

    def __init__(self):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        self.deployments: Dict[str, dict] = {}  # name -> {config, init, replicas}
        self._loop_task = None
        self._stopped = False
        self._last_scale_action: Dict[str, float] = {}
        self._load_history: Dict[str, List[float]] = {}
        # replica-set snapshot per deployment, pushed to long-poll
        # listeners whenever membership changes
        self._last_pushed: Dict[str, Any] = {}
        # replicas draining toward kill: [{replica, stop_ref, deadline}]
        self._stopping: List[dict] = []
        # node_id hex -> state, fed by the "nodes" pubsub (gray-failure
        # ladder): replica snapshots carry the host node's state so
        # routers demote replicas on SUSPECT/QUARANTINED nodes and
        # re-promote them when the node returns ALIVE.  Unknown nodes
        # default to ALIVE — demotion is advisory, never a liveness call.
        self._node_states: Dict[str, str] = {}
        from ray_tpu_torch._private.worker import global_worker_maybe

        w = global_worker_maybe()
        if w is not None and getattr(w, "connected", False):
            w.add_node_listener(self._on_node_event)

    def _on_node_event(self, state: str, node: dict):
        # Runs on the worker's node-event thread; plain dict writes are
        # atomic, the reconcile tick reads the latest view.
        nid = node.get("node_id")
        nid_hex = nid.hex() if isinstance(nid, (bytes, bytearray)) else str(nid or "")
        if not nid_hex:
            return
        if state == "DEAD":
            # Dead nodes leave the map: their replicas fail stats probes
            # and are replaced; a reused node_id starts ALIVE again.
            self._node_states.pop(nid_hex, None)
        else:
            self._node_states[nid_hex] = state

    async def _ensure_loop(self):
        if self._loop_task is None:
            # Seed node states before the first reconcile: a node already
            # SUSPECT/QUARANTINED at controller start must demote from
            # the first snapshot, not from its next state transition.
            try:
                for n in self._ray.nodes():
                    if n.get("State") not in (None, "DEAD"):
                        self._node_states[n["NodeID"]] = n["State"]
            except Exception:  # noqa: BLE001 — advisory only
                pass
            self._loop_task = asyncio.get_event_loop().create_task(self._reconcile_loop())

    # -- API (called by serve.run / handles) ----------------------------
    async def deploy(self, config_dict: dict, serialized_init) -> bool:
        """Create or update a deployment; rolling update on version change."""
        await self._ensure_loop()
        name = config_dict["name"]
        existing = self.deployments.get(name)
        self.deployments[name] = {
            "config": config_dict,
            "init": serialized_init,
            "replicas": existing["replicas"] if existing else [],
            "target": config_dict["num_replicas"],
        }
        if existing and existing["config"].get("version") != config_dict.get("version"):
            # mark old-version replicas for replacement (rolling)
            for r in self.deployments[name]["replicas"]:
                r["stale"] = True
        self._push_route_table()
        await self._reconcile_once()
        return True

    async def delete_deployment(self, name: str) -> bool:
        dep = self.deployments.pop(name, None)
        if dep:
            for r in dep["replicas"]:
                self._stop_replica(r)
        self._push_route_table()
        self.notify_changed(lp_replicas_key(name), [])
        return True

    async def get_replicas(self, name: str) -> List[dict]:
        dep = self.deployments.get(name)
        if not dep:
            return []
        return self._replica_snapshot(dep)

    def _replica_snapshot(self, dep: dict) -> List[dict]:
        """Routable replicas with their host node's membership state.
        node_state changes alter the snapshot, so a node going SUSPECT/
        QUARANTINED (or recovering) long-polls to routers like any
        membership change."""
        return [
            {
                "replica_id": r["replica_id"],
                "actor_name": r["actor_name"],
                "node_id": r.get("node_id", ""),
                "node_state": self._node_states.get(r.get("node_id", ""), "ALIVE"),
            }
            for r in dep["replicas"]
            if r["state"] == "RUNNING" and not r.get("stale")
        ]

    async def list_deployments(self) -> Dict[str, dict]:
        return {
            name: {
                "config": dep["config"],
                "num_running": sum(1 for r in dep["replicas"] if r["state"] == "RUNNING"),
                "target": dep["target"],
            }
            for name, dep in self.deployments.items()
        }

    async def record_load(self, name: str, ongoing_per_replica: float):
        """Routers report observed queue depth for autoscaling."""
        self._load_history.setdefault(name, []).append(ongoing_per_replica)
        self._load_history[name] = self._load_history[name][-60:]

    async def shutdown(self):
        self._stopped = True
        for name in list(self.deployments):
            await self.delete_deployment(name)
        # the reconcile loop is stopping: give prepare_shutdown a short
        # grace, then kill whatever is still draining
        if self._stopping:
            try:
                self._ray.wait(
                    [e["stop_ref"] for e in self._stopping],
                    num_returns=len(self._stopping),
                    timeout=self.STOP_GRACE_S,
                )
            except Exception:
                pass
            for entry in self._stopping:
                try:
                    self._ray.kill(entry["replica"]["actor"])
                except Exception:
                    pass
            self._stopping.clear()
        return True

    # -- reconciliation --------------------------------------------------
    async def _reconcile_loop(self):
        while not self._stopped:
            try:
                await self._reconcile_once()
            except Exception:
                logger.exception("serve reconcile failed")
            await asyncio.sleep(0.5)

    async def _reconcile_once(self):
        for name, dep in self.deployments.items():
            cfg = dep["config"]
            replicas = dep["replicas"]
            # drop dead handles
            for r in list(replicas):
                if r["state"] == "DEAD":
                    replicas.remove(r)
            self._autoscale(name, dep)
            target = dep["target"]
            fresh = [r for r in replicas if not r.get("stale")]
            # rolling replacement: start fresh replicas first, then retire
            # stale ones once enough fresh are running
            while len(fresh) < target:
                r = self._start_replica(name, cfg, dep["init"])
                replicas.append(r)
                fresh.append(r)
            running_fresh = [r for r in fresh if r["state"] == "RUNNING"]
            stale = [r for r in replicas if r.get("stale")]
            if len(running_fresh) >= target:
                for r in stale:
                    self._stop_replica(r)
                    replicas.remove(r)
            # scale down
            extra = len(fresh) - target
            for r in list(fresh)[:max(0, extra)]:
                self._stop_replica(r)
                replicas.remove(r)
            # health-check STARTING replicas: submit one ping and poll its
            # completion with a zero-timeout wait — no blocked threads
            for r in replicas:
                if r["state"] != "STARTING":
                    continue
                if "ping_ref" not in r:
                    r["ping_ref"] = r["actor"].ping.remote()
                ready, _ = self._ray.wait([r["ping_ref"]], num_returns=1, timeout=0)
                if ready:
                    try:
                        pong = self._ray.get(r.pop("ping_ref"))
                        if isinstance(pong, dict):
                            r["node_id"] = pong.get("node_id") or ""
                        r["state"] = "RUNNING"
                    except Exception:
                        r["state"] = "DEAD"
            # poll RUNNING replica stats: the queue-depth autoscaling
            # signal (ongoing + the deployment's internal queue) AND the
            # liveness probe — a replica whose stats call keeps failing
            # (e.g. chaos-killed) is declared DEAD and replaced above on
            # the next tick, with the membership change long-polled to
            # routers
            self._poll_replica_stats(name, dep)
        self._reap_stopping()
        # push replica-set changes to long-poll listeners (routers);
        # the snapshot embeds node_state, so gray-failure transitions
        # push too (demotion reaches routers within one reconcile tick)
        for name, dep in self.deployments.items():
            snapshot = self._replica_snapshot(dep)
            if self._last_pushed.get(name) != snapshot:
                self._last_pushed[name] = snapshot
                self.notify_changed(lp_replicas_key(name), snapshot)

    def _poll_replica_stats(self, name: str, dep: dict):
        now = time.monotonic()
        loads: List[float] = []
        for r in dep["replicas"]:
            if r["state"] != "RUNNING":
                continue
            ref = r.get("stats_ref")
            if ref is not None:
                ready, _ = self._ray.wait([ref], num_returns=1, timeout=0)
                if not ready:
                    continue
                r.pop("stats_ref")
                try:
                    stats = self._ray.get(ref)
                    r["stats_fails"] = 0
                    if stats.get("has_queue_hook"):
                        r["load"] = float(stats.get("queued") or 0)
                    else:
                        r["load"] = float(stats.get("ongoing", 0))
                except Exception:
                    r["stats_fails"] = r.get("stats_fails", 0) + 1
                    if r["stats_fails"] >= self.STATS_FAILS_TO_DEAD:
                        logger.warning(
                            "serve: replica %s failed %d stats probes — DEAD",
                            r["replica_id"], r["stats_fails"],
                        )
                        r["state"] = "DEAD"
                        continue
            if "load" in r:
                loads.append(r["load"])
            if now - r.get("stats_t", 0.0) >= self.STATS_INTERVAL_S and \
                    "stats_ref" not in r:
                try:
                    r["stats_ref"] = r["actor"].stats.remote()
                    r["stats_t"] = now
                except Exception:
                    r["stats_fails"] = r.get("stats_fails", 0) + 1
                    if r["stats_fails"] >= self.STATS_FAILS_TO_DEAD:
                        r["state"] = "DEAD"
        if loads:
            self._load_history.setdefault(name, []).append(sum(loads) / len(loads))
            self._load_history[name] = self._load_history[name][-60:]

    def _reap_stopping(self):
        """Kill gracefully-stopping replicas once prepare_shutdown
        resolves (or the grace deadline passes)."""
        now = time.monotonic()
        for entry in list(self._stopping):
            done = now >= entry["deadline"]
            if not done:
                ready, _ = self._ray.wait(
                    [entry["stop_ref"]], num_returns=1, timeout=0
                )
                done = bool(ready)
            if done:
                try:
                    self._ray.kill(entry["replica"]["actor"])
                except Exception:
                    pass
                self._stopping.remove(entry)

    def _push_route_table(self):
        # route_prefix == "" means explicitly unrouted (internal
        # deployments of a graph app — only the ingress is exposed).
        # Values carry per-deployment proxy config (load-shedding bound)
        # alongside the name; the proxy normalizes either shape.
        self.notify_changed(
            LP_ROUTE_TABLE,
            {
                (dep["config"].get("route_prefix") or f"/{name}"): {
                    "name": name,
                    "max_queued_requests": dep["config"].get(
                        "max_queued_requests", -1
                    ),
                    "tenant_quotas": dep["config"].get("tenant_quotas") or {},
                }
                for name, dep in self.deployments.items()
                if dep["config"].get("route_prefix") != ""
            },
        )

    def _start_replica(self, name: str, cfg: dict, init) -> dict:
        from ray_tpu_torch.serve._private.replica import Replica

        rid = f"{name}#{uuid.uuid4().hex[:6]}"
        actor_name = f"SERVE_REPLICA::{rid}"
        opts = dict(cfg.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 0.1)
        opts["name"] = actor_name
        opts["namespace"] = "serve"
        # streams hold an actor-concurrency slot for their whole life:
        # a deployment sized for thousands of ongoing requests (the LLM
        # plane) must not hit the actor cap before its own admission
        opts["max_concurrency"] = max(
            1000, 2 * int(cfg.get("max_ongoing_requests") or 0)
        )
        actor = self._ray.remote(**opts)(Replica).remote(
            rid, name, init, cfg.get("user_config"), cfg.get("max_ongoing_requests", 100)
        )
        logger.info("serve: started replica %s", rid)
        return {
            "replica_id": rid,
            "actor": actor,
            "actor_name": actor_name,
            "state": "STARTING",
            "version": cfg.get("version", "1"),
        }

    def _stop_replica(self, r):
        # two-phase: prepare_shutdown first (cancels @serve.batch worker
        # tasks, stops the LLM engine's step loop and frees its KV
        # blocks), the kill lands when it resolves or after STOP_GRACE_S
        try:
            self._stopping.append(
                {
                    "replica": r,
                    "stop_ref": r["actor"].prepare_shutdown.remote(),
                    "deadline": time.monotonic() + self.STOP_GRACE_S,
                }
            )
        except Exception:
            try:
                self._ray.kill(r["actor"])
            except Exception:
                pass
        r["state"] = "DEAD"
        logger.info("serve: stopped replica %s", r["replica_id"])

    def _autoscale(self, name: str, dep):
        cfg = dep["config"]
        auto = cfg.get("autoscaling_config")
        if not auto:
            dep["target"] = cfg["num_replicas"]
            return
        hist = self._load_history.get(name, [])
        if not hist:
            return
        recent = hist[-10:]
        avg = sum(recent) / len(recent)
        now = time.monotonic()
        last = self._last_scale_action.get(name, 0.0)
        target = dep["target"]
        if avg > auto["target_ongoing_requests"] and now - last > auto["upscale_delay_s"]:
            new_target = min(auto["max_replicas"], target + 1)
            if new_target != target:
                dep["target"] = new_target
                self._last_scale_action[name] = now
                logger.info("serve: autoscale %s up to %d (load %.2f)", name, new_target, avg)
        elif avg < 0.5 * auto["target_ongoing_requests"] and now - last > auto["downscale_delay_s"]:
            new_target = max(auto["min_replicas"], target - 1)
            if new_target != target:
                dep["target"] = new_target
                self._last_scale_action[name] = now
                logger.info("serve: autoscale %s down to %d (load %.2f)", name, new_target, avg)
