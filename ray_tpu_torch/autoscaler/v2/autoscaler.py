"""Autoscaler v2 reconciler (reference: python/ray/autoscaler/v2/
autoscaler.py + scheduler.py).

Each tick is a pure pipeline:

    demands  = pending task shapes (GCS load metrics)
             + declarative cluster constraints (sdk.request_cluster_resources)
    desired  = bin-pack demands onto node types (shared with v1)
    diff     = desired vs live instances  -> queue_launch / queue_terminate
    reconcile the instance state machine against provider + Ray state
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from ray_tpu_torch.autoscaler.autoscaler import (
    fold_grow_hints,
    replacement_launches,
    request_node_drain,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import get_nodes_to_launch
from ray_tpu_torch.autoscaler.v2.instance_manager import InstanceManager
from ray_tpu_torch.autoscaler.v2.sdk import get_cluster_resource_constraints

logger = logging.getLogger(__name__)


class AutoscalerV2:
    def __init__(
        self,
        provider,
        node_types: Dict[str, dict],
        *,
        max_workers: int = 8,
        idle_timeout_s: float = 60.0,
        gcs_client=None,
    ):
        self.im = InstanceManager(provider, node_types)
        self.node_types = node_types
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.gcs_client = gcs_client
        self._idle_since: Dict[str, float] = {}
        # instance_id -> monotonic terminate-by time while the GCS drains
        # the node (graceful scale-down: drain, then queue_terminate).
        self._draining: Dict[str, float] = {}
        # Preempted-node ids already replaced (lost_capacity is a log).
        self._lost_processed: set = set()
        self.num_capacity_returns = 0

    def update(self, load_metrics: Optional[dict] = None):
        if load_metrics is None:
            load_metrics = self.gcs_client.call("get_load_metrics")
        demands = list(load_metrics.get("pending_demands", []))
        if self.gcs_client is not None:
            try:
                demands += get_cluster_resource_constraints(self.gcs_client)
            except Exception:  # noqa: BLE001 — constraints are advisory
                pass
        # Elastic-trainer grow intents, deduped against the capacity
        # return path below (shared with v1).
        fold_grow_hints(demands, load_metrics)
        nodes_view: Dict[str, dict] = load_metrics.get("nodes", {})

        # Ray nodes by cloud instance id (provider maps the address);
        # the GCS node id rides along for drain requests.
        ray_by_cloud: Dict[str, dict] = {}
        for cloud_id in self.im.provider.non_terminated_nodes({}):
            addr = self.im.provider.raylet_address(cloud_id)
            for node_hex, rec in nodes_view.items():
                if rec.get("raylet_address") == addr:
                    ray_by_cloud[cloud_id] = dict(rec, node_id=node_hex)

        live = self.im.live()
        pending_by_type: Dict[str, int] = {}
        for inst in live:
            if inst.status != "RAY_RUNNING":
                pending_by_type[inst.node_type] = pending_by_type.get(inst.node_type, 0) + 1

        existing_free = [
            dict(n["available"])
            for n in nodes_view.values()
            if n.get("state", "ALIVE") == "ALIVE"
        ]
        to_launch = get_nodes_to_launch(
            demands,
            existing_free,
            self.node_types,
            pending_by_type,
            self.max_workers,
            len(live),
        )
        budget = self.max_workers - len(live)
        for node_type, count in to_launch.items():
            count = min(count, max(0, budget))
            if count > 0:
                budget -= count
                logger.info("autoscaler_v2: queueing %d x %s", count, node_type)
                self.im.queue_launch(node_type, count)

        # Capacity return: relaunch a PREEMPTED node's resources even with
        # no pending demand (an elastic trainer that shrank through the
        # preemption queues nothing — the replacement's ALIVE registration
        # is its grow signal).  One queue_launch per lost node.
        for lost_id, node_type in replacement_launches(
            self.node_types, load_metrics.get("lost_capacity", ()),
            self._lost_processed, budget,
        ):
            budget -= 1
            logger.info(
                "autoscaler_v2: relaunching 1 x %s to replace preempted %s",
                node_type, lost_id[:8],
            )
            self.im.queue_launch(node_type, 1)
            self.num_capacity_returns += 1

        # Finalize in-flight drains: queue the terminate once the GCS
        # reports migration complete (or the node died / deadline passed).
        now = time.monotonic()
        for iid in list(self._draining):
            inst = self.im.instances.get(iid)
            if inst is None or inst.status not in ("RAY_RUNNING", "ALLOCATED"):
                self._draining.pop(iid, None)
                continue
            rec = ray_by_cloud.get(inst.cloud_instance_id)
            if (
                rec is None
                or rec.get("state") == "DEAD"
                or rec.get("drain_complete")
                or now > self._draining[iid]
            ):
                logger.info("autoscaler_v2: retiring drained %s", iid)
                self._draining.pop(iid, None)
                self.im.queue_terminate(iid)

        # Idle scale-down (never below the declarative constraints —
        # those demands keep the packer wanting the node, and we only
        # retire nodes that are fully free AND unneeded).  Graceful:
        # drain through the GCS first, terminate when drained.
        for inst in self.im.live():
            if inst.status != "RAY_RUNNING" or inst.instance_id in self._draining:
                continue
            rec = ray_by_cloud.get(inst.cloud_instance_id)
            if rec is None or rec.get("state", "ALIVE") != "ALIVE":
                continue
            fully_free = all(
                abs(rec["available"].get(k, 0.0) - v) < 1e-9
                for k, v in rec["total"].items()
            )
            if fully_free and not demands:
                first = self._idle_since.setdefault(inst.instance_id, now)
                if now - first > self.idle_timeout_s:
                    self._idle_since.pop(inst.instance_id, None)
                    terminate_by = request_node_drain(
                        self.gcs_client, rec.get("node_id")
                    )
                    if terminate_by is not None:
                        logger.info("autoscaler_v2: draining idle %s", inst.instance_id)
                        self._draining[inst.instance_id] = terminate_by
                    else:
                        logger.info("autoscaler_v2: retiring idle %s", inst.instance_id)
                        self.im.queue_terminate(inst.instance_id)
            else:
                self._idle_since.pop(inst.instance_id, None)

        self.im.reconcile(ray_by_cloud)

    # -- introspection (reference: v2 get_cluster_status) ---------------
    def status(self) -> dict:
        by_state: Dict[str, int] = {}
        for inst in self.im.instances.values():
            by_state[inst.status] = by_state.get(inst.status, 0) + 1
        return {
            "instances": {
                i.instance_id: {
                    "type": i.node_type,
                    "status": i.status,
                    "cloud_id": i.cloud_instance_id,
                    "transitions": len(i.history),
                }
                for i in self.im.instances.values()
            },
            "counts": by_state,
        }
