"""Autoscaler v2 instance manager (reference: python/ray/autoscaler/v2/
instance_manager/instance_manager.py + instance_storage.py).

v2's core idea over v1: every cloud instance is tracked through an
explicit lifecycle state machine with an audit trail of transitions,
and reconciliation is a pure function of (desired state, instance
states, cloud/provider state, Ray cluster state) — no implicit
"booting" counters.

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                                      -> RAY_STOPPED -> TERMINATING -> TERMINATED

Allocation failures retry from QUEUED up to max_retries, then park in
ALLOCATION_FAILED.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

VALID_TRANSITIONS = {
    "QUEUED": {"REQUESTED"},
    "REQUESTED": {"ALLOCATED", "ALLOCATION_FAILED", "QUEUED"},
    "ALLOCATED": {"RAY_RUNNING", "TERMINATING"},
    "RAY_RUNNING": {"RAY_STOPPED", "TERMINATING"},
    "RAY_STOPPED": {"TERMINATING"},
    "TERMINATING": {"TERMINATED"},
    "ALLOCATION_FAILED": {"QUEUED"},
    "TERMINATED": set(),
}

LIVE_STATES = ("QUEUED", "REQUESTED", "ALLOCATED", "RAY_RUNNING")


@dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = "QUEUED"
    cloud_instance_id: Optional[str] = None
    launch_attempts: int = 0
    # (status, unix time) audit trail (reference: v2 status history).
    history: List[tuple] = field(default_factory=lambda: [("QUEUED", time.time())])

    def transition(self, new: str):
        if new not in VALID_TRANSITIONS[self.status]:
            raise ValueError(f"illegal transition {self.status} -> {new}")
        self.status = new
        self.history.append((new, time.time()))


class InstanceManager:
    """Owns the instance table and drives provider calls to make actual
    state match the queued intents."""

    def __init__(self, provider, node_types: Dict[str, dict], max_launch_retries: int = 3):
        self.provider = provider
        self.node_types = node_types
        self.max_launch_retries = max_launch_retries
        self.instances: Dict[str, Instance] = {}
        self._ids = itertools.count(1)

    # -- intents --------------------------------------------------------
    def queue_launch(self, node_type: str, count: int = 1) -> List[str]:
        out = []
        for _ in range(count):
            iid = f"i-{next(self._ids)}"
            self.instances[iid] = Instance(iid, node_type)
            out.append(iid)
        return out

    def queue_terminate(self, instance_id: str):
        inst = self.instances.get(instance_id)
        if inst is not None and inst.status in ("ALLOCATED", "RAY_RUNNING", "RAY_STOPPED"):
            inst.transition("TERMINATING")

    # -- views ----------------------------------------------------------
    def live(self, node_type: Optional[str] = None) -> List[Instance]:
        return [
            i
            for i in self.instances.values()
            if i.status in LIVE_STATES and (node_type is None or i.node_type == node_type)
        ]

    def by_cloud_id(self, cloud_id: str) -> Optional[Instance]:
        for i in self.instances.values():
            if i.cloud_instance_id == cloud_id:
                return i
        return None

    # -- reconciliation -------------------------------------------------
    def reconcile(self, ray_nodes_by_cloud_id: Dict[str, dict]):
        """One pass: launch QUEUED, observe provider + Ray state, retire
        TERMINATING, retry failed allocations."""
        for inst in list(self.instances.values()):
            if inst.status == "QUEUED":
                inst.transition("REQUESTED")
                inst.launch_attempts += 1
                try:
                    created = self.provider.create_node(
                        self.node_types[inst.node_type].get(
                            "node_config",
                            {"resources": self.node_types[inst.node_type].get("resources", {})},
                        ),
                        {"ray-node-kind": "worker", "ray-node-type": inst.node_type},
                        1,
                    )
                    inst.cloud_instance_id = created[0] if created else None
                    if inst.cloud_instance_id is None:
                        raise RuntimeError("provider returned no instance id")
                    inst.transition("ALLOCATED")
                except Exception as e:  # noqa: BLE001
                    logger.warning("launch of %s failed: %s", inst.instance_id, e)
                    if inst.launch_attempts >= self.max_launch_retries:
                        inst.transition("ALLOCATION_FAILED")
                    else:
                        inst.transition("QUEUED")
            elif inst.status == "ALLOCATED":
                if inst.cloud_instance_id in ray_nodes_by_cloud_id:
                    inst.transition("RAY_RUNNING")
                elif not self.provider.is_running(inst.cloud_instance_id):
                    inst.transition("TERMINATING")
            elif inst.status == "RAY_RUNNING":
                rec = ray_nodes_by_cloud_id.get(inst.cloud_instance_id)
                if rec is None or rec.get("state") == "DEAD":
                    inst.transition("RAY_STOPPED")
                    inst.transition("TERMINATING")
            if inst.status == "TERMINATING":
                try:
                    if inst.cloud_instance_id:
                        self.provider.terminate_node(inst.cloud_instance_id)
                except Exception:  # noqa: BLE001
                    logger.exception("terminate of %s failed", inst.instance_id)
                inst.transition("TERMINATED")
