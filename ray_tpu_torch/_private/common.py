"""Common runtime structures: task specs, resource sets, scheduling strategies.

Equivalents of the reference's task spec builder and resource model
(reference: src/ray/common/task/, src/ray/common/scheduling/resource_set.h,
cluster_resource_data.h).  Resources are arbitrary named floats — CPU, GPU,
memory, object_store_memory are predefined; custom names (e.g.
"node:10.0.0.1") flow through unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)

# Predefined resource names.
CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

RESOURCE_EPSILON = 1e-9


class ResourceSet(dict):
    """Named float resources with fixed-point-ish comparisons (reference:
    src/ray/common/scheduling/fixed_point.h — we quantize to 1e-4)."""

    QUANTUM = 1e-4

    @classmethod
    def of(cls, d: Optional[Dict[str, float]]) -> "ResourceSet":
        rs = cls()
        if d:
            for k, v in d.items():
                if v is None:
                    continue
                v = round(float(v) / cls.QUANTUM) * cls.QUANTUM
                if v < 0:
                    raise ValueError(f"negative resource {k}={v}")
                if v > 0:
                    rs[k] = v
        return rs

    def fits_in(self, avail: "ResourceSet") -> bool:
        for k, v in self.items():
            if avail.get(k, 0.0) + RESOURCE_EPSILON < v:
                return False
        return True

    def subtract(self, other: "ResourceSet"):
        for k, v in other.items():
            self[k] = self.get(k, 0.0) - v
            if abs(self[k]) < RESOURCE_EPSILON:
                self[k] = 0.0

    def add(self, other: "ResourceSet"):
        for k, v in other.items():
            self[k] = self.get(k, 0.0) + v

    def copy(self) -> "ResourceSet":
        return ResourceSet(self)


@dataclass
class SchedulingStrategy:
    """DEFAULT (hybrid), SPREAD, node-affinity, node-label, or placement
    group (reference: label scheduling in scheduling_policy.h +
    NodeLabelSchedulingStrategy)."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | NODE_LABEL | PLACEMENT_GROUP
    node_id: Optional[NodeID] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False
    # NODE_LABEL: every (key, value) must match the node's labels.
    labels: Optional[Dict[str, str]] = None


@dataclass
class TaskSpec:
    """Everything a raylet/worker needs to schedule and run one task.

    Mirrors the information content of the reference TaskSpec proto
    (reference: src/ray/protobuf/common.proto TaskSpec) in plain Python.
    """

    task_id: TaskID
    job_id: JobID
    name: str
    # Function lives in the GCS function table under this key.
    function_key: bytes
    # Args: list of ("v", bytes) inline values or ("ref", ObjectID).
    args: List[Tuple[str, Any]]
    num_returns: int
    resources: ResourceSet
    # Actor fields
    is_actor_creation: bool = False
    is_actor_task: bool = False
    actor_id: Optional[ActorID] = None
    # Ordering for actor tasks: sequence numbers start at 1 per
    # (caller, actor incarnation); the receiver admits contiguously from 1.
    # Callers reset + renumber queued specs when the actor restarts.
    sequence_number: int = 0
    actor_incarnation: int = 0
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    # Actor options
    max_concurrency: int = 1
    # Creation: named concurrency groups (name -> max parallel calls);
    # actor tasks carry the group to execute under (reference:
    # core_worker/concurrency_group_manager.h).
    concurrency_groups: Optional[Dict[str, int]] = None
    concurrency_group: Optional[str] = None
    max_restarts: int = 0
    max_task_retries: int = 0
    actor_name: Optional[str] = None
    namespace: Optional[str] = None
    runtime_env: Optional[dict] = None
    # Owner (for refcounting / error routing)
    owner_worker_id: Optional[WorkerID] = None
    owner_address: Optional[str] = None
    method_name: Optional[str] = None
    # Attempt counter (filled by raylet on retries)
    attempt_number: int = 0
    # Owner-side lineage-reconstruction resubmissions of this task
    # (reference: task_manager.h:212 lineage pinning + retry accounting).
    reconstructions: int = 0
    detached: bool = False
    # num_returns="streaming": the task is a generator whose yields are
    # sealed incrementally as return indices 1..N; return index 0 is the
    # end-of-stream sentinel (item count, or the task's error).
    # Reference: core_worker/generator_waiter.h + ObjectRefGenerator.
    is_streaming: bool = False
    # W3C traceparent of the SUBMITTING context (reference:
    # util/tracing/tracing_helper.py — spans nest across task hops).
    trace_parent: Optional[str] = None

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)]

    def stream_item_id(self, index: int) -> ObjectID:
        """ObjectID of the index-th yielded item (0-based) of a streaming
        task; slot 0 is reserved for the end-of-stream sentinel."""
        return ObjectID.for_task_return(self.task_id, index + 1)


@dataclass
class NodeInfo:
    node_id: NodeID
    raylet_address: str
    object_store_dir: str
    resources_total: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)
    state: str = "ALIVE"  # ALIVE | SUSPECT | DRAINING | QUARANTINED | DEAD
    start_time: float = field(default_factory=time.time)
    is_head: bool = False
    hostname: str = ""
    # Membership incarnation, stamped by the GCS at registration and
    # monotonic per node_id across re-registrations (and across GCS
    # restarts — derived from wall time).  Raylet-originated writes
    # carry it; stale writes are fenced (NodeFencedError).
    incarnation: int = 0
    # Directional-chaos identity reported by the raylet (net: rules).
    net_name: str = ""
    # Gray-failure ladder: last computed suspicion score (0..1) and the
    # monotonic time the node entered SUSPECT/QUARANTINED (0 when not).
    suspicion: float = 0.0
    suspect_since: float = 0.0
    quarantined_since: float = 0.0
    # Times this node completed a QUARANTINED -> ALIVE recovery; above
    # the flap budget the node stays quarantined until operator action.
    flap_count: int = 0
    # Drain plane (reference: gcs_node_manager DrainNode + autoscaler
    # drain API): set when the node enters DRAINING.  reason is
    # "PREEMPTION" (spot/preemptible termination notice) or
    # "IDLE_TERMINATION" (autoscaler scale-down); deadline is the wall
    # time the node is expected to disappear; drain_complete flips once
    # actors are migrated and sole-copy objects are re-replicated.
    drain_reason: Optional[str] = None
    drain_deadline: float = 0.0
    drain_complete: bool = False


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    class_name: str
    state: str = "PENDING_CREATION"  # DEPENDENCIES_UNREADY|PENDING_CREATION|ALIVE|RESTARTING|DEAD
    node_id: Optional[NodeID] = None
    raylet_address: Optional[str] = None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: Optional[str] = None
    creation_spec: Optional[TaskSpec] = None
    detached: bool = False
    pid: int = 0
    # Direct RPC endpoint of the actor's worker process — callers push
    # method invocations straight to it (reference: actor_task_submitter.h).
    worker_address: Optional[str] = None


@dataclass
class Bundle:
    resources: ResourceSet
    node_id: Optional[NodeID] = None


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    name: Optional[str]
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    bundles: List[Bundle]
    state: str = "PENDING"  # PENDING | CREATED | REMOVED | RESCHEDULING
    creator_job: Optional[JobID] = None


async def event_loop_lag_loop(obj, loop, stop_pred=None, period: float = 0.5):
    """Shared control-plane congestion gauge (used by both the raylet
    and the GCS): how late a sleep(period) wakes up measures event-loop
    saturation.  Writes EWMA + max onto ``obj.event_loop_lag_ms`` /
    ``obj.event_loop_lag_max_ms``."""
    import asyncio

    obj.event_loop_lag_ms = getattr(obj, "event_loop_lag_ms", 0.0)
    obj.event_loop_lag_max_ms = getattr(obj, "event_loop_lag_max_ms", 0.0)
    while stop_pred is None or not stop_pred():
        t0 = loop.time()
        await asyncio.sleep(period)
        lag_ms = max(0.0, (loop.time() - t0 - period) * 1000)
        obj.event_loop_lag_ms = 0.8 * obj.event_loop_lag_ms + 0.2 * lag_ms
        obj.event_loop_lag_max_ms = max(obj.event_loop_lag_max_ms, lag_ms)
