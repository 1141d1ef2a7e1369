"""ray_tpu_torch.util — core extensions (reference: python/ray/util/)."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "ActorPool",
    "Queue",
    "list_named_actors",
]


def list_named_actors(all_namespaces: bool = False):
    """Currently alive named actors (reference: ray.util.list_named_actors):
    their names in the caller's namespace, or
    ``[{"namespace": ..., "name": ...}]`` across all namespaces."""
    from ray_tpu_torch._private.worker import get_global_worker

    worker = get_global_worker()
    rows = worker.gcs_client.call(
        "list_named_actors", (bool(all_namespaces), worker.namespace)
    ) or []
    if all_namespaces:
        return rows
    return [r["name"] for r in rows]


def __getattr__(name):
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool

        return ActorPool
    if name == "Queue":
        from ray_tpu_torch.util.queue import Queue

        return Queue
    if name in ("collective", "state", "metrics", "queue", "tracing"):
        import importlib

        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    raise AttributeError(name)
