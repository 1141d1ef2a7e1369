"""Placement groups (reference: python/ray/util/placement_group.py;
GCS-side two-phase commit in gcs_placement_group_scheduler.h:283)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import get_global_worker


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: Optional[List[Dict[str, float]]] = None):
        self.id = pg_id
        self._bundles = bundles

    def ready(self):
        """ObjectRef-style readiness: returns self after blocking wait (the
        reference returns an ObjectRef of a marker task; here `wait()` is
        the canonical API and `ready()` is sugar over it)."""
        self.wait()
        return self

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        from ray_tpu_torch._private import retry

        worker = get_global_worker()
        bo = retry.POLL.start(deadline_s=timeout_seconds)
        while True:
            info = worker.gcs_client.call("get_placement_group", self.id.binary())
            if info is None:
                raise exceptions.PlacementGroupSchedulingError("placement group removed")
            if info["state"] == "CREATED":
                return True
            if info["state"] == "REMOVED":
                raise exceptions.PlacementGroupSchedulingError("placement group removed")
            delay = bo.next_delay()
            if delay is None:
                return False
            time.sleep(delay)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            worker = get_global_worker()
            info = worker.gcs_client.call("get_placement_group", self.id.binary())
            self._bundles = [b["resources"] for b in info["bundles"]] if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: Optional[str] = None,
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid placement group strategy {strategy}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or all(v == 0 for v in b.values()):
            raise ValueError("placement group bundles must request resources")
    worker = get_global_worker()
    pg_id = PlacementGroupID.from_random()
    worker.gcs_client.call(
        "create_placement_group",
        {
            "pg_id": pg_id.binary(),
            "bundles": [dict(b) for b in bundles],
            "strategy": strategy,
            "name": name,
            "lifetime": lifetime,
        },
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup):
    worker = get_global_worker()
    worker.gcs_client.call("remove_placement_group", pg.id.binary())


def get_placement_group_state(pg: PlacementGroup) -> Optional[dict]:
    worker = get_global_worker()
    return worker.gcs_client.call("get_placement_group", pg.id.binary())


def placement_group_table() -> List[dict]:
    worker = get_global_worker()
    return worker.gcs_client.call("list_placement_groups", None)
