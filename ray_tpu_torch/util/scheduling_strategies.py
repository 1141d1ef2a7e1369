"""Scheduling strategies (reference:
python/ray/util/scheduling_strategies.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "object"
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    """Run only on nodes whose labels contain every (key, value) in
    `hard` (reference: NodeLabelSchedulingStrategy + label scheduling
    policy).  Node labels come from `raylet --labels` / Cluster
    add_node(labels=...)."""

    hard: dict
    soft: Optional[dict] = None  # accepted for parity; hard rules decide


SPREAD = "SPREAD"
DEFAULT = "DEFAULT"
