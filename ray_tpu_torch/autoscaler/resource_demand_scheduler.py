"""Bin-pack pending resource demands onto node types (reference:
autoscaler/_private/resource_demand_scheduler.py:102
ResourceDemandScheduler.get_nodes_to_launch)."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _fits(demand: Dict[str, float], free: Dict[str, float]) -> bool:
    return all(free.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _consume(demand: Dict[str, float], free: Dict[str, float]):
    for k, v in demand.items():
        free[k] = free.get(k, 0.0) - v


def get_nodes_to_launch(
    pending_demands: List[Dict[str, float]],
    existing_free: List[Dict[str, float]],
    node_types: Dict[str, dict],
    pending_launches: Dict[str, int],
    max_workers: int,
    current_workers: int,
) -> Dict[str, int]:
    """First-fit-decreasing: satisfy demands against current free capacity
    (plus already-pending launches), then pick node types for the rest."""
    free = [dict(f) for f in existing_free]
    # capacity already on the way
    for node_type, count in pending_launches.items():
        res = node_types[node_type].get("resources", {})
        free.extend(dict(res) for _ in range(count))

    unmet: List[Dict[str, float]] = []
    for demand in sorted(pending_demands, key=lambda d: -sum(d.values())):
        for f in free:
            if _fits(demand, f):
                _consume(demand, f)
                break
        else:
            unmet.append(demand)

    to_launch: Dict[str, int] = {}
    budget = max_workers - current_workers - sum(pending_launches.values())
    for demand in unmet:
        # leftover capacity of nodes launched for earlier unmet demands
        placed = False
        for f in free:
            if _fits(demand, f):
                _consume(demand, f)
                placed = True
                break
        if placed:
            continue
        if budget <= 0:
            break
        # smallest node type that fits the demand
        candidates = [
            (sum(spec.get("resources", {}).values()), name, spec)
            for name, spec in node_types.items()
            if _fits(demand, dict(spec.get("resources", {})))
            and (spec.get("max_workers") is None
                 or to_launch.get(name, 0) + pending_launches.get(name, 0) < spec["max_workers"])
        ]
        if not candidates:
            continue  # infeasible on any type — surface via status, don't loop
        _, name, spec = min(candidates)
        to_launch[name] = to_launch.get(name, 0) + 1
        budget -= 1
        # the new node's remaining capacity can absorb later demands
        f = dict(spec.get("resources", {}))
        _consume(demand, f)
        free.append(f)
    return to_launch
