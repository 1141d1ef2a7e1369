"""Serve internal datatypes (reference: serve/_private/common.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class AutoscalingConfig:
    """(reference: serve/config.py AutoscalingConfig — queue-depth driven)"""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0


@dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    # proxy-enforced load-shedding bound: requests in flight through a
    # proxy beyond this are shed with 503 + Retry-After (-1 = unbounded;
    # reference: serve/config.py max_queued_requests)
    max_queued_requests: int = -1
    route_prefix: Optional[str] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    version: str = "1"
    user_config: Any = None
    # per-tenant token-rate quotas {"tenant": {"rate": tok/s, "burst":
    # tokens}}, enforced at the proxy (flows there via the route table);
    # empty = no quotas (docs/serving.md "Overload resilience")
    tenant_quotas: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ReplicaInfo:
    replica_id: str
    deployment_name: str
    version: str
    actor: Any = None  # ActorHandle
    state: str = "STARTING"  # STARTING|RUNNING|STOPPING|DEAD
