"""Run/scaling configs (reference: python/ray/air/config.py:102
ScalingConfig, as_placement_group_factory :267; RunConfig/FailureConfig/
CheckpointConfig).  ``use_gpu`` gives each worker one card's ``GPU``
resource, as the reference's ``use_gpu`` does; every worker sees all of
its node's cards (no device ids are assigned per worker)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    trainer_resources: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # Elastic training floor: when set (and < num_workers), the trainer
    # treats world size as dynamic — a preempted/dead rank shrinks the
    # group to the largest healthy size >= min_workers (checkpoint,
    # re-rendezvous, resume; NOT charged to FailureConfig.max_failures),
    # and the group grows back toward num_workers at the next epoch
    # boundary once capacity returns.  None = fixed-size (the classic
    # whole-group-restart recovery).
    min_workers: Optional[int] = None

    def __post_init__(self):
        if self.min_workers is not None:
            if self.min_workers < 1:
                raise ValueError(
                    f"ScalingConfig.min_workers must be >= 1, got {self.min_workers}"
                )
            if self.min_workers > self.num_workers:
                raise ValueError(
                    f"ScalingConfig.min_workers ({self.min_workers}) cannot "
                    f"exceed num_workers ({self.num_workers})"
                )

    @property
    def elastic(self) -> bool:
        """True when the group may run below num_workers (min_workers set)."""
        return self.min_workers is not None and self.min_workers < self.num_workers

    def _worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        if self.use_gpu:
            return {"GPU": 1.0}
        return {"CPU": 1.0}

    def as_placement_group_factory(self):
        from ray_tpu_torch.util.placement_group import placement_group

        bundles = [self._worker_resources() for _ in range(self.num_workers)]
        strategy = self.placement_strategy

        def factory():
            return placement_group(bundles, strategy=strategy)

        return factory


@dataclass
class FailureConfig:
    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    verbose: int = 1
    log_to_file: bool = False
    # Trial stop criteria: dict ({"training_iteration": 10} /
    # {"metric": threshold}) or callable(result)->bool (reference:
    # air.RunConfig(stop=...) / tune.run stop).
    stop: Optional[Any] = None

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser("~/ray_tpu_torch_results")
