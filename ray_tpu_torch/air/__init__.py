"""ray_tpu_torch.air — shared configs and result types (reference:
python/ray/air/config.py)."""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result

__all__ = ["ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig", "Result"]
