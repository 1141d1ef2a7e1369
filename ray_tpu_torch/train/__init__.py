"""ray_tpu_torch.train — distributed training orchestration (reference:
python/ray/train; call stack SURVEY.md §3.4).  ``TorchTrainer`` runs the
loop on each worker inside one ``torch.distributed`` process group (NCCL
on GPU workers, gloo otherwise)."""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import (
    BaseTrainer,
    DataParallelTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.train.context import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)

__all__ = [
    "BaseTrainer",
    "DataParallelTrainer",
    "TrainingFailedError",
    "Backend",
    "BackendConfig",
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainContext",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "report",
    "TorchTrainer",
    "TorchConfig",
]


def __getattr__(name):
    # Lazy, as the reference's JaxTrainer: the torch backend imports torch
    # only when a trainer is built.
    if name in ("TorchTrainer", "TorchConfig"):
        from ray_tpu_torch.train import torch as _torch

        return getattr(_torch, name)
    if name == "torch":
        import importlib

        return importlib.import_module("ray_tpu_torch.train.torch")
    raise AttributeError(name)
