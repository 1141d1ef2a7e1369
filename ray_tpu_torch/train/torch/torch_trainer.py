"""TorchTrainer (reference: python/ray/train/torch/torch_trainer.py; the
counterpart of the JAX package's ``JaxTrainer``).

DataParallelTrainer with the TorchConfig backend: each worker is one rank
of a ``torch.distributed`` process group, and ``train_loop_per_worker``
builds its model and optimizer and all-reduces its gradients over that
group, or, with ``sharding_config``, binds the trainer's GSPMD layout to
a ``DeviceMesh`` over the group (``train.sharding.plan_from_context()``)
and trains DTensors on it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.base_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


class TorchTrainer(DataParallelTrainer):
    _default_backend_config = TorchConfig()

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        torch_config: Optional[TorchConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        sharding_config: Optional[Any] = None,
    ):
        """``sharding_config`` (a
        :class:`ray_tpu_torch.train.sharding.ShardingConfig`) declares the
        GSPMD layout for this run: a batch x model device mesh over the
        worker group plus regex partition rules.  It travels to every
        rank's session — inside the loop,
        ``train.get_context().get_sharding_config()`` /
        ``sharding.plan_from_context()`` bind it to the live process
        group."""
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.sharding_config = sharding_config

    def _constructor_state(self):
        state = super()._constructor_state()
        # This constructor names the backend config `torch_config`.
        state["torch_config"] = state.pop("backend_config")
        state["sharding_config"] = self.sharding_config
        return state
