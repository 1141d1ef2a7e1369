"""Backend interface (reference: python/ray/train/backend.py Backend /
BackendConfig — the hook pair that sets up the collective runtime on the
worker group, e.g. _TorchBackend.on_start running init_process_group,
reference train/torch/config.py:153)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        pass
