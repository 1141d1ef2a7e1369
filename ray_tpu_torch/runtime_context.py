"""Runtime context (reference: python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.worker import get_global_worker


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    def get_job_id(self) -> str:
        return self._worker.job_id.hex() if self._worker.job_id else ""

    def get_node_id(self) -> str:
        return self._worker.node_id.hex() if self._worker.node_id else ""

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        return self._worker.current_task_id.hex() if self._worker.current_task_id else None

    def get_actor_id(self) -> Optional[str]:
        return self._worker.actor_id.hex() if self._worker.actor_id else None

    def get_actor_name(self) -> Optional[str]:
        spec = self._worker.current_spec
        return spec.actor_name if spec else None

    @property
    def namespace(self) -> str:
        return self._worker.namespace

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False  # populated once actor restart counters are plumbed

    def get_assigned_resources(self) -> dict:
        spec = self._worker.current_spec
        return dict(spec.resources) if spec else {}

    def get_runtime_env_string(self) -> str:
        spec = self._worker.current_spec
        import json

        return json.dumps(spec.runtime_env or {}) if spec else "{}"


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(get_global_worker())
