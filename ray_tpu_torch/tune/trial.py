"""Trial record (reference: python/ray/tune/experiment/trial.py)."""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(
        self,
        config: Dict[str, Any],
        experiment_dir: str,
        trial_id: Optional[str] = None,
        trainable_name: str = "trainable",
    ):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.config = config
        self.trainable_name = trainable_name
        self.status = PENDING
        self.last_result: Dict[str, Any] = {}
        self.metric_history: list = []
        self.checkpoint_path: Optional[str] = None
        self.error_msg: Optional[str] = None
        self.num_failures = 0
        self.local_dir = os.path.join(experiment_dir, f"{trainable_name}_{self.trial_id}")
        os.makedirs(self.local_dir, exist_ok=True)
        # runtime-only fields (not persisted)
        self.runner = None  # ActorHandle of _TrialRunner
        self._pbt_exploit = None

    @property
    def path(self) -> str:
        return self.local_dir

    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def to_json(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": _jsonable(self.config),
            "trainable_name": self.trainable_name,
            "status": self.status if self.status != RUNNING else PENDING,
            "last_result": _jsonable(self.last_result),
            "checkpoint_path": self.checkpoint_path,
            "error_msg": self.error_msg,
            "num_failures": self.num_failures,
            "local_dir": self.local_dir,
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "Trial":
        t = cls.__new__(cls)
        t.trial_id = data["trial_id"]
        t.config = data["config"]
        t.trainable_name = data.get("trainable_name", "trainable")
        t.status = data["status"]
        t.last_result = data.get("last_result", {})
        t.metric_history = []
        t.checkpoint_path = data.get("checkpoint_path")
        t.error_msg = data.get("error_msg")
        t.num_failures = data.get("num_failures", 0)
        t.local_dir = data["local_dir"]
        t.runner = None
        t._pbt_exploit = None
        return t

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, config={self.config})"


def _jsonable(obj):
    import json

    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return repr(obj)
