"""Result of a training run (reference: python/ray/air/result.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional["Any"]
    error: Optional[BaseException] = None
    path: Optional[str] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: List[Tuple[Any, Dict[str, Any]]] = field(default_factory=list)

    @property
    def config(self):
        return self.metrics.get("config") if self.metrics else None
