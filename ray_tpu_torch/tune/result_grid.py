"""ResultGrid (reference: python/ray/tune/result_grid.py)."""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.tune import trial as trial_mod
from ray_tpu_torch.tune.trial import Trial


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str] = None, mode: str = "max"):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self._results = [
            Result(
                metrics=t.last_result or None,
                checkpoint=Checkpoint(t.checkpoint_path) if t.checkpoint_path else None,
                error=RuntimeError(t.error_msg) if t.error_msg else None,
                path=t.local_dir,
            )
            for t in trials
        ]

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def num_errors(self) -> int:
        return sum(1 for t in self._trials if t.status == trial_mod.ERROR)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._trials if t.status == trial_mod.TERMINATED)

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("get_best_result requires a metric (pass one or set TuneConfig.metric)")
        scored = [r for r in self._results if r.metrics and metric in r.metrics]
        if not scored:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            if r.metrics:
                row = {k: v for k, v in r.metrics.items() if not isinstance(v, (dict, list))}
                for ck, cv in (r.metrics.get("config") or {}).items():
                    row[f"config/{ck}"] = cv
                rows.append(row)
        return pd.DataFrame(rows)
