"""Tuner + TuneConfig (reference: python/ray/tune/tuner.py:44,
tune/tune_config.py)."""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune import trial as trial_mod
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tune_controller import TuneController, load_experiment_state


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    time_budget_s: Optional[float] = None
    seed: int = 0


class Tuner:
    """tuner = Tuner(trainable, param_space=..., tune_config=..., run_config=...)
    results = tuner.fit()"""

    def __init__(
        self,
        trainable=None,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restored_trials=None,
        _experiment_dir: Optional[str] = None,
    ):
        from ray_tpu_torch.train.base_trainer import BaseTrainer

        if isinstance(trainable, BaseTrainer):
            trainable = _trainer_as_trainable(trainable)
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored_trials = _restored_trials
        self._experiment_dir = _experiment_dir

    def _resolve_experiment_dir(self) -> str:
        if self._experiment_dir:
            return self._experiment_dir
        name = self.run_config.name or f"tune_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
        return os.path.join(self.run_config.resolved_storage_path(), name)

    def fit(self) -> ResultGrid:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        tc = self.tune_config
        searcher = tc.search_alg
        if searcher is None:
            searcher = BasicVariantGenerator(self.param_space, tc.num_samples, tc.seed)
        else:
            searcher.set_search_properties(tc.metric, tc.mode, self.param_space)
        exp_dir = self._resolve_experiment_dir()
        max_concurrent = tc.max_concurrent_trials
        if max_concurrent is None:
            try:
                max_concurrent = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 8)))
            except Exception:
                max_concurrent = 8
        failure_config = self.run_config.failure_config
        ckpt_config = self.run_config.checkpoint_config
        controller = TuneController(
            self.trainable,
            searcher,
            tc.scheduler,
            exp_dir,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent=max_concurrent,
            max_failures=failure_config.max_failures if failure_config else 0,
            stop=getattr(self.run_config, "stop", None),
            time_budget_s=tc.time_budget_s,
            checkpoint_frequency=ckpt_config.checkpoint_frequency if ckpt_config else 0,
            restored_trials=self._restored_trials,
            # custom searchers have no num_samples notion; cap total trials
            max_trials=tc.num_samples if tc.search_alg is not None else None,
        )
        if self._restored_trials and searcher is not None:
            state = load_experiment_state(exp_dir)
            if state and state.get("searcher_state"):
                try:
                    searcher.restore(state["searcher_state"])
                except Exception:
                    pass
        trials = controller.run()
        return ResultGrid(trials, tc.metric, tc.mode)

    @classmethod
    def restore(
        cls,
        path: str,
        trainable,
        *,
        resume_errored: bool = False,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference:
        python/ray/tune/tuner.py Tuner.restore)."""
        state = load_experiment_state(path)
        if state is None:
            raise FileNotFoundError(f"no experiment state found under {path}")
        trials = []
        for tdata in state["trials"]:
            t = Trial.from_json(tdata)
            if t.status == trial_mod.ERROR and resume_errored:
                t.status = trial_mod.PENDING
                t.num_failures = 0
            elif t.status == trial_mod.PAUSED:
                t.status = trial_mod.PENDING
            trials.append(t)
        tc = tune_config or TuneConfig(metric=state.get("metric"), mode=state.get("mode") or "max")
        rc = run_config or RunConfig(name=os.path.basename(path), storage_path=os.path.dirname(path))
        return cls(
            trainable,
            param_space=param_space,
            tune_config=tc,
            run_config=rc,
            _restored_trials=trials,
            _experiment_dir=path,
        )

    @classmethod
    def can_restore(cls, path: str) -> bool:
        return load_experiment_state(path) is not None


def _trainer_as_trainable(trainer):
    """Wrap a Train trainer so Tune can sweep its train_loop_config
    (reference: base_trainer.fit wrapping itself in a single-trial Tuner)."""

    def trainable(config):
        import copy

        t = copy.copy(trainer)
        merged = dict(t.train_loop_config or {})
        merged.update(config.get("train_loop_config", config))
        t.train_loop_config = merged
        result = t.fit()
        out = dict(result.metrics or {})
        out["done"] = True
        from ray_tpu_torch.tune import report

        report(out)

    trainable.__name__ = type(trainer).__name__
    trainable._tune_resources = {"cpu": 0.5}
    return trainable
