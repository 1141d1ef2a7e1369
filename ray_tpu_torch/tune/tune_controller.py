"""TuneController: the experiment event loop (reference:
python/ray/tune/execution/tune_controller.py:68 — schedules trial actors,
applies scheduler decisions, persists experiment state)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch.tune import trial as trial_mod
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trainable import _TrialRunner
from ray_tpu_torch.tune.trial import Trial

logger = logging.getLogger(__name__)

STATE_FILE = "experiment_state.json"


class TuneController:
    def __init__(
        self,
        trainable,
        searcher: Searcher,
        scheduler: Optional[TrialScheduler],
        experiment_dir: str,
        *,
        metric: Optional[str] = None,
        mode: str = "max",
        max_concurrent: int = 8,
        max_failures: int = 0,
        stop: Optional[Any] = None,
        time_budget_s: Optional[float] = None,
        checkpoint_frequency: int = 0,
        restored_trials: Optional[List[Trial]] = None,
        max_trials: Optional[int] = None,
    ):
        self.trainable = trainable
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(metric, mode)
        self.experiment_dir = experiment_dir
        os.makedirs(experiment_dir, exist_ok=True)
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent
        self.max_failures = max_failures
        self.stop_criteria = stop
        self.time_budget_s = time_budget_s
        self.checkpoint_frequency = checkpoint_frequency
        self.max_trials = max_trials
        self.trials: List[Trial] = list(restored_trials or [])
        self._futures: Dict[Any, Trial] = {}  # step ObjectRef -> trial
        self._searcher_done = False
        self._trainable_name = getattr(trainable, "__name__", "trainable")

    # -- actor management --------------------------------------------------
    def _resources(self) -> Dict[str, Any]:
        res = dict(getattr(self.trainable, "_tune_resources", None) or {"cpu": 1})
        opts: Dict[str, Any] = {}
        if "cpu" in res:
            opts["num_cpus"] = res.pop("cpu")
        if "gpu" in res:
            opts["num_gpus"] = res.pop("gpu")
        if "tpu" in res:
            # The reference maps "tpu" to num_tpus; the port's runtime
            # counts cards as GPU and has no TPU resource.
            raise ValueError(
                'with_resources(..., {"tpu": ...}): the port\'s runtime has no TPU '
                'resource; lease a card with {"gpu": n}'
            )
        if res:
            opts["resources"] = res
        return opts

    def _start_trial(self, t: Trial, restore_from: Optional[str] = None):
        runner_cls = ray_tpu_torch.remote(**self._resources())(_TrialRunner)
        t.runner = runner_cls.remote(
            self.trainable,
            t.config,
            t.trial_id,
            t.local_dir,
            os.path.basename(self.experiment_dir),
            restore_from if restore_from is not None else t.checkpoint_path,
        )
        t.status = trial_mod.RUNNING
        self._futures[t.runner.step.remote()] = t

    def _stop_trial(self, t: Trial, status: str, error_msg: Optional[str] = None, save: bool = True):
        if t.runner is not None:
            try:
                if save and status == trial_mod.TERMINATED:
                    path = ray_tpu_torch.get(t.runner.save.remote(), timeout=30)
                    if path:
                        t.checkpoint_path = path
                t.runner.stop.remote()
            except exceptions.RayError:
                pass
            try:
                ray_tpu_torch.kill(t.runner)
            except exceptions.RayError:
                pass
            t.runner = None
        t.status = status
        t.error_msg = error_msg
        self.searcher.on_trial_complete(
            t.trial_id, t.last_result or None, error=(status == trial_mod.ERROR)
        )
        self.scheduler.on_trial_complete(t, t.last_result or None)

    # -- searcher ----------------------------------------------------------
    def _maybe_add_trials(self):
        # resume restored/paused PENDING trials first, even if the searcher
        # is exhausted
        while self._num_live() < self.max_concurrent:
            pending = [t for t in self.trials if t.status == trial_mod.PENDING and t.runner is None]
            if not pending:
                break
            self._start_trial(pending[0])
        while not self._searcher_done and self._num_live() < self.max_concurrent:
            if self.max_trials is not None and len(self.trials) >= self.max_trials:
                self._searcher_done = True
                break
            t_id = f"t{len(self.trials):05d}"
            cfg = self.searcher.suggest(t_id)
            if cfg is Searcher.FINISHED:
                self._searcher_done = True
                break
            if cfg is None:
                break  # searcher wants to wait for in-flight results
            t = Trial(cfg, self.experiment_dir, trial_id=t_id, trainable_name=self._trainable_name)
            self.trials.append(t)
            self.scheduler.on_trial_add(t)
            self._start_trial(t)

    def _num_live(self) -> int:
        return sum(1 for t in self.trials if t.status == trial_mod.RUNNING)

    # -- stop criteria -----------------------------------------------------
    def _should_stop_trial(self, result: Dict[str, Any]) -> bool:
        s = self.stop_criteria
        if s is None:
            return False
        if callable(s):
            return bool(s(result))
        if isinstance(s, dict):
            return any(k in result and result[k] >= v for k, v in s.items())
        return False

    # -- PBT exploit -------------------------------------------------------
    def _exploit(self, t: Trial):
        info = t._pbt_exploit
        t._pbt_exploit = None
        source = next((x for x in self.trials if x.trial_id == info["source"]), None)
        if source is None:
            self._futures[t.runner.step.remote()] = t
            return
        src_ckpt = source.checkpoint_path
        if source.runner is not None:
            try:
                src_ckpt = ray_tpu_torch.get(source.runner.save.remote(), timeout=60) or src_ckpt
                source.checkpoint_path = src_ckpt
            except exceptions.RayError:
                pass
        new_config = info["mutate"]({**source.config, **{}} if source.config else dict(t.config))
        logger.info("PBT exploit: %s <- %s, new config %s", t.trial_id, source.trial_id, new_config)
        # restart the trial actor with the source checkpoint + mutated config
        try:
            ray_tpu_torch.kill(t.runner)
        except exceptions.RayError:
            pass
        t.runner = None
        t.config = new_config
        t.checkpoint_path = src_ckpt
        self._start_trial(t, restore_from=src_ckpt)

    # -- persistence -------------------------------------------------------
    def save_state(self):
        state = {
            "timestamp": time.time(),
            "metric": self.metric,
            "mode": self.mode,
            "searcher_state": self.searcher.save(),
            "trials": [t.to_json() for t in self.trials],
        }
        tmp = os.path.join(self.experiment_dir, STATE_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, os.path.join(self.experiment_dir, STATE_FILE))

    # -- main loop ---------------------------------------------------------
    def run(self) -> List[Trial]:
        deadline = time.monotonic() + self.time_budget_s if self.time_budget_s else None
        self._maybe_add_trials()
        last_save = 0.0
        while self._futures or any(t.status == trial_mod.PENDING for t in self.trials):
            if deadline and time.monotonic() > deadline:
                logger.warning("time budget exhausted; stopping all trials")
                for t in list(self.trials):
                    if t.status == trial_mod.RUNNING:
                        self._stop_trial(t, trial_mod.TERMINATED)
                self._futures.clear()
                break
            if not self._futures:
                self._maybe_add_trials()
                if not self._futures:
                    break
            ready, _ = ray_tpu_torch.wait(list(self._futures), num_returns=1, timeout=1.0)
            for ref in ready:
                t = self._futures.pop(ref)
                self._handle_result(t, ref)
            self._maybe_add_trials()
            if time.monotonic() - last_save > 5.0:
                self.save_state()
                last_save = time.monotonic()
        self.save_state()
        return self.trials

    def _handle_result(self, t: Trial, ref):
        try:
            out = ray_tpu_torch.get(ref)
        except exceptions.RayError as e:
            self._on_trial_failure(t, str(e))
            return
        kind = out.get("kind")
        if kind == "error":
            self._on_trial_failure(t, out.get("traceback", "unknown error"))
            return
        metrics = out.get("metrics") or {}
        if metrics:
            metrics.setdefault("config", t.config)
            metrics.setdefault("trial_id", t.trial_id)
            t.last_result = metrics
            t.metric_history.append(metrics)
        if out.get("checkpoint_path"):
            t.checkpoint_path = out["checkpoint_path"]
        if kind == "finished":
            self._stop_trial(t, trial_mod.TERMINATED)
            return
        self.searcher.on_trial_result(t.trial_id, metrics)
        decision = self.scheduler.on_trial_result(t, metrics)
        if self._should_stop_trial(metrics):
            decision = TrialScheduler.STOP
        if decision == TrialScheduler.STOP:
            self._stop_trial(t, trial_mod.TERMINATED)
        elif decision == TrialScheduler.PAUSE and t._pbt_exploit:
            self._exploit(t)
        elif decision == TrialScheduler.PAUSE:
            self._pause_trial(t)
        else:
            itr = metrics.get("training_iteration", 0)
            if self.checkpoint_frequency and itr and itr % self.checkpoint_frequency == 0:
                try:
                    path = ray_tpu_torch.get(t.runner.save.remote(), timeout=60)
                    if path:
                        t.checkpoint_path = path
                except exceptions.RayError:
                    pass
            self._futures[t.runner.step.remote()] = t

    def _pause_trial(self, t: Trial):
        try:
            path = ray_tpu_torch.get(t.runner.save.remote(), timeout=60)
            if path:
                t.checkpoint_path = path
        except exceptions.RayError:
            pass
        try:
            ray_tpu_torch.kill(t.runner)
        except exceptions.RayError:
            pass
        t.runner = None
        t.status = trial_mod.PAUSED

    def _on_trial_failure(self, t: Trial, error_msg: str):
        t.num_failures += 1
        logger.warning("trial %s failed (%d): %s", t.trial_id, t.num_failures, error_msg.splitlines()[-1] if error_msg else "")
        if t.runner is not None:
            try:
                ray_tpu_torch.kill(t.runner)
            except exceptions.RayError:
                pass
            t.runner = None
        if t.num_failures <= self.max_failures:
            self._start_trial(t, restore_from=t.checkpoint_path)
        else:
            t.status = trial_mod.ERROR
            t.error_msg = error_msg
            self.searcher.on_trial_complete(t.trial_id, None, error=True)
            self.scheduler.on_trial_complete(t, None)


def load_experiment_state(experiment_dir: str):
    path = os.path.join(experiment_dir, STATE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
