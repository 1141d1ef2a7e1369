"""Trainable API + the trial-runner actor (reference:
python/ray/tune/trainable/trainable.py Trainable class API;
function_trainable.py for fn(config) trainables running on a session
thread)."""

from __future__ import annotations

import inspect
import os
import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.context import _set_session

TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Class trainable: the controller drives step() iterations."""

    def __init__(self, config: Optional[Dict[str, Any]] = None, trial_dir: str = "."):
        self.config = config or {}
        self.trial_dir = trial_dir
        self.iteration = 0
        self.setup(self.config)

    # -- subclass API -----------------------------------------------------
    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Any]:
        return None

    def load_checkpoint(self, checkpoint_dir: str):
        pass

    def cleanup(self):
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable can hot-swap configs (PBT uses this
        to avoid a restart)."""
        return False


class _FnSession:
    """Session placed in train.context for function trainables, so
    ray_tpu_torch.tune.report / ray_tpu_torch.train.report work inside fn(config).
    Mirrors the _TrainSession report surface (world_rank 0, world 1)."""

    world_rank = 0
    local_rank = 0
    node_rank = 0
    world_size = 1
    local_world_size = 1
    dataset_shards: Dict[str, Any] = {}

    def __init__(self, trial_dir: str, experiment_name: str, resume_checkpoint: Optional[Checkpoint]):
        self.storage_dir = trial_dir
        self.experiment_name = experiment_name
        self.resume_checkpoint = resume_checkpoint
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._idx = 0

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        persisted = None
        if checkpoint is not None:
            from ray_tpu_torch.train import checkpoint_plane

            dest = os.path.join(self.storage_dir, f"checkpoint_{self._idx:06d}")
            if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                # Snapshot-commit (tmp+fsync+rename per file + manifest):
                # a trial killed mid-report never leaves a plausible
                # partial checkpoint for resume to adopt.
                checkpoint_plane.persist_dir(
                    checkpoint.path, dest,
                    meta={"trial": self.experiment_name, "idx": self._idx},
                    mode="sync",
                )
                checkpoint_plane.gc_checkpoints(self.storage_dir, pinned=[dest])
            persisted = Checkpoint(dest)
        self._idx += 1
        self._queue.put(("report", dict(metrics), persisted))


class _TrialRunner:
    """The per-trial actor: wraps a class or function trainable behind a
    uniform step/save/stop interface driven by the TuneController."""

    def __init__(
        self,
        trainable,
        config: Dict[str, Any],
        trial_id: str,
        trial_dir: str,
        experiment_name: str = "exp",
        restore_from: Optional[str] = None,
    ):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.iteration = 0
        # Route every resume through the verified loader: a checkpoint
        # whose writer was killed mid-commit (or that bit-rotted) is
        # skipped and the newest verified one in the trial dir adopted.
        restore_from = self._verified_restore(restore_from)
        self._last_checkpoint: Optional[str] = restore_from
        self._is_function = not (inspect.isclass(trainable) and issubclass(trainable, Trainable))
        if self._is_function:
            self._fn = trainable
            self._config = config
            resume = Checkpoint(restore_from) if restore_from else None
            self._session = _FnSession(trial_dir, experiment_name, resume)
            self._thread: Optional[threading.Thread] = None
        else:
            self._trainable = trainable(config, trial_dir)
            if restore_from:
                self._trainable.load_checkpoint(restore_from)

    def _verified_restore(self, restore_from: Optional[str]) -> Optional[str]:
        if not restore_from:
            return None
        from ray_tpu_torch.train import checkpoint_plane

        return checkpoint_plane.resolve_restore(
            preferred=restore_from, root=os.path.dirname(restore_from)
        )

    # ------------------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is not None:
            return

        def runner():
            _set_session(self._session)
            try:
                out = self._fn(self._config) if _fn_wants_config(self._fn) else self._fn()
                self._session._queue.put(("finished", out if isinstance(out, dict) else {}, None))
            except BaseException:  # noqa: BLE001
                self._session._queue.put(("error", {"traceback": traceback.format_exc()}, None))

        self._thread = threading.Thread(target=runner, daemon=True, name=f"tune-{self.trial_id}")
        self._thread.start()

    def step(self) -> Dict[str, Any]:
        """One result: for class trainables one step() call; for function
        trainables the next report()."""
        if self._is_function:
            self._ensure_thread()
            kind, metrics, ckpt = self._session._queue.get()
            if kind == "error":
                return {"kind": "error", "traceback": metrics["traceback"]}
            if kind == "finished":
                return {"kind": "finished", "metrics": metrics}
            self.iteration += 1
            metrics.setdefault(TRAINING_ITERATION, self.iteration)
            if ckpt is not None:
                self._last_checkpoint = ckpt.path
            return {
                "kind": "report",
                "metrics": metrics,
                "checkpoint_path": self._last_checkpoint,
            }
        try:
            metrics = self._trainable.step()
        except BaseException:  # noqa: BLE001
            return {"kind": "error", "traceback": traceback.format_exc()}
        self.iteration += 1
        self._trainable.iteration = self.iteration
        metrics = dict(metrics or {})
        metrics.setdefault(TRAINING_ITERATION, self.iteration)
        done = bool(metrics.get("done"))
        return {
            "kind": "finished" if done else "report",
            "metrics": metrics,
            "checkpoint_path": self._last_checkpoint,
        }

    def save(self) -> Optional[str]:
        """Persist a checkpoint; returns its directory."""
        if self._is_function:
            return self._last_checkpoint
        from ray_tpu_torch.train import checkpoint_plane

        ckpt_dir = os.path.join(self.trial_dir, f"checkpoint_{self.iteration:06d}")
        os.makedirs(ckpt_dir, exist_ok=True)
        self._trainable.save_checkpoint(ckpt_dir)
        # Class trainables wrote files directly into the dir: commit the
        # manifest in place so resume/exploit can verify before adopting.
        checkpoint_plane.commit_directory(
            ckpt_dir, meta={"trial": self.trial_id, "iteration": self.iteration}
        )
        checkpoint_plane.gc_checkpoints(self.trial_dir, pinned=[ckpt_dir])
        self._last_checkpoint = ckpt_dir
        return ckpt_dir

    def reset(self, new_config: Dict[str, Any]) -> bool:
        """Try to hot-swap config (class trainables only)."""
        if self._is_function:
            return False
        ok = self._trainable.reset_config(new_config)
        if ok:
            self._trainable.config = new_config
        return ok

    def stop(self):
        if not self._is_function:
            self._trainable.cleanup()
        return True


def _fn_wants_config(fn: Callable) -> bool:
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return True


def with_parameters(trainable, **kwargs):
    """Bind large constant objects into a trainable (reference:
    python/ray/tune/trainable/util.py:with_parameters)."""
    if inspect.isclass(trainable):

        class _Bound(trainable):
            def setup(self, config):
                merged = dict(config)
                return trainable.setup(self, merged, **kwargs)

        _Bound.__name__ = trainable.__name__
        return _Bound

    def wrapped(config):
        return trainable(config, **kwargs)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


def with_resources(trainable, resources: Dict[str, float]):
    """Attach per-trial resource requests (reference:
    python/ray/tune/trainable/util.py:with_resources)."""
    trainable._tune_resources = dict(resources)
    return trainable
