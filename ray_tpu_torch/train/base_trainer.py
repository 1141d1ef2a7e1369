"""BaseTrainer + DataParallelTrainer (reference:
python/ray/train/base_trainer.py:111, data_parallel_trainer.py:25;
call stack SURVEY.md §3.4)."""

from __future__ import annotations

import inspect
import logging
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor,
    TrainingWorkerError,
)

logger = logging.getLogger(__name__)

# restore() override sentinel: distinguishes "not passed" from an
# explicit None (resume_from_checkpoint=None = start fresh)
_UNSET = object()


class TrainingFailedError(RuntimeError):
    """Training failed after exhausting FailureConfig.max_failures
    (reference: train/base_trainer.py:56)."""


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self) -> Result:
        raise NotImplementedError

    @classmethod
    def restore(cls, path: str, **kwargs):
        """Rebuild a trainer from a previous run's experiment directory
        and resume from its latest checkpoint (reference:
        train/base_trainer.py:250 restore → trainer.pkl + latest
        checkpoint discovery).  `kwargs` override saved constructor
        fields.

        Unpicklable constructor fields (a closure train loop, live
        dataset iterators) are recorded BY NAME at save time; restoring
        without re-supplying them raises immediately with the exact
        parameter list instead of failing later with a half-built
        trainer (re-specification is a first-class typed API, not a
        runtime warning)."""
        import os
        import pickle

        state_path = os.path.join(path, "trainer.pkl")
        if not os.path.exists(state_path):
            raise FileNotFoundError(
                f"{path!r} is not a restorable experiment dir (no trainer.pkl); "
                f"was it produced by Trainer.fit()?"
            )
        with open(state_path, "rb") as f:
            data = pickle.load(f)
        if isinstance(data, dict) and "fields" in data and "unpicklable" in data:
            state = data["fields"]
            missing = [f for f in data["unpicklable"] if f not in kwargs]
            if missing:
                raise ValueError(
                    f"{cls.__name__}.restore({path!r}): these constructor "
                    f"fields could not be pickled at save time and must be "
                    f"passed as keyword overrides: {', '.join(sorted(missing))} "
                    f"— e.g. {cls.__name__}.restore(path, "
                    + ", ".join(f"{m}=..." for m in sorted(missing))
                    + ")"
                )
        else:  # pre-partial-save layout
            state = data
        state.update(kwargs)
        if "resume_from_checkpoint" not in kwargs:
            latest = _latest_checkpoint(path)
            if latest is not None:
                state["resume_from_checkpoint"] = Checkpoint.from_directory(latest)
        run_config = state.get("run_config") or RunConfig()
        # Re-run into the SAME experiment dir so repeated crashes keep
        # resuming forward.
        run_config.name = os.path.basename(os.path.normpath(path))
        run_config.storage_path = os.path.dirname(os.path.normpath(path))
        state["run_config"] = run_config
        return cls(**state)

    @staticmethod
    def can_restore(path: str) -> bool:
        import os

        return os.path.exists(os.path.join(path, "trainer.pkl"))

    def _save_trainer_state(self, storage_dir: str) -> None:
        """Persist what restore() needs, excluding live run state.

        Saved FIELD BY FIELD: picklable fields round-trip; unpicklable
        ones are recorded by name so restore() can demand them as typed
        overrides instead of silently skipping the whole save."""
        import os
        import pickle

        fields, unpicklable = {}, []
        for key, value in self._constructor_state().items():
            try:
                pickle.dumps(value)
                fields[key] = value
            except Exception:
                unpicklable.append(key)
        if unpicklable:
            logger.info(
                "trainer fields %s are not picklable; Trainer.restore will "
                "require them as keyword overrides", unpicklable,
            )
        blob = pickle.dumps({"fields": fields, "unpicklable": unpicklable})
        tmp = os.path.join(storage_dir, ".trainer.pkl.tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(storage_dir, "trainer.pkl"))

    def _constructor_state(self) -> Dict[str, Any]:
        return {
            "scaling_config": self.scaling_config,
            "run_config": self.run_config,
            "datasets": self.datasets,
        }


def _latest_checkpoint(path: str) -> Optional[str]:
    """Newest VERIFIED checkpoint dir under the experiment dir (elastic
    resizes write generation-scoped names checkpoint_gGGG_NNNNNN_rank0;
    newest is by (generation, report index)).  Goes through the
    checkpoint plane's fallback-chain loader: a corrupt / partial /
    uncommitted newest is skipped (counted) and the walk continues to
    the last good one — garbage is never adopted."""
    from ray_tpu_torch.train import checkpoint_plane

    return checkpoint_plane.resolve_restore(root=path, rank=0)


def _verified_resume(ckpt: Optional[Checkpoint]) -> Optional[Checkpoint]:
    """Resolve a resume checkpoint through the checkpoint plane before
    handing it to a restart/shrink/grow: if it is uncommitted (an async
    write still in flight or killed mid-save) or fails CRC validation,
    walk back through the retained chain in the same storage dir to the
    last good one.  Raises CheckpointCorruptionError only when NOTHING
    in the chain verifies — a corrupted checkpoint is never adopted."""
    if ckpt is None:
        return None
    from ray_tpu_torch.train import checkpoint_plane

    path = checkpoint_plane.resolve_restore(
        preferred=ckpt.path, root=os.path.dirname(ckpt.path), rank=0
    )
    if path is None:
        return None
    if os.path.abspath(path) == os.path.abspath(ckpt.path):
        return ckpt
    return Checkpoint.from_directory(path)


class DataParallelTrainer(BaseTrainer):
    """SPMD trainer: N workers each run `train_loop_per_worker`; the
    backend (``TorchConfig`` for ``TorchTrainer``) wires them into one
    ``torch.distributed`` process group."""

    _default_backend_config: BackendConfig = None  # set by subclasses

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint,
            datasets=datasets,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        if backend_config is None:
            backend_config = type(self)._default_backend_config or BackendConfig()
        self.backend_config = backend_config

    # ------------------------------------------------------------------
    def _wrapped_train_fn(self):
        fn = self.train_loop_per_worker
        config = dict(self.train_loop_config)
        sig = inspect.signature(fn)
        if len(sig.parameters) >= 1:
            return lambda: fn(config)
        return fn

    def _dataset_shards_per_rank(self, n: Optional[int] = None) -> Optional[List[Dict[str, Any]]]:
        """Shard the datasets across `n` ranks (default: the configured
        num_workers).  Under elastic training this is re-invoked at every
        resize with the NEW world size, so data re-shards to match."""
        if not self.datasets:
            return None
        if n is None:
            n = self.scaling_config.num_workers
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                # equal=True: every rank sees the SAME number of rows.
                # Rank shards drive collective train steps — one starved
                # rank (e.g. a single-block dataset dealt whole to rank
                # 0) deadlocks the others inside the first collective
                # (reference: data_parallel_trainer's equal splitting).
                its = ds.streaming_split(n, equal=True)
                for i in range(n):
                    shards[i][name] = its[i]
            elif hasattr(ds, "split"):
                for i, piece in enumerate(ds.split(n)):
                    shards[i][name] = piece
            else:
                for i in range(n):
                    shards[i][name] = ds
        return shards

    def _constructor_state(self) -> Dict[str, Any]:
        state = super()._constructor_state()
        state.update(
            train_loop_per_worker=self.train_loop_per_worker,
            train_loop_config=self.train_loop_config,
            backend_config=self.backend_config,
        )
        return state

    @classmethod
    def restore(
        cls,
        path: str,
        *,
        train_loop_per_worker: Any = _UNSET,
        train_loop_config: Any = _UNSET,
        datasets: Any = _UNSET,
        scaling_config: Any = _UNSET,
        run_config: Any = _UNSET,
        backend_config: Any = _UNSET,
        resume_from_checkpoint: Any = _UNSET,
    ) -> "DataParallelTrainer":
        """Typed restore (reference: train/base_trainer.py:250): the
        re-bindable fields are explicit parameters — the common case is
        re-passing `train_loop_per_worker` (closures don't pickle) and
        `datasets` (live iterators don't either).  An EXPLICIT
        ``resume_from_checkpoint=None`` disables auto-resume (sentinel
        default, so passing None is distinguishable from omitting)."""
        overrides = {
            k: v
            for k, v in dict(
                train_loop_per_worker=train_loop_per_worker,
                train_loop_config=train_loop_config,
                datasets=datasets,
                scaling_config=scaling_config,
                run_config=run_config,
                backend_config=backend_config,
                resume_from_checkpoint=resume_from_checkpoint,
            ).items()
            if v is not _UNSET
        }
        return super().restore(path, **overrides)

    def fit(self) -> Result:
        name = self.run_config.name or f"train_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
        failure_config = self.run_config.failure_config or FailureConfig()
        max_failures = failure_config.max_failures
        attempts = 0
        # Drain-triggered (proactive) restarts: a drain notice covering a
        # rank's node triggers one best-effort checkpoint + whole-group
        # restart that does NOT count against max_failures — the failure
        # budget is only charged when the proactive checkpoint never
        # materializes and the death is discovered reactively.
        drain_restarts = 0
        latest_checkpoint: Optional[Checkpoint] = self.resume_from_checkpoint
        last_error: Optional[BaseException] = None
        elastic = bool(getattr(self.scaling_config, "elastic", False))

        while True:
            executor = BackendExecutor(
                self.backend_config, self.scaling_config, self.run_config, name,
            )
            proactive = False
            try:
                executor.start()
                self._save_trainer_state(executor.storage_dir)
                executor.start_training(
                    self._wrapped_train_fn(),
                    resume_checkpoint=latest_checkpoint,
                    dataset_shards_fn=self._dataset_shards_per_rank,
                )
                metrics_history: List[Dict[str, Any]] = []
                best_checkpoints = []
                while True:
                    try:
                        round_results = executor.get_next_results()
                    except ray_tpu_torch.exceptions.RayActorError as e:
                        # A worker PROCESS died mid-round (preemption that
                        # outran its notice, OOM, SIGKILL).  Elastic
                        # groups shrink and continue from the latest
                        # checkpoint — capacity loss is not a failure, so
                        # nothing is charged to max_failures.  (A user
                        # exception raises TrainingWorkerError instead and
                        # is always charged.)
                        # A dead rank may have left its async checkpoint
                        # write mid-flight: resolve through the verified
                        # fallback chain before anyone resumes from it.
                        latest_checkpoint = _verified_resume(latest_checkpoint)
                        if elastic and executor.shrink("worker_death", latest_checkpoint):
                            continue
                        raise e
                    if round_results is None:
                        break
                    reports = [r for r in round_results if r["kind"] == "report"]
                    if not reports:
                        continue
                    metrics = reports[0]["metrics"]  # rank 0 convention
                    metrics_history.append(metrics)
                    round_ckpt = False
                    for r in reports:
                        if r.get("checkpoint") is not None:
                            latest_checkpoint = r["checkpoint"]
                            round_ckpt = True
                    if reports and reports[0].get("checkpoint"):
                        best_checkpoints.append((reports[0]["checkpoint"], metrics))
                    if round_ckpt and executor.preempt_pending():
                        # Priority preemption notice (multi-tenant plane)
                        # and a checkpoint landed after it: release the
                        # requested workers via checkpoint-and-shrink.
                        # Capacity yielded to a higher-priority job is
                        # not a failure — nothing is charged to
                        # max_failures, and no work is lost (survivors
                        # resume from this round's checkpoint).
                        latest_checkpoint = _verified_resume(latest_checkpoint)
                        if elastic and executor.shrink("preempt", latest_checkpoint):
                            continue
                    if round_ckpt and executor.drain_imminent():
                        # A drain notice covers the group and a checkpoint
                        # landed after it (the report round is the
                        # barrier: every rank reached this step).
                        latest_checkpoint = _verified_resume(latest_checkpoint)
                        if elastic and executor.shrink("drain", latest_checkpoint):
                            # Shrunk past the doomed ranks: survivors keep
                            # their actors and resume from the checkpoint.
                            # Not charged to max_failures.
                            continue
                        if drain_restarts == 0:
                            # Fixed-size (or shrink refused below
                            # min_workers): the whole-group restart,
                            # off the doomed node, from this checkpoint.
                            proactive = True
                            break
                    if executor.grow_pending():
                        # Epoch boundary + capacity returned: grow back
                        # toward num_workers.  Growing re-enters the loop
                        # from the latest checkpoint, so only attempt it
                        # once one exists (never trade real progress for
                        # idle chips).
                        if latest_checkpoint is not None:
                            latest_checkpoint = _verified_resume(latest_checkpoint)
                        if latest_checkpoint is not None:
                            executor.try_grow(latest_checkpoint)
                if proactive:
                    drain_restarts += 1
                    executor.shutdown()
                    logger.warning(
                        "drain notice: restarting worker group from the "
                        "drain-triggered checkpoint (not counted against "
                        "max_failures=%d)", max_failures,
                    )
                    continue
                executor.shutdown()
                return Result(
                    metrics=metrics_history[-1] if metrics_history else None,
                    checkpoint=latest_checkpoint,
                    path=executor.storage_dir,
                    best_checkpoints=best_checkpoints,
                )
            except (TrainingWorkerError, ray_tpu_torch.exceptions.RayActorError) as e:
                last_error = e
                executor.shutdown()
                # The group died with a write possibly mid-flight: the
                # restart must resume from a COMMITTED checkpoint.
                latest_checkpoint = _verified_resume(latest_checkpoint)
                attempts += 1
                if attempts > max_failures:
                    raise TrainingFailedError(
                        f"training failed after {attempts} attempt(s); last error:\n{e}"
                    ) from e
                logger.warning("training attempt %d failed, restarting group: %s", attempts, e)
            except BaseException:
                executor.shutdown()
                raise
