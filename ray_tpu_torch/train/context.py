"""Per-worker training context (reference: python/ray/train/context.py:26
TrainContext; session functions python/ray/train/_internal/session.py)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_session_holder = threading.local()


def _get_session():
    s = getattr(_session_holder, "session", None)
    if s is None:
        raise RuntimeError(
            "No training session active — this API must be called inside "
            "train_loop_per_worker."
        )
    return s


def _set_session(session):
    _session_holder.session = session


class TrainContext:
    def get_world_size(self) -> int:
        """Current world size.  DYNAMIC under elastic training
        (ScalingConfig.min_workers): each resize re-enters
        train_loop_per_worker with the new size, so loops must size
        per-step work off this call, not off a captured constant."""
        return _get_session().world_size

    def get_world_rank(self) -> int:
        return _get_session().world_rank

    def get_local_rank(self) -> int:
        return _get_session().local_rank

    def get_local_world_size(self) -> int:
        return _get_session().local_world_size

    def get_node_rank(self) -> int:
        return _get_session().node_rank

    def get_experiment_name(self) -> str:
        return _get_session().experiment_name

    def get_trial_name(self) -> str:
        return _get_session().experiment_name

    def get_storage(self):
        return _get_session().storage_dir

    def drain_requested(self) -> bool:
        """True once any node hosting this worker group received a drain
        notice (preemption or scale-down).  Loops that poll this and
        report a checkpoint at the next step boundary resume from that
        step instead of the last periodic checkpoint."""
        return _get_session().drain_requested()

    def get_generation(self) -> int:
        """Elastic resize epoch of this worker group: 0 for the initial
        formation, +1 per shrink/grow.  Also the rendezvous generation
        for the group's collective namespace (see
        get_collective_group_name)."""
        return getattr(_get_session(), "generation", 0)

    def get_sharding_config(self):
        """The :class:`~ray_tpu_torch.train.sharding.ShardingConfig` this
        run was launched with (None when the trainer declared no GSPMD
        layout).  Bind it to the live process group with
        ``ray_tpu_torch.train.sharding.plan_from_context()`` — under elastic
        training the mesh is rebuilt per generation, so the plan must be
        rebuilt each time the loop (re)enters."""
        return getattr(_get_session(), "sharding_config", None)

    def get_collective_group_name(self) -> Optional[str]:
        """Group name reserved for this training run's out-of-band
        collectives.  Loops that init a util.collective group under this
        name MUST pass generation=ctx.get_generation(): the backend
        executor bumps the generation marker on every resize, so
        stragglers of a torn-down world get GroupInvalidatedError instead
        of hanging in a mesh that will never complete."""
        return getattr(_get_session(), "collective_group_name", None)


def get_context() -> TrainContext:
    return TrainContext()


def report(metrics: Dict[str, Any], checkpoint=None):
    """Report metrics (and optionally a checkpoint) from a worker
    (reference: python/ray/train/_internal/session.py:667)."""
    _get_session().report(metrics, checkpoint)


def get_checkpoint():
    """Latest checkpoint to resume from, or None (reference:
    session.get_checkpoint)."""
    return _get_session().resume_checkpoint


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    shard = s.dataset_shards.get(name) if s.dataset_shards else None
    if shard is None:
        raise KeyError(f"no dataset shard named '{name}' was provided to the trainer")
    return shard
