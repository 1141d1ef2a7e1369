"""_TrainSession: runs the user's train loop on a thread inside the
worker actor and shuttles reports back (reference:
python/ray/train/_internal/session.py:111)."""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import Any, Dict, Optional

from ray_tpu_torch.train import checkpoint_plane
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.context import _set_session

FINISHED = "__finished__"
ERRORED = "__errored__"


class SessionInvalidatedError(RuntimeError):
    """This session belongs to a superseded worker-group generation: an
    elastic resize replaced it.  Raised inside the old train-loop thread
    at its next report so it unwinds instead of racing the new loop."""


class _TrainSession:
    def __init__(
        self,
        train_fn,
        world_rank: int,
        local_rank: int,
        node_rank: int,
        world_size: int,
        local_world_size: int,
        experiment_name: str,
        storage_dir: str,
        resume_checkpoint: Optional[Checkpoint] = None,
        dataset_shards: Optional[Dict[str, Any]] = None,
        generation: int = 0,
        collective_group_name: Optional[str] = None,
    ):
        self.train_fn = train_fn
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.world_size = world_size
        self.local_world_size = local_world_size
        self.experiment_name = experiment_name
        self.storage_dir = storage_dir
        self.resume_checkpoint = resume_checkpoint
        self.dataset_shards = dataset_shards or {}
        # Elastic resize epoch: bumped by the backend executor on every
        # shrink/grow; the rendezvous generation for any out-of-band
        # collective group this session's loop joins.
        self.generation = generation
        self.collective_group_name = collective_group_name
        # maxsize=1 gives natural lockstep with the driver's polling.
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._report_idx = 0
        self._last_report_t: Optional[float] = None
        self.error: Optional[BaseException] = None
        # Drain plane: set when any rank's node received a preemption /
        # scale-down notice.  The train loop polls it via
        # train.get_context().drain_requested() and should checkpoint at
        # the next step boundary — the proactive path that avoids losing
        # progress to the mid-collective death.
        self._drain_requested = threading.Event()
        # Elastic plane: set when this session was superseded by a resize;
        # the old loop thread unwinds at its next report.
        self._stopped = threading.Event()
        # Durable checkpoint plane: bounded background writer (one write
        # in flight; the next report back-pressures).  Lazy — sessions
        # that never checkpoint never spawn the thread.
        self._ckpt_writer: Optional[checkpoint_plane.AsyncCheckpointWriter] = None

    def request_drain_checkpoint(self):
        """A drain notice covers this worker group: ask the user loop for
        an immediate best-effort checkpoint."""
        self._drain_requested.set()

    def drain_requested(self) -> bool:
        return self._drain_requested.is_set()

    def shutdown(self):
        """Retire this session (elastic resize replaced it): the loop
        thread raises SessionInvalidatedError at its next report, and any
        put() it is currently blocked in is released by draining the
        queue.  Idempotent."""
        self._stopped.set()
        # Land any in-flight async checkpoint write before retiring: the
        # resize may hand exactly that directory out as the resume
        # checkpoint.  Errors are swallowed — restore verifies, and an
        # uncommitted directory is never adopted.
        if self._ckpt_writer is not None:
            try:
                self._ckpt_writer.close(timeout=30.0)
            except Exception:
                pass
        # Release a loop thread blocked in _queue.put (maxsize=1) waiting
        # for a driver poll that will never come.  Drain ONLY — refilling
        # the slot (e.g. with a sentinel) could win the race against the
        # woken putter and leave it blocked forever.  Driver polls are
        # serialized with this call by the actor executor, so no poller
        # can be concurrently blocked on this queue.
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        # Tear down this run's collective group so ranks blocked in a
        # TCP recv against OUR sockets cascade-unwind (their error maps
        # to GroupInvalidatedError once the generation marker advances).
        if self.collective_group_name:
            try:
                from ray_tpu_torch.util.collective import collective as _coll

                _coll._manager.destroy(self.collective_group_name)
            except Exception:
                pass

    def start(self):
        def runner():
            _set_session(self)
            try:
                self.train_fn()
                # The loop's last checkpoint may still be in the async
                # writer: land it (or raise its failure) before reporting
                # the run finished, so the Result never names a
                # directory that is still being written.
                if self._ckpt_writer is not None:
                    self._ckpt_writer.wait()
                if not self._stopped.is_set():
                    self._queue.put((FINISHED, None, None))
            except SessionInvalidatedError:
                pass  # superseded by a resize: nobody is listening
            except BaseException as e:  # noqa: BLE001
                self.error = e
                # Close this rank's collective sockets so peers blocked in
                # a recv against us unwind instead of hanging (their error
                # surfaces as GroupInvalidatedError once the generation
                # marker advances).
                if self.collective_group_name:
                    try:
                        from ray_tpu_torch.util.collective import collective as _coll

                        _coll._manager.destroy(self.collective_group_name)
                    except Exception:
                        pass
                if not self._stopped.is_set():
                    self._queue.put((ERRORED, {"traceback": traceback.format_exc()}, e))

        self._thread = threading.Thread(target=runner, daemon=True, name="train-loop")
        self._thread.start()

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint]):
        if self._stopped.is_set():
            raise SessionInvalidatedError(
                "this training session was superseded by an elastic resize"
            )
        # Per-train-step wall time (report-to-report) feeds the
        # train_step_seconds histogram — the pod-scale "where does step
        # time go" signal (flight recorder, docs/observability.md).
        now = time.monotonic()
        if self._last_report_t is not None:
            from ray_tpu_torch._private import telemetry

            telemetry.observe_train_step(self.world_rank, now - self._last_report_t)
        self._last_report_t = now
        # Device memory gauges ride the same per-step cadence (CPU-safe
        # no-op; internally rate-limited to ~1/s).
        from ray_tpu_torch._private import profiling as profiling_mod

        profiling_mod.report_device_memory()
        persisted = None
        if checkpoint is not None:
            # Persist into the run's storage dir; rank-tagged (reference:
            # StorageContext.persist_current_checkpoint, storage.py:514).
            # Generation-scoped name: _report_idx restarts with every
            # elastic resize, so without the generation a new session's
            # first checkpoint would OVERWRITE the very directory the
            # resize handed out as the resume checkpoint — a worker that
            # reads it late resumes one step ahead and desynchronizes the
            # report rounds.  (Generation 0 keeps the classic name.)
            prefix = (
                f"checkpoint_g{self.generation:03d}_" if self.generation
                else "checkpoint_"
            )
            dest = os.path.join(
                self.storage_dir,
                f"{prefix}{self._report_idx:06d}_rank{self.world_rank}",
            )
            if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                self._persist_checkpoint(checkpoint.path, dest)
            persisted = Checkpoint(dest)
        self._report_idx += 1
        self._queue.put(("report", dict(metrics), persisted))
        if self._stopped.is_set():
            # Retired while blocked in put(): unwind now, the new session
            # owns the actor.
            raise SessionInvalidatedError(
                "this training session was superseded by an elastic resize"
            )

    def _persist_checkpoint(self, src: str, dest: str) -> None:
        """Snapshot-commit ``src`` into the run's storage dir.  The user
        loop already host-snapshotted into ``src`` (Checkpoint.from_*),
        so the serialize+CRC+write+commit here is the part the async
        writer takes off the train step.  A failed async write surfaces
        as CheckpointWriteError on the NEXT report via submit(); drain /
        preempt forces the synchronous path (flush + sync persist) so
        the checkpoint is durable before the shrink."""
        from ray_tpu_torch._private.config import CONFIG

        meta = {
            "experiment": self.experiment_name,
            "generation": self.generation,
            "report_idx": self._report_idx,
            "world_rank": self.world_rank,
            "world_size": self.world_size,
        }

        def _persist(mode: str) -> None:
            checkpoint_plane.persist_dir(src, dest, meta=meta, mode=mode)
            # Retention: one sweeper per world (rank 0) is enough — all
            # ranks share the storage dir and groups live/die together.
            if self.world_rank == 0:
                pinned = [dest]
                if self.resume_checkpoint is not None:
                    pinned.append(self.resume_checkpoint.path)
                checkpoint_plane.gc_checkpoints(self.storage_dir, pinned=pinned)

        use_async = bool(CONFIG.train_checkpoint_async) and not self._drain_requested.is_set()
        if use_async:
            if self._ckpt_writer is None:
                # graftlint: disable=shared-state-race -- report() runs on the loop thread (train.report inside train_fn), the same thread that reads the writer after train_fn returns
                self._ckpt_writer = checkpoint_plane.AsyncCheckpointWriter(
                    name=f"ckpt-writer-r{self.world_rank}"
                )
            # Back-pressures while the previous write is in flight and
            # raises its failure (typed) instead of queueing over it.
            self._ckpt_writer.submit(lambda: _persist("async"))
        else:
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait()
            _persist("sync")

    def next_report(self, timeout: Optional[float] = None):
        """Blocking fetch of the next report; driver calls via actor rpc."""
        try:
            kind, metrics, ckpt = self._queue.get(timeout=timeout)
        except queue.Empty:
            return {"kind": "pending"}
        if kind == FINISHED:
            return {"kind": "finished"}
        if kind == ERRORED:
            return {"kind": "error", "traceback": metrics["traceback"]}
        return {"kind": "report", "metrics": metrics, "checkpoint": ckpt}

    def finished(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()
