"""BackendExecutor: owns the worker group and the training lifecycle
(reference: python/ray/train/_internal/backend_executor.py:68 — start
:135, start_training :451, get_next_results :578).

Elastic mode (ScalingConfig.min_workers): the worker group is a dynamic
quantity.  A drain notice or worker death shrinks the group to the
largest healthy size >= min_workers — only the affected ranks are torn
down, survivors keep their actors — and the group re-forms under a
bumped **generation**: sessions restart with the new world size, the
run's collective-group namespace is invalidated so old-generation
stragglers get GroupInvalidatedError instead of hanging, and training
resumes from the latest checkpoint.  When capacity returns (a node
registers ALIVE), the next epoch boundary grows the group back toward
num_workers the same way.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train._internal.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingWorkerError(Exception):
    def __init__(self, rank: int, tb: str):
        self.rank = rank
        self.traceback_str = tb
        super().__init__(f"training worker rank {rank} failed:\n{tb}")


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        experiment_name: str,
        sharding_config=None,
    ):
        self.backend_config = backend_config
        # GSPMD layout declaration (train/sharding): forwarded into every
        # session so the loop can bind it to the live device view.
        self.sharding_config = sharding_config
        self.backend = backend_config.backend_cls()()
        self.scaling = scaling_config
        self.run_config = run_config
        self.experiment_name = experiment_name
        self.worker_group: Optional[WorkerGroup] = None
        self._ranks_meta: List[dict] = []
        self.storage_dir = os.path.join(run_config.resolved_storage_path(), experiment_name)
        os.makedirs(self.storage_dir, exist_ok=True)
        # Elastic resize epoch: 0 at formation, +1 per shrink/grow.  Also
        # the rendezvous generation of the run's collective namespace.
        self.generation = 0
        self.elastic = bool(getattr(scaling_config, "elastic", False))
        self.collective_group_name = f"train/{experiment_name}"
        # Training state needed to restart sessions across resizes.
        self._train_fn: Optional[Callable[[], None]] = None
        self._dataset_shards_fn: Optional[Callable[[int], Optional[List[dict]]]] = None
        # Drain plane: nodes that received a drain notice while hosting a
        # rank (preemption / scale-down).  The trainer reads
        # drain_imminent() and either shrinks (elastic) or restarts the
        # group from a drain-triggered checkpoint.
        self._drained_nodes: set = set()
        self._rank_nodes: set = set()
        # Priority-preemption plane (multi-tenant): a GCS preempt_job
        # notice asks this job to release capacity.  The elastic path
        # checkpoints at the next report boundary and shrinks by the
        # requested worker count — cooperative, never a raw kill.
        self._preempt_release = 0
        self._preempt_listener = None
        self._preempt_tenant_label = None
        # Capacity-return plane: set when a node registers ALIVE while the
        # group runs below num_workers; consumed by try_grow().
        self._capacity_event = threading.Event()
        self._next_grow_attempt = 0.0
        # Consecutive failed grow attempts: each one stalls the report
        # loop for the lease timeout, so the retry backoff escalates
        # (reset by a FRESH ALIVE signal or a successful grow).
        self._grow_failures = 0
        self._node_listener = None

    def start(self):
        # A fresh executor over a namespace a PREVIOUS incarnation used
        # (whole-group restart after a refused shrink, a re-run against
        # the same cluster) must bump PAST that generation, not join it:
        # the old generation's rendezvous keys still hold the dead
        # incarnation's addresses, and stragglers of the old world should
        # fail typed.  invalidate_collective_group also reaps the stale
        # keys.  A virgin namespace (no marker) starts at generation 0.
        try:
            from ray_tpu_torch.util import collective

            cur = collective.get_collective_group_generation(
                self.collective_group_name
            )
            if cur is not None:
                # Auto-increment form: atomic under concurrent bumps
                # (kv_put_max), never raises on a raced marker.
                self.generation = collective.invalidate_collective_group(
                    self.collective_group_name
                )
        except Exception:
            pass
        pg = None
        # Elastic groups lease workers individually: a fixed-size
        # placement group would couple every rank's fate to one atomic
        # reservation, exactly what shrink-through-preemption must avoid.
        if not self.elastic and self.scaling.num_workers > 1:
            pg = self.scaling.as_placement_group_factory()()
            if not pg.wait(timeout_seconds=120):
                raise TimeoutError(
                    "placement group for training workers not ready after 120s "
                    f"(bundles={pg.bundle_specs})"
                )
        self.worker_group = WorkerGroup(
            self.scaling.num_workers, self.scaling._worker_resources(), placement_group=pg
        )
        if self.elastic:
            # Bounded formation (the PG path's 120 s equivalent): start at
            # the largest healthy size — workers that can't lease within
            # the window are dropped, provided min_workers still form.
            alive = self.worker_group.alive_ranks(timeout=120.0)
            if len(alive) < self.scaling.num_workers:
                min_workers = self.scaling.min_workers or self.scaling.num_workers
                if len(alive) < min_workers:
                    raise TimeoutError(
                        f"only {len(alive)}/{self.scaling.num_workers} elastic "
                        f"training workers became ready after 120s "
                        f"(min_workers={min_workers})"
                    )
                pending = [
                    r for r in range(self.scaling.num_workers) if r not in alive
                ]
                logger.warning(
                    "elastic formation: starting at %d/%d workers (%d lease(s) "
                    "not granted in time)", len(alive),
                    self.scaling.num_workers, len(pending),
                )
                self.worker_group.remove_ranks(pending)
        self._refresh_meta()
        self.backend.on_start(self.worker_group, self.backend_config)
        self._watch_node_events()

    def _refresh_meta(self):
        self._ranks_meta = self.worker_group.metadata()
        self._rank_nodes = {m["node_id"] for m in self._ranks_meta}

    def _watch_node_events(self):
        from ray_tpu_torch._private.worker import get_global_worker

        def on_node_event(state, node):
            try:
                node_hex = node["node_id"].hex() if isinstance(
                    node.get("node_id"), bytes
                ) else str(node.get("node_id"))
            except Exception:
                return
            if state == "ALIVE":
                # Capacity returned: a new node registered.  Only relevant
                # while an elastic group runs shrunken.  A fresh signal
                # resets the grow backoff — this node was not part of the
                # previous failed attempts.
                if self.elastic and self.worker_group is not None and (
                    len(self.worker_group.workers) < self.scaling.num_workers
                ):
                    self._grow_failures = 0
                    self._capacity_event.set()
                return
            if state != "DRAINING":
                return
            if node_hex not in self._rank_nodes or node_hex in self._drained_nodes:
                return
            self._drained_nodes.add(node_hex)
            logger.warning(
                "drain notice covers rank node %s: requesting immediate "
                "checkpoint from all ranks", node_hex[:8],
            )
            # Best-effort: ask every rank's session for a checkpoint at
            # the next step boundary (fire-and-forget actor calls).
            for w in list(self.worker_group.workers):
                try:
                    w.notify_drain.remote()
                except Exception:
                    pass

        self._node_listener = on_node_event
        try:
            get_global_worker().add_node_listener(on_node_event)
        except Exception:
            self._node_listener = None

        def on_preempt(notice: dict):
            if not self.elastic or self.worker_group is None:
                return
            release = max(1, int(notice.get("release_workers") or 1))
            self._preempt_release = max(self._preempt_release, release)
            # The GCS clamps the label against its tenant registry; the
            # shrink counter must land on the SAME label as the
            # notice/actor_restart counts for this preemption.
            self._preempt_tenant_label = notice.get("tenant_label")
            logger.warning(
                "preemption notice: releasing %d worker(s) at the next "
                "checkpoint boundary (%s)", release, notice.get("reason"),
            )
            # Same cooperative path as a drain notice: every rank's
            # session checkpoints at its next step boundary.
            for w in list(self.worker_group.workers):
                try:
                    w.notify_drain.remote()
                except Exception:
                    pass

        self._preempt_listener = on_preempt
        try:
            get_global_worker().add_job_preempt_listener(on_preempt)
        except Exception:
            self._preempt_listener = None

    def preempt_pending(self) -> bool:
        """True while a preemption notice asks this (elastic) group to
        release workers and the group still sits above min_workers."""
        if not self.elastic or self.worker_group is None:
            return False
        min_workers = self.scaling.min_workers or self.scaling.num_workers
        return (
            self._preempt_release > 0
            and len(self.worker_group.workers) > min_workers
        )

    def drain_imminent(self) -> bool:
        """True while any node hosting a CURRENT rank is draining (the
        set shrinks when a resize removes the affected ranks)."""
        return bool(self._drained_nodes & self._rank_nodes)

    def grow_pending(self) -> bool:
        """True when the group runs below num_workers and a capacity
        signal arrived (node registered ALIVE) with the grow backoff
        elapsed — the trainer calls try_grow() at the next epoch
        boundary."""
        return (
            self.elastic
            and self.worker_group is not None
            and len(self.worker_group.workers) < self.scaling.num_workers
            and self._capacity_event.is_set()
            and time.monotonic() >= self._next_grow_attempt
        )

    def _rank_info(self) -> List[dict]:
        """world/local/node ranks per worker, grouped by node (reference:
        backend_executor _create_rank_mapping)."""
        by_node: Dict[str, List[int]] = defaultdict(list)
        for rank, meta in enumerate(self._ranks_meta):
            by_node[meta["node_id"]].append(rank)
        node_ranks = {node: i for i, node in enumerate(sorted(by_node))}
        out = []
        for rank, meta in enumerate(self._ranks_meta):
            node = meta["node_id"]
            out.append(
                {
                    "world_rank": rank,
                    "local_rank": by_node[node].index(rank),
                    "node_rank": node_ranks[node],
                    "local_world_size": len(by_node[node]),
                }
            )
        return out

    def start_training(self, train_fn: Callable[[], None], resume_checkpoint=None,
                       dataset_shards_fn: Optional[Callable[[int], Optional[List[dict]]]] = None):
        self._train_fn = train_fn
        self._dataset_shards_fn = dataset_shards_fn
        self.backend.on_training_start(self.worker_group, self.backend_config)
        self._start_sessions(resume_checkpoint)

    def _start_sessions(self, resume_checkpoint):
        infos = self._rank_info()
        n = len(self.worker_group.workers)
        dataset_shards = self._dataset_shards_fn(n) if self._dataset_shards_fn else None
        refs = []
        for rank, w in enumerate(self.worker_group.workers):
            info = infos[rank]
            session_kwargs = dict(
                world_rank=info["world_rank"],
                local_rank=info["local_rank"],
                node_rank=info["node_rank"],
                world_size=n,
                local_world_size=info["local_world_size"],
                experiment_name=self.experiment_name,
                storage_dir=self.storage_dir,
                resume_checkpoint=resume_checkpoint,
                dataset_shards=(dataset_shards[rank] if dataset_shards else None),
                generation=self.generation,
                collective_group_name=self.collective_group_name,
                sharding_config=self.sharding_config,
            )
            refs.append(w.start_session.remote(self._train_fn, session_kwargs))
        ray_tpu_torch.get(refs)

    # ------------------------------------------------------------------
    # elastic resize plane
    # ------------------------------------------------------------------
    def _reform(self, resume_checkpoint, direction: str, trigger: str,
                from_size: int):
        """Common tail of shrink/grow: bump the generation, invalidate
        the run's collective namespace so old-generation stragglers raise
        instead of hang, re-rendezvous the backend, restart sessions."""
        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch.util import tracing

        t0 = time.monotonic()
        self.generation += 1
        to_size = len(self.worker_group.workers)
        with tracing.start_span(
            "train.resize",
            attributes={
                "direction": direction,
                "trigger": trigger,
                "from_size": from_size,
                "to_size": to_size,
                "generation": self.generation,
                "experiment": self.experiment_name,
            },
        ):
            try:
                from ray_tpu_torch.util import collective

                collective.invalidate_collective_group(
                    self.collective_group_name, self.generation
                )
            except Exception:
                # Group namespace never used / GCS hiccup: the resize must
                # not die on the advisory invalidation.
                logger.debug("collective generation bump failed", exc_info=True)
            # Quiesce survivors FIRST: their old loop threads must unwind
            # (bounded by one report interval) before the backend tears
            # down / re-forms the collective runtime underneath them.
            retire_refs = []
            for w in self.worker_group.workers:
                try:
                    retire_refs.append(w.retire_session.remote())
                except Exception:
                    pass
            for ref in retire_refs:
                try:
                    ray_tpu_torch.get(ref, timeout=60)
                except Exception:
                    pass
            self._refresh_meta()
            self.backend.on_start(self.worker_group, self.backend_config)
            self.backend.on_training_start(self.worker_group, self.backend_config)
            self._start_sessions(resume_checkpoint)
        elapsed = time.monotonic() - t0
        telemetry.count_resize_event(direction, trigger)
        telemetry.observe_resize(direction, elapsed)
        # Publish (or clear) the pending grow intent NOW, not at the
        # epoch boundary: the autoscaler needs the lead time to have
        # replacement capacity warm when try_grow runs.
        self._update_grow_hint()
        logger.warning(
            "elastic %s (%s): worker group %d -> %d (generation %d) in %.2fs",
            direction, trigger, from_size, to_size, self.generation, elapsed,
        )

    def shrink(self, trigger: str, resume_checkpoint) -> bool:
        """Tear down only the affected ranks (drained nodes + dead
        actors) and re-form at the largest healthy size.  Returns False —
        leaving the group untouched — when the survivor count would fall
        below min_workers (the caller falls back to the whole-group
        restart path) or when there is nothing to shrink."""
        if not self.elastic or self.worker_group is None:
            return False
        from ray_tpu_torch._private.config import CONFIG

        group = self.worker_group
        from_size = len(group.workers)
        min_workers = self.scaling.min_workers or self.scaling.num_workers
        if trigger == "preempt":
            # Priority preemption: no rank is dead or doomed — release
            # the REQUESTED count (clamped to what min_workers allows),
            # shedding the highest ranks (cheapest re-shard: survivors
            # keep contiguous ranks 0..n-1).  The freed actors' resources
            # go to the starved higher-priority demand; telemetry charges
            # the shrink to this job's tenant.
            release = min(self._preempt_release, from_size - min_workers)
            self._preempt_release = 0
            if release <= 0:
                return False
            casualties = list(range(from_size - release, from_size))
            from ray_tpu_torch._private import telemetry

            try:
                telemetry.count_tenant_preemption(
                    self._preempt_tenant_label or "other", "shrink"
                )
            except Exception:
                pass
            group.remove_ranks(casualties)
            self._reform(resume_checkpoint, "shrink", trigger, from_size)
            return True
        # Casualty classification, in order of authority: ranks on drained
        # nodes, then actors the GCS reports DEAD (non-blocking, cannot
        # misclassify a slow-but-healthy rank mid-step).  Liveness pings
        # are only the FALLBACK for the window where a death raised
        # channel-side before the GCS heartbeat caught up — there the
        # dead actor fails its ping fast, and survivors get a generous
        # shared budget (elastic_ping_timeout_s) since a busy actor only
        # answers at its next report boundary.
        drained = {
            rank
            for rank in range(from_size)
            if rank < len(self._ranks_meta)
            and self._ranks_meta[rank]["node_id"] in self._drained_nodes
        }
        casualties = sorted(drained | set(group.dead_ranks_per_gcs()))
        if not casualties and trigger == "worker_death":
            alive = set(group.alive_ranks(
                timeout=float(CONFIG.elastic_ping_timeout_s)
            ))
            casualties = [r for r in range(from_size) if r not in alive]
        if not casualties:
            return False
        survivors = from_size - len(casualties)
        min_workers = self.scaling.min_workers or self.scaling.num_workers
        if survivors < min_workers:
            logger.warning(
                "elastic shrink refused: %d survivor(s) < min_workers=%d "
                "(falling back to whole-group restart)", survivors, min_workers,
            )
            return False
        group.remove_ranks(casualties)
        self._reform(resume_checkpoint, "shrink", trigger, from_size)
        return True

    def _update_grow_hint(self):
        """Tell the autoscaler how many worker shapes this (elastic)
        group still wants back; count 0 clears the hint.  Advisory:
        failures never affect the resize path."""
        if not self.elastic or self.worker_group is None:
            return
        want = self.scaling.num_workers - len(self.worker_group.workers)
        try:
            from ray_tpu_torch._private import telemetry
            from ray_tpu_torch._private.worker import get_global_worker

            get_global_worker().gcs_client.call(
                "train_grow_hint",
                {
                    "name": self.experiment_name,
                    "count": max(0, want),
                    "resources": self.scaling._worker_resources(),
                },
            )
            telemetry.count_grow_hint("publish" if want > 0 else "clear")
        except Exception:
            logger.debug("grow hint publish failed", exc_info=True)

    def try_grow(self, resume_checkpoint) -> bool:
        """Epoch-boundary grow: lease workers back toward num_workers.
        Each candidate must answer a ping within the lease timeout —
        capacity that did not actually return leaves the group unchanged
        (and backs off before the next attempt)."""
        from ray_tpu_torch._private.config import CONFIG

        if not self.grow_pending():
            return False
        group = self.worker_group
        from_size = len(group.workers)
        want = self.scaling.num_workers - from_size
        added = group.add_workers(
            want, ready_timeout=float(CONFIG.elastic_grow_lease_timeout_s)
        )
        if added == 0:
            # The ALIVE signal did not translate into grantable leases yet
            # (drain migration still occupying the node, resources not
            # registered).  KEEP the event set — a node's ALIVE
            # registration is a one-shot edge, so clearing here could
            # strand the group shrunken forever — but ESCALATE the retry
            # backoff: each attempt stalls the report loop for the lease
            # timeout, and a signal that never converts must not throttle
            # training forever (a fresh ALIVE resets the escalation).
            self._grow_failures += 1
            backoff = min(
                float(CONFIG.elastic_grow_backoff_s) * (2 ** self._grow_failures),
                300.0,
            )
            self._next_grow_attempt = time.monotonic() + backoff
            # Refresh the grow intent's TTL: the want is still unmet and
            # the autoscaler should keep a replacement warm.
            self._update_grow_hint()
            return False
        self._grow_failures = 0
        if len(group.workers) >= self.scaling.num_workers:
            self._capacity_event.clear()
        self._next_grow_attempt = (
            time.monotonic() + float(CONFIG.elastic_grow_backoff_s)
        )
        self._reform(resume_checkpoint, "grow", "capacity_return", from_size)
        return True

    def get_next_results(self, timeout: Optional[float] = None) -> Optional[List[dict]]:
        """One report round from every worker; None when all finished.
        Raises TrainingWorkerError if any worker's loop raised."""
        results = ray_tpu_torch.get(
            [w.next_report.remote(timeout) for w in self.worker_group.workers]
        )
        for rank, r in enumerate(results):
            if r["kind"] == "error":
                raise TrainingWorkerError(rank, r["traceback"])
        if all(r["kind"] == "finished" for r in results):
            return None
        return results

    def shutdown(self):
        # A finished/abandoned run must not pin replacement launches.
        if self.elastic and self.worker_group is not None:
            try:
                from ray_tpu_torch._private import telemetry
                from ray_tpu_torch._private.worker import get_global_worker

                get_global_worker().gcs_client.call(
                    "train_grow_hint",
                    {"name": self.experiment_name, "count": 0},
                )
                telemetry.count_grow_hint("clear")
            except Exception:
                pass
        if self._node_listener is not None:
            from ray_tpu_torch._private.worker import get_global_worker

            try:
                get_global_worker().remove_node_listener(self._node_listener)
            except Exception:
                pass
            self._node_listener = None
        if self._preempt_listener is not None:
            from ray_tpu_torch._private.worker import get_global_worker

            try:
                get_global_worker().remove_job_preempt_listener(
                    self._preempt_listener
                )
            except Exception:
                pass
            self._preempt_listener = None
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group, self.backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
