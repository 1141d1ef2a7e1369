"""WorkerGroup: N train-worker actors placed by a placement group
(reference: python/ray/train/_internal/worker_group.py)."""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._internal.session import _TrainSession


@ray_tpu_torch.remote
class RayTrainWorker:
    """One rank of the training job (reference: worker_group.py RayTrainWorker)."""

    def __init__(self):
        self._session: Optional[_TrainSession] = None

    # generic executor used by backends (torch's equivalent of
    # WorkerGroup.execute on the actor)
    def execute_fn(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    def node_ip_and_port(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        hostname = socket.gethostname()
        try:
            ip = socket.gethostbyname(hostname)
        except OSError:
            ip = "127.0.0.1"
        return ip, port

    def metadata(self):
        ctx = ray_tpu_torch.get_runtime_context()
        return {"node_id": ctx.get_node_id(), "pid": os.getpid()}

    def ping(self):
        """Liveness probe used by the elastic plane to partition a group
        into survivors and casualties after a failure."""
        return True

    def start_session(self, train_fn, session_kwargs: Dict[str, Any]):
        # Elastic resize restarts sessions on SURVIVING actors: retire the
        # old session first so a train-loop thread still blocked in it
        # unwinds at its next report instead of racing the new loop.
        if self._session is not None:
            self._session.shutdown()
        self._session = _TrainSession(train_fn, **session_kwargs)
        self._session.start()
        return True

    def next_report(self, timeout: Optional[float] = None):
        return self._session.next_report(timeout)

    def retire_session(self, join_timeout_s: float = 30.0):
        """Elastic resize: stop the current session and WAIT for its loop
        thread to unwind (bounded by one report interval) BEFORE the
        backend tears down and re-forms the collective runtime — yanking
        a torch.distributed group out from under a thread mid-collective is
        undefined behavior."""
        if self._session is not None:
            self._session.shutdown()
            t = self._session._thread
            if t is not None and t.is_alive():
                t.join(timeout=join_timeout_s)
        return True

    def notify_drain(self):
        """Drain notice covers this worker group: surface it to the user
        loop via train.get_context().drain_requested()."""
        if self._session is not None:
            self._session.request_drain_checkpoint()
        return True

    def shutdown_session(self):
        self._session = None
        return True


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_group=None):
        self.num_workers = num_workers
        self._pg = placement_group
        self._resources_per_worker = dict(resources_per_worker)
        self.workers = []
        for i in range(num_workers):
            self.workers.append(self._spawn(i))

    def _spawn(self, bundle_index: int):
        r = self._resources_per_worker
        cls = RayTrainWorker.options(
            num_cpus=r.get("CPU", 0),
            num_gpus=r.get("GPU"),
            resources={k: v for k, v in r.items() if k not in ("CPU", "GPU")},
            placement_group=self._pg,
            placement_group_bundle_index=bundle_index if self._pg else -1,
        )
        return cls.remote()

    # -- elastic membership ops -------------------------------------------
    def dead_ranks_per_gcs(self) -> List[int]:
        """Ranks whose actor the GCS authoritatively reports DEAD.
        Non-blocking (plain control-plane reads): the preferred casualty
        classifier — unlike a liveness ping, it can never misclassify a
        slow-but-healthy rank whose actor is busy in a long train step."""
        from ray_tpu_torch._private.worker import get_global_worker

        gcs = get_global_worker().gcs_client
        dead = []
        for rank, w in enumerate(self.workers):
            try:
                info = gcs.call("get_actor_info", w._actor_id.binary())
            except Exception:
                continue  # GCS hiccup: not evidence of death
            if info is None or info.get("state") == "DEAD":
                dead.append(rank)
        return dead

    def alive_ranks(self, timeout: float = 10.0) -> List[int]:
        """Ranks whose actor still answers a ping (partition survivors
        from casualties after a failure or drain).  `timeout` is ONE
        shared budget across the whole group, not per rank — pings run
        concurrently, so the total wait is bounded by the deadline."""
        import time

        alive = []
        deadline = time.monotonic() + timeout
        refs = [(rank, w.ping.remote()) for rank, w in enumerate(self.workers)]
        for rank, ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=max(0.1, deadline - time.monotonic()))
                alive.append(rank)
            except Exception:
                pass
        return alive

    def remove_ranks(self, ranks: List[int]):
        """Tear down ONLY the given ranks; survivors keep their actors
        (and their placement, warm imports, page cache).  Rank ids
        compact: the survivors are re-ranked 0..k-1 in prior order."""
        doomed = set(ranks)
        for rank in doomed:
            if 0 <= rank < len(self.workers):
                try:
                    ray_tpu_torch.kill(self.workers[rank])
                except Exception:
                    pass
        self.workers = [w for r, w in enumerate(self.workers) if r not in doomed]
        self.num_workers = len(self.workers)

    def add_workers(self, count: int, ready_timeout: float = 30.0) -> int:
        """Grow the group by up to `count` workers; each must answer a
        ping within the SHARED `ready_timeout` budget (i.e. a lease was
        actually granted — capacity really returned).  One deadline for
        the whole batch: this runs inline in the driver's report loop, so
        a partially-satisfiable grow must not stall training for
        count × timeout.  Workers that never come up are killed again.
        Returns how many were added."""
        import time

        deadline = time.monotonic() + ready_timeout
        candidates = [self._spawn(-1) for _ in range(count)]
        added = []
        for w in candidates:
            try:
                ray_tpu_torch.get(
                    w.ping.remote(), timeout=max(0.1, deadline - time.monotonic())
                )
                added.append(w)
            except Exception:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass
        self.workers.extend(added)
        self.num_workers = len(self.workers)
        return len(added)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker, return results ordered by rank."""
        return ray_tpu_torch.get([w.execute_fn.remote(fn, *args, **kwargs) for w in self.workers])

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self.workers[rank].execute_fn.remote(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute_fn.remote(fn, *args, **kwargs) for w in self.workers]

    def metadata(self) -> List[dict]:
        return ray_tpu_torch.get([w.metadata.remote() for w in self.workers])

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
