"""Multi-node cluster on one machine, for tests (reference:
python/ray/cluster_utils.py:135 Cluster — "the single most important
testing pattern to replicate", SURVEY.md §4): extra raylet processes join
the same GCS, each with its own object store and worker pool."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch._private import rpc


class Cluster:
    _prefault_guards = 0  # live Cluster instances holding the env guard
    _guard_owned = False  # whether the guard set the env var itself

    def __init__(self, initialize_head: bool = True, head_node_args: Optional[dict] = None):
        self.head = None
        self.workers: List = []  # (proc, raylet_address)
        self.gcs_address = None
        self.session_dir = None
        # Many raylets share this one machine: per-arena page
        # pre-population (a one-raylet-per-host production optimization)
        # would multiply resident memory by the node count and starve
        # the box's core during bring-up.  Guard is REFCOUNTED across
        # Cluster instances in this process and restored when the last
        # one shuts down, so a later init() isn't silently overridden
        # (env beats _system_config in CONFIG resolution).
        if Cluster._prefault_guards == 0:
            Cluster._guard_owned = "RAY_TPU_TORCH_arena_prefault_bytes" not in os.environ
            os.environ.setdefault("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        Cluster._prefault_guards += 1
        self._guard_released = False
        if initialize_head:
            self.add_head(**(head_node_args or {}))

    def add_head(self, **kwargs):
        assert self.head is None, "head already started"
        self.head = node_mod.start_head(**kwargs)
        self.gcs_address = self.head.gcs_address
        self.session_dir = self.head.session_dir
        return self.head

    @property
    def address(self) -> str:
        return self.gcs_address

    def add_node(self, num_cpus=None, num_gpus=None, resources=None, memory=None,
                 labels=None, wait: bool = True):
        assert self.gcs_address, "no head node"
        proc, raylet_address = node_mod.start_worker_node(
            self.gcs_address,
            self.session_dir,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            memory=memory,
            labels=labels,
            wait=wait,
        )
        handle = _NodeHandle(proc, raylet_address)
        self.workers.append(handle)
        return handle

    def remove_node(self, handle: "_NodeHandle", allow_graceful: bool = False):
        """Kill a node's raylet — the cluster-level chaos hook."""
        if handle.proc.poll() is None:
            if allow_graceful:
                handle.proc.terminate()
            else:
                handle.proc.kill()
            try:
                handle.proc.wait(timeout=10)
            except Exception:
                pass
        if handle in self.workers:
            self.workers.remove(handle)

    def wait_for_nodes(self, timeout: float = 30.0) -> int:
        """Wait until every started node is ALIVE in the GCS."""
        from ray_tpu_torch._private import retry

        expected = 1 + len(self.workers)
        alive = 0
        bo = retry.POLL.start(deadline_s=timeout)
        while True:
            client = rpc.RpcClient(self.gcs_address)
            try:
                info = client.call("get_cluster_info")
                alive = sum(1 for n in info["nodes"].values() if n["state"] == "ALIVE")
                if alive >= expected:
                    return alive
            finally:
                client.close()
            delay = bo.next_delay()
            if delay is None:
                raise TimeoutError(
                    f"only {alive} of {expected} nodes alive after {timeout}s"
                )
            time.sleep(delay)

    def shutdown(self):
        for handle in list(self.workers):
            self.remove_node(handle, allow_graceful=True)
        if self.head is not None:
            self.head.terminate()
            self.head = None
        if not getattr(self, "_guard_released", True):
            self._guard_released = True
            Cluster._prefault_guards -= 1
            if Cluster._prefault_guards == 0 and Cluster._guard_owned:
                os.environ.pop("RAY_TPU_TORCH_arena_prefault_bytes", None)
                Cluster._guard_owned = False


class _NodeHandle:
    def __init__(self, proc, raylet_address: str):
        self.proc = proc
        self.raylet_address = raylet_address
