"""Memory monitor / OOM worker killing on the port (a copy of the JAX
package's tests/test_oom.py; it imports neither JAX nor the JAX package;
reference:
src/ray/common/memory_monitor.h:52, worker_killing_policy_group_by_owner.cc).

The clusters here set an explicit worker-memory budget
(memory_limit_bytes) so the tests are deterministic regardless of what
else runs on the host; production defaults to the MemAvailable policy.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster

LIMIT = 700 * 1024 * 1024  # headroom for ~4 idle workers (~60 MiB each)


@pytest.fixture()
def oom_cluster(monkeypatch):
    saved = os.environ.get("RAY_TPU_TORCH_memory_limit_bytes")
    os.environ["RAY_TPU_TORCH_memory_limit_bytes"] = str(LIMIT)
    os.environ["RAY_TPU_TORCH_memory_monitor_refresh_ms"] = "200"
    # The monitor is what these tests drill, so it stays on (its budget is
    # the per-node memory_limit_bytes above, not the whole machine's
    # MemAvailable); only the 2 GiB shm arena prefault is off, as in the
    # port's other test clusters.
    monkeypatch.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()
    if saved is None:
        os.environ.pop("RAY_TPU_TORCH_memory_limit_bytes", None)
    else:
        os.environ["RAY_TPU_TORCH_memory_limit_bytes"] = saved
    os.environ.pop("RAY_TPU_TORCH_memory_monitor_refresh_ms", None)


def test_oom_task_killed_and_error_names_culprit(oom_cluster):
    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        ballast = bytearray(1024 * 1024 * 1024)  # 1 GiB, way over budget
        for i in range(0, len(ballast), 4096):
            ballast[i] = 1  # touch every page so RSS actually grows
        time.sleep(30)
        return len(ballast)

    with pytest.raises(ray_tpu_torch.exceptions.OutOfMemoryError) as ei:
        ray_tpu_torch.get(hog.remote(), timeout=90)
    assert "hog" in str(ei.value)
    assert "MiB" in str(ei.value)


def test_oom_retries_then_fails(oom_cluster):
    """An OOM-killed task is retriable like a crashed worker; when every
    attempt OOMs, the final error is still OutOfMemoryError."""

    @ray_tpu_torch.remote(max_retries=1)
    def hog2():
        ballast = bytearray(1024 * 1024 * 1024)
        for i in range(0, len(ballast), 4096):
            ballast[i] = 1
        time.sleep(30)
        return 1

    with pytest.raises(ray_tpu_torch.exceptions.OutOfMemoryError):
        ray_tpu_torch.get(hog2.remote(), timeout=150)


def test_oom_survivors_unaffected(oom_cluster):
    """Killing the hog must leave well-behaved tasks running.

    Load-hardened: the victim policy kills the NEWEST working worker
    first (retriable new work before long-running old work), and with
    num_cpus=2 the polite worker is always newer than the hog — so
    while the hog holds its ballast, every 200 ms monitor tick lands on
    whichever polite worker is up, and one kill charges every inflight
    spec on that lease.  On a busy box the polite tasks overlap the
    whole kill window and any finite retry budget exhausts.  Survivor
    semantics here are *eventual completion*, not zero kills: give the
    polite tasks an unlimited retry budget, settle the hog's OOM death
    first (which releases the memory pressure), then condition-poll the
    survivors under a generous deadline."""

    @ray_tpu_torch.remote(max_retries=0)
    def hog3():
        ballast = bytearray(1024 * 1024 * 1024)
        for i in range(0, len(ballast), 4096):
            ballast[i] = 1
        time.sleep(30)
        return 1

    @ray_tpu_torch.remote(max_retries=-1)
    def polite(x):
        time.sleep(0.2)
        return x * 2

    bad = hog3.remote()
    good = [polite.remote(i) for i in range(8)]
    with pytest.raises(ray_tpu_torch.exceptions.OutOfMemoryError):
        ray_tpu_torch.get(bad, timeout=120)
    assert ray_tpu_torch.get(good, timeout=150) == [i * 2 for i in range(8)]
