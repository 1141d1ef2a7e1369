"""Chaos tests on the port (a copy of the JAX package's
tests/test_chaos.py; it imports neither JAX nor the JAX package): the
deterministic fault-injection plane (chaos.py) plus
the legacy testing_rpc_failure drop hook (reference:
src/ray/rpc/rpc_chaos.h:23 + RayletKiller in
python/ray/_private/test_utils.py:1496).

Three layers of drills:

1. Determinism: the same seed + spec replays the identical fault
   schedule, asserted both on the plane directly and through a real
   RpcServer dispatch.
2. Chaos matrix (``-m chaos``): drop x delay x dup against the
   submit / lease / get paths on a live cluster — everything must still
   complete, with no hangs.
3. Idempotency: duplicated submit/exec deliveries must not run a task
   twice (the at-least-once discipline of docs/failure_semantics.md).

Fault specs are configured through RAY_TPU_TORCH_testing_chaos_spec /
RAY_TPU_TORCH_testing_rpc_failure env vars, which every spawned cluster
process inherits; rpc_call_timeout_s is lowered so dropped calls fail
fast instead of waiting out the 120 s default.
"""

import os
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster

_CLUSTER_SETTINGS = {
    "RAY_TPU_TORCH_arena_prefault_bytes": "0",
    "RAY_TPU_TORCH_memory_monitor_enabled": "0",
}


@pytest.fixture()
def chaos_cluster(request):
    """Per-test cluster factory: set chaos env vars BEFORE processes
    spawn, clean them up after.  Every process of the cluster runs
    without the 2 GiB shm arena prefault and without the memory monitor:
    the suite runs many clusters at once, and the monitor watches the
    whole machine."""
    created = []
    saved = {}
    for k, v in _CLUSTER_SETTINGS.items():
        saved.setdefault(k, os.environ.get(k))
        os.environ[k] = v

    def make(env: dict, head_args=None, nodes=()):
        for k, v in env.items():
            saved.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        c = Cluster(
            initialize_head=True, head_node_args=head_args or {"num_cpus": 2}
        )
        handles = [c.add_node(**kw) for kw in nodes]
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address)
        created.append(c)
        return c, handles

    yield make
    ray_tpu_torch.shutdown()
    for c in created:
        c.shutdown()
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old


def test_location_report_dropped(chaos_cluster):
    """The raylet's object_location_add push to the GCS is dropped once;
    the bounded retry must land it so a cross-node get still works."""
    _, _ = chaos_cluster(
        {"RAY_TPU_TORCH_testing_rpc_failure": "object_location_add:req:1"},
        nodes=[{"num_cpus": 1, "resources": {"side": 1}}],
    )

    @ray_tpu_torch.remote(resources={"side": 0.1})
    def make():
        return ray_tpu_torch.put(np.arange(200_000))

    inner = ray_tpu_torch.get(make.remote(), timeout=60)
    # Fetch the put object across nodes: requires the (retried) location.
    arr = ray_tpu_torch.get(inner, timeout=90)
    assert int(arr.sum()) == 19999900000


def test_lost_check_dropped_during_recovery(chaos_cluster):
    """Lineage reconstruction still happens when the GCS drops the first
    object_lost_check probes — the pull loop keeps asking."""
    c, [node] = chaos_cluster(
        {"RAY_TPU_TORCH_testing_rpc_failure": "object_lost_check:req:2"},
        nodes=[{"num_cpus": 1, "resources": {"doomed": 1}}],
    )

    @ray_tpu_torch.remote(resources={"doomed": 0.1}, max_retries=3)
    def produce():
        return np.full(150_000, 7.0)

    ref = produce.remote()
    assert ray_tpu_torch.get(ref, timeout=60).sum() == 7.0 * 150_000
    c.remove_node(node)
    c.add_node(num_cpus=1, resources={"doomed": 1})
    c.wait_for_nodes()
    # Every copy died with the node; the owner must resubmit produce()
    # even though the first lost-checks are eaten.
    assert ray_tpu_torch.get(ref, timeout=120).sum() == 7.0 * 150_000


def test_pg_prepare_reply_dropped(chaos_cluster):
    """2-phase PG creation: a dropped prepare reply looks like a failed
    node; the GCS must roll back and retry until the group commits."""
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_rpc_failure": "prepare_bundle:rep:1",
            "RAY_TPU_TORCH_rpc_call_timeout_s": "6",
        },
        head_args={"num_cpus": 4},
    )
    from ray_tpu_torch.util.placement_group import placement_group

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=90)
    assert len(pg.bundle_specs) == 2


def test_pg_commit_reply_dropped(chaos_cluster):
    """A dropped commit reply must not wedge the group in PENDING: the
    GCS rolls the bundles back and reschedules."""
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_rpc_failure": "commit_bundle:rep:1",
            "RAY_TPU_TORCH_rpc_call_timeout_s": "6",
        },
        head_args={"num_cpus": 4},
    )
    from ray_tpu_torch.util.placement_group import placement_group

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=90)

    # The committed group is actually usable.
    @ray_tpu_torch.remote(num_cpus=1)
    def inside():
        return "ok"

    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    ref = inside.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(placement_group=pg)
    ).remote()
    assert ray_tpu_torch.get(ref, timeout=60) == "ok"


def test_worker_lease_reply_dropped(chaos_cluster):
    """Direct task submission: a dropped lease grant strands a LEASED
    worker on the raylet side and returns None to the submitter — the
    submitter's reaper must re-request and tasks still complete."""
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_rpc_failure": "request_worker_lease:rep:1",
            "RAY_TPU_TORCH_worker_lease_timeout_ms": "6000",
        }
    )

    @ray_tpu_torch.remote
    def f(i):
        return i * 2

    out = ray_tpu_torch.get([f.remote(i) for i in range(20)], timeout=120)
    assert out == [i * 2 for i in range(20)]


def test_register_worker_reply_dropped(chaos_cluster):
    """A worker whose registration reply is eaten dies; the pool must
    spawn a replacement and tasks still run."""
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_rpc_failure": "register_worker:rep:1",
            "RAY_TPU_TORCH_rpc_call_timeout_s": "6",
        }
    )

    @ray_tpu_torch.remote
    def f():
        return os.getpid()

    assert ray_tpu_torch.get(f.remote(), timeout=90) > 0


def test_raylet_killer_tasks_retry(chaos_cluster):
    """Kill a node's raylet (SIGKILL) while its tasks are in flight;
    retriable tasks reschedule onto the surviving node."""
    c, [node] = chaos_cluster(
        {},
        head_args={"num_cpus": 2},
        nodes=[{"num_cpus": 2}],
    )

    @ray_tpu_torch.remote(max_retries=5)
    def slow(i):
        time.sleep(0.4)
        return i

    refs = [slow.remote(i) for i in range(16)]
    time.sleep(1.0)  # let tasks spread to both nodes
    c.remove_node(node)  # SIGKILL mid-flight
    out = ray_tpu_torch.get(refs, timeout=180)
    assert out == list(range(16))


# ==========================================================================
# Determinism drills: the same seed + spec must replay the identical
# fault schedule (logged and asserted).
# ==========================================================================

_DET_ENV = ("RAY_TPU_TORCH_testing_chaos_spec", "RAY_TPU_TORCH_testing_chaos_seed")


@pytest.fixture()
def chaos_env():
    """Set chaos env vars for in-process plane/RPC drills; restore after."""
    saved = {k: os.environ.get(k) for k in _DET_ENV}

    def set_env(spec: str, seed: str):
        os.environ["RAY_TPU_TORCH_testing_chaos_spec"] = spec
        os.environ["RAY_TPU_TORCH_testing_chaos_seed"] = seed

    yield set_env
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()


def test_chaos_schedule_deterministic(chaos_env):
    """Plane level: per-rule RNG streams + match counters make the fault
    schedule a pure function of (seed, spec, match ordinals)."""
    from ray_tpu_torch._private.chaos import ChaosPlane

    chaos_env(
        "submit_task:dup_req:n=2,store_get:delay_req:ms=10:p=0.4:n=-1,"
        "request_worker_lease:drop_rep:p=0.5:n=-1,@worker.exec:kill:at=4",
        "1234",
    )

    def drive(plane):
        decisions = []
        for i in range(40):
            decisions.append(plane.decide("submit_task", "req"))
            decisions.append(plane.decide("store_get", "req"))
            decisions.append(plane.decide("request_worker_lease", "rep"))
            decisions.append(plane.maybe_kill("worker.exec"))
        return decisions, plane.schedule_snapshot(), plane.schedule_digest()

    d1, s1, h1 = drive(ChaosPlane())
    d2, s2, h2 = drive(ChaosPlane())
    assert d1 == d2
    assert s1 == s2 and h1 == h2
    assert any(e.endswith(":fire") for e in s1), "no fault ever fired"
    assert sum(1 for e in s1 if e.endswith(":kill")) == 1  # at=4 fires once

    # A different seed diverges on the probabilistic rules.
    chaos_env(os.environ["RAY_TPU_TORCH_testing_chaos_spec"], "99")
    _d3, s3, _h3 = drive(ChaosPlane())
    assert s3 != s1


def _rpc_trace(n: int = 14):
    """Drive a fixed call trace through a REAL RpcServer dispatch with
    the process-global plane; returns (outcomes, handler executions,
    schedule snapshot)."""
    import asyncio

    from ray_tpu_torch._private import rpc as rpc_mod
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()

    class Handler:
        def __init__(self):
            self.executions = 0

        async def rpc_ping(self, payload, conn):
            self.executions += 1
            return payload * 2

    handler = Handler()
    sock = os.path.join(tempfile.mkdtemp(prefix="chaos_rpc_"), "s.sock")

    async def main():
        loop = asyncio.get_event_loop()
        server = rpc_mod.RpcServer(handler, f"unix:{sock}", loop)
        await server.start()
        client = await rpc_mod.AsyncRpcClient(f"unix:{sock}").connect()
        outcomes = []
        for i in range(n):
            try:
                outcomes.append(await client.call("ping", i, timeout=0.3))
            except rpc_mod.RpcError:
                outcomes.append("lost")
        await asyncio.sleep(0.1)  # let duplicated handlers settle
        client.close()
        await server.stop()
        return outcomes

    outcomes = asyncio.run(main())
    schedule = CHAOS.schedule_snapshot()
    return outcomes, handler.executions, schedule


def test_chaos_rpc_dispatch_deterministic(chaos_env):
    """End to end through rpc.RpcServer: same seed -> identical observable
    outcomes (which calls lost their reply, how many duplicate handler
    runs) AND identical logged schedule."""
    chaos_env("ping:drop_rep:p=0.4:n=-1,ping:dup_req:p=0.3:n=-1", "31")
    o1, x1, s1 = _rpc_trace()
    o2, x2, s2 = _rpc_trace()
    assert o1 == o2
    assert x1 == x2
    assert s1 == s2
    assert "lost" in o1, "drop_rep never fired"
    assert x1 > 14, "dup_req never duplicated a handler run"


# ==========================================================================
# Chaos matrix: drop x delay x dup against the submit/lease/get paths.
# Acceptance: all drills complete, no hangs.
# ==========================================================================

_MATRIX = {
    "drop": (
        "submit_task:drop_req:n=2,request_worker_lease:drop_rep:n=1,"
        "store_get:drop_req:n=2"
    ),
    "delay": (
        "submit_task:delay_req:ms=150:p=0.5:n=-1,"
        "request_worker_lease:delay_rep:ms=250:n=4,"
        "store_get:delay_req:ms=100:p=0.5:n=-1"
    ),
    "dup": (
        "submit_task:dup_req:n=3,request_worker_lease:dup_req:n=2,"
        "store_get:dup_req:n=6,exec_direct:dup_req:n=3"
    ),
    "drop+delay+dup": (
        "submit_task:dup_req:n=2,request_worker_lease:drop_rep:n=1,"
        "store_get:delay_req:ms=100:p=0.5:n=-1,exec_direct:dup_req:n=2,"
        "store_get:drop_req:n=1"
    ),
    "worker-kill": "@worker.exec:kill:at=2",
}


@pytest.mark.chaos
@pytest.mark.parametrize("axis", list(_MATRIX))
def test_chaos_matrix_progress(chaos_cluster, axis):
    """With faults active on submit/lease/get, tasks and puts/gets still
    complete inside their timeouts — retries + idempotency absorb every
    axis without double-running or hanging."""
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": _MATRIX[axis],
            "RAY_TPU_TORCH_testing_chaos_seed": "1234",
            "RAY_TPU_TORCH_rpc_call_timeout_s": "6",
            "RAY_TPU_TORCH_worker_lease_timeout_ms": "8000",
        }
    )

    @ray_tpu_torch.remote(max_retries=5)
    def f(i):
        return i * 3

    # Condition-poll instead of one wall-clock gather: under load a
    # worker-kill axis pays worker respawn + re-lease on top of the
    # chaos delays, so assert *progress* against a generous deadline
    # and only fail when completion genuinely stalls.
    refs = [f.remote(i) for i in range(12)]
    deadline = time.monotonic() + 300
    pending = list(refs)
    while pending and time.monotonic() < deadline:
        done, pending = ray_tpu_torch.wait(
            pending, num_returns=len(pending), timeout=5
        )
    assert not pending, f"{len(pending)} tasks still pending at deadline"
    out = ray_tpu_torch.get(refs, timeout=60)
    assert out == [i * 3 for i in range(12)]
    ref = ray_tpu_torch.put(np.arange(120_000))
    assert int(ray_tpu_torch.get(ref, timeout=120).sum()) == 7199940000


@pytest.mark.chaos
def test_chaos_matrix_raylet_mediated(chaos_cluster):
    """The same fault axes against the raylet-mediated submit path
    (direct submission off), exercising submit_task end to end."""
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": (
                "submit_task:drop_rep:n=2,submit_task:dup_req:n=2,"
                "store_get:delay_req:ms=100:p=0.5:n=-1"
            ),
            "RAY_TPU_TORCH_testing_chaos_seed": "7",
            "RAY_TPU_TORCH_direct_task_submission": "0",
            "RAY_TPU_TORCH_rpc_call_timeout_s": "6",
        }
    )

    @ray_tpu_torch.remote
    def g(i):
        return i + 100

    assert ray_tpu_torch.get([g.remote(i) for i in range(8)], timeout=120) == [
        i + 100 for i in range(8)
    ]


# ==========================================================================
# Idempotency: a replayed/duplicated submission must not run a task twice.
# ==========================================================================


def _count_lines(path: str) -> int:
    with open(path) as f:
        return len(f.readlines())


@pytest.mark.chaos
def test_duplicate_submit_does_not_double_execute(chaos_cluster, tmp_path):
    """Raylet path: every submit_task delivery is duplicated, and every
    reply is eaten once (forcing a client-side retry on top) — yet each
    task's side effect happens exactly once."""
    marker = str(tmp_path / "ran.log")
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": (
                "submit_task:dup_req:n=-1,submit_task:drop_rep:n=1"
            ),
            "RAY_TPU_TORCH_testing_chaos_seed": "5",
            "RAY_TPU_TORCH_direct_task_submission": "0",
            "RAY_TPU_TORCH_rpc_call_timeout_s": "5",
        }
    )

    @ray_tpu_torch.remote
    def effect(i):
        with open(marker, "a") as f:
            f.write(f"{i}\n")
        return i

    out = ray_tpu_torch.get([effect.remote(i) for i in range(6)], timeout=120)
    assert sorted(out) == list(range(6))
    assert _count_lines(marker) == 6, "a duplicated submit re-ran a task"


@pytest.mark.chaos
def test_duplicate_exec_direct_does_not_double_execute(chaos_cluster, tmp_path):
    """Direct path: every exec_direct push is delivered twice; the leased
    worker's admission dedupe drops the replays."""
    marker = str(tmp_path / "ran_direct.log")
    chaos_cluster(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": "exec_direct:dup_req:n=-1",
            "RAY_TPU_TORCH_testing_chaos_seed": "5",
        }
    )

    @ray_tpu_torch.remote
    def effect(i):
        with open(marker, "a") as f:
            f.write(f"{i}\n")
        return i

    out = ray_tpu_torch.get([effect.remote(i) for i in range(6)], timeout=90)
    assert sorted(out) == list(range(6))
    assert _count_lines(marker) == 6, "a duplicated exec_direct re-ran a task"
