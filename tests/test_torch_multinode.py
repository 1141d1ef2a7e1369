"""Multi-node behavior of the port on one machine via cluster_utils.Cluster
(a copy of the JAX package's tests/test_multinode.py; it imports neither
JAX nor the JAX package)
(reference test pattern: python/ray/tests/conftest.py ray_start_cluster)."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no 2 GiB shm arena
        # prefault per raylet, and no memory monitor, which watches the
        # whole machine.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
        c.add_node(num_cpus=2, resources={"special": 1})
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address)
        yield c
        ray_tpu_torch.shutdown()
        c.shutdown()


def test_two_nodes_visible(cluster):
    nodes = ray_tpu_torch.nodes()
    assert sum(1 for n in nodes if n["Alive"]) == 2
    assert ray_tpu_torch.cluster_resources()["CPU"] == 4.0


def test_task_spillback_to_remote_node(cluster):
    @ray_tpu_torch.remote(resources={"special": 0.1})
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    # "special" exists only on the worker node → must spill over.
    node_id = ray_tpu_torch.get(where.remote())
    head_id = ray_tpu_torch.get_runtime_context().get_node_id()
    assert node_id != head_id


def test_cross_node_object_transfer(cluster):
    @ray_tpu_torch.remote(resources={"special": 0.1})
    def produce():
        return np.arange(500_000, dtype=np.float64)  # 4MB, via shm store

    @ray_tpu_torch.remote
    def consume(arr):
        return float(arr.sum())

    ref = produce.remote()
    # Consume with no affinity: may pull across raylets.
    total = ray_tpu_torch.get(consume.remote(ref))
    assert total == float(np.arange(500_000, dtype=np.float64).sum())
    # Driver-side get also pulls to the head node store.
    arr = ray_tpu_torch.get(ref)
    assert arr.shape == (500_000,)


def test_spread_scheduling(cluster):
    @ray_tpu_torch.remote(num_cpus=1, scheduling_strategy="SPREAD")
    def where():
        time.sleep(0.3)
        return ray_tpu_torch.get_runtime_context().get_node_id()

    refs = [where.remote() for _ in range(4)]
    nodes = set(ray_tpu_torch.get(refs))
    assert len(nodes) >= 2, f"SPREAD used only {nodes}"


@pytest.mark.slow  # ~60 s node-death drill; drain/elastic smokes cover it
def test_actor_on_remote_node_and_node_death(cluster):
    node = cluster.add_node(num_cpus=1, resources={"doomed": 1})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(resources={"doomed": 1}, max_restarts=0)
    class Pinned:
        def ping(self):
            return "pong"

    a = Pinned.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"

    cluster.remove_node(node)
    # GCS health check marks the node dead; pending calls must fail.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get(a.ping.remote(), timeout=5)
        except ray_tpu_torch.exceptions.RayActorError:
            break
        except ray_tpu_torch.exceptions.GetTimeoutError:
            pass
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.5)
    else:
        pytest.fail("actor on dead node never reported as dead")


def test_lineage_reconstruction_simple(cluster):
    """An object whose only copy dies with its node is rebuilt by
    resubmitting the creating task (reference:
    core_worker/object_recovery_manager.h + task_manager.h:212)."""
    node = cluster.add_node(num_cpus=1, resources={"fragile": 1})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(resources={"fragile": 0.1}, max_retries=3)
    def produce():
        # Big enough to live in the shm store (not inline in the GCS).
        return np.full(200_000, 7.0)

    @ray_tpu_torch.remote(resources={"fragile": 0.1})
    def check(a):
        return float(a.sum())

    ref = produce.remote()
    # Consume on the SAME node so the only copy stays there (a driver get
    # would pull a surviving replica to the head node).
    assert ray_tpu_torch.get(check.remote(ref), timeout=60) == 7.0 * 200_000
    # Kill the node holding the only copy; a replacement node joins with
    # the same resources (the resubmitted task needs somewhere to run).
    cluster.remove_node(node)
    cluster.add_node(num_cpus=1, resources={"fragile": 1})
    cluster.wait_for_nodes()
    out = ray_tpu_torch.get(ref, timeout=120)
    assert float(out.sum()) == 7.0 * 200_000


def test_lineage_reconstruction_transitive(cluster):
    """Recovering an object whose creating task's ARGS are also lost
    recovers the whole chain."""
    node = cluster.add_node(num_cpus=2, resources={"fragile2": 2})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(resources={"fragile2": 0.1}, max_retries=3)
    def base():
        return np.ones(150_000)

    @ray_tpu_torch.remote(resources={"fragile2": 0.1}, max_retries=3)
    def double(a):
        return a * 2.0

    @ray_tpu_torch.remote(resources={"fragile2": 0.1})
    def check(x):
        return float(x.sum())

    a = base.remote()
    b = double.remote(a)
    # Consume on the fragile node: both a and b live only there.
    assert ray_tpu_torch.get(check.remote(b), timeout=60) == 2.0 * 150_000
    cluster.remove_node(node)
    cluster.add_node(num_cpus=2, resources={"fragile2": 2})
    cluster.wait_for_nodes()
    out = ray_tpu_torch.get(b, timeout=120)
    assert float(out.sum()) == 2.0 * 150_000


def test_put_object_lost_is_unrecoverable(cluster):
    """ray.put objects have no lineage: losing every copy raises
    ObjectLostError (matches the reference's semantics)."""
    node = cluster.add_node(num_cpus=1, resources={"fragile3": 1})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(resources={"fragile3": 0.1})
    def put_remote():
        return ray_tpu_torch.put(np.zeros(150_000))

    inner = ray_tpu_torch.get(put_remote.remote(), timeout=60)
    # The put lives only on the doomed node (driver never fetched it).
    cluster.remove_node(node)
    time.sleep(1.0)
    with pytest.raises(ray_tpu_torch.exceptions.ObjectLostError):
        ray_tpu_torch.get(inner, timeout=60)


def test_lineage_reconstruction_error_path(cluster):
    """A dependent task submitted AFTER its arg was lost stores an
    ObjectLostError-caused error; the owner's get unwraps it, rebuilds
    the chain, and resubmits the dependent task."""
    node = cluster.add_node(num_cpus=1, resources={"fragile4": 1})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(resources={"fragile4": 0.1}, max_retries=3)
    def produce():
        return np.full(150_000, 3.0)

    @ray_tpu_torch.remote(resources={"fragile4": 0.1})
    def touch(a):
        return float(a.sum())

    ref = produce.remote()
    assert ray_tpu_torch.get(touch.remote(ref), timeout=60) == 3.0 * 150_000
    cluster.remove_node(node)
    cluster.add_node(num_cpus=1, resources={"fragile4": 1})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(max_retries=3)
    def consume(a):
        return float(a.sum())

    # consume lands on a live node, discovers the arg is lost, and errors;
    # the driver's get triggers chain reconstruction and a resubmit.
    assert ray_tpu_torch.get(consume.remote(ref), timeout=120) == 3.0 * 150_000


@pytest.mark.slow  # ~17 s 1 GiB cross-node transfer: tier-2
def test_chunked_cross_node_transfer_1gib(cluster):
    """A >1GiB object crosses nodes in bounded-parallel 4MB chunks — no
    single whole-object frame, no event-loop stall (reference:
    push_manager.h:30)."""
    n = 1_100_000_000  # ~1.02 GiB, deliberately not chunk-aligned

    @ray_tpu_torch.remote(resources={"special": 0.1})
    def produce_big():
        a = np.zeros(n, dtype=np.uint8)
        a[0], a[-1], a[n // 2] = 7, 9, 5
        return a

    ref = produce_big.remote()
    # Driver get pulls the object from the worker node to the head store.
    out = ray_tpu_torch.get(ref, timeout=600)
    assert out.nbytes == n
    assert (int(out[0]), int(out[-1]), int(out[n // 2])) == (7, 9, 5)
    assert int(out.sum()) == 21
    del out, ref


def test_node_label_scheduling(cluster):
    """NODE_LABEL tasks run only on matching nodes; no match fails with a
    clear error (reference: NodeLabelSchedulingStrategy)."""
    from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy

    cluster.add_node(num_cpus=1, labels={"tier": "gold", "zone": "a"})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(
        scheduling_strategy=NodeLabelSchedulingStrategy(hard={"tier": "gold"})
    )
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    ran_on = {ray_tpu_torch.get(where.remote(), timeout=60) for _ in range(3)}
    gcs = ray_tpu_torch._private.worker.get_global_worker().gcs_client
    info = gcs.call("get_cluster_info")
    gold = {
        ray_tpu_torch.NodeID(n["node_id"]).hex()
        for n in info["nodes"].values()
        if n.get("labels", {}).get("tier") == "gold"
    }
    assert gold and ran_on <= gold, (ran_on, gold)

    @ray_tpu_torch.remote(
        scheduling_strategy=NodeLabelSchedulingStrategy(hard={"tier": "platinum"}),
        max_retries=0,
    )
    def nowhere():
        return 1

    with pytest.raises(ray_tpu_torch.exceptions.RaySystemError):
        ray_tpu_torch.get(nowhere.remote(), timeout=60)
