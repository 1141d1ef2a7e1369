"""The port's profiling plane on a live cluster: orchestrated captures of
actors through util.state.profile (attach / dump / merge / export), the
GCS profile table, the lifecycle edges (foreign session, dies
mid-capture, raylet kill), the <5% attached-overhead guard and the
compiled DAG's dataplane counters (copies of the cluster tests of
tests/test_profiling.py; the ones that need no cluster are in
tests/test_torch_observability_local.py; no JAX.  Reference: `ray
timeline` + py-spy attach workflows)."""

import json
import os
import signal
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state


@pytest.fixture(scope="module")
def cluster():
    """Module-scoped local cluster of the port (the conftest's fixtures
    start the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault per
        # raylet, and no memory monitor (it watches the whole machine).
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ctx = ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ctx
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Burner:
    """CPU-bound workload whose frames the profiler must attribute."""

    def burn_workload(self, seconds: float) -> int:
        deadline = time.monotonic() + seconds
        acc = 0
        while time.monotonic() < deadline:
            acc += sum(i * i for i in range(500))
        return acc

    def timed_burn(self, iters: int) -> float:
        t0 = time.perf_counter()
        acc = 0
        for _ in range(iters):
            acc += sum(i * i for i in range(2000))
        return time.perf_counter() - t0

    def getpid(self) -> int:
        return os.getpid()


def test_profile_live_actor_attributes_workload(cluster):
    """util.state.profile() on a live actor under load: the merged
    profile's top frames attribute >=80% of samples to the actor's
    actual workload, exported as both collapsed-stack and speedscope."""
    actor = Burner.remote()
    ray_tpu_torch.get(actor.burn_workload.remote(0.01), timeout=60)  # actor up
    ref = actor.burn_workload.remote(8.0)

    result = state.profile(actor, duration_s=2.0, mode="cpu")
    assert result.errors == []
    assert result.total_samples > 0
    attribution = result.attribution("burn_workload")
    assert attribution >= 0.8, (
        f"only {attribution:.0%} of samples in the workload; "
        f"top: {result.top_frames(8)}"
    )
    collapsed = result.collapsed()
    assert collapsed.startswith("actor:") and "burn_workload" in collapsed
    ss = result.speedscope()
    assert ss["profiles"] and ss["profiles"][0]["samples"]
    json.dumps(ss)
    ray_tpu_torch.get(ref, timeout=60)


def test_profile_ships_record_to_gcs_table(cluster):
    """End-of-capture records land in the GCS profile table
    (state.profiles) via the report channel — capture outlives driver."""
    actor = Burner.remote()
    ray_tpu_torch.get(actor.burn_workload.remote(0.01), timeout=60)
    ref = actor.burn_workload.remote(3.0)
    result = state.profile(actor, duration_s=1.0)
    assert result.profiles, result.errors
    sid = result.profiles[0]["session_id"]
    deadline = time.monotonic() + 15
    shipped = []
    while time.monotonic() < deadline and not shipped:
        shipped = state.profiles(session_id=sid)
        # graftlint: disable=retry-gate -- deadline-bounded assertion poll; 0.3 s is the scan resolution, not a retry delay
        time.sleep(0.3)
    assert shipped and shipped[0]["session_id"] == sid
    ray_tpu_torch.get(ref, timeout=60)


@pytest.mark.slow  # ~38 s kill drill: runs under `-m chaos`
@pytest.mark.chaos
def test_profiled_worker_dies_mid_capture_partial_no_leak(cluster):
    """SIGKILL the profiled worker mid-capture: the orchestration
    returns a partial result with an errors entry (no exception), and
    the next capture works — nothing leaks client-side."""
    victim = Burner.remote()
    pid = ray_tpu_torch.get(victim.getpid.remote(), timeout=60)
    victim.burn_workload.remote(20.0)

    from ray_tpu_torch.util import profiling as up

    gcs_call = state._gcs().call
    targets = up.resolve_targets(victim, gcs_call)

    killer = threading.Timer(1.0, lambda: os.kill(pid, signal.SIGKILL))
    killer.start()
    result = up.run_profile(
        targets, gcs_call, state._node_call, duration_s=3.0
    )
    killer.join()
    # The dump hit a dead socket: an errors entry, not an exception
    # (unless the end-of-capture ship beat the kill, which yields a
    # recovered record instead).
    assert result.errors or result.profiles

    # The plane still works for a fresh target afterwards.
    survivor = Burner.remote()
    ray_tpu_torch.get(survivor.burn_workload.remote(0.01), timeout=60)
    ref = survivor.burn_workload.remote(4.0)
    again = state.profile(survivor, duration_s=1.0)
    assert again.profiles and again.total_samples > 0
    ray_tpu_torch.get(ref, timeout=60)


def test_profiler_overhead_budget(cluster):
    """An actor workload with the profiler attached at the default Hz
    must run <5% slower than detached.  Wall-clock comparisons on the
    shared CI box swing with host load, so each condition takes the
    MINIMUM of several runs (the classic noise floor estimator) and the
    workload is timed inside the actor process."""
    actor = Burner.remote()
    iters = 150
    ray_tpu_torch.get(actor.timed_burn.remote(iters), timeout=60)  # warm

    def best_of(n):
        return min(
            ray_tpu_torch.get(actor.timed_burn.remote(iters), timeout=60) for _ in range(n)
        )

    base = best_of(4)
    # Attach at the default Hz for the whole measured window.
    info = state._gcs().call("get_actor_info", actor._actor_id.binary())
    start = state._node_call(
        info["worker_address"], "profile_start",
        {"duration_s": 60.0, "label": "overhead"},
    )
    try:
        attached = best_of(4)
    finally:
        state._node_call(
            info["worker_address"], "profile_dump",
            {"session_id": start["session_id"], "stop": True},
        )
    overhead = (attached - base) / base
    assert overhead < 0.05, (
        f"attached profiler overhead {overhead:.1%} >= 5% "
        f"(base {base * 1e3:.1f}ms, attached {attached * 1e3:.1f}ms)"
    )


def test_compiled_dag_stats_expose_dataplane(cluster):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, x):
            return x * 2

    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        node = Doubler.bind().double.bind(inp)
    dag = node.experimental_compile()
    try:
        for i in range(5):
            assert ray_tpu_torch.get(dag.execute(i)) == i * 2
        s = dag.stats()
        assert s["compiled"] is True
        assert s["executions"] == 5 and s["inflight"] == 0
        assert s["input_channels"][0]["writes"] == 5
        assert s["output_channels"][0]["reads"] == 5
    finally:
        dag.teardown()


def test_profile_foreign_session_is_error_not_shared(cluster):
    """A conflict with a session some OTHER operator started must
    surface as an error (the target's samples are missing from this
    result), not as a benign co-hosted 'shared' note."""
    actor = Burner.remote()
    ray_tpu_torch.get(actor.burn_workload.remote(0.01), timeout=60)
    info = state._gcs().call("get_actor_info", actor._actor_id.binary())
    foreign = state._node_call(
        info["worker_address"], "profile_start",
        {"duration_s": 30.0, "label": "operator-A"},
    )
    try:
        result = state.profile(actor, duration_s=0.5)
        assert result.shared == []
        assert result.errors and "busy" in result.errors[0]["error"]
        assert foreign["session_id"] in result.errors[0]["error"]
    finally:
        state._node_call(
            info["worker_address"], "profile_stop",
            {"session_id": foreign["session_id"]},
        )


@pytest.mark.slow  # ~39 s raylet-kill drill: runs under `-m chaos`
@pytest.mark.chaos
def test_profile_worker_through_raylet_kill():
    """SIGKILL the raylet of the node hosting the profiled actor while
    a capture is running.  The worker's direct RPC endpoint is
    independent of the raylet, so the attach either rides out the kill
    (dump succeeds with workload samples) or degrades to the partial
    path (errors entry) — never an exception, and the plane stays
    usable on the surviving node."""
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()  # the module fixture's single-node session
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    node = c.add_node(num_cpus=1, resources={"side": 1})
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)
    try:
        @ray_tpu_torch.remote(resources={"side": 0.5})
        class SideBurner:
            def burn_workload(self, seconds):
                deadline = time.monotonic() + seconds
                acc = 0
                while time.monotonic() < deadline:
                    acc += sum(i * i for i in range(500))
                return acc

        actor = SideBurner.remote()
        ray_tpu_torch.get(actor.burn_workload.remote(0.01), timeout=60)
        actor.burn_workload.remote(20.0)

        from ray_tpu_torch.util import profiling as up

        gcs_call = state._gcs().call
        targets = up.resolve_targets(actor, gcs_call)
        killer = threading.Timer(0.8, lambda: c.remove_node(node))
        killer.start()
        result = up.run_profile(
            targets, gcs_call, state._node_call, duration_s=2.5
        )
        killer.join()
        assert result.profiles or result.errors
        if result.profiles:
            # The worker outlived its raylet: samples attribute to the
            # workload as usual.
            assert result.total_samples > 0
            assert "burn_workload" in result.collapsed()

        # Plane still works on the head node afterwards.
        head_actor = Burner.remote()
        ray_tpu_torch.get(head_actor.burn_workload.remote(0.01), timeout=60)
        ref = head_actor.burn_workload.remote(4.0)
        again = state.profile(head_actor, duration_s=1.0)
        assert again.profiles and again.total_samples > 0
        ray_tpu_torch.get(ref, timeout=60)
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()

