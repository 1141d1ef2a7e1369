"""The port's autoscaler v2: the instance state machine, declarative
constraints, the node updater and the GPU-slice provider (copies of the 8
tests of ``tests/test_autoscaler_v2.py``; its two TPU-slice provider tests
drive the GPU-slice provider, ``h100-32`` (8 cards x 4 hosts) where they
use ``v5litepod-16`` and ``h100-1`` where they use ``v5litepod-4``).

Reference: python/ray/autoscaler/v2/.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import retry
from ray_tpu_torch._private.worker import get_global_worker
from ray_tpu_torch.autoscaler.node_provider import FakeMultiNodeProvider, NodeProvider
from ray_tpu_torch.autoscaler.v2 import AutoscalerV2, Instance, InstanceManager
from ray_tpu_torch.autoscaler.v2.sdk import request_cluster_resources


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port with the 4 CPUs the
    reference's fixture gives (the conftest's fixture of this name starts
    the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # many clusters share the machine under xdist: no 2 GiB arena
        # prefault, and no memory monitor killing this test's workers for
        # the others' memory (the fake nodes' raylets inherit both)
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, num_gpus=0, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed: ``for _ in _poll(30): ...``."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


class _MockProvider(NodeProvider):
    """In-memory provider for state-machine unit tests."""

    def __init__(self, fail_first: int = 0):
        self.nodes = {}
        self.counter = 0
        self.fail_first = fail_first

    def non_terminated_nodes(self, tag_filters):
        return list(self.nodes)

    def create_node(self, node_config, tags, count):
        if self.fail_first > 0:
            self.fail_first -= 1
            raise RuntimeError("cloud says no")
        out = []
        for _ in range(count):
            self.counter += 1
            nid = f"cloud-{self.counter}"
            self.nodes[nid] = dict(tags)
            out.append(nid)
        return out

    def terminate_node(self, node_id):
        self.nodes.pop(node_id, None)

    def is_running(self, node_id):
        return node_id in self.nodes

    def raylet_address(self, node_id):
        return f"unix:/fake/{node_id}"


def test_instance_lifecycle_happy_path():
    p = _MockProvider()
    im = InstanceManager(p, {"w": {"resources": {"CPU": 2}}})
    (iid,) = im.queue_launch("w")
    im.reconcile({})
    inst = im.instances[iid]
    assert inst.status == "ALLOCATED"
    cloud = inst.cloud_instance_id
    # Ray comes up on the node -> RAY_RUNNING
    im.reconcile({cloud: {"state": "ALIVE"}})
    assert inst.status == "RAY_RUNNING"
    # Ray node dies -> RAY_STOPPED -> TERMINATING -> TERMINATED + provider terminate
    im.reconcile({cloud: {"state": "DEAD"}})
    assert inst.status == "TERMINATED"
    assert cloud not in p.nodes
    # Audit trail recorded every hop.
    assert [s for s, _ in inst.history] == [
        "QUEUED", "REQUESTED", "ALLOCATED", "RAY_RUNNING",
        "RAY_STOPPED", "TERMINATING", "TERMINATED",
    ]


def test_instance_launch_retries_then_fails():
    p = _MockProvider(fail_first=5)
    im = InstanceManager(p, {"w": {"resources": {"CPU": 2}}}, max_launch_retries=3)
    (iid,) = im.queue_launch("w")
    for _ in range(5):
        im.reconcile({})
    assert im.instances[iid].status == "ALLOCATION_FAILED"
    assert im.instances[iid].launch_attempts == 3


def test_illegal_transition_rejected():
    inst = Instance("i-1", "w")
    with pytest.raises(ValueError):
        inst.transition("RAY_RUNNING")  # QUEUED cannot jump to RAY_RUNNING


def test_v2_scales_up_for_tasks(ray_cluster):
    worker = get_global_worker()
    provider = FakeMultiNodeProvider(
        {
            "gcs_address": worker.gcs_client.address,
            "session_dir": worker.session_info.get("session_dir"),
        }
    )
    scaler = AutoscalerV2(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=2,
        idle_timeout_s=9999,
        gcs_client=worker.gcs_client,
    )
    try:

        @ray_tpu_torch.remote(num_cpus=2)
        class Chunk:
            def ping(self):
                return "ok"

        actors = [Chunk.remote() for _ in range(3)]
        refs = [a.ping.remote() for a in actors]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            scaler.update()
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=1)
            if len(ready) == len(refs):
                break
        assert ray_tpu_torch.get(refs, timeout=30) == ["ok"] * 3
        # The instance state machine is eventually consistent: the tasks
        # can finish inside the same tick that launched the node, before
        # a later update() observes the registration and flips
        # ALLOCATED -> RAY_RUNNING.  Keep reconciling until it converges.
        for _ in _poll(max(0.0, deadline - time.monotonic())):
            if scaler.status()["counts"].get("RAY_RUNNING", 0) >= 1:
                break
            scaler.update()
        counts = scaler.status()["counts"]
        assert counts.get("RAY_RUNNING", 0) >= 1, counts
        for a in actors:
            ray_tpu_torch.kill(a)
    finally:
        for nid in provider.non_terminated_nodes({}):
            provider.terminate_node(nid)


def test_v2_declarative_constraint_launches_without_demand(ray_cluster):
    worker = get_global_worker()
    provider = FakeMultiNodeProvider(
        {
            "gcs_address": worker.gcs_client.address,
            "session_dir": worker.session_info.get("session_dir"),
        }
    )
    scaler = AutoscalerV2(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=2,
        idle_timeout_s=9999,
        gcs_client=worker.gcs_client,
    )
    try:
        # No pending tasks — only the declarative ask: 3 x 2-CPU bundles
        # exceed the 4-CPU head, so a worker must come up.
        request_cluster_resources([{"CPU": 2}] * 3, gcs_client=worker.gcs_client)
        for _ in _poll(90):
            scaler.update()
            if scaler.status()["counts"].get("RAY_RUNNING", 0) >= 1:
                break
        assert scaler.status()["counts"].get("RAY_RUNNING", 0) >= 1
    finally:
        request_cluster_resources([], gcs_client=worker.gcs_client)
        for nid in provider.non_terminated_nodes({}):
            provider.terminate_node(nid)


def test_command_runner_updater_phases_and_failure():
    """NodeUpdater runs initialization -> setup -> start_ray in order
    with the env prefix; the first failing command raises (reference:
    _private/updater.py phase ordering)."""
    from ray_tpu_torch.autoscaler.command_runner import (
        CommandRunnerError,
        LocalCommandRunner,
        NodeUpdater,
        SSHCommandRunner,
    )

    calls = []

    class _Proc:
        returncode = 0
        stdout = ""
        stderr = ""

    def recorder(argv, **kwargs):
        calls.append(argv)
        return _Proc()

    updater = NodeUpdater(
        LocalCommandRunner(process_runner=recorder),
        initialization_commands=["apt-get install -y foo"],
        setup_commands=["pip install bar"],
        start_ray_commands=["ray-tpu-torch start --address=$RAY_TPU_TORCH_GCS_ADDRESS"],
        env={"RAY_TPU_TORCH_GCS_ADDRESS": "unix:/tmp/gcs.sock"},
    )
    updater.update()
    cmds = [argv[-1] for argv in calls]
    assert "apt-get install -y foo" in cmds[0]
    assert "pip install bar" in cmds[1]
    assert cmds[2].startswith("export RAY_TPU_TORCH_GCS_ADDRESS=unix:/tmp/gcs.sock;")

    # ssh runner builds a BatchMode argv against the right target
    ssh_calls = []

    def ssh_recorder(argv, **kwargs):
        ssh_calls.append(argv)
        return _Proc()

    SSHCommandRunner("10.0.0.5", user="u", ssh_key="/k", process_runner=ssh_recorder).run("echo hi")
    argv = ssh_calls[0]
    assert argv[0] == "ssh" and "u@10.0.0.5" in argv and "-i" in argv

    # failure propagates with the command in the error
    class _Fail(_Proc):
        returncode = 7
        stderr = "boom"

    failing = NodeUpdater(
        LocalCommandRunner(process_runner=lambda argv, **k: _Fail()),
        setup_commands=["will-fail"],
    )
    with pytest.raises(CommandRunnerError, match="will-fail"):
        failing.update()


def test_tpu_provider_runs_bootstrap_commands_per_host():
    """A READY multi-host slice gets the command phases run on EVERY
    host before turning up-to-date; a failing host marks the slice
    update-failed."""
    from ray_tpu_torch.autoscaler import GPUNodeProvider, MockGpuClient

    ran = []

    class _Runner:
        def __init__(self, ip):
            self.ip = ip

        def run(self, cmd, *, timeout=600.0):
            ran.append((self.ip, cmd))
            return ""

    client = MockGpuClient()
    provider = GPUNodeProvider(
        {
            "gpu_client": client,
            "setup_commands": ["pip install ray-tpu-torch"],
            "start_ray_commands": ["ray-tpu-torch start"],
            "command_runner_factory": _Runner,
        },
        cluster_name="bt",
    )
    (nid,) = provider.create_node({"accelerator_type": "h100-32"}, {}, 1)
    provider.non_terminated_nodes({})  # reconcile: READY -> async bootstrap
    for _ in _poll(30):
        if provider.node_tags(nid)["node-status"] == "up-to-date":
            break
    assert provider.node_tags(nid)["node-status"] == "up-to-date"
    ips = {ip for ip, _ in ran}
    assert len(ips) == 4  # h100-32 = 4 hosts
    per_host = [c for ip, c in ran if ip == sorted(ips)[0]]
    assert any("pip install ray-tpu-torch" in c for c in per_host)
    assert any("ray-tpu-torch start" in c for c in per_host)
    # env carries slice identity + worker index
    assert any("RAY_TPU_TORCH_SLICE_NAME=" + nid in c for _, c in ran)
    assert any("RAY_TPU_TORCH_SLICE_WORKER_INDEX=3" in c for _, c in ran)

    # failing bootstrap -> update-failed
    class _Boom:
        def __init__(self, ip):
            pass

        def run(self, cmd, *, timeout=600.0):
            from ray_tpu_torch.autoscaler.command_runner import CommandRunnerError

            raise CommandRunnerError(cmd, 1, "nope")

    provider2 = GPUNodeProvider(
        {"gpu_client": MockGpuClient(), "setup_commands": ["x"],
         "command_runner_factory": _Boom},
        cluster_name="bf",
    )
    (nid2,) = provider2.create_node({"accelerator_type": "h100-1"}, {}, 1)
    provider2.non_terminated_nodes({})
    for _ in _poll(30):
        if provider2.node_tags(nid2)["node-status"] == "update-failed":
            break
    assert provider2.node_tags(nid2)["node-status"] == "update-failed"


def test_v2_drives_tpu_slice_provider(ray_cluster):
    """v2's instance state machine drives the GPU-slice provider
    end-to-end — slice-head demand queues a launch, the slice allocates
    (mock API + local raylet backing), the cluster registers it
    (RAY_RUNNING), and the task lands on the slice."""
    from ray_tpu_torch.autoscaler import GPUNodeProvider, MockGpuClient

    worker = get_global_worker()
    client = MockGpuClient()
    provider = GPUNodeProvider(
        {
            "gpu_client": client,
            "launch_local_raylets": True,
            "gcs_address": worker.gcs_client.address,
            "session_dir": worker.session_info.get("session_dir"),
        },
        cluster_name="v2e2e",
    )
    scaler = AutoscalerV2(
        provider,
        node_types={
            "gpu_h100_32": {
                "resources": {"CPU": 4, "GPU": 32, "GPU-h100-32-head": 1},
                "node_config": {"accelerator_type": "h100-32"},
            }
        },
        max_workers=2,
        idle_timeout_s=9999,
        gcs_client=worker.gcs_client,
    )
    try:

        @ray_tpu_torch.remote(resources={"GPU-h100-32-head": 1, "GPU": 4})
        def on_slice():
            return "v2-on-slice"

        ref = on_slice.remote()
        deadline = time.monotonic() + 120
        done = False
        while time.monotonic() < deadline and not done:
            scaler.update()
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=1)
            done = bool(ready)
        assert ray_tpu_torch.get(ref, timeout=30) == "v2-on-slice"
        # Same eventual-consistency as test_v2_scales_up_for_tasks: the
        # task can land inside the launching tick; reconcile until the
        # instance is observed RAY_RUNNING.
        for _ in _poll(max(0.0, deadline - time.monotonic())):
            if scaler.status()["counts"].get("RAY_RUNNING", 0) >= 1:
                break
            scaler.update()
        counts = scaler.status()["counts"]
        assert counts.get("RAY_RUNNING", 0) >= 1, counts
        assert len(client.list()) >= 1
    finally:
        for nid in provider.non_terminated_nodes({}):
            provider.terminate_node(nid)
        assert client.list() == [], "slice not deleted from the API"
