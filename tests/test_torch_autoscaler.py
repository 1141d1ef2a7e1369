"""The port's autoscaler: demand scheduler unit tests + fake-multinode
integration (copies of the 15 tests of ``tests/test_autoscaler.py``), with
``GPU`` node types where the reference's carry ``TPU``: its two TPU-slice
provider tests drive the GPU-slice provider, ``h100-32`` (8 cards x 4
hosts) where they use ``v5litepod-16`` (4 chips x 4 hosts); and the fake
provider's nodes carrying exactly their node type's GPU count on a
machine whose ``/dev`` shows cards.

Reference test model: python/ray/tests/test_resource_demand_scheduler.py,
test_autoscaler_fake_multinode.py.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import retry
from ray_tpu_torch._private.worker import get_global_worker
from ray_tpu_torch.autoscaler import (
    FakeMultiNodeProvider,
    Monitor,
    StandardAutoscaler,
    get_nodes_to_launch,
)


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


def test_demand_scheduler_bin_packing():
    node_types = {
        "small": {"resources": {"CPU": 2}},
        "big": {"resources": {"CPU": 8}},
    }
    # 5 x 1-CPU demands, 1 free CPU in cluster -> 4 CPUs needed -> 2 small
    to_launch = get_nodes_to_launch(
        [{"CPU": 1}] * 5,
        [{"CPU": 1}],
        node_types,
        pending_launches={},
        max_workers=10,
        current_workers=0,
    )
    assert to_launch == {"small": 2}


def test_demand_scheduler_prefers_smallest_fit():
    node_types = {
        "cpu": {"resources": {"CPU": 4}},
        "gpu_host": {"resources": {"CPU": 4, "GPU": 4}},
    }
    to_launch = get_nodes_to_launch(
        [{"GPU": 4}],
        [],
        node_types,
        pending_launches={},
        max_workers=10,
        current_workers=0,
    )
    assert to_launch == {"gpu_host": 1}


def test_demand_scheduler_respects_max_workers():
    node_types = {"small": {"resources": {"CPU": 1}}}
    to_launch = get_nodes_to_launch(
        [{"CPU": 1}] * 10,
        [],
        node_types,
        pending_launches={},
        max_workers=3,
        current_workers=1,
    )
    assert sum(to_launch.values()) == 2


def test_demand_scheduler_counts_pending_launches():
    node_types = {"small": {"resources": {"CPU": 4}}}
    to_launch = get_nodes_to_launch(
        [{"CPU": 1}] * 3,
        [],
        node_types,
        pending_launches={"small": 1},
        max_workers=10,
        current_workers=0,
    )
    assert to_launch == {}  # the in-flight node covers the demand


def test_autoscaler_scales_up_for_pending_actors(ray_cluster):
    """Pending actors that do not fit the head node must pull up a fake
    worker node, after which they get scheduled."""
    worker = get_global_worker()
    session_dir = worker.session_info.get("session_dir")
    gcs_address = worker.gcs_client.address

    provider = FakeMultiNodeProvider(
        {"gcs_address": gcs_address, "session_dir": session_dir}
    )
    autoscaler = StandardAutoscaler(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=2,
        idle_timeout_s=9999,
        gcs_client=worker.gcs_client,
    )
    monitor = Monitor(autoscaler, interval_s=1.0)
    monitor.start()
    try:
        # the module cluster has 4 CPUs; demand 6 CPUs of actors
        @ray_tpu_torch.remote(num_cpus=2)
        class Chunk:
            def ping(self):
                return "ok"

        actors = [Chunk.remote() for _ in range(3)]
        refs = [a.ping.remote() for a in actors]
        out = ray_tpu_torch.get(refs, timeout=120)
        assert out == ["ok"] * 3
        assert autoscaler.num_launches >= 1
        assert len(ray_tpu_torch.nodes()) >= 2
        for a in actors:
            ray_tpu_torch.kill(a)
    finally:
        monitor.stop()
        for nid in provider.non_terminated_nodes({}):
            provider.terminate_node(nid)


def test_tpu_provider_slice_lifecycle_mock():
    """Unit: slices are atomic — create/ready/terminate via the mocked
    GPU-slice API, with slice-topology resources advertised."""
    from ray_tpu_torch.autoscaler import GPUNodeProvider, MockGpuClient, slice_resources
    from ray_tpu_torch.autoscaler.node_provider import TAG_NODE_KIND, TAG_NODE_STATUS

    client = MockGpuClient()
    provider = GPUNodeProvider({"gpu_client": client}, cluster_name="t")
    ids = provider.create_node(
        {"accelerator_type": "h100-32"}, {TAG_NODE_KIND: "worker"}, 2
    )
    assert len(ids) == 2
    assert all(provider.is_running(i) for i in ids)  # mock: READY instantly
    # pending → up-to-date promotion happens on the reconcile read
    provider.non_terminated_nodes({})
    assert provider.node_tags(ids[0])[TAG_NODE_STATUS] == "up-to-date"
    res = slice_resources("h100-32", ids[0])
    assert res["GPU"] == 32.0
    assert res["GPU-h100-32-head"] == 1.0
    assert provider.internal_ip(ids[0]) is not None
    provider.terminate_node(ids[0])
    assert provider.non_terminated_nodes({TAG_NODE_KIND: "worker"}) == [ids[1]]
    assert client.get(ids[0]) is None  # API-side delete happened


@pytest.mark.slow
def test_autoscaler_scales_tpu_slice_up_and_down(ray_cluster):
    """Demand for an h100-32 slice head pulls a whole slice up
    (API-mocked, backed by a local raylet advertising the slice's
    resources); idle timeout scales it back down."""
    from ray_tpu_torch.autoscaler import (
        GPUNodeProvider,
        MockGpuClient,
        Monitor,
        StandardAutoscaler,
    )

    worker = get_global_worker()
    session_dir = worker.session_info.get("session_dir")
    gcs_address = worker.gcs_client.address

    client = MockGpuClient()
    provider = GPUNodeProvider(
        {
            "gpu_client": client,
            "launch_local_raylets": True,
            "gcs_address": gcs_address,
            "session_dir": session_dir,
        },
        cluster_name="h100",
    )
    autoscaler = StandardAutoscaler(
        provider,
        node_types={
            "gpu_h100_32": {
                # slice hosts have CPUs too — tasks carry an implicit
                # CPU: 1, so the node type must cover it to bin-pack
                "resources": {"CPU": 4, "GPU": 32, "GPU-h100-32-head": 1},
                "node_config": {"accelerator_type": "h100-32"},
            }
        },
        max_workers=2,
        idle_timeout_s=5.0,
        gcs_client=worker.gcs_client,
    )
    monitor = Monitor(autoscaler, interval_s=1.0)
    monitor.start()
    try:
        # gang-style demand: one slice-head + cards, unmet by the head node
        @ray_tpu_torch.remote(resources={"GPU-h100-32-head": 1, "GPU": 4})
        def on_slice():
            return "on-slice"

        assert ray_tpu_torch.get(on_slice.remote(), timeout=180) == "on-slice"
        assert autoscaler.num_launches >= 1
        assert len(client.list()) >= 1  # a slice exists in the (mock) API
        # scale-down: demand gone, slice idles out
        bo = retry.POLL.start(deadline_s=90)
        while not (autoscaler.num_terminations >= 1 and not client.list()):
            delay = bo.next_delay()
            if delay is None:
                break
            time.sleep(delay)
        assert autoscaler.num_terminations >= 1, "idle slice never terminated"
        assert client.list() == [], "slice not deleted from the API"
    finally:
        monitor.stop()
        for nid in provider.non_terminated_nodes({}):
            provider.terminate_node(nid)


# ==========================================================================
# Capacity return: preempted-node resources are relaunched even
# with no pending demand (an elastic trainer that shrank queues nothing).
# ==========================================================================


class _RecordingProvider:
    """Minimal provider for unit-driving the reconcile loop."""

    def __init__(self):
        self.created = []  # (tags, count)
        self._nodes = {}
        self._next = 0

    def create_node(self, node_config, tags, count):
        self.created.append((dict(tags), count))
        ids = []
        for _ in range(count):
            nid = f"n{self._next}"
            self._nodes[nid] = dict(tags)
            self._next += 1
            ids.append(nid)
        return ids

    def is_running(self, node_id):
        return node_id in self._nodes

    def non_terminated_nodes(self, tag_filters):
        return [
            nid for nid, tags in self._nodes.items()
            if all(tags.get(k) == v for k, v in tag_filters.items())
        ]

    def terminate_node(self, node_id):
        self._nodes.pop(node_id, None)

    def raylet_address(self, node_id):
        return None


def test_autoscaler_v1_capacity_return_relaunches_preempted():
    provider = _RecordingProvider()
    autoscaler = StandardAutoscaler(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}},
                    "big_worker": {"resources": {"CPU": 16}}},
        max_workers=4,
    )
    lost = {
        "pending_demands": [],
        "nodes": {},
        "lost_capacity": [
            {"node_id": "deadbeef01", "resources_total": {"CPU": 2},
             "reason": "PREEMPTION", "time": 0.0}
        ],
    }
    autoscaler.update(load_metrics=lost)
    # Smallest covering type relaunched, once, with zero pending demand.
    assert autoscaler.num_capacity_returns == 1
    assert len(provider.created) == 1
    assert provider.created[0][1] == 1
    assert "cpu_worker" in provider.created[0][0].values()
    # The log entry is processed exactly once: a second tick with the
    # same feed (the GCS keeps a bounded log) launches nothing new.
    autoscaler.update(load_metrics=lost)
    assert autoscaler.num_capacity_returns == 1
    assert len(provider.created) == 1


def test_autoscaler_v2_capacity_return_queues_replacement():
    from ray_tpu_torch.autoscaler.v2.autoscaler import AutoscalerV2

    provider = _RecordingProvider()
    autoscaler = AutoscalerV2(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=4,
    )
    lost = {
        "pending_demands": [],
        "nodes": {},
        "lost_capacity": [
            {"node_id": "deadbeef02", "resources_total": {"CPU": 2},
             "reason": "PREEMPTION", "time": 0.0}
        ],
    }
    autoscaler.update(load_metrics=lost)
    assert autoscaler.num_capacity_returns == 1
    assert len(provider.created) == 1  # reconcile drove the queued launch
    autoscaler.update(load_metrics=lost)
    assert autoscaler.num_capacity_returns == 1


def test_pick_replacement_type_smallest_cover():
    from ray_tpu_torch.autoscaler.autoscaler import pick_replacement_type

    types = {
        "small": {"resources": {"CPU": 2}},
        "big": {"resources": {"CPU": 16}},
        "gpu": {"resources": {"GPU": 4, "CPU": 8}},
    }
    assert pick_replacement_type(types, {"CPU": 2}) == "small"
    assert pick_replacement_type(types, {"CPU": 8}) == "big"
    assert pick_replacement_type(types, {"GPU": 4}) == "gpu"
    assert pick_replacement_type(types, {"TPU": 1}) is None  # a kind no type declares
    # Auto-detected extras on a REGISTERED node (memory from sysconf,
    # per-node markers) must not defeat the fit — only resource kinds
    # some node type declares participate.
    assert pick_replacement_type(
        types, {"CPU": 2, "memory": 8 * 1024**3, "node:10.0.0.4": 1}
    ) == "small"
    assert pick_replacement_type(types, {"memory": 8 * 1024**3}) is None


def test_replacement_launches_prune_survives_budget_break():
    """The consumed-once prune must be computed against the FULL feed: a
    budget break mid-iteration must not forget already-replaced ids past
    the break point (that would double-launch them next tick)."""
    from ray_tpu_torch.autoscaler.autoscaler import replacement_launches

    types = {"w": {"resources": {"CPU": 2}}}
    feed = [
        {"node_id": "A", "resources_total": {"CPU": 2}},
        {"node_id": "B", "resources_total": {"CPU": 2}},
    ]
    processed = {"B"}  # B already replaced; A pending (its launch failed)
    assert replacement_launches(types, feed, processed, budget=0) == []
    assert "B" in processed  # remembered despite the budget break at A
    out = replacement_launches(types, feed, processed, budget=2)
    assert [o[0] for o in out] == ["A"]  # A launches once, B never again
    # Aged-out entries DO get pruned once the GCS TTL drops them.
    assert replacement_launches(types, [], processed, budget=2) == []
    assert processed == set()


def test_grow_hint_rpc_roundtrip(ray_cluster):
    """train_grow_hint publishes into the load-metrics feed; count 0
    clears; stale hints age out by TTL at read time."""
    worker = get_global_worker()
    gcs = worker.gcs_client
    assert gcs.call(
        "train_grow_hint",
        {"name": "exp_grow", "count": 2, "resources": {"CPU": 1.0}},
    )
    hints = gcs.call("get_load_metrics")["grow_hints"]
    assert [h["name"] for h in hints] == ["exp_grow"]
    assert hints[0]["count"] == 2
    assert hints[0]["resources"] == {"CPU": 1.0}
    # refresh replaces in place (no duplicates)
    gcs.call(
        "train_grow_hint",
        {"name": "exp_grow", "count": 1, "resources": {"CPU": 1.0}},
    )
    hints = gcs.call("get_load_metrics")["grow_hints"]
    assert len(hints) == 1 and hints[0]["count"] == 1
    gcs.call("train_grow_hint", {"name": "exp_grow", "count": 0})
    assert gcs.call("get_load_metrics")["grow_hints"] == []
    # nameless publishes are refused, not stored
    assert gcs.call("train_grow_hint", {"count": 3}) is False


def test_autoscaler_launches_for_grow_hints():
    """A grow hint alone — zero pending task demand — pulls up worker
    capacity sized to the hinted shape, so the elastic trainer's
    epoch-boundary grow finds it warm."""
    provider = _RecordingProvider()
    autoscaler = StandardAutoscaler(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=4,
    )
    feed = {
        "pending_demands": [],
        "nodes": {},
        "lost_capacity": [],
        "grow_hints": [
            {"name": "exp", "count": 2, "resources": {"CPU": 1.0},
             "time": 0.0}
        ],
    }
    autoscaler.update(load_metrics=feed)
    assert len(provider.created) == 1
    # one 2-CPU worker covers both hinted 1-CPU shapes
    assert provider.created[0][1] == 1
    # empty shapes are ignored rather than minting zero-resource demand
    provider.created.clear()
    autoscaler2 = StandardAutoscaler(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=4,
    )
    autoscaler2.update(load_metrics={
        "pending_demands": [], "nodes": {}, "lost_capacity": [],
        "grow_hints": [{"name": "e", "count": 2, "resources": {}}],
    })
    assert provider.created == []


def test_grow_hint_deduped_against_capacity_return():
    """A preemption that shrank an elastic trainer logs BOTH a
    lost_capacity entry and a grow hint for the same worker — the
    replacement launch must not be doubled by the hint."""
    provider = _RecordingProvider()
    autoscaler = StandardAutoscaler(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=8,
    )
    feed = {
        "pending_demands": [],
        "nodes": {},
        "lost_capacity": [
            {"node_id": "deadbeef03", "resources_total": {"CPU": 2},
             "reason": "PREEMPTION", "time": 0.0}
        ],
        "grow_hints": [
            {"name": "exp", "count": 1, "resources": {"CPU": 1.0},
             "time": 0.0}
        ],
    }
    autoscaler.update(load_metrics=feed)
    # one node total: the capacity return already covers the hinted worker
    assert autoscaler.num_capacity_returns == 1
    assert len(provider.created) == 1
    assert provider.created[0][1] == 1
    # Hint demand BEYOND what the lost entry covers still launches: 3
    # hinted 1-CPU workers minus the one absorbed leaves 2, bin-packed
    # onto one 2-CPU node alongside the replacement.
    provider = _RecordingProvider()
    autoscaler = StandardAutoscaler(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=8,
    )
    feed["grow_hints"][0]["count"] = 3
    autoscaler.update(load_metrics=feed)
    assert autoscaler.num_capacity_returns == 1
    assert sum(c for _, c in provider.created) == 2


def test_autoscaler_v2_launches_for_grow_hints():
    """v2 folds hints through the same shared helper as v1."""
    from ray_tpu_torch.autoscaler.v2.autoscaler import AutoscalerV2

    provider = _RecordingProvider()
    autoscaler = AutoscalerV2(
        provider,
        node_types={"cpu_worker": {"resources": {"CPU": 2}}},
        max_workers=4,
    )
    autoscaler.update(load_metrics={
        "pending_demands": [], "nodes": {}, "lost_capacity": [],
        "grow_hints": [
            {"name": "exp", "count": 2, "resources": {"CPU": 1.0},
             "time": 0.0}
        ],
    })
    assert len(provider.created) == 1


def test_fake_provider_nodes_carry_their_node_types_gpu_count(ray_cluster, tmp_path, monkeypatch):
    """Port: on a machine whose /dev shows two cards, a FakeMultiNodeProvider
    node of type {"CPU": 1} registers no GPU and one of type {"CPU": 1,
    "GPU": 1} exactly one.  The reference passes no GPU count, so the
    node's raylet counts the machine's cards (here 2, and 2 again where the
    type asks for 1: the detected count overwrites the type's)."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm"):
        (dev / name).touch()
    detect = GPUAcceleratorManager.get_current_node_num_accelerators
    monkeypatch.setattr(GPUAcceleratorManager, "get_current_node_num_accelerators",
                        staticmethod(lambda dev_dir="/dev": detect(str(dev))))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    # what the reference's create_node asks for, on this /dev
    assert node_mod.detect_resources(1, None, {})["GPU"] == 2.0
    assert node_mod.detect_resources(1, None, {"GPU": 1})["GPU"] == 2.0

    worker = get_global_worker()
    provider = FakeMultiNodeProvider(
        {"gcs_address": worker.gcs_client.address,
         "session_dir": worker.session_info.get("session_dir")}
    )
    try:
        (cpu_node,) = provider.create_node({"resources": {"CPU": 1}}, {}, 1)
        (gpu_node,) = provider.create_node({"resources": {"CPU": 1, "GPU": 1}}, {}, 1)
        want = {provider.raylet_address(cpu_node): 0.0, provider.raylet_address(gpu_node): 1.0}

        def registered():
            info = worker.gcs_client.call("get_cluster_info")
            got = {n["raylet_address"]: n["resources_total"] for n in info["nodes"].values()
                   if n["raylet_address"] in want and n["state"] == "ALIVE"}
            return got if len(got) == 2 else None

        got = None
        bo = retry.POLL.start(deadline_s=30)
        while got is None:
            got = registered()
            delay = bo.next_delay()
            if got is None and delay is None:
                break
            if got is None:
                time.sleep(delay)
        assert got is not None, "the fake nodes never registered"
        assert {addr: res.get("GPU", 0.0) for addr, res in got.items()} == want
        assert all(res["CPU"] == 1.0 for res in got.values())
    finally:
        for nid in provider.non_terminated_nodes({}):
            provider.terminate_node(nid)
