"""Partition-tolerant membership on the port (a copy of the JAX package's
tests/test_partition.py; it imports neither JAX nor the JAX package):
link-level chaos, incarnation fencing, and the gray-failure
suspicion/quarantine ladder.

Three layers of drills (mirroring test_chaos.py):

1. The ``net:<src>-><dst>`` rule family in isolation — parser round
   trips, directional matching, seeded flaky replay, and the
   ``start=``/``for=`` wall-clock arming windows (a partition that
   heals, a link that flaps).
2. The GCS membership state machine, unit-tested by direct
   construction (no sockets): the incarnation fence matrix, the
   suspicion-score blend (gray signals cap below DEAD), and the
   QUARANTINED readmission path (hysteresis + flap budget).
3. Live-cluster drills: a zombie incarnation's writes are rejected
   over the wire with a typed, counted error, and serve routing
   demotes replicas on a QUARANTINED node then re-promotes them after
   readmission.

The asymmetric-partition and gray-failure end-to-end drills (real
raylets behind cut/slow links) live in the JAX package's
scripts/partition_smoke.py — they need whole-process net identities
that an in-process test can't fake; the port has no copy of it.
"""

import os
import pickle
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import NodeFencedError


# ----------------------------------------------------------------------
# fixtures
# ----------------------------------------------------------------------


@pytest.fixture()
def chaos_env():
    """In-process chaos plane: set spec env vars, reset the parsed
    rule table, and restore both afterwards."""
    from ray_tpu_torch._private.chaos import CHAOS

    saved = {}

    def set_env(env: dict):
        for k, v in env.items():
            saved.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        CHAOS.reset()
        return CHAOS

    yield set_env
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old
    CHAOS.reset()


@pytest.fixture()
def gcs():
    """A GcsServer constructed but never started: pure membership
    state machine, no sockets, no background loops."""
    import asyncio

    from ray_tpu_torch._private.gcs_server import GcsServer

    loop = asyncio.new_event_loop()
    srv = GcsServer("127.0.0.1:0", {"session_dir": ""}, loop=loop)
    yield srv, loop
    loop.close()


def _add_node(srv, state="ALIVE", inc=5):
    from ray_tpu_torch._private.common import NodeInfo, ResourceSet
    from ray_tpu_torch._private.ids import NodeID

    nid = NodeID.from_random()
    info = NodeInfo(
        node_id=nid,
        raylet_address="",
        object_store_dir="",
        resources_total=ResourceSet.of({}),
        state=state,
        incarnation=inc,
    )
    srv.nodes[nid] = info
    srv.node_incarnations[nid] = inc
    srv.last_heartbeat[nid] = time.monotonic()
    return nid, info


# ----------------------------------------------------------------------
# 1. net: rule family
# ----------------------------------------------------------------------


def test_net_rule_parse_defaults():
    from ray_tpu_torch._private.chaos import _parse_rule

    r = _parse_rule(0, "net:raylet*->gcs:cut", 7)
    assert r.pattern == "net:raylet*->gcs"
    assert r.action == "cut"
    assert r.n == -1  # link rules are sustained by default
    assert r.p == 1.0
    assert r.start_s == 0.0 and r.for_s is None

    r = _parse_rule(1, "net:*->node2:flaky", 7)
    assert r.p == 0.5  # flaky halves the link unless told otherwise
    assert r.n == -1

    r = _parse_rule(2, "net:node1->node2:slow:ms=500", 7)
    assert r.action == "slow"
    assert r.delay_s == pytest.approx(0.5)

    r = _parse_rule(3, "net:a->b:cut:start=5:for=3:p=0.25:n=10", 7)
    assert (r.start_s, r.for_s, r.p, r.n) == (5.0, 3.0, 0.25, 10)


def test_net_rule_rejects_non_link_pattern():
    from ray_tpu_torch._private.chaos import _parse_rule

    # A net action without a directional net:<src>-><dst> pattern is a
    # spec bug, not a silently-never-matching rule.
    with pytest.raises(ValueError):
        _parse_rule(0, "submit_task:cut", 7)
    with pytest.raises(ValueError):
        _parse_rule(0, "net:gcs:cut", 7)  # no "->"


def test_net_stats_round_trip(chaos_env):
    chaos = chaos_env(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": "net:a->b:cut:start=1:for=2",
            "RAY_TPU_TORCH_testing_chaos_seed": "11",
        }
    )
    assert chaos.active
    stats = chaos.stats()
    assert stats["seed"] == 11
    [rule] = stats["rules"]
    assert rule["pattern"] == "net:a->b"
    assert rule["action"] == "cut"
    assert rule["start_s"] == 1.0 and rule["for_s"] == 2.0


def test_decide_net_directionality(chaos_env, monkeypatch):
    from ray_tpu_torch._private import telemetry

    fired = []
    monkeypatch.setattr(
        telemetry, "count_chaos_net", lambda p, a: fired.append((p, a))
    )
    chaos = chaos_env(
        {"RAY_TPU_TORCH_testing_chaos_spec": "net:raylet*->gcs:cut"}
    )
    # src->dst matches: blackholed, and counted as a net injection.
    assert chaos.decide_net("raylet-abc123", "gcs").drop
    # The reverse direction keeps flowing — asymmetric by construction.
    assert chaos.decide_net("gcs", "raylet-abc123").clean
    # Unrelated links untouched.
    assert chaos.decide_net("driver", "gcs").clean
    assert fired == [("net:raylet*->gcs", "cut")]


def test_decide_net_flaky_seeded_replay(chaos_env):
    env = {
        "RAY_TPU_TORCH_testing_chaos_spec": "net:a->b:flaky:p=0.5",
        "RAY_TPU_TORCH_testing_chaos_seed": "1234",
    }
    chaos = chaos_env(env)
    first = [chaos.decide_net("a", "b").drop for _ in range(64)]
    chaos.reset()
    second = [chaos.decide_net("a", "b").drop for _ in range(64)]
    assert first == second  # same seed + spec -> identical schedule
    assert True in first and False in first  # genuinely flaky


def test_net_window_cut_heals(chaos_env):
    """``for=`` bounds a partition in wall-clock time: the cut holds,
    then the link heals without any spec change (spawned processes
    can't receive one)."""
    chaos = chaos_env(
        {"RAY_TPU_TORCH_testing_chaos_spec": "net:a->b:cut:for=0.3"}
    )
    assert chaos.decide_net("a", "b").drop  # armed immediately
    deadline = time.monotonic() + 5
    while chaos.decide_net("a", "b").drop:
        assert time.monotonic() < deadline, "cut window never healed"
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.05)
    assert chaos.decide_net("a", "b").clean


def test_net_window_delayed_start_and_flap(chaos_env):
    """``start=`` delays arming; two staggered windows on one pattern
    model a flapping link.  Disarmed matches consume no counters."""
    chaos = chaos_env(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": (
                "net:a->b:cut:start=0.2:for=0.2,"
                "net:a->b:cut:start=0.6:for=0.2"
            )
        }
    )
    assert chaos.decide_net("a", "b").clean  # both windows still closed
    # Disarmed matches must not advance any rule's match ordinal.
    assert all(r["matches"] == 0 for r in chaos.stats()["rules"])

    def _wait(pred, what):
        deadline = time.monotonic() + 5
        while not pred():
            assert time.monotonic() < deadline, what
            # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
            time.sleep(0.02)

    _wait(lambda: chaos.decide_net("a", "b").drop, "first flap never cut")
    _wait(lambda: chaos.decide_net("a", "b").clean, "first flap never healed")
    _wait(lambda: chaos.decide_net("a", "b").drop, "second flap never cut")
    _wait(lambda: chaos.decide_net("a", "b").clean, "second flap never healed")


# ----------------------------------------------------------------------
# 2. membership state machine (unit, no sockets)
# ----------------------------------------------------------------------


def test_fence_matrix(gcs, monkeypatch):
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch._private.ids import NodeID

    srv, _ = gcs
    counted = []
    monkeypatch.setattr(
        telemetry, "count_fence_rejection", lambda m: counted.append(m)
    )

    nid, info = _add_node(srv, state="ALIVE", inc=5)

    # Unstamped payloads (workers, legacy callers) always pass.
    srv._check_fence("m", None, None)
    srv._check_fence("m", nid, None)
    # A node the GCS has never stamped passes (registration races).
    srv._check_fence("m", NodeID.from_random(), 1)
    # The current incarnation of a live node passes.
    srv._check_fence("m", nid, 5)
    assert counted == []

    # Stale incarnation: typed rejection carrying the fenced identity.
    with pytest.raises(NodeFencedError) as ei:
        srv._check_fence("resource_report", nid, 4)
    assert ei.value.node_id == nid.binary()
    assert ei.value.incarnation == 4
    # Raw-bytes node ids (as they arrive in payloads) fence identically.
    with pytest.raises(NodeFencedError):
        srv._check_fence("resource_report", nid.binary(), 4)

    # Equal incarnation but declared DEAD at it: the zombie on the far
    # side of a healed partition.  Its writes must not resurrect it.
    info.state = "DEAD"
    with pytest.raises(NodeFencedError):
        srv._check_fence("object_location_add", nid, 5)
    info.state = "ALIVE"
    srv._check_fence("object_location_add", nid, 5)  # alive again: passes

    # Incarnation known but the NodeInfo itself is gone: fenced too.
    del srv.nodes[nid]
    with pytest.raises(NodeFencedError):
        srv._check_fence("free_objects", nid, 5)

    assert counted == [
        "resource_report",
        "resource_report",
        "object_location_add",
        "free_objects",
    ]


def test_fence_runs_before_heartbeat_touch(gcs, monkeypatch):
    """A zombie's resource_report must not refresh its successor's
    liveness: the fence fires before the heartbeat is touched."""
    from ray_tpu_torch._private import telemetry

    srv, loop = gcs
    monkeypatch.setattr(telemetry, "count_fence_rejection", lambda m: None)
    nid, _ = _add_node(srv, inc=7)
    srv.last_heartbeat[nid] = 123.0  # sentinel
    with pytest.raises(NodeFencedError):
        loop.run_until_complete(
            srv.rpc_resource_report(
                {"node_id": nid.binary(), "incarnation": 6, "available": {}},
                None,
            )
        )
    assert srv.last_heartbeat[nid] == 123.0
    # The current incarnation's report lands normally.
    loop.run_until_complete(
        srv.rpc_resource_report(
            {"node_id": nid.binary(), "incarnation": 7, "available": {}},
            None,
        )
    )
    assert srv.last_heartbeat[nid] != 123.0


def test_registration_stamps_monotonic_incarnation(gcs):
    """Re-registration always lands strictly above every prior stamp,
    and above wall-time — a rebooted GCS that lost the map can never
    re-issue an incarnation a zombie still holds."""
    srv, _ = gcs
    nid, info = _add_node(srv, inc=3)
    inc = max(srv.node_incarnations.get(nid, 0) + 1, int(time.time()))
    assert inc > 3 and inc >= int(time.time())
    # ... and if a prior stamp is already above wall time (clock skew),
    # +1 monotonicity wins.
    srv.node_incarnations[nid] = int(time.time()) + 10_000
    inc2 = max(srv.node_incarnations[nid] + 1, int(time.time()))
    assert inc2 == srv.node_incarnations[nid] + 1


def test_node_fenced_error_pickles_identity():
    err = NodeFencedError("fenced", node_id=b"\x01" * 16, incarnation=42)
    back = pickle.loads(pickle.dumps(err))
    assert isinstance(back, NodeFencedError)
    assert back.node_id == b"\x01" * 16
    assert back.incarnation == 42


def test_suspicion_score_blend(gcs, monkeypatch):
    """Hard silence is the only signal allowed to reach 1.0; gray
    signals (slow-but-alive) cap at 0.9 so they can never drive a
    false DEAD."""
    srv, _ = gcs
    now = time.monotonic()

    nid, _ = _add_node(srv)
    srv.last_heartbeat[nid] = now
    assert srv._suspicion_score(nid, now, threshold=10.0) == 0.0

    # Full silence past the threshold: 1.0.
    srv.last_heartbeat[nid] = now - 20.0
    assert srv._suspicion_score(nid, now, threshold=10.0) == 1.0

    # Pathological gray signals (huge RTT, endless RPC errors) with a
    # fresh heartbeat: capped strictly below the death score.
    srv.last_heartbeat[nid] = now
    srv.node_health[nid] = {"gcs_rtt_ms": 1e9, "gcs_errors": 1e9}
    assert srv._suspicion_score(nid, now, threshold=10.0) == 0.9

    # Channel-health degradation (blocked-seconds rate) is gray too.
    nid2, _ = _add_node(srv)
    srv.last_heartbeat[nid2] = now
    srv._chan_stats[nid2] = {b"w": (100.0, 0.0)}
    srv._chan_prev[nid2] = (0.0, 0.0, now - 1.0)
    assert srv._suspicion_score(nid2, now, threshold=10.0) == 0.9


def test_ring_blocked_time_is_not_a_slow_link(gcs):
    """Only a cross-host socket channel's blocked time feeds a node's
    suspicion: a same-host shm ring has no link, and its blocked time is
    its peer's compute (a pipeline's stages waiting on each other)."""
    srv, _ = gcs
    now = time.monotonic()

    def report(nid, transport, blocked):
        srv._note_channel_health(nid, b"w", [{
            "name": "channel_blocked_seconds_total",
            "tags": {"op": "read", "transport": transport},
            "value": blocked,
        }])

    ring, _ = _add_node(srv)
    srv.last_heartbeat[ring] = now
    report(ring, "ring", 0.0)
    assert srv._suspicion_score(ring, now - 1.0, threshold=10.0) == 0.0
    report(ring, "ring", 100.0)  # 100 s blocked in a 1 s window
    assert srv._suspicion_score(ring, now, threshold=10.0) == 0.0

    sock, _ = _add_node(srv)
    srv.last_heartbeat[sock] = now
    report(sock, "socket", 0.0)
    srv._suspicion_score(sock, now - 1.0, threshold=10.0)
    report(sock, "socket", 100.0)
    assert srv._suspicion_score(sock, now, threshold=10.0) == 0.9


def test_finish_quarantine_gating(gcs):
    """Only a QUARANTINE-reason drain parks in QUARANTINED; every other
    drain reason keeps its termination semantics."""
    srv, _ = gcs

    _, info = _add_node(srv, state="DRAINING")
    info.drain_reason = "QUARANTINE"
    srv._finish_quarantine(info)
    assert info.state == "QUARANTINED"
    assert info.quarantined_since > 0

    _, info2 = _add_node(srv, state="DRAINING")
    info2.drain_reason = "PREEMPTION"
    srv._finish_quarantine(info2)
    assert info2.state == "DRAINING"

    _, info3 = _add_node(srv, state="ALIVE")
    info3.drain_reason = "QUARANTINE"  # stale reason, node not draining
    srv._finish_quarantine(info3)
    assert info3.state == "ALIVE"


def test_unquarantine_hysteresis_and_flap_budget(gcs, monkeypatch):
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch._private.config import CONFIG

    srv, _ = gcs
    transitions = []
    monkeypatch.setattr(
        telemetry, "count_quarantine", lambda r, d: transitions.append((r, d))
    )
    hyst = float(CONFIG.unquarantine_hysteresis_s)
    budget = int(CONFIG.node_flap_budget)

    nid, info = _add_node(srv, state="QUARANTINED")
    info.drain_reason = "QUARANTINE"
    info.drain_complete = True
    now = 1000.0

    # Still suspicious: no recovery clock at all.
    srv._maybe_unquarantine(info, score=0.9, now=now)
    assert info.state == "QUARANTINED" and nid not in srv._recover_since

    # Healthy, but the hysteresis window hasn't elapsed.
    srv._maybe_unquarantine(info, score=0.0, now=now)
    assert info.state == "QUARANTINED" and srv._recover_since[nid] == now
    srv._maybe_unquarantine(info, score=0.0, now=now + hyst / 2)
    assert info.state == "QUARANTINED"

    # A suspicion blip mid-window resets the clock.
    srv._maybe_unquarantine(info, score=0.9, now=now + hyst * 0.75)
    assert nid not in srv._recover_since
    srv._maybe_unquarantine(info, score=0.0, now=now + hyst)
    assert info.state == "QUARANTINED"  # clock restarted at now+hyst

    # Sustained health past the window: readmitted, drain state reset,
    # one flap spent.
    srv._maybe_unquarantine(info, score=0.0, now=now + 2 * hyst + 0.1)
    assert info.state == "ALIVE"
    assert info.flap_count == 1
    assert info.drain_reason is None and not info.drain_complete
    assert ("gray_failure", "exit") in transitions

    # Budget exhausted: the node stays parked no matter how healthy.
    info.state = "QUARANTINED"
    info.flap_count = budget
    srv._maybe_unquarantine(info, score=0.0, now=now + 100)
    srv._maybe_unquarantine(info, score=0.0, now=now + 100 + 2 * hyst)
    assert info.state == "QUARANTINED"
    assert info.flap_count == budget


def test_free_batch_shed_is_counted(monkeypatch):
    """The owner-side free batch is bounded across a GCS outage; records
    the bound sheds are visible as telemetry_dropped_total, not a
    silent free leak."""
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch._private.worker import ReferenceCounter

    class _DeadGcs:
        closed = False

        def push(self, method, payload):
            raise ConnectionError("gcs down")

    class _FakeWorker:
        gcs_client = _DeadGcs()

    drops = []
    monkeypatch.setattr(
        telemetry,
        "count_telemetry_dropped",
        lambda reason, n=1: drops.append((reason, n)),
    )
    rc = ReferenceCounter(_FakeWorker())
    try:
        rc._to_free = [b"%032d" % i for i in range(100_050)]
        rc.flush()
        assert len(rc._to_free) == 100_000
        assert drops == [("gcs_outage_bound", 50)]
        # Under the bound nothing sheds.
        rc.flush()
        assert drops == [("gcs_outage_bound", 50)]
    finally:
        rc.stop()


# ----------------------------------------------------------------------
# 3. live-cluster drills
# ----------------------------------------------------------------------


@pytest.fixture()
def two_node_cluster(request):
    """Head + one worker node, env staged BEFORE spawn (config is
    frozen into children at process creation).  Every process of the
    cluster runs without the 2 GiB shm arena prefault and without the
    memory monitor: the suite runs many clusters at once, and the
    monitor watches the whole machine."""
    saved = {}
    created = []
    for k, v in {
        "RAY_TPU_TORCH_arena_prefault_bytes": "0",
        "RAY_TPU_TORCH_memory_monitor_enabled": "0",
    }.items():
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
    try:
        from ray_tpu_torch import serve

        serve.shutdown()
    except Exception:
        pass
    ray_tpu_torch.shutdown()
    for c in created:
        c.shutdown()
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old


def _wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.chaos
def test_stale_incarnation_fenced_over_the_wire(two_node_cluster):
    """Zombie-fencing regression: a raylet-originated write stamped with
    a stale incarnation is rejected with a TYPED NodeFencedError across
    the RPC wire, the rejection is counted, and the real node's
    liveness is untouched."""
    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.util import metrics as metrics_mod
    from ray_tpu_torch.util import state

    two_node_cluster({}, nodes=[{"num_cpus": 1, "resources": {"side": 1}}])
    w = get_global_worker()
    info = w.gcs_client.call("get_cluster_info")
    target = next(
        n for n in info["nodes"].values() if not n.get("is_head")
    )
    node_id, inc = target["node_id"], target["incarnation"]
    assert inc > 0

    with pytest.raises(NodeFencedError) as ei:
        w.gcs_client.call(
            "resource_report",
            {"node_id": node_id, "incarnation": inc - 1, "available": {}},
        )
    assert ei.value.node_id == node_id
    assert ei.value.incarnation == inc - 1

    # The current incarnation still passes (the fence is exact).
    assert w.gcs_client.call(
        "resource_report",
        {
            "node_id": node_id,
            "incarnation": inc,
            "available": target["available"],
        },
    )

    # The real node never flinched.
    nodes = {n["node_id"]: n for n in state.list_nodes()}
    assert nodes[bytes(node_id).hex()]["state"] == "ALIVE"

    # The rejection reached the fence counter (GCS-side telemetry
    # flushes into the metrics table on its own cadence).
    metrics_mod.flush()

    def _fence_counted():
        return any(
            r["name"] == "node_fence_rejections_total"
            and (r.get("tags") or {}).get("method") == "resource_report"
            and r.get("value", 0) >= 1
            for r in state.metrics()
        )

    _wait_for(_fence_counted, 15, "node_fence_rejections_total sample")


@pytest.mark.chaos
def test_serve_demotes_and_repromotes_quarantined_node(two_node_cluster):
    """The router stops picking replicas on a QUARANTINED node and
    resumes after the gray-failure ladder readmits it."""
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import get_global_worker
    from ray_tpu_torch.util import state

    two_node_cluster(
        # Readmission needs sustained health for the hysteresis window;
        # keep it short so the re-promotion leg fits the test budget,
        # but long enough to observe demotion while parked.
        {"RAY_TPU_TORCH_unquarantine_hysteresis_s": "6"},
        head_args={"num_cpus": 4, "resources": {"pin": 1}},
        nodes=[{"num_cpus": 1, "resources": {"pin": 1, "side": 1}}],
    )

    @serve.deployment(
        num_replicas=2,
        ray_actor_options={"num_cpus": 0, "resources": {"pin": 1}},
    )
    def where(_):
        from ray_tpu_torch.runtime_context import get_runtime_context

        return get_runtime_context().get_node_id()

    handle = serve.run(where.bind())

    nodes = state.list_nodes()
    side = next(n for n in nodes if not n["is_head"])["node_id"]

    # Both nodes serve before the quarantine (pin:1 per node forces one
    # replica onto each).
    def _hits(n=24):
        return {handle.remote(None).result(timeout=30) for _ in range(n)}

    _wait_for(lambda: side in _hits(), 60, "replica on the side node to serve")

    # Quarantine the side node through the drain plane (the same path
    # the gray-failure ladder takes).
    w = get_global_worker()
    w.gcs_client.call(
        "drain_node",
        {
            "node_id": bytes.fromhex(side),
            "reason": "QUARANTINE",
            "deadline_s": 5.0,
        },
    )
    _wait_for(
        lambda: any(
            n["node_id"] == side and n["state"] == "QUARANTINED"
            for n in state.list_nodes()
        ),
        30,
        "side node to park in QUARANTINED",
    )

    # Demotion: once the pushed snapshot lands, traffic avoids the
    # quarantined node's replica entirely.
    _wait_for(lambda: side not in _hits(12), 20, "router to demote the replica")
    assert side not in _hits()

    # The node is actually healthy, so the ladder readmits it after the
    # hysteresis window — and the router re-promotes the replica.
    _wait_for(
        lambda: any(
            n["node_id"] == side and n["state"] == "ALIVE"
            for n in state.list_nodes()
        ),
        60,
        "side node to be readmitted",
    )
    _wait_for(lambda: side in _hits(), 60, "router to re-promote the replica")


@ray_tpu_torch.remote(num_cpus=0)
class _StarvedRingReader:
    """The reader of a same-host ring whose writer never publishes: a
    pipeline stage waiting in its bubble, at the scale of seconds."""

    def starve(self, path: str, seconds: float) -> float:
        from ray_tpu_torch.experimental.channel import Channel, ChannelTimeout
        from ray_tpu_torch.util import metrics

        ch = Channel(path, max_size=4096, create=True)
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            try:
                ch.read(timeout=0.25)
            except ChannelTimeout:
                pass  # a timed-out read flushes its blocked seconds
            metrics.flush()
        return ch.stats["read_blocked_s"]


def test_blocked_ring_does_not_flap_its_node_suspect(two_node_cluster, tmp_path):
    """A node whose workers sit blocked on same-host rings stays ALIVE:
    the blocked seconds reach the GCS (transport=ring), but they are its
    peer's compute, not a slow link, so the gray-failure ladder neither
    cordons the node (SUSPECT) nor quarantines it under its own work."""
    from ray_tpu_torch.util import state

    two_node_cluster({}, head_args={"num_cpus": 2})
    seen = set()
    reader = _StarvedRingReader.remote()
    ref = reader.starve.remote(str(tmp_path / "ring"), 6.0)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        seen.update(n["state"] for n in state.list_nodes())
        done, _ = ray_tpu_torch.wait([ref], timeout=0.2)
        if done:
            break
    blocked = ray_tpu_torch.get(ref, timeout=30)
    assert blocked > 4.0
    reported = sum(
        m.get("value") or 0.0 for m in state.metrics()
        if m.get("name") == "channel_blocked_seconds_total"
        and (m.get("tags") or {}).get("transport") == "ring"
    )
    assert reported > 4.0, reported
    # two health periods past the last report: still no suspicion
    deadline = time.monotonic() + 2.5
    while time.monotonic() < deadline:
        seen.update(n["state"] for n in state.list_nodes())
        time.sleep(0.2)  # graftlint: disable=retry-gate -- scan resolution of a state watch with its own deadline, not a retry delay
    assert seen == {"ALIVE"}, seen
