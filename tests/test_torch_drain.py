"""Graceful node drain + preemption-aware recovery plane, on the port
(a copy of the JAX package's tests/test_drain.py; it imports neither JAX
nor the JAX package).

Layers drilled here:

1. Plane determinism: the ``preempt`` chaos action and pubsub-channel
   chaos rules replay identically under the same seed.
2. Core drain path (tier-1): ``drain_node`` moves a node
   ALIVE -> DRAINING, the raylet stops granting leases and bundle
   reservations, restartable actors migrate, sole-copy objects are
   re-replicated, and the node's later death loses nothing.
3. Drain-under-chaos matrix (``-m chaos``):
   - preemption notice honored: zero loss, no lineage reconstruction;
   - notice chaos-dropped: the reactive heartbeat path recovers
     (lineage reconstruction still repairs the lost object);
   - deadline expiry mid-task: in-flight tasks retried via the
     idempotent submit machinery;
   - TorchTrainer proactive checkpoint (CPU workers): a drain notice covering a rank
     triggers an immediate checkpoint + whole-group restart that resumes
     AHEAD of the last periodic checkpoint and burns none of
     FailureConfig.max_failures.
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture()
def env_guard():
    """Set env vars scoped to the test; restore (and reset the chaos
    plane) afterwards."""
    saved = {}

    def set_env(env: dict):
        for k, v in env.items():
            saved.setdefault(k, os.environ.get(k))
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    yield set_env
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()


@pytest.fixture()
def drain_cluster(env_guard):
    """Cluster factory with PER-PROCESS chaos env: head (GCS) and each
    worker node can carry different fault specs — a preemption rule must
    hit exactly one raylet, not every process in the session.

    Every process of the cluster runs without the 2 GiB shm arena
    prefault and without the memory monitor: the suite runs many
    clusters at once, and the monitor watches the whole machine."""
    created = []
    env_guard(
        {
            "RAY_TPU_TORCH_arena_prefault_bytes": "0",
            "RAY_TPU_TORCH_memory_monitor_enabled": "0",
        }
    )

    def make(head_env=None, head_args=None, nodes=()):
        env_guard(head_env or {})
        c = Cluster(initialize_head=True, head_node_args=head_args or {"num_cpus": 1})
        # Head (GCS) is up with its env; later spawns must not inherit it.
        env_guard({k: None for k in (head_env or {})})
        handles = []
        for kw in nodes:
            kw = dict(kw)
            node_env = kw.pop("node_env", {})
            env_guard(node_env)
            handles.append(c.add_node(**kw))
            env_guard({k: None for k in node_env})
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address)
        created.append(c)
        return c, handles

    yield make
    ray_tpu_torch.shutdown()
    for c in created:
        c.shutdown()


def _nodes_by_id():
    from ray_tpu_torch.util import state

    return {n["node_id"]: n for n in state.list_nodes()}


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


# ==========================================================================
# 1. Plane determinism for the new fault axes
# ==========================================================================


def test_preempt_and_pubsub_rules_deterministic(env_guard):
    from ray_tpu_torch._private.chaos import ChaosPlane

    env_guard(
        {
            "RAY_TPU_TORCH_testing_chaos_spec": (
                "@raylet.tick:preempt:at=3:ms=2500,"
                "pubsub:nodes:drop_req:p=0.5:n=-1,"
                "pubsub:actors:delay_req:ms=20:n=2"
            ),
            "RAY_TPU_TORCH_testing_chaos_seed": "77",
        }
    )

    def drive(plane):
        out = []
        for _ in range(10):
            out.append(plane.maybe_preempt("raylet.tick"))
            out.append(plane.decide("pubsub:nodes", "req"))
            out.append(plane.decide("pubsub:actors", "req"))
        return out, plane.schedule_snapshot(), plane.schedule_digest()

    o1, s1, h1 = drive(ChaosPlane())
    o2, s2, h2 = drive(ChaosPlane())
    assert o1 == o2 and s1 == s2 and h1 == h2
    # The preempt rule fires exactly once, on the 3rd tick, with its
    # notice window (ms=2500).
    notices = [v for v in o1[0::3] if v is not None]
    assert notices == [2.5]
    assert o1[0::3][2] == 2.5  # the 3rd maybe_preempt call
    # The actors-channel delay rule fires on its first two matches only;
    # preempt rules never leak into request/reply decisions.
    actor_decisions = o1[2::3]
    assert [d.delay_s for d in actor_decisions[:2]] == [0.02, 0.02]
    assert all(d.clean for d in actor_decisions[2:])
    # pubsub drop rule fired at least once at p=0.5 over 10 matches.
    assert any(d.drop for d in o1[1::3])


# ==========================================================================
# 2. Core drain path (tier-1)
# ==========================================================================


def test_drain_node_migrates_actor_and_objects(drain_cluster):
    """drain_node: leases/bundles rejected on the draining raylet, the
    restartable actor is restarted elsewhere, the sole-copy object is
    re-replicated, and the node's death loses nothing."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.util import state

    c, handles = drain_cluster(
        head_args={"num_cpus": 1},
        nodes=[{"num_cpus": 2}, {"num_cpus": 2}],
    )
    worker = ray_tpu_torch._private.worker.get_global_worker()

    @ray_tpu_torch.remote(num_cpus=2, max_restarts=1)
    class Keeper:
        def make(self):
            return ray_tpu_torch.put(np.arange(150_000))

        def home(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    keeper = Keeper.remote()
    home = ray_tpu_torch.get(keeper.home.remote(), timeout=60)
    data_ref = ray_tpu_torch.get(keeper.make.remote(), timeout=60)

    reply = worker.gcs_client.call(
        "drain_node",
        {"node_id": bytes.fromhex(home), "reason": "PREEMPTION", "deadline_s": 25},
    )
    assert reply["accepted"] and reply["state"] == "DRAINING"
    # Idempotent: a duplicate drain joins the in-flight one.
    again = worker.gcs_client.call(
        "drain_node",
        {"node_id": bytes.fromhex(home), "reason": "PREEMPTION", "deadline_s": 25},
    )
    assert again["accepted"] and again["state"] == "DRAINING"

    rec = _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DRAINING"
        and _nodes_by_id()[home],
        15, "DRAINING in state API",
    )
    assert rec["drain_reason"] == "PREEMPTION"

    # No lease granted post-drain: a direct lease request against the
    # draining raylet is rejected (spill hint or flat refusal), and new
    # placement-group reservations are refused.
    raylet_addr = rec["raylet_address"]
    client = rpc.RpcClient(raylet_addr)
    try:
        lease = client.call(
            "request_worker_lease",
            {
                "resources": {"CPU": 1},
                "job_id": worker.job_id.binary(),
                "runtime_env": None,
                "token": os.urandom(16),
            },
            timeout=15,
        )
        assert not (lease and lease.get("worker_id")), lease
        assert lease and lease.get("draining")
        assert not client.call(
            "prepare_bundle",
            {"pg_id": b"drainpg", "bundle_index": 0, "resources": {"CPU": 1}},
            timeout=15,
        )
        stats = client.call("node_stats", {})
        assert stats["draining"] and stats["drain_reason"] == "PREEMPTION"
    finally:
        client.close()

    # Actor restarted elsewhere, proactively (node still alive!).
    _wait(
        lambda: any(
            a["state"] == "ALIVE"
            and a["node_id"] != home
            and a["class_name"].endswith("Keeper")
            for a in state.list_actors()
        ),
        30, "proactive actor migration",
    )
    assert ray_tpu_torch.get(keeper.home.remote(), timeout=60) != home

    # Migration (incl. object re-replication) completes before the kill.
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("drain_complete"),
        30, "drain_complete",
    )

    # Kill the drained node: DRAINING -> DEAD, and the object is still
    # readable from its replica — no ObjectLostError, no reconstruction.
    victim = next(
        h for h in handles if h.raylet_address == rec["raylet_address"]
    )
    c.remove_node(victim)
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DEAD",
        30, "DEAD after kill",
    )
    arr = ray_tpu_torch.get(data_ref, timeout=60)
    assert int(arr.sum()) == 11249925000


def test_drain_reschedules_created_pg_before_kill(drain_cluster):
    """A CREATED placement group with a bundle
    on a DRAINING node moves ONLY that bundle to a live node AHEAD of
    the kill — the unaffected bundle (and anything running in it) stays
    exactly where it was, instead of the whole group bouncing at node
    death."""
    from ray_tpu_torch.util.placement_group import placement_group

    c, handles = drain_cluster(
        head_args={"num_cpus": 1},
        nodes=[{"num_cpus": 2}, {"num_cpus": 2}, {"num_cpus": 2}],
    )
    worker = ray_tpu_torch._private.worker.get_global_worker()

    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="SPREAD")
    assert pg.wait(30)

    def pg_info():
        return worker.gcs_client.call("get_placement_group", pg.id.binary())

    info = pg_info()
    assert info["state"] == "CREATED"
    home = info["bundles"][0]["node_id"].hex()
    other = info["bundles"][1]["node_id"].hex()
    assert home != other  # SPREAD onto two of the three nodes

    reply = worker.gcs_client.call(
        "drain_node",
        {"node_id": bytes.fromhex(home), "reason": "PREEMPTION", "deadline_s": 30},
    )
    assert reply["accepted"]

    # Bundle 0 lands on the free third node while the drained one is
    # STILL DRAINING (proactive), back in CREATED state; bundle 1 has
    # not moved.
    def moved():
        i = pg_info()
        b0 = i["bundles"][0]["node_id"]
        return (
            i["state"] == "CREATED"
            and b0 is not None
            and b0.hex() != home
            and _nodes_by_id().get(home, {}).get("state") == "DRAINING"
        )

    _wait(moved, 20, "PG bundle rescheduled off the draining node pre-kill")
    assert pg_info()["bundles"][1]["node_id"].hex() == other, (
        "unaffected bundle must keep its reservation"
    )

    # The node's eventual death must NOT bounce the group again.
    victim = next(
        h for h in handles
        if h.raylet_address == _nodes_by_id()[home]["raylet_address"]
    )
    c.remove_node(victim)
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DEAD",
        30, "DEAD after kill",
    )
    final = pg_info()
    assert final["state"] == "CREATED"
    assert final["bundles"][0]["node_id"].hex() != home
    assert final["bundles"][1]["node_id"].hex() == other


# ==========================================================================
# 3. Drain-under-chaos matrix
# ==========================================================================


@pytest.mark.chaos
def test_preemption_notice_honored_zero_loss(drain_cluster):
    """A seeded preemption fault drains the node with advance notice:
    the actor and sole-copy object are off the node before the kill, so
    nothing is lost and nothing is reconstructed."""
    from ray_tpu_torch.util import state

    c, [doomed] = drain_cluster(
        head_args={"num_cpus": 1},
        nodes=[
            {
                "num_cpus": 2,
                # ~8 s of ticks of headroom to set the scene, then a 5 s
                # notice before the hard kill.
                "node_env": {
                    "RAY_TPU_TORCH_testing_chaos_spec": "@raylet.tick:preempt:at=40:ms=5000",
                    "RAY_TPU_TORCH_testing_chaos_seed": "1234",
                },
            }
        ],
    )

    @ray_tpu_torch.remote(num_cpus=2, max_restarts=1)
    class Keeper:
        def make(self):
            return ray_tpu_torch.put(np.full(120_000, 3.0))

        def home(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    keeper = Keeper.remote()  # only the doomed node has 2 free CPUs
    home = ray_tpu_torch.get(keeper.home.remote(), timeout=60)
    data_ref = ray_tpu_torch.get(keeper.make.remote(), timeout=60)

    # Migration target comes up while the preemption clock ticks.
    c.add_node(num_cpus=2)
    c.wait_for_nodes()

    # The chaos preemption delivers the drain notice on its own.
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") in ("DRAINING", "DEAD"),
        30, "chaos preemption drain notice",
    )
    assert _nodes_by_id()[home].get("drain_reason") == "PREEMPTION"
    # ...and the node dies at the deadline without any test-side kill.
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DEAD",
        40, "preempted node death at deadline",
    )

    # Zero loss: actor alive elsewhere (migrated, not reconstructed from
    # scratch), object readable with no ObjectLostError.
    _wait(
        lambda: any(
            a["state"] == "ALIVE" and a["node_id"] != home
            for a in state.list_actors()
            if a["class_name"].endswith("Keeper")
        ),
        60, "actor migrated off the preempted node",
    )
    arr = ray_tpu_torch.get(data_ref, timeout=60)
    assert float(arr.sum()) == 3.0 * 120_000
    assert ray_tpu_torch.get(keeper.home.remote(), timeout=60) != home


@pytest.mark.chaos
def test_preemption_notice_dropped_heartbeat_fallback(drain_cluster, tmp_path):
    """The drain notice itself is chaos-dropped at the GCS: the node
    dies with no warning and the REACTIVE path (disconnect/heartbeat ->
    node death -> lineage reconstruction) must still recover the work."""
    marker = str(tmp_path / "produced.log")
    c, [doomed] = drain_cluster(
        head_env={
            # The GCS never hears the drain: every drain_node request is
            # eaten.  Fast heartbeat so the fallback fires quickly.
            "RAY_TPU_TORCH_testing_chaos_spec": "drain_node:drop_req:n=-1",
            "RAY_TPU_TORCH_testing_chaos_seed": "9",
            "RAY_TPU_TORCH_health_check_timeout_ms": "4000",
        },
        head_args={"num_cpus": 2},
        nodes=[
            {
                "num_cpus": 2,
                "resources": {"doomed": 1},
                "node_env": {
                    "RAY_TPU_TORCH_testing_chaos_spec": "@raylet.tick:preempt:at=40:ms=2000",
                    "RAY_TPU_TORCH_testing_chaos_seed": "9",
                },
            }
        ],
    )

    @ray_tpu_torch.remote(resources={"doomed": 0.1}, max_retries=3)
    def produce():
        with open(marker, "a") as f:
            f.write("ran\n")
        return np.full(120_000, 7.0)

    ref = produce.remote()
    # Do NOT get() before the death: a fetch would replicate the result
    # to the head store and the kill would lose nothing.  The marker file
    # proves the task ran; the only copy stays on the doomed node.
    _wait(lambda: os.path.exists(marker), 60, "produce side effect")
    time.sleep(1.0)  # let the result seal + report its location

    home = None
    for n in _nodes_by_id().values():
        if n["resources_total"].get("doomed"):
            home = n["node_id"]
    assert home is not None

    # The node dies at its (unheard) deadline; the notice never landed,
    # so it goes straight ALIVE -> DEAD with no DRAINING in between.
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DEAD",
        60, "reactive death detection",
    )
    assert not _nodes_by_id()[home].get("drain_reason")

    # Replacement capacity; the owner's get repairs via lineage.
    c.remove_node(doomed)  # reap the self-killed node's handle
    c.add_node(num_cpus=2, resources={"doomed": 1})
    c.wait_for_nodes()
    assert float(ray_tpu_torch.get(ref, timeout=120).sum()) == 7.0 * 120_000
    with open(marker) as f:
        runs = len(f.readlines())
    assert runs == 2, f"expected a lineage re-run (got {runs} execution(s))"


@pytest.mark.chaos
def test_drain_deadline_expiry_mid_task(drain_cluster):
    """Tasks still running when the preemption deadline kills the node
    are retried via the idempotent submit machinery and all complete."""
    drain_cluster(
        head_args={"num_cpus": 2},
        nodes=[
            {
                "num_cpus": 2,
                "node_env": {
                    "RAY_TPU_TORCH_testing_chaos_spec": "@raylet.tick:preempt:at=25:ms=1500",
                    "RAY_TPU_TORCH_testing_chaos_seed": "4321",
                },
            }
        ],
    )

    @ray_tpu_torch.remote(max_retries=5)
    def slow(i):
        time.sleep(0.4)
        return i * 11

    refs = [slow.remote(i) for i in range(16)]  # spreads across both nodes
    out = ray_tpu_torch.get(refs, timeout=180)
    assert out == [i * 11 for i in range(16)]


@pytest.mark.chaos
def test_pubsub_drain_notice_dropped(drain_cluster):
    """Pubsub deliveries route through the chaos plane — the
    nodes-channel DRAINING notice is dropped, so subscribers (the
    driver's node listeners) never hear it, while the GCS-side drain and
    the reactive death path still converge."""
    c, [node] = drain_cluster(
        head_env={
            # Drop every nodes-channel publish AFTER the two ALIVE
            # registrations (head + worker) that wait_for_nodes needs.
            "RAY_TPU_TORCH_testing_chaos_spec": "pubsub:nodes:drop_req:after=2:n=-1",
            "RAY_TPU_TORCH_testing_chaos_seed": "3",
        },
        head_args={"num_cpus": 2},
        nodes=[{"num_cpus": 1, "resources": {"side": 1}}],
    )
    worker = ray_tpu_torch._private.worker.get_global_worker()
    heard = []
    worker.add_node_listener(lambda state_, node_: heard.append(state_))

    home = None
    for n in _nodes_by_id().values():
        if n["resources_total"].get("side"):
            home = n["node_id"]
    reply = worker.gcs_client.call(
        "drain_node",
        {"node_id": bytes.fromhex(home), "reason": "IDLE_TERMINATION", "deadline_s": 10},
    )
    assert reply["accepted"]
    # The GCS itself drains (RPC-visible state), but the pubsub notice
    # never reaches subscribers.
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DRAINING",
        15, "RPC-visible DRAINING",
    )
    time.sleep(1.0)
    assert "DRAINING" not in heard, heard
    # Reactive fallback: the kill is still detected and the node dies.
    c.remove_node(node)
    _wait(
        lambda: _nodes_by_id().get(home, {}).get("state") == "DEAD",
        30, "reactive DEAD without pubsub",
    )


# ==========================================================================
# TorchTrainer proactive-checkpoint drill
# ==========================================================================


def _drain_ckpt_loop(config):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    resume = train.get_checkpoint()
    start = 0
    resumed_from = -1
    if resume is not None:
        resumed_from = resume.to_pytree()["step"]
        start = resumed_from
    node_id = ray_tpu_torch.get_runtime_context().get_node_id()
    drain_ckpt_done = resumed_from >= 0
    for step in range(start + 1, config["total_steps"] + 1):
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.15)
        ckpt = None
        if step == config["periodic_step"] and resumed_from < 0:
            ckpt = Checkpoint.from_pytree({"step": step})  # periodic
        if ctx.drain_requested() and not drain_ckpt_done:
            # Immediate best-effort checkpoint at the drain notice.
            ckpt = Checkpoint.from_pytree({"step": step})
            drain_ckpt_done = True
        with open(config["progress"], "w") as f:
            f.write(f"{node_id} {step}")
        train.report({"step": step, "resumed_from": resumed_from}, checkpoint=ckpt)


@pytest.mark.chaos
def test_torchtrainer_drain_proactive_checkpoint(drain_cluster, tmp_path):
    """A drain notice covering a rank triggers an immediate checkpoint +
    one proactive whole-group restart: the run resumes from a step
    STRICTLY AFTER the last periodic checkpoint and, with
    max_failures=0, provably burns none of the failure budget."""
    from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    c, _handles = drain_cluster(
        head_args={"num_cpus": 1},
        nodes=[{"num_cpus": 2}, {"num_cpus": 2}],
    )
    worker = ray_tpu_torch._private.worker.get_global_worker()
    progress = str(tmp_path / "progress")
    periodic_step = 5

    stop = threading.Event()
    drained_node = []

    def drainer():
        # Once the loop passes step 8, drain the node hosting the rank.
        while not stop.is_set():
            # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
            try:
                with open(progress) as f:
                    node_id, step = f.read().split()
                if int(step) >= 8:
                    worker.gcs_client.call(
                        "drain_node",
                        {
                            "node_id": bytes.fromhex(node_id),
                            "reason": "PREEMPTION",
                            "deadline_s": 60,
                        },
                    )
                    drained_node.append(node_id)
                    return
            except (OSError, ValueError):
                pass
            # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
            time.sleep(0.1)

    t = threading.Thread(target=drainer, daemon=True)
    t.start()
    try:
        trainer = TorchTrainer(
            _drain_ckpt_loop,
            train_loop_config={
                "total_steps": 20,
                "periodic_step": periodic_step,
                "progress": progress,
            },
            scaling_config=ScalingConfig(
                num_workers=1, resources_per_worker={"CPU": 2}
            ),
            run_config=RunConfig(
                name="drain_ckpt",
                storage_path=str(tmp_path),
                # ZERO failure budget: if the proactive path failed and
                # the restart were charged as a failure, fit() raises.
                failure_config=FailureConfig(max_failures=0),
            ),
        )
        result = trainer.fit()
    finally:
        stop.set()
        t.join(timeout=5)

    assert drained_node, "the drill never drained a node"
    assert result.metrics["step"] == 20
    resumed_from = result.metrics["resumed_from"]
    # Resumed from the drain-triggered checkpoint (taken at step >= 8),
    # strictly ahead of the last periodic checkpoint (step 5).
    assert resumed_from >= 8, result.metrics
    assert resumed_from > periodic_step
