"""Multi-tenant job plane on the port (a copy of the JAX package's
tests/test_tenants.py; it imports neither JAX nor the JAX package):
quotas, DRF fair-share lease
scheduling, and safe priority preemption.

Layers drilled here:

1. Pure model math (``_private/tenants.py``): dominant shares, quota
   checks, and the fair-share pick order (no intra-tenant queue-jumping,
   over-quota tenants skipped, work conservation across tenants).
2. Tier-1 quota plane: registry RPCs, admission parking + resume,
   typed backpressure (``QuotaExceededError``), and the accounting edge
   cases — actor restarts don't double-charge, PG bundles spanning
   nodes charge once, detached actors outlive their driver and keep
   charging their tenant, elastic grow is blocked at a quota boundary
   and resumes when the quota rises.
3. Chaos acceptance (``-m chaos``):
   - 3 competing tenants with unequal quotas under sustained demand:
     steady-state usage respects quotas within 10%, and a mid-drill
     node kill does not let any tenant exceed its quota after recovery;
   - a high-priority submission preempts a low-priority elastic trainer
     via checkpoint-and-shrink: no lost work (final-loss parity), no
     charge to ``FailureConfig.max_failures``.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import tenants as tenants_mod
from ray_tpu_torch._private.common import ResourceSet
from ray_tpu_torch.cluster_utils import Cluster


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        # graftlint: disable=retry-gate -- deadline-bounded assertion poll; 0.2 s is the scan resolution, not a retry delay
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def tenant_cluster():
    """Head + optional worker nodes with tenant-plane env knobs applied
    for every spawned process (config rides child_env)."""
    created = []
    saved_env = {}

    def set_env(env):
        for k, v in env.items():
            saved_env.setdefault(k, os.environ.get(k))
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # The suite runs many clusters at once: no 2 GiB shm arena prefault,
    # and no memory monitor, which watches the whole machine.  The drills'
    # driver subprocesses inherit these too.
    set_env(
        {
            "RAY_TPU_TORCH_arena_prefault_bytes": "0",
            "RAY_TPU_TORCH_memory_monitor_enabled": "0",
        }
    )

    def make(head_args=None, nodes=(), env=None, **init_kwargs):
        set_env(env or {})
        c = Cluster(initialize_head=True, head_node_args=head_args or {"num_cpus": 4})
        handles = [c.add_node(**dict(kw)) for kw in nodes]
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address, **init_kwargs)
        created.append(c)
        return c, handles

    yield make
    ray_tpu_torch.shutdown()
    for c in created:
        c.shutdown()
    for k, old in saved_env.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old


def _gcs():
    return ray_tpu_torch._private.worker.get_global_worker().gcs_client


def _tenant_view(name):
    for t in _gcs().call("list_tenants", None):
        if t["name"] == name:
            return t
    return None


def _usage_cpu(name):
    t = _tenant_view(name)
    return (t or {}).get("usage", {}).get("CPU", 0.0)


# ==========================================================================
# 1. pure model math
# ==========================================================================


def test_dominant_share_and_quota_math():
    totals = {"CPU": 10.0, "TPU": 4.0}
    assert tenants_mod.dominant_share({"CPU": 5.0}, totals) == 0.5
    # Dominant = the max share across resources.
    assert tenants_mod.dominant_share({"CPU": 2.0, "TPU": 2.0}, totals) == 0.5
    # Weight divides the share (weight 2 = entitled to twice as much).
    assert tenants_mod.dominant_share({"CPU": 5.0}, totals, weight=2.0) == 0.25
    # Resources the cluster doesn't have are ignored.
    assert tenants_mod.dominant_share({"accel": 3.0}, totals) == 0.0
    assert not tenants_mod.over_quota({"CPU": 1.0}, {"CPU": 1.0}, {"CPU": 2.0})
    assert tenants_mod.over_quota({"CPU": 1.5}, {"CPU": 1.0}, {"CPU": 2.0})
    # Empty quota = unlimited.
    assert not tenants_mod.over_quota({"CPU": 99.0}, None, {})


class _Fut:
    def done(self):
        return False


def _w(cpu, tenant, priority=0, seq=0):
    return tenants_mod.LeaseWaiter(
        res=ResourceSet.of({"CPU": cpu}), fut=_Fut(), tenant=tenant,
        priority=priority, seq=seq,
    )


def test_pick_next_drf_order_and_priority():
    totals = {"CPU": 8.0}
    avail = ResourceSet.of({"CPU": 4})
    # B has the lower dominant share -> B goes first despite higher seq.
    usage = {"a": {"CPU": 4.0}, "b": {"CPU": 1.0}}
    waiters = [_w(1, "a", seq=1), _w(1, "b", seq=2)]
    assert tenants_mod.pick_next(waiters, avail, usage, totals, {}).tenant == "b"
    # Within one tenant, priority wins, then FIFO.
    waiters = [_w(1, "a", priority=0, seq=1), _w(1, "a", priority=5, seq=9)]
    assert tenants_mod.pick_next(waiters, avail, usage, totals, {}).priority == 5


def test_pick_next_no_intra_tenant_queue_jumping():
    """A tenant's big parked head blocks its OWN later small requests
    (anti-starvation), but not other tenants (work conservation)."""
    totals = {"CPU": 8.0}
    avail = ResourceSet.of({"CPU": 2})
    usage = {"a": {"CPU": 0.0}, "b": {"CPU": 4.0}}
    big_a = _w(4, "a", seq=1)   # does not fit
    small_a = _w(1, "a", seq=2)  # must NOT jump its own queue
    small_b = _w(1, "b", seq=3)  # other tenant: may proceed
    got = tenants_mod.pick_next([big_a, small_a, small_b], avail, usage, totals, {})
    assert got is small_b


def test_pick_next_skips_over_quota_tenant():
    totals = {"CPU": 8.0}
    avail = ResourceSet.of({"CPU": 4})
    specs = {
        "a": tenants_mod.TenantSpec("a", quota=ResourceSet.of({"CPU": 2})),
    }
    usage = {"a": {"CPU": 2.0}, "b": {"CPU": 3.0}}
    waiters = [_w(1, "a", seq=1), _w(1, "b", seq=2)]
    got = tenants_mod.pick_next(waiters, avail, usage, totals, specs)
    assert got.tenant == "b"
    # Quota enforcement off: DRF order alone decides (a has lower share).
    got = tenants_mod.pick_next(
        waiters, avail, usage, totals, specs, enforce_quota=False
    )
    assert got.tenant == "a"


def test_preemption_victim_order():
    totals = {"CPU": 8.0}
    specs = {"over": tenants_mod.TenantSpec("over", quota=ResourceSet.of({"CPU": 1}))}
    usage = {"over": {"CPU": 2.0}, "big": {"CPU": 5.0}, "small": {"CPU": 1.0}}
    jobs = [
        {"tenant": "small", "priority": 0, "start_time": 3.0},
        {"tenant": "big", "priority": 0, "start_time": 2.0},
        {"tenant": "over", "priority": 1, "start_time": 1.0},
    ]
    ordered = tenants_mod.preemption_victim_order(jobs, usage, totals, specs)
    # Over-quota first (despite higher priority), then highest share.
    assert [j["tenant"] for j in ordered] == ["over", "big", "small"]


def test_fair_dispatch_order():
    """The raylet-mediated dispatch queue's ordering rule: (priority,
    FIFO) within a tenant, round-robin across
    tenants ascending dominant share."""
    totals = {"CPU": 8.0}
    usage = {"hog": {"CPU": 6.0}, "light": {"CPU": 1.0}}
    # entries: (tenant, priority, seq, item)
    entries = [
        ("hog", 0, 1, "h1"),
        ("hog", 0, 2, "h2"),
        ("hog", 5, 3, "h3-prio"),
        ("light", 0, 4, "l1"),
        ("light", 0, 5, "l2"),
    ]
    out = tenants_mod.fair_dispatch_order(entries, usage, totals, {})
    # light (lower share) leads each round; hog's high-priority task
    # jumps hog's own FIFO but NOT light's turn.
    assert out == ["l1", "h3-prio", "l2", "h1", "h2"]
    # weight raises effective fair share: a weighted hog wins the tie
    specs = {"hog": tenants_mod.TenantSpec("hog", weight=10.0)}
    out = tenants_mod.fair_dispatch_order(entries, usage, totals, specs)
    assert out[0] == "h3-prio"
    # empty usage: pure (priority, FIFO) interleave, deterministic
    assert tenants_mod.fair_dispatch_order([], {}, totals, {}) == []


def test_fair_dispatch_order_single_tenant_is_priority_fifo():
    """Degenerate case (one job/tenant): ordering reduces to the queue's
    existing (priority, FIFO) semantics — no behavior change."""
    entries = [("t", 0, 1, "a"), ("t", 2, 2, "b"), ("t", 0, 3, "c")]
    out = tenants_mod.fair_dispatch_order(entries, {}, {"CPU": 4.0}, {})
    assert out == ["b", "a", "c"]


def test_tenant_label_bounded():
    assert tenants_mod.tenant_label("teamA", {"teamA"}) == "teamA"
    assert tenants_mod.tenant_label("randomX", {"teamA"}) == "other"
    assert tenants_mod.tenant_label(None, ()) == "default"
    assert tenants_mod.resource_label("CPU") == "CPU"
    assert tenants_mod.resource_label("node:10.0.0.1") == "other"


# ==========================================================================
# 2. tier-1 quota plane
# ==========================================================================


@ray_tpu_torch.remote(num_cpus=1)
class _Holder:
    def ping(self):
        return "ok"

    def pid(self):
        return os.getpid()


def test_quota_registry_and_usage(tenant_cluster):
    tenant_cluster(head_args={"num_cpus": 4}, tenant="teamA")
    out = _gcs().call(
        "tenant_set_quota",
        {"tenant": "teamA", "quota": {"CPU": 2}, "weight": 2.0, "priority": 1},
    )
    assert out["quota"] == {"CPU": 2.0} and out["weight"] == 2.0
    a = _Holder.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "ok"
    _wait(lambda: _usage_cpu("teamA") == 1.0, 10, "usage to reflect the actor")
    view = _tenant_view("teamA")
    assert view["dominant_share"] > 0
    got = _gcs().call("get_tenant", "teamA")
    assert got["quota"] == {"CPU": 2.0}


def test_quota_parks_actor_and_resumes(tenant_cluster):
    tenant_cluster(head_args={"num_cpus": 4}, tenant="teamA")
    _gcs().call("tenant_set_quota", {"tenant": "teamA", "quota": {"CPU": 2}})
    a1, a2 = _Holder.remote(), _Holder.remote()
    assert ray_tpu_torch.get([a1.ping.remote(), a2.ping.remote()]) == ["ok", "ok"]
    a3 = _Holder.remote()  # over quota: parks, does not fail
    _wait(lambda: (_tenant_view("teamA") or {}).get("parked") == 1, 10, "a3 to park")
    # Parked means parked — it never came up.
    with pytest.raises(Exception):
        ray_tpu_torch.get(a3.ping.remote(), timeout=1.5)
    ray_tpu_torch.kill(a1)
    # Freed quota admits the parked actor.
    assert ray_tpu_torch.get(a3.ping.remote(), timeout=30) == "ok"
    _wait(lambda: (_tenant_view("teamA") or {}).get("parked") == 0, 10, "unpark")
    # Settle: the optimistic admission ledger overlaps the raylet report
    # for <1 s after an admission — steady state is back at the quota.
    _wait(lambda: _usage_cpu("teamA") <= 2.0 + 1e-6, 10, "usage settle")


def test_quota_backpressure_typed_error(tenant_cluster):
    from ray_tpu_torch.exceptions import QuotaExceededError

    tenant_cluster(
        head_args={"num_cpus": 4},
        env={"RAY_TPU_TORCH_tenant_max_parked": "1"},
        tenant="teamB",
    )
    _gcs().call("tenant_set_quota", {"tenant": "teamB", "quota": {"CPU": 1}})
    a1 = _Holder.remote()
    assert ray_tpu_torch.get(a1.ping.remote()) == "ok"
    a2 = _Holder.remote()  # parks (1 allowed)
    _wait(lambda: (_tenant_view("teamB") or {}).get("parked") == 1, 10, "a2 to park")
    # Third admission: parked queue is full -> typed fail-fast.
    with pytest.raises(QuotaExceededError):
        _Holder.remote()
    del a2


def _try(fn):
    try:
        return fn()
    except Exception:
        return None


def test_actor_restart_not_double_charged(tenant_cluster):
    tenant_cluster(head_args={"num_cpus": 4}, tenant="teamC")
    _gcs().call("tenant_set_quota", {"tenant": "teamC", "quota": {"CPU": 3}})
    a = _Holder.options(max_restarts=2).remote()
    pid = ray_tpu_torch.get(a.pid.remote())
    _wait(lambda: _usage_cpu("teamC") == 1.0, 10, "initial charge")
    os.kill(pid, 9)

    def restarted_pid():
        p = _try(lambda: ray_tpu_torch.get(a.pid.remote(), timeout=2))
        return p if p and p != pid else None

    # The restarted incarnation answers from a NEW pid...
    new_pid = _wait(restarted_pid, 60, "actor restart")
    assert new_pid != pid
    # ... and the tenant is charged exactly once, not per incarnation.
    time.sleep(1.0)
    _wait(lambda: _usage_cpu("teamC") == 1.0, 10, "single charge after restart")


def test_pg_bundles_spanning_nodes_charged_once(tenant_cluster):
    from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group

    tenant_cluster(
        head_args={"num_cpus": 2},
        nodes=[{"num_cpus": 2}, {"num_cpus": 2}],
        tenant="teamPG",
    )
    _gcs().call("tenant_set_quota", {"tenant": "teamPG", "quota": {"CPU": 4}})
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=60)
    # Both bundles (spanning two nodes) charge the tenant: 4 CPUs total.
    _wait(lambda: _usage_cpu("teamPG") == 4.0, 10, "PG reservation charged")
    # A second PG would exceed the quota: it parks PENDING.
    pg2 = placement_group([{"CPU": 1}])
    assert not pg2.wait(timeout_seconds=3)
    remove_placement_group(pg)
    # Freed reservation admits the parked group.
    assert pg2.wait(timeout_seconds=60)
    _wait(lambda: _usage_cpu("teamPG") == 1.0, 10, "usage after remove")
    remove_placement_group(pg2)


def test_detached_actor_outlives_driver_and_charges_tenant(tenant_cluster):
    c, _ = tenant_cluster(
        head_args={"num_cpus": 4}, tenant="ops", namespace="opsns"
    )
    script = textwrap.dedent(
        """
        import ray_tpu_torch, sys
        ray_tpu_torch.init(address=sys.argv[1], tenant="ops", namespace="opsns")

        @ray_tpu_torch.remote(num_cpus=1)
        class Keeper:
            def ping(self):
                return "alive"

        k = Keeper.options(name="keeper", lifetime="detached").remote()
        assert ray_tpu_torch.get(k.ping.remote()) == "alive"
        ray_tpu_torch.shutdown()
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script, c.address],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    # The creating driver is gone; the detached actor still answers from
    # another job's driver, and its tenant stays charged.
    k = _wait(
        lambda: _try(lambda: ray_tpu_torch.get_actor("keeper", namespace="opsns")),
        30, "detached actor lookup",
    )
    assert ray_tpu_torch.get(k.ping.remote(), timeout=10) == "alive"
    _wait(lambda: _usage_cpu("ops") == 1.0, 15, "detached actor still charged")
    ray_tpu_torch.kill(k)
    _wait(lambda: _usage_cpu("ops") == 0.0, 15, "charge released on kill")


def test_elastic_grow_blocked_at_quota_boundary(tenant_cluster):
    """Elastic shrink/grow crossing a quota boundary: a group shrunk
    within quota cannot grow past it — the grow's actors park and the
    batch times out (group unchanged); raising the quota admits them."""
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup

    tenant_cluster(head_args={"num_cpus": 4}, tenant="train")
    _gcs().call("tenant_set_quota", {"tenant": "train", "quota": {"CPU": 2}})
    group = WorkerGroup(2, {"CPU": 1})
    assert len(group.alive_ranks(timeout=60)) == 2
    _wait(lambda: _usage_cpu("train") == 2.0, 10, "group charged")
    # Shrink within quota...
    group.remove_ranks([1])
    _wait(lambda: _usage_cpu("train") == 1.0, 10, "shrink released quota")
    # ...grow back: first +1 fits the quota, the second crosses it.
    assert group.add_workers(1, ready_timeout=30.0) == 1
    assert group.add_workers(1, ready_timeout=4.0) == 0  # parked, timed out
    assert len(group.workers) == 2
    # Raise the quota: the next grow attempt succeeds.
    _gcs().call("tenant_set_quota", {"tenant": "train", "quota": {"CPU": 3}})
    assert group.add_workers(1, ready_timeout=60.0) == 1
    assert len(group.workers) == 3
    group.shutdown()


def test_lost_capacity_published_for_noticeless_node_death(tenant_cluster):
    """A worker node that dies WITHOUT a drain
    notice (heartbeat-timeout / connection-close DEAD) still lands in
    the autoscaler's lost_capacity replacement feed, tagged NODE_DEATH —
    only planned IDLE_TERMINATION capacity is excluded."""
    c, handles = tenant_cluster(head_args={"num_cpus": 2}, nodes=[{"num_cpus": 2}])
    c.remove_node(handles[0])  # hard kill: no drain, no notice

    def lost():
        lm = _gcs().call("get_load_metrics", None)
        return [
            e for e in lm.get("lost_capacity", ())
            if e.get("reason") == "NODE_DEATH"
        ]
    records = _wait(lambda: lost() or None, 30, "NODE_DEATH lost_capacity record")
    assert records[0]["resources_total"].get("CPU") == 2.0


# ==========================================================================
# 3. chaos acceptance drills
# ==========================================================================


_LOAD_DRIVER = textwrap.dedent(
    """
    import sys, time
    import ray_tpu_torch

    addr, tenant, prio, inflight, secs = (
        sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
        float(sys.argv[5]),
    )
    ray_tpu_torch.init(address=addr, tenant=tenant, priority=prio)

    @ray_tpu_torch.remote(num_cpus=1, max_retries=-1)
    def burn(t):
        time.sleep(t)
        return 1

    pending = []
    deadline = time.time() + secs
    while time.time() < deadline:
        while len(pending) < inflight:
            pending.append(burn.remote(0.2))
        _done, pending = ray_tpu_torch.wait(
            pending, num_returns=1, timeout=1.0
        )
    ray_tpu_torch.shutdown()
    """
)


@pytest.mark.chaos
@pytest.mark.slow  # ~45 s sustained-demand drill: runs under `-m chaos`
def test_three_tenant_fairness_quotas_and_node_kill(tenant_cluster, tmp_path):
    """The acceptance drill: tenants A/B/C with unequal quotas (6/3/3)
    saturate a 12-CPU cluster with sustained 1-CPU task demand.  Steady
    state: each tenant's average usage is its quota within 10%, and no
    instantaneous sample ever exceeds a quota.  Mid-drill, a worker node
    is killed (12 -> 8 CPUs): after recovery no tenant exceeds its
    quota."""
    c, handles = tenant_cluster(
        head_args={"num_cpus": 8}, nodes=[{"num_cpus": 4}]
    )
    gcs = _gcs()
    quotas = {"tA": 6.0, "tB": 3.0, "tC": 3.0}
    for name, q in quotas.items():
        gcs.call("tenant_set_quota", {"tenant": name, "quota": {"CPU": q}})

    drill_s = 40.0
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _LOAD_DRIVER, c.address, name, "0", "10",
             str(drill_s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in quotas
    ]
    try:
        # Warm up, then sample steady state.
        samples = {name: [] for name in quotas}
        t0 = time.monotonic()
        time.sleep(8.0)
        while time.monotonic() - t0 < 18.0:
            for name in quotas:
                samples[name].append(_usage_cpu(name))
            # graftlint: disable=retry-gate -- fixed sampling cadence of the drill's usage time series
            time.sleep(0.4)
        for name, q in quotas.items():
            avg = sum(samples[name]) / max(1, len(samples[name]))
            assert abs(avg - q) <= 0.1 * q + 0.3, (
                f"{name}: steady-state usage {avg:.2f} not within 10% of "
                f"quota {q} (samples={samples[name][-8:]})"
            )
            # Hard bound with a one-sample grace: the cross-raylet grant
            # race can overshoot for <1 s before the reconciliation loop
            # revokes the excess lease — a PERSISTENT overshoot fails.
            over = [u for u in samples[name] if u > q + 1e-6]
            assert len(over) <= 2, (
                f"{name}: quota {q} exceeded persistently: {over}"
            )

        # Mid-drill node kill: 12 -> 8 CPUs.
        c.remove_node(handles[0])
        time.sleep(6.0)  # recovery: retries re-lease on the survivor
        post = {name: [] for name in quotas}
        while time.monotonic() - t0 < drill_s - 2:
            for name in quotas:
                u = _usage_cpu(name)
                post[name].append(u)
                assert u <= quotas[name] + 1e-6, (
                    f"{name} exceeded quota after node kill: {u}"
                )
            # graftlint: disable=retry-gate -- fixed sampling cadence of the drill's usage time series
            time.sleep(0.4)
        # The survivor's 8 CPUs are still being used (work conservation).
        assert any(sum(p) > 0 for p in post.values())
    finally:
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()


_URGENT_DRIVER = textwrap.dedent(
    """
    import sys, time
    import ray_tpu_torch

    addr = sys.argv[1]
    ray_tpu_torch.init(address=addr, tenant="urgent", priority=5)

    @ray_tpu_torch.remote(num_cpus=1)
    class Rush:
        def ping(self):
            return "ok"

    # Two 1-CPU actors against a cluster where the low-priority elastic
    # trainer holds all but one CPU: the second actor starves until the
    # preemption plane shrinks the trainer.
    actors = [Rush.remote() for _ in range(2)]
    got = ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=90)
    assert got == ["ok", "ok"], got
    time.sleep(2)
    ray_tpu_torch.shutdown()
    """
)


@pytest.mark.chaos
@pytest.mark.slow  # ~20 s trainer drill: runs under `-m chaos`
def test_priority_preemption_elastic_checkpoint_shrink(tenant_cluster, tmp_path):
    """A high-priority submission preempts a low-priority elastic
    trainer through checkpoint-and-shrink: the urgent job's actors come
    up, the trainer finishes every step (final-loss parity = no lost
    work) at a reduced world size, and nothing is charged to
    max_failures (max_failures=0 would raise on any charge)."""
    from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer
    from ray_tpu_torch.train import Checkpoint  # noqa: F401 (exercised in loop)

    c, _ = tenant_cluster(
        head_args={"num_cpus": 4},
        env={
            "RAY_TPU_TORCH_preemption_grace_s": "3",
            "RAY_TPU_TORCH_preemption_check_period_ms": "300",
        },
        tenant="train",
        priority=0,
    )
    progress_dir = str(tmp_path / "progress")
    os.makedirs(progress_dir, exist_ok=True)
    total_steps = 60

    def loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        ctx = train.get_context()
        resume = train.get_checkpoint()
        start = resume.to_pytree()["step"] if resume is not None else 0
        for step in range(start + 1, config["total_steps"] + 1):
            # graftlint: disable=retry-gate -- simulated train-step duration, not a retry delay
            time.sleep(0.15)
            # Deterministic loss: parity proves no step was lost/redone.
            loss = 1.0 / step
            ckpt = Checkpoint.from_pytree({"step": step})
            with open(
                os.path.join(config["progress_dir"], f"rank_{ctx.get_world_rank()}"),
                "w",
            ) as f:
                f.write(f"{step} {ctx.get_world_size()}")
            train.report(
                {"step": step, "loss": loss, "world_size": ctx.get_world_size()},
                checkpoint=ckpt,
            )

    urgent = {}

    def rank0_step():
        raw = _try(
            lambda: open(os.path.join(progress_dir, "rank_0")).read().split()
        )
        return int(raw[0]) if raw else 0

    def launch_urgent():
        # Wait for the trainer to make some progress first.
        _wait(lambda: rank0_step() >= 3, 60, "trainer progress")
        urgent["proc"] = subprocess.run(
            [sys.executable, "-c", _URGENT_DRIVER, c.address],
            capture_output=True, text=True, timeout=180,
        )

    t = threading.Thread(target=launch_urgent, daemon=True)
    t.start()
    trainer = TorchTrainer(
        loop,
        train_loop_config={
            "total_steps": total_steps, "progress_dir": progress_dir,
        },
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(
            num_workers=3, min_workers=1, resources_per_worker={"CPU": 1}
        ),
        run_config=RunConfig(
            name="preempt_shrink",
            storage_path=str(tmp_path),
            # ZERO budget: any charged restart raises TrainingFailedError.
            failure_config=FailureConfig(max_failures=0),
        ),
    )
    result = trainer.fit()
    t.join(timeout=120)

    proc = urgent.get("proc")
    assert proc is not None, "urgent driver never launched"
    assert proc.returncode == 0, proc.stderr[-2000:] or proc.stdout[-2000:]
    # No lost work: the deterministic loss landed exactly on the last step.
    assert result.metrics["step"] == total_steps
    assert result.metrics["loss"] == 1.0 / total_steps
    # The trainer really shrank for the urgent job.
    assert result.metrics["world_size"] < 3
    from ray_tpu_torch.util import metrics as metrics_mod

    shrank = sum(
        rec.get("value", 0.0)
        for (name, tags), rec in metrics_mod._registry.items()
        if name == "train_resize_events_total"
        and ("trigger", "preempt") in tuple(tags)
    )
    assert shrank >= 1, "no preempt-triggered resize recorded"


def test_lease_ledger_prevents_cross_raylet_over_admission(tenant_cluster):
    """Regression (charge-at-admission ledger): when a
    tenant's quota exceeds one node's capacity, its demand spills to a
    peer raylet whose usage view is a report period (~1 s) stale — both
    raylets could grant against the same headroom, over-admitting past
    the quota until cooperative revocation mopped up.  Here revocation
    is DISABLED (chaos drops every revoke_lease push) and the holds are
    long, so any over-admission is persistent and visible: the GCS
    lease-admission ledger (charge at admission, reconcile on report)
    alone must keep concurrent usage at/below the quota."""
    tenant_cluster(
        head_args={"num_cpus": 4},
        nodes=[{"num_cpus": 4}],
        env={"RAY_TPU_TORCH_testing_chaos_spec": "revoke_lease:drop_req:n=-1"},
        tenant="teamQ",
    )
    # quota 6 > head's 4 CPUs: demand past 4 spills to the worker raylet
    _gcs().call("tenant_set_quota", {"tenant": "teamQ", "quota": {"CPU": 6}})

    @ray_tpu_torch.remote(num_cpus=1)
    def hold(t):
        time.sleep(t)
        return 1

    refs = [hold.remote(25.0) for _ in range(10)]
    try:
        overshoot = []  # (t, usage) samples above quota
        peak = 0.0
        t0 = time.monotonic()
        while time.monotonic() - t0 < 8.0:
            u = _usage_cpu("teamQ")
            peak = max(peak, u)
            if u > 6.0 + 1e-6:
                overshoot.append((round(time.monotonic() - t0, 1), u))
            # graftlint: disable=retry-gate -- fixed sampling cadence of the drill's usage time series
            time.sleep(0.2)
        # Pre-ledger behavior: both raylets grant into the same headroom
        # and usage sits at 7-8 for the WHOLE 30 s hold (revocation is
        # disabled, so nothing can mop an excess lease up — persistence
        # IS the over-admission signal).  With charge-at-admission the
        # only tolerated artifact is the grant-burst accounting overlap
        # (ledger entry + report both carrying a fresh lease for a few
        # hundred ms) — never a persistent excess lease.
        assert not [o for o in overshoot if o[0] > 2.5], (
            f"over-admission persisted past the grant burst: {overshoot}"
        )
        # work conservation: the plane still filled the quota across nodes
        assert peak >= 5.0, f"peak usage only {peak}"
    finally:
        for r in refs:
            try:
                ray_tpu_torch.cancel(r, force=True)
            except Exception:
                pass
