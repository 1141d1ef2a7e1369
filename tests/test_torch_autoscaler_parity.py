"""The port's autoscaler and dashboard helpers held to the JAX package's
on the same inputs, made with numpy from a seed: the demand scheduler
(``get_nodes_to_launch``), the capacity-return and grow-hint helpers
(``pick_replacement_type``, ``replacement_launches``,
``fold_grow_hints``), v1's reconcile pass, v2's ``InstanceManager``
transitions and refusals, the Grafana factory and the usage report.
Results are equal exactly; the usage report's one stated difference is
that the port counts ``GPU`` where the reference counts ``TPU``.

No cluster: every function here is pure or runs against an in-memory
provider."""

import copy

import numpy as np
import pytest

import ray_tpu.autoscaler.autoscaler as ref_v1
import ray_tpu.autoscaler.resource_demand_scheduler as ref_rds
import ray_tpu.autoscaler.v2.instance_manager as ref_im
import ray_tpu.dashboard.grafana_dashboard_factory as ref_grafana
import ray_tpu.dashboard.usage_stats as ref_usage
import ray_tpu_torch.autoscaler.autoscaler as port_v1
import ray_tpu_torch.autoscaler.resource_demand_scheduler as port_rds
import ray_tpu_torch.autoscaler.v2.instance_manager as port_im
import ray_tpu_torch.dashboard.grafana_dashboard_factory as port_grafana
import ray_tpu_torch.dashboard.usage_stats as port_usage

_KINDS = ("CPU", "GPU", "memory", "accel-slot")


def _shape(rng, kinds=_KINDS, lo=0, hi=5) -> dict:
    out = {}
    for k in kinds:
        if rng.random() < 0.6:
            out[k] = float(rng.integers(lo, hi))
    return out or {"CPU": 1.0}


def _node_types(rng) -> dict:
    types = {}
    for i in range(int(rng.integers(1, 5))):
        spec = {"resources": {"CPU": float(rng.integers(1, 9)), **_shape(rng, lo=1, hi=9)}}
        if rng.random() < 0.3:
            spec["max_workers"] = int(rng.integers(0, 3))
        types[f"type{i}"] = spec
    return types


def _scheduler_case(seed: int):
    rng = np.random.default_rng(seed)
    types = _node_types(rng)
    demands = [_shape(rng, kinds=("CPU", "GPU", "accel-slot"), hi=3)
               for _ in range(int(rng.integers(0, 12)))]
    free = [_shape(rng, hi=3) for _ in range(int(rng.integers(0, 4)))]
    pending = {t: int(rng.integers(0, 2)) for t in types if rng.random() < 0.4}
    max_workers = int(rng.integers(2, 10))
    current = int(rng.integers(0, max_workers // 2 + 1))
    return demands, free, types, pending, max_workers, current


@pytest.mark.parametrize("seed", range(6))
def test_get_nodes_to_launch_matches_reference(seed):
    case = _scheduler_case(seed)
    want = ref_rds.get_nodes_to_launch(*copy.deepcopy(case))
    got = port_rds.get_nodes_to_launch(*copy.deepcopy(case))
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_pick_replacement_type_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    types = _node_types(rng)
    for _ in range(20):
        lost = _shape(rng, kinds=_KINDS + ("node:10.0.0.1",), hi=6)
        assert (port_v1.pick_replacement_type(types, dict(lost))
                == ref_v1.pick_replacement_type(types, dict(lost)))


def _lost_feed(rng, n: int) -> list:
    return [{"node_id": f"{int(rng.integers(0, 1 << 30)):08x}",
             "resources_total": _shape(rng, hi=6), "reason": "PREEMPTION", "time": 0.0}
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_replacement_launches_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    types = _node_types(rng)
    feed = _lost_feed(rng, int(rng.integers(1, 8)))
    processed = {e["node_id"] for e in feed if rng.random() < 0.3}
    ref_processed, port_processed = set(processed), set(processed)
    for budget in (int(rng.integers(0, 3)), 8, 8):
        want = ref_v1.replacement_launches(types, feed, ref_processed, budget)
        got = port_v1.replacement_launches(types, feed, port_processed, budget)
        assert got == want and port_processed == ref_processed
    # the feed ages out: both forget the same ids
    assert (port_v1.replacement_launches(types, feed[:1], port_processed, 8)
            == ref_v1.replacement_launches(types, feed[:1], ref_processed, 8))
    assert port_processed == ref_processed


@pytest.mark.parametrize("seed", range(3))
def test_fold_grow_hints_matches_reference(seed):
    rng = np.random.default_rng(300 + seed)
    metrics = {
        "lost_capacity": _lost_feed(rng, int(rng.integers(0, 4))),
        "grow_hints": [{"name": f"exp{i}", "count": int(rng.integers(0, 4)),
                        "resources": _shape(rng, hi=3), "time": 0.0}
                       for i in range(int(rng.integers(0, 4)))],
    }
    demands = [_shape(rng, hi=3) for _ in range(int(rng.integers(0, 4)))]
    want, got = copy.deepcopy(demands), copy.deepcopy(demands)
    ref_v1.fold_grow_hints(want, copy.deepcopy(metrics))
    port_v1.fold_grow_hints(got, copy.deepcopy(metrics))
    assert got == want


class _RecordingProvider:
    """In-memory provider: records every create_node call."""

    def __init__(self, fail_first: int = 0):
        self.created = []
        self.nodes = {}
        self.counter = 0
        self.fail_first = fail_first

    def create_node(self, node_config, tags, count):
        if self.fail_first > 0:
            self.fail_first -= 1
            raise RuntimeError("cloud says no")
        self.created.append((dict(node_config), dict(tags), count))
        out = []
        for _ in range(count):
            self.counter += 1
            nid = f"cloud-{self.counter}"
            self.nodes[nid] = dict(tags)
            out.append(nid)
        return out

    def non_terminated_nodes(self, tag_filters):
        return [n for n, tags in self.nodes.items()
                if all(tags.get(k) == v for k, v in tag_filters.items())]

    def terminate_node(self, node_id):
        self.nodes.pop(node_id, None)

    def is_running(self, node_id):
        return node_id in self.nodes

    def raylet_address(self, node_id):
        return None


@pytest.mark.parametrize("seed", range(2))
def test_standard_autoscaler_update_matches_reference(seed):
    """v1's reconcile pass over seeded load metrics: the same launches,
    capacity returns and counters, tick after tick."""
    rng = np.random.default_rng(400 + seed)
    types = _node_types(rng)
    ticks = [{"pending_demands": [_shape(rng, hi=4) for _ in range(int(rng.integers(0, 6)))],
              "nodes": {},
              "lost_capacity": _lost_feed(rng, int(rng.integers(0, 3))),
              "grow_hints": []} for _ in range(3)]
    ref_p, port_p = _RecordingProvider(), _RecordingProvider()
    ref_a = ref_v1.StandardAutoscaler(ref_p, types, max_workers=6)
    port_a = port_v1.StandardAutoscaler(port_p, types, max_workers=6)
    for tick in ticks:
        ref_a.update(load_metrics=copy.deepcopy(tick))
        port_a.update(load_metrics=copy.deepcopy(tick))
        assert port_p.created == ref_p.created
        assert ((port_a.num_launches, port_a.num_capacity_returns, port_a.num_terminations)
                == (ref_a.num_launches, ref_a.num_capacity_returns, ref_a.num_terminations))


def _im_view(im) -> list:
    return [(i.instance_id, i.node_type, i.status, i.cloud_instance_id, i.launch_attempts,
             [s for s, _t in i.history]) for i in im.instances.values()]


@pytest.mark.parametrize("seed", range(3))
def test_instance_manager_transitions_match_reference(seed):
    """A seeded run of launches, failed allocations, Ray states and
    terminations: every instance's status, cloud id, attempts and audit
    trail, step by step."""
    rng = np.random.default_rng(500 + seed)
    types = {"w": {"resources": {"CPU": 2}}, "g": {"resources": {"CPU": 4, "GPU": 1}}}
    fail_first = int(rng.integers(0, 5))
    ref = ref_im.InstanceManager(_RecordingProvider(fail_first), types, max_launch_retries=3)
    port = port_im.InstanceManager(_RecordingProvider(fail_first), types, max_launch_retries=3)
    for _ in range(12):
        op = rng.integers(0, 3)
        if op == 0:
            node_type, n = ("w", "g")[int(rng.integers(0, 2))], int(rng.integers(1, 3))
            assert port.queue_launch(node_type, n) == ref.queue_launch(node_type, n)
        elif op == 1:
            iids = sorted(ref.instances)
            if iids:
                iid = iids[int(rng.integers(0, len(iids)))]
                ref.queue_terminate(iid)
                port.queue_terminate(iid)
        # the Ray view: each allocated cloud id ALIVE, DEAD or not yet up
        ray = {}
        for inst in ref.instances.values():
            if inst.cloud_instance_id is not None:
                pick = rng.integers(0, 3)
                if pick:
                    ray[inst.cloud_instance_id] = {"state": ("ALIVE", "DEAD")[pick - 1]}
        ref.reconcile(copy.deepcopy(ray))
        port.reconcile(copy.deepcopy(ray))
        assert _im_view(port) == _im_view(ref)
        assert ([i.instance_id for i in port.live()] == [i.instance_id for i in ref.live()])


def test_instance_transitions_and_refusals_match_reference():
    """Every (from, to) pair of the state machine: the same pairs are
    allowed, and the same ones raise."""
    assert port_im.VALID_TRANSITIONS == ref_im.VALID_TRANSITIONS
    assert port_im.LIVE_STATES == ref_im.LIVE_STATES
    states = sorted(ref_im.VALID_TRANSITIONS)
    for src in states:
        for dst in states:
            outcome = []
            for mod in (ref_im, port_im):
                inst = mod.Instance("i-1", "w", status=src)
                try:
                    inst.transition(dst)
                    outcome.append(("ok", inst.status, [s for s, _ in inst.history][1:]))
                except ValueError as e:
                    outcome.append(("refused", str(e)))
            assert outcome[0] == outcome[1], (src, dst)


def _metrics_text(seed: int) -> str:
    rng = np.random.default_rng(600 + seed)
    lines = []
    for i in range(int(rng.integers(3, 9))):
        name = f"m{i}_{('reqs', 'depth', 'lat', 'step')[int(rng.integers(0, 4))]}"
        mtype = ("counter", "gauge", "histogram", None)[int(rng.integers(0, 4))]
        if rng.random() < 0.5:
            lines.append(f"# HELP {name} help for {name}")
        if mtype is not None:
            lines.append(f"# TYPE {name} {mtype}")
        if mtype == "histogram":
            lines += [f'{name}_bucket{{le="1"}} {int(rng.integers(0, 9))}', f"{name}_sum 1.5",
                      f"{name}_count 3"]
        else:
            lines.append(f'{name}{{node="a"}} {float(rng.random())}')
    if rng.random() < 0.5:  # a live exposition of a builtin family
        lines += ["# HELP train_step_seconds live", "# TYPE train_step_seconds histogram"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(2))
def test_grafana_dashboard_matches_reference(seed):
    """Panels, queries and layout equal; the dashboard's tag, and its
    default title and uid, name the port's package."""
    text = _metrics_text(seed)
    kw = {"title": "cluster", "uid": "cluster-default"}
    want = ref_grafana.generate_grafana_dashboard(text, **kw)
    assert want["tags"] == ["ray_tpu", "generated"] and len(want["panels"]) >= 9
    want["tags"] = ["ray_tpu_torch", "generated"]
    assert port_grafana.generate_grafana_dashboard(text, **kw) == want
    want.update(uid="ray-tpu-torch-default", title="ray_tpu_torch")
    assert port_grafana.generate_grafana_dashboard(text) == want


class _ClusterView:
    """The part of the dashboard's state the usage report reads."""

    def __init__(self, total: dict, alive: int, dead: int, actors: list, jobs: list):
        self._status = {"nodes_alive": alive, "nodes_dead": dead, "resources_total": total,
                        "resources_available": {}}
        self._actors, self._jobs = actors, jobs

    def cluster_status(self):
        return copy.deepcopy(self._status)

    def actors(self):
        return list(self._actors)

    def jobs(self):
        return list(self._jobs)


def test_usage_report_matches_reference_with_gpu_for_tpu():
    rng = np.random.default_rng(700)
    total = {"CPU": float(rng.integers(1, 64)), "memory": 1e9, "accel-slot": 1.0}
    n_acc = float(rng.integers(1, 9))
    actors = [{"state": ("ALIVE", "DEAD")[int(rng.integers(0, 2))]} for _ in range(7)]
    jobs = [{"job_id": i} for i in range(int(rng.integers(0, 5)))]
    session = {"session_dir": "/tmp/x/session_2026"}
    ref = ref_usage.collect(_ClusterView({**total, "TPU": n_acc}, 3, 1, actors, jobs), session, 0.0)
    port = port_usage.collect(_ClusterView({**total, "GPU": n_acc}, 3, 1, actors, jobs),
                              session, 0.0)
    assert port.pop("total_num_gpus") == ref.pop("total_num_tpus") == n_acc
    for payload in (ref, port):  # the clock, and this process's imports
        for key in ("collected_at", "uptime_s", "libraries_used"):
            payload.pop(key)
    assert port == ref
    assert port["custom_resources"] == ["accel-slot"]
    # the library tags: the reference's, under the port's package name
    assert port_usage._LIBRARIES == tuple(
        "ray_tpu_torch" + name[len("ray_tpu"):] for name in ref_usage._LIBRARIES)
