"""util extras of the port: ActorPool, Queue, metrics, state API, timeline
(copies of tests/test_util.py over the port's cluster; no JAX).

Reference test model: python/ray/tests/test_actor_pool.py, test_queue.py,
test_metrics_agent.py, python/ray/tests/test_state_api.py.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import retry


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault per
        # raylet, and no memory monitor (it watches the whole machine).
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


@pytest.fixture(scope="module")
def pool_actors(ray_cluster):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, v):
            return 2 * v

        def slow_double(self, v):
            time.sleep(0.2 if v == 0 else 0.01)
            return 2 * v

    actors = [Doubler.remote() for _ in range(2)]
    yield actors
    for a in actors:
        ray_tpu_torch.kill(a)


def test_actor_pool_ordered(pool_actors):
    from ray_tpu_torch.util import ActorPool

    pool = ActorPool(pool_actors)
    out = list(pool.map(lambda a, v: a.double.remote(v), list(range(8))))
    assert out == [2 * v for v in range(8)]


def test_actor_pool_unordered(pool_actors):
    from ray_tpu_torch.util import ActorPool

    pool = ActorPool(pool_actors)
    out = list(pool.map_unordered(lambda a, v: a.slow_double.remote(v), list(range(6))))
    assert sorted(out) == [2 * v for v in range(6)]


def test_actor_pool_submit_get(pool_actors):
    from ray_tpu_torch.util import ActorPool

    pool = ActorPool(pool_actors)
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    assert pool.get_next() == 20
    assert pool.get_next() == 40
    assert not pool.has_next()


def test_queue_basic(ray_cluster):
    from ray_tpu_torch.util.queue import Empty, Queue

    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2
    assert q.get() == 1
    assert q.get() == 2
    with pytest.raises(Empty):
        q.get(block=False)
    q.shutdown()


def test_queue_producers_consumers(ray_cluster):
    from ray_tpu_torch.util.queue import Queue

    q = Queue()

    @ray_tpu_torch.remote
    def produce(q, lo, hi):
        for i in range(lo, hi):
            q.put(i)
        return hi - lo

    n = ray_tpu_torch.get([produce.remote(q, 0, 5), produce.remote(q, 5, 10)])
    assert sum(n) == 10
    got = sorted(q.get() for _ in range(10))
    assert got == list(range(10))
    q.shutdown()


def test_state_api_actors_and_nodes(ray_cluster):
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    class Sleeper:
        def ping(self):
            return "pong"

    a = Sleeper.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    actors = state.list_actors([("state", "=", "ALIVE")])
    assert any(x["class_name"].endswith("Sleeper") for x in actors)
    nodes = state.list_nodes()
    assert len(nodes) >= 1 and nodes[0]["state"] == "ALIVE"
    ray_tpu_torch.kill(a)


def test_task_events_and_timeline(ray_cluster, tmp_path):
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    def traced_task(x):
        return x + 1

    ray_tpu_torch.get([traced_task.remote(i) for i in range(5)])
    # worker flushes events at most 1/s; poll the GCS table
    events = []
    for _ in _poll(15):
        events = [e for e in state.list_tasks() if "traced_task" in e["name"]]
        if len(events) >= 5:
            break
    assert len(events) >= 5
    assert all(e["state"] == "FINISHED" for e in events)
    summary = state.summarize_tasks()
    assert any("traced_task" in name for name in summary["summary"])

    out = state.timeline(str(tmp_path / "trace.json"))
    import json

    with open(out) as f:
        trace = json.load(f)
    assert any("traced_task" in ev["name"] for ev in trace)


def test_metrics_roundtrip(ray_cluster):
    from ray_tpu_torch.util import metrics as m
    from ray_tpu_torch.util import state

    c = m.Counter("test_requests_total", description="reqs", tag_keys=("route",))
    c.inc(1.0, tags={"route": "a"})
    c.inc(2.0, tags={"route": "a"})
    g = m.Gauge("test_inflight")
    g.set(7.0)
    h = m.Histogram("test_latency_s", boundaries=[0.1, 1.0])
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    m.flush()

    recs = []
    for _ in _poll(10):
        recs = state.metrics()
        if {r["name"] for r in recs} >= {"test_requests_total", "test_inflight", "test_latency_s"}:
            break
    by_name = {r["name"]: r for r in recs}
    assert by_name["test_requests_total"]["value"] == 3.0
    assert by_name["test_inflight"]["value"] == 7.0
    assert by_name["test_latency_s"]["count"] == 3
    assert by_name["test_latency_s"]["counts"] == [1, 1, 1]

    text = m.prometheus_text(recs)
    assert "test_requests_total" in text and 'le="+Inf"' in text


def test_trace_context_propagates_across_tasks(ray_cluster):
    """W3C trace context rides TaskSpec.trace_parent: every hop of a
    distributed call tree shares one trace id (reference:
    util/tracing/tracing_helper.py)."""
    from ray_tpu_torch.util import tracing

    @ray_tpu_torch.remote
    def leaf():
        return tracing.get_trace_id(), tracing.get_span_id()

    @ray_tpu_torch.remote
    def mid():
        here = tracing.get_trace_id()
        sub_trace, _sub_span = ray_tpu_torch.get(leaf.remote())
        return here, sub_trace

    with tracing.start_span("root") as root:
        mid_trace, leaf_trace = ray_tpu_torch.get(mid.remote(), timeout=60)
    assert mid_trace == root.trace_id, "trace id lost at first hop"
    assert leaf_trace == root.trace_id, "trace id lost at nested hop"
    # untraced submissions carry no context
    @ray_tpu_torch.remote
    def bare():
        return tracing.get_trace_id()
    assert ray_tpu_torch.get(bare.remote(), timeout=60) is None
    spans = tracing.drain_spans()
    assert any(s["name"] == "root" for s in spans)


def test_runtime_env_plugins(ray_cluster, tmp_path):
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private import runtime_env as renv

    # validation: plugin keys accepted, bad values rejected
    renv.validate({"conda": "myenv"})
    renv.validate({"uv": ["requests"]})
    renv.validate({"image_uri": "gcr.io/x/y:1"})
    with pytest.raises(renv.RuntimeEnvError):
        renv.validate({"uv": "not-a-list"})
    with pytest.raises(renv.RuntimeEnvError):
        renv.validate({"bogus_key": 1})

    # custom plugin: registered, staged in priority order
    staged = []

    class MarkerPlugin(renv.RuntimeEnvPlugin):
        name = "marker"
        priority = 1

        def stage(self, value, gcs_client, session_dir):
            staged.append(value)
            os.environ["MARKER_PLUGIN"] = str(value)

    renv.register_plugin(MarkerPlugin())
    try:
        norm, uploads = renv.prepare({"marker": "hello"})
        assert norm == {"marker": "hello"} and uploads == []
        renv.stage_and_apply({"marker": "hello"}, None, str(tmp_path))
        assert staged == ["hello"]
        assert os.environ.pop("MARKER_PLUGIN") == "hello"
    finally:
        renv._plugins.pop("marker", None)
        renv.SUPPORTED_KEYS.discard("marker")

    # gated plugin fails LOUDLY end-to-end (no container runtime here)
    @ray_tpu_torch.remote(runtime_env={"image_uri": "gcr.io/x/y:1"}, max_retries=0)
    def containered():
        return 1

    with pytest.raises(exceptions.RuntimeEnvSetupError):
        ray_tpu_torch.get(containered.remote(), timeout=120)
