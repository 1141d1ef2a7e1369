"""The port's cluster flight recorder: cross-process span aggregation,
the merged Perfetto timeline, the live Prometheus exposition, the
instrumentation overhead guard and the dashboard's trace, timeline and
chaos endpoints (copies of the cluster tests of
tests/test_observability.py; the ones that need no cluster are in
tests/test_torch_observability_local.py; no JAX.  Reference:
python/ray/tests/test_metrics_agent.py, `ray timeline`)."""

import json
import time
from urllib import request as urlrequest

import pytest
from test_torch_observability_local import _parse_exposition

import ray_tpu_torch
from ray_tpu_torch._private import retry
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import state, tracing


@pytest.fixture(scope="module")
def obs():
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


def _poll(fn, timeout=20.0):
    """Call ``fn`` until it returns something truthy or ``timeout`` has
    passed, backing off by the runtime's POLL policy; its last result."""
    bo = retry.POLL.start(deadline_s=timeout)
    while True:
        out = fn()
        if out:
            return out
        delay = bo.next_delay()
        if delay is None:
            return out
        time.sleep(delay)


def test_cluster_timeline_cross_process(obs, tmp_path):
    """A remote() call tree produces ONE trace whose spans come from >=2
    distinct PIDs with parent/child links that survive the process hop:
    root (driver) -> task::mid (worker A) -> task::leaf (worker B)."""

    @ray_tpu_torch.remote
    def leaf():
        return "leaf-done"

    @ray_tpu_torch.remote
    def mid():
        return ray_tpu_torch.get(leaf.remote())

    with tracing.start_span("obs-root") as root:
        assert ray_tpu_torch.get(mid.remote(), timeout=60) == "leaf-done"

    def fetch():
        sp = state.spans()
        names = {s["name"] for s in sp}
        if "obs-root" in names and any("mid" in n for n in names) and any(
            "leaf" in n for n in names
        ):
            return sp
        return None

    sp = _poll(fetch)
    assert sp, "spans did not reach the GCS span table"
    ours = [s for s in sp if s["trace_id"] == root.trace_id]
    by_id = {s["span_id"]: s for s in ours}
    root_span = next(s for s in ours if s["name"] == "obs-root")
    mid_span = next(s for s in ours if s["name"].endswith("mid"))
    leaf_span = next(s for s in ours if s["name"].endswith("leaf"))
    # parent/child nesting across process boundaries
    assert root_span["parent_span_id"] is None
    assert mid_span["parent_span_id"] == root_span["span_id"]
    assert leaf_span["parent_span_id"] == mid_span["span_id"]
    assert leaf_span["parent_span_id"] in by_id and mid_span["parent_span_id"] in by_id
    # spans span processes: driver + at least one distinct worker pid
    pids = {root_span["pid"], mid_span["pid"], leaf_span["pid"]}
    assert len(pids) >= 2, f"expected >=2 distinct PIDs, got {pids}"

    # the timeline export carries the same spans as Chrome-trace events
    out = state.timeline(str(tmp_path / "trace.json"))
    with open(out) as f:
        trace = json.load(f)
    span_events = [e for e in trace if e.get("cat") == "span"]
    ev_pids = {e["pid"] for e in span_events
               if e["args"].get("trace_id") == root.trace_id}
    assert len(ev_pids) >= 2
    for e in span_events:
        assert {"trace_id", "span_id"} <= set(e["args"])
    # grouped view agrees
    tr = next(t for t in state.traces() if t["trace_id"] == root.trace_id)
    assert tr["span_count"] >= 3 and len(tr["pids"]) >= 2


def test_live_metrics_exposition_parses(obs):
    """The cluster's real /metrics view (core instrumentation included)
    parses cleanly and exposes rpc_latency_seconds histograms per
    method."""

    @ray_tpu_torch.remote
    def touch(x):
        return x

    ray_tpu_torch.get([touch.remote(i) for i in range(5)])
    metrics_mod.flush()

    def fetch():
        recs = state.metrics()
        if any(r["name"] == "rpc_latency_seconds" for r in recs):
            return recs
        return None

    recs = _poll(fetch, timeout=15)
    assert recs, "rpc_latency_seconds never reached the GCS"
    text = metrics_mod.prometheus_text(recs)
    samples, types = _parse_exposition(text)
    assert all(len(v) == 1 for v in types.values())
    assert types["rpc_latency_seconds"] == ["histogram"]
    methods = {
        dict(k[1]).get("method")
        for k in samples
        if k[0] == "rpc_latency_seconds_count"
    }
    assert len(methods) >= 2, f"expected per-method series, got {methods}"


def test_instrumentation_overhead_budget(obs):
    """The flight recorder must cost <5% of bench_micro task throughput.
    A task involves ~10 instrumented events (client+server RPC observes,
    task phases, span record); measure the real per-event cost and the
    real per-task wall time and assert the ratio."""
    from ray_tpu_torch._private import telemetry

    @ray_tpu_torch.remote
    def nop():
        return b"ok"

    # warm the path (lease grants, function table)
    ray_tpu_torch.get([nop.remote() for _ in range(20)])
    n_tasks = 200
    t0 = time.perf_counter()
    ray_tpu_torch.get([nop.remote() for _ in range(n_tasks)])
    per_task_s = (time.perf_counter() - t0) / n_tasks

    n_ops = 5000
    t0 = time.perf_counter()
    for _ in range(n_ops):
        telemetry.observe_rpc("overhead_probe", "client", 0.001)
        telemetry.observe_task_phase("exec", 0.001)
    per_event_s = (time.perf_counter() - t0) / (2 * n_ops)

    # Direct-path critical-path events per task: submit + e2e (driver),
    # exec + span-context check (worker); exec_direct/task_finished are
    # uninstrumented pushes and server-side observes land in other
    # processes, off the driver-throughput critical path.  6 = that
    # census (~4) with headroom.
    events_per_task = 6
    overhead = events_per_task * per_event_s / per_task_s
    assert overhead < 0.05, (
        f"instrumentation overhead {overhead:.1%} >= 5% "
        f"(per-event {per_event_s * 1e6:.2f}us, per-task {per_task_s * 1e3:.2f}ms)"
    )



# ----------------------------------------------------------------------
# dashboard endpoints
# ----------------------------------------------------------------------
def test_dashboard_observability_endpoints(obs):
    url = obs.dashboard_url
    assert url

    @ray_tpu_torch.remote
    def ping():
        return 1

    with tracing.start_span("dash-root"):
        ray_tpu_torch.get([ping.remote() for _ in range(3)])
    tracing.flush()

    def fetch():
        with urlrequest.urlopen(url + "/api/traces", timeout=10) as r:
            traces = json.loads(r.read())
        if any(t["span_count"] >= 2 for t in traces):
            return traces
        return None

    traces = _poll(fetch, timeout=15)
    assert traces, "/api/traces never showed a multi-span trace"

    req = urlrequest.urlopen(url + "/api/timeline", timeout=10)
    assert "attachment" in req.headers.get("Content-Disposition", "")
    tl = json.loads(req.read())
    assert any(e.get("cat") == "span" for e in tl)
    assert any(e.get("ph") == "M" for e in tl)  # perfetto process names

    with urlrequest.urlopen(url + "/api/chaos", timeout=10) as r:
        chaos = json.loads(r.read())
    # no chaos configured: endpoint reports inactive but well-formed views
    assert chaos["active"] is False
    assert chaos["gcs"] is not None and chaos["gcs"]["rules"] == []
    assert isinstance(chaos["nodes"], dict) and len(chaos["nodes"]) >= 1
    for view in chaos["nodes"].values():
        assert "rules" in view and "spec" in view
