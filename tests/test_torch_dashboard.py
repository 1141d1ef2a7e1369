"""The port's dashboard: its HTTP API, REST job submission, usage stats
and the Grafana factory (copies of the ten tests of
``tests/test_dashboard.py`` and of ``test_profiling.py``'s
``test_dashboard_profile_endpoint``), over the port's head, which serves
the dashboard from its own process; and a submitted job's
``runtime_env``, which reaches the port's tasks and not the JAX
package's (a fault of the reference the port does not inherit).

Reference: dashboard/dashboard.py routes, dashboard/modules/job/ REST +
sdk.
"""

import json
import os
import subprocess
import sys
import time
from urllib import request

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import retry
from ray_tpu_torch.dashboard import JobSubmissionClient

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dash():
    """Module-scoped local cluster of the port; its head serves the
    dashboard (the conftest's fixtures start the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault per
        # raylet, and no memory monitor (it watches the whole machine).
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ctx = ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
        url = ctx.dashboard_url
        assert url, "head did not report a dashboard url"
        yield url
        ray_tpu_torch.shutdown()


def _get(url, path):
    with request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read())


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


def test_state_endpoints(dash):
    @ray_tpu_torch.remote
    class Marker:
        def ping(self):
            return 1

    m = Marker.remote()
    assert ray_tpu_torch.get(m.ping.remote(), timeout=30) == 1

    status = _get(dash, "/api/cluster_status")
    assert status["nodes_alive"] >= 1
    assert status["resources_total"].get("CPU", 0) >= 2

    nodes = _get(dash, "/api/nodes")
    assert any(n["state"] == "ALIVE" for n in nodes)

    actors = _get(dash, "/api/actors")
    assert any(a["state"] == "ALIVE" and "Marker" in a["class_name"] for a in actors)

    assert isinstance(_get(dash, "/api/tasks"), list)
    assert isinstance(_get(dash, "/api/placement_groups"), list)
    ray_tpu_torch.kill(m)


def test_index_serves_spa_and_metrics(dash):
    """GET / serves the self-contained SPA (tabbed tables polling the
    /api endpoints — reference: dashboard/client app)."""
    with request.urlopen(dash + "/", timeout=10) as r:
        page = r.read().decode()
    assert "<nav" in page and "/api/cluster_status" in page  # live-polling SPA
    for endpoint in ("/api/nodes", "/api/actors", "/api/tasks", "/api/jobs"):
        assert endpoint in page  # every entity tab wired to its API
    with request.urlopen(dash + "/metrics", timeout=10) as r:
        assert r.status == 200


def test_grafana_dashboard_endpoint(dash):
    """GET /api/grafana_dashboard returns importable Grafana JSON whose
    panels cover the families the cluster exports (reference:
    modules/metrics/grafana_dashboard_factory.py)."""
    model = _get(dash, "/api/grafana_dashboard")
    assert model["uid"] == "ray-tpu-torch-default"  # the reference's: ray-tpu-default
    assert model["templating"]["list"][0]["name"] == "datasource"
    with request.urlopen(dash + "/metrics", timeout=10) as r:
        metrics_text = r.read().decode()
    exported = {
        line.split(None, 3)[2]
        for line in metrics_text.splitlines()
        if line.startswith("# TYPE ")
    }
    paneled = set()
    for p in model["panels"]:
        for t in p["targets"]:
            expr = t["expr"]
            paneled.add(
                expr.split("rate(")[-1].split("[")[0].split("_bucket")[0]
                if "(" in expr else expr
            )
    missing = exported - paneled
    assert not missing, f"metrics with no panel: {missing}"


def test_grafana_factory_query_shapes():
    """Counters get rate() queries, histograms get quantile queries over
    _bucket, gauges are raw."""
    from ray_tpu_torch.dashboard.grafana_dashboard_factory import generate_grafana_dashboard

    text = (
        "# HELP reqs total requests\n# TYPE reqs counter\nreqs 10\n"
        "# TYPE depth gauge\ndepth 3\n"
        "# TYPE lat histogram\nlat_bucket{le=\"1\"} 4\nlat_sum 2.0\nlat_count 4\n"
    )
    model = generate_grafana_dashboard(text)
    by_title = {p["title"]: p for p in model["panels"]}
    assert by_title["reqs"]["targets"][0]["expr"] == "rate(reqs[5m])"
    assert by_title["depth"]["targets"][0]["expr"] == "depth"
    lat_exprs = [t["expr"] for t in by_title["lat"]["targets"]]
    assert any("histogram_quantile(0.99" in e and "lat_bucket" in e for e in lat_exprs)
    assert len(lat_exprs) == 3
    assert by_title["reqs"]["description"] == "total requests"


def test_grafana_factory_training_robustness_panels_out_of_the_box():
    """train_step_seconds and the drain_*/train_resize_* metrics get
    panels even when the exposition text predates their first event — and
    a live exposition of the same family does not duplicate the panel."""
    from ray_tpu_torch.dashboard.grafana_dashboard_factory import generate_grafana_dashboard

    model = generate_grafana_dashboard("")  # nothing exported yet
    titles = {p["title"] for p in model["panels"]}
    for metric in (
        "train_step_seconds",
        "train_resize_events_total",
        "train_resize_seconds",
        "drain_events_total",
        "drain_migration_seconds",
        "chaos_injections_total",
    ):
        assert metric.replace("_", " ") in titles, metric
    # Histogram builtins get quantile queries; counters get rate().
    by_title = {p["title"]: p for p in model["panels"]}
    resize_exprs = [t["expr"] for t in by_title["train resize seconds"]["targets"]]
    assert any("histogram_quantile" in e for e in resize_exprs)
    events_exprs = [t["expr"] for t in by_title["train resize events total"]["targets"]]
    assert events_exprs == ["rate(train_resize_events_total[5m])"]

    # Live exposition wins without duplication.
    text = "# HELP train_step_seconds live\n# TYPE train_step_seconds histogram\n"
    model2 = generate_grafana_dashboard(text)
    step_panels = [
        p for p in model2["panels"] if p["title"] == "train step seconds"
    ]
    assert len(step_panels) == 1
    assert step_panels[0]["description"] == "live"


def test_job_submission_lifecycle(dash, tmp_path):
    client = JobSubmissionClient(dash)
    out = tmp_path / "job_out.txt"
    sid = client.submit_job(
        entrypoint=f"python -c \"open('{out}','w').write('done')\" && echo finished",
        metadata={"who": "test"},
    )
    status = client.wait_until_finished(sid, timeout=60)
    assert status == "SUCCEEDED"
    assert out.read_text() == "done"
    assert "finished" in client.get_job_logs(sid)
    info = client.get_job_info(sid)
    assert info["metadata"] == {"who": "test"}
    jobs = client.list_jobs()
    assert any(j["submission_id"] == sid for j in jobs)
    assert client.delete_job(sid)
    with pytest.raises(RuntimeError):
        client.get_job_status(sid)


def test_job_submission_runs_driver_against_cluster(dash, tmp_path):
    """The submitted entrypoint connects to THIS cluster via
    RAY_TPU_TORCH_ADDRESS and runs real tasks."""
    client = JobSubmissionClient(dash)
    script = tmp_path / "driver.py"
    script.write_text(
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()  # RAY_TPU_TORCH_ADDRESS is set by the job supervisor\n"
        "@ray_tpu_torch.remote\n"
        "def f(x):\n"
        "    return x * 3\n"
        "print('RESULT', ray_tpu_torch.get(f.remote(14)))\n"
        "ray_tpu_torch.shutdown()\n"
    )
    sid = client.submit_job(entrypoint=f"{sys.executable} {script}")
    assert client.wait_until_finished(sid, timeout=120) == "SUCCEEDED"
    assert "RESULT 42" in client.get_job_logs(sid)


def test_job_stop(dash):
    client = JobSubmissionClient(dash)
    sid = client.submit_job(entrypoint="sleep 120")
    _poll(lambda: client.get_job_status(sid) != "PENDING", timeout=30)
    assert client.get_job_status(sid) == "RUNNING"
    assert client.stop_job(sid)
    assert client.wait_until_finished(sid, timeout=30) == "STOPPED"


def test_failed_job_status(dash):
    client = JobSubmissionClient(dash)
    sid = client.submit_job(entrypoint="python -c 'raise SystemExit(3)'")
    assert client.wait_until_finished(sid, timeout=60) == "FAILED"
    assert "code 3" in client.get_job_info(sid)["message"]


def test_usage_stats_endpoint_and_local_report(dash):
    """Usage stats (reference: dashboard/modules/usage_stats): LOCAL
    report only — /api/usage_stats collects a snapshot, persists it in
    the session dir, and never needs egress."""
    stats = _get(dash, "/api/usage_stats")
    assert stats["schema_version"] == 1
    assert stats["num_nodes_alive"] >= 1
    assert stats["total_num_cpus"] >= 2
    assert "total_num_gpus" in stats  # the reference's: total_num_tpus
    assert "ray_tpu_torch.data" not in stats["libraries_used"]  # dashboard proc

    # persisted next to the session's other artifacts (by the loop)
    from ray_tpu_torch._private.worker import get_global_worker

    sd = get_global_worker().session_info.get("session_dir")
    path = os.path.join(sd, "usage_stats.json")
    assert _poll(lambda: os.path.exists(path), timeout=20)  # loop writes once at startup
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["schema_version"] == 1


@ray_tpu_torch.remote
class Burner:
    """CPU-bound workload whose frames the profiler must attribute."""

    def burn_workload(self, seconds: float) -> int:
        deadline = time.monotonic() + seconds
        acc = 0
        while time.monotonic() < deadline:
            acc += sum(i * i for i in range(500))
        return acc


def test_dashboard_profile_endpoint(dash):
    """/api/profile drives the same orchestration with the dashboard's
    own clients (no connected driver) in all three formats (copied from
    test_profiling.py, whose module fixture is the cluster's context; here
    the fixture is the dashboard's url)."""
    url = dash
    actor = Burner.remote()
    ray_tpu_torch.get(actor.burn_workload.remote(0.01), timeout=60)
    ref = actor.burn_workload.remote(6.0)
    aid = actor._actor_id.hex()
    with request.urlopen(
        f"{url}/api/profile?target={aid}&duration_s=1", timeout=30
    ) as r:
        body = json.loads(r.read())
    assert body["total_samples"] > 0 and not body["errors"]
    assert body["collapsed"].startswith("actor:")
    with request.urlopen(
        f"{url}/api/profile?target={aid}&duration_s=0.5&format=collapsed", timeout=30
    ) as r:
        assert b"burn_workload" in r.read()
    with request.urlopen(f"{url}/api/profiles", timeout=10) as r:
        assert isinstance(json.loads(r.read()), list)
    ray_tpu_torch.get(ref, timeout=60)


_ENV_MARK = "DASHBOARD_JOB_ENV_MARK"
_ENV_JOB = """
import os, sys
import {pkg} as rt
rt.init()  # the address comes from the job supervisor
@rt.remote
def read():
    return os.environ.get({mark!r})
print("SEEN", rt.get(read.remote()), "IN_DRIVER", os.environ.get({mark!r}))
rt.shutdown()
"""
# The same job submitted to the JAX package's own dashboard, in a process
# of its own (it starts the JAX package's cluster there).
_REFERENCE_SUBMIT = """
import json, sys
import ray_tpu
from ray_tpu.dashboard import JobSubmissionClient
ctx = ray_tpu.init(num_cpus=1)
try:
    client = JobSubmissionClient(ctx.dashboard_url)
    sid = client.submit_job(entrypoint=sys.argv[1], runtime_env=json.loads(sys.argv[2]))
    status = client.wait_until_finished(sid, timeout=120)
    print(json.dumps({"status": status, "logs": client.get_job_logs(sid)}))
finally:
    ray_tpu.shutdown()
"""


def test_job_runtime_env_reaches_tasks(dash, tmp_path):
    """A job submitted with ``runtime_env={"env_vars": ...}`` runs its
    tasks with those variables on the port, whose ``init()`` takes the
    supervisor's ``RAY_TPU_TORCH_JOB_RUNTIME_ENV``.  The same job on the
    JAX package runs its task without them: its supervisor writes
    ``RAY_TPU_JOB_RUNTIME_ENV`` (ray_tpu/dashboard/job_manager.py:110-111)
    and its ``init()`` never reads it (ray_tpu/__init__.py:160-190), so
    the variable is in neither its driver nor its task."""
    runtime_env = {"env_vars": {_ENV_MARK: "from-runtime-env"}}
    port_job = tmp_path / "port_job.py"
    port_job.write_text(_ENV_JOB.format(pkg="ray_tpu_torch", mark=_ENV_MARK))
    client = JobSubmissionClient(dash)
    sid = client.submit_job(entrypoint=f"{sys.executable} {port_job}", runtime_env=runtime_env)
    assert client.wait_until_finished(sid, timeout=120) == "SUCCEEDED"
    assert "SEEN from-runtime-env IN_DRIVER None" in client.get_job_logs(sid)

    ref_job = tmp_path / "reference_job.py"
    ref_job.write_text(_ENV_JOB.format(pkg="ray_tpu", mark=_ENV_MARK))
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_")}
    env.update(PYTHONPATH=REPO_ROOT, RAY_TPU_arena_prefault_bytes="0",
               RAY_TPU_memory_monitor_enabled="0")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SUBMIT, f"{sys.executable} {ref_job}",
         json.dumps(runtime_env)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ref["status"] == "SUCCEEDED", ref
    assert "SEEN None IN_DRIVER None" in ref["logs"], ref["logs"]
