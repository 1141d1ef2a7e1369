"""Dashboard HTTP server (reference: python/ray/dashboard/dashboard.py +
dashboard/modules/job/job_head.py REST routes).

A ThreadingHTTPServer hosted in the head-node process.  All state reads
go through the GCS (and raylet node_stats), the same sources as the
state API; job routes delegate to the JobManager.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch.dashboard.job_manager import JobManager

logger = logging.getLogger(__name__)


class _DashboardState:
    """GCS-backed reads, mirroring ray_tpu_torch.util.state without needing a
    connected driver worker."""

    def __init__(self, gcs_client):
        self.gcs = gcs_client
        self._raylet_clients = {}

    def _raylet(self, address: str):
        c = self._raylet_clients.get(address)
        if c is None or c.closed:
            c = rpc.RpcClient(address)
            self._raylet_clients[address] = c
        return c

    def nodes(self):
        info = self.gcs.call("get_cluster_info")
        return [
            {
                "node_id": NodeID(n["node_id"]).hex(),
                "state": n["state"],  # ALIVE | DRAINING | DEAD
                "is_head": n.get("is_head", False),
                "resources_total": n["resources_total"],
                "raylet_address": n["raylet_address"],
                "hostname": n.get("hostname", ""),
                "drain_reason": n.get("drain_reason"),
                "drain_deadline": n.get("drain_deadline", 0.0),
                "drain_complete": n.get("drain_complete", False),
            }
            for n in info["nodes"].values()
        ]

    def cluster_status(self):
        info = self.gcs.call("get_cluster_info")
        total: dict = {}
        available: dict = {}
        for n in info["nodes"].values():
            # Capacity view: DRAINING nodes grant nothing, so they are
            # excluded from the totals (they still appear in /api/nodes).
            if n["state"] != "ALIVE":
                continue
            for k, v in n["resources_total"].items():
                total[k] = total.get(k, 0) + v
        for avail in info.get("available", {}).values():
            for k, v in avail.items():
                available[k] = available.get(k, 0) + v
        return {
            "nodes_alive": sum(1 for n in info["nodes"].values() if n["state"] == "ALIVE"),
            "nodes_draining": sum(
                1 for n in info["nodes"].values() if n["state"] == "DRAINING"
            ),
            "nodes_dead": sum(1 for n in info["nodes"].values() if n["state"] == "DEAD"),
            "resources_total": total,
            "resources_available": available,
        }

    def actors(self):
        out = []
        for a in self.gcs.call("list_actors", None):
            out.append(
                {
                    "actor_id": ActorID(a["actor_id"]).hex(),
                    "state": a["state"],
                    "class_name": a.get("class_name", ""),
                    "name": a.get("name"),
                    "node_id": NodeID(a["node_id"]).hex() if a.get("node_id") else None,
                    "pid": a.get("pid", 0),
                    "num_restarts": a.get("num_restarts", 0),
                    "death_cause": a.get("death_cause"),
                }
            )
        return out

    def tasks(self, limit: int = 1000):
        return self.gcs.call("list_task_events", {"limit": limit})

    def placement_groups(self):
        return self.gcs.call("list_placement_groups", None)

    def jobs(self):
        return self.gcs.call("list_jobs", None)

    def tenants(self):
        return self.gcs.call("list_tenants", None)

    def set_tenant(self, payload: dict):
        return self.gcs.call("tenant_set_quota", payload)

    def workers(self):
        out = []
        for n in self.nodes():
            if n["state"] not in ("ALIVE", "DRAINING"):
                continue
            try:
                stats = self._raylet(n["raylet_address"]).call("node_stats", {})
            except Exception:
                continue
            for w in stats.get("workers", []):
                w["node_id"] = n["node_id"]
                out.append(w)
        return out

    def objects(self):
        out = []
        for n in self.nodes():
            if n["state"] not in ("ALIVE", "DRAINING"):
                continue
            try:
                stats = self._raylet(n["raylet_address"]).call(
                    "node_stats", {"include_objects": True}
                )
            except Exception:
                continue
            for obj in stats.get("objects", []):
                obj["node_id"] = n["node_id"]
                out.append(obj)
        return out

    def spans(self, limit: int = 100_000):
        from ray_tpu_torch.util.state import _dedupe_spans

        return _dedupe_spans(self.gcs.call("list_spans", {"limit": limit}) or [])

    def traces(self):
        from ray_tpu_torch.util.state import group_traces

        return group_traces(self.spans())

    def dataplane(self):
        """Hot-path health view: per-channel-edge hop stats from
        sampled spans merged with cluster-wide channel_* counters."""
        from ray_tpu_torch.util.state import build_dataplane

        try:
            metric_records = self.gcs.call("metrics_get", None) or []
        except Exception:
            metric_records = []
        return build_dataplane(self.spans(), metric_records)

    def timeline_trace(self):
        """Cluster flight-recorder export: GCS task events + spans from
        every process merged into one Chrome-trace/Perfetto event list."""
        from ray_tpu_torch.util.state import build_chrome_trace

        events = self.gcs.call("list_task_events", {"limit": 100_000})
        return build_chrome_trace(events, self.spans())

    def profile(
        self,
        target=None,
        duration_s: float = 3.0,
        hz=None,
        mode: str = "wall",
        include_workers: bool = True,
    ):
        """Drive an on-demand sampling-profiler capture (util.profiling
        orchestration over the dashboard's own GCS/raylet clients).
        Blocks this HTTP thread for ~duration_s (ThreadingHTTPServer:
        other routes keep serving)."""
        from ray_tpu_torch.util import profiling as profiling_mod

        targets = profiling_mod.resolve_targets(
            target, self.gcs.call, include_workers=include_workers
        )
        return profiling_mod.run_profile(
            targets,
            self.gcs.call,
            lambda addr, m, p, t: self._raylet(addr).call(m, p, timeout=t),
            duration_s=duration_s,
            hz=hz,
            mode=mode,
        )

    def list_profiles(self, session_id=None):
        payload = {"session_id": session_id} if session_id else None
        return self.gcs.call("list_profiles", payload) or []

    def chaos(self):
        """Active chaos schedule + per-rule injection counts: the GCS
        process's view, every alive raylet's view (node_stats), and the
        chaos_injections_total counters flushed by worker processes."""
        out = {"gcs": None, "nodes": {}, "injections": [], "active": False}
        try:
            out["gcs"] = self.gcs.call("chaos_stats", None)
        except Exception:
            out["gcs"] = None
        try:
            nodes = self.nodes()
        except Exception:
            nodes = []
        for n in nodes:
            if n["state"] not in ("ALIVE", "DRAINING"):
                continue
            try:
                stats = self._raylet(n["raylet_address"]).call("node_stats", {})
            except Exception:
                continue
            if "chaos" in stats:
                out["nodes"][n["node_id"]] = stats["chaos"]
        try:
            recs = self.gcs.call("metrics_get", None) or []
            out["injections"] = [
                {"tags": r.get("tags", {}), "count": r.get("value", 0.0)}
                for r in recs
                if r.get("name") == "chaos_injections_total"
            ]
        except Exception:
            pass
        views = [v for v in [out["gcs"], *out["nodes"].values()] if v]
        out["active"] = any(v.get("active") for v in views)
        return out

    def prometheus_metrics(self) -> str:
        """User metrics (util.metrics flushed through the GCS) PLUS
        built-in operational gauges derived from cluster state, so a
        cluster with zero user instrumentation still exports a real
        scrape surface (reference: the C++ stats the reference exports
        unconditionally — node count, resources, scheduler health)."""
        try:
            from ray_tpu_torch.util import metrics as metrics_mod

            records = list(self.gcs.call("metrics_get", None) or [])
            records.extend(self._builtin_metric_records())
            return metrics_mod.prometheus_text(records)
        except Exception:
            return ""

    def _builtin_metric_records(self) -> list:
        out = []

        def gauge(name, desc, value, tags=None):
            out.append({
                "name": name, "type": "gauge", "description": desc,
                "value": float(value), "tags": tags or {},
            })

        try:
            status = self.cluster_status()
            gauge("ray_tpu_torch_nodes_alive", "alive raylet nodes", status["nodes_alive"])
            gauge("ray_tpu_torch_nodes_dead", "dead raylet nodes", status["nodes_dead"])
            for k, v in status["resources_total"].items():
                gauge("ray_tpu_torch_resource_total", "cluster resource capacity", v,
                      {"resource": k})
            for k, v in status["resources_available"].items():
                gauge("ray_tpu_torch_resource_available", "cluster resource availability",
                      v, {"resource": k})
            gauge("ray_tpu_torch_actors_alive", "alive actors",
                  sum(1 for a in self.actors() if a.get("state") == "ALIVE"))
        except Exception:
            pass
        # per-node raylet health (event-loop lag is the saturation signal
        # the stress suite asserts on); per-node try so one unreachable
        # raylet doesn't drop every later node's gauges from the scrape
        try:
            nodes = self.nodes()
        except Exception:
            nodes = []
        for n in nodes:
            try:
                if n["state"] not in ("ALIVE", "DRAINING"):
                    continue
                stats = self._raylet(n["raylet_address"]).call("node_stats", {})
                nid = n["node_id"][:12]
                for key in ("event_loop_lag_ms", "event_loop_lag_max_ms",
                            "num_workers", "queue_len", "infeasible",
                            "num_tasks_dispatched", "num_tasks_spilled"):
                    if key in stats:
                        gauge(f"ray_tpu_torch_raylet_{key}", f"raylet {key}",
                              stats[key], {"node": nid})
                store = stats.get("store", {})
                for key in ("used_bytes", "capacity_bytes", "num_objects",
                            "num_evictions", "num_spilled"):
                    if key in store:
                        gauge(f"ray_tpu_torch_object_store_{key}", f"object store {key}",
                              store[key], {"node": nid})
            except Exception:
                continue
        return out


def _html_table(title: str, rows: list) -> str:
    import html as html_mod

    esc = lambda v: html_mod.escape(str(v))  # noqa: E731 — user data (names,
    # entrypoints, metadata) must never reach the page unescaped
    if not rows:
        return f"<h3>{esc(title)}</h3><p>none</p>"
    cols = list(rows[0].keys())
    head = "".join(f"<th>{esc(c)}</th>" for c in cols)
    body = "".join(
        "<tr>" + "".join(f"<td>{esc(r.get(c, ''))}</td>" for c in cols) + "</tr>"
        for r in rows
    )
    return (
        f"<h3>{esc(title)}</h3><table border=1 cellpadding=4 "
        f"style='border-collapse:collapse;font-family:monospace'>"
        f"<tr>{head}</tr>{body}</table>"
    )


class _Handler(BaseHTTPRequestHandler):
    server_version = "ray-tpu-torch-dashboard"
    state: _DashboardState = None  # type: ignore  # set by factory
    jobs: JobManager = None  # type: ignore

    def log_message(self, fmt, *args):  # quiet
        logger.debug("dashboard: " + fmt, *args)

    # -- helpers --------------------------------------------------------
    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj: Any, code: int = 200):
        self._send(code, json.dumps(obj, default=str).encode())

    def _error(self, code: int, message: str):
        self._json({"error": message}, code)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if not n:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    # -- routes ---------------------------------------------------------
    def do_GET(self):
        path = urlparse(self.path).path.rstrip("/") or "/"
        try:
            if path == "/":
                return self._index()
            if path == "/api/version":
                return self._json({"version": "ray_tpu_torch", "api": 1})
            if path == "/api/cluster_status":
                return self._json(self.state.cluster_status())
            if path == "/api/nodes":
                return self._json(self.state.nodes())
            if path == "/api/actors":
                return self._json(self.state.actors())
            if path == "/api/tasks":
                return self._json(self.state.tasks())
            if path == "/api/placement_groups":
                return self._json(self.state.placement_groups())
            if path == "/api/workers":
                return self._json(self.state.workers())
            if path == "/api/objects":
                return self._json(self.state.objects())
            if path == "/api/cluster_jobs":
                return self._json(self.state.jobs())
            if path == "/api/tenants":
                return self._json(self.state.tenants())
            if path == "/api/jobs":
                return self._json(self.jobs.list_jobs())
            if path.startswith("/api/jobs/"):
                rest = path[len("/api/jobs/"):]
                if rest.endswith("/logs"):
                    sid = rest[: -len("/logs")]
                    return self._json({"logs": self.jobs.get_job_logs(sid)})
                info = self.jobs.get_job_status(rest)
                if info is None:
                    return self._error(404, f"job {rest!r} not found")
                return self._json(info)
            if path == "/api/traces":
                return self._json(self.state.traces())
            if path == "/api/dataplane":
                return self._json(self.state.dataplane())
            if path == "/api/timeline":
                body = json.dumps(self.state.timeline_trace(), default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header(
                    "Content-Disposition",
                    'attachment; filename="ray_tpu_torch_timeline.json"',
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path == "/api/chaos":
                return self._json(self.state.chaos())
            if path == "/api/profile":
                from urllib.parse import parse_qs

                q = parse_qs(urlparse(self.path).query)

                def qget(key, default=None):
                    vals = q.get(key)
                    return vals[0] if vals else default

                duration = max(0.05, min(float(qget("duration_s", 3.0)), 30.0))
                hz = qget("hz")
                result = self.state.profile(
                    target=qget("target") or None,
                    duration_s=duration,
                    hz=float(hz) if hz else None,
                    mode=qget("mode", "wall"),
                    include_workers=qget("workers", "1") not in ("0", "false"),
                )
                fmt = qget("format", "json")
                if fmt == "collapsed":
                    return self._send(200, result.collapsed().encode(), "text/plain")
                if fmt == "speedscope":
                    return self._send(
                        200, json.dumps(result.speedscope()).encode(), "application/json"
                    )
                return self._json(
                    {
                        **result.summary(),
                        "collapsed": result.collapsed(),
                        "profiles": result.profiles,
                    }
                )
            if path == "/api/profiles":
                from urllib.parse import parse_qs

                q = parse_qs(urlparse(self.path).query)
                sid = q.get("session_id", [None])[0]
                return self._json(self.state.list_profiles(sid))
            if path == "/metrics":
                return self._send(
                    200, self.state.prometheus_metrics().encode(), "text/plain; version=0.0.4"
                )
            if path == "/api/usage_stats":
                from ray_tpu_torch.dashboard import usage_stats as usage_mod

                if not usage_mod.enabled():
                    return self._json({"enabled": False})
                # read-only endpoint: persistence belongs to the loop
                return self._json(
                    usage_mod.collect(self.state, self.session_info, self.start_time)
                )
            if path == "/api/grafana_dashboard":
                # importable Grafana JSON generated from the metrics this
                # cluster actually exports (reference:
                # modules/metrics/grafana_dashboard_factory.py)
                from ray_tpu_torch.dashboard.grafana_dashboard_factory import (
                    generate_grafana_dashboard,
                )

                return self._json(
                    generate_grafana_dashboard(self.state.prometheus_metrics())
                )
            return self._error(404, f"no route {path}")
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001
            logger.exception("dashboard GET %s failed", path)
            try:
                self._error(500, f"{type(e).__name__}: {e}")
            except Exception:
                pass

    def do_POST(self):
        path = urlparse(self.path).path.rstrip("/")
        try:
            if path == "/api/jobs":
                body = self._read_body()
                if not body.get("entrypoint"):
                    return self._error(400, "entrypoint is required")
                sid = self.jobs.submit_job(
                    entrypoint=body["entrypoint"],
                    submission_id=body.get("submission_id"),
                    runtime_env=body.get("runtime_env"),
                    metadata=body.get("metadata"),
                    tenant=body.get("tenant"),
                    priority=int(body.get("priority") or 0),
                    quota=body.get("quota"),
                )
                return self._json({"submission_id": sid})
            if path == "/api/tenants":
                body = self._read_body()
                if not body.get("tenant"):
                    return self._error(400, "tenant is required")
                return self._json(self.state.set_tenant(body))
            if path.endswith("/stop") and path.startswith("/api/jobs/"):
                sid = path[len("/api/jobs/"): -len("/stop")]
                if not self.jobs.stop_job(sid):
                    return self._error(404, f"job {sid!r} not found")
                return self._json({"stopped": True})
            return self._error(404, f"no route {path}")
        except ValueError as e:
            self._error(400, str(e))
        except Exception as e:  # noqa: BLE001
            logger.exception("dashboard POST %s failed", path)
            self._error(500, f"{type(e).__name__}: {e}")

    def do_DELETE(self):
        path = urlparse(self.path).path.rstrip("/")
        if path.startswith("/api/jobs/"):
            sid = path[len("/api/jobs/"):]
            try:
                if not self.jobs.delete_job(sid):
                    return self._error(404, f"job {sid!r} not found")
                return self._json({"deleted": True})
            except ValueError as e:
                return self._error(400, str(e))
        return self._error(404, f"no route {path}")

    def _index(self):
        """Serve the SPA (static/index.html — tabbed tables polling the
        /api endpoints; reference: dashboard/client).  Falls back to a
        minimal server-rendered page if the asset is missing."""
        import os

        asset = os.path.join(os.path.dirname(__file__), "static", "index.html")
        try:
            with open(asset, "rb") as f:
                return self._send(200, f.read(), "text/html")
        except OSError:
            pass
        import html as html_mod

        status = self.state.cluster_status()
        html = (
            "<html><head><title>ray_tpu_torch dashboard</title></head><body>"
            "<h2>ray_tpu_torch cluster</h2>"
            f"<p>alive nodes: {status['nodes_alive']} &nbsp; "
            f"draining: {status.get('nodes_draining', 0)} &nbsp; "
            f"dead: {status['nodes_dead']}</p>"
            f"<p>resources: {html_mod.escape(str(status['resources_total']))} &nbsp; "
            f"available: {html_mod.escape(str(status['resources_available']))}</p>"
            + _html_table("Nodes", self.state.nodes())
            + _html_table("Actors", self.state.actors())
            + _html_table("Jobs (submitted)", self.jobs.list_jobs())
            + "<p>API: /api/nodes /api/actors /api/tasks /api/jobs "
            "/api/objects /api/placement_groups /api/workers /api/traces "
            "/api/dataplane /api/timeline /api/chaos /metrics</p>"
            "</body></html>"
        )
        self._send(200, html.encode(), "text/html")


def start_dashboard(
    gcs_address: str, session_dir: str, host: str = "127.0.0.1", port: int = 8265
) -> Optional[ThreadingHTTPServer]:
    """Start the dashboard in a daemon thread; returns the server (its
    bound port is server.server_address[1]; port=0 picks a free one)."""
    try:
        gcs_client = rpc.RpcClient(gcs_address)
        jobs_gcs_client = rpc.RpcClient(gcs_address)
    except rpc.RpcError as e:
        logger.warning("dashboard: cannot reach GCS: %s", e)
        return None
    handler = type("BoundHandler", (_Handler,), {})
    handler.state = _DashboardState(gcs_client)
    handler.jobs = JobManager(jobs_gcs_client, gcs_address, session_dir)
    # The launcher only hands us session_dir; the GCS session record
    # (ray version, node ip, etc.) fills in the rest for usage reports.
    # Fetched off-thread: start_dashboard runs ON the head process's
    # event loop, so a synchronous self-call to the GCS here would block
    # the loop (and the raylet's heartbeats) for the full timeout.
    handler.session_info = {"session_dir": session_dir}

    def _enrich_session_info():
        try:
            extra = dict(gcs_client.call("get_session_info", None, timeout=5) or {})
        except rpc.RpcError:
            return
        extra["session_dir"] = session_dir
        handler.session_info = extra  # atomic class-attr rebind

    threading.Thread(
        target=_enrich_session_info, daemon=True, name="dashboard-session-info"
    ).start()
    handler.start_time = time.time()
    try:
        server = ThreadingHTTPServer((host, port), handler)
    except OSError as e:
        logger.warning("dashboard: cannot bind %s:%s: %s", host, port, e)
        return None
    threading.Thread(target=server.serve_forever, daemon=True, name="dashboard-http").start()

    # periodic local usage report (reference: usage_stats_head's report
    # loop; here local-file only — see dashboard/usage_stats.py)
    from ray_tpu_torch.dashboard import usage_stats as usage_mod

    if usage_mod.enabled():
        def usage_loop():
            while True:
                try:
                    usage_mod.write_report(
                        handler.state, handler.session_info, handler.start_time
                    )
                except Exception:
                    pass
                time.sleep(300)

        threading.Thread(target=usage_loop, daemon=True, name="usage-stats").start()
    logger.info("dashboard listening on http://%s:%s", *server.server_address)
    return server
