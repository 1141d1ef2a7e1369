"""State API (reference: python/ray/util/state/api.py:110 StateApiClient,
list_actors :781, summarize_tasks :1365; served by the dashboard state
head aggregating GCS + raylets).

Here the GCS is the aggregation point: actors/nodes/jobs/PGs come from
its tables; per-node task/object stats come from raylet `node_stats`;
task events come from the GCS task-event table fed by worker reports
(reference: core_worker/task_event_buffer.h → gcs_task_manager.h:86).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.worker import get_global_worker


def _gcs():
    w = get_global_worker()
    if not w.connected:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return w.gcs_client


def list_nodes() -> List[Dict[str, Any]]:
    info = _gcs().call("get_cluster_info")
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


def list_actors(filters: Optional[List[tuple]] = None) -> List[Dict[str, Any]]:
    actors = _gcs().call("list_actors", None)
    out = []
    for a in actors:
        rec = {
            "actor_id": ActorID(a["actor_id"]).hex(),
            "state": a["state"],
            "class_name": a.get("class_name", ""),
            "name": a.get("name"),
            "node_id": NodeID(a["node_id"]).hex() if a.get("node_id") else None,
            "pid": a.get("pid", 0),
            "num_restarts": a.get("num_restarts", 0),
            "death_cause": a.get("death_cause"),
        }
        if _matches(rec, filters):
            out.append(rec)
    return out


def list_placement_groups() -> List[Dict[str, Any]]:
    return _gcs().call("list_placement_groups", None)


def list_jobs() -> List[Dict[str, Any]]:
    return _gcs().call("list_jobs", None)


def list_tasks(filters: Optional[List[tuple]] = None, limit: int = 10000) -> List[Dict[str, Any]]:
    events = _gcs().call("list_task_events", {"limit": limit})
    out = []
    for e in events:
        if _matches(e, filters):
            out.append(e)
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Aggregate object-store stats over all raylets."""
    out = []
    for n in list_nodes():
        if n["state"] not in ("ALIVE", "DRAINING"):
            continue
        try:
            stats = _node_call(n["raylet_address"], "node_stats", {"include_objects": True})
        except Exception:
            continue
        for obj in stats.get("objects", []):
            obj["node_id"] = n["node_id"]
            out.append(obj)
    return out


def list_workers() -> List[Dict[str, Any]]:
    out = []
    for n in list_nodes():
        if n["state"] not in ("ALIVE", "DRAINING"):
            continue
        try:
            stats = _node_call(n["raylet_address"], "node_stats", {})
        except Exception:
            continue
        for w in stats.get("workers", []):
            w["node_id"] = n["node_id"]
            out.append(w)
    return out


def summarize_tasks() -> Dict[str, Any]:
    """Group task events by (name, state) (reference: summarize_tasks)."""
    tasks = list_tasks()
    summary: Dict[str, Dict[str, int]] = {}
    for t in tasks:
        name = t.get("name", "?")
        state = t.get("state", "?")
        summary.setdefault(name, {})
        summary[name][state] = summary[name].get(state, 0) + 1
    return {"node_count": len([n for n in list_nodes() if n["state"] == "ALIVE"]), "summary": summary}


def summarize_actors() -> Dict[str, Any]:
    actors = list_actors()
    summary: Dict[str, Dict[str, int]] = {}
    for a in actors:
        cls = a.get("class_name", "?")
        summary.setdefault(cls, {})
        summary[cls][a["state"]] = summary[cls].get(a["state"], 0) + 1
    return {"summary": summary}


def metrics() -> List[Dict[str, Any]]:
    """Aggregated user + system metric records from the GCS."""
    return _gcs().call("metrics_get", None)


def profile(
    target: Any = None,
    duration_s: float = 5.0,
    hz: Optional[float] = None,
    mode: str = "wall",
    include_workers: bool = True,
):
    """Attach the on-demand sampling profiler to a live actor, node,
    the GCS, or the whole cluster, and return the merged
    ``ProfileResult`` (collapsed-stack / speedscope exports, top-frame
    attribution — docs/profiling.md).

    ``target``: an ``ActorHandle`` / actor id, a node id hex, ``"gcs"``,
    or ``None``/``"cluster"`` for everything.  Blocks ~``duration_s``.
    A target that dies mid-capture yields a partial result with an
    ``errors`` entry, never an exception.
    """
    from ray_tpu_torch.util import profiling as profiling_mod

    gcs_call = _gcs().call
    targets = profiling_mod.resolve_targets(
        target, gcs_call, include_workers=include_workers
    )
    return profiling_mod.run_profile(
        targets, gcs_call, _node_call, duration_s=duration_s, hz=hz, mode=mode
    )


def profiles(session_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Capture records in the GCS profile table (shipped by profiled
    processes at end of capture — survives the profiled process)."""
    payload = {"session_id": session_id} if session_id else None
    return _gcs().call("list_profiles", payload) or []


def _dedupe_spans(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Span delivery to the GCS is at-least-once (a lost span_report
    reply re-sends the batch), so collapse duplicates by span_id —
    duplicate records are byte-identical, keep the first."""
    seen = set()
    out = []
    for s in records:
        sid = s.get("span_id")
        if sid is not None and sid in seen:
            continue
        if sid is not None:
            seen.add(sid)
        out.append(s)
    return out


def spans(limit: int = 100_000) -> List[Dict[str, Any]]:
    """Cluster-wide finished spans from the GCS span table.  The local
    process's unflushed spans are shipped first so a driver's root spans
    appear alongside the worker spans they parent."""
    from ray_tpu_torch.util import tracing

    tracing.flush()
    return _dedupe_spans(_gcs().call("list_spans", {"limit": limit}) or [])


def traces(limit: int = 100_000) -> List[Dict[str, Any]]:
    """Spans grouped per trace (cluster-wide), newest-first: each entry
    carries the span tree of one distributed call graph."""
    return group_traces(spans(limit))


_DP_HOP_SPANS = ("channel.write", "channel.read", "channel.reattach")
# Queue-wait histogram bounds (seconds): log-spaced from 10µs to 10s.
_DP_QW_BOUNDS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def build_dataplane(
    span_records: List[Dict[str, Any]],
    metric_records: List[Dict[str, Any]],
) -> Dict[str, Any]:
    """Pure merge of channel hop spans and ``channel_*`` counter
    aggregates into the live hot-path health view (shared by
    ``util.state.dataplane()`` and the dashboard's ``/api/dataplane``,
    which has no connected worker).

    Per-edge stats come from sampled ``channel.write`` / ``channel.read``
    / ``channel.reattach`` spans grouped by their ``path`` attribute
    (the channel endpoint is the edge identity); a ``channel.read``
    span's duration is the frame's queue wait, so each edge carries a
    queue-wait p50/p95/max plus a log-bucketed histogram.  Cluster-wide
    counters (every op, not just sampled ones) ride alongside from the
    GCS metric table."""
    edges: Dict[str, Dict[str, Any]] = {}
    for s in span_records:
        name = s.get("name")
        if name not in _DP_HOP_SPANS:
            continue
        attrs = s.get("attributes") or {}
        path = str(attrs.get("path", "?"))
        e = edges.get(path)
        if e is None:
            e = edges[path] = {
                "path": path,
                "kind": attrs.get("kind"),
                "writes": 0,
                "reads": 0,
                "reattaches": 0,
                "reattach_failures": 0,
                "last_epoch": None,
                "pids": set(),
                "_qw": [],
            }
        if attrs.get("kind"):
            e["kind"] = attrs["kind"]
        if s.get("pid") is not None:
            e["pids"].add(s["pid"])
        if name == "channel.write":
            e["writes"] += 1
        elif name == "channel.read":
            e["reads"] += 1
            qw = attrs.get("queue_wait_s")
            if isinstance(qw, (int, float)):
                e["_qw"].append(float(qw))
        else:  # channel.reattach
            e["reattaches"] += 1
            if attrs.get("result") != "ok":
                e["reattach_failures"] += 1
            if attrs.get("epoch") is not None:
                e["last_epoch"] = attrs["epoch"]
    out_edges = []
    for e in sorted(edges.values(), key=lambda e: e["path"]):
        qw = sorted(e.pop("_qw"))
        counts = [0] * (len(_DP_QW_BOUNDS) + 1)
        for v in qw:
            for i, b in enumerate(_DP_QW_BOUNDS):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
        e["pids"] = sorted(e["pids"], key=str)
        e["queue_wait"] = {
            "count": len(qw),
            "p50_s": _quantile(qw, 0.50),
            "p95_s": _quantile(qw, 0.95),
            "max_s": qw[-1] if qw else 0.0,
            "histogram": {"bounds_s": list(_DP_QW_BOUNDS), "counts": counts},
        }
        out_edges.append(e)
    counters: Dict[str, Any] = {}
    for m in metric_records:
        name = m.get("name", "")
        if not (name.startswith("channel_") or name.startswith("socket_channel_")):
            continue
        if m.get("type") != "counter":
            continue
        tags = m.get("tags") or {}
        if tags:
            sub = counters.setdefault(name, {})
            sub["|".join(f"{k}={v}" for k, v in sorted(tags.items()))] = m.get("value", 0)
        else:
            counters[name] = m.get("value", 0)
    return {"edges": out_edges, "counters": counters}


def dataplane(limit: int = 100_000) -> Dict[str, Any]:
    """Live dataplane health: per-channel-edge hop/queue-wait stats
    derived from sampled trace spans, merged with the cluster-wide
    ``channel_*`` counters (docs/observability.md, "Dataplane
    tracing")."""
    span_records = spans(limit)
    try:
        metric_records = metrics()
    except Exception:
        metric_records = []
    return build_dataplane(span_records, metric_records)


_CP_OVERLAP_SLACK_S = 1e-6  # clock-jitter tolerance between siblings


def critical_path(group: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The longest dependency chain through one trace's span tree.

    Within each span, sequential (non-overlapping) children form a
    dependency chain — the chain is walked backwards from the
    last-finishing child, each link the latest-ending child that ends
    before the next link starts.  Each link expands recursively, so the
    result is the root-first flattening of the chain that bounds the
    trace's end-to-end latency.  For a serve request that reads
    ``serve.request -> serve.queue -> serve.prefill -> serve.decode``
    and attributes wall time across the three phases; for a task tree it
    names the slowest submit chain.

    Entries: ``{name, span_id, duration_s, depth, segment}`` —
    ``segment=True`` marks links whose time actually accrues to the path
    (links further expanded by their own children contribute through
    those children instead), so ``sum(duration_s where segment)`` is the
    path's latency decomposition without double counting.  Pure: shared
    by the state API and the dashboard.
    """
    by_id = {s["span_id"]: s for s in group if s.get("span_id")}
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for s in group:
        parent = s.get("parent_span_id")
        if parent and parent in by_id and parent != s.get("span_id"):
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    if not roots:
        return []

    def dur(s) -> float:
        return max(0.0, (s.get("end_time") or 0.0) - (s.get("start_time") or 0.0))

    def entry(s, depth, segment) -> Dict[str, Any]:
        return {
            "name": s.get("name"),
            "span_id": s.get("span_id"),
            "duration_s": dur(s),
            "depth": depth,
            "segment": segment,
        }

    def sequential_chain(kids) -> List[Dict[str, Any]]:
        """Backwards greedy: last-finishing child, then the latest-ending
        child that ends before it starts, ... — returned in start order."""
        chain: List[Dict[str, Any]] = []
        remaining = sorted(kids, key=lambda s: s.get("end_time") or 0.0)
        cursor = None
        while remaining:
            nxt = None
            for k in reversed(remaining):
                if cursor is None or (k.get("end_time") or 0.0) <= cursor + _CP_OVERLAP_SLACK_S:
                    nxt = k
                    break
            if nxt is None:
                break
            chain.append(nxt)
            remaining.remove(nxt)
            cursor = nxt.get("start_time") or 0.0
        chain.reverse()
        return chain

    def expand(s, depth, seen) -> List[Dict[str, Any]]:
        sid = s.get("span_id")
        kids = [k for k in children.get(sid, []) if k.get("span_id") not in seen]
        if not kids:
            return [entry(s, depth, True)]
        seen = seen | {sid}
        out = [entry(s, depth, False)]
        for k in sequential_chain(kids):
            out.extend(expand(k, depth + 1, seen))
        return out

    def total(path) -> float:
        return sum(e["duration_s"] for e in path if e["segment"])

    best = max((expand(r, 0, frozenset()) for r in roots), key=total)
    return best


def group_traces(span_records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Pure grouping of span records into per-trace summaries (shared by
    the state API and the dashboard, which has no connected worker)."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in span_records:
        tid = s.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(s)
    out = []
    for tid, group in by_trace.items():
        group.sort(key=lambda s: s.get("start_time", 0.0))
        start = min(s.get("start_time", 0.0) for s in group)
        end = max(s.get("end_time", 0.0) for s in group)
        cpath = critical_path(group)
        out.append(
            {
                "trace_id": tid,
                "span_count": len(group),
                "pids": sorted({s.get("pid") for s in group if s.get("pid") is not None}),
                "start_time": start,
                "duration_s": max(0.0, end - start),
                "root_names": [s.get("name") for s in group if not s.get("parent_span_id")],
                "critical_path": cpath,
                "critical_path_s": sum(
                    e["duration_s"] for e in cpath if e["segment"]
                ),
                "spans": group,
            }
        )
    out.sort(key=lambda t: t["start_time"], reverse=True)
    return out


def build_chrome_trace(
    task_events: List[Dict[str, Any]], span_records: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Merge GCS task events and cross-process spans into one
    Chrome-trace/Perfetto event list.  Spans keep their real (pid, tid)
    so Perfetto renders one track per process/thread, and carry
    trace_id/span_id/parent_span_id in args so the call tree is
    reconstructable across process boundaries."""
    trace: List[Dict[str, Any]] = []
    for e in task_events:
        start = e.get("start_time")
        end = e.get("end_time") or time.time()
        if start is None:
            continue
        trace.append(
            {
                "cat": "task",
                "name": e.get("name", "task"),
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(0.0, (end - start)) * 1e6,
                "pid": e.get("node_id", "node")[:8] if e.get("node_id") else "node",
                "tid": e.get("worker_id", "worker")[:8] if e.get("worker_id") else "worker",
                "args": {k: v for k, v in e.items() if isinstance(v, (str, int, float, bool))},
            }
        )
    span_pids = set()
    for s in span_records:
        start = s.get("start_time")
        if start is None:
            continue
        end = s.get("end_time") or start
        args = {
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "parent_span_id": s.get("parent_span_id"),
        }
        for k, v in (s.get("attributes") or {}).items():
            if isinstance(v, (str, int, float, bool)):
                args[k] = v
        pid = s.get("pid", 0)
        span_pids.add(pid)
        trace.append(
            {
                "cat": "span",
                "name": s.get("name", "span"),
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(0.0, end - start) * 1e6,
                "pid": pid,
                "tid": s.get("tid", 0),
                "args": args,
            }
        )
    for pid in sorted(span_pids, key=str):
        trace.append(
            {
                "ph": "M",
                "cat": "__metadata",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"pid {pid}"},
            }
        )
    return trace


def timeline(filename: Optional[str] = None, include_spans: bool = True) -> Optional[str]:
    """Chrome-trace (catapult) export of the cluster flight recorder:
    task events PLUS spans merged from every process (reference:
    `ray timeline`, GcsTaskManager → chrome://tracing format; open the
    output in Perfetto or chrome://tracing)."""
    events = _gcs().call("list_task_events", {"limit": 100000})
    span_records: List[Dict[str, Any]] = []
    if include_spans:
        try:
            span_records = spans()
        except Exception:
            span_records = []
    trace = build_chrome_trace(events, span_records)
    if filename is None:
        return json.dumps(trace)
    with open(filename, "w") as f:
        json.dump(trace, f)
    return filename


# ----------------------------------------------------------------------
def _matches(rec: Dict[str, Any], filters: Optional[List[tuple]]) -> bool:
    if not filters:
        return True
    for f in filters:
        key, op, value = f
        actual = rec.get(key)
        if op in ("=", "=="):
            if str(actual) != str(value):
                return False
        elif op == "!=":
            if str(actual) == str(value):
                return False
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return True


_node_clients: Dict[str, Any] = {}


def _node_call(address: str, method: str, payload: Any, timeout: Optional[float] = None):
    from ray_tpu_torch._private import rpc

    client = _node_clients.get(address)
    if client is None or client.closed:
        # Re-dial closed cached clients (connection loss must not
        # permanently break this address — the target may be back).
        client = rpc.RpcClient(address)
        _node_clients[address] = client
    if timeout is None:  # unset: keep the config-default call timeout
        return client.call(method, payload)
    return client.call(method, payload, timeout=timeout)
