"""User-defined application metrics (reference: python/ray/util/metrics.py
Counter :137, Histogram :187, Gauge :262; export pipeline SURVEY.md §5 —
C++ opencensus → dashboard agent → Prometheus).

Here: each worker process batches metric records locally and flushes them
to the GCS metrics table (rpc `metrics_report`) on a background thread;
`ray_tpu_torch.util.state.metrics()` and the dashboard's /metrics endpoint read
the aggregated view (Prometheus text format).
"""

from __future__ import annotations

import atexit
import threading
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

_FLUSH_INTERVAL_S = 2.0

_lock = threading.Lock()
_registry: Dict[Tuple[str, tuple], dict] = {}
_flusher_started = False

# Processes without a connected worker (raylet, GCS, dashboard helpers)
# register a delivery channel instead: fn(method, payload) -> None ships
# one report RPC to the GCS by whatever transport the process owns.
_report_channel: Optional[Callable[[str, dict], Any]] = None
_reporter_id: bytes = b""


def set_report_channel(fn: Optional[Callable[[str, dict], Any]], reporter_id: bytes = b""):
    """Route metric/span reports through `fn(method, payload)` rather than
    the global worker's GCS client (raylet/GCS processes have no worker).
    reporter_id keys this process's snapshot in the GCS metrics table."""
    global _report_channel, _reporter_id
    _report_channel = fn
    _reporter_id = reporter_id


def report(method: str, payload: dict) -> bool:
    """Deliver one report RPC to the GCS via the registered channel or the
    connected global worker.  Returns False when neither is available."""
    if _report_channel is not None:
        try:
            _report_channel(method, payload)
            return True
        except Exception:
            return False
    from ray_tpu_torch._private.worker import global_worker_maybe

    w = global_worker_maybe()
    if w is None or not w.connected or w.gcs_client is None:
        return False
    try:
        # Node attribution (no incarnation: workers are not fenced — the
        # GCS uses this to fold channel blocked/reattach counters into
        # the host node's gray-failure suspicion score).
        if getattr(w, "node_id", None) is not None:
            payload.setdefault("node_id", w.node_id.binary())
        # Bounded: this runs on flusher threads and at interpreter exit —
        # it must never park a dying worker on the full rpc call timeout.
        w.gcs_client.call(method, payload, timeout=10)
        return True
    except Exception:
        return False


def reporter_id() -> bytes:
    if _reporter_id:
        return _reporter_id
    from ray_tpu_torch._private.worker import global_worker_maybe

    w = global_worker_maybe()
    if w is not None and w.worker_id is not None:
        return w.worker_id.binary()
    return b""


def _ensure_flusher():
    # Deferred to the first metric WRITE (not construction): importing a
    # module that defines metrics must not spawn threads — that breaks
    # fork-based process spawning and burns a thread in every process
    # that merely imports an instrumented module.
    global _flusher_started
    if _flusher_started:
        return
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True

    def flush_loop():
        while True:
            time.sleep(_FLUSH_INTERVAL_S)
            try:
                flush()
            except Exception:
                pass

    threading.Thread(target=flush_loop, daemon=True, name="metrics-flush").start()
    # Short-lived workers die between flush ticks; push the final
    # snapshot (and any unflushed spans) on interpreter exit.
    atexit.register(_flush_at_exit)


def _flush_at_exit():
    try:
        flush()
    except Exception:
        pass
    try:
        from ray_tpu_torch.util import tracing

        tracing.flush()
    except Exception:
        pass


def flush():
    """Push the current snapshot to GCS (no-op when not connected)."""
    with _lock:
        snapshot = [
            {
                "name": name,
                "tags": dict(tags),
                "type": rec["type"],
                "value": rec["value"] if rec["type"] != "histogram" else None,
                "buckets": rec.get("buckets"),
                "counts": list(rec.get("counts", [])),
                "sum": rec.get("sum", 0.0),
                "count": rec.get("count", 0),
                "description": rec.get("description", ""),
            }
            for (name, tags), rec in _registry.items()
        ]
    if snapshot:
        report("metrics_report", {"worker_id": reporter_id(), "metrics": snapshot})


class _Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Optional[Tuple[str, ...]] = None):
        if not name:
            raise ValueError("metric name must be non-empty")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[str, tuple]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return (self._name, tuple(sorted(merged.items())))

    @property
    def info(self) -> dict:
        return {
            "name": self._name,
            "description": self._description,
            "tag_keys": self._tag_keys,
            "default_tags": self._default_tags,
        }


class _Bound:
    """A metric pre-resolved to one (name, tags) series: the per-event
    cost drops to lock + record update — no tag merge, no sorted() — so
    hot-path instrumentation (every RPC, every task) stays well under
    the <5% overhead budget.  The registry record is cached after first
    touch; records are never replaced for counters/histograms, so the
    cache cannot go stale."""

    __slots__ = ("_key", "_template", "_rec")

    def __init__(self, key: Tuple[str, tuple], template: dict):
        self._key = key
        self._template = template
        self._rec = None


class _BoundCounter(_Bound):
    def inc(self, value: float = 1.0):
        rec = self._rec
        with _lock:
            if rec is None:
                rec = self._rec = _registry.setdefault(self._key, dict(self._template))
            rec["value"] += value


class Counter(_Metric):
    """Monotonically increasing (reference: util/metrics.py:137)."""

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc() requires value > 0")
        _ensure_flusher()
        key = self._key(tags)
        with _lock:
            rec = _registry.setdefault(
                key, {"type": "counter", "value": 0.0, "description": self._description}
            )
            rec["value"] += value

    def bound(self, tags: Optional[Dict[str, str]] = None) -> _BoundCounter:
        """Pre-resolve the tag set for hot-path increments.  The flusher
        check happens here, once, so per-event writes skip it."""
        _ensure_flusher()
        return _BoundCounter(
            self._key(tags),
            {"type": "counter", "value": 0.0, "description": self._description},
        )


class Gauge(_Metric):
    """Last-value-wins (reference: util/metrics.py:262)."""

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        _ensure_flusher()
        key = self._key(tags)
        with _lock:
            _registry[key] = {"type": "gauge", "value": float(value), "description": self._description}


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)


class Histogram(_Metric):
    """Bucketed observations (reference: util/metrics.py:187)."""

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[List[float]] = None,
        tag_keys: Optional[Tuple[str, ...]] = None,
    ):
        super().__init__(name, description, tag_keys)
        bounds = boundaries if boundaries is not None else list(DEFAULT_BUCKETS)
        if any(b <= 0 for b in bounds) or sorted(bounds) != list(bounds):
            raise ValueError("histogram boundaries must be positive and sorted")
        self._boundaries = list(bounds)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        _ensure_flusher()
        key = self._key(tags)
        with _lock:
            rec = _registry.setdefault(key, self._template())
            i = bisect_left(self._boundaries, value)
            rec["counts"][i] += 1
            rec["sum"] += value
            rec["count"] += 1

    def _template(self) -> dict:
        return {
            "type": "histogram",
            "buckets": self._boundaries,
            "counts": [0] * (len(self._boundaries) + 1),
            "sum": 0.0,
            "count": 0,
            "description": self._description,
        }

    def bound(self, tags: Optional[Dict[str, str]] = None) -> "_BoundHistogram":
        """Pre-resolve the tag set for hot-path observations.  The
        flusher check happens here, once, so per-event writes skip it."""
        _ensure_flusher()
        return _BoundHistogram(self._key(tags), self._template(), self._boundaries)


class _BoundHistogram(_Bound):
    __slots__ = ("_boundaries",)

    def __init__(self, key, template, boundaries):
        super().__init__(key, template)
        self._boundaries = boundaries

    def observe(self, value: float):
        rec = self._rec
        with _lock:
            if rec is None:
                rec = self._rec = _registry.setdefault(self._key, dict(self._template))
                rec["counts"] = list(rec["counts"])  # never alias the template
            rec["counts"][bisect_left(self._boundaries, value)] += 1
            rec["sum"] += value
            rec["count"] += 1


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline (in that order — backslash first or the other
    escapes get double-escaped)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_text(metrics: List[dict]) -> str:
    """Render aggregated metric records in Prometheus exposition format."""
    lines = []
    by_name = defaultdict(list)
    for m in metrics:
        by_name[m["name"]].append(m)
    for name, group in sorted(by_name.items()):
        mtype = group[0]["type"]
        desc = _escape_help(group[0].get("description", ""))
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {mtype if mtype != 'histogram' else 'histogram'}")
        for m in group:
            label = ",".join(
                f'{k}="{_escape_label_value(v)}"'
                for k, v in sorted((m.get("tags") or {}).items())
            )
            label = "{" + label + "}" if label else ""
            if mtype == "histogram":
                cum = 0
                for bound, cnt in zip(m["buckets"] + [float("inf")], m["counts"]):
                    cum += cnt
                    b = "+Inf" if bound == float("inf") else repr(bound)
                    sep = "," if m.get("tags") else ""
                    tag_body = label[1:-1] if label else ""
                    lines.append(f'{name}_bucket{{{tag_body}{sep}le="{b}"}} {cum}')
                lines.append(f"{name}_sum{label} {m['sum']}")
                lines.append(f"{name}_count{label} {m['count']}")
            else:
                lines.append(f"{name}{label} {m['value']}")
    return "\n".join(lines) + "\n"
