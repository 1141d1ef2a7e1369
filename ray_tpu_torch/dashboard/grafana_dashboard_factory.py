"""Grafana dashboard factory (reference:
python/ray/dashboard/modules/metrics/grafana_dashboard_factory.py — the
reference generates its default Grafana dashboards from Panel configs;
here the panel list is DERIVED from the metrics the cluster actually
exports, so a dashboard generated against a live cluster always matches
its /metrics surface).

``generate_grafana_dashboard(metrics_text)`` parses Prometheus
exposition text (HELP/TYPE + samples) and emits one timeseries panel
per metric family — counters as rate() queries, gauges raw, histograms
as p50/p95/p99 quantile queries over the _bucket series.  The
datasource is the ``${datasource}`` template variable, so the JSON
imports into any Grafana with a Prometheus source.

The training/robustness panels are NOT purely derived: a curated
builtin family list (train step time, drain events/migration, elastic
resize events/duration, chaos injections) is merged in so those panels
exist out of the box — a dashboard generated before the first drain or
resize still has the panel the on-call will stare at during one."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# Always-present panels (name, type, help).  A live exposition of the
# same family wins (identical shape), but its ABSENCE — metrics only
# exist after their first event — must not drop the panel.
_BUILTIN_FAMILIES: List[Tuple[str, str, str]] = [
    (
        "train_step_seconds",
        "histogram",
        "wall time between consecutive train.report calls per rank",
    ),
    (
        "train_resize_events_total",
        "counter",
        "elastic worker-group resizes, by direction (shrink, grow) and trigger",
    ),
    (
        "train_resize_seconds",
        "histogram",
        "wall time of one elastic resize (teardown, re-rendezvous, session restart)",
    ),
    (
        "drain_events_total",
        "counter",
        "node drains initiated, by reason (PREEMPTION, IDLE_TERMINATION)",
    ),
    (
        "drain_migration_seconds",
        "histogram",
        "time from drain start until actors and sole-copy objects are off the node",
    ),
    (
        "chaos_injections_total",
        "counter",
        "fault injections fired by the chaos plane",
    ),
]


def _parse_families(metrics_text: str) -> List[Tuple[str, str, str]]:
    """[(name, type, help)] in first-seen order from exposition text."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    order: List[str] = []
    for line in metrics_text.splitlines():
        line = line.strip()
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(None, 3)
            if name not in types:
                order.append(name)
            types[name] = mtype
        elif line.startswith("# HELP "):
            parts = line.split(None, 3)
            helps[parts[2]] = parts[3] if len(parts) > 3 else ""
        elif line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix):
                    base = base[: -len(suffix)]
            if base not in types:
                types[base] = "gauge"
                order.append(base)
    return [(n, types[n], helps.get(n, "")) for n in order]


def _panel(panel_id: int, title: str, description: str, targets: List[dict],
           x: int, y: int) -> dict:
    return {
        "id": panel_id,
        "type": "timeseries",
        "title": title,
        "description": description,
        "datasource": "${datasource}",
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "fieldConfig": {"defaults": {"custom": {"fillOpacity": 10}}, "overrides": []},
        "targets": targets,
    }


def _targets_for(name: str, mtype: str) -> List[dict]:
    if mtype == "counter":
        return [{
            "expr": f"rate({name}[5m])",
            "legendFormat": "{{instance}}",
            "refId": "A",
        }]
    if mtype == "histogram":
        return [
            {
                "expr": f"histogram_quantile({q}, "
                        f"sum(rate({name}_bucket[5m])) by (le))",
                "legendFormat": f"p{int(q * 100)}",
                "refId": chr(ord("A") + i),
            }
            for i, q in enumerate((0.5, 0.95, 0.99))
        ]
    return [{"expr": name, "legendFormat": "{{instance}}", "refId": "A"}]


def generate_grafana_dashboard(
    metrics_text: str, *, title: str = "ray_tpu_torch", uid: str = "ray-tpu-torch-default"
) -> dict:
    """Exposition text → importable Grafana dashboard JSON model."""
    families = _parse_families(metrics_text)
    seen = {name for name, _t, _h in families}
    families += [f for f in _BUILTIN_FAMILIES if f[0] not in seen]
    panels = []
    for i, (name, mtype, help_) in enumerate(families):
        panels.append(
            _panel(
                i + 1,
                name.replace("_", " "),
                help_ or f"{mtype} {name}",
                _targets_for(name, mtype),
                x=(i % 2) * 12,
                y=(i // 2) * 8,
            )
        )
    return {
        "uid": uid,
        "title": title,
        "tags": ["ray_tpu_torch", "generated"],
        "timezone": "browser",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "templating": {
            "list": [{
                "name": "datasource",
                "type": "datasource",
                "query": "prometheus",
                "label": "Data source",
            }]
        },
        "panels": panels,
    }


def write_grafana_dashboard(metrics_text: str, path: str, **kwargs) -> None:
    with open(path, "w") as f:
        json.dump(generate_grafana_dashboard(metrics_text, **kwargs), f, indent=2)
