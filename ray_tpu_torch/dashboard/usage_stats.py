"""Usage stats collection (reference:
dashboard/modules/usage_stats/usage_stats_head.py — the reference
collects cluster metadata + library-usage tags and reports them to a
collector URL, opt-out via RAY_USAGE_STATS_ENABLED).

This environment has zero egress, and phoning home is the wrong default
anyway — so the polarity is flipped: collection writes a LOCAL
machine-readable report (session_dir/usage_stats.json, also served at
/api/usage_stats) that operators can inspect or forward themselves.
External reporting would be the operator's own cron over that file.
Disable entirely with RAY_TPU_TORCH_USAGE_STATS_ENABLED=0."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

# library subpackages whose import marks a "feature used" tag
# (reference: usage_lib's library usage tags)
_LIBRARIES = (
    "ray_tpu_torch.train",
    "ray_tpu_torch.data",
    "ray_tpu_torch.tune",
    "ray_tpu_torch.serve",
    "ray_tpu_torch.rllib",
    "ray_tpu_torch.workflow",
    "ray_tpu_torch.dag",
    "ray_tpu_torch.util.collective",
    "ray_tpu_torch.util.multiprocessing",
    "ray_tpu_torch.util.joblib",
    "ray_tpu_torch.util.dask",
)


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") not in ("0", "false")


def library_usage() -> list:
    """Which libraries THIS process has imported (cheap sys.modules scan)."""
    return sorted(lib for lib in _LIBRARIES if lib in sys.modules)


def collect(state, session_info: Dict[str, Any],
            start_time: float) -> Dict[str, Any]:
    """One usage snapshot from cluster state (reference:
    usage_stats_head.py:generate_report shape, minus identity fields —
    no hostnames/IPs leave the report).  ``state`` is the dashboard's
    _DashboardState: the aggregation lives THERE (cluster_status), not
    duplicated here."""
    import platform

    payload: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "collected_at": time.time(),
        "uptime_s": round(time.time() - start_time, 1),
        "session_name": os.path.basename(
            session_info.get("session_dir", "") or ""
        ),
        "python_version": platform.python_version(),
        "platform": platform.system().lower(),
        "libraries_used": library_usage(),
    }
    try:
        status = state.cluster_status()
        total = status["resources_total"]
        payload.update(
            num_nodes_alive=status["nodes_alive"],
            num_nodes_total=status["nodes_alive"] + status["nodes_dead"],
            total_num_cpus=total.get("CPU", 0.0),
            # the port's accelerator is GPU where the reference counts TPU
            total_num_gpus=total.get("GPU", 0.0),
            custom_resources=sorted(
                k for k in total if k not in ("CPU", "GPU", "memory")
            ),
        )
        payload["num_actors"] = sum(
            1 for a in state.actors() if a.get("state") == "ALIVE"
        )
        payload["num_jobs"] = len(state.jobs() or [])
    except Exception:
        payload["cluster_state"] = "unavailable"
    return payload


def report_path(session_info: Dict[str, Any]) -> Optional[str]:
    sd = session_info.get("session_dir")
    return os.path.join(sd, "usage_stats.json") if sd else None


def write_report(state, session_info: Dict[str, Any],
                 start_time: float) -> Optional[Dict[str, Any]]:
    """Collect + atomically persist one snapshot; returns the payload.
    Only the periodic loop calls this — the HTTP endpoint serves
    collect() without a disk side effect.  The tmp name is
    pid-qualified anyway so even concurrent writers can't rename each
    other's half-written files into place."""
    if not enabled():
        return None
    path = report_path(session_info)
    if path is None:
        return None
    payload = collect(state, session_info, start_time)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return payload
