"""Autoscaler v2 SDK (reference: python/ray/autoscaler/v2/sdk.py
request_cluster_resources): declarative minimum cluster shape, stored
in the GCS KV and folded into the scheduler's demand every tick."""

from __future__ import annotations

import json
from typing import Dict, List

KV_NS = b"autoscaler_v2"
KEY = b"cluster_resource_constraints"


def request_cluster_resources(bundles: List[Dict[str, float]], gcs_client=None) -> None:
    """Ask the autoscaler to keep capacity for `bundles` (e.g.
    [{"CPU": 4}, {"GPU": 1}]) regardless of current task demand.  Pass
    an empty list to clear."""
    if gcs_client is None:
        from ray_tpu_torch._private.worker import get_global_worker

        gcs_client = get_global_worker().gcs_client
    gcs_client.call("kv_put", (KV_NS, KEY, json.dumps(bundles).encode(), True))


def get_cluster_resource_constraints(gcs_client) -> List[Dict[str, float]]:
    blob = gcs_client.call("kv_get", (KV_NS, KEY))
    return json.loads(blob) if blob else []
