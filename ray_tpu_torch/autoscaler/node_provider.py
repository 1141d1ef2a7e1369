"""NodeProvider interface (reference: python/ray/autoscaler/node_provider.py:13)
+ FakeMultiNodeProvider for tests (reference:
autoscaler/_private/fake_multi_node/node_provider.py — simulated nodes as
local raylet processes, the pattern the reference uses to test scaling
without clouds)."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

TAG_NODE_KIND = "node-kind"  # head | worker
TAG_NODE_TYPE = "node-type"
TAG_NODE_STATUS = "node-status"  # pending | up-to-date | terminated


class NodeProvider:
    """Pluggable cloud abstraction: the autoscaler only sees opaque node
    ids + tags."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any], tags: Dict[str, str], count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> Optional[str]:
        return None

    def raylet_address(self, node_id: str) -> Optional[str]:
        """Map a provider node to the raylet address it registered with the
        GCS.  Needed for idle detection and boot tracking; providers that
        return None get no idle scale-down (a warning is logged)."""
        return None


class FakeMultiNodeProvider(NodeProvider):
    """'Launches' nodes as extra raylet processes against the live GCS."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str = "fake"):
        super().__init__(provider_config, cluster_name)
        self.gcs_address = provider_config["gcs_address"]
        self.session_dir = provider_config["session_dir"]
        self._nodes: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        with self._lock:
            out = []
            for nid, rec in self._nodes.items():
                if rec["tags"].get(TAG_NODE_STATUS) == "terminated":
                    continue
                if all(rec["tags"].get(k) == v for k, v in tag_filters.items()):
                    out.append(nid)
            return out

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def create_node(self, node_config, tags, count):
        from ray_tpu_torch._private.node import start_worker_node

        created = []
        for _ in range(count):
            nid = f"fake-{uuid.uuid4().hex[:8]}"
            resources = dict(node_config.get("resources", {"CPU": 1}))
            proc, raylet_addr = start_worker_node(
                self.gcs_address,
                self.session_dir,
                num_cpus=int(resources.get("CPU", 1)),
                # Port: the node type's own GPU count, 0 where it has none.
                # Left unset, the node would count this machine's cards
                # (_private/node.py:detect_resources), and the autoscaler
                # would plan against a node shape it did not launch.
                num_gpus=resources.get("GPU", 0),
                resources={k: v for k, v in resources.items()
                           if k not in ("CPU", "GPU", "memory")},
                memory=resources.get("memory"),
                wait=True,
            )
            rec = {
                "proc": proc,
                "raylet_address": raylet_addr,
                "tags": dict(tags, **{TAG_NODE_STATUS: "up-to-date"}),
                "created_at": time.time(),
            }
            with self._lock:
                self._nodes[nid] = rec
            created.append(nid)
        return created

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None:
                return
            rec["tags"][TAG_NODE_STATUS] = "terminated"
        proc = rec["proc"]
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except Exception:
                proc.kill()

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            rec = self._nodes.get(node_id)
        return rec is not None and rec["proc"].poll() is None

    def raylet_address(self, node_id: str) -> Optional[str]:
        with self._lock:
            rec = self._nodes.get(node_id)
        return rec["raylet_address"] if rec else None
