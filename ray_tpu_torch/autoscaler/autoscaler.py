"""StandardAutoscaler (reference: autoscaler/_private/autoscaler.py:172):
periodic loop — read load from GCS, launch nodes for unmet demand,
drain then terminate idle nodes past the timeout (idle scale-down goes
ALIVE -> DRAINING -> terminate so leases stop, actors migrate, and
sole-copy objects are re-replicated before the node disappears)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import (
    TAG_NODE_KIND,
    TAG_NODE_STATUS,
    TAG_NODE_TYPE,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import _fits, get_nodes_to_launch

logger = logging.getLogger(__name__)


def pick_replacement_type(node_types: Dict[str, dict],
                          lost_resources: Dict[str, float]) -> Optional[str]:
    """Smallest node type that covers a preempted node's resources — the
    capacity-return launch shape (shared by the v1 and v2 autoscalers).

    Only resource kinds DECLARED by some node type participate in the
    fit: a registered node's resources_total carries auto-detected extras
    (``memory`` from sysconf, per-node markers) that no provider spec
    ever declares — matching against the raw total would make every
    lost node infeasible and the feature silently inert.  Types carrying
    resource kinds the lost node did not have (e.g. a GPU node covering
    a plain-CPU loss) rank behind exact-kind covers."""
    managed: set = set()
    for spec in node_types.values():
        managed |= set(spec.get("resources", {}))
    lost_managed = {
        k: v for k, v in lost_resources.items() if v > 0 and k in managed
    }
    if not lost_managed:
        return None
    lost = set(lost_managed)
    candidates = [
        (
            len(set(spec.get("resources", {})) - lost),  # foreign kinds
            sum(spec.get("resources", {}).values()),
            name,
        )
        for name, spec in node_types.items()
        if _fits(lost_managed, dict(spec.get("resources", {})))
    ]
    if not candidates:
        return None
    return min(candidates)[2]


def fold_grow_hints(demands: List[Dict[str, float]], load_metrics: dict) -> None:
    """Shared v1/v2: fold elastic trainers' published grow intents into
    ``demands`` so replacement capacity is warm before
    the trainer's epoch-boundary grow attempt — a shrunken trainer
    queues no task demand while it adapts.

    Deduped against the lost_capacity feed: a preemption that shrank the
    trainer ALSO logged the node as lost capacity, and
    :func:`replacement_launches` relaunches it with zero demand.  Each
    lost entry whose resources cover the hinted shape absorbs one hinted
    worker; without this, every preemption boots two nodes for one lost
    worker (hint demand + capacity return)."""
    lost = [
        dict(e.get("resources_total", {}) or {})
        for e in load_metrics.get("lost_capacity", ())
    ]
    for hint in load_metrics.get("grow_hints", ()):
        shape = {
            k: v for k, v in (hint.get("resources") or {}).items() if v
        }
        if not shape:
            continue
        count = int(hint.get("count") or 0)
        remaining = []
        for total in lost:
            if count > 0 and all(
                total.get(k, 0) >= v for k, v in shape.items()
            ):
                count -= 1
            else:
                remaining.append(total)
        lost = remaining
        demands.extend(dict(shape) for _ in range(count))


def replacement_launches(node_types: Dict[str, dict], lost_capacity,
                         processed: set, budget: int) -> List[Tuple[str, str]]:
    """Shared v1/v2 capacity-return decision: which node types to launch
    for not-yet-processed preempted nodes, within `budget`.  Marks
    entries processed (including infeasible ones — there is no type that
    will ever cover them); entries skipped only for budget stay
    unprocessed and retry next tick.  Returns [(lost_node_id, type)]."""
    out: List[Tuple[str, str]] = []
    # Full-feed id set BEFORE the loop: the budget break below exits the
    # iteration early, and pruning `processed` against a partial prefix
    # would forget already-replaced ids past the break point (→ duplicate
    # launches once the budget frees up).
    feed_ids = {entry.get("node_id") for entry in lost_capacity}
    for entry in lost_capacity:
        lost_id = entry.get("node_id")
        if lost_id in processed:
            continue
        if budget - len(out) <= 0:
            break
        node_type = pick_replacement_type(
            node_types, entry.get("resources_total", {})
        )
        processed.add(lost_id)
        if node_type is None:
            continue
        out.append((lost_id, node_type))
    # The consumed-once memory only needs to cover entries still in the
    # feed (the GCS TTL-prunes it); dropping aged-out ids keeps the set
    # bounded over a long-lived autoscaler on a churning fleet.
    processed &= feed_ids
    return out


def request_node_drain(gcs_client, node_hex: Optional[str]) -> Optional[float]:
    """Ask the GCS to drain a node for idle scale-down (shared by the v1
    and v2 autoscalers).  Returns the monotonic terminate-by time (drain
    deadline + grace) on success, None when there is no drain path (no
    GCS client / unknown node / RPC failure) — callers fall back to the
    hard kill."""
    if node_hex is None or gcs_client is None:
        return None
    from ray_tpu_torch._private.config import CONFIG

    deadline_s = float(CONFIG.idle_drain_deadline_s)
    try:
        reply = gcs_client.call(
            "drain_node",
            {
                "node_id": bytes.fromhex(node_hex),
                "reason": "IDLE_TERMINATION",
                "deadline_s": deadline_s,
            },
            timeout=10,
        )
    except Exception:
        return None
    if not (reply and reply.get("accepted")):
        return None
    return time.monotonic() + deadline_s + 10.0


class StandardAutoscaler:
    def __init__(
        self,
        provider: NodeProvider,
        node_types: Dict[str, dict],
        *,
        max_workers: int = 8,
        idle_timeout_s: float = 60.0,
        upscaling_speed: float = 1.0,
        gcs_client=None,
    ):
        self.provider = provider
        self.node_types = node_types
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.upscaling_speed = upscaling_speed
        self.gcs_client = gcs_client
        self._idle_since: Dict[str, float] = {}
        # launches whose nodes have not yet registered with the GCS:
        # (node_type, launch time) — trimmed as nodes come up
        self._booting: List[tuple] = []
        # provider node id -> monotonic terminate-by time for nodes the
        # GCS is draining on our behalf; terminated once drain_complete
        # (or the node dies / the deadline passes).
        self._draining: Dict[str, float] = {}
        self._warned_no_mapping = False
        # Preempted-node ids whose replacement launch was already issued
        # (the GCS lost_capacity feed is a bounded log; process each once).
        self._lost_processed: set = set()
        self.num_launches = 0
        self.num_terminations = 0
        self.num_drains = 0
        self.num_capacity_returns = 0

    # -- one reconcile pass ---------------------------------------------
    def update(self, load_metrics: Optional[dict] = None):
        if load_metrics is None:
            load_metrics = self.gcs_client.call("get_load_metrics")
        demands: List[Dict[str, float]] = load_metrics.get("pending_demands", [])
        nodes_view: Dict[str, dict] = load_metrics.get("nodes", {})
        fold_grow_hints(demands, load_metrics)

        workers = self.provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})
        live_workers = sum(1 for n in nodes_view.values() if not n.get("is_head"))
        # launches still booting = provider nodes the GCS hasn't seen yet;
        # keep only that many of the most recent launch records so an
        # async create_node isn't double-counted as new demand next tick
        booting_count = max(0, len(workers) - live_workers)
        self._booting = self._booting[-booting_count:] if booting_count else []
        pending_launches: Dict[str, int] = {}
        for node_type, _t in self._booting:
            pending_launches[node_type] = pending_launches.get(node_type, 0) + 1

        # free capacity on live worker+head nodes (DRAINING nodes are
        # visible in the view for drain tracking but grant nothing)
        existing_free = [
            dict(n["available"])
            for n in nodes_view.values()
            if n.get("state", "ALIVE") == "ALIVE"
        ]

        to_launch = get_nodes_to_launch(
            demands,
            existing_free,
            self.node_types,
            pending_launches,
            self.max_workers,
            len(workers),
        )
        budget = self.max_workers - len(workers)
        for node_type, count in to_launch.items():
            # upscaling_speed >1 launches ahead of demand but never past
            # max_workers
            count = min(max(1, int(count * self.upscaling_speed)), max(0, budget))
            if count <= 0:
                continue
            budget -= count
            logger.info("autoscaler: launching %d x %s", count, node_type)
            self.provider.create_node(
                self.node_types[node_type].get("node_config", {"resources": self.node_types[node_type].get("resources", {})}),
                {TAG_NODE_KIND: "worker", TAG_NODE_TYPE: node_type},
                count,
            )
            now = time.monotonic()
            self._booting.extend((node_type, now) for _ in range(count))
            self.num_launches += count

        # Capacity return: a PREEMPTED node's resources are relaunched
        # even with no pending demand — an elastic trainer that shrank
        # through the preemption queues nothing, but wants its chips
        # back.  The replacement's ALIVE registration is the grow signal
        # train-side.  One launch per lost node, budget permitting.
        for lost_id, node_type in replacement_launches(
            self.node_types, load_metrics.get("lost_capacity", ()),
            self._lost_processed, budget,
        ):
            budget -= 1
            logger.info(
                "autoscaler: relaunching 1 x %s to replace preempted node %s",
                node_type, lost_id[:8],
            )
            try:
                self.provider.create_node(
                    self.node_types[node_type].get(
                        "node_config",
                        {"resources": self.node_types[node_type].get("resources", {})},
                    ),
                    {TAG_NODE_KIND: "worker", TAG_NODE_TYPE: node_type},
                    1,
                )
            except Exception:
                # Transient provider failure (the native weather of a
                # preemptible fleet): unmark so the next tick retries
                # instead of dropping the replacement forever.
                logger.exception("capacity-return launch of %s failed", node_type)
                self._lost_processed.discard(lost_id)
                budget += 1
                continue
            self._booting.append((node_type, time.monotonic()))
            self.num_launches += 1
            self.num_capacity_returns += 1

        # finalize in-flight drains: terminate once the GCS reports the
        # migration complete (or the node died / the deadline passed)
        now = time.monotonic()
        for node_id in list(self._draining):
            addr = self.provider.raylet_address(node_id)
            _hex, rec = self._node_view_for(nodes_view, addr)
            if (
                rec is None
                or rec.get("state") == "DEAD"
                or rec.get("drain_complete")
                or now > self._draining[node_id]
            ):
                logger.info("autoscaler: terminating drained node %s", node_id)
                self._draining.pop(node_id, None)
                self.provider.terminate_node(node_id)
                self.num_terminations += 1

        # idle termination: a worker node with full availability == idle.
        # Scale-down is graceful: drain through the GCS first so in-flight
        # work lands and nothing new is scheduled, then terminate.
        for node_id in workers:
            if node_id in self._draining:
                continue
            addr = self.provider.raylet_address(node_id)
            if addr is None:
                if not self._warned_no_mapping:
                    logger.warning(
                        "provider %s does not implement raylet_address(); "
                        "idle nodes will never be scaled down",
                        type(self.provider).__name__,
                    )
                    self._warned_no_mapping = True
                continue
            node_hex, rec = self._node_view_for(nodes_view, addr)
            idle = (
                rec is not None
                and rec.get("state", "ALIVE") == "ALIVE"
                and _dicts_equal(rec["available"], rec["total"])
            )
            if idle and not demands:
                first = self._idle_since.setdefault(node_id, now)
                if now - first > self.idle_timeout_s:
                    self._idle_since.pop(node_id, None)
                    terminate_by = request_node_drain(self.gcs_client, node_hex)
                    if terminate_by is not None:
                        logger.info("autoscaler: draining idle node %s", node_id)
                        self.num_drains += 1
                        self._draining[node_id] = terminate_by
                    else:
                        # No drain path (GCS unreachable / unknown node):
                        # fall back to the hard kill.
                        logger.info("autoscaler: terminating idle node %s", node_id)
                        self.provider.terminate_node(node_id)
                        self.num_terminations += 1
            else:
                self._idle_since.pop(node_id, None)

    @staticmethod
    def _node_view_for(
        nodes_view: dict, raylet_address: Optional[str]
    ) -> Tuple[Optional[str], Optional[dict]]:
        if raylet_address is None:
            return None, None
        for node_hex, rec in nodes_view.items():
            if rec.get("raylet_address") == raylet_address:
                return node_hex, rec
        return None, None


def _dicts_equal(a: Dict[str, float], b: Dict[str, float]) -> bool:
    keys = set(a) | set(b)
    return all(abs(a.get(k, 0.0) - b.get(k, 0.0)) < 1e-9 for k in keys)


class Monitor:
    """Autoscaler loop runner (reference: autoscaler/_private/monitor.py:127)."""

    def __init__(self, autoscaler: StandardAutoscaler, interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        def loop():
            while not self._stop.is_set():
                try:
                    self.autoscaler.update()
                except Exception:
                    logger.exception("autoscaler update failed")
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
