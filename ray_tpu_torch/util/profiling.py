"""Driver-side profiling orchestration: attach the on-demand sampling
profiler to live processes, collect the dumps, and merge them into one
cluster profile (reference: `ray timeline` + py-spy attach workflows).

``ray_tpu_torch.util.state.profile(target, duration_s)`` is the front door.
The reference's dashboard drives the same orchestration from ``/api/profile``
with its own GCS/raylet clients (no connected worker); the port has no
dashboard yet (ROADMAP Queue A item 6(e)), but everything here stays
parameterized by two callables so that one can:

- ``gcs_call(method, payload)``  — one RPC to the GCS
- ``node_call(address, method, payload)`` — one RPC to a raylet/worker

Targets resolve to ``(label, address-or-gcs)`` pairs; labels key the
merged flamegraph (``actor:<tenant>/<class>``, ``worker:<pid>``,
``raylet:<node>``, ``gcs``) so a cluster-wide capture reads per-actor,
per-tenant at the roots.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import profiling as _prof
from ray_tpu_torch._private.profiling import (  # re-exported: the public error surface
    ProfilerConflictError,
    ProfilerError,
    ProfilerSessionNotFound,
)

__all__ = [
    "ProfileResult",
    "ProfilerError",
    "ProfilerConflictError",
    "ProfilerSessionNotFound",
    "resolve_targets",
    "run_profile",
]

_GCS_TARGET = "__gcs__"


class ProfileResult:
    """Merged outcome of one orchestrated capture across N processes.

    ``profiles`` holds the per-process capture records (possibly
    partial — a target that died mid-capture contributes whatever it
    shipped before dying, or an ``errors`` entry); exports fold them
    into collapsed-stack text or speedscope JSON.
    """

    def __init__(
        self,
        profiles: List[Dict[str, Any]],
        errors: List[Dict[str, str]],
        shared: Optional[List[Dict[str, str]]] = None,
    ):
        self.profiles = profiles
        self.errors = errors
        # Targets whose process was already being captured under another
        # label (the head node co-hosts GCS + raylet in one process):
        # their samples arrive via that other capture, not an error.
        self.shared = shared or []

    @property
    def total_samples(self) -> int:
        return sum(p.get("sample_count", 0) for p in self.profiles)

    @property
    def complete(self) -> bool:
        return not self.errors

    def merged_samples(self) -> Dict[str, int]:
        """Cluster-wide folded stacks, rooted at each process label."""
        return _prof.merge_records(self.profiles)

    def collapsed(self) -> str:
        """Collapsed-stack text (flamegraph.pl / speedscope import)."""
        lines = [f"{k} {v}" for k, v in sorted(self.merged_samples().items())]
        return "\n".join(lines) + ("\n" if lines else "")

    def speedscope(self) -> Dict[str, Any]:
        return _prof.speedscope(self.profiles)

    def top_frames(self, n: int = 10) -> List[Tuple[str, int, float]]:
        return _prof.top_frames(self.profiles, n)

    def attribution(self, needle: str) -> float:
        """Fraction of all samples whose stack mentions ``needle`` —
        the acceptance probe ("&ge;80% of samples in the workload")."""
        total = hit = 0
        for stack, count in self.merged_samples().items():
            total += count
            if needle in stack:
                hit += count
        return (hit / total) if total else 0.0

    def save(self, path: str, fmt: str = "collapsed") -> str:
        """Write ``collapsed`` text or ``speedscope`` JSON to ``path``."""
        if fmt == "collapsed":
            body = self.collapsed()
        elif fmt == "speedscope":
            body = json.dumps(self.speedscope())
        else:
            raise ValueError(f"unknown profile format {fmt!r}")
        with open(path, "w") as f:
            f.write(body)
        return path

    def summary(self) -> Dict[str, Any]:
        return {
            "targets": [p.get("label") for p in self.profiles],
            "total_samples": self.total_samples,
            "errors": self.errors,
            "shared": self.shared,
            "top_frames": [
                {"frame": f, "samples": c, "fraction": round(fr, 4)}
                for f, c, fr in self.top_frames(10)
            ],
        }


# ----------------------------------------------------------------------
# target resolution
# ----------------------------------------------------------------------
def _actor_target(info: Dict[str, Any]) -> Tuple[str, str]:
    if not info:
        raise ValueError("no such actor")
    if info.get("state") != "ALIVE":
        raise ValueError(f"actor is {info.get('state')}, not ALIVE")
    addr = info.get("worker_address")
    if not addr:
        raise ValueError("actor's worker has no direct RPC endpoint")
    tenant = info.get("tenant") or "default"
    name = info.get("name") or info.get("class_name") or "actor"
    return (f"actor:{tenant}/{name}", addr)


def resolve_targets(
    target: Any,
    gcs_call: Callable[[str, Any], Any],
    include_workers: bool = True,
) -> List[Tuple[str, str]]:
    """Resolve ``target`` into ``[(label, address)]``; address
    ``__gcs__`` means "call the GCS itself".

    Accepted targets: an ``ActorHandle``; an actor id (hex str or
    ``ActorID``); a node id hex (profiles that raylet, plus its workers
    when ``include_workers``); ``"gcs"``; ``None``/``"cluster"`` for
    everything (GCS + every raylet + every worker).
    """
    from ray_tpu_torch._private.ids import ActorID, NodeID

    # ActorHandle without importing the actor module up front.
    actor_id = None
    if hasattr(target, "_actor_id"):
        actor_id = target._actor_id
    elif isinstance(target, ActorID):
        actor_id = target

    if actor_id is not None:
        # A just-created actor may still be PENDING_CREATION; give it a
        # short window to come up rather than failing the attach.
        from ray_tpu_torch._private import retry

        bo = retry.POLL.start(deadline_s=10.0)
        while True:
            info = gcs_call("get_actor_info", actor_id.binary())
            if info and info.get("state") in ("PENDING_CREATION", "RESTARTING"):
                delay = bo.next_delay()
                if delay is not None:
                    time.sleep(delay)
                    continue
            return [_actor_target(info)]

    if target == "gcs":
        return [("gcs", _GCS_TARGET)]

    if isinstance(target, NodeID):
        target = target.hex()

    if target not in (None, "", "cluster") and not isinstance(target, str):
        # An unrecognized TYPE must not silently widen to a cluster-wide
        # capture (which consumes the one-session slot in EVERY
        # process) — fail loudly like the unrecognized-string case.
        raise ValueError(f"unrecognized profile target {target!r}")

    info = gcs_call("get_cluster_info", None)
    nodes = {NodeID(n["node_id"]).hex(): n for n in info["nodes"].values()}

    if isinstance(target, str) and target in nodes:
        return _node_targets(nodes[target], target, include_workers)

    if isinstance(target, str) and target not in ("", "cluster"):
        # Hex actor id as a plain string.
        try:
            aid = ActorID(bytes.fromhex(target))
        except ValueError:
            raise ValueError(f"unrecognized profile target {target!r}") from None
        return [_actor_target(gcs_call("get_actor_info", aid.binary()))]

    # cluster-wide
    out: List[Tuple[str, str]] = [("gcs", _GCS_TARGET)]
    for hexid, n in sorted(nodes.items()):
        if n.get("state") not in ("ALIVE", "DRAINING"):
            continue
        out.extend(_node_targets(n, hexid, include_workers))
    return out


def _node_targets(node: Dict[str, Any], hexid: str, include_workers: bool):
    out = [(f"raylet:{hexid[:8]}", node["raylet_address"])]
    if include_workers:
        # Worker endpoints come from the raylet at capture time (the
        # orchestrator asks node_stats right before attaching).
        out.append((f"__workers_of__:{hexid[:8]}", node["raylet_address"]))
    return out


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------
def run_profile(
    targets: List[Tuple[str, str]],
    gcs_call: Callable[..., Any],
    node_call: Callable[..., Any],
    duration_s: float = 5.0,
    hz: Optional[float] = None,
    mode: str = "wall",
    rpc_timeout_s: float = 10.0,
) -> ProfileResult:
    """Attach to every target, wait out the capture, dump, merge.

    Attach/dump RPCs are serial but carry ``rpc_timeout_s`` (not the
    120 s default): one wedged process — exactly the kind a cluster
    capture wants to look at — costs seconds per target, not minutes.

    Dies-mid-capture semantics: a target whose dump fails contributes
    an ``errors`` entry; if its process shipped a (partial or complete)
    record to the GCS profile table before dying, that record is
    recovered from there.  The rest of the targets are unaffected —
    the result is partial, never an exception.
    """
    # Floor: a negative/zero duration would attach samplers everywhere
    # and then die in time.sleep() below.  Ceiling: samplers clamp
    # themselves to profile_max_duration_s — sleeping longer than that
    # would block the caller past the capture window and silently
    # return a truncated profile.
    from ray_tpu_torch._private.config import CONFIG

    try:
        max_duration = float(CONFIG.profile_max_duration_s)
    except Exception:  # noqa: BLE001
        max_duration = 600.0
    duration_s = min(max(0.05, float(duration_s)), max_duration)

    def call(addr: str, method: str, payload: Any):
        if addr == _GCS_TARGET:
            return gcs_call(method, payload, rpc_timeout_s)
        return node_call(addr, method, payload, rpc_timeout_s)

    expanded: List[Tuple[str, str]] = []
    errors: List[Dict[str, str]] = []
    for label, addr in targets:
        if label.startswith("__workers_of__:"):
            node_tag = label.split(":", 1)[1]
            try:
                stats = call(addr, "node_stats", {})
            except Exception as e:  # noqa: BLE001 — raylet gone: note and move on
                errors.append({"target": label, "error": f"{type(e).__name__}: {e}"})
                continue
            for w in stats.get("workers", []):
                waddr = w.get("direct_address")
                if not waddr or w.get("state") == "DEAD":
                    continue
                # Root labels key the merged flamegraph by actor/tenant
                # (no spaces — labels are collapsed-stack frames).
                tenant = w.get("tenant") or "default"
                if w.get("actor_id"):
                    wlabel = (
                        f"actor:{tenant}/{w['actor_id'][:8]}/pid{w.get('pid')}"
                    )
                else:
                    wlabel = f"worker:{tenant}/{node_tag}/pid{w.get('pid')}"
                expanded.append((wlabel, waddr))
        else:
            expanded.append((label, addr))

    started: List[Tuple[str, str, str]] = []  # (label, addr, session_id)
    shared: List[Dict[str, str]] = []
    for label, addr in expanded:
        payload = {
            "duration_s": duration_s,
            "hz": hz,
            "mode": mode,
            "label": label,
        }
        try:
            rep = call(addr, "profile_start", payload)
            started.append((label, addr, rep["session_id"]))
        except ProfilerConflictError as e:
            if e.session_id and e.session_id in {s[2] for s in started}:
                # Same process already attached by THIS capture under
                # another label (the head co-hosts GCS + its raylet):
                # its samples arrive via that session — a note, not a
                # failure.
                shared.append({"target": label, "session_id": e.session_id})
            else:
                # Someone else's live session owns this process: its
                # samples will NOT be in this result — surface it.
                errors.append(
                    {
                        "target": label,
                        "error": (
                            "profiler busy: another session "
                            f"({e.session_id or 'unknown'}) is attached to this "
                            "process"
                        ),
                    }
                )
        except Exception as e:  # noqa: BLE001 — dead target: partial capture
            errors.append({"target": label, "error": f"{type(e).__name__}: {e}"})

    if started:
        time.sleep(duration_s)

    profiles: List[Dict[str, Any]] = []
    for label, addr, sid in started:
        dump_payload = {"session_id": sid, "stop": True}
        try:
            rec = call(addr, "profile_dump", dump_payload)
            profiles.append(rec)
        except Exception as e:  # noqa: BLE001 — died mid-capture
            rec = _recover_from_gcs(gcs_call, sid)
            if rec is not None:
                profiles.append(rec)
            else:
                errors.append(
                    {
                        "target": label,
                        "session_id": sid,
                        "error": f"died mid-capture: {type(e).__name__}: {e}",
                    }
                )
    return ProfileResult(profiles, errors, shared)


def _recover_from_gcs(gcs_call, session_id: str) -> Optional[Dict[str, Any]]:
    """A dead target may still have shipped its record through the GCS
    report path (natural end of capture races the process kill)."""
    try:
        for rec in gcs_call("list_profiles", {"session_id": session_id}) or []:
            return rec
    except Exception:  # noqa: BLE001
        pass
    return None
