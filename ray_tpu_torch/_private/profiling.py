"""On-demand sampling profiler and device-memory gauges: the cluster's
bottleneck-attribution plane.

Spans and RPC/task-phase metrics say *where time went between
processes*.  This module answers the next two questions (reference: `ray
timeline` + per-worker py-spy/memray hooks):

- **What is a hot process doing?**  A stdlib-only wall/CPU sampling
  profiler: a daemon thread walks ``sys._current_frames()`` at a
  configurable Hz and folds stacks into counts.  Any live worker /
  actor host / raylet / the GCS can be attached via the
  ``profile_start`` / ``profile_stop`` / ``profile_dump`` RPC surface
  (handlers delegate to ``handle_profile_*`` here — they never block
  the dispatch loop).  Finished captures also ship to the GCS profile
  table through the existing metrics/span report channel, so a capture
  survives its driver.
- **What is the card's memory doing?**  ``report_device_memory``
  publishes ``torch.cuda.memory_stats`` gauges in a process that already
  holds a CUDA context (a no-op otherwise).

Exports: ``collapse`` (collapsed-stack / flamegraph lines),
``speedscope`` (speedscope JSON), ``merge_records`` (fold per-process
captures into one cluster profile keyed by actor/tenant label).
``ray_tpu_torch.util.profiling`` is the driver-side orchestration on top.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG


class ProfilerError(Exception):
    """Base error of the profiling plane."""


class ProfilerConflictError(ProfilerError):
    """A session is already running in this process.  One sampler per
    process: two concurrent captures would double the overhead and
    interleave their sample sets; the second attach gets this typed
    error (carrying the live session id) instead of silently sharing."""

    def __init__(self, message: str, session_id: str = ""):
        super().__init__(message)
        self.session_id = session_id

    def __reduce__(self):
        # Keep session_id across the RPC pickle boundary (default
        # Exception reduction only replays args[0]).
        return (type(self), (self.args[0], self.session_id))


class ProfilerSessionNotFound(ProfilerError):
    """stop/dump named a session this process doesn't have (already
    reaped, or the caller's target restarted in between)."""


# Fallback idle heuristic for CPU mode on platforms without per-thread
# CPU accounting (/proc): leaf functions that mean "this thread is
# parked, not computing".  The blocking call itself is C code (no
# Python frame), so the heuristic keys on the Python caller
# conventionally wrapping it.
_IDLE_LEAF_NAMES = frozenset(
    {
        "wait",
        "_wait_for_tstate_lock",
        "select",
        "poll",
        "epoll",
        "accept",
        "recv",
        "recv_into",
        "readexactly",
        "_recv_exact",
        "read",
        "readline",
        "get",  # queue.Queue.get parks on a condition
        "join",
        "flush_loop",
        "run_forever",
        "sleep",
    }
)


class _ThreadCpuClock:
    """Per-thread CPU-time deltas from /proc/self/task/<tid>/stat
    (Linux).  A thread whose utime+stime did not advance since the last
    sample was parked (C-level sleep/select/recv included — which the
    Python-frame leaf heuristic cannot see).  ``delta(py_tid)`` is
    None when accounting is unavailable → caller falls back to the
    leaf-name heuristic."""

    def __init__(self):
        self._available = os.path.isdir("/proc/self/task")
        self._native: Dict[int, int] = {}  # python tid -> native tid
        self._last: Dict[int, int] = {}  # native tid -> cpu jiffies

    def _refresh_native_map(self) -> None:
        for t in threading.enumerate():
            nid = getattr(t, "native_id", None)
            if nid is not None:
                self._native[t.ident] = nid

    def _cpu_jiffies(self, native_tid: int) -> Optional[int]:
        try:
            with open(f"/proc/self/task/{native_tid}/stat", "rb") as f:
                data = f.read()
            # utime, stime are fields 14, 15 (1-based), after the
            # parenthesized comm which may itself contain spaces.
            rest = data.rsplit(b")", 1)[1].split()
            return int(rest[11]) + int(rest[12])
        except (OSError, IndexError, ValueError):
            return None

    def delta(self, py_tid: int) -> Optional[int]:
        """CPU jiffies this thread burned since its previous probe;
        None = unknown (no accounting for this thread/platform).  Used
        as the sample WEIGHT: when GIL contention stretches the tick
        interval, a continuously-computing thread still accrues its
        full CPU time while a housekeeping loop's 1-jiffy blip stays a
        blip."""
        if not self._available:
            return None
        nid = self._native.get(py_tid)
        if nid is None:
            self._refresh_native_map()
            nid = self._native.get(py_tid)
            if nid is None:
                return None
        cur = self._cpu_jiffies(nid)
        if cur is None:
            # Stale mapping: the thread behind this Python ident exited
            # and a new thread reused the ident — re-resolve once so
            # churned threads don't permanently fall back to the leaf
            # heuristic (or read a recycled tid's clock).
            self._native.pop(py_tid, None)
            self._refresh_native_map()
            nid = self._native.get(py_tid)
            cur = self._cpu_jiffies(nid) if nid is not None else None
            if cur is None:
                return None
        prev = self._last.get(nid)
        self._last[nid] = cur
        if prev is None:
            return 0  # no baseline yet: treat the first probe as idle
        return max(0, cur - prev)


def _frame_label(code) -> str:
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class SamplingProfiler:
    """One capture: a daemon thread sampling every live thread's stack.

    ``mode="wall"`` keeps every sample; ``mode="cpu"`` drops samples
    whose leaf frame is a known parked-thread idiom (see
    ``_IDLE_LEAF_NAMES``) — an approximation, but a useful one without
    OS-level thread state (stdlib-only by design).
    """

    def __init__(
        self,
        session_id: str,
        hz: float,
        duration_s: float,
        mode: str = "wall",
        label: str = "",
        on_finish=None,
    ):
        self.session_id = session_id
        self.hz = max(1.0, min(float(hz), 1000.0))
        self.duration_s = float(duration_s)
        self.mode = mode if mode in ("wall", "cpu") else "wall"
        self.label = label
        self.started_at = time.time()
        self.ended_at: Optional[float] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[str, ...], int] = {}
        self._ticks = 0
        self._sample_count = 0
        self._idle_dropped = 0
        self._threads_seen: set = set()
        self._errors: List[str] = []
        self._max_depth = int(CONFIG.profile_max_stack_depth)
        self._on_finish = on_finish
        self._cpu_clock = _ThreadCpuClock() if self.mode == "cpu" else None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"profile-sampler-{session_id[:8]}"
        )

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        deadline = time.monotonic() + self.duration_s
        own_tid = threading.get_ident()
        try:
            while not self._stop.is_set() and time.monotonic() < deadline:
                t0 = time.perf_counter()
                self._sample_once(own_tid)
                # Absorb the sampling cost into the interval so the
                # effective rate stays ~hz instead of hz + walk time.
                self._stop.wait(max(0.0005, interval - (time.perf_counter() - t0)))
        except Exception as e:  # noqa: BLE001 — a broken sampler must end cleanly
            with self._lock:
                self._errors.append(f"sampler died: {type(e).__name__}: {e}")
        finally:
            with self._lock:
                self.ended_at = time.time()
            if self._on_finish is not None:
                try:
                    self._on_finish(self)
                except Exception:  # noqa: BLE001 — best-effort ship
                    pass

    def _sample_once(self, own_tid: int) -> None:
        # Phase 1 — walk every stack WITHOUT any GIL-releasing call in
        # between: the frame objects in the snapshot stay live only
        # while the sampled threads cannot run.  (The CPU-clock probes
        # below do file I/O, which releases the GIL; probing first once
        # produced truncated single-frame stacks of frames the thread
        # had already popped.)
        frames = sys._current_frames()
        walked: List[Tuple[int, str, Tuple[str, ...]]] = []
        for tid, top in frames.items():
            if tid == own_tid:
                continue
            stack: List[str] = []
            f = top
            depth = 0
            while f is not None and depth < self._max_depth:
                stack.append(_frame_label(f.f_code))
                f = f.f_back
                depth += 1
            stack.reverse()
            walked.append((tid, top.f_code.co_name, tuple(stack)))
        # Phase 2 — filter + fold (CPU-clock probes may release the GIL
        # freely now; the stacks are already copied out as strings).
        with self._lock:
            self._ticks += 1
            for tid, leaf_name, key in walked:
                self._threads_seen.add(tid)
                weight = 1
                if self.mode == "cpu":
                    # Real per-thread CPU accounting where the OS
                    # provides it (samples weighted by jiffies burned);
                    # leaf-name heuristic otherwise.
                    delta = self._cpu_clock.delta(tid)
                    if delta == 0 or (
                        delta is None and leaf_name in _IDLE_LEAF_NAMES
                    ):
                        self._idle_dropped += 1
                        continue
                    if delta is not None:
                        weight = delta
                self._samples[key] = self._samples.get(key, 0) + weight
                self._sample_count += weight

    # -- export ---------------------------------------------------------
    def snapshot(self, partial: Optional[bool] = None) -> Dict[str, Any]:
        """The session's record — safe to call mid-capture (a dump of a
        dying worker returns whatever was sampled so far)."""
        with self._lock:
            samples = {";".join(k): v for k, v in self._samples.items()}
            errors = list(self._errors)
            ticks, count = self._ticks, self._sample_count
            idle, nthreads = self._idle_dropped, len(self._threads_seen)
            ended_at = self.ended_at
        return {
            "session_id": self.session_id,
            "label": self.label,
            "pid": os.getpid(),
            "hz": self.hz,
            "mode": self.mode,
            "duration_s": self.duration_s,
            "started_at": self.started_at,
            "ended_at": ended_at,
            "running": self.running if partial is None else partial,
            "ticks": ticks,
            "sample_count": count,
            "idle_dropped": idle,
            "threads_seen": nthreads,
            "errors": errors,
            "samples": samples,
        }


# ----------------------------------------------------------------------
# per-process session registry (one active capture per process)
# ----------------------------------------------------------------------
_registry_lock = threading.Lock()
_active: Optional[SamplingProfiler] = None
_last_record: Optional[Dict[str, Any]] = None


def _ship_finished(profiler: SamplingProfiler) -> None:
    """Natural end of a capture: cache the record locally (a late dump
    RPC still gets it) and ship it to the GCS profile table through the
    existing report channel (worker GCS client, or the raylet/GCS
    report channel — same path spans ride)."""
    global _last_record
    record = profiler.snapshot(partial=False)
    with _registry_lock:
        _last_record = record
    from ray_tpu_torch._private import telemetry

    telemetry.count_profile_session("completed")
    try:
        from ray_tpu_torch.util import metrics as metrics_mod
        from ray_tpu_torch.util import tracing

        tracing.record_event_span(
            "profile.capture",
            record["started_at"],
            record["ended_at"] or time.time(),
            attributes={
                "label": record["label"],
                "hz": record["hz"],
                "mode": record["mode"],
                "sample_count": record["sample_count"],
            },
        )
        metrics_mod.report(
            "profile_report",
            {
                "profile": record,
                # per-tenant accounting in the GCS profile table (same
                # stamp the span flusher carries)
                "tenant": os.environ.get("RAY_TPU_TORCH_TENANT") or "default",
            },
        )
    except Exception:  # noqa: BLE001 — shipping is best-effort
        pass


def handle_profile_start(payload: Optional[dict]) -> Dict[str, Any]:
    """RPC surface: attach a sampler to THIS process.  Non-blocking —
    spawns the daemon sampler thread and returns immediately."""
    global _active
    payload = payload or {}
    duration = min(
        max(0.05, float(payload.get("duration_s") or 10.0)),
        float(CONFIG.profile_max_duration_s),
    )
    hz = float(payload.get("hz") or CONFIG.profile_default_hz)
    mode = payload.get("mode") or "wall"
    label = str(payload.get("label") or f"pid:{os.getpid()}")
    session_id = payload.get("session_id") or _new_session_id()
    with _registry_lock:
        # Conflict gate keys on ended_at, not thread liveness: a just-
        # registered session whose thread hasn't started yet (start()
        # below, still under this lock) and a running one both have
        # ended_at None — checking Thread.is_alive() here left a window
        # where a concurrent attach could silently overwrite the
        # registry and double the sampling overhead.
        if _active is not None and _active.ended_at is None:
            from ray_tpu_torch._private import telemetry

            telemetry.count_profile_session("conflict")
            raise ProfilerConflictError(
                f"a profile session ({_active.session_id}) is already running "
                f"in pid {os.getpid()}; stop it or wait for its deadline",
                session_id=_active.session_id,
            )
        prof = SamplingProfiler(
            session_id, hz, duration, mode=mode, label=label, on_finish=_ship_finished
        )
        _active = prof
        try:
            prof.start()
        except Exception:
            # Thread spawn failed (e.g. at the process thread limit): a
            # registered-but-never-started session would hold the
            # conflict gate (ended_at stays None with no thread to set
            # it) and brick profiling for the process — release the
            # slot and surface the error instead.
            _active = None
            raise
    return {
        "session_id": session_id,
        "pid": os.getpid(),
        "hz": prof.hz,
        "mode": prof.mode,
        "duration_s": duration,
        "started_at": prof.started_at,
        "label": label,
    }


def _find(session_id: Optional[str]) -> SamplingProfiler:
    if _active is None or (session_id and _active.session_id != session_id):
        raise ProfilerSessionNotFound(
            f"no profile session {session_id or '<any>'} in pid {os.getpid()}"
        )
    return _active


def handle_profile_stop(payload: Optional[dict]) -> Dict[str, Any]:
    """Stop the capture early; returns the final record."""
    payload = payload or {}
    with _registry_lock:
        prof = _find(payload.get("session_id"))
    prof.stop()
    # The sampler thread exits within one interval; don't join on the
    # dispatch loop — snapshot now (records through the last tick).
    return prof.snapshot(partial=False)


def handle_profile_dump(payload: Optional[dict]) -> Dict[str, Any]:
    """Dump the capture (partial if still running).  ``stop=True``
    (default) also ends it — the one-call dump-and-detach the driver
    orchestration uses."""
    global _last_record
    payload = payload or {}
    sid = payload.get("session_id")
    with _registry_lock:
        if _active is None or (sid and _active.session_id != sid):
            if _last_record is not None and (
                not sid or _last_record["session_id"] == sid
            ):
                return _last_record
            raise ProfilerSessionNotFound(
                f"no profile session {sid or '<any>'} in pid {os.getpid()}"
            )
        prof = _active
    if payload.get("stop", True):
        prof.stop()
    return prof.snapshot()


def active_session_id() -> Optional[str]:
    with _registry_lock:
        if _active is not None and _active.running:
            return _active.session_id
    return None


def _new_session_id() -> str:
    import secrets

    return secrets.token_hex(8)


# ----------------------------------------------------------------------
# export formats (pure functions; shared by util.profiling + dashboard)
# ----------------------------------------------------------------------
def collapse(record: Dict[str, Any], root: Optional[str] = None) -> str:
    """Brendan-Gregg collapsed-stack lines ("f1;f2;f3 count"), the
    input format of flamegraph.pl / speedscope / inferno.  ``root``
    (default: the record's label) prefixes every stack so merged
    cluster profiles stay attributable per process."""
    prefix = record.get("label", "") if root is None else root
    lines = []
    for stack, count in sorted(record.get("samples", {}).items()):
        line = f"{prefix};{stack}" if prefix else stack
        lines.append(f"{line} {count}")
    return "\n".join(lines) + ("\n" if lines else "")


def merge_records(records: List[Dict[str, Any]]) -> Dict[str, int]:
    """Fold per-process capture records into one cluster-wide stack
    map, each stack rooted at its process label (actor/tenant/raylet),
    so one flamegraph shows the whole cluster with per-target subtrees."""
    merged: Dict[str, int] = {}
    for rec in records:
        prefix = rec.get("label", "")
        for stack, count in rec.get("samples", {}).items():
            key = f"{prefix};{stack}" if prefix else stack
            merged[key] = merged.get(key, 0) + count
    return merged


def speedscope(records: List[Dict[str, Any]], name: str = "ray_tpu_torch profile") -> Dict[str, Any]:
    """Speedscope JSON (sampled profiles, one per capture record) —
    https://www.speedscope.app file-format-schema.  Aggregated stacks
    become one weighted sample each; weights are sample counts."""
    frames: List[Dict[str, str]] = []
    frame_idx: Dict[str, int] = {}

    def fidx(label: str) -> int:
        i = frame_idx.get(label)
        if i is None:
            i = frame_idx[label] = len(frames)
            frames.append({"name": label})
        return i

    profiles = []
    for rec in records:
        samples: List[List[int]] = []
        weights: List[float] = []
        for stack, count in sorted(rec.get("samples", {}).items()):
            samples.append([fidx(fr) for fr in stack.split(";")])
            weights.append(float(count))
        profiles.append(
            {
                "type": "sampled",
                "name": rec.get("label") or f"pid {rec.get('pid')}",
                "unit": "none",
                "startValue": 0.0,
                "endValue": float(sum(weights)),
                "samples": samples,
                "weights": weights,
            }
        )
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": profiles,
        "name": name,
        "exporter": "ray_tpu_torch.profiling",
        "activeProfileIndex": 0,
    }


def top_frames(records: List[Dict[str, Any]], n: int = 10) -> List[Tuple[str, int, float]]:
    """(leaf_frame, samples, fraction) of the hottest exclusive frames
    across the given records — the "what is it doing" one-liner."""
    counts: Dict[str, int] = {}
    total = 0
    for rec in records:
        for stack, count in rec.get("samples", {}).items():
            leaf = stack.rsplit(";", 1)[-1]
            counts[leaf] = counts.get(leaf, 0) + count
            total += count
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:n]
    return [(fr, c, (c / total if total else 0.0)) for fr, c in ranked]


# ----------------------------------------------------------------------
# Device memory.  The reference's instrument_jit (compile timing, retrace
# counts, cost_analysis of jitted functions) has no counterpart: torch
# runs eagerly, with no jit to instrument.
# ----------------------------------------------------------------------
_dev_report_lock = threading.Lock()
_last_dev_report = 0.0


def report_device_memory(min_interval_s: float = 1.0) -> None:
    """Publish per-card memory gauges from ``torch.cuda.memory_stats``
    (``device_memory_bytes{device, kind}``, kind = in_use, peak, limit).

    A no-op unless this process has already imported torch and torch has
    already made a CUDA context: the runtime never imports torch itself,
    and a report must not make a context of its own.  Rate-limited so
    per-step call sites cost one clock read on the fast path."""
    global _last_dev_report
    from ray_tpu_torch._private import telemetry

    if not telemetry.enabled():
        return
    now = time.monotonic()
    if now - _last_dev_report < min_interval_s:
        return  # lock-free fast path for per-step call sites
    with _dev_report_lock:
        if now - _last_dev_report < min_interval_s:
            return
        _last_dev_report = now
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None) if torch is not None else None
    if cuda is None or not cuda.is_initialized():
        return
    try:
        count = cuda.device_count()
    except RuntimeError:  # driver gone or context lost
        return
    for i in range(count):
        label = f"cuda:{i}"
        try:
            stats = cuda.memory_stats(i)
            limit = cuda.get_device_properties(i).total_memory
        except RuntimeError:
            continue
        in_use = stats.get("allocated_bytes.all.current")
        if in_use is not None:
            telemetry.set_device_memory(label, "in_use", float(in_use))
        peak = stats.get("allocated_bytes.all.peak")
        if peak is not None:
            telemetry.set_device_memory(label, "peak", float(peak))
        telemetry.set_device_memory(label, "limit", float(limit))
