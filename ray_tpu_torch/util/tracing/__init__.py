"""Distributed trace-context propagation (reference:
python/ray/util/tracing/tracing_helper.py — W3C traceparent carried in
task metadata so spans nest across task/actor boundaries).

Standalone by design (the image ships no OpenTelemetry SDK): context is
a W3C ``traceparent`` string ("00-<trace_id:32>-<span_id:16>-01")
propagated via TaskSpec.trace_parent.  Submitting a task stamps the
caller's current context onto the spec; the executing worker installs a
child context before running the task body, so ``get_trace_id()`` is
stable across an entire distributed call tree and every task event
row carries (trace_id, span_id, parent_span_id) — the timeline and any
external collector can reassemble the tree.

If an OpenTelemetry SDK IS importable, ``use_opentelemetry()`` bridges
span starts/ends to a real tracer.
"""

from __future__ import annotations

import contextvars
import os
import secrets
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

_ctx: contextvars.ContextVar = contextvars.ContextVar("ray_tpu_trace", default=None)
_otel_tracer = None
# process-local span log (drained by tests/exporters; shipped off-box by
# the background flusher — see flush())
_finished_spans: List[Dict[str, Any]] = []
_MAX_SPANS = 10_000
_span_lock = threading.Lock()
# Index into _finished_spans up to which the flusher already shipped
# spans to the GCS span table.  The flusher never REMOVES spans, so
# drain_spans() keeps its pop-everything semantics for local consumers.
_flushed_upto = 0
_flusher_started = False
# Concurrency bookkeeping for flush(): ring-buffer trims and drains
# shift/clear indices while a report RPC is in flight; these counters
# let the post-report cursor advance account for that instead of
# skipping (and silently dropping) spans recorded mid-flight.
_trim_total = 0
_drain_epoch = 0


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


def new_span_id() -> str:
    """Mint a span id (public: channel hops mint per-frame write spans)."""
    return _new_span_id()


def set_frame_context(frame_ctx: Optional[Tuple[str, str]]) -> Any:
    """Adopt an inbound dataplane frame's trace context: enter a child
    of ``(trace_id, parent_span_id)`` — or CLEAR the context when the
    frame is untraced (``None``), so an executor that serves many
    requests never parents one request's spans under a stale context
    captured at actor start.  Returns a token for :func:`reset_context`."""
    if frame_ctx is None:
        return _ctx.set(None)
    return _ctx.set((frame_ctx[0], _new_span_id(), frame_ctx[1]))


def reset_context(token: Any) -> None:
    """Undo a :func:`set_frame_context` (restores the previous context)."""
    _ctx.reset(token)


def adopt_context(
    ctx: Optional[Tuple[str, str, Optional[str]]]
) -> Any:
    """Set this thread's context to an EXACT ``(trace_id, span_id,
    parent_span_id)`` tuple (or ``None``) without minting — for worker
    threads (e.g. a channel tx thread) acting on behalf of a task whose
    span the tuple names.  Returns a token for :func:`reset_context`."""
    return _ctx.set(ctx)


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    if not header:
        return None
    parts = header.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


def get_trace_id() -> Optional[str]:
    cur = _ctx.get()
    return cur[0] if cur else None


def current_context() -> Optional[Tuple[str, str, Optional[str]]]:
    """(trace_id, span_id, parent_span_id) of the active context, or None.
    The executor side uses this to record the task's own span — the span
    id minted by install_context IS the task span, so recording it (rather
    than opening a fresh child) keeps parent links intact across the
    process hop."""
    return _ctx.get()


def get_span_id() -> Optional[str]:
    cur = _ctx.get()
    return cur[1] if cur else None


def current_traceparent() -> Optional[str]:
    """The header to stamp on outgoing work (None when not tracing)."""
    cur = _ctx.get()
    if cur is None:
        return None
    return format_traceparent(cur[0], cur[1])


def install_context(traceparent: Optional[str]) -> None:
    """Executor side: enter a CHILD context of the received header (a
    fresh span id whose parent is the caller's span)."""
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        _ctx.set(None)
        return
    trace_id, parent_span = parsed
    _ctx.set((trace_id, _new_span_id(), parent_span))


@contextmanager
def start_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """Open a span under the current context (starting a new trace if
    none is active); spans land in the process span log and, when
    bridged, the OpenTelemetry tracer."""
    prev = _ctx.get()
    if prev is None:
        trace_id, parent = _new_trace_id(), None
    else:
        trace_id, parent = prev[0], prev[1]
    span_id = _new_span_id()
    token = _ctx.set((trace_id, span_id, parent))
    start = time.time()
    otel_cm = None
    if _otel_tracer is not None:
        otel_cm = _otel_tracer.start_as_current_span(name)
        otel_cm.__enter__()
    try:
        yield SpanHandle(trace_id, span_id)
    finally:
        if otel_cm is not None:
            otel_cm.__exit__(None, None, None)
        _record_span(
            {
                "name": name,
                "trace_id": trace_id,
                "span_id": span_id,
                "parent_span_id": parent,
                "start_time": start,
                "end_time": time.time(),
                "pid": os.getpid(),
                "attributes": attributes or {},
            }
        )
        _ctx.reset(token)


class SpanHandle:
    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def _sampled(trace_id: Optional[str]) -> bool:
    """Head sampling, deterministic in the trace id: every process keeps
    or drops the SAME traces, so sampled trees stay whole across hops.
    Spans with no trace id (shouldn't happen) are kept."""
    from ray_tpu_torch._private.config import CONFIG

    try:
        rate = float(CONFIG.span_sample_rate)
    except Exception:
        return True
    if rate >= 1.0:
        return True
    if rate <= 0.0 or not trace_id:
        return rate > 0.0
    try:
        bucket = int(trace_id[:8], 16) / float(0xFFFFFFFF)
    except ValueError:
        return True
    return bucket < rate


def _record_span(span: Dict[str, Any]) -> None:
    global _flushed_upto, _trim_total
    if not _sampled(span.get("trace_id")):
        return
    span.setdefault("tid", threading.get_ident())
    with _span_lock:
        _finished_spans.append(span)
        if len(_finished_spans) > _MAX_SPANS:
            trim = len(_finished_spans) - _MAX_SPANS
            del _finished_spans[:trim]
            _trim_total += trim
            _flushed_upto = max(0, _flushed_upto - trim)
    _ensure_flusher()


def record_span(
    name: str,
    start_time: float,
    end_time: float,
    attributes: Optional[Dict[str, Any]] = None,
    context: Optional[Tuple[str, str, Optional[str]]] = None,
) -> None:
    """Record an already-timed span at the given (or current) context
    WITHOUT minting a new span id.  Used by the task executor: the
    context installed from TaskSpec.trace_parent is the task's span, and
    its id is what child tasks were told their parent is."""
    ctx = context if context is not None else _ctx.get()
    if ctx is None:
        return
    trace_id, span_id, parent = ctx
    _record_span(
        {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_span_id": parent,
            "start_time": start_time,
            "end_time": end_time,
            "pid": os.getpid(),
            "attributes": attributes or {},
        }
    )


def record_event_span(
    name: str,
    start_time: float,
    end_time: float,
    attributes: Optional[Dict[str, Any]] = None,
) -> None:
    """Record an already-timed standalone event as its own root span
    (fresh trace id), regardless of any active context.  For events
    that happen on background threads with no caller to parent them —
    profile captures — so they still land in
    ``state.timeline()``."""
    _record_span(
        {
            "name": name,
            "trace_id": _new_trace_id(),
            "span_id": _new_span_id(),
            "parent_span_id": None,
            "start_time": start_time,
            "end_time": end_time,
            "pid": os.getpid(),
            "attributes": attributes or {},
        }
    )


def drain_spans() -> List[Dict[str, Any]]:
    """Pop and return this process's finished spans."""
    global _flushed_upto, _drain_epoch
    with _span_lock:
        out, _finished_spans[:] = list(_finished_spans), []
        _flushed_upto = 0
        _drain_epoch += 1
    return out


def flush() -> bool:
    """Ship spans recorded since the last flush to the GCS span table
    (mirrors util.metrics.flush; delivery goes through the same report
    channel so raylet/GCS processes export too).  Local consumers are
    unaffected: spans stay drainable until drain_spans() pops them.

    Each call ships at most CONFIG.span_flush_max_batch spans (ROADMAP
    PR-2 follow-up): sustained load produces a bounded report frame per
    interval instead of one unbounded ship-everything RPC; the remainder
    goes on the next interval (or the next explicit flush call).

    Delivery is at-least-once: a reply lost after the GCS applied the
    batch leaves the cursor behind and the batch is re-sent — readers
    dedupe by span_id (state._dedupe_spans)."""
    global _flushed_upto
    from ray_tpu_torch._private.config import CONFIG

    try:
        max_batch = max(1, int(CONFIG.span_flush_max_batch))
    except Exception:
        max_batch = 2048
    with _span_lock:
        pending = _finished_spans[_flushed_upto : _flushed_upto + max_batch]
        mark = _flushed_upto + len(pending)
        base_trim = _trim_total
        base_epoch = _drain_epoch
    if not pending:
        return True
    from ray_tpu_torch.util import metrics as _metrics

    payload = {
        "reporter": _metrics.reporter_id(),
        # Per-tenant accounting in the GCS span table (the raylet stamps
        # RAY_TPU_TORCH_TENANT into worker environments).
        "tenant": os.environ.get("RAY_TPU_TORCH_TENANT") or "default",
        "spans": pending,
    }
    if _metrics.report("span_report", payload):
        with _span_lock:
            if _drain_epoch == base_epoch:
                # Shift the snapshot index by whatever the ring trimmed
                # during the RPC so spans recorded mid-flight are not
                # marked as shipped.
                mark -= _trim_total - base_trim
                _flushed_upto = max(_flushed_upto, min(max(0, mark), len(_finished_spans)))
            # else: a drain cleared the log mid-flight; cursor already 0
        return True
    return False


def _ensure_flusher() -> None:
    global _flusher_started
    if _flusher_started:
        return
    with _span_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def flush_loop():
        from ray_tpu_torch._private.config import CONFIG

        while True:
            try:
                time.sleep(max(0.05, CONFIG.span_flush_interval_ms / 1000))
                flush()
            except Exception:
                pass

    threading.Thread(target=flush_loop, daemon=True, name="span-flush").start()
    import atexit

    atexit.register(lambda: _safe_flush())


def _safe_flush():
    try:
        # flush() ships one bounded batch per call; at exit, drain what
        # remains (bounded — the ring holds at most _MAX_SPANS).
        for _ in range(16):
            flush()
            with _span_lock:
                done = _flushed_upto >= len(_finished_spans)
            if done:
                break
    except Exception:
        pass


def use_opentelemetry(tracer=None) -> bool:
    """Bridge spans to an OpenTelemetry tracer if the SDK is available
    (reference: tracing_helper's use of opentelemetry.trace)."""
    global _otel_tracer
    if tracer is not None:
        _otel_tracer = tracer
        return True
    try:
        from opentelemetry import trace as otel_trace

        _otel_tracer = otel_trace.get_tracer("ray_tpu_torch")
        return True
    except Exception:
        return False
