"""The port's observability and profiling planes inside one process: no
cluster starts in this module.  Copies, with their names, of the tests
of tests/test_observability.py, tests/test_profiling.py, tests/test_util.py
and tests/test_serve_llm.py that need no cluster (the cluster halves are
tests/test_torch_observability.py and tests/test_torch_profiling.py); no
JAX.  Reference: `ray timeline`, python/ray/tests/test_metrics_agent.py,
py-spy attach workflows."""

import json
import sys
import threading
import time

import pytest

from ray_tpu_torch._private import profiling as profiling_mod
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.profiling import ProfilerConflictError


def _parse_exposition(text: str):
    """Minimal Prometheus text-format parser: returns (samples, types)
    where samples is {(name, frozenset(labels)): value}."""
    samples, types = {}, {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            types.setdefault(name, []).append(mtype)
            continue
        if line.startswith("#"):
            continue
        metric, _, value = line.rpartition(" ")
        labels = {}
        if "{" in metric:
            name, _, rest = metric.partition("{")
            body = rest.rstrip("}")
            i, cur_key, cur, in_q, esc = 0, None, "", False, False
            # label values may contain escaped quotes/commas — walk chars
            while i < len(body):
                ch = body[i]
                if in_q:
                    if esc:
                        cur += {"n": "\n", '"': '"', "\\": "\\"}.get(ch, ch)
                        esc = False
                    elif ch == "\\":
                        esc = True
                    elif ch == '"':
                        in_q = False
                        labels[cur_key] = cur
                        cur = ""
                    else:
                        cur += ch
                elif ch == '"':
                    in_q = True
                elif ch == "=":
                    cur_key, cur = cur, ""
                elif ch == ",":
                    cur = ""
                else:
                    cur += ch
                i += 1
        else:
            name = metric
        samples[(name, frozenset(labels.items()))] = float(value)
    return samples, types


def test_prometheus_roundtrip_and_label_escaping():
    records = [
        {
            "name": "odd_counter",
            "type": "counter",
            "description": "labels with\nnewlines and \\slashes",
            "value": 3.0,
            "tags": {"path": 'a"b\\c\nd', "plain": "ok"},
        },
        {
            "name": "lat_hist",
            "type": "histogram",
            "description": "latency",
            "buckets": [0.1, 1.0],
            "counts": [2, 1, 1],
            "sum": 3.3,
            "count": 4,
            "tags": {"m": "x"},
        },
        {
            "name": "lat_hist",
            "type": "histogram",
            "description": "latency",
            "buckets": [0.1, 1.0],
            "counts": [1, 0, 0],
            "sum": 0.05,
            "count": 1,
            "tags": {"m": "y"},
        },
    ]
    text = metrics_mod.prometheus_text(records)
    samples, types = _parse_exposition(text)
    # exactly one # TYPE line per metric name (grouping, not duplication)
    assert all(len(v) == 1 for v in types.values()), types
    assert types["odd_counter"] == ["counter"] and types["lat_hist"] == ["histogram"]
    # the escaped label value round-trips byte-for-byte
    key = ("odd_counter", frozenset({("path", 'a"b\\c\nd'), ("plain", "ok")}.__iter__()))
    assert samples[key] == 3.0
    # histogram exposition: cumulative buckets + _sum/_count per series
    assert samples[("lat_hist_bucket", frozenset({("m", "x"), ("le", "+Inf")}))] == 4
    assert samples[("lat_hist_bucket", frozenset({("m", "x"), ("le", "0.1")}))] == 2
    assert samples[("lat_hist_count", frozenset({("m", "x")}))] == 4
    assert samples[("lat_hist_count", frozenset({("m", "y")}))] == 1
    # a single trailing newline, no blank # HELP spam
    assert text.endswith("\n") and "# HELP odd_counter" in text


def test_chaos_stats_counts_injections():
    from ray_tpu_torch._private.chaos import CHAOS
    from ray_tpu_torch._private.config import CONFIG

    CONFIG._overrides["testing_chaos_spec"] = "obs_fake_*:drop_req:n=2"
    CONFIG._overrides["testing_chaos_seed"] = 7
    CHAOS.reset()
    try:
        assert CHAOS.decide("obs_fake_call", "req").drop
        assert CHAOS.decide("obs_fake_call", "req").drop
        assert not CHAOS.decide("obs_fake_call", "req").drop  # n=2 exhausted
        st = CHAOS.stats()
        assert st["active"] and st["seed"] == 7
        (rule,) = st["rules"]
        assert rule["pattern"] == "obs_fake_*" and rule["action"] == "drop_req"
        assert rule["matches"] == 3 and rule["fired"] == 2
        assert st["schedule_len"] == 3
    finally:
        CONFIG._overrides.pop("testing_chaos_spec", None)
        CONFIG._overrides.pop("testing_chaos_seed", None)
        CHAOS.reset()


def test_call_idempotent_retries_timeouts():
    from ray_tpu_torch._private import rpc

    class FlakyClient:
        def __init__(self, fail_n):
            self.fail_n = fail_n
            self.calls = 0

        def call(self, method, payload=None, timeout=None):
            self.calls += 1
            if self.calls <= self.fail_n:
                raise rpc.CallTimeout(f"{method} timed out")
            return ("ok", method, payload)

    c = FlakyClient(fail_n=2)
    assert rpc.call_idempotent(c, "kv_get", ("ns", b"k"))[0] == "ok"
    assert c.calls == 3

    # budget exhaustion surfaces the original CallTimeout
    c2 = FlakyClient(fail_n=99)
    with pytest.raises(rpc.CallTimeout):
        rpc.call_idempotent(c2, "kv_get", None)
    assert c2.calls >= 3


def test_dataplane_trailer_overhead_budget():
    """Trace propagation must be free when off: an untraced frame is
    byte-identical to a pre-trailer encode (ZERO trailer bytes on the
    wire — the strongest possible zero-serialization-cost proof, and
    deterministic where a timing ratio flakes on a loaded 1-core box),
    a traced frame pays exactly TRACE_LEN extra, and both decode
    transparently.  The TIMING half of the guard is the bench gate:
    bench_micro.py channel_rtt_us_untraced vs the checked-in
    BENCH_micro_head.json capture, compared like-for-like by
    bench_gate.py."""
    from ray_tpu_torch._private import wire
    from ray_tpu_torch.util import tracing

    payload = {"prompt": list(range(16)), "max_tokens": 8}
    plain = wire.encode(payload, tag=3)
    assert plain[0] & wire.TRACE_FLAG == 0
    # no ambient context -> channels pass trace=None -> identical bytes
    assert wire.encode(payload, tag=3, trace=None) == plain

    trace = ("ab" * 16, "cd" * 8, 0, time.time())
    traced = wire.encode(payload, tag=3, trace=trace)
    assert traced[0] & wire.TRACE_FLAG
    assert len(traced) == len(plain) + wire.TRACE_LEN

    # both decode transparently; decode_traced surfaces the context
    assert wire.decode(memoryview(plain))[1] == payload
    assert wire.decode(memoryview(traced))[1] == payload
    tag, val, tctx = wire.decode_traced(memoryview(traced))
    assert (tag, val) == (3, payload) and tctx[0] == "ab" * 16
    tag, val, tctx = wire.decode_traced(memoryview(plain))
    assert (tag, val, tctx) == (3, payload, None)
    assert tracing.current_context() is None


def test_telemetry_kill_switch():
    """telemetry_enabled=False turns every instrumentation site into a
    boolean check and records nothing new."""
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch._private.config import CONFIG

    CONFIG._overrides["telemetry_enabled"] = False
    telemetry.refresh()
    try:
        assert telemetry.enabled() is False
        before = dict(metrics_mod._registry)
        telemetry.observe_rpc("kill_switch_probe", "client", 1.0)
        telemetry.count_retry("kill_switch_probe")
        assert not any(
            k[0] in ("rpc_latency_seconds", "retry_backoff_total")
            and any("kill_switch_probe" in str(t) for t in k[1])
            for k in metrics_mod._registry
            if k not in before
        )
    finally:
        CONFIG._overrides.pop("telemetry_enabled", None)
        telemetry.refresh()
        assert telemetry.enabled() is True


def test_span_flush_batch_cap():
    """Each flush() ships at most span_flush_max_batch spans (ROADMAP
    PR-2 follow-up: bounded report frames under sustained load); the
    remainder goes out on subsequent flushes."""
    from ray_tpu_torch._private.config import CONFIG

    tracing.drain_spans()  # clean slate
    shipped_batches = []

    orig_report = metrics_mod.report

    def capture(method, payload):
        if method == "span_report":
            shipped_batches.append(len(payload["spans"]))
            return True
        return orig_report(method, payload)

    CONFIG._overrides["span_flush_max_batch"] = 10
    metrics_mod.report, orig = capture, metrics_mod.report
    try:
        for i in range(25):
            with tracing.start_span(f"cap-span-{i}"):
                pass
        for _ in range(5):
            tracing.flush()
        assert shipped_batches, "flush never shipped"
        assert max(shipped_batches) <= 10, shipped_batches
        assert sum(shipped_batches) >= 25  # everything eventually ships
    finally:
        metrics_mod.report = orig
        CONFIG._overrides.pop("span_flush_max_batch", None)
        tracing.drain_spans()


def test_span_head_sampling_deterministic():
    """span_sample_rate head-samples whole traces at record time,
    deterministically in the trace id: rate 0 records nothing, rate 1
    records everything, and the keep/drop verdict for one trace id is
    stable (so multi-process trees stay whole)."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.util.tracing import _sampled

    tracing.drain_spans()
    CONFIG._overrides["span_sample_rate"] = 0.0
    try:
        with tracing.start_span("never-kept"):
            pass
        assert tracing.drain_spans() == []
        CONFIG._overrides["span_sample_rate"] = 1.0
        with tracing.start_span("always-kept"):
            pass
        assert [s["name"] for s in tracing.drain_spans()] == ["always-kept"]
        # Determinism of the per-trace verdict at a partial rate.
        CONFIG._overrides["span_sample_rate"] = 0.5
        # Sampling keys off the FIRST 8 hex chars of the trace id.
        ids = [f"{i:08x}" + "0" * 24 for i in range(0, 2**32, 2**28)]
        v1 = [_sampled(t) for t in ids]
        v2 = [_sampled(t) for t in ids]
        assert v1 == v2
        assert any(v1) and not all(v1)  # rate actually partitions
    finally:
        CONFIG._overrides.pop("span_sample_rate", None)
        tracing.drain_spans()


def _busy_thread(seconds: float) -> threading.Thread:
    def busy():
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            sum(i * i for i in range(1000))

    t = threading.Thread(target=busy, daemon=True, name="busy-probe")
    t.start()
    return t


def test_sampler_captures_busy_thread_and_exports():
    _busy_thread(1.2)
    rep = profiling_mod.handle_profile_start(
        {"duration_s": 0.8, "hz": 100, "label": "local"}
    )
    time.sleep(0.9)
    rec = profiling_mod.handle_profile_dump({"session_id": rep["session_id"]})
    assert rec["sample_count"] > 0 and rec["ticks"] > 0
    collapsed = profiling_mod.collapse(rec)
    assert "busy" in collapsed
    # Every line is "stack count" with the label as root frame.
    for line in collapsed.strip().splitlines():
        stack, count = line.rsplit(" ", 1)
        assert stack.startswith("local;") and int(count) > 0
    ss = profiling_mod.speedscope([rec])
    json.dumps(ss)  # serializable
    prof = ss["profiles"][0]
    assert prof["type"] == "sampled" and len(prof["samples"]) == len(prof["weights"])
    assert all(
        i < len(ss["shared"]["frames"]) for s in prof["samples"] for i in s
    )


def test_sampler_cpu_mode_filters_idle_threads():
    """mode=cpu drops parked threads (per-thread CPU clocks): a sleeping
    thread contributes ~nothing, a spinning one dominates."""
    _busy_thread(2.0)
    rep = profiling_mod.handle_profile_start(
        {"duration_s": 1.2, "hz": 80, "mode": "cpu", "label": "cpu"}
    )
    time.sleep(1.3)
    rec = profiling_mod.handle_profile_dump({"session_id": rep["session_id"]})
    assert rec["sample_count"] > 0
    # The pytest main thread is parked in time.sleep during the whole
    # capture; with CPU filtering it must not dominate.
    busy = sum(c for s, c in rec["samples"].items() if "busy" in s)
    assert busy / rec["sample_count"] >= 0.5, rec["samples"]


def test_concurrent_attach_gets_typed_conflict_error():
    rep = profiling_mod.handle_profile_start({"duration_s": 5.0, "label": "first"})
    try:
        with pytest.raises(ProfilerConflictError) as err:
            profiling_mod.handle_profile_start({"duration_s": 1.0, "label": "second"})
        assert err.value.session_id == rep["session_id"]
    finally:
        profiling_mod.handle_profile_stop({"session_id": rep["session_id"]})
    # The stopped session frees the slot: a new attach succeeds (no leak).
    time.sleep(0.1)
    rep2 = profiling_mod.handle_profile_start({"duration_s": 0.2, "label": "third"})
    assert rep2["session_id"] != rep["session_id"]
    time.sleep(0.3)


def test_dump_after_natural_end_returns_cached_record():
    rep = profiling_mod.handle_profile_start({"duration_s": 0.2, "hz": 50, "label": "x"})
    time.sleep(0.5)  # capture ended on its own
    rec = profiling_mod.handle_profile_dump({"session_id": rep["session_id"]})
    assert rec["running"] is False
    assert rec["session_id"] == rep["session_id"]


def test_merge_records_keys_cluster_profile_by_label():
    a = {"label": "actor:tenantA/Foo", "samples": {"f1;f2": 3}, "sample_count": 3}
    b = {"label": "raylet:abcd1234", "samples": {"f1;f2": 2, "g": 1}, "sample_count": 3}
    merged = profiling_mod.merge_records([a, b])
    assert merged["actor:tenantA/Foo;f1;f2"] == 3
    assert merged["raylet:abcd1234;f1;f2"] == 2
    assert merged["raylet:abcd1234;g"] == 1


def test_profiler_detached_zero_cost():
    """Detached = zero cost: no sampler thread survives a capture, no
    interpreter-level profile/trace hook is ever installed, and the
    execution path carries no per-call hooks (attach is a pure RPC
    surface)."""
    rep = profiling_mod.handle_profile_start({"duration_s": 0.2, "hz": 50, "label": "z"})
    time.sleep(0.5)
    rec = profiling_mod.handle_profile_dump({"session_id": rep["session_id"]})
    assert rec["running"] is False
    time.sleep(0.2)
    assert profiling_mod.active_session_id() is None
    assert not any(
        t.name.startswith("profile-sampler") and t.is_alive()
        for t in threading.enumerate()
    )
    assert sys.getprofile() is None and sys.gettrace() is None


def test_report_device_memory_cpu_safe():
    # Must be a no-op (no exception) in a process without a CUDA context
    # (the port's gauges read torch.cuda.memory_stats; the reference's
    # jax importorskip has no counterpart: the report never imports torch).
    profiling_mod.report_device_memory(min_interval_s=0.0)


def test_channel_counters_and_occupancy(tmp_path):
    from ray_tpu_torch.experimental.channel import Channel, ChannelTimeout

    path = str(tmp_path / "chan")
    Channel.create_file(path, 1 << 16)
    w = Channel(path)
    r = Channel(path)
    assert w.pending() is False
    w.write(b"x" * 100)
    assert w.pending() is True  # published, not yet acked
    assert r.read() == b"x" * 100
    assert w.pending() is False
    assert w.stats["writes"] == 1 and w.stats["bytes_written"] == 100
    assert r.stats["reads"] == 1 and r.stats["bytes_read"] == 100
    # A read with nothing published blocks, then times out -> counted.
    with pytest.raises(ChannelTimeout):
        r.read(timeout=0.1)
    assert r.stats["read_timeouts"] == 1
    assert r.stats["read_blocked_s"] > 0
    w.close()
    r.close()


def test_resolve_targets_rejects_unknown_types():
    """A wrong-typed target must raise, not silently widen to a
    cluster-wide capture."""
    from ray_tpu_torch.util import profiling as up

    def must_not_call(method, payload, *a):
        raise AssertionError(f"gcs_call reached for bad target: {method}")

    with pytest.raises(ValueError):
        up.resolve_targets(123, must_not_call)
    with pytest.raises(ValueError):
        up.resolve_targets(b"\x01\x02", must_not_call)


def test_tracing_traceparent_format():
    from ray_tpu_torch.util import tracing

    hdr = tracing.format_traceparent("a" * 32, "b" * 16)
    assert tracing.parse_traceparent(hdr) == ("a" * 32, "b" * 16)
    assert tracing.parse_traceparent("garbage") is None
    assert tracing.parse_traceparent(None) is None


def test_critical_path_sequential_children():
    from ray_tpu_torch.util.state import critical_path, group_traces

    def span(name, sid, parent, t0, t1):
        return {"name": name, "span_id": sid, "parent_span_id": parent,
                "trace_id": "t1", "start_time": t0, "end_time": t1, "pid": 1}

    group = [
        span("serve.request", "root", None, 0.0, 10.0),
        span("serve.queue", "q", "root", 0.0, 2.0),
        span("serve.prefill", "p", "root", 2.0, 3.0),
        span("serve.decode", "d", "root", 3.0, 10.0),
        # a concurrent sibling that overlaps decode: NOT on the path
        span("other", "o", "root", 4.0, 5.0),
    ]
    path = critical_path(group)
    names = [e["name"] for e in path]
    assert names == ["serve.request", "serve.queue", "serve.prefill", "serve.decode"]
    total = sum(e["duration_s"] for e in path if e["segment"])
    assert total == pytest.approx(10.0)
    traces = group_traces(group)
    assert traces[0]["critical_path_s"] == pytest.approx(10.0)
    assert [e["name"] for e in traces[0]["critical_path"]] == names

