"""The port's state API and profiling exports against the JAX package's:
the same seeded span, task-event, metric and capture records go through
the pure functions of both packages, and the outputs must be equal
(exactly: the functions are host code over plain dicts).

- util.state: ``critical_path``, ``group_traces``, ``build_dataplane``,
  ``build_chrome_trace``, ``_quantile``;
- util.profiling: ``ProfileResult``'s ``collapsed``, ``speedscope``,
  ``top_frames``, ``attribution``, ``summary`` and ``save``;
  ``resolve_targets`` over the same fake ``gcs_call``.

This is the only module that imports both packages."""

import copy
import json
import time

import numpy as np
import pytest

from ray_tpu.util import profiling as ref_profiling
from ray_tpu.util import state as ref_state
from ray_tpu_torch.util import profiling as port_profiling
from ray_tpu_torch.util import state as port_state

_SPAN_NAMES = ("serve.request", "serve.queue", "serve.prefill", "serve.decode",
               "task::mid", "task::leaf", "dag.op", "serve.router")
_HOP_NAMES = ("channel.write", "channel.read", "channel.reattach")


def _hex(rng, n):
    return "".join(f"{int(b):02x}" for b in rng.integers(0, 256, n))


def _span_records(seed, n_traces=6, spans_per_trace=14):
    """Span trees with sequential and overlapping siblings, channel hops
    with queue waits, a reattach, a span whose parent is missing, and a
    few without a trace id or a start."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_traces):
        tid = _hex(rng, 16)
        t0 = float(rng.uniform(1e9, 1e9 + 100))
        root = {"name": "client.request", "span_id": _hex(rng, 8), "parent_span_id": None,
                "trace_id": tid, "start_time": t0, "end_time": t0 + float(rng.uniform(0.5, 2)),
                "pid": int(rng.integers(100, 104)), "tid": int(rng.integers(1, 4)),
                "attributes": {"route": "/llm"}}
        group = [root]
        for i in range(spans_per_trace):
            parent = group[int(rng.integers(0, len(group)))]
            start = parent["start_time"] + float(rng.uniform(0, 0.3))
            end = start + float(rng.uniform(0, 0.4))
            if rng.random() < 0.4:
                name = _HOP_NAMES[int(rng.integers(0, 3))]
                attrs = {"path": f"/dev/shm/chan-{int(rng.integers(0, 3))}",
                         "kind": ("shm", "socket")[int(rng.integers(0, 2))]}
                if name == "channel.read":
                    attrs["queue_wait_s"] = float(10.0 ** rng.uniform(-6, 1.5))
                if name == "channel.reattach":
                    attrs["result"] = ("ok", "failed")[int(rng.integers(0, 2))]
                    attrs["epoch"] = int(rng.integers(1, 5))
            else:
                name = _SPAN_NAMES[int(rng.integers(0, len(_SPAN_NAMES)))]
                attrs = {"tokens": int(rng.integers(0, 64)), "obj": [1, 2]}
            span = {"name": name, "span_id": _hex(rng, 8), "parent_span_id": parent["span_id"],
                    "trace_id": tid, "start_time": start, "end_time": end,
                    "pid": int(rng.integers(100, 104)), "tid": int(rng.integers(1, 4)),
                    "attributes": attrs}
            if i == 3:
                span["parent_span_id"] = _hex(rng, 8)  # parent never shipped
            group.append(span)
        out.extend(group)
    out.append({"name": "orphan", "span_id": _hex(rng, 8), "start_time": 5.0, "end_time": 6.0})
    out.append({"name": "no-start", "span_id": _hex(rng, 8), "trace_id": "x" * 32})
    order = rng.permutation(len(out))
    return [out[int(i)] for i in order]


def _task_events(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        start = None if i % 11 == 5 else float(rng.uniform(1e9, 1e9 + 10))
        ev = {"task_id": _hex(rng, 12), "name": f"traced_task_{int(rng.integers(0, 4))}",
              "state": ("FINISHED", "RUNNING", "FAILED")[int(rng.integers(0, 3))],
              "start_time": start, "attempt": int(rng.integers(0, 3)),
              "nested": {"not": "scalar"}}
        if start is not None and rng.random() < 0.8:
            ev["end_time"] = start + float(rng.uniform(0, 1))
        if rng.random() < 0.7:
            ev["node_id"] = _hex(rng, 16)
        if rng.random() < 0.7:
            ev["worker_id"] = _hex(rng, 16)
        out.append(ev)
    return out


def _metric_records(seed):
    rng = np.random.default_rng(seed)
    out = []
    for name in ("channel_writes_total", "channel_reads_total", "socket_channel_reconnects_total",
                 "channel_bytes", "rpc_latency_seconds", "channel_read_blocked_total"):
        tagged = bool(rng.integers(0, 2))  # a metric's series all carry tags, or none does
        for k in range(3 if tagged else 1):
            tags = {"kind": ("shm", "socket", "shm")[k], "edge": str(k)} if tagged else {}
            out.append({"name": name,
                        "type": "gauge" if name == "channel_bytes" else "counter",
                        "value": float(rng.integers(0, 1000)), "tags": tags})
    return out


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    """build_chrome_trace stamps a running task's end with time.time():
    hold the clock so both packages read the same instant."""
    monkeypatch.setattr(time, "time", lambda: 1e9 + 20.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critical_path_and_group_traces_match(seed):
    spans = _span_records(seed)
    by_trace = {}
    for s in spans:
        if s.get("trace_id") and s.get("start_time") is not None:
            by_trace.setdefault(s["trace_id"], []).append(s)
    for group in by_trace.values():
        ref = ref_state.critical_path(copy.deepcopy(group))
        assert ref
        assert port_state.critical_path(copy.deepcopy(group)) == ref
    ref = ref_state.group_traces(copy.deepcopy([s for s in spans if "start_time" in s]))
    assert len(ref) >= 6
    assert port_state.group_traces(copy.deepcopy([s for s in spans if "start_time" in s])) == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_dataplane_matches(seed):
    spans, metrics = _span_records(seed), _metric_records(seed)
    ref = ref_state.build_dataplane(copy.deepcopy(spans), copy.deepcopy(metrics))
    assert ref["edges"] and any(e["queue_wait"]["count"] for e in ref["edges"])
    assert port_state.build_dataplane(copy.deepcopy(spans), copy.deepcopy(metrics)) == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_chrome_trace_matches(seed):
    spans, events = _span_records(seed), _task_events(seed)
    for s in spans[::7]:
        s["end_time"] = None  # drawn as a zero-length span
    ref = ref_state.build_chrome_trace(copy.deepcopy(events), copy.deepcopy(spans))
    port = port_state.build_chrome_trace(copy.deepcopy(events), copy.deepcopy(spans))
    assert port == ref
    assert json.dumps(port) == json.dumps(ref)


def test_quantile_matches():
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 5, 64, 1001):
        vals = sorted(float(v) for v in rng.exponential(1e-3, n))
        for q in (0.0, 0.05, 0.5, 0.95, 0.99, 1.0):
            assert port_state._quantile(vals, q) == ref_state._quantile(vals, q)


def _capture_records(seed, n=4):
    rng = np.random.default_rng(seed)
    frames = ["threading.py:_bootstrap", "worker.py:main_loop", "gpt2_loop.py:train_step",
              "engine.py:_step_loop", "flash_attention.py:forward", "selectors.py:select",
              "metrics.py:flush_loop", "rpc.py:call"]
    out = []
    for i in range(n):
        samples = {}
        for _ in range(int(rng.integers(5, 30))):
            depth = int(rng.integers(1, 6))
            stack = ";".join(frames[int(j)] for j in rng.integers(0, len(frames), depth))
            samples[stack] = samples.get(stack, 0) + int(rng.integers(1, 50))
        out.append({"label": f"actor:default/Trainer{i}/pid{100 + i}", "session_id": _hex(rng, 8),
                    "samples": samples, "sample_count": sum(samples.values()), "ticks": 500,
                    "running": False, "pid": 100 + i})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profile_result_exports_match(seed, tmp_path):
    recs = _capture_records(seed)
    errors = [{"target": "raylet:abcd1234", "error": "ConnectionLost: gone"}]
    shared = [{"target": "gcs", "session_id": "s1"}]
    ref = ref_profiling.ProfileResult(copy.deepcopy(recs), list(errors), list(shared))
    port = port_profiling.ProfileResult(copy.deepcopy(recs), list(errors), list(shared))
    assert port.total_samples == ref.total_samples > 0
    assert port.complete == ref.complete is False
    assert port.merged_samples() == ref.merged_samples()
    assert port.collapsed() == ref.collapsed()
    for n in (1, 3, 10, 50):
        assert port.top_frames(n) == ref.top_frames(n)
    for needle in ("train_step", "_step_loop", "select", "absent", "Trainer1"):
        assert port.attribution(needle) == ref.attribution(needle)
    assert port.summary() == ref.summary()
    # speedscope differs only in the two fields that name the exporter.
    ref_ss, port_ss = ref.speedscope(), port.speedscope()
    assert (ref_ss.pop("name"), ref_ss.pop("exporter")) == ("ray_tpu profile", "ray_tpu.profiling")
    assert (port_ss.pop("name"), port_ss.pop("exporter")) == (
        "ray_tpu_torch profile", "ray_tpu_torch.profiling")
    assert port_ss == ref_ss
    a = port.save(str(tmp_path / "port.txt"))
    b = ref.save(str(tmp_path / "ref.txt"))
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def _fake_gcs(seed, ids_mod):
    """A gcs_call over a fixed cluster table: three nodes (one DEAD, one
    DRAINING) and two actors, one ALIVE and one DEAD."""
    rng = np.random.default_rng(seed)
    node_ids = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(3)]
    actor_ids = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(2)]
    nodes = {f"k{i}": {"node_id": nid, "state": st, "raylet_address": f"unix:/tmp/raylet{i}.sock"}
             for i, (nid, st) in enumerate(zip(node_ids, ("ALIVE", "DEAD", "DRAINING")))}
    actors = {
        actor_ids[0]: {"state": "ALIVE", "worker_address": "tcp:127.0.0.1:4001",
                       "tenant": "teamA", "name": None, "class_name": "Trainer"},
        actor_ids[1]: {"state": "DEAD", "worker_address": None, "class_name": "Gone"},
    }
    calls = []

    def gcs_call(method, payload, *rest):
        calls.append((method, payload))
        if method == "get_cluster_info":
            return {"nodes": copy.deepcopy(nodes)}
        if method == "get_actor_info":
            return copy.deepcopy(actors.get(payload))
        raise AssertionError(method)

    return gcs_call, calls, node_ids, actor_ids


class _Handle:
    def __init__(self, actor_id):
        self._actor_id = actor_id


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_targets_matches(seed):
    from ray_tpu._private import ids as ref_ids
    from ray_tpu_torch._private import ids as port_ids

    def resolve(mod, ids_mod, target_of):
        gcs_call, calls, node_ids, actor_ids = _fake_gcs(seed, ids_mod)
        out = []
        for make in target_of(node_ids, actor_ids, ids_mod):
            for include_workers in (True, False):
                try:
                    res = mod.resolve_targets(make, gcs_call, include_workers=include_workers)
                    out.append(("ok", res))
                except ValueError as e:
                    out.append(("ValueError", str(e)))
        return out, calls

    def targets(node_ids, actor_ids, ids_mod):
        return [
            None, "cluster", "", "gcs",
            node_ids[0].hex(), node_ids[2].hex(), ids_mod.NodeID(node_ids[0]),
            actor_ids[0].hex(), actor_ids[1].hex(), "zz-not-hex",
            ids_mod.ActorID(actor_ids[0]), _Handle(ids_mod.ActorID(actor_ids[0])),
            _Handle(ids_mod.ActorID(actor_ids[1])), 123, b"\x01\x02",
        ]

    ref, ref_calls = resolve(ref_profiling, ref_ids, targets)
    port, port_calls = resolve(port_profiling, port_ids, targets)
    assert port == ref
    assert port_calls == ref_calls
    kinds = [k for k, _ in ref]
    assert "ok" in kinds and "ValueError" in kinds
