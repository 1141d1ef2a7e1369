"""Dataplane tracing of the port: trace-context propagation over compiled
channels (copies of tests/test_dataplane_trace.py over the port's
clusters; no JAX).

The wire trailer carries (trace id, write-span id, writer timestamp)
across every channel kind, and each consumer re-parents from the
inbound frame — so one serve request over the channel dataplane is a
SINGLE connected trace spanning router, replica, and engine processes,
compiled-DAG executions re-parent per execution (not per actor start),
and a chaos-induced reattach shows up as an annotated span rather than
a broken tree.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import retry
from ray_tpu_torch.util import tracing


@pytest.fixture(scope="module")
def serve_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture
    ``ray_cluster`` starts the JAX package's), with serve torn down."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault per
        # raylet, and no memory monitor (it watches the whole machine).
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        serve.shutdown()
        ray_tpu_torch.shutdown()


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


def _orphans(group):
    ids = {s["span_id"] for s in group}
    return [
        s for s in group
        if s.get("parent_span_id") and s["parent_span_id"] not in ids
    ]


def _trace_group(trace_id, want_names, deadline_s=45.0):
    """Poll the cluster span table until trace ``trace_id`` contains all
    of ``want_names`` AND is fully connected (every parent resolves):
    spans ship on the 1 s flusher cadence from every process, so a hop's
    parent may land a beat after the hop itself."""
    from ray_tpu_torch.util import state

    group, names = [], set()
    for _ in _poll(deadline_s):
        group = [s for s in state.spans() if s.get("trace_id") == trace_id]
        names = {s.get("name") for s in group}
        if want_names <= names and not _orphans(group):
            return group
    raise AssertionError(
        f"trace {trace_id}: wanted {sorted(want_names)}, have {sorted(names)}, "
        f"orphans {[(s['name'], s['parent_span_id']) for s in _orphans(group)]}"
    )


def _assert_no_orphans(group):
    """Every span's parent is either absent (root) or present in the
    same trace — the 'single connected trace' invariant."""
    assert _orphans(group) == [], [
        (s["name"], s["parent_span_id"]) for s in _orphans(group)
    ]


def test_dag_socket_hop_and_per_execution_reparenting(monkeypatch):
    """Cross-raylet compiled-DAG executions: the trace context crosses
    the SOCKET hop, the resident executor re-parents per execution from
    the inbound frame (two traced executions land their dag.op spans in
    two different traces — the stale actor-start-context bug), and an
    untraced execution threads through without minting spans."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.util import state

    # The memory monitor watches the whole machine, which the suite shares.
    monkeypatch.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.add_node(num_cpus=2, resources={"edge": 4})
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)

    @ray_tpu_torch.remote(resources={"edge": 0.1})
    class Far:
        def step(self, x):
            return x * 2 + 1

    try:
        far = Far.bind()
        with InputNode() as inp:
            dag = far.step.bind(inp)
        compiled = dag.experimental_compile(max_inflight=4)
        assert compiled._channels_on
        assert "socket" in {d["kind"] for d in compiled._descs.values()}
        try:
            # untraced execution first: must not break, must not trace
            assert ray_tpu_torch.get(compiled.execute(0), timeout=30) == 1
            roots = []
            for i in (1, 2):
                with tracing.start_span(f"dag.client.{i}") as root:
                    assert ray_tpu_torch.get(compiled.execute(i), timeout=30) == i * 2 + 1
                roots.append(root.trace_id)
            groups = [
                _trace_group(tid, {"channel.write", "channel.read", "dag.op"})
                for tid in roots
            ]
            for group in groups:
                _assert_no_orphans(group)
                assert len({s.get("pid") for s in group}) >= 2
                kinds = {
                    (s.get("attributes") or {}).get("kind")
                    for s in group if s["name"].startswith("channel.")
                }
                assert "socket" in kinds, kinds
            # per-execution re-parent: each execution's dag.op lives in
            # ITS OWN trace (a stale actor-start context would pile both
            # into one)
            dag_ops = [
                {s["span_id"] for s in g if s["name"] == "dag.op"}
                for g in groups
            ]
            assert all(dag_ops) and not (dag_ops[0] & dag_ops[1])
            # the untraced execution minted no dag.op outside those traces
            all_spans = state.spans()
            stray = [
                s for s in all_spans
                if s.get("name") == "dag.op"
                and s.get("trace_id") not in roots
            ]
            assert stray == [], stray
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def test_chaos_reattach_is_annotated_span_not_broken_trace(monkeypatch):
    """A chaos-cut socket edge heals by epoch reattach mid-run; the
    reattach surfaces as a channel.reattach span (result/epoch
    attributes) while the traced executions' trees stay connected."""
    import os as _os

    from ray_tpu_torch._private.chaos import CHAOS
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.util import state

    saved = {
        k: _os.environ.get(k)
        for k in ("RAY_TPU_TORCH_testing_chaos_spec", "RAY_TPU_TORCH_testing_chaos_seed")
    }
    _os.environ["RAY_TPU_TORCH_testing_chaos_spec"] = "chan:socket:*:close:at=3"
    _os.environ["RAY_TPU_TORCH_testing_chaos_seed"] = "7"
    CHAOS.reset()
    # The memory monitor watches the whole machine, which the suite shares.
    monkeypatch.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.add_node(num_cpus=2, resources={"edge": 4})
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)

    @ray_tpu_torch.remote(resources={"edge": 0.1})
    class Far:
        def step(self, x):
            return x + 100

    try:
        far = Far.bind()
        with InputNode() as inp:
            dag = far.step.bind(inp)
        compiled = dag.experimental_compile(max_inflight=4)
        try:
            roots = []
            for i in range(8):
                with tracing.start_span(f"chaos.client.{i}") as root:
                    assert ray_tpu_torch.get(compiled.execute(i), timeout=60) == i + 100
                roots.append(root.trace_id)
            # the cut really fired and healed
            epochs = [compiled._driver_in[0][0].epoch, compiled._driver_out[0].epoch]
            assert max(epochs) >= 2, epochs
            # reattach is an annotated span somewhere in the table...
            reattaches = []
            for _ in _poll(45):
                reattaches = [
                    s for s in state.spans() if s.get("name") == "channel.reattach"
                ]
                if reattaches:
                    break
            assert reattaches, "no channel.reattach span recorded"
            att = reattaches[0].get("attributes") or {}
            assert att.get("result") in ("ok", "failed") and "epoch" in att
            # ...and the traced executions' trees are still whole
            for tid in roots[-2:]:
                _assert_no_orphans(
                    _trace_group(tid, {"channel.write", "channel.read"})
                )
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        for k, old in saved.items():
            if old is None:
                _os.environ.pop(k, None)
            else:
                _os.environ[k] = old
        CHAOS.reset()


def test_serve_stream_single_connected_trace_with_critical_path(serve_cluster):
    """An LLM token stream over the channel dataplane produces ONE
    connected trace — client root → serve.router → channel hops →
    replica dispatch → engine prefill/decode → per-token stream writes —
    spanning at least two processes, and critical_path() decomposes it
    into segments that sum to (at most) the end-to-end latency without
    double counting."""
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve._private.dataplane import ChannelClient, ChannelStream
    from ray_tpu_torch.serve._private.router import _routers
    from ray_tpu_torch.util import state

    app = llm.build_app(
        llm.LLMConfig(
            model="tiny", name="llm_traced", max_batch_size=4,
            num_blocks=64, block_size=8, default_max_tokens=6, device="cpu",
        )
    )
    handle = serve.run(app, name="llm_traced_app")
    # warm the dataplane attach outside the traced request
    handle.remote({"prompt": [1, 2], "max_tokens": 2}).result(timeout=60)
    router = _routers[handle.deployment_name]
    assert any(isinstance(v, ChannelClient) for v in router._dataplanes.values())

    with tracing.start_span("client.request") as root:
        gen = handle.options(stream=True).generate.remote(
            {"prompt": "hi", "max_tokens": 6}
        )
        assert isinstance(gen._gen, ChannelStream)
        events = list(gen)
    assert events[-1]["done"]

    group = _trace_group(
        root.trace_id,
        {
            "client.request", "serve.router", "channel.write", "channel.read",
            "serve.replica.stream", "serve.request", "serve.prefill",
            "serve.decode",
        },
    )
    _assert_no_orphans(group)
    # the trace crosses the process boundary (driver + replica at least)
    assert len({s.get("pid") for s in group}) >= 2, group

    cp = state.critical_path(group)
    assert cp and cp[0]["name"] == "client.request"
    seg_total = sum(e["duration_s"] for e in cp if e["segment"])
    start = min(s["start_time"] for s in group)
    end = max(s["end_time"] for s in group)
    assert 0.0 < seg_total <= (end - start) + 0.05, (seg_total, end - start)
    cp_names = {e["name"] for e in cp}
    # the decomposition reaches through the channel hop into the engine
    assert cp_names & {"channel.read", "channel.write"}, cp_names
    assert cp_names & {"serve.prefill", "serve.decode", "serve.request",
                       "serve.replica.stream"}, cp_names
    # queue-wait attribution rides the read spans
    reads = [s for s in group if s["name"] == "channel.read"]
    assert reads and all(
        "queue_wait_s" in (s.get("attributes") or {}) for s in reads
    )
    serve.delete("llm_traced")


def test_untraced_serve_call_records_no_request_spans(serve_cluster):
    """Untraced requests stay untraced end to end: no ambient context on
    the driver → no trailer on the wire → zero channel/replica spans for
    that call (the overhead contract, observable at the span level)."""

    @serve.deployment(name="UntracedDep")
    class UntracedDep:
        def __call__(self, x):
            return x + 1

    h = serve.run(UntracedDep.bind(), name="untraced_dep")
    h.remote(1).result(timeout=30)  # attach + warm
    before = len(tracing.drain_spans())  # clear the local log
    assert tracing.current_context() is None
    assert h.remote(41).result(timeout=30) == 42
    local = [
        s for s in tracing.drain_spans()
        if s["name"].startswith(("channel.", "serve."))
    ]
    assert local == [], (before, local)
    serve.delete("untraced_dep")
