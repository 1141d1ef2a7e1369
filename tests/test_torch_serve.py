"""Serve of the port: deployments, handles, routing, batching, HTTP and
gRPC proxies, scaling, the channel dataplane — copies of
``tests/test_serve.py`` over the port's runtime.  The last test holds
the RPC path (``serve_channel_dataplane`` off) to the dataplane test's
exactness checks.

Reference test model: python/ray/serve/tests/ (test_deploy.py,
test_handle.py, test_batching.py, test_proxy.py) scaled to CI size.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import retry


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed: ``for _ in _poll(30): ...``."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def serve_cluster(ray_cluster):
    yield ray_cluster
    serve.shutdown()


@pytest.fixture(scope="module")
def http_port(serve_cluster):
    # the JAX package's serve tests bind 18123 on the same host: the
    # port's proxy takes a free port of its own
    return _free_port()


def test_function_deployment(serve_cluster):
    @serve.deployment
    def echo(payload):
        return {"got": payload}

    handle = serve.run(echo.bind())
    out = handle.remote({"x": 1}).result(timeout=30)
    assert out == {"got": {"x": 1}}


def test_class_deployment_with_methods(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.value = start

        def incr(self, by=1):
            self.value += by
            return self.value

        def __call__(self, payload):
            return {"value": self.value}

    handle = serve.run(Counter.bind(10), name="counter")
    v = handle.incr.remote(5).result(timeout=30)
    assert v == 15
    out = handle.remote({}).result(timeout=30)
    assert "value" in out
    # serve.run returns once ONE replica runs; the second may need one
    # more reconcile tick (0.5 s) to pass its health check
    for _ in _poll(30):
        st = serve.status()
        if st["Counter"]["num_running"] >= 2:
            break
    assert st["Counter"]["num_running"] == 2


def test_handle_composition(serve_cluster):
    @serve.deployment(name="inner")
    def inner(x):
        return x * 2

    @serve.deployment(name="outer")
    class Outer:
        def __init__(self, inner_handle):
            self.inner = inner_handle

        def __call__(self, x):
            return self.inner.remote(x).result(timeout=30) + 1

    inner_handle = serve.run(inner.bind())
    handle = serve.run(Outer.bind(inner_handle))
    assert handle.remote(21).result(timeout=30) == 43


def test_load_balancing_across_replicas(serve_cluster):
    import os

    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __call__(self, payload):
            return os.getpid()

    handle = serve.run(WhoAmI.bind(), name="whoami")
    # Both replicas must serve traffic.  The router's replica cache may
    # briefly know only one replica right after deploy (refresh is
    # rate-limited), so keep sending until the second shows up.
    import time

    pids = set()
    deadline = time.time() + 30
    while len(pids) < 2 and time.time() < deadline:
        pids.add(handle.remote({}).result(timeout=30))
    assert len(pids) == 2  # both replicas served traffic


def test_batching(serve_cluster):
    @serve.deployment
    class BatchedModel:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        async def handle_batch(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        async def __call__(self, x):
            return await self.handle_batch(x)

        def get_batch_sizes(self):
            return self.batch_sizes

    handle = serve.run(BatchedModel.bind(), name="batched")
    responses = [handle.remote(i) for i in range(16)]
    results = [r.result(timeout=30) for r in responses]
    assert sorted(results) == [i * 10 for i in range(16)]
    sizes = handle.get_batch_sizes.remote().result(timeout=30)
    assert max(sizes) > 1  # at least one real batch formed


def test_http_proxy(serve_cluster, http_port):
    @serve.deployment(route_prefix="/api")
    def api(payload):
        return {"echo": payload, "ok": True}

    serve.run(api.bind(), http_port=http_port)
    # route table may lag one refresh; retry briefly
    last = None
    for _ in _poll(15):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{http_port}/api",
                data=json.dumps({"q": 1}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=5) as resp:
                out = json.loads(resp.read())
            assert out == {"echo": {"q": 1}, "ok": True}
            return
        except AssertionError:
            raise
        except Exception as e:  # noqa: BLE001
            last = e
    raise AssertionError(f"proxy never became reachable: {last}")


def test_rolling_update(serve_cluster):
    @serve.deployment(name="versioned", version="1")
    def v1(payload):
        return "v1"

    handle = serve.run(v1.bind())
    assert handle.remote({}).result(timeout=30) == "v1"

    @serve.deployment(name="versioned", version="2")
    def v2(payload):
        return "v2"

    handle = serve.run(v2.bind())
    for _ in _poll(30):
        if handle.remote({}).result(timeout=30) == "v2":
            return
    raise AssertionError("rolling update never converged to v2")


def test_multiplexed_model_swap(serve_cluster):
    """LRU model multiplexing on one replica + handle model routing
    (reference: serve/multiplex.py + handle multiplexed_model_id)."""

    @serve.deployment(num_replicas=2)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"weights": f"model-{model_id}"}

        async def __call__(self, payload):
            mid = serve.get_multiplexed_model_id()
            model = await self.get_model(mid)
            return {"model": model["weights"], "loads": list(self.loads)}

    handle = serve.run(MultiModel.bind())
    # same model id repeatedly: ONE load (cache hit + replica affinity)
    outs = [
        handle.options(multiplexed_model_id="a").remote(None).result(timeout=30)
        for _ in range(4)
    ]
    assert all(o["model"] == "model-a" for o in outs)
    assert outs[-1]["loads"].count("a") == 1, outs[-1]["loads"]
    # third model on the same replica evicts the LRU (max 2)
    for mid in ("b", "c", "a"):
        out = handle.options(multiplexed_model_id=mid).remote(None).result(timeout=30)
        assert out["model"] == f"model-{mid}"
    loads = out["loads"]
    # "a" was evicted by b/c (capacity 2) and re-loaded on this replica
    # if all routed to one replica; across 2 replicas affinity may have
    # spread them — either way every answer was correct and total loads
    # stayed bounded
    assert 1 <= loads.count("a") <= 2


def test_long_poll_pushes_replica_set(serve_cluster):
    """Routers learn replica-set changes via long-poll push, not just
    the 1s polling fallback (reference: long_poll.py)."""
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME, lp_replicas_key
    from ray_tpu_torch.serve._private.long_poll import LongPollClient

    @serve.deployment(num_replicas=1, version="v1")
    def pushed(payload):
        return "v1"

    serve.run(pushed.bind())
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")

    seen = []
    client = LongPollClient(
        controller, {lp_replicas_key("pushed"): lambda snap: seen.append(snap)}
    )
    # scale up: the push must arrive without any poll from us
    serve.run(pushed.options(num_replicas=2, version="v1").bind())
    for _ in _poll(20):
        if any(len(s) == 2 for s in seen):
            break
    client.stop()
    assert any(len(s) == 2 for s in seen), f"no 2-replica snapshot pushed: {seen}"


def test_local_testing_mode():
    """serve.run(_local_testing_mode=True) needs NO cluster: the
    deployment runs in-process with the normal handle convention,
    including async methods and multiplexed model routing (reference:
    serve/_private/local_testing_mode.py)."""

    @serve.deployment
    class Local:
        def __init__(self, base):
            self.base = base

        async def __call__(self, x):
            return self.base + x

        def describe(self):
            return "local"

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, mid):
            return f"m-{mid}"

        async def which_model(self, _):
            return await self.get_model(serve.get_multiplexed_model_id())

    h = serve.run(Local.bind(10), _local_testing_mode=True)
    assert h.remote(5).result() == 15
    assert h.describe.remote().result() == "local"
    out = h.options(multiplexed_model_id="z").which_model.remote(None).result()
    assert out == "m-z"

    # errors propagate like DeploymentResponse.result does
    @serve.deployment
    def boom(payload):
        raise ValueError("kapow")

    hb = serve.run(boom.bind(), _local_testing_mode=True)
    with pytest.raises(ValueError):
        hb.remote(1).result()


def test_streaming_deployment_handle(serve_cluster):
    """Generator deployments stream items through the handle
    (reference: serve/handle.py DeploymentResponseGenerator over a
    streaming replica call)."""
    @serve.deployment(name="TokenStream")
    class TokenStream:
        def __call__(self, n):
            for i in range(int(n)):
                yield {"token": i}

        async def agen(self, n):
            for i in range(int(n)):
                yield i * 10

    handle = serve.run(TokenStream.bind(), name="stream_app")
    items = list(handle.options(stream=True).remote(4))
    assert items == [{"token": i} for i in range(4)]
    # async generator method, method dispatch through the same option
    vals = list(handle.options(stream=True).agen.remote(3))
    assert vals == [0, 10, 20]
    # non-stream calls on the same deployment still work (one-shot path)
    sync_handle = handle.options(stream=False)
    assert hasattr(sync_handle.remote(1), "result")


def test_streaming_http_chunked(serve_cluster, http_port):
    """x-serve-stream: 1 streams each yield as a chunk (reference:
    StreamingResponse over the HTTP proxy)."""
    @serve.deployment(name="HttpStream")
    class HttpStream:
        def __call__(self, payload):
            for i in range(3):
                yield f"chunk-{i};"

    # the proxy is a singleton: reuse the module's proxy port (first
    # http_port wins; later ports are ignored by _ensure_proxy)
    serve.run(HttpStream.bind(), name="http_stream", route_prefix="/hs",
              http_port=http_port)
    req = urllib.request.Request(
        f"http://127.0.0.1:{http_port}/hs", headers={"x-serve-stream": "1"}
    )
    with urllib.request.urlopen(req, timeout=20) as r:
        body = r.read().decode()
    assert body == "chunk-0;chunk-1;chunk-2;"


def test_streaming_local_testing_mode(serve_cluster):
    """Local mode streams generator yields like the cluster path."""
    @serve.deployment
    class LocalGen:
        def __call__(self, n):
            yield from range(n)

    h = serve.run(LocalGen.bind(), _local_testing_mode=True)
    assert list(h.options(stream=True).remote(3)) == [0, 1, 2]


def test_grpc_proxy(serve_cluster):
    """Generic-bytes gRPC route through the full serve stack (reference:
    proxy.py:538 gRPCProxy)."""
    import grpc

    @serve.deployment
    class GrpcModel:
        def __call__(self, x):
            return {"doubled": x * 2}

        def describe(self):
            return "grpc-model"

    port = _free_port()  # the JAX package's test binds 19456 on the same host
    serve.run(GrpcModel.bind(), grpc_port=port)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = channel.unary_unary("/ray_tpu.serve.UserDefinedService/GrpcModel")
    last = None
    for _ in _poll(15):
        try:
            out = json.loads(call(json.dumps({"args": [21]}).encode(), timeout=10))
            assert out == {"doubled": 42}
            break
        except AssertionError:
            raise
        except Exception as e:  # noqa: BLE001
            last = e
    else:
        raise AssertionError(f"grpc proxy never became reachable: {last}")
    # non-__call__ dispatch via metadata
    out = json.loads(
        call(json.dumps({"args": []}).encode(), timeout=10,
             metadata=(("method", "describe"),))
    )
    assert out == "grpc-model"
    channel.close()


def test_channel_dataplane_engaged_and_exact(serve_cluster):
    """The router→replica hot path rides compiled channels: calls and
    token streams go through the per-replica ChannelClient (no per-call
    RPC, no per-token object-store items) with exact results, errors
    surfacing as their original type, and the disconnect-cancel contract
    intact."""
    from ray_tpu_torch.serve._private.dataplane import ChannelClient, ChannelStream
    from ray_tpu_torch.serve._private.router import _routers

    @serve.deployment(name="DataplaneDep")
    class DataplaneDep:
        def __call__(self, payload):
            if payload == "boom":
                raise ValueError("boom")
            return {"echo": payload}

        def tokens(self, n):
            for i in range(n):
                yield {"tok": i}

    h = serve.run(DataplaneDep.bind(), name="dataplane_dep")
    assert h.remote({"a": 1}).result(timeout=30) == {"echo": {"a": 1}}
    router = _routers[h.deployment_name]
    dps = [v for v in router._dataplanes.values() if isinstance(v, ChannelClient)]
    assert dps, "dataplane did not attach"
    # streams multiplex over the same channel pair
    gen = h.options(stream=True).tokens.remote(6)
    assert isinstance(gen._gen, ChannelStream)
    assert list(gen) == [{"tok": i} for i in range(6)]
    # errors keep their original type across the channel boundary
    with pytest.raises(ValueError):
        h.remote("boom").result(timeout=30)
    # concurrent streams interleave on one channel without crosstalk
    gens = [h.options(stream=True).tokens.remote(4) for _ in range(8)]
    outs = [list(g) for g in gens]
    assert all(o == [{"tok": i} for i in range(4)] for o in outs)
    # early close sends the cancel frame and releases the waiter slot
    g = h.options(stream=True).tokens.remote(1000)
    g.close()
    dp = dps[0]
    assert not dp.dead


def test_try_next_then_oneshot_result_on_one_handle_keeps_dataplane(serve_cluster, monkeypatch):
    """One handle, one sync thread: a dataplane stream drained in part
    with ``try_next()``, a blocking one-shot ``.result()`` on the same
    handle while the stream is open, then the rest of the stream.  Both
    answers equal the RPC path's, and the replica's channel still serves
    afterwards: its ``SERVED`` counts grow and the client is not dead."""
    from ray_tpu_torch.serve._private.dataplane import ChannelClient, ChannelStream
    from ray_tpu_torch.serve._private.router import _routers

    @serve.deployment(name="MixedDep")
    class MixedDep:
        def __call__(self, payload):
            return {"echo": payload}

        def tokens(self, n):
            for i in range(n):
                yield {"tok": i}

        def served(self):
            from ray_tpu_torch.serve._private import dataplane

            return dict(dataplane.SERVED)

    h = serve.run(MixedDep.bind(), name="mixed_dep")
    assert h.remote({"a": 1}).result(timeout=30) == {"echo": {"a": 1}}
    router = _routers[h.deployment_name]

    def served():
        # over actor RPC, so that reading the counts does not move them
        actor = router.get_replica_actor(router.pick()["replica_id"])
        return ray_tpu_torch.get(
            actor.handle_request.remote("served", (), {}, "", None), timeout=30)

    def mixed(n_items):
        gen = h.options(stream=True).tokens.remote(n_items)
        head = []
        for _ in _poll(30):
            item = gen.try_next()
            if item is not None:
                head.append(item)
            if len(head) == 3:
                break
        one = h.remote({"b": 2}).result(timeout=30)
        tail = []
        for _ in _poll(30):
            try:
                item = gen.try_next()
            except StopIteration:
                break
            if item is not None:
                tail.append(item)
        return gen, head + tail, one

    dps = [v for v in router._dataplanes.values() if isinstance(v, ChannelClient)]
    assert dps, "dataplane did not attach"
    before = served()
    gen, items, one = mixed(12)
    assert isinstance(gen._gen, ChannelStream)
    after = served()
    assert after["stream"] == before["stream"] + 1, (before, after)
    assert after["call"] == before["call"] + 1, (before, after)
    assert after["stream_items"] == before["stream_items"] + 12, (before, after)
    assert not dps[0].dead
    # the channel still serves: no fall back to RPC
    assert h.remote({"c": 3}).result(timeout=30) == {"echo": {"c": 3}}
    assert list(h.options(stream=True).tokens.remote(2)) == [{"tok": 0}, {"tok": 1}]
    again = served()
    assert again["call"] == after["call"] + 1 and again["stream"] == after["stream"] + 1
    assert router._dataplanes and all(not v.dead for v in router._dataplanes.values())

    # the same sequence over actor RPC gives the same answers
    monkeypatch.setenv("RAY_TPU_TORCH_serve_channel_dataplane", "0")
    rpc_gen, rpc_items, rpc_one = mixed(12)
    assert not isinstance(rpc_gen._gen, ChannelStream)
    assert served() == again
    assert (items, one) == (rpc_items, rpc_one) == (
        [{"tok": i} for i in range(12)], {"echo": {"b": 2}})


def test_rpc_path_exact(serve_cluster, monkeypatch):
    """With ``serve_channel_dataplane`` off the router->replica path is
    actor RPC (the reference's path with its channel dataplane off):
    calls and token streams come back exact, errors surface as their
    original type, concurrent streams interleave without crosstalk, and
    an early close releases the stream's in-flight slot."""
    from ray_tpu_torch.serve._private.router import _routers

    # the router lives in this process and reads the setting per call
    monkeypatch.setenv("RAY_TPU_TORCH_serve_channel_dataplane", "0")

    @serve.deployment(name="RpcDep")
    class RpcDep:
        def __call__(self, payload):
            if payload == "boom":
                raise ValueError("boom")
            return {"echo": payload}

        def tokens(self, n):
            for i in range(n):
                yield {"tok": i}

    h = serve.run(RpcDep.bind(), name="rpc_dep")
    assert h.remote({"a": 1}).result(timeout=30) == {"echo": {"a": 1}}
    router = _routers[h.deployment_name]
    gen = h.options(stream=True).tokens.remote(6)
    assert list(gen) == [{"tok": i} for i in range(6)]
    with pytest.raises(ValueError):
        h.remote("boom").result(timeout=30)
    gens = [h.options(stream=True).tokens.remote(4) for _ in range(8)]
    outs = [list(g) for g in gens]
    assert all(o == [{"tok": i} for i in range(4)] for o in outs)
    g = h.options(stream=True).tokens.remote(1000)
    g.close()
    assert all(v == 0 for v in router._queue_estimate.values()), router._queue_estimate
    # every call and stream above took RPC: no channel was attached
    assert router._dataplanes == {}, router._dataplanes
