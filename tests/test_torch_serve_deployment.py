"""The port's LLM deployments (ray_tpu_torch/serve/llm/deployment.py)
against the JAX package's, on tiny GPT-2 in float32 on the CPU.

Greedy tokens served through ``serve.run(build_app(...))`` of the port,
over HTTP and over a streaming handle, must equal the JAX ``LLMEngine``'s
on the same prompts and weights; so must the static-batch server's, and
a multiplexed variant's.  The replicas serve the weights the port draws
from the config's seed; the JAX side gets the same weights as a flax
tree, checked to carry back to the port's ``state_dict`` unchanged
through ``models/convert.py``.  Then the cluster cases of
tests/test_serve_llm.py, ported: stream and one-shot, proxy and engine
shedding over HTTP, queue-depth autoscaling, and disconnect-cancel with
zero KV leak.

The deployments are ``ray_tpu_torch`` classes or classes defined inside
a test (pickled by value), so no replica imports JAX; the JAX side runs
only in the pytest process.
"""

import asyncio
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.serve.llm import LLMConfig as JLLMConfig
from ray_tpu.serve.llm import LLMEngine as JLLMEngine
from ray_tpu.serve.llm import StaticBatchLLMServer as JStaticBatchLLMServer
from ray_tpu.serve.llm.engine import FINISHED as JFINISHED
from ray_tpu_torch import serve
from ray_tpu_torch._private import retry
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm import LLMConfig, StaticBatchLLMServer

torch.set_num_threads(2)

# the JAX package's serve tests bind fixed ports on the same host
_sock = socket.socket()
_sock.bind(("127.0.0.1", 0))
PROXY_PORT = _sock.getsockname()[1]
_sock.close()

# one config for both packages (the port's adds its device)
_BASE = dict(model="tiny", max_batch_size=2, num_blocks=64, block_size=8,
             temperature=0.0)


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed: ``for _ in _poll(30): ...``."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


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


def _prompts():
    rng = np.random.default_rng(0)
    return ([rng.integers(0, 512, size=n).tolist() for n in (5, 13, 40, 100)],
            [10, 7, 12, 9])


def _port_model(seed: int) -> tgpt2.GPT2:
    """The weights a port engine on the CPU draws from ``seed``."""
    cfg = LLMConfig(device="cpu", **_BASE).model_config()
    return tgpt2.init_model(cfg, torch.Generator(device="cpu").manual_seed(seed), "cpu")


def _jax_params(model: tgpt2.GPT2, template) -> dict:
    """The port model's weights as the JAX package's GPT-2 tree, shaped
    like ``template``; carried back through ``convert.py`` they must give
    the port's state_dict bit for bit."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def build(node, module):
        out = {}
        for key, leaf in node.items():
            name = f"{module}.{key}" if module else key
            if isinstance(leaf, dict):
                out[key] = build(leaf, name)
                continue
            if key == "kernel":
                a = sd[f"{module}.weight"].T
            elif key in ("scale", "embedding"):
                a = sd[f"{module}.weight"]
            else:
                a = sd[name].reshape(np.shape(leaf))
            assert a.shape == np.shape(leaf), name
            out[key] = np.ascontiguousarray(a)
        return out

    tree = build(jax.tree_util.tree_map(np.asarray, template), "")
    back = gpt2_state_dict_from_jax(tree, model.cfg)
    assert back.keys() == model.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    return jax.tree_util.tree_map(jnp.asarray, tree)


# a multiplexed variant's weights derive from its id (LLMServer's rule)
_V1_SEED = 1 + zlib.crc32(b"v1") % 997


@pytest.fixture(scope="module")
def jax_tokens():
    """Greedy streams of one JAX engine (one set of compiles) serving the
    port's weights: seed 0 over ``_prompts()``, then the ``v1`` variant's
    seed over its first two prompts.  {seed: [tokens per prompt]}."""
    prompts, max_tokens = _prompts()

    async def serve_all(eng, seed, n):
        eng.params = _jax_params(_port_model(seed), eng.params)
        reqs = [await eng.add_request(p, max_tokens=m)
                for p, m in zip(prompts[:n], max_tokens[:n])]
        outs = []
        for r in reqs:
            toks = []
            while (ev := await r.out.get()) is not JFINISHED:
                toks.append(ev["token"])
            outs.append(toks)
        return outs

    async def main():
        eng = JLLMEngine(JLLMConfig(**_BASE))
        out = {0: await serve_all(eng, 0, len(prompts)),
               _V1_SEED: await serve_all(eng, _V1_SEED, 2)}
        await eng.stop()
        return out

    return asyncio.run(main())


@pytest.fixture(scope="module")
def llm_app(serve_cluster):
    """One ``build_app`` LLMServer replica on the route ``/llm``, shared
    by the tests that need a plain one (a replica start imports torch):
    its handle."""
    cfg = LLMConfig(device="cpu", name="llm_shared", **_BASE)
    handle = serve.run(llm.build_app(cfg, route_prefix="/llm"),
                       name="llm_shared_app", http_port=PROXY_PORT)
    _wait_route("/llm")
    yield handle
    serve.delete("llm_shared")


def _wait_route(prefix: str, timeout: float = 30.0):
    for _ in _poll(timeout):
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{PROXY_PORT}/-/routes", timeout=5
            ) as r:
                if prefix in json.loads(r.read()):
                    return
        except Exception:  # noqa: BLE001
            pass
    raise AssertionError(f"route {prefix} never became live")


def _http_stream(path: str, payload: dict) -> list:
    """One chunked streaming request; the NDJSON events it carried."""
    conn = http.client.HTTPConnection("127.0.0.1", PROXY_PORT, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              "x-serve-stream": "1"})
        resp = conn.getresponse()
        assert resp.status == 200, (resp.status, resp.read())
        return [json.loads(line) for line in resp.read().decode().splitlines() if line]
    finally:
        conn.close()


def _kv_drained(handle, timeout: float = 30.0) -> dict:
    for _ in _poll(timeout):
        st = handle.stats.remote().result(timeout=30)
        if not st["kv_blocks_in_use"]:
            break
    return st


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------
def _proxy_dataplanes() -> dict:
    """deployment -> the kinds of the proxy's router's replica transports,
    read inside the proxy's process."""

    def read(_proxy):
        from ray_tpu_torch.serve._private.router import _routers

        return {name: sorted(type(v).__name__ for v in r._dataplanes.values())
                for name, r in _routers.items()}

    proxy = ray_tpu_torch.get_actor("SERVE_PROXY", "serve")
    return ray_tpu_torch.get(proxy.__ray_call__.remote(read), timeout=30)


def test_serve_run_llm_matches_jax_engine_over_http_and_handle(llm_app, jax_tokens):
    """build_app's LLMServer, reached through the HTTP proxy (four
    concurrent chunked streams) and through a streaming handle, streams
    the JAX engine's greedy tokens, then drains to zero KV blocks.  Both
    routes ride the replica's channel dataplane (the default), the
    proxy's router and this process's."""
    from ray_tpu_torch.serve._private.dataplane import ChannelClient, ChannelStream
    from ray_tpu_torch.serve._private.router import _routers

    prompts, max_tokens = _prompts()
    want = jax_tokens[0]
    assert [len(w) for w in want] == max_tokens
    handle = llm_app

    events = [None] * len(prompts)

    def call(i):
        events[i] = _http_stream("/llm", {"prompt": prompts[i],
                                          "max_tokens": max_tokens[i]})

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(e is not None for e in events), events
    assert [[e["token"] for e in ev if "token" in e] for ev in events] == want
    for ev in events:
        assert ev[-1]["done"] and ev[-1]["finish_reason"] == "length", ev[-1]
        assert not any("__serve_stream_meta__" in e for e in ev)
    assert _proxy_dataplanes()[handle.deployment_name] == ["ChannelClient"]

    gens = [handle.options(stream=True).generate.remote(
        {"prompt": p, "max_tokens": m}) for p, m in zip(prompts, max_tokens)]
    assert all(isinstance(g._gen, ChannelStream) for g in gens)
    got = [[e["token"] for e in g if "token" in e] for g in gens]
    assert got == want
    dps = list(_routers[handle.deployment_name]._dataplanes.values())
    assert len(dps) == 1 and isinstance(dps[0], ChannelClient), dps

    out = handle.remote({"prompt": prompts[1], "max_tokens": max_tokens[1]}).result(timeout=60)
    assert out["tokens"] == want[1] and out["finish_reason"] == "length"

    st = _kv_drained(handle)
    assert st["kv_leak_report"]["blocks_in_use"] == 0, st["kv_leak_report"]
    assert st["kv_leak_report"]["live_sequences"] == 0


def test_static_batch_run_batch_matches_reference_past_max_seq_len():
    """The static server's lockstep decode lets finished lanes run past
    max_seq_len: the long prompt's lane (120 of 128 positions, 4 tokens)
    keeps decoding while the short one generates 40.  The reference's
    position lookup is a JAX gather, which clamps; the port clamps too,
    and the batch's tokens equal the reference's on converted weights."""
    rng = np.random.default_rng(3)
    specs = [
        {"prompt": rng.integers(0, 512, size=120).tolist(), "max_tokens": 4},
        {"prompt": rng.integers(0, 512, size=5).tolist(), "max_tokens": 40},
        {"prompt": rng.integers(0, 512, size=30).tolist(), "max_tokens": 12},
    ]
    jsrv = JStaticBatchLLMServer(JLLMConfig(model="tiny", max_batch_size=4))
    want = jsrv._run_batch(specs)
    cfg = LLMConfig(model="tiny", max_batch_size=4, device="cpu")
    srv = StaticBatchLLMServer(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jsrv.params)
    srv.model.load_state_dict(gpt2_state_dict_from_jax(tree, cfg.model_config()))
    got = srv._run_batch(specs)
    assert [g["num_tokens"] for g in got] == [4, 40, 12]
    assert got == want


def test_static_server_through_serve_matches_reference(serve_cluster):
    """StaticBatchLLMServer deployed with serve: concurrent calls
    coalesce into @serve.batch batches, and each request's tokens equal
    the JAX static server's on the port's seed weights (a row's tokens
    do not depend on the batch it shares)."""
    prompts, max_tokens = _prompts()
    specs = [{"prompt": p, "max_tokens": m} for p, m in zip(prompts, max_tokens)]
    jsrv = JStaticBatchLLMServer(JLLMConfig(model="tiny", max_batch_size=4))
    jsrv.params = _jax_params(_port_model(0), jsrv.params)
    want = jsrv._run_batch(specs)

    dep = serve.deployment(name="llm_static")(StaticBatchLLMServer)
    cfg = LLMConfig(model="tiny", max_batch_size=4, device="cpu")
    handle = serve.run(dep.bind(cfg.to_dict(), batch_wait_timeout_s=0.2),
                       name="llm_static_app")
    responses = [handle.remote(s) for s in specs]
    got = [r.result(timeout=60) for r in responses]
    assert got == want
    serve.delete("llm_static")


def test_multiplexed_variant_matches_jax_and_evicts_lru(llm_app, jax_tokens):
    """A multiplexed model id selects a variant engine whose weights
    derive from the id (seed + 1 + crc32(id) % 997): its greedy tokens
    equal the JAX engine's on those weights, and a third id evicts the
    least recently used variant (two per replica)."""
    prompts, max_tokens = _prompts()
    want = jax_tokens[_V1_SEED]
    handle = llm_app
    v1 = handle.options(multiplexed_model_id="v1", stream=True)
    got = [[e["token"] for e in v1.generate.remote({"prompt": p, "max_tokens": m})
            if "token" in e] for p, m in zip(prompts[:2], max_tokens[:2])]
    assert got == want
    for mid in ("v2", "v3"):
        out = handle.options(multiplexed_model_id=mid).remote(
            {"prompt": [1, 2], "max_tokens": 3}).result(timeout=60)
        assert out["num_tokens"] == 3
    st = handle.stats.remote().result(timeout=30)
    assert set(st["multiplex"]["loaded_model_ids"]) == {"v2", "v3"}
    assert st["multiplex"]["evictions"] == 1


# ----------------------------------------------------------------------
# cluster cases of tests/test_serve_llm.py, ported
# ----------------------------------------------------------------------
def test_llm_serve_stream_and_oneshot(llm_app):
    handle = llm_app
    out = handle.remote({"prompt": [1, 2, 3], "max_tokens": 5}).result(timeout=60)
    assert out["num_tokens"] == 5 and len(out["tokens"]) == 5
    events = list(handle.options(stream=True).generate.remote(
        {"prompt": "hi", "max_tokens": 4}
    ))
    assert [e["token"] for e in events if "token" in e.keys()][:4]
    assert events[-1]["done"] and events[-1]["num_tokens"] == 4
    # explicit cancel mid-stream frees blocks on the replica
    gen = handle.options(stream=True).generate.remote(
        {"prompt": "xy", "max_tokens": 400}
    )
    it = iter(gen)
    first = next(it)
    handle.cancel.remote(first["request_id"]).result(timeout=30)
    list(it)  # drains to the cancelled sentinel
    st = _kv_drained(handle, timeout=10)
    assert st["kv_blocks_in_use"] == 0, st["kv_leak_report"]


def test_autoscale_up_down_from_queue_depth(serve_cluster):
    """Synthetic queue depth reported via __serve_stats__ drives real
    replica add/remove through the controller's autoscaling_config."""

    @serve.deployment(
        name="synthload",
        num_replicas=1,
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 3,
            "target_ongoing_requests": 2.0,
            "upscale_delay_s": 0.5,
            "downscale_delay_s": 1.0,
        },
    )
    class SynthLoad:
        def __init__(self):
            self.depth = 0

        def set_depth(self, d):
            self.depth = d
            return d

        def __serve_stats__(self):
            return {"queued": self.depth}

        def __call__(self, payload):
            return "ok"

    handle = serve.run(SynthLoad.bind(), name="synthload_app")

    def running():
        return serve.status()["synthload"]["num_running"]

    # every replica reports depth 10 >> target 2 -> scale to max
    handle.set_depth.remote(10).result(timeout=30)
    for _ in _poll(60):
        if running() >= 3:
            break
        # new replicas start at depth 0; keep pushing load to all of them
        try:
            handle.set_depth.remote(10).result(timeout=30)
        except Exception:
            pass
    assert running() == 3, f"never scaled up: {running()} running"
    # drain: depth 0 everywhere -> scale back down to min
    for _ in _poll(1.8):
        try:
            handle.set_depth.remote(0).result(timeout=30)
        except Exception:
            pass
    for _ in _poll(60):
        if running() <= 1:
            break
        try:
            handle.set_depth.remote(0).result(timeout=30)
        except Exception:
            pass
    assert running() == 1, f"never scaled down: {running()} running"
    serve.delete("synthload")


def _http_flood(path: str, payloads: list, stagger_s: float = 0.0) -> dict:
    """POST each payload from its own thread; {i: (kind, status,
    Retry-After or error)}."""
    results = {}

    def call(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{PROXY_PORT}{path}",
            data=json.dumps(payloads[i]).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                results[i] = ("ok", resp.status, None)
        except urllib.error.HTTPError as e:
            results[i] = ("http_error", e.code, e.headers.get("Retry-After"))
        except Exception as e:  # noqa: BLE001
            results[i] = ("error", None, str(e))

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(payloads))]
    for t in threads:
        t.start()
        time.sleep(stagger_s)  # establish arrival order
    for t in threads:
        t.join(timeout=120)
    return results


def test_proxy_sheds_past_queue_bound(serve_cluster):
    """Past max_queued_requests the proxy sheds with 503 + Retry-After
    instead of queueing unboundedly; capacity returning un-sheds."""

    @serve.deployment(name="shedme", max_queued_requests=2, route_prefix="/shedme")
    class Slow:
        async def __call__(self, payload):
            await asyncio.sleep(1.0)
            return {"ok": True}

    serve.run(Slow.bind(), name="shed_app", http_port=PROXY_PORT)
    _wait_route("/shedme")
    results = _http_flood("/shedme", [{"i": i} for i in range(8)], stagger_s=0.02)
    oks = [r for r in results.values() if r[0] == "ok"]
    sheds = [r for r in results.values() if r[0] == "http_error" and r[1] == 503]
    assert oks, results
    assert sheds, f"no 503s under overload: {results}"
    assert all(r[2] == "1" for r in sheds), "503 without Retry-After"
    # overload gone: requests flow again
    again = _http_flood("/shedme", [{"i": 0}])
    assert again[0][0] == "ok", again
    serve.delete("shedme")


def test_engine_shed_maps_to_503_over_http(serve_cluster):
    """A RequestShedError raised in the ENGINE (inside the replica, so
    it crosses the task boundary as a derived task error) must still
    surface as 503 + Retry-After at the proxy."""
    app = llm.build_app(
        LLMConfig(model="tiny", max_batch_size=1, num_blocks=64, block_size=8,
                  max_queue=1, name="llm_eshed", device="cpu"),
        route_prefix="/eshed",
        max_ongoing_requests=64,
    )
    serve.run(app, name="llm_eshed_app", http_port=PROXY_PORT)
    _wait_route("/eshed")
    results = _http_flood("/eshed", [{"prompt": [i], "max_tokens": 100}
                                     for i in range(10)])
    sheds = [r for r in results.values() if r[1] == 503]
    oks = [r for r in results.values() if r[0] == "ok"]
    others = [r for r in results.values() if r[0] == "error" or r[1] not in (200, 503)]
    assert not others, f"engine shed surfaced as non-503: {results}"
    assert sheds, f"flood never shed through the engine bound: {results}"
    assert all(r[2] == "1" for r in sheds), f"503 without Retry-After: {sheds}"
    assert oks, results
    serve.delete("llm_eshed")


def test_llm_http_token_streaming_and_disconnect(llm_app):
    """HTTP chunked token streaming (one NDJSON event per token, the
    transport meta item stripped by the proxy), and client disconnect
    mid-stream releasing the request's KV blocks via the proxy's
    disconnect-cancel contract."""
    handle = serve.get_deployment_handle("llm_shared")
    # the replica is shared with other tests: count this test's tokens
    tokens_before = handle.stats.remote().result(timeout=30)["total_tokens"]
    lines = _http_stream("/llm", {"prompt": "hey", "max_tokens": 5})
    tokens = [e for e in lines if "token" in e]
    assert len(tokens) == 5, lines
    assert lines[-1].get("done"), lines
    assert not any("__serve_stream_meta__" in e for e in lines), (
        "transport meta leaked to the client"
    )

    # disconnect mid-stream: read a little, then drop the connection —
    # the proxy must cancel the request so its blocks free
    conn = http.client.HTTPConnection("127.0.0.1", PROXY_PORT, timeout=30)
    body = json.dumps({"prompt": "long", "max_tokens": 120})
    conn.request("POST", "/llm", body=body,
                 headers={"Content-Type": "application/json",
                          "x-serve-stream": "1"})
    resp = conn.getresponse()
    resp.read(40)  # a few token events
    conn.close()  # abandon the stream

    st = None
    for _ in _poll(30):
        st = handle.stats.remote().result(timeout=30)
        if st["kv_blocks_in_use"] == 0 and st["waiting"] == 0 and st["running"] == 0:
            break
    assert st["kv_blocks_in_use"] == 0, f"KV leak after disconnect: {st['kv_leak_report']}"
    # the cancel reached the engine: the abandoned request did not run to
    # its 120 tokens
    assert st["total_tokens"] - tokens_before < 5 + 120, (st["total_tokens"], tokens_before)
    # the proxy stays healthy and keeps serving
    out = handle.remote({"prompt": [1], "max_tokens": 3}).result(timeout=60)
    assert out["num_tokens"] == 3
