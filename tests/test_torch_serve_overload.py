"""The port's overload armor (ray_tpu_torch/serve/llm/overload.py, the
engine's fair queue, preemption and brownout, and the proxy's token
quotas) on the CPU: the cases of tests/test_serve_overload.py, ported.
Preempt-by-recompute must stay token-exact against an uninterrupted
greedy run, and every storm must balance the KV pool.  The cluster cases
run the port's serve plane (no JAX in this file: replicas import it)."""

import asyncio
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import retry
from ray_tpu_torch.serve.exceptions import RequestShedError
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
from ray_tpu_torch.serve.llm.engine import FINISHED
from ray_tpu_torch.serve.llm.overload import (
    DegradationController,
    TenantBuckets,
    TokenBucket,
    normalize_slo,
)

torch.set_num_threads(2)

_CLUSTER_ENV = {
    # The suite runs many clusters at once, the JAX package's among them:
    # no 2 GiB shm arena prefault per raylet, and no memory monitor, which
    # watches the whole machine and would kill this test's workers for
    # the others' memory.
    "RAY_TPU_TORCH_arena_prefault_bytes": "0",
    "RAY_TPU_TORCH_memory_monitor_enabled": "0",
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the JAX package's overload tests bind 18129 on the same host
PROXY_PORT = _free_port()


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
        for k, v in _CLUSTER_ENV.items():
            mp.setenv(k, v)
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def serve_cluster(ray_cluster):
    yield ray_cluster
    try:
        serve.shutdown()
    except Exception:  # noqa: BLE001 — a chaos drill may have torn down
        pass


def _tiny(**kw) -> LLMConfig:
    base = dict(model="tiny", max_batch_size=4, num_blocks=64, block_size=8,
                default_max_tokens=8, device="cpu")
    base.update(kw)
    return LLMConfig(**base)


async def _drain(req):
    toks = []
    while True:
        ev = await req.out.get()
        if ev is FINISHED:
            return toks
        toks.append(ev["token"])


def _wait_route(prefix: str, port: int = PROXY_PORT, timeout: float = 30.0):
    for _ in _poll(timeout):
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/-/routes", timeout=5
            ) as r:
                if prefix in json.loads(r.read()):
                    return
        except Exception:  # noqa: BLE001
            pass
    raise AssertionError(f"route {prefix} never became live")


def _post(path: str, payload: dict, headers: dict = None,
          port: int = PROXY_PORT, timeout: float = 60.0):
    """(status, body_bytes, response_headers); HTTP errors return their
    status instead of raising."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# ----------------------------------------------------------------------
# pure math: token buckets
# ----------------------------------------------------------------------
def test_token_bucket_charge_refund_refill():
    b = TokenBucket(rate=10, burst=20)
    assert b.charge(20, now=0.0)          # full burst goes through
    assert not b.charge(1, now=0.0)       # empty: refused, NOT deducted
    assert b.level(now=0.0) == 0.0
    b.refund(5)
    assert b.charge(5, now=0.0)           # the refund is spendable
    assert b.charge(10, now=1.0)          # 1s at rate 10 refilled 10
    assert not b.charge(1, now=1.0)
    # refill caps at burst, refund caps at burst
    assert b.level(now=100.0) == 20.0
    b.refund(10**6)
    assert b.level(now=100.0) == 20.0


def test_token_bucket_retry_after():
    b = TokenBucket(rate=10, burst=20)
    assert b.charge(20, now=0.0)
    # 10-token deficit at 10 tok/s -> 1s (and never below the 1s floor)
    assert b.retry_after(10, now=0.0) == pytest.approx(1.0)
    assert b.retry_after(2, now=0.0) == 1.0
    # a request larger than burst is bounded by the burst deficit
    assert b.retry_after(10**9, now=0.0) == pytest.approx(2.0)
    frozen = TokenBucket(rate=0, burst=5)
    assert frozen.charge(5, now=0.0)
    assert frozen.retry_after(1, now=0.0) == 60.0


def test_tenant_buckets_unregistered_unlimited():
    tb = TenantBuckets({"metered": {"rate": 5, "burst": 10}})
    assert set(tb.registered()) == {"metered"}
    # no quota entry -> always admitted, no retry hint
    for _ in range(100):
        assert tb.charge("anon", 10**6, now=0.0) == (True, 0.0)
    ok, retry = tb.charge("metered", 10, now=0.0)
    assert ok and retry == 0.0
    ok, retry = tb.charge("metered", 1, now=0.0)
    assert not ok and retry >= 1.0
    tb.refund("metered", 4)
    assert tb.charge("metered", 4, now=0.0) == (True, 0.0)
    # refunding an unregistered tenant is a no-op, not an error
    tb.refund("anon", 50)


def test_slo_priority_orders_classes():
    """The port's overload module carries the reference's slo_priority:
    interactive > standard > batch, unknown strings fold to standard."""
    from ray_tpu_torch.serve.llm.overload import SLO_CLASSES, slo_priority

    assert SLO_CLASSES == ("interactive", "standard", "batch")
    assert slo_priority("interactive") > slo_priority("standard") > slo_priority("batch")
    assert slo_priority("platinum") == slo_priority("standard") == slo_priority(None)


# ----------------------------------------------------------------------
# pure math: SLO classes
# ----------------------------------------------------------------------
def test_normalize_slo():
    assert normalize_slo("interactive") == "interactive"
    assert normalize_slo(" Batch ") == "batch"
    for junk in (None, "", "gold-tier", "INTERACTIVE!!", "0"):
        assert normalize_slo(junk) == "standard"


# ----------------------------------------------------------------------
# pure math: brownout ladder
# ----------------------------------------------------------------------
def test_degradation_ladder_hysteresis_and_monotonicity():
    d = DegradationController(ttft_slo_s=1.0, queue_high=10,
                              down_ticks=3, up_ticks=5)
    assert d.enabled
    levels = [d.level]
    # sustained violation: one step per down_ticks, never a jump
    for _ in range(12):
        levels.append(d.tick(5.0, 0))
    assert levels[:10] == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3]
    assert d.level == 3  # clamped at LEVEL_MAX
    assert all(abs(b - a) <= 1 for a, b in zip(levels, levels[1:]))
    # the hysteresis band (between recover_margin*bound and bound)
    # HOLDS the level and resets both streaks — no flapping
    for _ in range(20):
        assert d.tick(0.9, 0) == 3
    # two healthy ticks then a violation: the healthy streak resets
    d.tick(0.1, 0), d.tick(0.1, 0)
    d.tick(5.0, 0)
    for _ in range(4):
        assert d.tick(0.1, 0) == 3
    # sustained healthy: recovers one step per up_ticks back to 0
    up = [d.tick(0.1, 0) for _ in range(16)]
    assert up[0] == 2 and up[-1] == 0
    assert all(abs(b - a) <= 1 for a, b in zip(up, up[1:]))
    # queue depth alone violates too
    d2 = DegradationController(ttft_slo_s=1.0, queue_high=10, down_ticks=1)
    d2.tick(None, 50)
    assert d2.level == 1


def test_degradation_shed_ordering_never_interactive():
    d = DegradationController(ttft_slo_s=1.0, queue_high=10, down_ticks=1)
    for expect_batch, expect_std in [(False, False), (False, False),
                                     (True, False), (True, True)]:
        assert d.should_shed("batch") is expect_batch
        assert d.should_shed("standard") is expect_std
        assert d.should_shed("interactive") is False
        d.tick(9.0, 0)
    # at the deepest level interactive STILL flows
    assert d.level == 3 and not d.should_shed("interactive")
    # level >= 1 clamps only batch generation budgets
    assert d.max_tokens_cap("batch", 500) == d.batch_max_tokens
    assert d.max_tokens_cap("standard", 500) == 500
    assert d.max_tokens_cap("interactive", 500) == 500
    # disabled controller is inert regardless of signals
    off = DegradationController(ttft_slo_s=0.0, queue_high=1, down_ticks=1)
    assert not off.enabled
    for _ in range(10):
        assert off.tick(10**6, 10**6) == 0
    assert not off.should_shed("batch")


# ----------------------------------------------------------------------
# engine: tenant-fair queue, preemption, storm accounting, brownout
# ----------------------------------------------------------------------
def test_engine_fair_queue_victim_overtakes_hog_backlog():
    """With DRF fairness a newly-arrived tenant's request is admitted
    ahead of another tenant's queued backlog (zero dominant share beats
    any positive share) — FIFO would make it wait behind all of it."""

    async def main():
        eng = LLMEngine(_tiny(max_batch_size=2, preempt_wait_s=30.0,
                              tenant_weights={"hog": 1.0, "victim": 1.0}))
        hogs = [
            await eng.add_request([1 + i, 2, 3], max_tokens=30,
                                  tenant="hog", slo="batch")
            for i in range(6)
        ]
        while not all(h.generated >= 1 for h in hogs[:2]):
            await asyncio.sleep(0.01)
        vic = await eng.add_request([9, 9], max_tokens=4,
                                    tenant="victim", slo="interactive")
        st_mid = eng.stats()
        await asyncio.gather(*[_drain(r) for r in hogs + [vic]])
        report = eng.bm.leak_report()
        await eng.stop()
        return hogs, vic, st_mid, report

    hogs, vic, st_mid, report = asyncio.run(main())
    # per-tenant usage was visible while contended
    assert "hog" in st_mid["tenants"], st_mid
    # the victim overtook the ENTIRE queued hog backlog (two lanes can
    # free at one step boundary, so a hog may join the SAME step — but
    # never an earlier one; FIFO would have made the victim wait for 4)
    queued_hogs = hogs[2:]
    assert all(vic.join_step <= h.join_step for h in queued_hogs), (
        vic.join_step, [h.join_step for h in queued_hogs]
    )
    assert len(vic.tokens) == 4
    assert report["blocks_in_use"] == 0


def test_engine_preempt_by_recompute_token_exact():
    """An interactive arrival with no free lane preempts a batch lane;
    the victim's KV is freed and its generated-so-far folds into the
    prompt, so its final token sequence is IDENTICAL to an uninterrupted
    greedy run — preemption must be invisible in the output."""
    prompts, hog_tokens = [[3, 1, 4], [2, 7, 1]], 40

    async def interrupted():
        eng = LLMEngine(_tiny(max_batch_size=2, preempt_wait_s=0.005,
                              temperature=0.0,
                              tenant_weights={"a": 1.0, "b": 1.0}))
        hogs = [
            await eng.add_request(p, max_tokens=hog_tokens,
                                  tenant="a", slo="batch")
            for p in prompts
        ]
        while not all(h.generated >= 3 for h in hogs):
            await asyncio.sleep(0.01)
        vic = await eng.add_request([5, 5], max_tokens=4,
                                    tenant="b", slo="interactive")
        await asyncio.gather(*[_drain(r) for r in hogs + [vic]])
        st = eng.stats()
        report = eng.bm.leak_report()
        await eng.stop()
        return hogs, vic, st, report

    async def uninterrupted(prompt):
        eng = LLMEngine(_tiny(max_batch_size=2, temperature=0.0))
        req = await eng.add_request(prompt, max_tokens=hog_tokens)
        toks = await _drain(req)
        await eng.stop()
        return toks

    hogs, vic, st, report = asyncio.run(interrupted())
    assert st["preemptions_total"] >= 1, "drill is vacuous: nothing preempted"
    assert any(h.preemptions >= 1 for h in hogs), (
        "a batch lane should have been the victim"
    )
    # victims are only ever strictly-lower-priority lanes
    assert vic.preemptions == 0
    assert any(e["type"] == "preemption" and e["victim_slo"] == "batch"
               for e in st["events"]), st["events"]
    # token-exactness: EVERY hog (preempted or not) parity-checks against
    # its own uninterrupted greedy run — preemption is invisible
    for hog, prompt in zip(hogs, prompts):
        assert hog.tokens == asyncio.run(uninterrupted(prompt)), (
            f"hog with {hog.preemptions} preemption(s) diverged"
        )
    # KV accounting balanced through free -> fold -> re-prefill
    assert report["blocks_in_use"] == 0
    assert report["total_allocs"] == report["total_frees"]


def test_engine_preempt_parity_exact_for_known_victim():
    """Single-lane variant pins WHICH request is preempted, so the
    parity assertion is exact: same prompt, same seed, one run preempted
    (possibly repeatedly), one not — byte-identical token streams."""
    prompt, n = [6, 2, 8], 30

    async def run(preempt: bool):
        eng = LLMEngine(_tiny(max_batch_size=1, preempt_wait_s=0.005,
                              temperature=0.0,
                              tenant_weights={"a": 1.0, "b": 1.0}))
        hog = await eng.add_request(prompt, max_tokens=n,
                                    tenant="a", slo="batch")
        vics = []
        if preempt:
            while hog.generated < 4:
                await asyncio.sleep(0.01)
            vics.append(await eng.add_request([5], max_tokens=3,
                                              tenant="b", slo="interactive"))
            while not vics[0].finish_reason:
                await asyncio.sleep(0.01)
            # a second wave AFTER the hog is back in the lane forces a
            # second preemption through the fold-resume path
            while hog.slot < 0 and not hog.finish_reason:
                await asyncio.sleep(0.005)
            vics.append(await eng.add_request([7], max_tokens=3,
                                              tenant="b", slo="interactive"))
        await asyncio.gather(*[_drain(r) for r in [hog] + vics])
        st = eng.stats()
        report = eng.bm.leak_report()
        await eng.stop()
        return hog, st, report

    hog_p, st_p, rep_p = asyncio.run(run(preempt=True))
    hog_o, _, _ = asyncio.run(run(preempt=False))
    assert hog_p.preemptions >= 2, "drill is vacuous: fewer than 2 preemptions"
    assert st_p["preemptions_total"] >= 2
    assert hog_p.tokens == hog_o.tokens, (
        "preempt-by-recompute diverged from the uninterrupted run"
    )
    assert len(hog_p.tokens) == n and hog_p.finish_reason == "length"
    assert rep_p["blocks_in_use"] == 0
    assert rep_p["total_allocs"] == rep_p["total_frees"]


def test_engine_cancel_preempt_storm_zero_leak():
    """A storm of mixed-class multi-tenant requests with cancels landing
    on waiting, running, and preempted requests must balance the KV pool
    to zero — `_finish` is the only exit and every path reaches it."""

    async def main():
        eng = LLMEngine(_tiny(max_batch_size=2, preempt_wait_s=0.02,
                              num_blocks=96,
                              tenant_weights={"a": 1.0, "b": 1.0}))
        reqs = []
        for i in range(24):
            r = await eng.add_request(
                [1 + (i % 7), 2, 3],
                max_tokens=6 + (i % 9),
                tenant="a" if i % 2 == 0 else "b",
                slo=("interactive", "standard", "batch")[i % 3],
            )
            reqs.append(r)
            if i % 3 == 0:
                await asyncio.sleep(0.005)
            if i % 4 == 3:  # cancel a recent one in whatever state it is
                eng.cancel(reqs[i - 1].request_id)
        await asyncio.sleep(0.05)
        for r in reqs[::5]:  # second wave, some mid-decode / post-preempt
            eng.cancel(r.request_id)
        await asyncio.gather(*[_drain(r) for r in reqs])
        deadline = time.monotonic() + 10
        while eng.bm.blocks_in_use and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        report = eng.bm.leak_report()
        await eng.stop()
        return report

    report = asyncio.run(main())
    assert report["blocks_in_use"] == 0, report
    assert report["live_sequences"] == 0
    assert report["total_allocs"] == report["total_frees"]


def test_engine_brownout_sheds_batch_admits_interactive():
    async def main():
        eng = LLMEngine(_tiny(slo_ttft_s=0.5, max_queue=64))
        # drive the ladder directly (the engine ticks it at its 1 Hz
        # control tick; the ladder math itself is unit-tested above)
        for _ in range(3):
            eng._degrade.tick(10.0, 10**6)
        assert eng._degrade.level == 1
        # level 1: batch budgets clamp, nothing shed yet
        br = await eng.add_request([1, 2], max_tokens=500, slo="batch")
        assert br.max_tokens == eng._degrade.batch_max_tokens
        for _ in range(6):
            eng._degrade.tick(10.0, 10**6)
        assert eng._degrade.level == 3
        with pytest.raises(RequestShedError):
            await eng.add_request([3], max_tokens=4, slo="batch")
        with pytest.raises(RequestShedError):
            await eng.add_request([3], max_tokens=4, slo="standard")
        # interactive is NEVER shed by brownout
        ir = await eng.add_request([4, 5], max_tokens=4, slo="interactive")
        await asyncio.gather(_drain(br), _drain(ir))
        st = eng.stats()
        await eng.stop()
        return ir, st

    ir, st = asyncio.run(main())
    assert len(ir.tokens) == 4
    assert st["degradation_level"] == 3
    assert st["shed_total"] == 2


def test_engine_shed_attributes_where_and_tenant():
    """The engine's shed hook: each shed is counted under (where, tenant
    label) and flushed to the telemetry counter on the forced control
    tick, so the pending map is empty right after the raise."""
    async def main():
        eng = LLMEngine(_tiny(max_queue=1, tenant_quotas={"acme": {"rate": 1}}))
        eng._stopped = True  # no step loop: the queue stays full
        eng.ensure_started()
        await eng.add_request([1], max_tokens=2, tenant="acme")
        seen = []
        orig = eng._push_metrics

        def spy(force=False):
            seen.append(dict(eng._shed_unreported))
            orig(force=force)

        eng._push_metrics = spy
        with pytest.raises(RequestShedError):
            await eng.add_request([2], max_tokens=2, tenant="acme")
        with pytest.raises(RequestShedError):
            await eng.add_request([3], max_tokens=2, tenant="stranger")
        pending = dict(eng._shed_unreported)
        st = eng.stats()
        eng._stopped = False
        await eng.stop()
        return seen, pending, st

    seen, pending, st = asyncio.run(main())
    assert seen == [{("engine", "acme"): 1}, {("engine", "other"): 1}], seen
    assert pending == {}
    assert st["shed_total"] == 2
    assert st["kv_leak_report"]["blocks_in_use"] == 0


def test_engine_queued_depth_counts_waiting_and_lanes():
    async def main():
        eng = LLMEngine(_tiny(max_batch_size=1))
        assert eng.queued_depth() == 0
        reqs = [await eng.add_request([1, 2], max_tokens=20) for _ in range(3)]
        depth = eng.queued_depth()
        await asyncio.gather(*[_drain(r) for r in reqs])
        after = eng.queued_depth()
        await eng.stop()
        return depth, after

    depth, after = asyncio.run(main())
    assert depth == 3 and after == 0


def test_engine_records_request_spans():
    """The engine's per-request spans land in the process span log:
    serve.request is the root, and queue, prefill and decode hang off it
    in time order."""
    from ray_tpu_torch.util import tracing

    tracing.drain_spans()  # isolate

    async def main():
        eng = LLMEngine(_tiny())
        req = await eng.add_request([1, 2, 3], max_tokens=4)
        await _drain(req)
        await eng.stop()
        return req

    req = asyncio.run(main())
    spans = [s for s in tracing.drain_spans() if s["name"].startswith("serve.")]
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"serve.request", "serve.queue", "serve.prefill",
                            "serve.decode"}
    root = by_name["serve.request"]
    assert root["attributes"]["tokens"] == 4
    assert root["attributes"]["request_id"] == req.request_id
    for name in ("serve.queue", "serve.prefill", "serve.decode"):
        assert by_name[name]["parent_span_id"] == root["span_id"]
        assert by_name[name]["trace_id"] == root["trace_id"]
    assert (by_name["serve.queue"]["end_time"] <= by_name["serve.prefill"]["end_time"]
            <= by_name["serve.decode"]["end_time"])


# ----------------------------------------------------------------------
# replica: multiplexed model variants with LRU swap
# ----------------------------------------------------------------------
def test_multiplex_variant_lru_swap_and_eviction_count():
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    async def main():
        srv = LLMServer(_tiny(name="mx").to_dict())
        e_a = await srv._engine_for({"model_id": "a", "prompt": [1]})
        e_b = await srv._engine_for({"model_id": "b", "prompt": [1]})
        assert e_a is not e_b is not srv.engine
        # cache hit: same id -> same engine, no reload
        assert await srv._engine_for({"model_id": "a", "prompt": [1]}) is e_a
        assert srv._mx_evictions == 0
        # third variant exceeds MAX_MODELS_PER_REPLICA=2 -> LRU (b) out
        e_c = await srv._engine_for({"model_id": "c", "prompt": [1]})
        ids = {v.model_id for v in srv._loaded_variants()}
        assert ids == {"a", "c"} and srv._mx_evictions == 1
        # the evicted id reloads as a FRESH engine (and evicts again)
        e_b2 = await srv._engine_for({"model_id": "b", "prompt": [1]})
        assert e_b2 is not e_b and srv._mx_evictions == 2
        # empty model_id means the base engine
        assert await srv._engine_for({"prompt": [1]}) is srv.engine
        # a variant engine actually serves, with its own derived weights
        req = await e_c.add_request([1, 2, 3], max_tokens=4)
        toks = await _drain(req)
        assert len(toks) == 4
        stats = srv.stats()
        assert set(stats["multiplex"]["loaded_model_ids"]) == {"c", "b"}
        assert stats["multiplex"]["evictions"] == 2
        await srv.__serve_shutdown__()

    asyncio.run(main())


# ----------------------------------------------------------------------
# cluster: identity threading + proxy quota admission
# ----------------------------------------------------------------------
def test_identity_threads_header_and_handle_to_replica(serve_cluster):
    """tenant + SLO class reach the replica's request context through
    BOTH front doors: the proxy's x-serve-* headers and the handle's
    options(tenant=, slo_class=) — across the router's replica call."""

    @serve.deployment(name="whoami", route_prefix="/whoami")
    class WhoAmI:
        def __call__(self, payload):
            return {"tenant": serve.get_request_tenant(),
                    "slo": serve.get_request_slo()}

    handle = serve.run(WhoAmI.bind(), name="whoami_app", http_port=PROXY_PORT)
    # handle kwarg path
    out = handle.options(tenant="acme", slo_class="interactive").remote(
        {}).result(timeout=60)
    assert out == {"tenant": "acme", "slo": "interactive"}
    # no identity -> defaults (and the derived handle didn't stick)
    out = handle.remote({}).result(timeout=60)
    assert out == {"tenant": "default", "slo": "standard"}
    # unknown SLO strings clamp instead of minting labels
    out = handle.options(tenant="acme", slo_class="platinum").remote(
        {}).result(timeout=60)
    assert out["slo"] == "standard"
    # HTTP header path through the proxy
    _wait_route("/whoami")
    status, body, _ = _post("/whoami", {"x": 1},
                            headers={"x-serve-tenant": "acme",
                                     "x-serve-slo": "interactive"})
    assert status == 200 and json.loads(body) == {
        "tenant": "acme", "slo": "interactive"}
    # payload fields win over headers
    status, body, _ = _post("/whoami", {"tenant": "beta", "slo": "batch"},
                            headers={"x-serve-tenant": "acme"})
    assert status == 200 and json.loads(body) == {
        "tenant": "beta", "slo": "batch"}
    serve.delete("whoami")


def test_proxy_tenant_quota_429_attributed_to_hostile_only(serve_cluster):
    """Over-quota tenants get 429 + Retry-After at the proxy; in-quota
    tenants are untouched, and the shed counters attribute every quota
    shed to the hostile tenant only."""
    from ray_tpu_torch.serve import llm

    cfg = _tiny(
        name="llm_quota",
        tenant_quotas={
            # hostile: one small burst, then effectively frozen
            "hostile": {"rate": 0.001, "burst": 30},
            "victim": {"rate": 1e6, "burst": 1e6},
        },
    )
    app = llm.build_app(cfg, route_prefix="/quota")
    serve.run(app, name="llm_quota_app", http_port=PROXY_PORT)
    _wait_route("/quota")

    def call(tenant):
        return _post("/quota", {"prompt": "hi", "max_tokens": 8},
                     headers={"x-serve-tenant": tenant})

    # hostile: the burst admits ~3 requests (est = 2 prompt bytes + 8),
    # then the bucket refuses — completion refunds only the unused part
    codes = [call("hostile")[0] for _ in range(8)]
    assert 200 in codes, codes
    rejected = [c for c in codes if c == 429]
    assert rejected, f"hostile was never throttled: {codes}"
    status, _, headers = call("hostile")
    assert status == 429
    assert int(headers.get("Retry-After", "0")) >= 1
    # the victim flows freely the whole time
    for _ in range(5):
        status, body, _ = call("victim")
        assert status == 200, (status, body)
        assert json.loads(body)["num_tokens"] == 8
    # shed attribution: only the hostile tenant appears
    with urllib.request.urlopen(
        f"http://127.0.0.1:{PROXY_PORT}/-/stats", timeout=10
    ) as r:
        stats = json.loads(r.read())
    per_tenant = stats.get("shed_tenant", {}).get("llm_quota", {})
    assert per_tenant.get("hostile", 0) >= len(rejected), stats
    assert "victim" not in per_tenant, stats
    serve.delete("llm_quota")


# ----------------------------------------------------------------------
# chaos drills (slow; copies of the reference's): a replica killed mid-stream
# (tests/test_serve_llm.py), a tenant storm with a replica kill
# ----------------------------------------------------------------------
@pytest.mark.slow  # ~17 s replica-kill drill: runs under `-m chaos`
@pytest.mark.chaos
def test_chaos_replica_kill_mid_stream(serve_cluster):
    """Kill one replica mid-load: its streams fail, streams on the
    survivor are unaffected, new requests re-route, the controller
    replaces the dead replica, and KV accounting on the survivor still
    balances to zero."""
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    app = llm.build_app(
        LLMConfig(model="tiny", max_batch_size=4, num_blocks=128,
                  block_size=8, name="llm_chaos", device="cpu"),
        num_replicas=2,
    )
    handle = serve.run(app, name="llm_chaos_app")
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")

    def replica_actors():
        reps = ray_tpu_torch.get(controller.get_replicas.remote("llm_chaos"))
        return {
            r["replica_id"]: ray_tpu_torch.get_actor(r["actor_name"], "serve")
            for r in reps
        }

    deadline = time.time() + 60
    while time.time() < deadline and len(replica_actors()) < 2:
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.5)
    actors = replica_actors()
    assert len(actors) == 2

    # open LONG streams (120 tokens ~ seconds of decode runway) so they
    # are genuinely in flight at kill time; "total" is the replica's
    # monotonic stream-request counter, so spread detection can't race
    # completions
    streams = []
    counts = {rid: 0 for rid in actors}
    deadline = time.time() + 60
    while time.time() < deadline and (
        len(streams) < 8 or not all(c >= 2 for c in counts.values())
    ):
        gen = handle.options(stream=True).generate.remote(
            {"prompt": [1, 2, 3], "max_tokens": 120}
        )
        it = iter(gen)
        first = next(it)  # established: first token arrived
        streams.append({"it": it, "first": first, "tokens": [first["token"]]})
        counts = {
            rid: ray_tpu_torch.get(a.stats.remote()).get("total", 0)
            for rid, a in actors.items()
        }
        if len(streams) >= 20:
            break
    assert all(c >= 1 for c in counts.values()), f"streams never spread: {counts}"

    victim_id = max(counts, key=counts.get)
    survivor_id = next(rid for rid in counts if rid != victim_id)
    ray_tpu_torch.kill(actors[victim_id])

    # drain every open stream: survivors complete, victim's streams fail
    completed, failed = 0, 0
    for s in streams:
        try:
            done_ev = None
            for ev in s["it"]:
                if "token" in ev:
                    s["tokens"].append(ev["token"])
                if ev.get("done"):
                    done_ev = ev
            assert done_ev is not None and done_ev["num_tokens"] == 120
            completed += 1
        except AssertionError:
            raise
        except Exception:  # noqa: BLE001 — the killed replica's streams
            failed += 1
    assert completed >= 1, "no stream survived the kill"
    assert failed >= 1, "the killed replica's streams vanished silently?"

    # new requests re-route to live replicas: the first attempt may race
    # the stale membership, but observing the death evicts the replica
    # from the router so retries converge immediately
    deadline = time.time() + 30
    out = None
    while time.time() < deadline:
        try:
            out = handle.remote({"prompt": [9], "max_tokens": 4}).result(timeout=60)
            break
        except Exception:  # noqa: BLE001 — raced the dead replica
            # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
            time.sleep(0.2)
    assert out is not None and out["num_tokens"] == 4, "re-route never converged"

    # the controller replaces the dead replica
    deadline = time.time() + 60
    while time.time() < deadline:
        reps = ray_tpu_torch.get(controller.get_replicas.remote("llm_chaos"))
        if len(reps) == 2 and all(r["replica_id"] != victim_id for r in reps):
            break
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.5)
    assert len(reps) == 2, f"dead replica never replaced: {reps}"

    # KV accounting on the survivor balances to zero
    survivor = actors[survivor_id]
    deadline = time.time() + 30
    while time.time() < deadline:
        st = ray_tpu_torch.get(survivor.stats.remote())
        if st.get("kv_blocks_in_use") == 0:
            break
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.3)
    assert st.get("kv_blocks_in_use") == 0, st.get("kv_leak_report")
    serve.delete("llm_chaos")


@pytest.mark.slow  # multi-replica storm with a kill: runs under `-m chaos`
@pytest.mark.chaos
def test_chaos_tenant_storm_with_replica_kill(serve_cluster):
    """A hostile tenant floods at many times its quota while a victim
    tenant streams interactively; one replica is killed mid-storm.  The
    victim's established streams all complete (retries absorb the kill),
    its TTFT stays bounded, every quota shed lands on the hostile tenant,
    and KV accounting on the survivors balances to zero."""
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    cfg = _tiny(
        name="llm_storm",
        max_batch_size=4,
        num_blocks=128,
        preempt_wait_s=0.1,
        temperature=0.0,
        tenant_weights={"hostile": 1.0, "victim": 1.0},
        tenant_quotas={
            "hostile": {"rate": 20, "burst": 40},
            "victim": {"rate": 1e6, "burst": 1e6},
        },
    )
    app = llm.build_app(cfg, num_replicas=2)
    serve.run(app, name="llm_storm_app", http_port=PROXY_PORT)
    _wait_route("/llm_storm")
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")

    stop = threading.Event()
    hostile = {"sent": 0, "ok": 0, "throttled": 0, "other": 0}

    def hostile_flood():
        while not stop.is_set():
            hostile["sent"] += 1
            try:
                status, _, _ = _post(
                    "/llm_storm", {"prompt": "h" * 16, "max_tokens": 16},
                    headers={"x-serve-tenant": "hostile",
                             "x-serve-slo": "batch"},
                    timeout=30,
                )
                if status == 200:
                    hostile["ok"] += 1
                elif status == 429:
                    hostile["throttled"] += 1
                else:
                    hostile["other"] += 1
            except Exception:  # noqa: BLE001 — the kill may drop one
                hostile["other"] += 1

    def victim_stream_once():
        """One interactive victim stream; returns its TTFT (s)."""
        req = urllib.request.Request(
            f"http://127.0.0.1:{PROXY_PORT}/llm_storm",
            data=json.dumps({"prompt": "v", "max_tokens": 8}).encode(),
            headers={"Content-Type": "application/json",
                     "x-serve-stream": "1",
                     "x-serve-tenant": "victim",
                     "x-serve-slo": "interactive"},
        )
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=60) as resp:
            first = resp.readline()  # established: first token event
            ttft = time.time() - t0
            assert first
            body = resp.read().decode()
        events = [json.loads(l) for l in body.splitlines() if l]
        assert events and events[-1].get("done"), events
        return ttft

    floods = [threading.Thread(target=hostile_flood, daemon=True)
              for _ in range(3)]
    for t in floods:
        t.start()

    ttfts, raw_failures, completed = [], 0, 0
    killed = False
    try:
        for i in range(10):
            for attempt in range(4):
                try:
                    ttfts.append(victim_stream_once())
                    completed += 1
                    break
                except Exception:  # noqa: BLE001 — kill races a stream
                    raw_failures += 1
                    # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
                    time.sleep(0.5)
            else:
                raise AssertionError(
                    f"victim stream {i} failed every retry "
                    f"(raw_failures={raw_failures})"
                )
            if completed == 3 and not killed:
                reps = ray_tpu_torch.get(controller.get_replicas.remote("llm_storm"))
                victim_rep = reps[0]
                ray_tpu_torch.kill(
                    ray_tpu_torch.get_actor(victim_rep["actor_name"], "serve")
                )
                killed = True
    finally:
        stop.set()
        for t in floods:
            t.join(timeout=30)

    assert killed, "the drill never killed a replica"
    assert completed == 10, "a victim stream was permanently lost"
    # TTFT bound: generous for the 1-core CI box, but it proves the
    # hostile flood and the kill never starved the interactive class
    ttfts.sort()
    p99 = ttfts[max(0, int(len(ttfts) * 0.99) - 1)]
    assert p99 < 30.0, f"victim TTFT blew out under storm: {ttfts}"
    assert hostile["throttled"] >= 5, hostile
    assert hostile["sent"] >= 3 * hostile["ok"], (
        f"flood too weak to prove throttling: {hostile}"
    )
    # shed attribution: quota sheds are the hostile tenant's alone
    with urllib.request.urlopen(
        f"http://127.0.0.1:{PROXY_PORT}/-/stats", timeout=10
    ) as r:
        stats = json.loads(r.read())
    per_tenant = stats.get("shed_tenant", {}).get("llm_storm", {})
    assert per_tenant.get("hostile", 0) >= 5, stats
    assert "victim" not in per_tenant, stats
    # the dead replica is replaced and KV balances to zero everywhere
    deadline = time.time() + 60
    reps = []
    while time.time() < deadline:
        reps = ray_tpu_torch.get(controller.get_replicas.remote("llm_storm"))
        if len(reps) == 2:
            break
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.5)
    assert len(reps) == 2, f"replica never replaced: {reps}"
    deadline = time.time() + 30
    leaks = None
    while time.time() < deadline:
        leaks = {}
        for rep in reps:
            try:
                st = ray_tpu_torch.get(
                    ray_tpu_torch.get_actor(rep["actor_name"], "serve").stats.remote()
                )
                leaks[rep["replica_id"]] = st.get("kv_blocks_in_use", -1)
            except Exception:  # noqa: BLE001 — replica still starting
                leaks[rep["replica_id"]] = -1
        if all(v == 0 for v in leaks.values()):
            break
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.5)
    assert all(v == 0 for v in leaks.values()), f"KV leak after storm: {leaks}"
    serve.delete("llm_storm")


# ----------------------------------------------------------------------
# chaos drill: SIGKILL mid-preemption (own cluster, so it runs last)
# ----------------------------------------------------------------------
@pytest.mark.chaos
def test_chaos_sigkill_mid_preemption_zero_leak():
    """A seeded SIGKILL lands exactly in the preemption window — after
    the victim's KV pages are freed, before the requeue.  The replica
    dies mid-preemption; the controller must replace it, the replacement
    must serve with ZERO leaked KV blocks, and the plane must not wedge."""
    env = dict(_CLUSTER_ENV,
               RAY_TPU_TORCH_testing_chaos_spec="@serve.preempt.evict:kill:at=1",
               RAY_TPU_TORCH_testing_chaos_seed="7")
    saved = {k: os.environ.get(k) for k in env}
    for fn in (serve.shutdown, ray_tpu_torch.shutdown):
        try:
            fn()
        except Exception:  # noqa: BLE001
            pass
    os.environ.update(env)
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()
    try:
        ray_tpu_torch.init(num_cpus=4)
        from ray_tpu_torch.serve import llm
        from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

        cfg = _tiny(name="llm_psig", max_batch_size=1, preempt_wait_s=0.05,
                    temperature=0.0,
                    tenant_weights={"a": 1.0, "b": 1.0})
        handle = serve.run(llm.build_app(cfg), name="llm_psig_app")
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
        reps0 = ray_tpu_torch.get(controller.get_replicas.remote("llm_psig"))
        assert len(reps0) == 1
        rid0 = reps0[0]["replica_id"]

        # occupy the single lane with a long batch-class stream
        gen = handle.options(stream=True, tenant="a", slo_class="batch")\
            .generate.remote({"prompt": [1, 2, 3], "max_tokens": 400})
        it = iter(gen)
        next(it)  # established

        # an interactive arrival forces the preemption whose evict-side
        # chaos point kills the replica (os._exit between free + requeue)
        def poke():
            try:
                handle.options(tenant="b", slo_class="interactive").remote(
                    {"prompt": [5], "max_tokens": 3}
                ).result(timeout=20)
            except Exception:  # noqa: BLE001 — died with the replica
                pass

        threading.Thread(target=poke, daemon=True).start()

        # the kill fired iff the replica id changes
        reps = []
        for _ in _poll(90):
            reps = ray_tpu_torch.get(controller.get_replicas.remote("llm_psig"))
            if len(reps) == 1 and reps[0]["replica_id"] != rid0:
                break
        assert reps and reps[0]["replica_id"] != rid0, (
            "chaos kill at serve.preempt.evict never fired (no preemption?)"
        )
        # the orphaned stream dies with its replica, never wedges
        try:
            for _ in it:
                pass
        except Exception:  # noqa: BLE001 — expected: replica death
            pass

        # the replacement serves immediately and its KV pool is clean
        out = None
        for _ in _poll(60):
            try:
                out = handle.options(tenant="b", slo_class="interactive")\
                    .remote({"prompt": [9], "max_tokens": 4}).result(timeout=30)
                break
            except Exception:  # noqa: BLE001 — raced the dead membership
                pass
        assert out is not None and out["num_tokens"] == 4, (
            "replacement replica never served"
        )
        st = None
        for _ in _poll(30):
            st = handle.stats.remote().result(timeout=30)
            if st["kv_blocks_in_use"] == 0 and st["waiting"] == 0:
                break
        assert st["kv_blocks_in_use"] == 0, st["kv_leak_report"]
        rep = st["kv_leak_report"]
        assert rep["total_allocs"] == rep["total_frees"], rep
        serve.delete("llm_psig")
    finally:
        for fn in (serve.shutdown, ray_tpu_torch.shutdown):
            try:
                fn()
            except Exception:  # noqa: BLE001
                pass
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        CHAOS.reset()
