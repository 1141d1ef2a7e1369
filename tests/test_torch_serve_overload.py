"""The port's overload armor (ray_tpu_torch/serve/llm/overload.py and
the engine's fair queue, preemption and brownout) on the CPU: the
engine-level and pure-math cases of tests/test_serve_overload.py,
ported.  Preempt-by-recompute must stay token-exact against an
uninterrupted greedy run, and every storm must balance the KV pool."""

import asyncio
import time

import pytest
import torch

from ray_tpu_torch.serve.exceptions import RequestShedError
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
from ray_tpu_torch.serve.llm.engine import FINISHED
from ray_tpu_torch.serve.llm.overload import DegradationController, normalize_slo

torch.set_num_threads(2)


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
