"""The port's LLM engine (ray_tpu_torch/serve/llm) on the CPU: the
engine-level cases of tests/test_serve_llm.py, ported (block-manager
accounting, greedy against the full forward, no leak after mixed
requests, join at a step boundary, cancel frees blocks, shed past the
queue bound, KV-pool admission), plus one cross-framework case: the JAX
engine and the port's engine, serving the same weights, stream identical
greedy tokens."""

import asyncio
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.serve.exceptions import RequestShedError
from ray_tpu_torch.serve.llm import BlockManager, LLMConfig, LLMEngine
from ray_tpu_torch.serve.llm.engine import FINISHED
from ray_tpu_torch.serve.llm.kv_cache import NoFreeBlocksError

torch.set_num_threads(2)


def _tiny(**kw) -> LLMConfig:
    base = dict(model="tiny", max_batch_size=4, num_blocks=64, block_size=8,
                default_max_tokens=8, device="cpu")
    base.update(kw)
    return LLMConfig(**base)


async def _drain(req, finished=FINISHED):
    toks = []
    while True:
        ev = await req.out.get()
        if ev is finished:
            return toks
        toks.append(ev["token"])


# ----------------------------------------------------------------------
# block manager: pure accounting
# ----------------------------------------------------------------------
def test_block_manager_accounting():
    bm = BlockManager(num_blocks=8, block_size=4)
    assert bm.free_blocks == 7  # block 0 reserved
    bm.allocate("a", 10)  # 3 blocks
    bm.allocate("b", 4)  # 1 block
    assert bm.blocks_in_use == 4
    bm.advance("a", 10)
    assert all(bm.phys_index("a", p) >= bm.block_size for p in range(10))
    with pytest.raises(NoFreeBlocksError):
        bm.advance("a", 3)
    with pytest.raises(NoFreeBlocksError):
        bm.allocate("c", 100)
    assert bm.free("a") == 3
    assert bm.free("a") == 0  # idempotent
    bm.free("b")
    assert bm.blocks_in_use == 0
    assert bm.leak_report()["total_allocs"] == bm.leak_report()["total_frees"]


def test_block_manager_phys_indices_padding():
    bm = BlockManager(num_blocks=8, block_size=4)
    bm.allocate("s", 6)
    bm.advance("s", 6)
    idx = bm.phys_indices("s", 6, 12)
    assert list(idx[6:]) == [0] * 6  # padded with the scratch slot
    assert idx[1] == idx[0] + 1


# ----------------------------------------------------------------------
# engine: generation, parity, continuous batching, cancel, shed
# ----------------------------------------------------------------------
def test_engine_greedy_matches_full_forward():
    """The paged prefill/decode path must produce the SAME greedy tokens
    as re-running the full model over the growing sequence."""

    async def main():
        eng = LLMEngine(_tiny(temperature=0.0))
        req = await eng.add_request([3, 1, 4, 1, 5], max_tokens=6)
        toks = await _drain(req)
        await eng.stop()
        return eng, toks

    eng, toks = asyncio.run(main())
    oracle = tgpt2.generate_greedy(eng.model, torch.tensor([[3, 1, 4, 1, 5]]), 6)
    assert toks == oracle[0].tolist(), (toks, oracle)


def test_engine_no_leak_after_mixed_requests():
    async def main():
        eng = LLMEngine(_tiny())
        reqs = [
            await eng.add_request([1 + i, 2, 3], max_tokens=3 + (i % 5))
            for i in range(12)
        ]
        outs = await asyncio.gather(*[_drain(r) for r in reqs])
        for r, out in zip(reqs, outs):
            assert len(out) == r.max_tokens
            assert r.finish_reason == "length"
        report = eng.bm.leak_report()
        await eng.stop()
        return report

    report = asyncio.run(main())
    assert report["blocks_in_use"] == 0
    assert report["live_sequences"] == 0
    assert report["total_allocs"] == 12
    assert report["total_frees"] == 12


def test_engine_continuous_batch_join_at_step_boundary():
    """A late request must join the RUNNING batch at a step boundary and
    decode concurrently — not wait for the batch to drain."""

    async def main():
        eng = LLMEngine(_tiny(max_batch_size=2))
        long_req = await eng.add_request([1, 2], max_tokens=60)
        while long_req.generated < 5:
            await asyncio.sleep(0.01)
        late = await eng.add_request([3, 4], max_tokens=5)
        await asyncio.gather(_drain(long_req), _drain(late))
        report = eng.bm.leak_report()
        await eng.stop()
        return long_req, late, report

    long_req, late, report = asyncio.run(main())
    assert late.join_step < long_req.finish_step, (
        f"late joined at step {late.join_step}, long finished at "
        f"{long_req.finish_step} — no in-flight join happened"
    )
    assert late.finish_step <= long_req.finish_step
    assert report["blocks_in_use"] == 0


def test_engine_cancel_frees_blocks():
    async def main():
        eng = LLMEngine(_tiny(max_batch_size=1))
        a = await eng.add_request([1], max_tokens=100)
        b = await eng.add_request([2], max_tokens=100)
        while a.generated < 1:
            await asyncio.sleep(0.01)
        assert b.slot < 0  # still waiting behind a
        eng.cancel(b.request_id)
        assert await b.out.get() is FINISHED
        assert b.finish_reason == "cancelled"
        while a.generated < 3:
            await asyncio.sleep(0.01)
        eng.cancel(a.request_id)
        await _drain(a)
        deadline = time.monotonic() + 5
        while eng.bm.blocks_in_use and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        report = eng.bm.leak_report()
        await eng.stop()
        return report

    report = asyncio.run(main())
    assert report["blocks_in_use"] == 0
    assert report["live_sequences"] == 0


def test_engine_sheds_past_queue_bound():
    async def main():
        eng = LLMEngine(_tiny(max_batch_size=1, max_queue=2))
        first = await eng.add_request([0], max_tokens=100)
        while first.generated < 1:  # occupies the single lane
            await asyncio.sleep(0.01)
        held = [first] + [await eng.add_request([i], max_tokens=100) for i in (1, 2)]
        with pytest.raises(RequestShedError):
            await eng.add_request([9], max_tokens=4)
        for r in held:
            eng.cancel(r.request_id)
        for r in held:
            await _drain(r)
        stats = eng.stats()
        await eng.stop()
        return stats, eng.bm.leak_report()

    stats, report = asyncio.run(main())
    assert stats["shed_total"] == 1
    assert report["blocks_in_use"] == 0


def test_engine_kv_pool_admission_blocks_then_completes():
    """When the pool can't hold another sequence the head-of-line waits
    (no overtaking) and is admitted once completions free blocks."""

    async def main():
        # 15 usable blocks * 4 = 60 slots; each request needs 2 + 30
        # tokens -> 8 blocks, so only one fits at a time
        eng = LLMEngine(LLMConfig(model="tiny", max_batch_size=4, num_blocks=16,
                                  block_size=4, max_model_len=32, device="cpu"))
        a = await eng.add_request([1, 2], max_tokens=30)
        b = await eng.add_request([3, 4], max_tokens=30)
        while a.generated < 2:
            await asyncio.sleep(0.01)
        assert b.slot < 0  # parked on KV capacity, not a free lane
        out_a, out_b = await asyncio.gather(_drain(a), _drain(b))
        assert len(out_a) == 30 and len(out_b) == 30
        report = eng.bm.leak_report()
        await eng.stop()
        return report

    report = asyncio.run(main())
    assert report["blocks_in_use"] == 0


def test_engine_rejects_out_of_vocabulary_prompt():
    """An id past the embedding table would fault the device; the port
    refuses it at admission (the reference's gather clamps it silently)."""

    async def main():
        eng = LLMEngine(_tiny())
        with pytest.raises(ValueError):
            await eng.add_request([1, eng.model_cfg.vocab_size], max_tokens=2)
        await eng.stop()
        return eng.bm.leak_report()

    assert asyncio.run(main())["blocks_in_use"] == 0


def test_engine_serves_a_given_model_and_checks_its_config():
    cfg = _tiny()
    model = tgpt2.init_model(cfg.model_config(), torch.Generator().manual_seed(7), "cpu")
    eng = LLMEngine(cfg, model=model)
    assert eng.model is model
    with pytest.raises(ValueError):
        LLMEngine(_tiny(dtype="bfloat16"), model=model)


# ----------------------------------------------------------------------
# cross-framework: the JAX engine and the port's stream the same tokens
# ----------------------------------------------------------------------
def test_engine_streams_match_jax_engine():
    """Same weights (the JAX engine's seed-0 params, carried across by
    convert.py), same prompts over several prefill buckets (8, 16, 64,
    128), two decode lanes so requests join mid-run: identical greedy
    streams.  Float32 on the CPU."""
    jax = pytest.importorskip("jax")
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.serve.llm import LLMConfig as JLLMConfig
    from ray_tpu.serve.llm import LLMEngine as JLLMEngine
    from ray_tpu.serve.llm.engine import FINISHED as JFINISHED
    from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (5, 13, 40, 100)]
    max_tokens = [10, 7, 12, 9]
    base = dict(model="tiny", max_batch_size=2, num_blocks=64, block_size=8,
                temperature=0.0)

    async def serve(eng, finished):
        reqs = [await eng.add_request(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
        outs = await asyncio.gather(*[_drain(r, finished) for r in reqs])
        await eng.stop()
        return outs

    jeng = JLLMEngine(JLLMConfig(**base))
    want = asyncio.run(serve(jeng, JFINISHED))

    tree = jax.tree_util.tree_map(np.asarray, jgpt2.init_params(
        jeng.model_cfg, rng=jax.random.PRNGKey(jeng.config.seed)))
    cfg = LLMConfig(device="cpu", **base)
    model = tgpt2.GPT2(cfg.model_config())
    model.load_state_dict(gpt2_state_dict_from_jax(tree, cfg.model_config()))
    teng = LLMEngine(cfg, model=model)
    got = asyncio.run(serve(teng, FINISHED))
    assert [len(o) for o in got] == max_tokens
    assert got == want
    assert teng.bm.leak_report()["blocks_in_use"] == 0


# ----------------------------------------------------------------------
# @serve.batch fixes: running-loop binding + shutdown cancel (copies of the
# reference's)
# ----------------------------------------------------------------------
def test_batch_queue_binds_running_loop():
    """The batch worker must bind the loop the first call RUNS on — a
    non-default loop here (the old get_event_loop() bound the thread
    default and the worker never woke)."""

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
    async def doubler(items):
        return [i * 2 for i in items]

    loop = asyncio.new_event_loop()  # NOT the thread's default loop
    try:
        out = loop.run_until_complete(asyncio.wait_for(doubler(21), timeout=5))
        for q in doubler._serve_batch_queues.values():
            q.shutdown()
        loop.run_until_complete(asyncio.sleep(0))  # let cancellation land
    finally:
        loop.close()
    assert out == 42


def test_replica_prepare_shutdown_cancels_batch_worker():
    from ray_tpu_torch.serve._private.replica import Replica

    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
        async def handle(self, items):
            return [i + 1 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

    async def main():
        rep = Replica("r1", "dep", (Batched, (), {}), None, 10)
        out = await rep.handle_request("__call__", (1,), {})
        assert out == 2
        queues = rep.callable.handle._serve_batch_queues
        workers = [q._worker for q in queues.values() if q._worker is not None]
        assert workers and not any(w.done() for w in workers)
        await rep.prepare_shutdown()
        await asyncio.sleep(0)  # let cancellation propagate
        return workers

    workers = asyncio.run(main())
    assert all(w.done() for w in workers), "batch worker task leaked past shutdown"
