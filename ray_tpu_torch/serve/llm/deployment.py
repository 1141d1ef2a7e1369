"""Serve deployments over the LLM engine.

``LLMServer`` is the continuous-batching deployment: ``generate`` is an
async generator (one stream item per token, via the replica's
``handle_request_stream``), ``__call__`` is the one-shot completion
path.  ``StaticBatchLLMServer`` is the request-level ``@serve.batch``
baseline the bench compares against: a whole batch decodes in lockstep
until its LAST member finishes, so mixed-length traffic pays the
drain barrier continuous batching removes.

Port of ``ray_tpu/serve/llm/deployment.py``.  The static step is plain
torch on ``models/gpt2.py``'s ``prefill_forward`` / ``decode_forward``
with the dense cache written by index (the reference's is a ``jnp`` step
under ``jax.jit``; there is no jit here, so no ``instrument_jit``).  The
module imports no torch and no engine at module level: the serve
controller unpickles ``LLMServer`` and its config and must not load torch.
"""

from __future__ import annotations

import asyncio
import dataclasses
import uuid
import zlib
from typing import Any, AsyncIterator, Dict, List, Optional

from ray_tpu_torch.serve.llm.config import LLMConfig
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

# transport-level key: when a streaming proxy asks for disconnect-cancel
# support (payload hint "__serve_stream_cancel__"), the first stream item
# is a meta dict under this key (consumed by the proxy, never forwarded)
STREAM_META_KEY = "__serve_stream_meta__"


def _parse(payload: Any) -> Dict[str, Any]:
    if isinstance(payload, dict):
        return payload
    if isinstance(payload, str):
        return {"prompt": payload}
    if isinstance(payload, (list, tuple)):
        return {"prompt": list(payload)}
    raise TypeError(f"LLM payload must be dict/str/list, got {type(payload)}")


class _EngineVariant:
    """One multiplexed model variant: a full engine whose weights derive
    from the variant id (seed offset — a stand-in for per-variant
    checkpoint loading, docs/serving.md).  Metrics keep the deployment
    name, so variants never mint label cardinality."""

    def __init__(self, owner: "LLMServer", config: LLMConfig, model_id: str):
        from ray_tpu_torch.serve.llm.engine import LLMEngine

        self._owner = owner
        self.model_id = model_id
        self.engine = LLMEngine(config)

    def __serve_unload__(self):
        """LRU eviction hook (called by the multiplex cache): count it
        and stop the variant's engine so its KV pool and step loop go
        with it."""
        self._owner._mx_evictions += 1
        try:
            from ray_tpu_torch._private import telemetry

            telemetry.count_serve_multiplex_eviction(self.engine.config.name)
        except Exception:  # noqa: BLE001
            pass
        try:
            asyncio.get_event_loop().create_task(self.engine.stop())
        except RuntimeError:
            pass


class LLMServer:
    """The continuous-batching LLM deployment (one engine per replica;
    per-request ``model_id`` selects a multiplexed variant engine with
    LRU swap)."""

    MAX_MODELS_PER_REPLICA = 2

    def __init__(self, llm_config: Optional[Any] = None):
        from ray_tpu_torch.serve.llm.engine import LLMEngine

        self.config = LLMConfig.coerce(llm_config)
        self.engine = LLMEngine(self.config)
        self._mx_evictions = 0

    # -- multiplexed variants --------------------------------------------
    @multiplexed(max_num_models_per_replica=MAX_MODELS_PER_REPLICA)
    async def _load_variant(self, model_id: str) -> _EngineVariant:
        # deterministic per-variant weights: stable hash of the id folds
        # into the seed (same variant -> same weights on every replica)
        seed_off = 1 + zlib.crc32(model_id.encode("utf-8")) % 997
        cfg = dataclasses.replace(self.config, seed=self.config.seed + seed_off)
        return _EngineVariant(self, cfg, model_id)

    def _loaded_variants(self) -> List[_EngineVariant]:
        cache = getattr(self, self._load_variant._cache_attr, None)
        return list(cache._models.values()) if cache is not None else []

    async def _engine_for(self, spec: Dict[str, Any]):
        """The engine serving this request: the payload's ``model_id``
        (or the handle's multiplexed_model_id) selects a variant; empty
        means the base engine."""
        model_id = spec.get("model_id") or get_multiplexed_model_id()
        if not model_id:
            return self.engine
        variant = await self._load_variant(model_id)
        return variant.engine

    def _identity(self, spec: Dict[str, Any]) -> tuple:
        """(tenant, slo) for this request: explicit payload fields win,
        else the wire-threaded request context set by the replica."""
        from ray_tpu_torch.serve._private.request_context import get_request_meta

        meta = get_request_meta() or {}
        tenant = spec.get("tenant") or meta.get("tenant")
        slo = spec.get("slo") or spec.get("slo_class") or meta.get("slo")
        return tenant, slo

    # -- request paths ---------------------------------------------------
    async def generate(self, payload: Any) -> AsyncIterator[dict]:
        """Streaming completion: yields one event per token, then a final
        summary event.  The ``finally`` cancels the engine request when
        the stream is torn down early (disconnect/cancel) so KV blocks
        never leak."""
        from ray_tpu_torch.serve.llm.engine import FINISHED

        spec = _parse(payload)
        engine = await self._engine_for(spec)
        tenant, slo = self._identity(spec)
        req = await engine.add_request(
            spec.get("prompt", ""),
            max_tokens=spec.get("max_tokens"),
            temperature=spec.get("temperature"),
            request_id=spec.get("request_id"),
            tenant=tenant,
            slo=slo,
        )
        if spec.get("__serve_stream_cancel__"):
            yield {STREAM_META_KEY: {"request_id": req.request_id,
                                     "cancel_method": "cancel"}}
        try:
            while True:
                ev = await req.out.get()
                if ev is FINISHED:
                    break
                yield ev
            yield {
                "request_id": req.request_id,
                "finish_reason": req.finish_reason,
                "num_tokens": req.generated,
                "done": True,
            }
        finally:
            engine.cancel(req.request_id)

    async def __call__(self, payload: Any):
        """One-shot completion (same engine, same batcher — just drained
        server-side instead of streamed).  HTTP token streaming lands
        here too: the proxy's chunked path calls ``__call__`` with the
        ``__serve_stream_cancel__`` hint (or the client passes
        ``stream: true``), and returning the ``generate`` async
        generator streams one chunk per token."""
        spec = _parse(payload)
        if isinstance(payload, dict) and (
            spec.get("stream") or spec.get("__serve_stream_cancel__")
        ):
            return self.generate(payload)
        from ray_tpu_torch.serve.llm.engine import FINISHED

        engine = await self._engine_for(spec)
        tenant, slo = self._identity(spec)
        req = await engine.add_request(
            spec.get("prompt", ""),
            max_tokens=spec.get("max_tokens"),
            temperature=spec.get("temperature"),
            request_id=spec.get("request_id"),
            tenant=tenant,
            slo=slo,
        )
        try:
            while True:
                ev = await req.out.get()
                if ev is FINISHED:
                    break
            return {
                "request_id": req.request_id,
                "tokens": list(req.tokens),
                "num_tokens": req.generated,
                "finish_reason": req.finish_reason,
            }
        finally:
            engine.cancel(req.request_id)

    # -- control surface -------------------------------------------------
    def cancel(self, request_id: str) -> bool:
        """Cancel wherever the request lives: the base engine or any
        loaded variant (disconnect-cancel doesn't know which engine
        admitted the id)."""
        if self.engine.cancel(request_id):
            return True
        for v in self._loaded_variants():
            if v.engine.cancel(request_id):
                return True
        return False

    def stats(self) -> Dict[str, Any]:
        out = self.engine.stats()
        out["multiplex"] = {
            "loaded_model_ids": [v.model_id for v in self._loaded_variants()],
            "evictions": self._mx_evictions,
        }
        return out

    def __serve_stats__(self) -> Dict[str, Any]:
        """Replica stats hook: the controller's autoscaler reads
        ``queued`` as this replica's queue depth."""
        queued = self.engine.queued_depth() + sum(
            v.engine.queued_depth() for v in self._loaded_variants()
        )
        return {"queued": queued, **self.stats()}

    async def __serve_shutdown__(self):
        """Replica prepare_shutdown hook: stop the step loops and drain
        (frees every KV block, finishes every open stream)."""
        await self.engine.stop()
        for v in self._loaded_variants():
            await v.engine.stop()


class StaticBatchLLMServer:
    """Request-level batching baseline: ``@serve.batch`` coalesces
    requests, then the whole batch generates to completion with a dense
    per-batch KV cache — no in-flight joins, no early exit for short
    members.  Kept as the bench's comparison point and as the simplest
    correct serving path."""

    def __init__(self, llm_config: Optional[Any] = None,
                 batch_wait_timeout_s: float = 0.05):
        import functools

        from ray_tpu_torch.serve.batching import batch

        self.config = LLMConfig.coerce(llm_config)
        self.model_cfg = self.config.model_config()
        self._build()
        # bind the batch queue at the configured size at init time
        self._batched = batch(
            max_batch_size=self.config.max_batch_size,
            batch_wait_timeout_s=batch_wait_timeout_s,
        )(functools.partial(StaticBatchLLMServer._generate_batch, self))

    def _build(self):
        import torch

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models import gpt2

        self.device = resolve_device(self.config.device)
        # the engine's weight draw: the same seed gives the same weights
        gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.model = gpt2.init_model(self.model_cfg, gen, self.device).eval()
        self._gpt2 = gpt2
        self._torch = torch

    def _step(self, cur, lens, k_full, v_full, mask):
        """One lockstep decode step over the dense cache, written by
        index in place (the reference donates it to its jitted step)."""
        logits, k_new, v_new = self._gpt2.decode_forward(
            self.model, cur, lens, k_full, v_full, mask
        )
        rows = self._torch.arange(cur.shape[0], device=cur.device)
        k_full[:, rows, lens] = k_new
        v_full[:, rows, lens] = v_new
        mask[rows, lens] = True
        return logits.argmax(dim=-1)

    async def _generate_batch(self, payloads: List[Any]) -> List[Dict[str, Any]]:
        loop = asyncio.get_running_loop()
        specs = [_parse(p) for p in payloads]
        return await loop.run_in_executor(None, self._run_batch, specs)

    def _run_batch(self, specs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        import numpy as np

        from ray_tpu_torch.serve.llm.config import tokenize_prompt

        torch = self._torch
        cfg = self.model_cfg
        gpt2 = self._gpt2
        # inference mode is thread-local: entered here, in the executor thread
        with torch.inference_mode():
            prompts = []
            maxts = []
            for s in specs:
                toks = tokenize_prompt(s.get("prompt", ""), cfg.vocab_size)
                prompts.append(toks[: cfg.max_seq_len - 1])
                mt = int(s.get("max_tokens") or self.config.default_max_tokens)
                maxts.append(max(1, min(mt, cfg.max_seq_len - len(toks))))
            B = len(prompts)
            T = max(len(p) for p in prompts)
            toks = np.zeros((B, T), dtype=np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
            last_idx = np.array([len(p) - 1 for p in prompts], dtype=np.int64)
            logits, k, v = gpt2.prefill_forward(
                self.model, torch.from_numpy(toks).to(self.device),
                last_index=torch.from_numpy(last_idx).to(self.device),
            )
            # dense cache [L, B, Ctot, H, Dh]; the batch runs until its LAST
            # member reaches max_tokens (the drain barrier)
            steps = max(maxts)
            outs: List[List[int]] = [[] for _ in range(B)]
            cur = logits.argmax(dim=-1)
            lens = torch.tensor([len(p) for p in prompts], dtype=torch.long,
                                device=self.device)
            # bucket the cache width as the reference does (there it bounds
            # the jit's compilations)
            ctot = T + steps
            bucket = 16
            while bucket < ctot:
                bucket *= 2
            # NOT clamped to max_seq_len: every individual sequence fits its
            # own T_i + maxts_i <= max_seq_len, but finished lanes keep
            # decoding (lockstep) and their positions may run past it —
            # garbage confined to their own rows (decode_forward clamps the
            # position lookup, as the reference's gather does)
            Ctot = bucket
            L, _, _, H, Dh = k.shape
            k_full = torch.zeros((L, B, Ctot, H, Dh), dtype=cfg.dtype, device=self.device)
            v_full = torch.zeros((L, B, Ctot, H, Dh), dtype=cfg.dtype, device=self.device)
            k_full[:, :, :T] = k
            v_full[:, :, :T] = v
            mask = np.zeros((B, Ctot), dtype=bool)
            for i, p in enumerate(prompts):
                mask[i, :len(p)] = True
            mask = torch.from_numpy(mask).to(self.device)
            host = cur.cpu().numpy()
            for i in range(B):
                outs[i].append(int(host[i]))
            for _step in range(steps - 1):
                cur = self._step(cur, lens, k_full, v_full, mask)
                lens = lens + 1
                host = cur.cpu().numpy()
                for i in range(B):
                    if len(outs[i]) < maxts[i]:
                        outs[i].append(int(host[i]))
            return [
                {"tokens": outs[i], "num_tokens": len(outs[i]), "finish_reason": "length"}
                for i in range(B)
            ]

    async def __call__(self, payload: Any) -> Dict[str, Any]:
        return await self._batched(payload)


def build_app(
    llm_config: Optional[Any] = None,
    *,
    num_replicas: int = 1,
    max_ongoing_requests: int = 2048,
    max_queued_requests: int = -1,
    autoscaling_config: Optional[dict] = None,
    route_prefix: Optional[str] = None,
):
    """An Application serving ``LLMServer`` with serving-appropriate
    deployment defaults (streams hold a slot for their whole life, so
    ``max_ongoing_requests`` is high; admission control lives in the
    engine's ``max_queue`` and the proxy's ``max_queued_requests``).
    The LLM config's ``tenant_quotas`` flow onto the deployment so the
    route table carries them to the proxy's token-bucket admission.

    A replica whose engine serves on a CUDA device leases one ``GPU``, so
    the scheduler never places two engines on one card; a CPU engine
    leases none (the reference's replicas take the TPU unleased).
    ``app.deployment.options(ray_actor_options=...)`` changes it."""
    from ray_tpu_torch import serve

    cfg = LLMConfig.coerce(llm_config)
    dep = serve.deployment(
        name=cfg.name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        max_queued_requests=max_queued_requests,
        autoscaling_config=autoscaling_config,
        route_prefix=route_prefix,
        ray_actor_options={"num_gpus": 1} if cfg.device.startswith("cuda") else {},
        tenant_quotas=cfg.tenant_quotas,
    )(LLMServer)
    return dep.bind(cfg.to_dict())
