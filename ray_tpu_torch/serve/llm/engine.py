"""Token-granular LLM engine with continuous in-flight batching (port of
``ray_tpu/serve/llm/engine.py``; reference: vLLM LLMEngine / Ray Serve
llm deployment).

Execution model: one asyncio loop task per engine ("the step loop").
Each iteration is a **step boundary**:

1. cancelled sequences leave the batch and free their KV blocks;
2. waiting requests join free decode lanes (admission reserved their
   whole KV need up front, so a joined request can never die of pool
   exhaustion) — each join runs a bucketed prefill that writes the
   prompt's K/V straight into its pages and samples the first token
   (TTFT is measured here);
3. one decode step advances EVERY active lane a token:
   gather pages -> decode_forward -> write new K/V -> sample.

Tokens stream to per-request asyncio queues.  The model steps run in the
default executor, under ``torch.inference_mode()`` inside that thread
(inference mode is thread-local), so the event loop (joins, stream
consumption, stats) stays responsive during a step.  On the card, prefill
attention runs the hand-written flash kernel (``ops/flash_attention.py``).

Overload armor: requests carry tenant + SLO-class identity.  The waiting
queue is a weighted fair queue over KV blocks and decode lanes (DRF) with
an intra-tenant order of priority-then-FIFO; a starved higher-priority
request preempts the cheapest lower-priority decode lane by recompute (KV
pages freed, generated-so-far folded into the prompt; the resume is
token-exact under greedy sampling); and a brownout ladder driven by
observed TTFT/queue depth degrades batch before standard and never sheds
interactive.  All of it is inert for anonymous traffic: identity-free
requests take the FIFO fast path.

Request spans (``serve.request`` -> ``serve.queue`` / ``serve.prefill``
/ ``serve.decode``) are recorded per request, and the 1 Hz control tick
exports the telemetry gauges and shed counters.  The reference's jit
profiling (``instrument_jit``) has no counterpart: torch runs eagerly.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import tenants as tenants_mod
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.serve.exceptions import RequestShedError
from ray_tpu_torch.serve.llm.config import LLMConfig, tokenize_prompt
from ray_tpu_torch.serve.llm.kv_cache import BlockManager
from ray_tpu_torch.serve.llm.overload import (
    DegradationController,
    SLO_PRIORITY,
    normalize_slo,
)

logger = logging.getLogger(__name__)

# end-of-stream sentinel pushed onto a request's output queue
FINISHED = object()


@dataclass
class _Request:
    request_id: str
    prompt: List[int]
    max_tokens: int
    temperature: float
    out: "asyncio.Queue"
    t_submit: float
    slot: int = -1
    generated: int = 0
    finish_reason: str = ""
    cancelled: bool = False
    t_join: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    join_step: int = -1
    finish_step: int = -1
    tokens: List[int] = field(default_factory=list)
    # overload identity + preemption state
    tenant: str = tenants_mod.DEFAULT_TENANT
    slo: str = "standard"
    priority: int = 1
    seq: int = 0  # admission order — the intra-tenant FIFO tiebreak
    preemptions: int = 0
    folded: int = 0  # tokens already folded into prompt by past preemptions
    t_enqueue: float = 0.0  # last (re)queue time — the starvation clock
    # span plumbing: (trace_id, root_span_id, parent_span_id or None)
    trace: tuple = ()


class LLMEngine:
    """One engine per replica; owns the model, the paged KV cache, and the
    continuous-batching step loop.

    ``model``: a ``GPT2`` to serve (e.g. weights carried across from the
    reference by ``models/convert.py``); it must have this config's model
    config and is moved to ``config.device``.  Without one, the engine
    builds synthetic weights from ``config.seed``."""

    def __init__(self, config: Optional[Any] = None, model: Optional[gpt2.GPT2] = None):
        self.config = LLMConfig.coerce(config)
        self.model_cfg = self.config.model_config()
        self.max_ctx = self.config.max_context
        self.bm = BlockManager(self.config.num_blocks, self.config.block_size)
        # usable pool excludes the reserved scratch block 0: a max-length
        # sequence must fit in the ALLOCATABLE blocks, or a max-size
        # request would pass admission bounds yet park forever
        if self.bm.blocks_needed(self.max_ctx) > self.config.num_blocks - 1:
            raise ValueError(
                "KV pool smaller than one max-length sequence: "
                f"{self.config.num_blocks - 1} usable blocks < "
                f"{self.bm.blocks_needed(self.max_ctx)} needed for "
                f"max_context {self.max_ctx}"
            )
        self._build_model(model)
        self.slots: List[Optional[_Request]] = [None] * self.config.max_batch_size
        self.waiting: Deque[_Request] = collections.deque()
        self._by_id: Dict[str, _Request] = {}
        self._loop_task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._stopped = False
        self.step_count = 0
        # (wall time, tokens emitted) per step, for the tokens/s gauge
        self._tok_window: Deque[tuple] = collections.deque(maxlen=512)
        self._total_tokens = 0
        self._shed_total = 0
        # shed attribution: {(where, tenant_label): n}, flushed at 1 Hz
        self._shed_unreported: Dict[tuple, int] = {}
        self._last_metrics_push = 0.0
        # -- overload armor state --
        self._seq_counter = 0
        # False -> every waiting request is anonymous default-tenant
        # standard-class traffic, so admission takes the FIFO fast path
        self._fair_dirty = False
        self._preempt_total = 0
        self._events: Deque[Dict[str, Any]] = collections.deque(maxlen=128)
        self._ttft_recent: Deque[float] = collections.deque(maxlen=64)
        # (wall time, tenant, tokens) for the per-tenant rate gauge
        self._tenant_tok_window: Deque[tuple] = collections.deque(maxlen=2048)
        self._registered_tenants = (
            set(self.config.tenant_quotas) | set(self.config.tenant_weights)
        )
        self._degrade = DegradationController(
            ttft_slo_s=self.config.slo_ttft_s,
            queue_high=(self.config.brownout_queue_high
                        or 4 * self.config.max_batch_size),
            down_ticks=self.config.brownout_down_ticks,
            up_ticks=self.config.brownout_up_ticks,
            batch_max_tokens=self.config.brownout_batch_max_tokens,
        )

    # -- model -----------------------------------------------------------
    def _build_model(self, model: Optional[gpt2.GPT2]):
        cfg = self.model_cfg
        self.device = resolve_device(self.config.device)
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
            model = gpt2.init_model(cfg, gen, self.device)
        elif model.cfg != cfg:
            raise ValueError(f"model config {model.cfg} != serving config {cfg}")
        self.model = model.to(self.device).eval()
        P = self.bm.num_slots
        shape = (cfg.n_layer, P, cfg.n_head, cfg.d_head)
        self.k_pages = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        # one sampling stream for the engine's life; steps run one at a time
        self._rng = torch.Generator(device=self.device).manual_seed(self.config.seed + 1)

    def _tensor(self, a: np.ndarray, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, dtype)

    def _prefill_step(self, toks, phys, last_idx, temp) -> int:
        # toks [1, Tpad]; phys [Tpad] (scratch slot 0 at pads); logits taken
        # at the last REAL position, not the pad tail.  K/V pages are
        # written in place (the reference donates them to the jitted step).
        with torch.inference_mode():
            logits, k, v = gpt2.prefill_forward(
                self.model, self._tensor(toks, torch.long),
                last_index=self._tensor(last_idx, torch.long),
            )
            phys_t = self._tensor(phys, torch.long)
            self.k_pages.index_copy_(1, phys_t, k[:, 0])
            self.v_pages.index_copy_(1, phys_t, v[:, 0])
            first = gpt2.sample_logits(logits, self._rng, self._tensor(temp),
                                       self.config.top_k)
            return int(first[0])

    def _decode_step(self, tok, pos, idx, mask, write_phys, temp) -> np.ndarray:
        # gather each lane's context pages, advance one token, write the
        # new K/V back at write_phys (inactive lanes hit scratch slot 0)
        with torch.inference_mode():
            idx_t = self._tensor(idx, torch.long)
            k_ctx = self.k_pages[:, idx_t]  # [L, B, C, H, Dh]
            v_ctx = self.v_pages[:, idx_t]
            logits, k_new, v_new = gpt2.decode_forward(
                self.model, self._tensor(tok, torch.long), self._tensor(pos, torch.long),
                k_ctx, v_ctx, self._tensor(mask),
            )
            wp = self._tensor(write_phys, torch.long)
            self.k_pages.index_copy_(1, wp, k_new)
            self.v_pages.index_copy_(1, wp, v_new)
            nxt = gpt2.sample_logits(logits, self._rng, self._tensor(temp), self.config.top_k)
            return nxt.cpu().numpy()

    @staticmethod
    def _prefill_bucket(n: int, cap: int) -> int:
        """Pad prompts to power-of-two buckets (min 8), as the reference
        does, so prefill sees a handful of shapes."""
        b = 8
        while b < n:
            b *= 2
        return min(b, cap)

    # -- public API ------------------------------------------------------
    def ensure_started(self):
        """Start (or restart) the step loop on the current event loop."""
        if self._loop_task is None or self._loop_task.done():
            self._stopped = False
            self._wake = self._wake or asyncio.Event()
            self._loop_task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self):
        self._stopped = True
        if self._wake is not None:
            self._wake.set()
        task, self._loop_task = self._loop_task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        # drain everything still queued/running so blocks balance to zero
        self.slots = [None] * self.config.max_batch_size
        self.waiting.clear()
        for req in list(self._by_id.values()):
            self._finish(req, "engine_stopped")

    def tokenize(self, prompt: Any) -> List[int]:
        """Token ids from a prompt (byte-level placeholder tokenizer)."""
        return tokenize_prompt(prompt, self.model_cfg.vocab_size)

    def _tenant_label(self, tenant: str) -> str:
        """Clamp a wire-supplied tenant to the bounded metric domain."""
        return tenants_mod.tenant_label(tenant, self._registered_tenants)

    def _shed(self, where: str, tenant: str, message: str,
              retry_after_s: float = 1.0) -> None:
        self._shed_total += 1
        key = (where, self._tenant_label(tenant))
        self._shed_unreported[key] = self._shed_unreported.get(key, 0) + 1
        self._push_metrics(force=True)
        raise RequestShedError(message, retry_after_s=retry_after_s)

    async def add_request(
        self,
        prompt: Any,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        slo: Optional[str] = None,
    ) -> _Request:
        """Admit one request; its ``.out`` queue streams token events
        ending with the FINISHED sentinel.  Sheds (typed, retryable) when
        the waiting queue is at its bound or the brownout ladder sheds
        the request's SLO class."""
        self.ensure_started()
        tenant = tenants_mod.normalize_tenant(tenant)
        slo = normalize_slo(slo)
        if self._degrade.should_shed(slo):
            self._shed(
                "brownout", tenant,
                f"brownout level {self._degrade.level} sheds {slo}-class "
                "requests (interactive is never shed)",
                retry_after_s=2.0,
            )
        if len(self.waiting) >= self.config.max_queue:
            self._shed(
                "engine", tenant,
                f"engine queue full ({len(self.waiting)} waiting, "
                f"bound {self.config.max_queue})",
            )
        tokens = self.tokenize(prompt)
        vocab = self.model_cfg.vocab_size
        if any(t < 0 or t >= vocab for t in tokens):
            # an out-of-range id would fault the embedding on the device
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if len(tokens) >= self.max_ctx:
            tokens = tokens[: self.max_ctx - 1]
        mt = max_tokens if max_tokens is not None else self.config.default_max_tokens
        mt = self._degrade.max_tokens_cap(slo, mt)
        mt = max(1, min(int(mt), self.max_ctx - len(tokens)))
        temp = self.config.temperature if temperature is None else float(temperature)
        rid = request_id or uuid.uuid4().hex[:16]
        if rid in self._by_id:
            raise ValueError(f"duplicate request id {rid!r}")
        now = time.time()
        self._seq_counter += 1
        req = _Request(
            request_id=rid,
            prompt=tokens,
            max_tokens=mt,
            temperature=temp,
            out=asyncio.Queue(),
            t_submit=now,
            tenant=tenant,
            slo=slo,
            priority=SLO_PRIORITY[slo],
            seq=self._seq_counter,
            t_enqueue=now,
            trace=self._mint_trace(),
        )
        if tenant != tenants_mod.DEFAULT_TENANT or req.priority != 1:
            self._fair_dirty = True
        self._by_id[rid] = req
        self.waiting.append(req)
        self._wake.set()
        return req

    def cancel(self, request_id: str) -> bool:
        """Cancel a request (client disconnect or explicit): frees its KV
        blocks and emits the finish sentinel.  Idempotent."""
        req = self._by_id.get(request_id)
        if req is None:
            return False
        if req.slot < 0:
            # still queued: release immediately (no blocks held yet)
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
            self._finish(req, "cancelled")
            return True
        # running: mark; the next step boundary frees the lane + blocks
        req.cancelled = True
        req.finish_reason = "cancelled"
        if self._wake is not None:
            self._wake.set()
        return True

    def stats(self) -> Dict[str, Any]:
        running = sum(1 for r in self.slots if r is not None)
        tenants: Dict[str, Dict[str, int]] = {}
        for r in self.slots:
            if r is None:
                continue
            u = tenants.setdefault(
                self._tenant_label(r.tenant),
                {"waiting": 0, "running": 0, "kv_blocks": 0},
            )
            u["running"] += 1
            u["kv_blocks"] += self.bm.blocks_held(r.request_id)
        for r in self.waiting:
            u = tenants.setdefault(
                self._tenant_label(r.tenant),
                {"waiting": 0, "running": 0, "kv_blocks": 0},
            )
            u["waiting"] += 1
        return {
            "waiting": len(self.waiting),
            "running": running,
            "max_batch_size": self.config.max_batch_size,
            "kv_blocks_in_use": self.bm.blocks_in_use,
            "kv_blocks_total": self.bm.num_blocks - 1,
            "kv_leak_report": self.bm.leak_report(),
            "tokens_per_s": round(self._tokens_per_s(), 2),
            "total_tokens": self._total_tokens,
            "shed_total": self._shed_total,
            "steps": self.step_count,
            "preemptions_total": self._preempt_total,
            "degradation_level": self._degrade.level,
            "tenants": tenants,
            "events": list(self._events),
        }

    def queued_depth(self) -> int:
        """Autoscaling signal: requests in the engine (waiting + lanes)."""
        return len(self.waiting) + sum(1 for r in self.slots if r is not None)

    # -- step loop -------------------------------------------------------
    async def _run(self):
        loop = asyncio.get_running_loop()
        while not self._stopped:
            try:
                self._reap()
                await self._join_waiters(loop)
                if not any(r is not None for r in self.slots):
                    self._push_metrics()
                    if not self.waiting:
                        self._wake.clear()
                        try:
                            await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                        except asyncio.TimeoutError:
                            pass
                    else:
                        # waiting but nothing admissible: KV pool full —
                        # yield until a completion frees blocks
                        await asyncio.sleep(0.005)
                    continue
                await self._decode_once(loop)
                self._push_metrics()
                # step boundary: let pending add_request/cancel callbacks run
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — one bad step must not stop serving
                logger.exception("llm engine step failed; continuing")
                await asyncio.sleep(0.05)

    def _reap(self):
        """Step-boundary cleanup: cancelled lanes leave, blocks freed."""
        for i, req in enumerate(self.slots):
            if req is not None and req.cancelled:
                self.slots[i] = None
                self._finish(req, "cancelled")

    async def _join_waiters(self, loop) -> int:
        """Admit waiting requests into free lanes — the continuous-batch
        join point: new requests enter at a step boundary instead of
        waiting for the running batch to drain."""
        self._maybe_preempt()
        joined = 0
        for i in range(len(self.slots)):
            if self.slots[i] is not None:
                continue
            req = self._next_admissible()
            if req is None:
                break
            req.slot = i
            req.t_join = time.time()
            req.join_step = self.step_count
            self.slots[i] = req
            try:
                await self._prefill(loop, req)
            except Exception as e:  # noqa: BLE001 — a bad prompt must not kill the loop
                logger.exception("prefill failed for %s", req.request_id)
                self.slots[i] = None
                req.finish_reason = f"error: {type(e).__name__}"
                self._finish(req, req.finish_reason)
                continue
            joined += 1
        return joined

    @staticmethod
    def _kv_need(req: _Request) -> int:
        """Remaining KV reservation.  Invariant under preemption folds:
        after a fold, len(prompt) grew by exactly the generated tokens it
        absorbed, so the need is always len(prompt0) + max_tokens."""
        return len(req.prompt) + req.max_tokens - req.generated

    def _next_admissible(self) -> Optional[_Request]:
        if not self._fair_dirty:
            # fast path: all waiting traffic is anonymous default-tenant
            # standard class — plain FIFO
            while self.waiting:
                req = self.waiting.popleft()
                if req.cancelled:
                    self._finish(req, "cancelled")
                    continue
                need = self._kv_need(req)
                if not self.bm.can_allocate(need):
                    # head-of-line blocks until capacity frees: put it
                    # back and stop (FIFO — no small-request overtaking)
                    self.waiting.appendleft(req)
                    return None
                self.bm.allocate(req.request_id, need)
                return req
            return None
        return self._next_admissible_fair()

    def _next_admissible_fair(self) -> Optional[_Request]:
        """Weighted-fair admission: per tenant, the head is its best
        (priority desc, then admission order) waiting request; across
        tenants, heads are served in ascending DRF dominant share over
        {KV blocks, decode lanes} (weights from ``tenant_weights``).
        Work-conserving: a head that does not fit the pool is skipped."""
        if not self.waiting:
            self._fair_dirty = False
            return None
        alive = []
        for req in self.waiting:
            if req.cancelled:
                self._finish(req, "cancelled")
            else:
                alive.append(req)
        if len(alive) != len(self.waiting):
            self.waiting = collections.deque(alive)
        if not alive:
            self._fair_dirty = False
            return None
        heads: Dict[str, _Request] = {}
        for req in alive:
            cur = heads.get(req.tenant)
            if cur is None or (-req.priority, req.seq) < (-cur.priority, cur.seq):
                heads[req.tenant] = req
        usage: Dict[str, Dict[str, float]] = {}
        for r in self.slots:
            if r is None:
                continue
            u = usage.setdefault(r.tenant, {"kv": 0.0, "lanes": 0.0})
            u["kv"] += self.bm.blocks_held(r.request_id)
            u["lanes"] += 1.0
        totals = {
            "kv": float(self.bm.num_blocks - 1),
            "lanes": float(self.config.max_batch_size),
        }
        weights = self.config.tenant_weights

        def rank(t: str):
            share = tenants_mod.dominant_share(
                usage.get(t, {}), totals, float(weights.get(t, 1.0))
            )
            h = heads[t]
            return (share, -h.priority, h.seq)

        for t in sorted(heads, key=rank):
            req = heads[t]
            need = self._kv_need(req)
            if self.bm.can_allocate(need):
                self.waiting.remove(req)
                self.bm.allocate(req.request_id, need)
                return req
        return None

    # -- priority preemption (preempt-by-recompute) ----------------------
    def _maybe_preempt(self):
        """When a higher-priority request has starved past
        ``preempt_wait_s`` and cannot join (no lane, or KV pool full),
        evict the cheapest strictly-lower-priority running lane.  At most
        one victim per step boundary."""
        if not self._fair_dirty or not self.waiting:
            return
        cand = None
        for req in self.waiting:
            if req.cancelled:
                continue
            if cand is None or (-req.priority, req.seq) < (-cand.priority, cand.seq):
                cand = req
        if cand is None:
            return
        now = time.time()
        if now - (cand.t_enqueue or cand.t_submit) < self.config.preempt_wait_s:
            return
        if (any(r is None for r in self.slots)
                and self.bm.can_allocate(self._kv_need(cand))):
            return  # joins normally this boundary; nothing to evict
        victims = [
            r for r in self.slots
            if r is not None and not r.cancelled and r.priority < cand.priority
        ]
        if not victims:
            return
        # cheapest recompute first: lowest priority, least generated
        # (smallest refill), youngest lane
        victim = min(victims, key=lambda r: (r.priority, r.generated, -r.t_join))
        self._preempt(victim, cand)

    def _preempt(self, req: _Request, for_req: Optional[_Request] = None):
        """Evict a running lane by recompute: free its KV pages, fold the
        tokens generated so far into its prompt, and re-queue it.  On
        resume, prefill replays the folded context and samples the next
        token — under greedy decoding exactly the token the uninterrupted
        run would have produced."""
        import os

        from ray_tpu_torch._private.chaos import CHAOS

        if req.slot >= 0:
            self.slots[req.slot] = None
        req.slot = -1
        self.bm.free(req.request_id)
        # Chaos fault point: "@serve.preempt.evict:kill:at=N" dies after
        # the pages are freed but before the requeue — the replica-crash
        # window the zero-leak drill drives.
        if CHAOS.active and CHAOS.maybe_kill("serve.preempt.evict"):
            logger.warning("chaos: killing replica mid-preemption (evict)")
            os._exit(1)
        req.prompt = list(req.prompt) + req.tokens[req.folded:]
        req.folded = len(req.tokens)
        req.t_enqueue = time.time()
        req.preemptions += 1
        self._preempt_total += 1
        self._events.append({
            "type": "preemption",
            "t": req.t_enqueue,
            "victim": req.request_id,
            "victim_slo": req.slo,
            "victim_tenant": self._tenant_label(req.tenant),
            "for": for_req.request_id if for_req is not None else "",
            "generated": req.generated,
            "preemptions": req.preemptions,
        })
        try:
            from ray_tpu_torch._private import telemetry

            telemetry.count_serve_preemption(self.config.name, req.slo)
        except Exception:  # noqa: BLE001
            pass
        if CHAOS.active and CHAOS.maybe_kill("serve.preempt.requeue"):
            logger.warning("chaos: killing replica mid-preemption (requeue)")
            os._exit(1)
        self.waiting.append(req)
        self._fair_dirty = True

    async def _prefill(self, loop, req: _Request):
        n = len(req.prompt)
        bucket = self._prefill_bucket(n, self.max_ctx)
        toks = np.zeros((1, bucket), dtype=np.int64)
        toks[0, :n] = req.prompt
        self.bm.advance(req.request_id, n)
        phys = self.bm.phys_indices(req.request_id, n, bucket)
        last_idx = np.array([n - 1], dtype=np.int64)
        temp = np.array([req.temperature], dtype=np.float32)
        tok = await loop.run_in_executor(
            None, self._prefill_step, toks, phys, last_idx, temp
        )
        self._emit(req, tok)
        self._tok_window.append((time.time(), 1))
        if req.cancelled or self._is_finished(req, tok):
            self.slots[req.slot] = None
            self._finish(req, req.finish_reason or "length")

    async def _decode_once(self, loop):
        B = self.config.max_batch_size
        C = self.max_ctx
        tok = np.zeros(B, dtype=np.int64)
        pos = np.zeros(B, dtype=np.int64)
        idx = np.zeros((B, C), dtype=np.int64)
        mask = np.zeros((B, C), dtype=bool)
        write_phys = np.zeros(B, dtype=np.int64)
        temp = np.zeros(B, dtype=np.float32)
        active_lanes = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            rid = req.request_id
            cur_len = self.bm.seq_len(rid)  # positions already in cache
            tok[i] = req.tokens[-1]
            pos[i] = cur_len  # the fed token's position
            idx[i] = self.bm.phys_indices(rid, cur_len, C)
            mask[i, :cur_len] = True
            self.bm.advance(rid, 1)
            write_phys[i] = self.bm.phys_index(rid, cur_len)
            temp[i] = req.temperature
            active_lanes.append(i)
        nxt = await loop.run_in_executor(
            None, self._decode_step, tok, pos, idx, mask, write_phys, temp
        )
        self.step_count += 1
        now = time.time()
        emitted = 0
        for i in active_lanes:
            req = self.slots[i]
            if req is None:
                continue
            t = int(nxt[i])
            self._emit(req, t, now=now)
            emitted += 1
            if req.cancelled or self._is_finished(req, t):
                self.slots[i] = None
                self._finish(req, req.finish_reason or "length")
        if emitted:
            self._tok_window.append((now, emitted))

    # -- bookkeeping -----------------------------------------------------
    def _emit(self, req: _Request, token: int, now: Optional[float] = None):
        req.tokens.append(token)
        req.generated += 1
        self._total_tokens += 1
        if self._fair_dirty or req.tenant != tenants_mod.DEFAULT_TENANT:
            self._tenant_tok_window.append((now or time.time(), req.tenant, 1))
        if req.t_first_token == 0.0:
            req.t_first_token = now or time.time()
        req.out.put_nowait(
            {
                "request_id": req.request_id,
                "token": token,
                "index": req.generated - 1,
            }
        )

    def _is_finished(self, req: _Request, token: int) -> bool:
        eos = self.config.eos_token
        if eos >= 0 and token == eos:
            req.finish_reason = "eos"
            return True
        if req.generated >= req.max_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _finish(self, req: _Request, reason: str):
        """Terminal bookkeeping — the ONLY place a request leaves the
        engine: frees blocks, emits the sentinel, records spans/TTFT."""
        if self._by_id.pop(req.request_id, None) is None:
            return
        self.bm.free(req.request_id)
        req.finish_reason = req.finish_reason or reason
        req.t_done = time.time()
        req.finish_step = self.step_count
        req.out.put_nowait(FINISHED)
        self._record_spans(req)
        self._observe_ttft(req)

    # -- observability ---------------------------------------------------
    def _mint_trace(self) -> tuple:
        from ray_tpu_torch.util import tracing

        ctx = tracing.current_context()
        trace_id = ctx[0] if ctx else uuid.uuid4().hex
        parent = ctx[1] if ctx else None
        return (trace_id, uuid.uuid4().hex[:16], parent)

    def _record_spans(self, req: _Request):
        """serve.request -> {serve.queue, serve.prefill, serve.decode}:
        the per-request latency decomposition that critical-path analysis
        surfaces."""
        try:
            from ray_tpu_torch.util import tracing

            trace_id, root_id, parent = req.trace
            end = req.t_done or time.time()
            tracing.record_span(
                "serve.request", req.t_submit, end,
                {
                    "request_id": req.request_id,
                    "deployment": self.config.name,
                    "tokens": req.generated,
                    "finish_reason": req.finish_reason,
                },
                context=(trace_id, root_id, parent),
            )
            t_join = req.t_join or end
            tracing.record_span(
                "serve.queue", req.t_submit, t_join, None,
                context=(trace_id, uuid.uuid4().hex[:16], root_id),
            )
            if req.t_join:
                t_first = req.t_first_token or end
                tracing.record_span(
                    "serve.prefill", req.t_join, t_first, None,
                    context=(trace_id, uuid.uuid4().hex[:16], root_id),
                )
                tracing.record_span(
                    "serve.decode", t_first, end, {"tokens": req.generated},
                    context=(trace_id, uuid.uuid4().hex[:16], root_id),
                )
        except Exception:  # noqa: BLE001 — observability must not fail serving
            pass

    def _observe_ttft(self, req: _Request):
        if not req.t_first_token:
            return
        self._ttft_recent.append(req.t_first_token - req.t_submit)
        try:
            from ray_tpu_torch._private import telemetry

            telemetry.observe_serve_ttft(
                self.config.name, req.t_first_token - req.t_submit
            )
        except Exception:  # noqa: BLE001
            pass

    # -- load signals ----------------------------------------------------
    def _tokens_per_s(self) -> float:
        now = time.time()
        window = [(t, n) for t, n in self._tok_window if now - t <= 5.0]
        if not window:
            return 0.0
        span = max(now - window[0][0], 1e-3)
        return sum(n for _, n in window) / span

    def _ttft_p95(self) -> Optional[float]:
        if not self._ttft_recent:
            return None
        vals = sorted(self._ttft_recent)
        return vals[min(len(vals) - 1, int(0.95 * len(vals)))]

    def _push_metrics(self, force: bool = False):
        """The 1 Hz control tick: drives the brownout ladder (inert when
        ``slo_ttft_s`` is 0) and exports the serve gauges, the shed
        counters and the device-memory report."""
        now = time.time()
        if not force and now - self._last_metrics_push < 1.0:
            return
        self._last_metrics_push = now
        if self._degrade.enabled:
            before = self._degrade.level
            level = self._degrade.tick(self._ttft_p95(), len(self.waiting))
            if level != before:
                self._events.append({
                    "type": "degradation",
                    "t": now,
                    "from": before,
                    "to": level,
                    "queue": len(self.waiting),
                })
                logger.info(
                    "brownout level %d -> %d (queue=%d)",
                    before, level, len(self.waiting),
                )
        try:
            from ray_tpu_torch._private import telemetry

            name = self.config.name
            telemetry.set_serve_queue_depth(name, len(self.waiting))
            telemetry.set_serve_kv_blocks(name, self.bm.blocks_in_use)
            telemetry.set_serve_tokens_per_s(name, self._tokens_per_s())
            if self._degrade.enabled:
                telemetry.set_serve_degradation(name, self._degrade.level)
            for tenant, rate in self._tenant_tokens_per_s().items():
                telemetry.set_serve_tenant_tokens_per_s(name, tenant, rate)
            # Device memory attribution for the paged KV cache (a no-op
            # without a CUDA context; internally rate-limited).
            from ray_tpu_torch._private import profiling as profiling_mod

            profiling_mod.report_device_memory()
            if self._shed_unreported:
                pending, self._shed_unreported = self._shed_unreported, {}
                for (where, tenant), n in pending.items():
                    telemetry.count_serve_shed(name, where, n, tenant=tenant)
        except Exception:  # noqa: BLE001
            pass

    def _tenant_tokens_per_s(self) -> Dict[str, float]:
        """Per-tenant token rate over the 5 s window, labels clamped to
        the registered domain (empty for pure anonymous traffic — the
        window is only fed once identity appears)."""
        now = time.time()
        window = [(t, ten, n) for t, ten, n in self._tenant_tok_window
                  if now - t <= 5.0]
        if not window:
            return {}
        span = max(now - window[0][0], 1e-3)
        out: Dict[str, float] = {}
        for _, ten, n in window:
            label = self._tenant_label(ten)
            out[label] = out.get(label, 0.0) + n
        return {k: v / span for k, v in out.items()}
