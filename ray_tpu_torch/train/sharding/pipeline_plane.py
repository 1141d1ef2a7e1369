"""MPMD pipeline parallelism: stage actor groups over compiled channels
(port of ``ray_tpu/train/sharding/pipeline_plane.py``).

The SPMD pipeline (``parallel/pipeline.py``) runs all stages as one SPMD
program — right when the stages fit one mesh.  This plane is the
MPMD formulation (PAPERS.md "Scaling Deep Learning Training with MPMD
Pipeline Parallelism"): each stage is its OWN actor group member with
its own program, placed via a placement group, and activations/grads
flow stage-to-stage as wire frames over the compiled-channel dataplane —
shm rings same-node, persistent sockets cross-node, **no object store
on the steady-state path**.

Schedule: 1F1B.  Stage ``s`` of ``S`` runs ``w = min(M, S-1-s)`` warmup
forwards, then ``M-w`` (forward, backward) pairs, then ``w`` cooldown
backwards — the global interleaving emerges from each stage blocking on
its channel reads, no central scheduler.  Per-stage busy time and
bubble fraction feed the profiling plane
(``pipeline_stage_seconds`` / ``pipeline_bubble_fraction``).

Failure model: a stage death is detected driver-side (result-channel
timeout + GCS actor probe) and recovers by WHOLE-pipeline restart from
the plane's last in-memory checkpoint — the pipeline is one logical
training process, exactly like the fixed-size trainer's whole-group
restart.  Restarts replay the steps since the checkpoint, so a chaos
kill mid-epoch lands on the same final loss as an undisturbed run.

The runtime half (the config, ``schedule_ops``, the stage's channel
binding and reads, the driver's placement, fan-out broadcast, wiring,
steps, restarts, checkpoints, probes and teardown) is the reference's
with the imports renamed.  The stage's arithmetic is torch:

- the GPT-2 stage programs run the port's ``Block`` through
  ``torch.func.functional_call`` over the stage's parameters, a flat
  ``{name: tensor}`` of ``models/gpt2.py``'s names; host trees hold them
  as numpy arrays, as the reference's do (a CPU tensor where numpy lacks
  the dtype: bf16); the optimizer is ``gpt2.make_adamw``, its host state
  the ``state_dict``;
- F runs under ``no_grad``; B takes the saved input with
  ``requires_grad``, recomputes the stage's forward and back-propagates
  ``dy`` (the reference's ``jax.vjp`` recomputes too), the parameters'
  gradients summing in their ``.grad``; the last stage runs forward and
  backward once; the update divides the summed gradients by M and steps
  AdamW;
- activations keep the reference's wire, f32 numpy; a stage casts them
  to its compute dtype, and a gradient to its output's dtype.

``PipelineConfig.device`` (default ``cuda``) is where each stage
computes: a ``cuda`` stage leases ``1/stages`` of a ``GPU`` in its
placement-group bundle and its actor options, beside the reference's
CPU, so the stages share one card; the driver refuses ``cuda`` on a
machine without one.  Each stage reports its flash kernels' launches in
``get_stats()`` (counts of its own process).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosed,
    ChannelCorruptionError,
    ChannelTimeout,
    FanoutChannel,
    FanoutReader,
    SocketListener,
    dial,
    node_hosts,
    reattach,
    ring_base_dir,
)

logger = logging.getLogger(__name__)


class StageFailedError(RuntimeError):
    """A pipeline stage died or stalled past the step deadline."""


@dataclass
class PipelineConfig:
    """MPMD pipeline shape: ``stages`` actor-group members running
    ``microbatches`` microbatches per step under 1F1B."""

    stages: int = 2
    microbatches: int = 4
    num_cpus_per_stage: float = 1.0
    placement: str = "PACK"
    # Ring capacity per edge; must hold ~stages activations in flight
    # (the 1F1B warmup depth).  16 MiB covers the CPU-scale configs —
    # RAISE it yourself when one activation microbatch frame outgrows it
    # (the stage loop hits ChannelCapacityError, surfaced through
    # StageFailedError's per-stage errors).
    ring_capacity: int = 16 * 1024 * 1024
    step_timeout_s: float = 120.0
    # Driver-side in-memory checkpoint cadence (steps); 0 = only the
    # initial state is restorable.
    checkpoint_every: int = 0
    # Durable checkpoints (checkpoint_plane commit protocol): every
    # in-memory checkpoint is ALSO snapshot-committed here, and a fresh
    # plane (driver restart, not just stage restart) resumes from the
    # newest verified one.  None = in-memory restart points only.
    checkpoint_dir: Optional[str] = None
    # Whole-pipeline restarts allowed before a stage death propagates.
    max_restarts: int = 1
    seed: int = 0
    # Where each stage computes: "cuda" (a 1/stages GPU lease a stage) or
    # "cpu".
    device: str = "cuda"

    def __post_init__(self):
        if self.stages < 2:
            raise ValueError("a pipeline needs at least 2 stages")
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")


def schedule_ops(stage: int, n_stages: int, n_micro: int) -> List[str]:
    """This stage's local 1F1B op order; the global schedule emerges
    from channel blocking."""
    w = min(n_micro, n_stages - 1 - stage)
    ops = ["F"] * w
    for _ in range(n_micro - w):
        ops += ["F", "B"]
    ops += ["B"] * w
    return ops


# ---------------------------------------------------------------------------
# Stage programs (picklable: module-level fns bound with functools.partial)


@dataclass
class PipelineProgram:
    """Model split into ``n_stages`` stage programs.

    ``init_params()`` builds the FULL host param tree (driver-side,
    seeded); ``split(params, s)`` extracts stage ``s``'s subtree;
    ``merge(stage_trees)`` reassembles for checkpoint interop;
    ``stage_apply[s]`` is that stage's forward — first stage
    ``(params, tokens) -> act``, middle ``(params, act) -> act``, last
    ``(params, act, targets) -> scalar loss``.  ``optimizer(params)``
    builds the stage's optimizer over its parameter tensors."""

    n_stages: int
    init_params: Callable[[], Any]
    split: Callable[[Any, int], Any]
    merge: Callable[[List[Any]], Any]
    stage_apply: List[Callable] = field(default_factory=list)
    optimizer: Callable[[], Any] = None


def _gpt2_init(cfg, seed: int):
    import torch

    from ray_tpu_torch.models import gpt2

    model = gpt2.init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return {k: v.detach() for k, v in model.named_parameters()}


def _gpt2_layer_range(cfg, n_stages: int, s: int) -> Tuple[int, int]:
    if cfg.n_layer % n_stages:
        raise ValueError(
            f"n_layer {cfg.n_layer} not divisible by {n_stages} stages"
        )
    per = cfg.n_layer // n_stages
    return s * per, (s + 1) * per


def _gpt2_split(cfg, n_stages: int, params: Any, s: int) -> Any:
    lo, hi = _gpt2_layer_range(cfg, n_stages, s)
    sub = {k: v for k, v in params.items()
           if k.startswith("h_") and lo <= int(k[2:k.index(".")]) < hi}
    if s == 0:
        sub["wte.weight"] = params["wte.weight"]
        sub["wpe.weight"] = params["wpe.weight"]
    if s == n_stages - 1:
        for k in ("ln_f.weight", "ln_f.bias", "lm_head.weight"):
            sub[k] = params[k]
    return sub


def _gpt2_merge(cfg, n_stages: int, stage_trees: List[Any]) -> Any:
    full: Dict[str, Any] = {}
    for sub in stage_trees:
        full.update(sub)
    return full


def _gpt2_blocks(cfg, params, x, lo: int, hi: int):
    from torch.func import functional_call

    from ray_tpu_torch.models.common import meta_build
    from ray_tpu_torch.models.gpt2 import Block

    block = meta_build(lambda: Block(cfg))
    for i in range(lo, hi):
        prefix = f"h_{i}."
        layer = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        x = functional_call(block, layer, (x,))[0]
    return x


def _gpt2_apply_first(cfg, n_stages: int, params, tokens):
    from ray_tpu_torch.models.gpt2_pp import _embed

    lo, hi = _gpt2_layer_range(cfg, n_stages, 0)
    x = _embed(params["wte.weight"], params["wpe.weight"], tokens, cfg)
    return _gpt2_blocks(cfg, params, x, lo, hi)


def _gpt2_apply_mid(cfg, n_stages: int, s: int, params, x):
    lo, hi = _gpt2_layer_range(cfg, n_stages, s)
    return _gpt2_blocks(cfg, params, x.to(cfg.dtype), lo, hi)


def _gpt2_apply_last(cfg, n_stages: int, params, x, targets):
    from ray_tpu_torch.models.gpt2_pp import _head_loss

    lo, hi = _gpt2_layer_range(cfg, n_stages, n_stages - 1)
    x = _gpt2_blocks(cfg, params, x.to(cfg.dtype), lo, hi)
    return _head_loss(params, x, targets, cfg)


def _gpt2_adamw(lr: float, params):
    from ray_tpu_torch.models import gpt2

    return gpt2.make_adamw(params, lr=lr)


def gpt2_pipeline_programs(
    cfg, n_stages: int, lr: float = 1e-3, seed: int = 0
) -> PipelineProgram:
    """Stage programs for ``models/gpt2.py``: embed + first blocks on
    stage 0, block ranges in the middle, blocks + ln_f + head + loss on
    the last stage.  Loss/grad parity with the single-process
    ``gpt2.loss_fn`` is exact (same math, microbatch-mean == batch-mean
    for equal microbatches).  The stage programs apply plain blocks
    (``cfg.remat`` is not read: B recomputes the stage's forward)."""
    from functools import partial

    applies: List[Callable] = []
    for s in range(n_stages):
        if s == 0:
            applies.append(partial(_gpt2_apply_first, cfg, n_stages))
        elif s == n_stages - 1:
            applies.append(partial(_gpt2_apply_last, cfg, n_stages))
        else:
            applies.append(partial(_gpt2_apply_mid, cfg, n_stages, s))
    return PipelineProgram(
        n_stages=n_stages,
        init_params=partial(_gpt2_init, cfg, seed),
        split=partial(_gpt2_split, cfg, n_stages),
        merge=partial(_gpt2_merge, cfg, n_stages),
        stage_apply=applies,
        optimizer=partial(_gpt2_adamw, lr),
    )


# ---------------------------------------------------------------------------
# Stage actor


def _to_wire(x) -> np.ndarray:
    """Activations travel as f32 numpy (bf16 has no portable numpy wire
    form); stages cast back to their compute dtype on read."""
    import torch

    return x.detach().to(torch.float32).cpu().numpy()


def _host_copy(tree: Any) -> Any:
    """``tree`` (nested dicts, lists and tensors) with every tensor a host
    copy: a numpy array, the reference's host form, which the wire moves
    without pickling; a CPU tensor where numpy lacks the dtype (bf16)."""
    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _on(tree: Any, dev) -> Any:
    """A host tree's arrays and tensors as tensors on ``dev``, each a copy
    (a decoded frame's arrays may be read-only views of it)."""
    import torch

    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev, copy=True)
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, dev) for v in tree)
    return tree


@ray_tpu_torch.remote
class PipelineStage:
    """One MPMD pipeline stage: owns its param/optimizer shard and runs
    the 1F1B loop on a background thread so checkpoint/stats RPCs stay
    serviceable mid-epoch."""

    def __init__(self, index: int, n_stages: int, n_micro: int,
                 apply_fn: Callable, optimizer_fn: Callable, device: str = "cuda"):
        self.index = index
        self.n_stages = n_stages
        self.n_micro = n_micro
        self.apply_fn = apply_fn
        self.optimizer_fn = optimizer_fn
        self.device = device
        self.is_first = index == 0
        self.is_last = index == n_stages - 1
        self.params = None
        self.optimizer = None
        self._dev = None  # torch.device, the loop thread's own (resolved as it starts)
        self._listeners: Dict[str, SocketListener] = {}
        self._chans: Dict[str, Any] = {}
        self._ring_dir: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self._error: Optional[str] = None
        self.stats: Dict[str, Any] = {
            "steps": 0, "microbatches": 0, "busy_s": 0.0, "wall_s": 0.0,
            "bubble_fraction": 0.0,
        }

    # -- control --------------------------------------------------------
    def ping(self):
        return True

    def set_state(self, params, opt_state=None):
        """Adopt a host tree (and the optimizer's ``state_dict``, else a
        fresh optimizer) on this stage's device; raises for ``cuda`` on a
        machine without a card."""
        from ray_tpu_torch._private.device import resolve_device

        dev = resolve_device(self.device)
        params = {k: v.requires_grad_(True) for k, v in _on(params, dev).items()}
        optimizer = self.optimizer_fn(list(params.values()))
        if opt_state is not None:
            optimizer.load_state_dict(_on(opt_state, dev))
        with self._state_lock:
            self.params, self.optimizer = params, optimizer
        return True

    def read_broadcast(self, path: str, reader_index: int, split_fn: Callable):
        """Consume one fan-out weight broadcast (write-once, N
        consume-acks) and slice out this stage's subtree — the
        same-node replacement for N duplicate ring writes."""
        reader = FanoutReader(path, reader_index)
        try:
            _tag, payload = reader.read_value(timeout=60.0)
        finally:
            reader.close()
        full_params, opt_states = payload
        self.set_state(
            split_fn(full_params, self.index),
            opt_states[self.index] if opt_states else None,
        )
        return True

    def get_state(self):
        """(params, the optimizer's ``state_dict``) as host copies; taken
        between steps."""
        with self._state_lock:
            return _host_copy(self.params), _host_copy(self.optimizer.state_dict())

    def get_stats(self):
        """The loop's counters, the flash kernels' launches in this
        process ([B1, B2, B3]) and, on the card, its peak memory."""
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        out = {**self.stats, "launches": [fa.flash_attention_fwd.launches,
                                          fa.flash_attention_dq.launches,
                                          fa.flash_attention_dkv.launches]}
        if torch.device(self.device).type == "cuda" and torch.cuda.is_initialized():
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated(self.device) / 1e9
        return out

    def get_error(self):
        """Last loop-thread failure (None while healthy) — lets the
        driver name a deterministic error (e.g. ChannelCapacityError)
        instead of reporting only its own result timeout."""
        with self._state_lock:
            return self._error

    def bind(self, in_specs: Dict[str, dict]) -> Dict[str, Any]:
        """Create this stage's INBOUND endpoints: ring files locally,
        socket listeners for cross-node writers.  Returns
        name -> path (ring) | port (socket)."""
        out: Dict[str, Any] = {}
        for name, spec in in_specs.items():
            if spec["kind"] == "ring":
                if self._ring_dir is None:
                    self._ring_dir = os.path.join(
                        ring_base_dir(), f"ray_tpu_torch_pp_{uuid.uuid4().hex[:12]}"
                    )
                    os.makedirs(self._ring_dir, exist_ok=True)
                path = os.path.join(self._ring_dir, name)
                Channel.create_file(path, int(spec["capacity"]))
                out[name] = path
            else:
                lst = SocketListener()
                self._listeners[name] = lst
                out[name] = lst.port
        return out

    def start(self, edge_specs: Dict[str, dict]):
        """Open every endpoint and run the 1F1B loop on a daemon thread
        (joined in stop_loop) so the actor stays responsive."""
        self._stop.clear()
        with self._state_lock:
            self._error = None
        self._thread = threading.Thread(
            target=self._loop, args=(edge_specs,), daemon=True,
            name=f"pp-stage-{self.index}",
        )
        self._thread.start()
        return True

    def stop_loop(self, join_timeout_s: float = 10.0):
        self._stop.set()
        for chan in self._chans.values():
            try:
                chan.close()
            except Exception:  # noqa: BLE001 — teardown
                pass
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout_s)
        self._chans.clear()
        if self._ring_dir:
            import shutil

            shutil.rmtree(self._ring_dir, ignore_errors=True)
            self._ring_dir = None
        with self._state_lock:
            return self._error

    # -- loop -----------------------------------------------------------
    def _open(self, name: str, spec: dict):
        if spec["role"] == "read":
            if spec["kind"] == "ring":
                chan = Channel(spec["path"])
            else:
                chan = self._listeners.pop(name).accept("read", timeout=60.0)
        else:
            if spec["kind"] == "ring":
                chan = Channel(spec["path"])
            else:
                chan = dial(tuple(spec["addr"]), "write", timeout=30.0)
        self._chans[name] = chan
        return chan

    # -- the stage's arithmetic ---------------------------------------------
    def _on_device(self, a: np.ndarray):
        import torch

        return torch.from_numpy(a).to(self._dev)

    def _sync(self) -> None:
        """Wait for the device (a busy window ends when its work has)."""
        import torch

        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)

    def _fwd(self, params, x):
        """F: the stage's forward, nothing recorded for a backward."""
        import torch

        with torch.no_grad():
            return self.apply_fn(params, x)

    def _bwd(self, params, x, dy):
        """B: recompute the forward from the saved input and back-propagate
        ``dy``; the parameters' gradients add into their ``.grad``.
        Returns the input's gradient (None for the first stage, whose
        input is token ids)."""
        import torch

        x = x if self.is_first else x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.apply_fn(params, x)
            torch.autograd.backward(y, dy.to(y.dtype))
        return None if self.is_first else x.grad

    def _fwdbwd(self, params, x, tgt):
        """The last stage's F: forward and backward at once; (loss, dx)."""
        import torch

        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.apply_fn(params, x, tgt)
            loss.backward()
        return float(loss.detach()), x.grad

    def _update(self, params, optimizer) -> None:
        """Divide the summed gradients by M and step AdamW."""
        for p in params.values():
            if p.grad is not None:
                p.grad.div_(self.n_micro)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def _read(self, chan, what: str):
        """Blocking channel read that honors the stop flag: short read
        timeouts are retried until stop is set (an idle pipeline between
        driver steps is not an error).  A connection-level death takes
        one shared reattach() before giving up; a corrupted frame
        propagates typed (a lost microbatch desyncs 1F1B — the driver's
        checkpoint-restart owns that)."""
        while True:
            try:
                _tag, value, tctx = chan.read_value_traced(timeout=5.0)
                if tctx is not None:
                    # Adopt the inbound microbatch's trace context for this
                    # stage thread: downstream edge writes (act_out/grad_out)
                    # parent under it, so a step's trace crosses every stage.
                    # Untraced frames leave the context alone — interleaved
                    # 1F1B reads on one thread must not sever a traced
                    # step's chain mid-schedule.
                    from ray_tpu_torch.util import tracing

                    tracing.set_frame_context(tctx)
                return value
            except ChannelTimeout:
                if self._stop.is_set():
                    raise ChannelClosed(f"stage {self.index} stopping ({what})")
            except ChannelClosed:
                if self._stop.is_set():
                    raise
                if not reattach(chan):
                    raise

    def _loop(self, edge_specs: Dict[str, dict]):
        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch._private.device import resolve_device

        try:
            self._dev = resolve_device(self.device)
            for name, spec in edge_specs.items():
                self._open(name, spec)
            act_in = self._chans.get("act_in")
            act_out = self._chans.get("act_out")
            grad_in = self._chans.get("grad_in")
            grad_out = self._chans.get("grad_out")
            tgt_in = self._chans.get("tgt_in")
            result_out = self._chans.get("result_out")
            ops = schedule_ops(self.index, self.n_stages, self.n_micro)
            while not self._stop.is_set():
                saved: deque = deque()
                losses: List[float] = []
                busy = 0.0
                # Block for the step's first input OUTSIDE the wall-time
                # window: idle-between-steps is driver cadence, not
                # pipeline bubble.
                first = self._read(act_in, "act_in")
                t_step = time.monotonic()
                # One params snapshot per step: set_state() can swap the
                # weights concurrently, and mixing old/new params across
                # the F/B ops of a single step corrupts the gradient.
                with self._state_lock:
                    params, optimizer = self.params, self.optimizer
                for oi, op in enumerate(ops):
                    if op == "F":
                        x_np = first if oi == 0 else self._read(act_in, "act_in")
                        first = None
                        t0 = time.monotonic()
                        x = self._on_device(x_np)
                        if self.is_last:
                            tgt = self._on_device(self._read(tgt_in, "tgt_in"))
                            loss, dx = self._fwdbwd(params, x, tgt)
                            saved.append(dx)
                            losses.append(loss)
                            busy += time.monotonic() - t0
                        else:
                            y = self._fwd(params, x)
                            y_np = _to_wire(y)
                            busy += time.monotonic() - t0
                            act_out.write_value(y_np, timeout=60.0)
                            saved.append(x)
                    else:  # B
                        if self.is_last:
                            dx = saved.popleft()
                            t0 = time.monotonic()
                            dx_np = _to_wire(dx)
                            busy += time.monotonic() - t0
                            grad_out.write_value(dx_np, timeout=60.0)
                        else:
                            dy = self._on_device(self._read(grad_in, "grad_in"))
                            x = saved.popleft()
                            t0 = time.monotonic()
                            dx = self._bwd(params, x, dy)
                            if dx is None:
                                self._sync()
                                dx_np = None
                            else:
                                dx_np = _to_wire(dx)
                            busy += time.monotonic() - t0
                            if dx_np is not None:
                                grad_out.write_value(dx_np, timeout=60.0)
                t0 = time.monotonic()
                with self._state_lock:
                    self._update(params, optimizer)
                    # Force completion inside the busy window.
                    self._sync()
                busy += time.monotonic() - t0
                wall = time.monotonic() - t_step
                bubble = max(0.0, 1.0 - busy / wall) if wall > 0 else 0.0
                s = self.stats
                s["steps"] += 1
                s["microbatches"] += self.n_micro
                s["busy_s"] += busy
                s["wall_s"] += wall
                s["bubble_fraction"] = bubble
                telemetry.observe_pipeline_stage(self.index, busy)
                telemetry.set_pipeline_bubble(self.index, bubble)
                if self.is_last:
                    result_out.write_value(
                        {"loss": float(np.mean(losses)), "busy_s": busy,
                         "wall_s": wall},
                        timeout=60.0,
                    )
        except ChannelClosed:
            pass  # orderly teardown / driver restart
        except Exception as e:  # noqa: BLE001 — surfaced via stop_loop
            if not self._stop.is_set():
                logger.exception("pipeline stage %d loop failed", self.index)
                with self._state_lock:
                    self._error = f"{type(e).__name__}: {e}"
        finally:
            for chan in self._chans.values():
                try:
                    chan.close()
                except Exception:  # noqa: BLE001
                    pass


# ---------------------------------------------------------------------------
# Driver plane


class PipelinePlane:
    """Driver half: owns the stage actors, their channel edges, the
    microbatch feed, and the checkpoint-restart failure path."""

    def __init__(self, program: PipelineProgram, config: PipelineConfig):
        if program.n_stages != config.stages:
            raise ValueError(
                f"program has {program.n_stages} stages, config {config.stages}"
            )
        self.program = program
        self.config = config
        self.actors: List[Any] = []
        self._pg = None
        self._chans: Dict[str, Any] = {}
        self._listeners: Dict[str, SocketListener] = {}
        self._ring_dir: Optional[str] = None
        self._stage_ring_dirs: set = set()
        self._started = False
        self.restarts = 0
        self.steps_done = 0
        # (step, params_full, [opt_state per stage]) — the restart point.
        self._ckpt: Optional[Tuple[int, Any, Optional[List[Any]]]] = None

    # -- lifecycle ------------------------------------------------------
    def start(self, state: Optional[Tuple[Any, Optional[List[Any]]]] = None):
        """Spawn + place the stage actors, wire every edge, distribute
        weights (fan-out broadcast when all stages share the driver's
        node), and launch the resident loops."""
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.util.placement_group import placement_group

        cfg = self.config
        S = cfg.stages
        # a cuda stage leases 1/S of a card, so the stages share one; a
        # machine without a card refuses cuda here, before any placement
        gpus = 1.0 / S if resolve_device(cfg.device).type == "cuda" else 0.0
        if (
            state is None
            and self._ckpt is None
            and cfg.checkpoint_dir
            and self._restore_durable_ckpt()
        ):
            # Driver restart: a verified durable checkpoint supersedes a
            # fresh init (stage restarts pass state= and skip this).
            _step, params_full, opt_states = self._ckpt
        elif state is None:
            params_full = _host_copy(self.program.init_params())
            opt_states = None
        else:
            params_full, opt_states = state
        if self._ckpt is None:
            self._ckpt = (0, params_full, opt_states)

        bundle = {"CPU": cfg.num_cpus_per_stage, **({"GPU": gpus} if gpus else {})}
        self._pg = placement_group([dict(bundle) for _ in range(S)], strategy=cfg.placement)
        self._pg.wait(timeout_seconds=60)
        self.actors = []
        for s in range(S):
            cls = PipelineStage.options(
                num_cpus=cfg.num_cpus_per_stage,
                num_gpus=gpus,
                placement_group=self._pg,
                placement_group_bundle_index=s,
            )
            self.actors.append(
                cls.remote(
                    s, S, cfg.microbatches,
                    self.program.stage_apply[s], self.program.optimizer, cfg.device,
                )
            )
        ray_tpu_torch.get([a.ping.remote() for a in self.actors], timeout=60)
        nodes = self._actor_nodes()
        self._distribute_state(params_full, opt_states, nodes)
        self._wire(nodes)
        self._started = True

    def _actor_nodes(self) -> List[str]:
        from ray_tpu_torch._private.ids import ActorID, NodeID
        from ray_tpu_torch._private.worker import get_global_worker

        worker = get_global_worker()
        want = {a._actor_id: i for i, a in enumerate(self.actors)}
        nodes: Dict[int, str] = {}
        deadline = time.monotonic() + 30.0
        while len(nodes) < len(self.actors) and time.monotonic() < deadline:
            for rec in worker.gcs_client.call("list_actors", None):
                aid = ActorID(rec["actor_id"])
                if aid in want and rec.get("node_id"):
                    nodes[want[aid]] = NodeID(rec["node_id"]).hex()
            if len(nodes) < len(self.actors):
                ray_tpu_torch.get(
                    [a.ping.remote() for a in self.actors], timeout=30
                )
        if len(nodes) < len(self.actors):
            raise StageFailedError("stage actors have no node placement")
        return [nodes[i] for i in range(len(self.actors))]

    def _my_node(self) -> str:
        from ray_tpu_torch._private.worker import get_global_worker

        worker = get_global_worker()
        return worker.node_id.hex() if worker.node_id is not None else ""

    def _distribute_state(self, params_full, opt_states, nodes: List[str]):
        """Fan-out broadcast (write once, S consume-acks) when every
        stage shares the driver's node; per-stage RPC otherwise."""
        my_node = self._my_node()
        if all(n == my_node for n in nodes):
            d = self._driver_ring_dir()
            path = os.path.join(d, f"bcast_{uuid.uuid4().hex[:8]}")
            nbytes = _tree_nbytes(params_full)
            if opt_states:
                nbytes += sum(_tree_nbytes(o) for o in opt_states)
            chan = FanoutChannel(
                path, len(self.actors),
                max_size=max(1 << 20, 2 * nbytes + (1 << 16)), create=True,
            )
            refs = [
                a.read_broadcast.remote(path, i, self.program.split)
                for i, a in enumerate(self.actors)
            ]
            chan.write_value((params_full, opt_states), timeout=60.0)
            ray_tpu_torch.get(refs, timeout=120)
            chan.close()
            chan.unlink()
        else:
            refs = []
            for s, a in enumerate(self.actors):
                refs.append(
                    a.set_state.remote(
                        self.program.split(params_full, s),
                        opt_states[s] if opt_states else None,
                    )
                )
            ray_tpu_torch.get(refs, timeout=120)

    def _driver_ring_dir(self) -> str:
        if self._ring_dir is None:
            self._ring_dir = os.path.join(
                ring_base_dir(), f"ray_tpu_torch_ppd_{uuid.uuid4().hex[:12]}"
            )
            os.makedirs(self._ring_dir, exist_ok=True)
        return self._ring_dir

    def _wire(self, nodes: List[str]):
        """Edges: driver -> act0; act s->s+1; grads s+1->s; driver ->
        tgt(last); last -> result(driver).  Readers create/bind in the
        bind phase; writers open in the start phase."""
        from ray_tpu_torch._private.worker import get_global_worker

        cfg = self.config
        S = cfg.stages
        my_node = self._my_node()
        hosts = node_hosts(get_global_worker())
        cap = cfg.ring_capacity

        # bind phase: per-stage inbound endpoints
        in_specs: List[Dict[str, dict]] = []
        for s in range(S):
            writer_node = my_node if s == 0 else nodes[s - 1]
            spec = {
                "act_in": {
                    "kind": "ring" if writer_node == nodes[s] else "socket",
                    "capacity": cap,
                }
            }
            if s < S - 1:
                spec["grad_in"] = {
                    "kind": "ring" if nodes[s + 1] == nodes[s] else "socket",
                    "capacity": cap,
                }
            if s == S - 1:
                spec["tgt_in"] = {
                    "kind": "ring" if my_node == nodes[s] else "socket",
                    "capacity": cap,
                }
            in_specs.append(spec)
        bound = ray_tpu_torch.get(
            [a.bind.remote(in_specs[s]) for s, a in enumerate(self.actors)],
            timeout=60,
        )
        # Stage ring dirs, remembered driver-side: the kill-path restart
        # never reaches a stage's stop_loop cleanup, and ring files are
        # tmpfs (RAM) — reap them after the kill.  Same-node dirs only;
        # a remote stage's dir is that raylet's teardown to reclaim.
        self._stage_ring_dirs.update(
            os.path.dirname(b[name])
            for s, b in enumerate(bound)
            for name in b
            if in_specs[s][name]["kind"] == "ring"
        )
        # driver's inbound endpoint (result, from last stage)
        if nodes[S - 1] == my_node:
            rpath = os.path.join(self._driver_ring_dir(), "result")
            Channel.create_file(rpath, 1 << 20)
            result_desc = {"role": "write", "kind": "ring", "path": rpath}
            self._chans["result"] = Channel(rpath)
        else:
            lst = SocketListener()
            self._listeners["result"] = lst
            result_desc = {
                "role": "write", "kind": "socket",
                "addr": (hosts.get(my_node, "127.0.0.1"), lst.port),
            }

        def _out_desc(reader: int, name: str) -> dict:
            kind = in_specs[reader][name]["kind"]
            if kind == "ring":
                return {"role": "write", "kind": "ring",
                        "path": bound[reader][name]}
            return {
                "role": "write", "kind": "socket",
                "addr": (hosts.get(nodes[reader], "127.0.0.1"),
                         bound[reader][name]),
            }

        # start phase: full edge map per stage
        refs = []
        for s, a in enumerate(self.actors):
            edges: Dict[str, dict] = {}
            edges["act_in"] = {
                "role": "read", **_in_desc(in_specs[s], bound[s], "act_in")
            }
            if "grad_in" in in_specs[s]:
                edges["grad_in"] = {
                    "role": "read", **_in_desc(in_specs[s], bound[s], "grad_in")
                }
            if "tgt_in" in in_specs[s]:
                edges["tgt_in"] = {
                    "role": "read", **_in_desc(in_specs[s], bound[s], "tgt_in")
                }
            if s < S - 1:
                edges["act_out"] = _out_desc(s + 1, "act_in")
            if s > 0:
                edges["grad_out"] = _out_desc(s - 1, "grad_in")
            if s == S - 1:
                edges["result_out"] = result_desc
            refs.append(a.start.remote(edges))
        ray_tpu_torch.get(refs, timeout=60)

        # driver's outbound endpoints (stage 0 act feed + last-stage tgt)
        self._chans["feed"] = self._open_out(_out_desc(0, "act_in"))
        self._chans["tgt"] = self._open_out(_out_desc(S - 1, "tgt_in"))
        if "result" in self._listeners:
            self._chans["result"] = self._listeners.pop("result").accept(
                "read", timeout=60.0
            )

    def _open_out(self, desc: dict):
        if desc["kind"] == "ring":
            return Channel(desc["path"])
        return dial(tuple(desc["addr"]), "write", timeout=30.0)

    # -- training -------------------------------------------------------
    def train_step(self, tokens: np.ndarray, targets: np.ndarray) -> float:
        """Feed one global batch as M microbatch wire frames, return the
        step's mean loss from the result channel."""
        cfg = self.config
        M = cfg.microbatches
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        per = B // M
        try:
            for j in range(M):
                sl = slice(j * per, (j + 1) * per)
                self._chans["feed"].write_value(
                    np.ascontiguousarray(tokens[sl]), timeout=60.0
                )
                self._chans["tgt"].write_value(
                    np.ascontiguousarray(targets[sl]), timeout=60.0
                )
            while True:
                try:
                    _tag, res = self._chans["result"].read_value(
                        timeout=cfg.step_timeout_s
                    )
                    break
                except ChannelClosed:
                    # A transient drop of the result edge is recoverable
                    # in place; anything else is a stage failure.
                    if not reattach(self._chans["result"]):
                        raise
        except (ChannelClosed, ChannelTimeout, ChannelCorruptionError, OSError) as e:
            raise StageFailedError(
                f"pipeline step failed ({type(e).__name__}: {e}); "
                f"dead stages: {self._dead_stages()}; "
                f"stage errors: {self._stage_errors()}"
            ) from e
        self.steps_done += 1
        return float(res["loss"])

    def run(self, data_fn: Callable[[int], Tuple[np.ndarray, np.ndarray]],
            steps: int) -> List[float]:
        """Drive ``steps`` train steps with checkpoint-restart recovery:
        a stage death restores the whole pipeline from the last
        checkpoint and REPLAYS the steps since (deterministic
        ``data_fn`` -> same final state as an undisturbed run)."""
        cfg = self.config
        if not self._started:
            self.start()
        losses: List[float] = [0.0] * steps
        step = self.steps_done
        while step < steps:
            try:
                if (
                    cfg.checkpoint_every
                    and step > 0
                    and step % cfg.checkpoint_every == 0
                    and (self._ckpt is None or self._ckpt[0] != step)
                ):
                    self.checkpoint()
                tokens, targets = data_fn(step)
                losses[step] = self.train_step(tokens, targets)
                step += 1
            except StageFailedError as e:
                if self.restarts >= cfg.max_restarts:
                    raise
                self.restarts += 1
                ck_step, params_full, opt_states = self._ckpt
                logger.warning(
                    "pipeline stage failure (%s): whole-pipeline restart "
                    "%d/%d from checkpointed step %d", e, self.restarts,
                    cfg.max_restarts, ck_step,
                )
                self._teardown(kill=True)
                self.steps_done = ck_step
                step = ck_step
                self.start(state=(params_full, opt_states))
        return losses

    # -- checkpoint / failure -------------------------------------------
    def checkpoint(self) -> Tuple[int, Any, List[Any]]:
        """Pull (params, opt_state) from every stage at a step boundary
        and retain driver-side as the restart point."""
        # The result channel acks a step when the LAST stage finishes it;
        # earlier stages may still be applying their final optimizer
        # update (the stage_stats race).  Converge step counts first so
        # the checkpoint cuts every stage at the SAME step — a torn
        # checkpoint would replay to a different loss after a restart.
        self.stage_stats()
        states = ray_tpu_torch.get(
            [a.get_state.remote() for a in self.actors], timeout=120
        )
        params_full = self.program.merge([p for p, _ in states])
        opt_states = [o for _, o in states]
        self._ckpt = (self.steps_done, params_full, opt_states)
        if self.config.checkpoint_dir:
            self._persist_ckpt()
        return self._ckpt

    def _persist_ckpt(self) -> None:
        """Snapshot-commit the in-memory restart point under
        ``config.checkpoint_dir`` so a DRIVER restart (not just a stage
        restart) resumes from it; keep-K retention via the plane's GC."""
        import pickle

        from ray_tpu_torch.train import checkpoint_plane

        step, params_full, opt_states = self._ckpt
        dest = os.path.join(
            self.config.checkpoint_dir, f"checkpoint_{step:06d}"
        )
        blob = pickle.dumps(
            {"step": step, "params": params_full, "opt_states": opt_states},
            protocol=5,
        )
        crc = checkpoint_plane.write_file_atomic(dest, "state.pkl", blob)
        checkpoint_plane.commit_manifest(
            dest,
            {"state.pkl": {"crc": crc, "bytes": len(blob)}},
            meta={"step": step, "stages": self.config.stages},
        )
        checkpoint_plane.gc_checkpoints(
            self.config.checkpoint_dir, pinned=[dest]
        )

    def _restore_durable_ckpt(self) -> bool:
        """Adopt the newest VERIFIED durable checkpoint (fallback chain:
        a corrupt/uncommitted newest is skipped, never loaded).  Returns
        True when one was adopted."""
        import pickle

        from ray_tpu_torch.train import checkpoint_plane

        path = checkpoint_plane.resolve_restore(root=self.config.checkpoint_dir)
        if path is None:
            return False
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            state = pickle.load(f)
        self._ckpt = (state["step"], state["params"], state["opt_states"])
        self.steps_done = state["step"]
        logger.info(
            "pipeline resuming from durable checkpoint %s (step %d)",
            path, state["step"],
        )
        return True

    def state_dict(self) -> Any:
        """Merged full-model params (checkpoint interop with the
        single-process / GSPMD paths)."""
        return self.checkpoint()[1]

    def _stage_errors(self) -> Dict[int, str]:
        """Loop errors from stages still answering (advisory; a dead
        stage's error is unreachable and shows up in _dead_stages)."""
        out: Dict[int, str] = {}
        for i, a in enumerate(self.actors):
            try:
                err = ray_tpu_torch.get(a.get_error.remote(), timeout=5)
            except Exception:  # noqa: BLE001 — advisory
                continue
            if err:
                out[i] = err
        return out

    def _dead_stages(self) -> List[int]:
        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch._private.worker import get_global_worker

        dead = []
        try:
            states = {
                ActorID(a["actor_id"]): a.get("state")
                for a in get_global_worker().gcs_client.call(
                    "list_actors", None
                )
            }
            for i, a in enumerate(self.actors):
                if states.get(a._actor_id) == "DEAD":
                    dead.append(i)
        except Exception:  # noqa: BLE001 — advisory
            pass
        return dead

    def stage_stats(self) -> List[dict]:
        """Per-stage counters.  The result channel acks a step when the
        LAST stage finishes it, so earlier stages can still be inside
        their final backward/optimizer update when the driver asks —
        poll (bounded) until every stage has reached the same step
        count before returning."""
        from ray_tpu_torch._private import retry

        bo = retry.POLL.start(deadline_s=15.0)
        while True:
            stats = ray_tpu_torch.get(
                [a.get_stats.remote() for a in self.actors], timeout=30
            )
            counts = {s["steps"] for s in stats}
            if len(counts) == 1:
                return stats
            delay = bo.next_delay()
            if delay is None:
                return stats
            time.sleep(delay)

    def _teardown(self, kill: bool = False):
        for chan in self._chans.values():
            try:
                chan.close()
            except Exception:  # noqa: BLE001
                pass
        self._chans.clear()
        for lst in self._listeners.values():
            lst.close()
        self._listeners.clear()
        if not kill:
            for a in self.actors:
                try:
                    ray_tpu_torch.get(a.stop_loop.remote(), timeout=30)
                except Exception:  # noqa: BLE001
                    pass
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        self.actors = []
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
            self._pg = None
        if self._ring_dir:
            import shutil

            shutil.rmtree(self._ring_dir, ignore_errors=True)
            self._ring_dir = None
        if self._stage_ring_dirs:
            import shutil

            for d in self._stage_ring_dirs:
                shutil.rmtree(d, ignore_errors=True)
            self._stage_ring_dirs = set()
        self._started = False

    def stop(self):
        self._teardown(kill=False)


def _in_desc(spec: Dict[str, dict], bound: Dict[str, Any], name: str) -> dict:
    if spec[name]["kind"] == "ring":
        return {"kind": "ring", "path": bound[name]}
    return {"kind": "socket"}  # accept on the listener bound in bind()


def _tree_nbytes(tree: Any) -> int:
    """Bytes of the arrays and tensors in a host tree (nested dicts and
    lists)."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0))
