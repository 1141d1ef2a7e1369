"""Learner + LearnerGroup (reference: rllib/core/learner/learner.py:109 —
compute_gradients :442, update_from_batch :948; learner_group.py:81).

The port's Learner owns an RLModule on ``config["device"]`` (``cuda``
unless the caller says ``cpu``) and takes each minibatch update as one
eager loss -> backward -> Adam step.  Adam follows optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))``, the reference's
optimizer, written out: the clip scales every gradient by
``grad_clip / norm`` when the global norm reaches ``grad_clip``.  One
``torch.Generator`` seeded from ``config["seed"]`` draws the initial
weights and then the epoch permutations, both on the CPU, so a learner on
the card and one on the CPU start from the same weights and take the
same minibatches.

The streaming fragment path (``update_from_fragments``, the podracer
plane's update) takes ``[K, T, N]`` fragments, merges them time-major and
either steps on the time-major columns (``fragment_loss``, V-trace) or
derives training rows (``prepare_fragments``, PPO's GAE) and runs the
epoch schedule over them.  The reference fuses all of it into one jitted
dispatch; here it is eager torch on the learner's device.

Every optimizer step holds the learner's weight lock, and
``get_weights`` takes it: a thread that steps the learner (IMPALA's
``LearnerThread``) and a driver that reads weights for a broadcast never
see half an Adam step.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def learner_device(device: str = "cuda"):
    """The ``torch.device`` a learner updates on: a card by index (a
    learner may step on another thread), with TF32 off so that float32
    means float32 and the CPU learner stays its reference.  Raises when
    ``cuda`` is asked for without a card."""
    import torch

    from ray_tpu_torch._private.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def batch_tensor(value, device):
    """A batch column as a tensor on ``device``; float64 becomes float32,
    as the reference's arrays do (JAX without x64), so rows read from
    JSON or Python floats feed a float32 module."""
    import torch

    a = np.asarray(value)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device)


def _pad_rows(count: int, multiple: int) -> np.ndarray:
    """Row indices that cycle ``count`` rows up to a multiple of
    ``multiple``."""
    padded = ((count + multiple - 1) // multiple) * multiple
    return np.arange(padded) % count


class Learner:
    """Owns the module + optimizer state; subclasses define the loss.

    Losses that treat the batch's row axis as a TIME axis must set
    ``preserve_time_order = True``: it routes updates through the
    order-preserving single-step path and disables pad-by-cycling."""

    preserve_time_order = False

    def __init__(self, module_spec, config: Optional[Dict[str, Any]] = None):
        import torch

        self.config = config or {}
        self.module_spec = module_spec
        self.device = learner_device(self.config.get("device", "cuda"))
        self._gen = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        self.module = self.build_module().to(self.device)
        self.grad_clip = self.config.get("grad_clip", None)
        # optax.adam's defaults; torch's Adam takes the same step
        self.optimizer = torch.optim.Adam(
            self.module.parameters(), lr=self.config.get("lr", 5e-5),
            betas=(0.9, 0.999), eps=1e-8,
        )
        self._metrics: Dict[str, float] = {}
        # held by every parameter update and by get_weights
        self._weights_lock = threading.Lock()

    # -- subclass API ----------------------------------------------------
    def build_module(self):
        """The module this learner trains, on the CPU, its weights drawn
        from the learner's generator (DQN's learner builds its Q-net)."""
        return self.module_spec.build(self._gen)

    def compute_loss(self, batch: Dict[str, Any]) -> Any:
        """Return (loss_scalar, metrics_dict) for a dict of tensors on the
        learner's device."""
        raise NotImplementedError

    def before_update(self, batch) -> None:
        """Hook run before EVERY update (single or epochs): mutate
        `batch` to attach derived columns."""

    def after_update(self) -> None:
        """Hook run after every update (target syncs etc.)."""

    # -- update ----------------------------------------------------------
    def _to_device(self, batch, idx: np.ndarray) -> Dict[str, Any]:
        return {k: batch_tensor(np.asarray(v)[idx], self.device) for k, v in batch.items()}

    def _step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One loss -> gradient -> Adam step on ``compute_loss``."""
        return self._descend(lambda: self.compute_loss(batch))

    def _descend(self, loss_fn: Callable[[], Any]) -> Dict[str, Any]:
        """One loss -> gradient -> Adam step on ``loss_fn()``'s (loss,
        metrics); metrics stay tensors."""
        import torch

        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn()
        loss.backward()
        grads = [p.grad for p in self.module.parameters() if p.grad is not None]
        grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if self.grad_clip:
            # optax.clip_by_global_norm: g / norm * clip once norm >= clip
            # (clip_grad_norm_ would add 1e-6 to the norm)
            clipping = grad_norm >= self.grad_clip
            for g in grads:
                g.copy_(torch.where(clipping, g / grad_norm * self.grad_clip, g))
        with self._weights_lock:
            self.optimizer.step()
        metrics = dict(metrics)
        metrics["total_loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm.detach()  # before clipping
        return metrics

    def _finish(self, metrics: Dict[str, Any]) -> Dict[str, float]:
        self._metrics = {k: float(v) for k, v in metrics.items()}
        self.after_update()
        return self._metrics

    def update_from_batch(self, batch) -> Dict[str, float]:
        """One gradient step on one (mini)batch (reference:
        learner.py:948).

        Rows are padded (cycling) up to a multiple of 32, as the
        reference pads them to reuse one compiled program: the padding
        changes the loss's mean, so the port keeps it."""
        self.before_update(batch)
        count = batch.count
        idx = np.arange(count) if self.preserve_time_order else _pad_rows(count, 32)
        return self._finish(self._step(self._to_device(batch, idx)))

    def update_from_batch_epochs(
        self, batch, minibatch_size: int, num_epochs: int
    ) -> Dict[str, float]:
        """The epoch x minibatch SGD schedule (reference: the fused
        ``_epochs_schedule``): the batch padded by cycling to a multiple
        of the minibatch, then each epoch a fresh permutation of the
        padded rows from the learner's generator, truncated to whole
        minibatches and walked in order.  Reports the last minibatch's
        metrics."""
        self.before_update(batch)
        count = batch.count
        mb = min(minibatch_size, count)
        idx = _pad_rows(count, mb)
        return self._finish(self._epochs(self._to_device(batch, idx), len(idx), mb, num_epochs))

    def _epochs(self, rows: Dict[str, Any], count: int, mb: int, num_epochs: int) -> Dict[str, Any]:
        """The reference's ``_epochs_schedule`` over ``count`` rows on the
        device: each epoch a fresh permutation from the learner's
        generator, truncated to whole minibatches of ``mb`` and walked in
        order.  Returns the last minibatch's metrics."""
        import torch

        n_mb = max(1, count // mb)
        take = n_mb * mb
        perms = torch.stack([torch.randperm(count, generator=self._gen)[:take]
                             for _ in range(num_epochs)]).to(self.device)
        metrics: Dict[str, Any] = {}
        for perm in perms:
            for j in range(n_mb):
                sel = perm[j * mb:(j + 1) * mb]
                metrics = self._step({k: v[sel] for k, v in rows.items()})
        return metrics

    # -- streaming-fragment update (podracer plane) ----------------------
    # Fragments arrive as fixed-shape [T, N] time-major columns (see
    # env_runner._collect_fragment); everything the synchronous path did
    # on the host — GAE / V-trace targets, concat, standardize, the
    # minibatch schedule — happens here on the learner's device.

    def prepare_fragments(self, cols: Dict[str, Any], last_values) -> Dict[str, Any]:
        """Hook (non-time-order learners): derive training columns from
        time-major [T, B] fragment tensors + [B] bootstrap values.  Must
        return a dict of [T, B, ...] tensors ready to flatten into SGD
        rows.  PPO computes GAE + masked standardization here."""
        raise NotImplementedError

    def fragment_loss(self, cols: Dict[str, Any], last_values):
        """Hook (preserve_time_order learners): loss directly on the
        time-major [T, B] columns (IMPALA's V-trace scan).  Returns
        (loss, metrics)."""
        raise NotImplementedError

    @staticmethod
    def _merge_time_major(x):
        """[K, T, N, ...] -> [T, K*N, ...]: fragments from any mix of
        runners concat along the batch axis."""
        x = x.movedim(0, 1)
        return x.reshape(x.shape[0], x.shape[1] * x.shape[2], *x.shape[3:])

    def update_from_fragments(
        self, frags: List[dict], minibatch_size: Optional[int] = None, num_epochs: int = 1
    ) -> Dict[str, float]:
        """One update from a batch of streamed trajectory fragments:
        advantage targets, concat and the whole epoch x minibatch
        schedule on the learner's device.  A time-order learner takes
        ``num_epochs`` Adam steps on the merged time-major columns; any
        other derives rows with ``prepare_fragments`` and runs the epoch
        schedule over the K*T*N rows (no padding)."""
        import torch

        if not frags:
            raise ValueError("update_from_fragments needs at least one fragment")
        keys = frags[0]["cols"].keys()
        cols = {
            k: torch.as_tensor(np.stack([np.asarray(f["cols"][k]) for f in frags])).to(self.device)
            for k in keys
        }
        last_values = torch.as_tensor(
            np.stack([np.asarray(f["last_values"]) for f in frags])).to(self.device)
        K, T, N = last_values.shape[0], *next(iter(cols.values())).shape[1:3]
        tm = {k: self._merge_time_major(v) for k, v in cols.items()}
        last = last_values.reshape(-1)
        if self.preserve_time_order:
            metrics: Dict[str, Any] = {}
            for _ in range(num_epochs):
                metrics = self._descend(lambda: self.fragment_loss(tm, last))
        else:
            count = K * T * N
            with torch.no_grad():
                prepared = self.prepare_fragments(tm, last)
            rows = {k: v.reshape((count,) + tuple(v.shape[2:])) for k, v in prepared.items()}
            metrics = self._epochs(rows, count, min(minibatch_size or count, count), num_epochs)
        return self._finish(metrics)

    # -- weights / checkpoints ------------------------------------------
    def get_weights(self) -> Dict[str, np.ndarray]:
        """One generation's weights as numpy: taken under the weight lock,
        so never between two halves of an optimizer step."""
        with self._weights_lock:
            return self.module.get_weights()

    def set_weights(self, weights):
        with self._weights_lock:
            self.module.set_weights(weights)

    def get_state(self) -> Dict[str, Any]:
        """Weights and Adam's moments as numpy (a checkpoint from the card
        loads on the CPU), by parameter name."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        opt = {}
        for p, s in self.optimizer.state.items():
            opt[names[id(p)]] = {k: (v.detach().cpu().numpy().copy() if hasattr(v, "detach") else v)
                                 for k, v in s.items()}
        return {"weights": self.get_weights(), "opt_state": opt, "config": self.config}

    def set_state(self, state: Dict[str, Any]):
        import torch

        self.set_weights(state["weights"])
        params = dict(self.module.named_parameters())
        self.optimizer.state.clear()
        for name, s in state["opt_state"].items():
            p = params[name]
            self.optimizer.state[p] = {
                # Adam keeps "step" as a CPU float32 tensor
                k: (torch.as_tensor(np.asarray(v)).to(p.device) if k != "step"
                    else torch.as_tensor(np.asarray(v), dtype=torch.float32))
                for k, v in s.items()
            }

    def metrics(self) -> Dict[str, float]:
        return self._metrics


class LearnerGroup:
    """Drives one or more Learner workers (reference: learner_group.py:81).

    num_learners == 0 -> the learner runs inline in the calling process
    (the driver, or a Tune trial's actor), on its device.  num_learners
    >= 1 -> remote learner actors, each leasing one ``GPU`` beside its
    CPUs when its device is ``cuda``; batches are sharded between them
    and rank 0's weights are read back (the reference's semantics)."""

    def __init__(self, learner_cls, module_spec, config: Optional[dict] = None, num_learners: int = 0, resources: Optional[dict] = None):
        import ray_tpu_torch

        self.config = config or {}
        self._local: Optional[Learner] = None
        self._workers: List[Any] = []
        if num_learners <= 0:
            self._local = learner_cls(module_spec, self.config)
        else:
            opts = dict(resources or {"num_cpus": 1})
            if str(self.config.get("device", "cuda")).startswith("cuda"):
                opts.setdefault("num_gpus", 1)
            remote_cls = ray_tpu_torch.remote(**opts)(learner_cls)
            self._workers = [remote_cls.remote(module_spec, self.config) for _ in range(num_learners)]

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def update_from_batch(self, batch, minibatch_size: Optional[int] = None, num_epochs: int = 1) -> Dict[str, float]:
        """Epoch/minibatch SGD driver (reference: Learner minibatch loop)."""
        import ray_tpu_torch

        if self._local is not None:
            if self._local.preserve_time_order:
                # temporal losses: no permutation, no minibatching
                last: Dict[str, float] = {}
                for _ in range(num_epochs):
                    last = self._local.update_from_batch(batch)
                return last
            return self._local.update_from_batch_epochs(
                batch, minibatch_size or batch.count, num_epochs
            )
        # remote: shard the batch across learner actors
        n = len(self._workers)
        shard = max(1, batch.count // n)
        refs = []
        for i, w in enumerate(self._workers):
            sub = batch.slice(i * shard, batch.count if i == n - 1 else (i + 1) * shard)
            refs.append(w.update_from_batch.remote(sub))
        results = ray_tpu_torch.get(refs)
        return results[0]

    def update_from_fragments(self, frags, minibatch_size: Optional[int] = None, num_epochs: int = 1) -> Dict[str, float]:
        """Streaming update (podracer plane).  The learner lives in the
        driver process (num_learners=0); remote learner actors would put
        the object store back on the hot path the channel plane exists to
        avoid."""
        if self._local is None:
            raise ValueError(
                "the podracer streaming plane requires a local learner "
                "(num_learners=0)"
            )
        return self._local.update_from_fragments(frags, minibatch_size, num_epochs)

    def get_weights(self):
        import ray_tpu_torch

        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._workers[0].get_weights.remote())

    def set_weights(self, weights):
        import ray_tpu_torch

        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([w.set_weights.remote(weights) for w in self._workers])

    def get_state(self):
        import ray_tpu_torch

        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._workers[0].get_state.remote())

    def set_state(self, state):
        import ray_tpu_torch

        if self._local is not None:
            self._local.set_state(state)
        else:
            ray_tpu_torch.get([w.set_state.remote(state) for w in self._workers])

    def shutdown(self):
        import ray_tpu_torch

        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []
