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

The reference's streaming fragment path (``update_from_fragments``,
``prepare_fragments``, ``fragment_loss``) belongs to the podracer plane,
ROADMAP Queue A item 5(b); it raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

PODRACER_ITEM = "ROADMAP.md Queue A item 5(b), the podracer streaming plane"


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

        from ray_tpu_torch._private.device import resolve_device

        self.config = config or {}
        self.module_spec = module_spec
        self.device = resolve_device(self.config.get("device", "cuda"))
        if self.device.type == "cuda":
            # float32 means float32: the CPU learner is its reference
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._gen = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        self.module = module_spec.build(self._gen).to(self.device)
        self.grad_clip = self.config.get("grad_clip", None)
        # optax.adam's defaults; torch's Adam takes the same step
        self.optimizer = torch.optim.Adam(
            self.module.parameters(), lr=self.config.get("lr", 5e-5),
            betas=(0.9, 0.999), eps=1e-8,
        )
        self._metrics: Dict[str, float] = {}

    # -- subclass API ----------------------------------------------------
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
        import torch

        return {k: torch.as_tensor(np.asarray(v)[idx]).to(self.device) for k, v in batch.items()}

    def _step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One loss -> gradient -> Adam step; metrics stay tensors."""
        import torch

        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.compute_loss(batch)
        loss.backward()
        grads = [p.grad for p in self.module.parameters() if p.grad is not None]
        grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if self.grad_clip:
            # optax.clip_by_global_norm: g / norm * clip once norm >= clip
            # (clip_grad_norm_ would add 1e-6 to the norm)
            clipping = grad_norm >= self.grad_clip
            for g in grads:
                g.copy_(torch.where(clipping, g / grad_norm * self.grad_clip, g))
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
        import torch

        self.before_update(batch)
        count = batch.count
        mb = min(minibatch_size, count)
        idx = _pad_rows(count, mb)
        padded = len(idx)
        n_mb = max(1, padded // mb)
        take = n_mb * mb
        rows = self._to_device(batch, idx)
        perms = torch.stack([torch.randperm(padded, generator=self._gen)[:take]
                             for _ in range(num_epochs)]).to(self.device)
        metrics: Dict[str, Any] = {}
        for perm in perms:
            for j in range(n_mb):
                sel = perm[j * mb:(j + 1) * mb]
                metrics = self._step({k: v[sel] for k, v in rows.items()})
        return self._finish(metrics)

    def update_from_fragments(self, frags, minibatch_size=None, num_epochs: int = 1):
        raise NotImplementedError(f"update_from_fragments: {PODRACER_ITEM}")

    def prepare_fragments(self, cols, last_values):
        raise NotImplementedError(f"prepare_fragments: {PODRACER_ITEM}")

    def fragment_loss(self, cols, last_values):
        raise NotImplementedError(f"fragment_loss: {PODRACER_ITEM}")

    # -- weights / checkpoints ------------------------------------------
    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.module.get_weights()

    def set_weights(self, weights):
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
        raise NotImplementedError(f"update_from_fragments: {PODRACER_ITEM}")

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
