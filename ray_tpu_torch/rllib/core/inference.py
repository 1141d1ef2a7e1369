"""Sebulba-split inference server: one actor owns the policy on the
learner-side device and serves action selection for EVERY env runner in
continuous batches (PAPERS.md "Podracer architectures" — the sebulba
configuration separates acting hardware from stepping hardware for
policies too heavy to evaluate inside a CPU env runner).

Batching rides the serve plane's ``@serve.batch`` machinery: the actor is
async (the decorator's queue coalesces concurrent runner calls within a
2 ms window), one forward on the server's device serves the coalesced
batch, and results are split back per caller.  Weights arrive
generation-tagged from the learner (`set_weights`); every response
carries the generation so fragments inherit the staleness bookkeeping
with no extra channel.

The module lives on ``device`` (``cuda`` unless the caller asks for
``cpu``; without a card ``cuda`` raises).  Exploration draws from a
``torch.Generator`` on that device, seeded as the reference's key
(``seed * 9973 + 17``).  Observations arrive and results leave as numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ray_tpu_torch.serve.batching import batch


class InferenceServer:
    """Created via ``ray_tpu_torch.remote(...)(InferenceServer).remote(
    spec, seed, device)``; env runners call ``compute_actions`` once per
    vector-env step and the batcher coalesces across runners."""

    def __init__(self, module_spec, seed: int = 0, device: str = "cuda"):
        import torch

        from ray_tpu_torch._private.device import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            # float32 means float32, as on the learner
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.module = module_spec.build().to(self.device).eval()
        self._weights_set = False
        self.generation = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed * 9973 + 17)

    def set_weights(self, weights, generation: int) -> int:
        self.module.set_weights(weights)
        self._weights_set = True
        self.generation = int(generation)
        return self.generation

    def ping(self) -> str:
        return "pong"

    @batch(max_batch_size=32, batch_wait_timeout_s=0.002)
    async def _batched_forward(self, items):
        """items: list of (obs_batch, explore).  One concat -> one
        forward -> split by caller sizes.  Mixed explore flags split into
        at most two device calls (runners normally agree)."""
        import torch

        assert self._weights_set, "set_weights before compute_actions"
        out = [None] * len(items)
        for explore_flag in (True, False):
            idx = [i for i, (_o, e) in enumerate(items) if e == explore_flag]
            if not idx:
                continue
            obs = np.concatenate([np.asarray(items[i][0]) for i in idx], axis=0)
            with torch.no_grad():
                if explore_flag:
                    actions, logp, value = self.module.forward_exploration(obs, self._gen)
                    logp = logp.cpu().numpy().astype(np.float32)
                else:
                    actions, value = self.module.forward_inference(obs)
                    logp = np.zeros(obs.shape[0], np.float32)
                actions = actions.cpu().numpy()
                value = value.cpu().numpy().astype(np.float32)
            start = 0
            for i in idx:
                n = len(np.asarray(items[i][0]))
                out[i] = (
                    actions[start : start + n],
                    logp[start : start + n],
                    value[start : start + n],
                    self.generation,
                )
                start += n
        return out

    async def compute_actions(
        self, obs, explore: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """One runner's vector-env step worth of observations ->
        (actions, logp, values, weight_generation)."""
        return await self._batched_forward((obs, explore))
