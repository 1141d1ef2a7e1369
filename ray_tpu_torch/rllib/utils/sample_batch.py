"""SampleBatch: columnar container for trajectories (reference:
python/ray/rllib/policy/sample_batch.py — dict of arrays with
concat/slice/shuffle/minibatch utilities)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

OBS = "obs"
NEXT_OBS = "next_obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"
# 0.0 on rows kept only for shape stability (autoreset rows in V-trace
# batches); losses must exclude them.
LOSS_MASK = "loss_mask"


class SampleBatch(dict):
    """dict[str, np.ndarray] with equal first dimensions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def __len__(self) -> int:  # len(batch) == timestep count, not key count
        return self.count

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def select(self, idx: np.ndarray) -> "SampleBatch":
        return SampleBatch({k: v[idx] for k, v in self.items()})

    def shuffle(self, rng: Optional[np.random.Generator] = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.count)
        return self.select(perm)

    def minibatches(self, size: int, rng: Optional[np.random.Generator] = None) -> Iterator["SampleBatch"]:
        """Shuffled, trailing remainder dropped (every minibatch has the
        same shape)."""
        b = self.shuffle(rng)
        n = self.count
        for start in range(0, n - size + 1, size):
            yield b.slice(start, start + size)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({k: np.concatenate([b[k] for b in batches], axis=0) for k in keys})

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        out = []
        ids = self[EPS_ID]
        boundaries = np.where(ids[1:] != ids[:-1])[0] + 1
        start = 0
        for b in list(boundaries) + [len(ids)]:
            out.append(self.slice(start, b))
            start = b
        return out
