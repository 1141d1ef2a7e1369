"""Replay buffers (reference: rllib/utils/replay_buffers/ —
ReplayBuffer, PrioritizedEpisodeReplayBuffer).  Columnar numpy storage so
`sample()` hands the learner a contiguous batch without Python loops
over transitions."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform ring buffer over transition columns."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch):
        n = batch.count
        if n == 0:
            return
        if not self._cols:
            for k, v in batch.items():
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:], dtype=v.dtype)
        for k, col in self._cols.items():
            v = batch[k]
            end = self._idx + n
            if end <= self.capacity:
                col[self._idx:end] = v
            else:  # wrap
                first = self.capacity - self._idx
                col[self._idx:] = v[:first]
                col[: end % self.capacity] = v[first:]
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.integers(0, self._size, batch_size)
        return SampleBatch({k: col[idx] for k, col in self._cols.items()})

    def stats(self) -> dict:
        return {"size": self._size, "capacity": self.capacity}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (PER, Schaul et al.) with a numpy
    sum-tree (reference: rllib prioritized replay)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6, beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        # binary-heap-layout sum tree: leaves [cap, 2*cap)
        self._tree_cap = 1
        while self._tree_cap < capacity:
            self._tree_cap *= 2
        self._tree = np.zeros(2 * self._tree_cap, dtype=np.float64)
        self._max_prio = 1.0
        self._last_idx: Optional[np.ndarray] = None

    def _tree_set(self, leaf_idx: np.ndarray, values: np.ndarray):
        self._tree[leaf_idx + self._tree_cap] = values
        pos = np.unique((leaf_idx + self._tree_cap) // 2)
        while pos.size:
            self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]
            pos = np.unique(pos // 2)
            pos = pos[pos >= 1]
            if pos.size == 1 and pos[0] == 1:
                self._tree[1] = self._tree[2] + self._tree[3]
                break

    def add(self, batch: SampleBatch):
        n = batch.count
        start = self._idx
        super().add(batch)
        leaf = (start + np.arange(n)) % self.capacity
        self._tree_set(leaf, np.full(n, self._max_prio ** self.alpha))

    def sample(self, batch_size: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        total = self._tree[1]
        targets = self._rng.uniform(0, total, batch_size)
        idx = np.empty(batch_size, dtype=np.int64)
        for i, t in enumerate(targets):  # log-depth descents
            pos = 1
            while pos < self._tree_cap:
                left = 2 * pos
                if t <= self._tree[left]:
                    pos = left
                else:
                    t -= self._tree[left]
                    pos = left + 1
            idx[i] = pos - self._tree_cap
        idx = np.minimum(idx, self._size - 1)
        self._last_idx = idx
        batch = SampleBatch({k: col[idx] for k, col in self._cols.items()})
        probs = self._tree[idx + self._tree_cap] / max(total, 1e-12)
        weights = (self._size * probs) ** (-self.beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        batch["batch_indexes"] = idx
        return batch

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        priorities = np.abs(priorities) + 1e-6
        self._max_prio = max(self._max_prio, float(priorities.max()))
        self._tree_set(np.asarray(idx), priorities ** self.alpha)
