"""OfflineData: the single entry point offline algorithms (BC, MARWIL,
CQL) use to turn recorded experience into train batches (reference:
rllib/offline/offline_data.py — OfflineData.__init__ builds a Ray
Dataset from config.input_, sample() returns train batches;
json_reader.py / json_writer.py for the JSONL wire format).

Accepted inputs:
  * a ``ray_tpu_torch.data`` Dataset (rows are per-timestep dicts),
  * a list of per-timestep dict rows,
  * a SampleBatch,
  * a path: a JSONL file, a directory of JSONL files, or a parquet
    file/directory (read through ray_tpu_torch.data.read_parquet).

Derived columns are computed once, vectorized over episodes:
  * ``ensure_next_obs()``    — NEXT_OBS by shifting obs inside episodes
    (Q-learning family: CQL needs (s, a, r, s')).
  * ``ensure_value_targets(gamma)`` — per-episode discounted
    returns-to-go into VALUE_TARGETS (MARWIL's regression target).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    EPS_ID,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
    TRUNCATEDS,
    VALUE_TARGETS,
)


class OfflineData:
    """Materialized, columnar offline dataset with batch sampling."""

    def __init__(self, input_: Any, *, shuffle_seed: int = 0):
        self.batch = _materialize(input_)
        if self.batch.count == 0:
            raise ValueError("offline input is empty")
        self._rng = np.random.default_rng(shuffle_seed)

    @property
    def count(self) -> int:
        return self.batch.count

    def __len__(self) -> int:
        return self.count

    # -- derived columns -------------------------------------------------
    def ensure_next_obs(self) -> "OfflineData":
        """Attach NEXT_OBS by shifting OBS one step within each episode.

        The last row of an episode keeps its own obs as next_obs; its
        TERMINATEDS flag already zeroes the bootstrap so the value is
        never read by a correct Bellman target.
        """
        if NEXT_OBS in self.batch:
            return self
        obs = np.asarray(self.batch[OBS])
        next_obs = np.concatenate([obs[1:], obs[-1:]], axis=0)
        ends = self._episode_ends()
        next_obs[ends] = obs[ends]
        self.batch[NEXT_OBS] = next_obs
        return self

    def ensure_value_targets(self, gamma: float) -> "OfflineData":
        """Attach per-episode discounted returns-to-go as VALUE_TARGETS."""
        if VALUE_TARGETS in self.batch:
            return self
        rew = np.asarray(self.batch[REWARDS], np.float32)
        targets = np.empty_like(rew)
        start = 0
        for end in self._episode_ends():
            acc = 0.0
            for t in range(end, start - 1, -1):
                acc = rew[t] + gamma * acc
                targets[t] = acc
            start = end + 1
        self.batch[VALUE_TARGETS] = targets
        return self

    def _episode_ends(self) -> np.ndarray:
        """Indices of the last row of each episode."""
        n = self.batch.count
        if EPS_ID in self.batch:
            ids = np.asarray(self.batch[EPS_ID])
            ends = np.where(ids[1:] != ids[:-1])[0]
            return np.concatenate([ends, [n - 1]])
        done = np.asarray(self.batch[TERMINATEDS], bool)
        if TRUNCATEDS in self.batch:
            done = done | np.asarray(self.batch[TRUNCATEDS], bool)
        ends = np.where(done)[0]
        if len(ends) == 0 or ends[-1] != n - 1:
            ends = np.concatenate([ends, [n - 1]])
        return ends

    # -- sampling --------------------------------------------------------
    def sample(self, n: int) -> SampleBatch:
        """Uniform sample of ``n`` rows (with replacement iff n > count)."""
        count = self.count
        idx = (
            self._rng.integers(0, count, n)
            if n > count
            else self._rng.choice(count, n, replace=False)
        )
        return self.batch.select(idx)

    def items(self):
        return self.batch.items()

    def __getitem__(self, key):
        return self.batch[key]


def _materialize(input_: Any) -> SampleBatch:
    """Flatten any accepted input into one columnar SampleBatch."""
    if input_ is None:
        raise ValueError("offline_data(input_=...) is required")
    if isinstance(input_, OfflineData):
        return input_.batch
    if isinstance(input_, SampleBatch):
        return input_
    if hasattr(input_, "take_all"):  # ray_tpu_torch.data Dataset
        return _rows_to_batch(input_.take_all())
    if isinstance(input_, (list, tuple)):
        return _rows_to_batch(list(input_))
    if isinstance(input_, str):
        return _read_path(input_)
    raise TypeError(f"unsupported offline input type {type(input_).__name__}")


def _read_path(path: str) -> SampleBatch:
    names = (
        sorted(os.path.join(path, f) for f in os.listdir(path))
        if os.path.isdir(path)
        else [path]
    )
    if any(n.endswith(".parquet") for n in names):
        from ray_tpu_torch import data as rt_data

        return _rows_to_batch(rt_data.read_parquet(path).take_all())
    rows: List[dict] = []
    for p in names:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
    return _rows_to_batch(rows)


def _rows_to_batch(rows: List[dict]) -> SampleBatch:
    if not rows:
        return SampleBatch({OBS: np.zeros((0, 1)), ACTIONS: np.zeros((0,))})
    cols = {k: np.asarray([r[k] for r in rows]) for k in rows[0].keys()}
    return SampleBatch(cols)


def module_spec_from_offline(cfg, dataset: "OfflineData"):
    """RLModuleSpec from the configured env when present, else inferred
    from the dataset's obs/actions columns (shared by BC and MARWIL;
    reference: offline_prelearner.py deriving spaces from recorded
    episodes when no env is given)."""
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    hidden = tuple(cfg.model.get("hidden", (64, 64)))
    if cfg.env is not None or cfg.env_creator is not None:
        probe = cfg.make_env_creator()()
        spec = RLModuleSpec.from_gym_env(probe, hidden=hidden)
        probe.close()
        return spec
    obs = np.asarray(dataset[OBS])
    acts = np.asarray(dataset[ACTIONS])
    discrete = np.issubdtype(acts.dtype, np.integer)
    return RLModuleSpec(
        observation_dim=int(np.prod(obs.shape[1:])),
        action_dim=int(acts.max()) + 1 if discrete else int(np.prod(acts.shape[1:])),
        discrete=discrete,
        hidden=hidden,
    )


class JsonWriter:
    """Append SampleBatches as JSONL rows, sharded by size (reference:
    rllib/offline/json_writer.py — max_file_size sharding)."""

    def __init__(self, path: str, *, max_rows_per_shard: int = 100_000):
        self.path = path
        self.max_rows = max_rows_per_shard
        os.makedirs(path, exist_ok=True)
        self._shard = 0
        self._rows_in_shard = 0
        self._fh = None

    def _open_next(self):
        if self._fh is not None:
            self._fh.close()
        name = os.path.join(self.path, f"shard-{self._shard:05d}.jsonl")
        self._fh = open(name, "a")
        self._shard += 1
        self._rows_in_shard = 0

    def write(self, batch: SampleBatch) -> None:
        if self._fh is None or self._rows_in_shard >= self.max_rows:
            self._open_next()
        keys = list(batch.keys())
        arrays = [np.asarray(batch[k]) for k in keys]
        for i in range(batch.count):
            row = {k: _jsonable(a[i]) for k, a in zip(keys, arrays)}
            self._fh.write(json.dumps(row) + "\n")
            self._rows_in_shard += 1
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def record_rollouts(
    env_creator: Callable[[], Any],
    action_fn: Callable[[np.ndarray], Any],
    *,
    num_steps: int,
    output_path: Optional[str] = None,
    seed: int = 0,
) -> SampleBatch:
    """Collect (s, a, r, s', done) transitions with ``action_fn`` and
    optionally persist them as JSONL (reference:
    rllib/offline/offline_env_runner.py — an env runner whose sample()
    writes episodes instead of returning them).

    ``action_fn(obs) -> action`` drives a single (non-vector) env; use a
    scripted/random policy to build behavior datasets for BC/MARWIL/CQL
    tests and demos.  Returns the recorded batch (also written to
    ``output_path`` when given).
    """
    env = env_creator()
    obs, _ = env.reset(seed=seed)
    cols: Dict[str, list] = {
        OBS: [], ACTIONS: [], REWARDS: [], NEXT_OBS: [],
        TERMINATEDS: [], TRUNCATEDS: [], EPS_ID: [],
    }
    eps = 0
    for _ in range(num_steps):
        a = action_fn(np.asarray(obs))
        next_obs, r, term, trunc, _ = env.step(a)
        cols[OBS].append(np.asarray(obs))
        cols[ACTIONS].append(a)
        cols[REWARDS].append(float(r))
        cols[NEXT_OBS].append(np.asarray(next_obs))
        cols[TERMINATEDS].append(bool(term))
        cols[TRUNCATEDS].append(bool(trunc))
        cols[EPS_ID].append(eps)
        if term or trunc:
            eps += 1
            obs, _ = env.reset(seed=seed + eps)
        else:
            obs = next_obs
    env.close()
    batch = SampleBatch({k: np.asarray(v) for k, v in cols.items()})
    if output_path is not None:
        w = JsonWriter(output_path)
        w.write(batch)
        w.close()
    return batch
