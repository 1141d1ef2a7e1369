"""BC — offline Behavior Cloning (reference: rllib/algorithms/bc/bc.py +
bc_catalog / MARWIL's beta=0 special case: supervised -logp(a|s) on a
recorded dataset, no environment interaction).

Offline data flows through ray_tpu_torch.data: ``config.offline_data(input_=...)``
accepts a Dataset, a list of SampleBatch-like dicts, or a path of JSON
rows (reference: rllib/offline/offline_data.py reading via Ray Data).
The learner is the standard Learner with a log-likelihood loss on the
learner's device (``cuda`` by default), so the epoch x minibatch
schedule applies unchanged."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.utils.sample_batch import ACTIONS, OBS, SampleBatch


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 2048
        self.minibatch_size = 256
        self.num_epochs = 1
        self.input_: Any = None  # Dataset | list[dict] | path
        self.num_env_runners = 0

    def offline_data(self, *, input_: Any = None):
        if input_ is not None:
            self.input_ = input_
        return self

    @property
    def algo_class(self):
        return BC


class BCLearner(Learner):
    def compute_loss(self, batch: Dict[str, Any]):
        logp, entropy, _ = self.module.forward_train(batch[OBS], batch[ACTIONS])
        loss = -logp.mean()
        return loss, {"bc_logp": logp.detach().mean(), "entropy": entropy.detach().mean()}


class BC(Algorithm):
    config_class = BCConfig
    learner_class = BCLearner

    def _needs_advantages(self) -> bool:
        return False

    def setup(self, config: Dict[str, Any]):
        from ray_tpu_torch.rllib.core.learner import LearnerGroup

        cfg = self.algo_config
        self._dataset = _load_offline(cfg.input_)
        if self._dataset.count == 0:
            raise ValueError("BC offline input is empty")
        from ray_tpu_torch.rllib.offline.offline_data import (
            OfflineData,
            module_spec_from_offline,
        )

        self.module_spec = module_spec_from_offline(
            cfg, OfflineData(self._dataset)
        )
        self.learner_group = LearnerGroup(
            BCLearner, self.module_spec, config=self._learner_config(), num_learners=cfg.num_learners
        )
        self._timesteps_total = 0
        self._epoch_rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        # one pass: sample train_batch_size rows from the dataset
        n = self._dataset.count
        idx = self._epoch_rng.integers(0, n, min(cfg.train_batch_size, n))
        batch = SampleBatch({k: np.asarray(v)[idx] for k, v in self._dataset.items()})
        metrics = self.learner_group.update_from_batch(
            batch, minibatch_size=cfg.minibatch_size, num_epochs=cfg.num_epochs
        )
        self._timesteps_total += batch.count
        metrics["num_env_steps_trained"] = self._timesteps_total
        return metrics

    def save_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        state = {
            "learner": self.learner_group.get_state(),
            "timesteps_total": self._timesteps_total,
            "config": {
                k: v for k, v in self.algo_config.to_dict().items() if k != "input_"
            },
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._timesteps_total = state.get("timesteps_total", 0)

    def cleanup(self):
        self.learner_group.shutdown()
        if getattr(self, "_eval_runner_group", None) is not None:
            self._eval_runner_group.stop()

    stop = cleanup


def _load_offline(input_: Any) -> SampleBatch:
    """Materialize offline input into one flat SampleBatch (delegates to
    the shared offline-data plane, reference: rllib/offline)."""
    from ray_tpu_torch.rllib.offline.offline_data import _materialize

    if input_ is None:
        raise ValueError("BCConfig.offline_data(input_=...) is required")
    return _materialize(input_)
