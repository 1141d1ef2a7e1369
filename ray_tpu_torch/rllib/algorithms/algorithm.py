"""Algorithm + AlgorithmConfig (reference:
rllib/algorithms/algorithm.py:229 — step() :889, training_step() :1658,
setup() :610; algorithm_config.py builder).

An Algorithm is a tune.Trainable: `algo.train()` runs one iteration;
Tuner(PPO, ...) sweeps it; checkpoints flow through the same
save/restore hooks the reference uses (Checkpointable).

The port runs the synchronous single-agent path: env-runner actors on the
CPU, the learner on ``learners(device=...)`` (``cuda`` by default).  The
podracer streaming plane is ROADMAP Queue A item 5(b) and multi-agent
configs item 5(c); asking for either raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np

from ray_tpu_torch.rllib.core.learner import PODRACER_ITEM, LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.tune.trainable import Trainable

REST_ITEM = "ROADMAP.md Queue A item 5(c), the rest of RLlib"


class AlgorithmConfig:
    """Fluent builder (reference: rllib/algorithms/algorithm_config.py).

    cfg = (PPOConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=2)
           .training(lr=3e-4, train_batch_size=2000))
    algo = cfg.build()
    """

    algo_class: Optional[Type["Algorithm"]] = None

    def __init__(self):
        # environment
        self.env: Optional[str] = None
        self.env_creator: Optional[Callable[[], Any]] = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners = 2
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 200
        self.num_cpus_per_env_runner = 1.0
        self.restart_failed_env_runners = True
        # Policy-inference device for env runners ("cpu" keeps per-step
        # calls off the learner's card; "cuda" raises without one).
        self.inference_backend = "cpu"
        # podracer streaming plane (the reference's core/stream.py; not
        # ported, ROADMAP Queue A item 5(b)): its fields stay so a
        # reference config carries over, and building with it on raises.
        self.podracer_enabled = False
        # "anakin": action selection inside the runner's jitted step
        # (cheap envs/policies); "sebulba": a shared continuous-batching
        # inference server actor (heavy policies).
        self.policy_mode = "anakin"
        self.max_weight_lag = 4  # generations a fragment may trail the learner
        self.broadcast_interval = 1  # learner updates between weight publishes
        self.trajectory_queue_size = 8  # fragments buffered learner-side
        # Connector pipelines applied in every env runner (reference:
        # config.env_runners(env_to_module_connector=...)).  Stateful
        # connector state lives per-runner and is not checkpointed.
        self.env_to_module = None
        self.module_to_env = None
        # training
        self.gamma = 0.99
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 1
        self.grad_clip: Optional[float] = None
        # learners
        self.num_learners = 0
        self.num_cpus_per_learner = 1.0
        self.learner_device = "cuda"  # where the learner's module and Adam live
        # module
        self.model: Dict[str, Any] = {"hidden": (64, 64), "vf_share_layers": False}
        # multi-agent (reference: algorithm_config.py multi_agent())
        self.policies: Optional[Dict[str, Any]] = None  # policy_id -> spec | None
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        # evaluation (reference: algorithm_config.py evaluation() —
        # evaluation_interval/_num_env_runners/_duration)
        self.evaluation_interval: Optional[int] = None
        self.evaluation_num_env_runners = 0
        self.evaluation_duration = 5  # episodes
        # debug
        self.seed = 0

    # -- builder steps ---------------------------------------------------
    def environment(self, env: Optional[str] = None, *, env_creator=None, env_config: Optional[dict] = None):
        if env is not None:
            self.env = env
        if env_creator is not None:
            self.env_creator = env_creator
        if env_config:
            self.env_config.update(env_config)
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None, num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None, num_cpus_per_env_runner: Optional[float] = None,
                    restart_failed_env_runners: Optional[bool] = None, inference_backend: Optional[str] = None,
                    env_to_module=None, module_to_env=None):
        if inference_backend is not None:
            self.inference_backend = inference_backend
        if env_to_module is not None:
            self.env_to_module = env_to_module
        if module_to_env is not None:
            self.module_to_env = module_to_env
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_env_runner = num_cpus_per_env_runner
        if restart_failed_env_runners is not None:
            self.restart_failed_env_runners = restart_failed_env_runners
        return self

    def podracer(self, *, enabled: bool = True, policy_mode: Optional[str] = None,
                 max_weight_lag: Optional[int] = None,
                 broadcast_interval: Optional[int] = None,
                 trajectory_queue_size: Optional[int] = None):
        """Enable the podracer streaming plane (sebulba/anakin split;
        PAPERS.md 'Podracer architectures for scalable RL').  Not ported:
        ``enabled=True`` raises."""
        if enabled:
            raise NotImplementedError(f"podracer(enabled=True): {PODRACER_ITEM}")
        self.podracer_enabled = enabled
        if policy_mode is not None:
            if policy_mode not in ("anakin", "sebulba"):
                raise ValueError(f"policy_mode must be anakin|sebulba, got {policy_mode!r}")
            self.policy_mode = policy_mode
        if max_weight_lag is not None:
            self.max_weight_lag = max_weight_lag
        if broadcast_interval is not None:
            self.broadcast_interval = broadcast_interval
        if trajectory_queue_size is not None:
            self.trajectory_queue_size = trajectory_queue_size
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k) and k != "model":
                raise ValueError(f"unknown training option {k!r}")
            if k == "model":
                self.model.update(v)
            else:
                setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None, num_cpus_per_learner: Optional[float] = None,
                 device: Optional[str] = None):
        """``device``: where the learner updates, ``"cuda"`` (the default;
        raises without a card) or ``"cpu"``."""
        if num_learners is not None:
            self.num_learners = num_learners
        if num_cpus_per_learner is not None:
            self.num_cpus_per_learner = num_cpus_per_learner
        if device is not None:
            self.learner_device = device
        return self

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Callable[[str], str]] = None):
        """Declare the policy set and the agent→policy routing
        (reference: algorithm_config.py multi_agent()).  Building an
        algorithm from a multi-agent config raises: not ported yet."""
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    @property
    def is_multi_agent(self) -> bool:
        return bool(self.policies)

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_env_runners: Optional[int] = None,
                   evaluation_duration: Optional[int] = None):
        """Configure the separate evaluation pass (reference:
        algorithm_config.py evaluation()); duration is in episodes."""
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = evaluation_num_env_runners
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    # -- finalize --------------------------------------------------------
    def make_env_creator(self) -> Callable[[], Any]:
        if self.env_creator is not None:
            return self.env_creator
        env_name, env_cfg = self.env, dict(self.env_config)
        if env_name is None:
            raise ValueError("config.environment(...) must set an env")

        def creator():
            import gymnasium as gym

            return gym.make(env_name, **env_cfg)

        return creator

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise NotImplementedError("use a concrete config (PPOConfig/DQNConfig/...)")
        return self.algo_class(self)

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_") and not callable(v)}

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            setattr(self, k, v)
        return self


class Algorithm(Trainable):
    """Drives EnvRunnerGroup + LearnerGroup (reference: algorithm.py:229)."""

    config_class: Type[AlgorithmConfig] = AlgorithmConfig
    learner_class = None  # set by subclasses
    # V-trace-style algorithms keep autoreset rows for fixed batch shapes
    mask_autoreset_rows = True

    def __init__(self, config=None, trial_dir: str = "."):
        # Accept AlgorithmConfig directly or a tune config dict (for
        # Tuner(PPO, param_space={...}))
        if isinstance(config, AlgorithmConfig):
            self.algo_config = config
            tune_cfg = {}
        else:
            tune_cfg = dict(config or {})
            self.algo_config = self.config_class().update_from_dict(tune_cfg)
        super().__init__(tune_cfg, trial_dir)

    # -- Trainable hooks -------------------------------------------------
    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        if cfg.is_multi_agent:
            raise NotImplementedError(f"multi_agent() configs: {REST_ITEM}")
        if cfg.podracer_enabled:
            raise NotImplementedError(f"podracer(enabled=True): {PODRACER_ITEM}")
        env_creator = cfg.make_env_creator()
        probe_env = env_creator()
        self.module_spec = RLModuleSpec.from_gym_env(
            probe_env,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
            vf_share_layers=cfg.model.get("vf_share_layers", False),
            conv_filters=cfg.model.get("conv_filters"),
        )
        probe_env.close()
        self.env_runner_group = EnvRunnerGroup(
            env_creator,
            self.module_spec,
            num_env_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            rollout_fragment_length=cfg.rollout_fragment_length,
            gamma=cfg.gamma,
            lambda_=getattr(cfg, "lambda_", 0.95),
            compute_advantages=self._needs_advantages(),
            num_cpus_per_runner=cfg.num_cpus_per_env_runner,
            restart_failed=cfg.restart_failed_env_runners,
            seed=cfg.seed,
            inference_backend=cfg.inference_backend,
            mask_autoreset=type(self).mask_autoreset_rows,
            env_to_module=cfg.env_to_module,
            module_to_env=cfg.module_to_env,
        )
        self.learner_group = LearnerGroup(
            type(self).learner_class,
            self.module_spec,
            config=self._learner_config(),
            num_learners=cfg.num_learners,
            resources={"num_cpus": cfg.num_cpus_per_learner},
        )
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._timesteps_total = 0

    def _needs_advantages(self) -> bool:
        return True

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        return {"lr": cfg.lr, "grad_clip": cfg.grad_clip, "gamma": cfg.gamma, "seed": cfg.seed,
                "device": cfg.learner_device}

    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        results = self.training_step()
        results.setdefault("timesteps_total", self._timesteps_total)
        results.update(self.env_runner_group.aggregate_metrics())
        results["time_this_iter_s"] = time.time() - t0
        self._maybe_evaluate(results)
        return results

    # -- evaluation (reference: algorithm.py evaluate() — a separate
    # EnvRunnerGroup sampling deterministically, never the training
    # runners) -----------------------------------------------------------
    def _maybe_evaluate(self, results: Dict[str, Any]) -> None:
        cfg = self.algo_config
        if not cfg.evaluation_interval:
            return
        if cfg.env is None and cfg.env_creator is None:
            return  # offline-only config without an env: nothing to roll out
        # own counter: self.iteration is driver-dependent (the Tune
        # driver sets it AFTER step(), standalone train() before), which
        # would both shift the schedule and evaluate untrained weights
        # on the very first step
        self._train_iters_for_eval = getattr(self, "_train_iters_for_eval", 0) + 1
        if self._train_iters_for_eval % cfg.evaluation_interval == 0:
            results["evaluation"] = self.evaluate()

    def _make_eval_runner_group(self) -> "EnvRunnerGroup":
        cfg = self.algo_config
        return EnvRunnerGroup(
            cfg.make_env_creator(),
            self.module_spec,
            num_env_runners=cfg.evaluation_num_env_runners,
            num_envs_per_runner=1,
            rollout_fragment_length=32,
            compute_advantages=False,
            num_cpus_per_runner=cfg.num_cpus_per_env_runner,
            seed=cfg.seed + 10_000,
            inference_backend=cfg.inference_backend,
            env_to_module=cfg.env_to_module,
            module_to_env=cfg.module_to_env,
        )

    def evaluate(self) -> Dict[str, Any]:
        """Deterministic rollouts on dedicated eval runners; returns the
        evaluation metrics dict (reference: algorithm.py evaluate()).

        Algorithms whose policy is not the standard RLModule (DQN's
        Q-net, SAC's squashed Gaussian) override this with their own
        greedy rollout."""
        cfg = self.algo_config
        if getattr(self, "_eval_runner_group", None) is None:
            self._eval_runner_group = self._make_eval_runner_group()
        group = self._eval_runner_group
        group.sync_weights(self.get_policy_weights())
        returns = group.sample_episodes(cfg.evaluation_duration, explore=False)
        return {
            "num_episodes": len(returns),
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_return_max": float(np.max(returns)),
        }

    def train(self) -> Dict[str, Any]:
        """Standalone use: algo.train() outside a Tuner."""
        self.iteration += 1
        out = self.step()
        out.setdefault("training_iteration", self.iteration)
        return out

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- checkpoints (reference: rllib/utils/checkpoints.py
    # Checkpointable) ----------------------------------------------------
    def save_checkpoint(self, checkpoint_dir: str):
        learner_state = self.learner_group.get_state()
        import cloudpickle

        state = {
            "learner": learner_state,
            "timesteps_total": self._timesteps_total,
            "config": self.algo_config.to_dict(),
            # to_dict strips callables (env_creator, policy_mapping_fn) —
            # without them a restored multi-agent config cannot rebuild
            # its runners; the cloudpickled config object is the source
            # of truth for from_checkpoint (reference: rllib checkpoints
            # cloudpickle the whole AlgorithmConfig).
            "config_blob": cloudpickle.dumps(self.algo_config),
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str):
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._timesteps_total = state.get("timesteps_total", 0)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str) -> "Algorithm":
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        blob = state.get("config_blob")
        if blob is not None:
            import cloudpickle

            cfg = cloudpickle.loads(blob)
        else:
            cfg = cls.config_class().update_from_dict(state["config"])
        algo = cls(cfg)
        algo.load_checkpoint(checkpoint_dir)
        return algo

    def get_policy_weights(self):
        return self.learner_group.get_weights()

    def cleanup(self):
        self.env_runner_group.stop()
        if getattr(self, "_eval_runner_group", None) is not None:
            self._eval_runner_group.stop()
        self.learner_group.shutdown()

    stop = cleanup
