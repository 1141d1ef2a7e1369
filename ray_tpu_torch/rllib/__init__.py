"""ray_tpu_torch.rllib — reinforcement learning at scale (reference:
rllib/).

The single-agent paths of the reference's new API stack: RLModule (an
``nn.Module``), Learner and LearnerGroup (the update on ``cuda`` by
default), SingleAgentEnvRunner and EnvRunnerGroup (CPU actors), Algorithm
(a tune.Trainable), PPO, and the podracer plane: IMPALA and its
LearnerThread, APPO, the TrajectoryPlane and PodracerDriver that stream
fragments over channels, and the sebulba InferenceServer.  The
reference's other names (DQN, SAC, CQL, BC/MARWIL, DreamerV3, the replay
buffers and multi-agent envs) raise ``NotImplementedError`` naming
ROADMAP Queue A item 5(c), which ports them.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import REST_ITEM, Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig, LearnerThread
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.connectors import (
    ClipActions,
    ConnectorPipelineV2,
    ConnectorV2,
    FlattenObservations,
    NormalizeObservations,
)
from ray_tpu_torch.rllib.core.inference import InferenceServer
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import QModule, RLModule, RLModuleSpec
from ray_tpu_torch.rllib.core.stream import PodracerDriver, TrajectoryPlane
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

_NOT_PORTED = dict.fromkeys(
    ("DQN", "DQNConfig", "SAC", "SACConfig", "BC", "BCConfig", "CQL", "CQLConfig",
     "DreamerV3", "DreamerV3Config", "MARWIL", "MARWILConfig", "MultiAgentEnv",
     "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup", "ReplayBuffer",
     "PrioritizedReplayBuffer"), REST_ITEM)


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"ray_tpu_torch.rllib.{name} is not ported yet: {_NOT_PORTED[name]}")
    raise AttributeError(f"module 'ray_tpu_torch.rllib' has no attribute '{name}'")


__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    "IMPALA",
    "IMPALAConfig",
    "APPO",
    "APPOConfig",
    "LearnerThread",
    "ConnectorV2",
    "ConnectorPipelineV2",
    "FlattenObservations",
    "NormalizeObservations",
    "ClipActions",
    "InferenceServer",
    "Learner",
    "LearnerGroup",
    "PodracerDriver",
    "TrajectoryPlane",
    "RLModule",
    "RLModuleSpec",
    "QModule",
    "SingleAgentEnvRunner",
    "EnvRunnerGroup",
    "SampleBatch",
]
