"""ray_tpu_torch.rllib — reinforcement learning at scale (reference:
rllib/).

The synchronous single-agent path of the reference's new API stack:
RLModule (an ``nn.Module``), Learner and LearnerGroup (the update on
``cuda`` by default), SingleAgentEnvRunner and EnvRunnerGroup (CPU
actors), Algorithm (a tune.Trainable) and PPO.  The reference's other
names raise ``NotImplementedError`` naming the ROADMAP item that ports
them: the podracer plane (IMPALA, APPO, the inference server, the
trajectory plane) is Queue A item 5(b); DQN, SAC, CQL, BC/MARWIL,
DreamerV3, the replay buffers and multi-agent envs are item 5(c).
"""

from ray_tpu_torch.rllib.algorithms.algorithm import REST_ITEM, Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.connectors import (
    ClipActions,
    ConnectorPipelineV2,
    ConnectorV2,
    FlattenObservations,
    NormalizeObservations,
)
from ray_tpu_torch.rllib.core.learner import PODRACER_ITEM, Learner, LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import QModule, RLModule, RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

_NOT_PORTED = {
    **dict.fromkeys(
        ("IMPALA", "IMPALAConfig", "APPO", "APPOConfig", "LearnerThread",
         "InferenceServer", "PodracerDriver", "TrajectoryPlane"), PODRACER_ITEM),
    **dict.fromkeys(
        ("DQN", "DQNConfig", "SAC", "SACConfig", "BC", "BCConfig", "CQL", "CQLConfig",
         "DreamerV3", "DreamerV3Config", "MARWIL", "MARWILConfig", "MultiAgentEnv",
         "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup", "ReplayBuffer",
         "PrioritizedReplayBuffer"), REST_ITEM),
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"ray_tpu_torch.rllib.{name} is not ported yet: {_NOT_PORTED[name]}")
    raise AttributeError(f"module 'ray_tpu_torch.rllib' has no attribute '{name}'")


__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    "ConnectorV2",
    "ConnectorPipelineV2",
    "FlattenObservations",
    "NormalizeObservations",
    "ClipActions",
    "Learner",
    "LearnerGroup",
    "RLModule",
    "RLModuleSpec",
    "QModule",
    "SingleAgentEnvRunner",
    "EnvRunnerGroup",
    "SampleBatch",
]
