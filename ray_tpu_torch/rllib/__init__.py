"""ray_tpu_torch.rllib — reinforcement learning at scale (reference:
rllib/).

The reference's new API stack on PyTorch: RLModule (an ``nn.Module``),
Learner and LearnerGroup (the update on ``cuda`` by default),
SingleAgentEnvRunner and EnvRunnerGroup (CPU actors), Algorithm (a
tune.Trainable) and its algorithms: PPO (single- and multi-agent), DQN
with its replay buffers, SAC, the offline algorithms BC, MARWIL and CQL
fed through OfflineData, DreamerV3, and the podracer plane: IMPALA and
its LearnerThread, APPO, the TrajectoryPlane and PodracerDriver that
stream fragments over channels, and the sebulba InferenceServer.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig, LearnerThread
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
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
from ray_tpu_torch.rllib.env.multi_agent_env import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentEnvRunnerGroup,
)
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    "DQN",
    "DQNConfig",
    "IMPALA",
    "IMPALAConfig",
    "APPO",
    "APPOConfig",
    "SAC",
    "SACConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "DreamerV3",
    "DreamerV3Config",
    "MARWIL",
    "MARWILConfig",
    "LearnerThread",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentEnvRunnerGroup",
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
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
    "SampleBatch",
]
