"""Copies of tests/test_rllib.py's sample-batch, GAE, connector,
autoreset and RLModule-shape tests on the port (no JAX here; the module
test draws from a torch generator), and the port's checks that need no
cluster: the reference's names and paths that are not ported raise,
naming their ROADMAP item; cuda refused without a card; a remote cuda
learner's GPU lease."""

import re

import numpy as np
import pytest
import torch

import ray_tpu_torch

torch.set_num_threads(2)


def test_sample_batch_ops():
    from ray_tpu_torch.rllib import SampleBatch

    b = SampleBatch({"obs": np.arange(10).reshape(5, 2), "rew": np.ones(5)})
    assert b.count == 5
    sliced = b.slice(1, 3)
    assert sliced.count == 2
    cat = SampleBatch.concat_samples([b, b])
    assert cat.count == 10
    mbs = list(cat.minibatches(4, np.random.default_rng(0)))
    assert len(mbs) == 2 and all(m.count == 4 for m in mbs)


def test_gae_matches_manual():
    from ray_tpu_torch.rllib.utils.postprocessing import compute_gae
    from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

    batch = SampleBatch(
        {
            "rewards": np.array([1.0, 1.0, 1.0], np.float32),
            "vf_preds": np.array([0.5, 0.4, 0.3], np.float32),
            "terminateds": np.array([False, False, True]),
            "truncateds": np.array([False, False, False]),
        }
    )
    out = compute_gae(batch, last_value=0.0, gamma=0.9, lambda_=1.0)
    # terminal step: delta = 1 - 0.3 = 0.7
    # t1: 1 + 0.9*0.3 - 0.4 + 0.9*0.7 = 1.50
    # t0: 1 + 0.9*0.4 - 0.5 + 0.9*1.50 = 2.21
    np.testing.assert_allclose(out["advantages"], [2.21, 1.5, 0.7], rtol=1e-5)


def test_connectors_pipeline():
    from ray_tpu_torch.rllib import (
        ClipActions,
        ConnectorPipelineV2,
        FlattenObservations,
        NormalizeObservations,
    )

    pipe = ConnectorPipelineV2([FlattenObservations(), NormalizeObservations(clip=5.0)])
    obs = np.random.default_rng(0).normal(3.0, 2.0, (16, 2, 2)).astype(np.float32)
    out = pipe(obs)
    assert out.shape == (16, 4)
    # after enough batches the running filter should roughly whiten
    for _ in range(50):
        out = pipe(np.random.default_rng(1).normal(3.0, 2.0, (16, 2, 2)))
    assert abs(out.mean()) < 0.5
    clip = ClipActions(low=-1.0, high=1.0)
    np.testing.assert_allclose(clip(np.array([-5.0, 0.5, 5.0])), [-1.0, 0.5, 1.0])
    state = pipe.get_state()
    pipe2 = ConnectorPipelineV2([FlattenObservations(), NormalizeObservations(clip=5.0)])
    pipe2.set_state(state)
    assert pipe2.connectors[1]._count == pipe.connectors[1]._count


def test_env_runner_drops_autoreset_rows():
    """gymnasium>=1.0 next-step autoreset rows (obs = previous episode's
    terminal frame, action ignored) must not appear in sample batches."""
    import gymnasium as gym

    from ray_tpu_torch.rllib import RLModuleSpec, SingleAgentEnvRunner

    creator = lambda: gym.make("CartPole-v1")  # noqa: E731
    probe = creator()
    spec = RLModuleSpec.from_gym_env(probe, hidden=(8,))
    probe.close()
    runner = SingleAgentEnvRunner(creator, spec, num_envs=2, rollout_fragment_length=300, seed=0)
    runner.set_weights(spec.build(torch.Generator().manual_seed(0)).get_weights())
    batch = runner.sample(300)
    # random CartPole episodes last ~20 steps: plenty of resets happened,
    # so dropped rows mean fewer than the raw 600 transitions
    assert batch.count < 600
    # every episode fragment's rewards are all-1 (CartPole): a reset row
    # would have carried reward 0
    assert (batch["rewards"] == 1.0).all()
    runner.stop()


def test_rl_module_shapes():
    from ray_tpu_torch.rllib import RLModuleSpec

    spec = RLModuleSpec(observation_dim=4, action_dim=2, discrete=True, hidden=(8,))
    mod = spec.build(torch.Generator().manual_seed(0))
    obs = np.zeros((3, 4), np.float32)
    with torch.no_grad():
        actions, logp, value = mod.forward_exploration(obs, torch.Generator().manual_seed(1))
        assert actions.shape == (3,) and logp.shape == (3,) and value.shape == (3,)
        a2, v2 = mod.forward_inference(obs)
        assert a2.shape == (3,)
        lp, ent, v = mod.forward_train(obs, np.zeros(3, np.int32))
    assert float(ent.mean()) > 0


@pytest.mark.parametrize("name,item", [
    ("IMPALA", "5(b)"), ("APPO", "5(b)"), ("InferenceServer", "5(b)"), ("TrajectoryPlane", "5(b)"),
    ("DQN", "5(c)"), ("SAC", "5(c)"), ("CQL", "5(c)"), ("BC", "5(c)"), ("MARWIL", "5(c)"),
    ("DreamerV3", "5(c)"), ("MultiAgentEnv", "5(c)"), ("ReplayBuffer", "5(c)"),
])
def test_names_not_ported_raise_naming_their_item(name, item):
    import ray_tpu_torch.rllib as rllib

    with pytest.raises(NotImplementedError, match=rf"Queue A item {re.escape(item)}"):
        getattr(rllib, name)


def test_deferred_paths_raise_naming_their_item():
    from ray_tpu_torch.rllib import LearnerGroup, PPOConfig, RLModuleSpec
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    with pytest.raises(NotImplementedError, match=r"item 5\(b\)"):
        PPOConfig().podracer(enabled=True)
    cfg = (PPOConfig().environment("CartPole-v1").learners(device="cpu")
           .multi_agent(policies={"p0": None}, policy_mapping_fn=lambda a: "p0"))
    with pytest.raises(NotImplementedError, match=r"item 5\(c\)"):
        cfg.build()
    spec = RLModuleSpec(observation_dim=4, action_dim=2)
    group = LearnerGroup(PPOLearner, spec, config={"device": "cpu"})
    with pytest.raises(NotImplementedError, match=r"item 5\(b\)"):
        group.update_from_fragments([{}])
    with pytest.raises(NotImplementedError, match=r"item 5\(b\)"):
        group._local.prepare_fragments({}, None)


def test_cuda_learner_and_inference_refuse_a_machine_without_a_card(monkeypatch):
    """The learner's device and the runners' inference device default to
    nothing silently: asked for cuda without a card they raise."""
    from ray_tpu_torch.rllib import RLModuleSpec, SingleAgentEnvRunner
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = RLModuleSpec(observation_dim=4, action_dim=2)
    with pytest.raises(RuntimeError, match="cuda"):
        PPOLearner(spec, {})  # the default device
    import gymnasium as gym

    with pytest.raises(RuntimeError, match="cuda"):
        SingleAgentEnvRunner(lambda: gym.make("CartPole-v1"), spec, inference_backend="cuda")
    with pytest.raises(ValueError, match="inference_backend"):
        SingleAgentEnvRunner(lambda: gym.make("CartPole-v1"), spec, inference_backend="")


def test_a_remote_cuda_learner_leases_a_gpu_beside_its_cpus(monkeypatch):
    """num_learners >= 1: each learner actor on cuda asks for one GPU
    beside its CPUs (the reference's asks for CPUs only); a cpu learner
    for none."""
    from ray_tpu_torch.rllib import LearnerGroup, RLModuleSpec
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    asked = []

    def remote(**opts):
        asked.append(opts)
        return lambda cls: type("Remote", (), {"remote": staticmethod(lambda *a: cls.__name__)})

    monkeypatch.setattr(ray_tpu_torch, "remote", remote)
    spec = RLModuleSpec(observation_dim=4, action_dim=2)
    LearnerGroup(PPOLearner, spec, config={}, num_learners=2, resources={"num_cpus": 2})
    LearnerGroup(PPOLearner, spec, config={"device": "cpu"}, num_learners=1)
    assert asked == [{"num_cpus": 2, "num_gpus": 1}, {"num_cpus": 1}]
