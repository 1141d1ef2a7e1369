"""Copies of tests/test_rllib.py's sample-batch, GAE, connector,
autoreset, replay-buffer and RLModule-shape tests on the port (no JAX
here; the module test draws from a torch generator), and the port's
checks that need no cluster: every name of the reference resolves, a
multi-agent config of explicit specs builds and trains without
gymnasium; cuda refused without a card; a remote cuda
learner's GPU lease; the podracer plane's pieces in one process (a
fragment's columns and sizes, the inference server's batched answers,
the learner's weight lock, APPO's target copy, the learner thread's
errors)."""

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
    ("DQN", "algorithms.dqn"), ("SAC", "algorithms.sac"), ("CQL", "algorithms.cql"),
    ("BC", "algorithms.bc"), ("MARWIL", "algorithms.marwil"), ("DreamerV3", "algorithms.dreamerv3"),
    ("MultiAgentEnv", "env.multi_agent_env"), ("ReplayBuffer", "utils.replay_buffers"),
])
def test_names_not_ported_raise_naming_their_item(name, item):
    """Once stubs that raised naming ROADMAP item 5(c); now each name
    resolves to the port's class in its module, beside every other name
    the reference exports."""
    import importlib

    import ray_tpu_torch.rllib as rllib

    cls = getattr(rllib, name)
    assert cls is getattr(importlib.import_module(f"ray_tpu_torch.rllib.{item}"), name)
    assert name in rllib.__all__
    if item.startswith("algorithms."):
        config = getattr(rllib, f"{name}Config")()
        assert config.algo_class is cls and config.learner_device == "cuda"


class _TwoWalkers:
    """Two agents on a line, no gymnasium: each moves -1/+1 a step,
    reward -|position|/10; ``walker_1`` terminates on its own past 3, the
    episode truncates after 12 steps."""

    possible_agents = ["walker_0", "walker_1"]

    def __init__(self):
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = {a: float(self._rng.integers(-2, 3)) for a in self.possible_agents}
        self._t = 0
        return {a: self._obs(a) for a in self._pos}, {}

    def _obs(self, agent):
        p = self._pos[agent]
        return np.array([p / 4.0, self._t / 12.0, 1.0 if agent == "walker_1" else 0.0],
                        np.float32)

    def step(self, action_dict):
        self._t += 1
        obs, rew, term, trunc = {}, {}, {}, {}
        for a, act in action_dict.items():
            self._pos[a] += 1.0 if int(act) == 1 else -1.0
            rew[a] = -abs(self._pos[a]) / 10.0
            term[a] = a == "walker_1" and abs(self._pos[a]) > 3
            trunc[a] = self._t >= 12
            if term[a]:
                del self._pos[a]
            else:
                obs[a] = self._obs(a)
        term["__all__"] = not self._pos
        trunc["__all__"] = self._t >= 12
        return obs, rew, term, trunc, {}

    def close(self):
        pass


def test_deferred_paths_raise_naming_their_item(tmp_path):
    """Once a multi_agent() config raised naming item 5(c); now a PPO
    config of explicit RLModuleSpecs on a plain-Python env (no gymnasium)
    builds on the CPU, trains one iteration reporting both policies, and
    its learner groups are one a policy."""
    from ray_tpu_torch.rllib import PPOConfig, RLModuleSpec

    specs = {pid: RLModuleSpec(observation_dim=3, action_dim=2, hidden=(8,))
             for pid in ("p0", "p1")}
    cfg = (PPOConfig().environment(env_creator=_TwoWalkers).learners(device="cpu")
           .env_runners(num_env_runners=0, rollout_fragment_length=32)
           .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
           .multi_agent(policies=specs, policy_mapping_fn=lambda a: "p" + a[-1]))
    algo = cfg.build()
    try:
        assert set(algo.learner_groups) == {"p0", "p1"}
        assert all(str(lg._local.device) == "cpu" for lg in algo.learner_groups.values())
        out = algo.train()
        assert {"p0", "p1"} <= set(out) and out["num_env_steps_sampled"] > 0
        assert set(algo.get_policy_weights()) == {"p0", "p1"}
    finally:
        algo.cleanup()


def test_replay_buffer_wraps():
    from ray_tpu_torch.rllib import ReplayBuffer, SampleBatch

    buf = ReplayBuffer(capacity=8, seed=0)
    for i in range(3):
        buf.add(SampleBatch({"x": np.arange(4) + 4 * i}))
    assert len(buf) == 8
    s = buf.sample(16)
    assert s.count == 16
    assert s["x"].min() >= 4  # first batch was overwritten


def test_prioritized_buffer_prefers_high_priority():
    from ray_tpu_torch.rllib import PrioritizedReplayBuffer, SampleBatch

    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, seed=0)
    buf.add(SampleBatch({"x": np.arange(64)}))
    # element 7 gets huge priority
    prios = np.full(64, 0.001)
    prios[7] = 100.0
    buf.update_priorities(np.arange(64), prios)
    s = buf.sample(256)
    frac_7 = (s["x"] == 7).mean()
    assert frac_7 > 0.5


def test_the_rest_of_rllib_refuses_cuda_without_a_card(monkeypatch):
    """DQN's, SAC's, CQL's, BC's, MARWIL's and DreamerV3's learners default
    to cuda and raise without a card; a multi-agent runner asked to infer
    on cuda raises, and refuses any other backend than cpu or cuda."""
    from ray_tpu_torch.rllib import MultiAgentEnvRunner, RLModuleSpec
    from ray_tpu_torch.rllib.algorithms.bc import BCLearner
    from ray_tpu_torch.rllib.algorithms.cql import CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config, DreamerV3Learner
    from ray_tpu_torch.rllib.algorithms.marwil import MARWILLearner
    from ray_tpu_torch.rllib.algorithms.sac import SACLearner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    discrete = RLModuleSpec(observation_dim=3, action_dim=2, hidden=(8,))
    continuous = RLModuleSpec(observation_dim=3, action_dim=1, discrete=False, hidden=(8,))
    for make in (lambda: DQNLearner(discrete, {}), lambda: BCLearner(discrete, {}),
                 lambda: MARWILLearner(discrete, {}), lambda: SACLearner(continuous, {}),
                 lambda: CQLLearner(continuous, {}),
                 lambda: DreamerV3Learner(DreamerV3Config().training(hidden=(8,)), 3, 2)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    specs = {"p0": discrete}
    with pytest.raises(RuntimeError, match="cuda"):
        MultiAgentEnvRunner(_TwoWalkers, specs, lambda a: "p0", inference_backend="cuda")
    with pytest.raises(ValueError, match="inference_backend"):
        MultiAgentEnvRunner(_TwoWalkers, specs, lambda a: "p0", inference_backend="")


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


def test_podracer_configs_build_their_options():
    """podracer() turns the plane on with its options; IMPALA's and APPO's
    configs carry the reference's defaults."""
    from ray_tpu_torch.rllib import APPO, IMPALA, APPOConfig, IMPALAConfig, PPOConfig

    cfg = PPOConfig().podracer(policy_mode="sebulba", max_weight_lag=2, broadcast_interval=3,
                               trajectory_queue_size=5)
    assert (cfg.podracer_enabled, cfg.policy_mode, cfg.max_weight_lag, cfg.broadcast_interval,
            cfg.trajectory_queue_size) == (True, "sebulba", 2, 3, 5)
    with pytest.raises(ValueError, match="anakin"):
        PPOConfig().podracer(policy_mode="tpu")
    impala, appo = IMPALAConfig(), APPOConfig()
    assert impala.algo_class is IMPALA and appo.algo_class is APPO
    assert (impala.rollout_fragment_length, impala.max_weight_lag, impala.lr) == (50, 16, 5e-4)
    assert (appo.clip_param, appo.target_network_update_freq, appo.use_kl_loss) == (0.4, 2, False)


def _image_env():
    import gymnasium as gym

    class Frames(gym.Env):
        """Random uint8 frames, 3 actions, episodes of 5 steps."""

        observation_space = gym.spaces.Box(0, 255, (6, 6, 2), np.uint8)
        action_space = gym.spaces.Discrete(3)

        def reset(self, seed=None, options=None):
            super().reset(seed=seed)
            self._t = 0
            return self.np_random.integers(0, 256, (6, 6, 2), dtype=np.uint8), {}

        def step(self, action):
            self._t += 1
            obs = self.np_random.integers(0, 256, (6, 6, 2), dtype=np.uint8)
            return obs, 1.0, self._t >= 5, False, {}

    return Frames()


@pytest.mark.parametrize("env", ["CartPole-v1", "frames"])
def test_a_fragment_crosses_as_numpy_of_the_reference_dtypes(env):
    """_collect_fragment's [T, N] columns are numpy arrays of the
    reference's dtypes (uint8 frames stay uint8, int64 discrete actions,
    bool flags, float32 the rest), autoreset rows masked, and the ring
    sizing reads the env's own obs dtype."""
    import gymnasium as gym

    from ray_tpu_torch.rllib import RLModuleSpec, SingleAgentEnvRunner
    from ray_tpu_torch.rllib.core.stream import _estimate_fragment_bytes, _weights_nbytes

    creator = (lambda: gym.make("CartPole-v1")) if env == "CartPole-v1" else _image_env
    probe = creator()
    conv = ((4, 3, 1),) if env == "frames" else None
    spec = RLModuleSpec.from_gym_env(probe, hidden=(8,), conv_filters=conv)
    probe.close()
    runner = SingleAgentEnvRunner(creator, spec, num_envs=2, seed=0, mask_autoreset=False)
    weights = spec.build(torch.Generator().manual_seed(0)).get_weights()
    runner.set_weights(weights)
    frag = runner._collect_fragment(40)  # CartPole's random episodes end well within
    cols = frag["cols"]
    frame = np.uint8 if env == "frames" else np.float32
    want = {"obs": frame, "actions": np.int64, "rewards": np.float32, "terminateds": np.bool_,
            "truncateds": np.bool_, "action_logp": np.float32, "vf_preds": np.float32,
            "loss_mask": np.float32}
    assert {k: v.dtype for k, v in cols.items()} == {k: np.dtype(v) for k, v in want.items()}
    assert all(isinstance(v, np.ndarray) and v.shape[:2] == (40, 2) for v in cols.values())
    assert frag["last_values"].dtype == np.float32 and frag["last_values"].shape == (2,)
    done = cols["terminateds"] | cols["truncateds"]
    assert done.any() and (cols["loss_mask"][1:][done[:-1]] == 0).all()
    assert frag["env_steps"] == int(cols["loss_mask"].sum()) and frag["seq"] == 1
    obs_bytes = int(np.prod(spec.obs_shape or (spec.observation_dim,))) * np.dtype(frame).itemsize
    assert _estimate_fragment_bytes(creator, spec, 40, 2) == 40 * 2 * (obs_bytes + 64) + (64 << 10)
    assert _weights_nbytes(weights) == sum(v.nbytes for v in weights.values())
    runner.stop()


def test_inference_server_batches_callers_and_tags_their_generation():
    """The sebulba server in one process on the CPU: concurrent greedy
    calls are coalesced, each answer carries the weights' generation and
    equals the module's own greedy actions and values; exploring calls
    return their actions' logp."""
    import asyncio

    from ray_tpu_torch.rllib import InferenceServer, RLModuleSpec

    spec = RLModuleSpec(observation_dim=4, action_dim=3, hidden=(8,))
    module = spec.build(torch.Generator().manual_seed(2))
    server = InferenceServer(spec, seed=1, device="cpu")
    assert server.set_weights(module.get_weights(), 3) == 3
    obs = [np.random.default_rng(i).standard_normal((5, 4)).astype(np.float32) for i in range(6)]

    async def calls():
        greedy = await asyncio.gather(*(server.compute_actions(o, False) for o in obs))
        explore = await server.compute_actions(obs[0], True)
        return greedy, explore

    greedy, (acts, logp, value, gen) = asyncio.run(calls())
    for o, (a, lp, v, g) in zip(obs, greedy):
        with torch.no_grad():
            want_a, want_v = module.forward_inference(o)
        assert g == 3 and a.dtype == np.int64
        np.testing.assert_array_equal(a, want_a.numpy())
        np.testing.assert_allclose(v, want_v.numpy(), rtol=1e-5, atol=1e-6)  # one batch of 30 rows
        assert (lp == 0).all()
    assert gen == 3 and acts.shape == (5,)
    with torch.no_grad():
        want_logp = module.forward_train(obs[0], acts)[0].numpy()
    np.testing.assert_allclose(logp, want_logp, rtol=1e-5)


def test_inference_server_refuses_cuda_without_a_card(monkeypatch):
    from ray_tpu_torch.rllib import InferenceServer, RLModuleSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceServer(RLModuleSpec(observation_dim=4, action_dim=2))  # the default device


def test_learner_weights_are_always_one_generation():
    """A thread steps the learner (as IMPALA's LearnerThread does) while
    this one reads weights for broadcasts: every snapshot equals the
    weights after some whole step, never half of one (the weight lock)."""
    import sys
    import threading

    from ray_tpu_torch.rllib import RLModuleSpec, SampleBatch
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    learner = PPOLearner(spec, {"device": "cpu", "lr": 1e-2})
    rng = np.random.default_rng(0)
    batch = SampleBatch({"obs": rng.standard_normal((32, 4)).astype(np.float32),
                         "actions": rng.integers(0, 2, 32), "action_logp": np.zeros(32, np.float32),
                         "advantages": rng.standard_normal(32).astype(np.float32),
                         "value_targets": rng.standard_normal(32).astype(np.float32)})
    generations = [learner.get_weights()]
    learner.after_update = lambda: generations.append(learner.module.get_weights())
    snapshots, stop = [], threading.Event()

    def steps():
        for _ in range(60):
            learner.update_from_batch(batch)
        stop.set()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=steps, daemon=True)
        t.start()
        while not stop.is_set():
            snapshots.append(learner.get_weights())
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and len(generations) == 61 and snapshots
    keys = sorted(generations[0])
    whole = {tuple(g[k].tobytes() for k in keys) for g in generations}
    assert all(tuple(s[k].tobytes() for k in keys) in whole for s in snapshots)


def test_appo_target_policy_is_a_copy_synced_every_n_updates():
    """old_params are tensors of their own: an update moves the module and
    not the target, and after target_network_update_freq updates the
    target equals the module again."""
    from ray_tpu_torch.rllib import RLModuleSpec, SampleBatch
    from ray_tpu_torch.rllib.algorithms.appo import APPOLearner

    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))
    learner = APPOLearner(spec, {"device": "cpu", "lr": 1e-2, "target_network_update_freq": 2})
    rng = np.random.default_rng(1)
    batch = SampleBatch({"obs": rng.standard_normal((16, 4)).astype(np.float32),
                         "actions": rng.integers(0, 2, 16),
                         "action_logp": np.full(16, np.log(0.5), np.float32),
                         "rewards": np.ones(16, np.float32),
                         "terminateds": np.zeros(16, bool), "truncateds": np.zeros(16, bool)})
    start = {k: v.clone() for k, v in learner.old_params.items()}
    params = dict(learner.module.named_parameters())
    assert all(learner.old_params[k].data_ptr() != p.data_ptr() for k, p in params.items())
    learner.update_from_batch(batch)
    assert all(torch.equal(learner.old_params[k], v) for k, v in start.items())
    assert any(not torch.equal(learner.old_params[k], p) for k, p in params.items())
    learner.update_from_batch(batch)
    assert all(torch.equal(learner.old_params[k], p.detach()) for k, p in params.items())


def test_learner_thread_surfaces_an_update_error():
    """An exception on the learner thread stops it and is raised by the
    driver's next check_error(), never swallowed."""
    from ray_tpu_torch.rllib import LearnerThread, SampleBatch

    class Broken:
        def update_from_batch(self, batch):
            raise RuntimeError("update failed on the learner thread")

    lt = LearnerThread(Broken(), maxsize=2)
    lt.start()
    assert lt.put(SampleBatch({"obs": np.zeros((2, 4))}), timeout=5)
    lt.join(timeout=30)
    assert not lt.is_alive()
    with pytest.raises(RuntimeError, match="learner thread"):
        lt.check_error()
