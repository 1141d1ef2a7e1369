"""The port's offline RL against the JAX package's, and copies of
tests/test_rllib_offline.py's tests on the port: BC's and MARWIL's losses
and one update (MARWIL at beta 0 and 1), the IS and WIS estimates of the
same RLModule weights, OfflineData's derived columns and JSONL round
trip, the estimators on known-value data, MARWIL learning CartPole from
mixed data and CQL's checkpoint keeping its BC phase.  No cluster: the
offline algorithms learn inline and evaluate on a local runner.

Tolerances: losses, metrics and estimates at 2e-4; after an Adam step
each parameter within 1e-2 lr of the reference's where its gradient is
at least 1e-2 of its tensor's largest, else 2 lr (the rule of
tests/test_torch_train.py; the gradients read from Adam's first moment
at 5e-3 of each tensor's largest).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib.algorithms.bc import BCLearner as JBCLearner  # noqa: E402
from ray_tpu.rllib.algorithms.marwil import MARWILLearner as JMARWILLearner  # noqa: E402
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec  # noqa: E402
from ray_tpu.rllib.utils.sample_batch import SampleBatch as JBatch  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_from_flax  # noqa: E402
from ray_tpu_torch.rllib.algorithms.bc import BCLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.marwil import MARWILLearner  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch  # noqa: E402
from test_torch_rllib_offpolicy import (  # noqa: E402
    B1,
    TOL,
    adam_mu,
    hold_grads,
    hold_params,
    perturbed,
    torch_grads,
)

torch.set_num_threads(2)

SPECS = {
    "discrete": dict(observation_dim=4, action_dim=3, discrete=True, hidden=(16, 16)),
    "continuous": dict(observation_dim=3, action_dim=2, discrete=False, hidden=(16,)),
}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _batch(name: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    kw = SPECS[name]
    acts = (rng.integers(0, kw["action_dim"], n) if kw["discrete"]
            else rng.standard_normal((n, kw["action_dim"])).astype(np.float32))
    return {"obs": rng.standard_normal((n, kw["observation_dim"])).astype(np.float32),
            "actions": acts,
            "value_targets": (3.0 * rng.standard_normal(n)).astype(np.float32)}


def _learners(jcls, tcls, name: str, seed: int, **over):
    cfg = {"lr": 1e-3, "seed": 0, **over}
    jl = jcls(JSpec(**SPECS[name]), dict(cfg))
    params = perturbed(jl.params, seed)
    jl.params = jax.tree_util.tree_map(jnp.asarray, params)
    jl.opt_state = jl.optimizer.init(jl.params)
    tl = tcls(RLModuleSpec(**SPECS[name]), {**cfg, "device": "cpu"})
    tl.module.load_state_dict(rl_module_from_flax(params))
    return jl, tl


CASES = [("bc", "discrete", {}), ("bc", "continuous", {}),
         ("marwil", "discrete", {"beta": 0.0}), ("marwil", "discrete", {"beta": 1.0}),
         ("marwil", "continuous", {"beta": 1.0, "max_adv_exponent": 0.5, "vf_coeff": 0.3})]


@pytest.mark.parametrize("algo,name,over", CASES)
def test_offline_loss_and_one_update_match_the_reference(algo, name, over):
    """The loss and its metrics on the same weights, then one padded
    update (64 rows from 45): metrics, gradients and parameters.  MARWIL
    at beta 0 is BC's log-likelihood plus the value regression; the
    clip of the advantage exponent takes part at max_adv_exponent 0.5."""
    jcls, tcls = {"bc": (JBCLearner, BCLearner), "marwil": (JMARWILLearner, MARWILLearner)}[algo]
    jl, tl = _learners(jcls, tcls, name, 2, **over)
    batch = _batch(name, 45, 3)
    jloss, jm = jl.compute_loss(jl.params, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    loss, m = tl.compute_loss({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL, err_msg=k)
    if over.get("beta") == 0.0:
        assert float(m["mean_adv_weight"]) == 1.0
    jm = jl.update_from_batch(JBatch(batch))
    m = tl.update_from_batch(SampleBatch(batch))
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=k)
    grads = torch_grads(tl.optimizer, tl.module)
    hold_grads(grads, _np(rl_module_from_flax(
        jax.tree_util.tree_map(lambda x: np.asarray(x) / (1 - B1), adam_mu(jl.opt_state)))))
    hold_params(tl.get_weights(), _np(rl_module_from_flax(jax.device_get(jl.params))), grads, 1e-3)


def _episodes(n_eps: int, seed: int):
    """Behaviour episodes of 1 to 6 steps with their logp, for 3 actions."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, n_eps)
    n = int(lens.sum())
    return SampleBatch({
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, n),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "action_logp": np.log(rng.uniform(0.2, 0.6, n)).astype(np.float32),
        "eps_id": np.repeat(np.arange(n_eps), lens),
    })


@pytest.mark.parametrize("estimator", ["ImportanceSampling", "WeightedImportanceSampling"])
def test_estimates_match_the_reference(estimator):
    """IS and WIS of one RLModule's weights over the same episodes: the
    target logp comes from the port's module (no gradient, on its
    device), the rest is the reference's numpy."""
    import ray_tpu.rllib.offline as joff

    import ray_tpu_torch.rllib.offline as toff

    kw = SPECS["discrete"]
    jspec = JSpec(**kw)
    params = perturbed(jspec.build().init(jax.random.PRNGKey(0)), 4)
    module = RLModuleSpec(**kw).build()
    batch = _episodes(40, 5)
    want = getattr(joff, estimator)(jspec.build(), jax.tree_util.tree_map(jnp.asarray, params),
                                    gamma=0.9).estimate(JBatch(dict(batch)))
    weights = _np(rl_module_from_flax(params))
    got = getattr(toff, estimator)(module, weights, gamma=0.9).estimate(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


# -- copies of tests/test_rllib_offline.py -------------------------------
def _expert_action(obs) -> int:
    """Scripted CartPole expert: push toward the pole's lean (~200+ return)."""
    return int(obs[2] + 0.5 * obs[3] > 0)


def _cartpole_mixture_rows(n_steps=3000, expert_frac=0.5, seed=0):
    """Mixed expert/random CartPole transitions with episode structure
    (the advantage signal MARWIL needs: expert episodes are long, random
    episodes short)."""
    import gymnasium as gym

    rng = np.random.default_rng(seed)
    env = gym.make("CartPole-v1")
    rows = []
    eps = 0
    use_expert = True
    obs, _ = env.reset(seed=seed)
    steps = 0
    while steps < n_steps:
        a = _expert_action(obs) if use_expert else int(rng.integers(0, 2))
        next_obs, r, term, trunc, _ = env.step(a)
        rows.append(
            {
                "obs": obs.astype(np.float32).tolist(),
                "actions": a,
                "rewards": float(r),
                "terminateds": bool(term),
                "truncateds": bool(trunc),
                "eps_id": eps,
            }
        )
        steps += 1
        if term or trunc:
            eps += 1
            use_expert = rng.random() < expert_frac
            obs, _ = env.reset(seed=seed + eps)
        else:
            obs = next_obs
    env.close()
    return rows


def test_offline_data_next_obs_and_returns():
    """NEXT_OBS shifts inside episodes only; VALUE_TARGETS are the
    per-episode discounted returns-to-go."""
    from ray_tpu_torch.rllib.offline import OfflineData

    rows = [
        # episode 0: two steps
        {"obs": [0.0], "actions": 0, "rewards": 1.0, "terminateds": False, "eps_id": 0},
        {"obs": [1.0], "actions": 1, "rewards": 2.0, "terminateds": True, "eps_id": 0},
        # episode 1: one step
        {"obs": [5.0], "actions": 0, "rewards": 3.0, "terminateds": True, "eps_id": 1},
    ]
    ds = OfflineData(rows).ensure_next_obs().ensure_value_targets(gamma=0.5)
    np.testing.assert_allclose(ds["next_obs"][:, 0], [1.0, 1.0, 5.0])
    # returns-to-go: [1 + 0.5*2, 2, 3]
    np.testing.assert_allclose(ds["value_targets"], [2.0, 2.0, 3.0])


def test_record_rollouts_jsonl_roundtrip(tmp_path):
    """record_rollouts persists JSONL that OfflineData reads back whole."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.offline import OfflineData, record_rollouts

    out = str(tmp_path / "cartpole_random")
    batch = record_rollouts(
        lambda: gym.make("CartPole-v1"),
        lambda obs: int(obs[2] > 0),
        num_steps=120,
        output_path=out,
        seed=3,
    )
    assert batch.count == 120
    ds = OfflineData(out)
    assert ds.count == 120
    np.testing.assert_allclose(
        np.asarray(ds["obs"], np.float32), np.asarray(batch["obs"], np.float32), rtol=1e-6
    )
    assert ds["actions"].dtype.kind in "iu"
    # sampling without replacement below count
    s = ds.sample(32)
    assert s.count == 32 and len(np.unique(s["rewards"], axis=0)) >= 1


def test_marwil_learns_cartpole_from_mixed_data():
    """MARWIL (beta=1) on 50/50 expert/random data reaches expert-like
    eval returns — the advantage weighting must upweight expert episodes
    (reference: BUILD learning_tests_marwil_cartpole)."""
    from ray_tpu_torch.rllib import MARWILConfig

    rows = _cartpole_mixture_rows(n_steps=4000, expert_frac=0.5, seed=1)
    cfg = (
        MARWILConfig()
        .environment("CartPole-v1")
        .offline_data(input_=rows)
        .training(lr=1e-3, train_batch_size=2048, minibatch_size=256,
                  num_epochs=2, beta=1.0)
        .evaluation(evaluation_interval=10, evaluation_duration=5)
        .learners(device="cpu")
        .debugging(seed=7)
    )
    algo = cfg.build()
    best = -np.inf
    for i in range(30):
        out = algo.train()
        if "evaluation" in out:
            best = max(best, out["evaluation"]["episode_return_mean"])
            if best > 120:
                break
    algo.cleanup()
    assert best > 120, f"MARWIL failed to exceed mixed-data baseline: best={best}"


def test_cql_checkpoint_resumes_bc_phase(tmp_path):
    """bc_iters progress survives save/restore (the BC→SAC switch is
    learner state, not a fresh counter)."""
    from ray_tpu_torch.rllib import CQLConfig

    rng = np.random.default_rng(0)
    obs = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    rows = [
        {"obs": o.tolist(), "actions": [float(o[0])], "rewards": 0.0,
         "terminateds": True, "truncateds": False, "eps_id": i}
        for i, o in enumerate(obs)
    ]
    cfg = (
        CQLConfig()  # no env: action bounds come from the data envelope
        .offline_data(input_=rows)
        .training(train_batch_size=32, bc_iters=1000, updates_per_iteration=4,
                  model={"hidden": (16,)})
        .learners(device="cpu")
    )
    algo = cfg.build()
    algo.train()
    assert algo.learner._num_updates == 4
    ckpt = str(tmp_path)
    algo.save_checkpoint(ckpt)
    algo2 = cfg.build()
    algo2.load_checkpoint(ckpt)
    assert algo2.learner._num_updates == 4


@pytest.fixture
def ray_cluster():
    """The port's local cluster (the conftest's fixture of this name starts
    the JAX package's): no 2 GiB shm arena prefault, and no memory
    monitor, which watches the whole machine the suite shares."""
    import ray_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_ppo_evaluation_runners(ray_cluster):
    """evaluate() uses SEPARATE eval runners with explore=False and the
    evaluation_interval wiring lands results under 'evaluation'
    (reference: algorithm.py evaluate()); a copy of the JAX package's
    test, its learner on ``cpu``."""
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, rollout_fragment_length=64)
        .training(train_batch_size=128, minibatch_size=64, num_epochs=1)
        .evaluation(evaluation_interval=2, evaluation_num_env_runners=1,
                    evaluation_duration=3)
        .learners(device="cpu")
    )
    algo = cfg.build()
    out1 = algo.train()
    assert "evaluation" not in out1  # iteration 1: off-interval
    out2 = algo.train()
    ev = out2["evaluation"]
    assert ev["num_episodes"] == 3
    assert np.isfinite(ev["episode_return_mean"])
    assert ev["episode_return_min"] <= ev["episode_return_mean"] <= ev["episode_return_max"]
    # the eval group exists and is distinct from the training group
    assert algo._eval_runner_group is not algo.env_runner_group
    algo.cleanup()


def _logp_of(logits_fn):
    """A minimal target-policy surface: forward_train(obs, actions) whose
    logp comes from ``logits_fn(obs)``."""

    class _Policy:
        def forward_train(self, obs, actions):
            logp_all = torch.log_softmax(logits_fn(obs), dim=-1)
            return logp_all.gather(-1, actions.long()[..., None])[..., 0], None, None

    return _Policy()


def test_off_policy_estimators_recover_known_value():
    """IS and WIS on a synthetic bandit where the answer is computable:
    behavior = uniform over 2 actions, reward = action, target prefers
    action 1 with known probability (reference: rllib/offline/estimators
    tests with known-value MDPs)."""
    from ray_tpu_torch.rllib.offline import ImportanceSampling, WeightedImportanceSampling

    prefers1 = _logp_of(lambda obs: torch.stack(
        [torch.zeros(obs.shape[0]), torch.full((obs.shape[0],), 2.0)], dim=-1))
    rng = np.random.default_rng(0)
    n = 4000
    actions = rng.integers(0, 2, n)
    batch = SampleBatch({
        "obs": np.zeros((n, 1), np.float32),
        "actions": actions.astype(np.int64),
        "rewards": actions.astype(np.float32),   # reward == action
        "action_logp": np.full(n, np.log(0.5), np.float32),
        "eps_id": np.arange(n),                  # 1-step episodes
    })
    p1 = float(torch.softmax(torch.tensor([0.0, 2.0]), 0)[1])  # ≈ 0.8808
    is_est = ImportanceSampling(prefers1, params=None).estimate(batch)
    wis_est = WeightedImportanceSampling(prefers1, params=None).estimate(batch)
    assert is_est["v_behavior"] == pytest.approx(0.5, abs=0.03)
    assert is_est["v_target"] == pytest.approx(p1, abs=0.05)
    assert wis_est["v_target"] == pytest.approx(p1, abs=0.05)
    assert is_est["v_gain"] > 1.5 and wis_est["v_gain"] > 1.5
    assert is_est["num_episodes"] == n

    # interface parity: a real RLModule slots in unchanged
    spec = RLModuleSpec(observation_dim=1, action_dim=2, hidden=(8,))
    module = spec.build(torch.Generator().manual_seed(0))
    out = ImportanceSampling(module).estimate(batch)
    assert np.isfinite(out["v_target"]) and out["num_episodes"] == n

    # missing behavior logp / eps_id / empty batch are loud errors, not
    # silent garbage
    bad = SampleBatch({k: v for k, v in batch.items() if k != "action_logp"})
    with pytest.raises(ValueError, match="action_logp"):
        ImportanceSampling(prefers1, params=None).estimate(bad)
    no_eps = SampleBatch({k: v for k, v in batch.items() if k != "eps_id"})
    with pytest.raises(ValueError, match="eps_id"):
        ImportanceSampling(prefers1, params=None).estimate(no_eps)
    with pytest.raises(ValueError, match="empty"):
        ImportanceSampling(prefers1, params=None).estimate(
            SampleBatch({k: v[:0] for k, v in batch.items()})
        )


def test_wis_is_per_decision():
    """Per-decision WIS: a step where target == behavior keeps weight ~1
    even when LATER steps diverge — an episode-mean weighting would drag
    the diverged ratios into the t=0 reward (reference WIS is
    per-decision)."""
    from ray_tpu_torch.rllib.offline import WeightedImportanceSampling

    def switched(obs):
        """Target logits: uniform when obs==0, strongly prefers action 1
        when obs==1."""
        strength = 4.0 * obs[:, 0]
        return torch.stack([torch.zeros_like(strength), strength], dim=-1)

    rng = np.random.default_rng(1)
    n_eps = 500
    # 2-step episodes: t=0 obs=0 (target==behavior), reward 1;
    #                  t=1 obs=1 (target diverges),  reward 0
    obs = np.tile(np.array([[0.0], [1.0]], np.float32), (n_eps, 1))
    actions = rng.integers(0, 2, 2 * n_eps).astype(np.int64)
    rewards = np.tile(np.array([1.0, 0.0], np.float32), n_eps)
    batch = SampleBatch({
        "obs": obs,
        "actions": actions,
        "rewards": rewards,
        "action_logp": np.full(2 * n_eps, np.log(0.5), np.float32),
        "eps_id": np.repeat(np.arange(n_eps), 2),
    })
    est = WeightedImportanceSampling(_logp_of(switched), params=None, gamma=1.0)
    out = est.estimate(batch)
    # all value sits at t=0 where ratios are exactly 1 -> v_target == v_behavior
    assert out["v_behavior"] == pytest.approx(1.0)
    assert out["v_target"] == pytest.approx(1.0, abs=0.05), out
