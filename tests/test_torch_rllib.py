"""The port's RLlib path against the JAX package's: the RLModule's forwards
and distribution math, PPO's loss, one learner update, the epoch x
minibatch schedule and greedy rollouts, on the same weights (carried by
``models/convert.py``) and inputs made from a numpy seed.

Tolerances: forwards, logp, entropy and losses at 2e-4; after Adam steps
each parameter within 5e-3 lr of the reference's where its gradient is at
least 1e-2 of its tensor's largest, and within the 2 lr that bounds one
Adam step elsewhere (a gradient within float noise of zero may move one
way in one run and the other in the other); Adam's moments within 5e-3 of
each tensor's largest.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib.algorithms.ppo import PPOLearner as JPPOLearner  # noqa: E402
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec  # noqa: E402
from ray_tpu.rllib.utils.sample_batch import SampleBatch as JBatch  # noqa: E402
from ray_tpu_torch.models.convert import q_module_from_flax, rl_module_from_flax  # noqa: E402
from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import QModule, RLModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
CONV = ((8, 4, 2), (16, 3, 2))
FRAME = (20, 20, 3)

# (name, spec kwargs): discrete, continuous, a shared torso, the conv torso
SPECS = {
    "discrete": dict(observation_dim=6, action_dim=3, discrete=True, hidden=(16, 16)),
    "continuous": dict(observation_dim=5, action_dim=2, discrete=False, hidden=(16,)),
    "shared": dict(observation_dim=6, action_dim=4, discrete=True, hidden=(16, 8),
                   vf_share_layers=True),
    "conv": dict(observation_dim=int(np.prod(FRAME)), action_dim=5, discrete=True,
                 hidden=(32,), obs_shape=FRAME, conv_filters=CONV),
}


def _jparams(spec: JSpec, seed: int):
    """The reference's params with every leaf perturbed from a numpy seed
    (zero biases and log_std would hide a transposed or misnamed leaf)."""
    params = spec.build().init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _pair(name: str, seed: int = 0):
    kw = SPECS[name]
    jspec, tspec = JSpec(**kw), RLModuleSpec(**kw)
    params = _jparams(jspec, seed)
    module = tspec.build()
    module.load_state_dict(rl_module_from_flax(params))
    return jspec, params, module


def _obs(name: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if name == "conv":
        return rng.integers(0, 256, size=(n, SPECS[name]["observation_dim"])).astype(np.uint8)
    return rng.standard_normal((n, SPECS[name]["observation_dim"])).astype(np.float32)


def _actions(name: str, n: int, seed: int):
    rng = np.random.default_rng(seed + 1)
    kw = SPECS[name]
    if kw["discrete"]:
        return rng.integers(0, kw["action_dim"], size=n).astype(np.int32)
    return rng.standard_normal((n, kw["action_dim"])).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_rl_module_forwards_match_the_reference(name):
    jspec, params, module = _pair(name)
    jmod = jspec.build()
    obs, acts = _obs(name, 9, 3), _actions(name, 9, 3)
    with torch.no_grad():
        logits, value = module(obs)
        a_inf, v_inf = module.forward_inference(obs)
        logp, ent, v_tr = module.forward_train(obs, acts)
    jlogits, jvalue = jmod.net.apply({"params": params}, obs)
    ja, jv = jmod.forward_inference(params, obs)
    jlogp, jent, jv_tr = jmod.forward_train(params, obs, acts)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), **TOL)
    if jspec.discrete:
        np.testing.assert_array_equal(a_inf.numpy(), np.asarray(ja))
    else:
        np.testing.assert_allclose(a_inf.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(v_inf.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **TOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), **TOL)
    np.testing.assert_allclose(v_tr.numpy(), np.asarray(jv_tr), **TOL)
    # the reference's names, leaf for leaf
    flat = {".".join(p.key for p in path) for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert {k.replace(".weight", ".kernel") for k in module.state_dict()} == flat


def test_q_module_matches_the_reference():
    from ray_tpu.rllib.core.rl_module import QModule as JQModule

    kw = dict(observation_dim=6, action_dim=3, hidden=(16, 16))
    jq = JQModule(JSpec(**kw))
    params = jq.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    q = QModule(RLModuleSpec(**kw))
    q.load_state_dict(q_module_from_flax(params))
    obs = _obs("discrete", 7, 5)
    with torch.no_grad():
        got = q.q_values(obs).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.q_values(params, obs)), **TOL)


@pytest.mark.parametrize("name", ["discrete", "continuous"])
def test_exploration_samples_follow_their_distribution(name):
    """Sampled actions are held by their distribution (a torch generator
    and JAX's keys draw different streams): the categorical's frequencies
    and the Gaussian's mean and std against the reference's logits, and
    the returned logp equal to the reference's logp of those actions."""
    jspec, params, module = _pair(name)
    obs = np.repeat(_obs(name, 1, 4), 20000, axis=0)
    with torch.no_grad():
        acts, logp, value = module.forward_exploration(obs, torch.Generator().manual_seed(0))
    jlogits, jvalue = jspec.build().net.apply({"params": params}, obs[:1])
    jlogits = np.asarray(jlogits)[0]
    if jspec.discrete:
        p = np.exp(jlogits - jlogits.max())
        p /= p.sum()
        freq = np.bincount(acts.numpy(), minlength=len(p)) / len(obs)
        # 20000 draws: 4 standard errors of each frequency
        np.testing.assert_allclose(freq, p, atol=4 * np.sqrt(p * (1 - p) / len(obs)).max())
    else:
        mean, log_std = np.split(jlogits, 2)
        a = acts.numpy()
        std = np.exp(log_std)
        np.testing.assert_allclose(a.mean(0), mean, atol=4 * std.max() / np.sqrt(len(obs)))
        np.testing.assert_allclose(a.std(0), std, rtol=0.03)
    jlogp = jspec.build()._dist_logp(jnp.asarray(np.broadcast_to(jlogits, (len(obs), len(jlogits)))),
                                     jnp.asarray(acts.numpy()))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **TOL)
    np.testing.assert_allclose(value.numpy()[:3], np.repeat(np.asarray(jvalue), 3), **TOL)


def _ppo_batch(name: str, n: int, seed: int):
    rng = np.random.default_rng(seed + 7)
    return {
        "obs": _obs(name, n, seed),
        "actions": _actions(name, n, seed),
        "action_logp": (-1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": (2.0 * rng.standard_normal(n)).astype(np.float32),
    }


PPO_CFG = dict(clip_param=0.2, vf_clip_param=3.0, vf_loss_coeff=0.5, entropy_coeff=0.01,
               lr=1e-3, seed=0)


def _learners(name: str, seed: int, **over):
    cfg = {**PPO_CFG, **over}
    jl = JPPOLearner(JSpec(**SPECS[name]), dict(cfg))
    params = _jparams(JSpec(**SPECS[name]), seed)
    jl.params = jax.tree_util.tree_map(jnp.asarray, params)
    jl.opt_state = jl.optimizer.init(jl.params)
    tl = PPOLearner(RLModuleSpec(**SPECS[name]), {**cfg, "device": "cpu"})
    tl.module.load_state_dict(rl_module_from_flax(params))
    return jl, tl


@pytest.mark.parametrize("name", ["discrete", "continuous", "conv"])
def test_ppo_loss_and_metrics_match_the_reference(name):
    jl, tl = _learners(name, 1)
    batch = _ppo_batch(name, 40, 1)
    jloss, jm = jl.compute_loss(jl.params, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    loss, m = tl.compute_loss({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL, err_msg=k)


def _adam_moments(opt_state):
    """optax's ScaleByAdamState (mu, nu) inside a chain's state."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no adam state")


def _hold(tl, jl, grads, lr, steps=1):
    """The port's parameters and Adam moments against the reference's."""
    jw = {k: v.numpy() for k, v in rl_module_from_flax(jax.device_get(jl.params)).items()}
    got = tl.get_weights()
    assert set(got) == set(jw)
    for k, want in jw.items():
        diff = np.abs(got[k] - want)
        g = np.abs(grads[k])
        sure = g >= 1e-2 * g.max()
        assert diff[sure].max(initial=0.0) <= 5e-3 * lr * steps, k
        assert diff.max() <= 2 * lr * steps, k
    mu, nu = (rl_module_from_flax(jax.device_get(t)) for t in _adam_moments(jl.opt_state))
    state = tl.get_state()["opt_state"]
    for k in jw:
        for name, ref in (("exp_avg", mu[k].numpy()), ("exp_avg_sq", nu[k].numpy())):
            err = np.abs(state[k][name] - ref).max()
            assert err <= 5e-3 * np.abs(ref).max() + 1e-12, (k, name, err)


def _grads(tl, batch):
    """The port's gradient of the loss on ``batch`` at its current
    weights, by parameter name (the module is left as it was)."""
    tl.module.zero_grad(set_to_none=True)
    loss, _ = tl.compute_loss({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    out = {k: p.grad.numpy().copy() for k, p in tl.module.named_parameters()}
    tl.module.zero_grad(set_to_none=True)
    return out


@pytest.mark.parametrize("grad_clip", [None, 0.05])
@pytest.mark.parametrize("rows", [45, 64])
def test_one_update_matches_the_reference(rows, grad_clip):
    """update_from_batch pads the rows by cycling to a multiple of 32 (45
    -> 64, which changes the loss's mean) and clips by optax's global-norm
    rule: parameters, Adam's moments and the metrics after one step."""
    jl, tl = _learners("discrete", 2, grad_clip=grad_clip)
    batch = _ppo_batch("discrete", rows, 2)
    padded = {k: v[np.arange(64) % rows] for k, v in batch.items()}
    grads = _grads(tl, padded)
    jm = jl.update_from_batch(JBatch(batch))
    m = tl.update_from_batch(SampleBatch(batch))
    if grad_clip:
        assert jm["grad_norm"] > grad_clip  # the clip took part
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=k)
    _hold(tl, jl, grads, PPO_CFG["lr"])


@pytest.mark.parametrize("rows,mb,epochs", [(100, 32, 2), (256, 64, 3)])
def test_epoch_schedule_matches_the_references_minibatch_updates(rows, mb, epochs):
    """update_from_batch_epochs walks a permutation from the learner's
    generator: re-derived here from the generator's state, its minibatches
    go in order through the reference's update_from_batch (minibatches of
    a multiple of 32 rows, which it does not pad)."""
    jl, tl = _learners("continuous", 3)
    batch = _ppo_batch("continuous", rows, 3)
    padded_n = -(-rows // mb) * mb
    idx = np.arange(padded_n) % rows
    gen = torch.Generator()
    gen.set_state(tl._gen.get_state())
    perms = [torch.randperm(padded_n, generator=gen).numpy() for _ in range(epochs)]
    grads = _grads(tl, {k: v[idx] for k, v in batch.items()})
    m = tl.update_from_batch_epochs(SampleBatch(batch), mb, epochs)
    jm = None
    for perm in perms:
        for j in range(padded_n // mb):
            sel = idx[perm[j * mb:(j + 1) * mb]]
            jm = jl.update_from_batch(JBatch({k: v[sel] for k, v in batch.items()}))
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=k)
    _hold(tl, jl, grads, PPO_CFG["lr"], steps=epochs * (padded_n // mb))


def test_learner_state_round_trips_through_numpy():
    _, tl = _learners("discrete", 4)
    tl.update_from_batch(SampleBatch(_ppo_batch("discrete", 32, 4)))
    state = tl.get_state()
    assert all(isinstance(v, np.ndarray) for v in state["weights"].values())
    _, fresh = _learners("discrete", 5)
    fresh.set_state(state)
    batch = SampleBatch(_ppo_batch("discrete", 32, 6))
    a, b = tl.update_from_batch(batch), fresh.update_from_batch(batch)
    assert a == b
    for k, v in tl.get_weights().items():
        np.testing.assert_array_equal(fresh.get_weights()[k], v)


def test_greedy_rollouts_match_the_reference():
    """sample(explore=False) on CartPole with the same weights and seeds:
    the same batch, autoreset rows dropped, GAE per episode."""
    import gymnasium as gym

    from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JRunner
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    creator = lambda: gym.make("CartPole-v1")  # noqa: E731
    kw = dict(observation_dim=4, action_dim=2, discrete=True, hidden=(16,))
    params = _jparams(JSpec(**kw), 7)
    jr = JRunner(creator, JSpec(**kw), num_envs=2, rollout_fragment_length=64, seed=3,
                 worker_index=1)
    tr = SingleAgentEnvRunner(creator, RLModuleSpec(**kw), num_envs=2,
                              rollout_fragment_length=64, seed=3, worker_index=1)
    jr.set_weights(params)
    tr.set_weights({k: v.numpy() for k, v in rl_module_from_flax(params).items()})
    for _ in range(2):  # the second fragment starts mid-episode
        want, got = jr.sample(explore=False), tr.sample(explore=False)
        assert got.count == want.count < 128  # autoreset rows dropped
        assert set(got) == set(want)
        for k in ("obs", "rewards", "terminateds", "truncateds", "eps_id"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["actions"], np.asarray(want["actions"]))
        for k in ("vf_preds", "advantages", "value_targets", "action_logp"):
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert tr.get_metrics() == jr.get_metrics()
    jr.stop()
    tr.stop()
