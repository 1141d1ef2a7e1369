"""The port's off-policy learners against the JAX package's: DQN's double-Q
update with prioritized weights, SAC's update, CQL's update in its BC
phase and after it, and the converters that carry SAC's and DreamerV3's
flax trees across (``models/convert.py``).  Same weights (every leaf
perturbed from a numpy seed), same batches.

The reference draws SAC's and CQL's noise inside its jitted update; each
test here rebuilds those draws from the reference learner's key, checks
that they reproduce the reference's own samples, and passes them to the
port's update as tensors.

Tolerances: forwards, losses and metrics at 2e-4; gradients (read from
Adam's first moment after the first step, ``(1 - b1) g`` in both
libraries) at 5e-3 of each tensor's largest; after an Adam step each
parameter within 1e-2 lr of the reference's where its gradient is at
least 1e-2 of its tensor's largest, and within the 2 lr that bounds one
Adam step elsewhere (tests/test_torch_train.py's rule).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib.algorithms.cql import CQLLearner as JCQLLearner  # noqa: E402
from ray_tpu.rllib.algorithms.dqn import DQNLearner as JDQNLearner  # noqa: E402
from ray_tpu.rllib.algorithms.sac import SACLearner as JSACLearner  # noqa: E402
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec  # noqa: E402
from ray_tpu.rllib.utils.sample_batch import SampleBatch as JBatch  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    dreamer_from_flax,
    q_module_from_flax,
    sac_from_flax,
    state_dict_from_jax,
)
from ray_tpu_torch.rllib.algorithms.cql import CQLLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.sac import SACLearner  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
B1 = 0.9  # Adam's first-moment decay in both libraries


def perturbed(tree, seed: int):
    """A flax tree with every leaf moved by 0.05 N(0, 1) from a numpy seed
    (zero biases would hide a transposed or misnamed leaf)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def adam_mu(opt_state):
    """optax's first moment (ScaleByAdamState.mu) inside a chain's state."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu
    raise AssertionError("no adam state")


def torch_grads(optimizer, module) -> dict:
    """The first step's gradients by parameter name, from Adam's first
    moment."""
    return {n: optimizer.state[p]["exp_avg"].cpu().numpy() / (1 - B1)
            for n, p in module.named_parameters() if p in optimizer.state}


def hold_grads(got: dict, want: dict):
    assert set(got) <= set(want)
    for k, g in got.items():
        w = np.asarray(want[k])
        err = np.abs(g - w).max()
        assert err <= 5e-3 * max(np.abs(w).max(), 1e-12), (k, err, np.abs(w).max())


def hold_params(got: dict, want: dict, grads: dict, lr: float):
    """One Adam step's parameters by the rule in the docstring."""
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, w in want.items():
        diff = np.abs(np.asarray(got[k]) - np.asarray(w))
        if k in grads:
            g = np.abs(np.asarray(grads[k]))
            sure = g >= 1e-2 * g.max()
            assert diff[sure].max(initial=0.0) <= 1e-2 * lr, (k, diff[sure].max())
        assert diff.max() <= 2 * lr, (k, diff.max())


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


# -- DQN ----------------------------------------------------------------
DQN_KW = dict(observation_dim=6, action_dim=3, hidden=(16, 16))
DQN_CFG = dict(lr=1e-3, gamma=0.99, seed=0)


def _dqn_pair(seed: int):
    jl = JDQNLearner(JSpec(**DQN_KW), dict(DQN_CFG))
    online, target = perturbed(jl.params, seed), perturbed(jl.params, seed + 1)
    jl.params = jax.tree_util.tree_map(jnp.asarray, online)
    jl.target_params = jax.tree_util.tree_map(jnp.asarray, target)
    jl.opt_state = jl.optimizer.init(jl.params)
    tl = DQNLearner(RLModuleSpec(**DQN_KW), {**DQN_CFG, "device": "cpu"})
    tl.module.load_state_dict(q_module_from_flax(online))
    tl.target.load_state_dict(q_module_from_flax(target))
    return jl, tl


def _dqn_batch(n: int, seed: int, weights: bool):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.standard_normal((n, 6)).astype(np.float32),
         "actions": rng.integers(0, 3, n), "rewards": rng.standard_normal(n).astype(np.float32),
         "next_obs": rng.standard_normal((n, 6)).astype(np.float32),
         "terminateds": rng.random(n) < 0.2, "batch_indexes": np.arange(n)}
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


@pytest.mark.parametrize("weights", [False, True])
def test_dqn_update_matches_the_reference(weights):
    """Loss, Q mean, TD errors, gradients and parameters after one Adam
    step, with and without the prioritized buffer's weights column; then
    a second step from the reference's own second batch."""
    jl, tl = _dqn_pair(1)
    for step in range(2):
        batch = _dqn_batch(32, 10 + step, weights)
        jm = jl.update_from_batch(JBatch(batch))
        m = tl.update_from_batch(SampleBatch(batch))
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=k)
        np.testing.assert_allclose(tl.last_td_error(), jl.last_td_error(), **TOL)
        assert isinstance(tl.last_td_error(), np.ndarray)
        want = _np(q_module_from_flax(jax.device_get(jl.params)))
        if step == 0:
            grads = torch_grads(tl.optimizer, tl.module)
            hold_grads(grads, _np(q_module_from_flax(
                jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1), adam_mu(jl.opt_state)))))
            hold_params(tl.get_weights(), want, grads, DQN_CFG["lr"])
    for k, w in want.items():
        np.testing.assert_allclose(tl.get_weights()[k], w, atol=4 * DQN_CFG["lr"])


def test_dqn_target_is_a_copy_not_an_alias():
    """update_target copies the online weights; an in-place Adam step
    afterwards leaves the target where it was (the reference's identity
    tree_map would alias here), and the target's state round-trips."""
    _, tl = _dqn_pair(2)
    tl.update_target()
    before = {k: v.clone() for k, v in tl.target.state_dict().items()}
    for k, v in tl.module.state_dict().items():
        assert v.data_ptr() != tl.target.state_dict()[k].data_ptr()
        torch.testing.assert_close(before[k], v)
    tl.update_from_batch(SampleBatch(_dqn_batch(32, 3, True)))
    moved = [k for k, v in tl.module.state_dict().items() if not torch.equal(v, before[k])]
    assert moved  # the step moved the online net ...
    for k, v in tl.target.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)  # ... not the target
    state = tl.get_state()
    _, fresh = _dqn_pair(3)
    fresh.set_state(state)
    for k, v in tl.target.state_dict().items():
        torch.testing.assert_close(fresh.target.state_dict()[k], v, rtol=0, atol=0)


# -- SAC and CQL --------------------------------------------------------
SAC_SPEC = dict(observation_dim=3, action_dim=2, discrete=False, hidden=(16, 16))
SAC_CFG = dict(lr=1e-3, gamma=0.99, tau=0.005, initial_alpha=0.5, target_entropy="auto",
               seed=0, hidden=(16, 16), action_low=np.array([-2.0, -1.0], np.float32),
               action_high=np.array([2.0, 1.0], np.float32))


def _sac_pair(jcls, tcls, seed: int, narrow: bool = True, **over):
    """The two learners on the same perturbed weights.  ``narrow`` puts
    the policy's log-std near -2 (its kernel scaled by 0.1, its bias moved
    by -2): the squashed samples then stay inside tanh's well-conditioned
    range, where float32 rounding moves the tanh correction log(1 - a^2 +
    1e-6) by far less than the tolerance
    (test_sac_tanh_correction_near_the_bounds holds the rest)."""
    cfg = {**SAC_CFG, **over}
    jl = jcls(JSpec(**SAC_SPEC), dict(cfg))
    pi = perturbed(jl.pi_params, seed)
    if narrow:
        pi["pi_log_std"]["kernel"] = pi["pi_log_std"]["kernel"] * np.float32(0.1)
        pi["pi_log_std"]["bias"] = pi["pi_log_std"]["bias"] - np.float32(2.0)
    jl.pi_params = jax.tree_util.tree_map(jnp.asarray, pi)
    jl.q_params = jax.tree_util.tree_map(jnp.asarray, perturbed(jl.q_params, seed + 1))
    jl.target_q_params = jax.tree_util.tree_map(jnp.asarray, perturbed(jl.q_params, seed + 2))
    jl.pi_opt_state = jl.pi_opt.init(jl.pi_params)
    jl.q_opt_state = jl.q_opt.init(jl.q_params)
    tl = tcls(RLModuleSpec(**SAC_SPEC), {**cfg, "device": "cpu"})
    sd = sac_from_flax(jax.device_get(jl.get_state()), RLModuleSpec(**SAC_SPEC), cfg["hidden"])
    tl.set_state({**{k: _np(v) for k, v in sd.items()},
                  "log_alpha": np.asarray(jl.log_alpha)})
    return jl, tl


def _sac_batch(n: int, seed: int, truncateds: bool = False):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
         # some actions at the bounds: _unscale's clip to +-0.999999 takes part
         "actions": np.clip(rng.uniform(-2.2, 2.2, (n, 2)) * [1.0, 0.5], [-2, -1], [2, 1]
                            ).astype(np.float32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
         "terminateds": rng.random(n) < 0.2}
    if truncateds:
        b["truncateds"] = rng.random(n) < 0.2
    return b


def _sac_draws(jl, batch, cql: bool):
    """The reference's draws for its next update, rebuilt from its key
    (update_from_batch: split, then split into rng_next, rng_pi and for
    CQL rng_cql, rng_cql2, each a (uniform, policy) split), each checked
    against the reference's own sample."""
    n, adim = len(batch["obs"]), SAC_SPEC["action_dim"]
    _, rng = jax.random.split(jl._rng)
    keys = jax.random.split(rng, 4) if cql else jax.random.split(rng)
    noise = {"eps_next": jax.random.normal(keys[0], (n, adim)),
             "eps_pi": jax.random.normal(keys[1], (n, adim))}
    for key, src in zip(keys[2:], ("obs", "next_obs")):
        rows = n * jl.config["num_actions"]
        r_unif, r_pi = jax.random.split(key)
        noise[f"unif_{src}"] = jax.random.uniform(r_unif, (rows, adim), minval=-1.0, maxval=1.0)
        noise[f"pi_{src}"] = jax.random.normal(r_pi, (rows, adim))
        rep = jnp.repeat(jnp.asarray(batch[src]), jl.config["num_actions"], axis=0)
        _check_draw(jl, rep, r_pi, noise[f"pi_{src}"])
    _check_draw(jl, jnp.asarray(batch["next_obs"]), keys[0], noise["eps_next"])
    _check_draw(jl, jnp.asarray(batch["obs"]), keys[1], noise["eps_pi"])
    return {k: np.asarray(v) for k, v in noise.items()}


def _check_draw(jl, obs, key, eps):
    """The reference's squashed sample with ``key`` is tanh(mean + std eps)."""
    a, _ = jl._pi_sample_logp(jl.pi_params, obs, key)
    mean, log_std = jl.pi_net.apply({"params": jl.pi_params}, obs)
    np.testing.assert_allclose(np.asarray(jnp.tanh(mean + jnp.exp(log_std) * eps)), np.asarray(a),
                               rtol=1e-6, atol=1e-6)


def _hold_sac(jl, tl, first: bool):
    lr = SAC_CFG["lr"]
    state = jax.device_get(jl.get_state())
    want = sac_from_flax(state, RLModuleSpec(**SAC_SPEC), SAC_CFG["hidden"])
    got = tl.get_state()
    for key, opt, module in (("pi", tl.pi_opt, tl.pi_net), ("q", tl.q_opt, tl.q_net)):
        grads = torch_grads(opt, module)
        if first:
            mu = adam_mu(jl.pi_opt_state if key == "pi" else jl.q_opt_state)
            hold_grads(grads, _np(state_dict_from_jax(
                jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1), mu))))
            hold_params(got[key], _np(want[key]), grads, lr)
        else:
            hold_params(got[key], _np(want[key]), {}, 2 * lr)
    # Polyak: the target moved tau of the way to the updated critics
    for k, w in _np(want["target_q"]).items():
        np.testing.assert_allclose(got["target_q"][k], w, **TOL, err_msg=k)
    np.testing.assert_allclose(got["log_alpha"], np.asarray(state["log_alpha"]), atol=lr * 1e-2)


def test_sac_update_matches_the_reference():
    """Two updates with the reference's draws: the critics step first,
    the actor's loss reads the updated critics, alpha reads the actor's
    logp, Polyak last; every metric at 2e-4, the first step's gradients
    and parameters, the target critics and log_alpha."""
    jl, tl = _sac_pair(JSACLearner, SACLearner, 3)
    for step in range(2):
        batch = _sac_batch(32, 20 + step)
        noise = _sac_draws(jl, batch, cql=False)
        jm = jl.update_from_batch(JBatch(batch))
        m = tl.update_from_batch(SampleBatch(batch), noise=noise)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=(step, k))
        _hold_sac(jl, tl, first=step == 0)


def test_cql_update_matches_the_reference_in_and_after_its_bc_phase():
    """bc_iters=1: the first update's actor clones the data's actions,
    the second takes SAC's loss; the conservative penalty's uniform and
    policy samples (``repeat_interleave`` of each row) in both; truncated
    rows count as done for the target."""
    jl, tl = _sac_pair(JCQLLearner, CQLLearner, 5, bc_iters=1, num_actions=3,
                       min_q_weight=2.0, temperature=0.7)
    for step in range(2):
        batch = _sac_batch(32, 30 + step, truncateds=True)
        noise = _sac_draws(jl, batch, cql=True)
        jm = jl.update_from_batch(JBatch(batch))
        m = tl.update_from_batch(SampleBatch(batch), noise=noise)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=(step, k))
        _hold_sac(jl, tl, first=step == 0)
    assert tl.get_state()["num_updates"] == 2


def test_sac_tanh_correction_near_the_bounds():
    """Wide policies saturate tanh: a change da of ``a`` near +-1 moves
    log(1 - a^2 + 1e-6) by about 2 |a| da / (1 - a^2 + 1e-6), so there
    the logp is held to that bound for the samples' own difference plus
    one float32 ulp (it reached 0.4 against the reference's); the samples
    themselves at 1e-6 and every well-conditioned row's logp at 2e-4."""
    jl, tl = _sac_pair(JSACLearner, SACLearner, 3, narrow=False)
    obs = 3.0 * np.random.default_rng(6).standard_normal((256, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    eps = jax.random.normal(key, (256, 2))
    ja, jlogp = jl._pi_sample_logp(jl.pi_params, jnp.asarray(obs), key)
    with torch.no_grad():
        a, logp = tl._pi_sample_logp(torch.from_numpy(obs), torch.from_numpy(np.asarray(eps)))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    da = np.abs(a.numpy() - np.asarray(ja)) + np.spacing(np.float32(1.0))
    a = a.numpy().astype(np.float64)
    bound = (2 * np.abs(a) * da / (1 - a ** 2 + 1e-6)).sum(-1) * 2 + 2e-4
    err = np.abs(logp.numpy() - np.asarray(jlogp))
    saturated = (1 - a ** 2 < 1e-3).any(-1)
    assert saturated.sum() >= 16  # the case this test is for
    assert (err <= bound).all(), (err.max(), bound[err.argmax()])
    np.testing.assert_allclose(logp.numpy()[~saturated], np.asarray(jlogp)[~saturated], **TOL)


def test_sac_state_round_trips_and_draws_noise_from_its_generator():
    """Without ``noise`` the update draws from the learner's generator:
    two learners of one seed take the same update.  The state (numpy
    throughout; as the reference's, no optimizer moments) carries every
    network and log_alpha to a fresh learner."""
    _, a = _sac_pair(JSACLearner, SACLearner, 7)
    _, b = _sac_pair(JSACLearner, SACLearner, 7)
    batch = SampleBatch(_sac_batch(32, 40))
    assert a.update_from_batch(batch) == b.update_from_batch(batch)
    state = a.get_state()
    assert all(isinstance(v, np.ndarray) for k in ("pi", "q", "target_q") for v in state[k].values())
    _, c = _sac_pair(JSACLearner, SACLearner, 9)
    c.set_state(state)
    for key, got in c.get_state().items():
        if key != "config":
            for k, v in (got.items() if isinstance(got, dict) else [("", got)]):
                np.testing.assert_array_equal(v, state[key][k] if k else state[key])


# -- converters ---------------------------------------------------------
def test_sac_from_flax_names_shapes_and_refusals():
    jl = JSACLearner(JSpec(**SAC_SPEC), dict(SAC_CFG))
    state = jax.device_get(jl.get_state())
    out = sac_from_flax(state, RLModuleSpec(**SAC_SPEC), (16, 16))
    assert set(out) == {"pi", "q", "target_q"}
    assert out["pi"]["pi_dense_0.weight"].shape == (16, 3)
    assert out["pi"]["pi_log_std.weight"].shape == (2, 16)
    assert out["q"]["q2_dense_0.weight"].shape == (16, 5)  # obs and action concatenated
    np.testing.assert_array_equal(out["q"]["q1_out.weight"].numpy(),
                                  np.asarray(state["q"]["q1_out"]["kernel"]).T)
    missing = {**state, "q": {k: v for k, v in state["q"].items() if k != "q2_out"}}
    with pytest.raises(ValueError, match="missing leaves.*q2_out"):
        sac_from_flax(missing, RLModuleSpec(**SAC_SPEC), (16, 16))
    with pytest.raises(ValueError, match="pi_dense_1.weight is"):
        sac_from_flax(state, RLModuleSpec(**SAC_SPEC), (16, 8))


DREAMER_KW = dict(deter_size=16, stoch_groups=4, stoch_classes=4, hidden=(16,), seq_len=4,
                  batch_seqs=3, horizon=3)


def _dreamer_state():
    from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3Config as JConfig
    from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3Learner as JLearner
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config

    jl = JLearner(JConfig().training(**DREAMER_KW), 5, 3)
    return jl, perturbed(jl.get_state(), 1), DreamerV3Config().training(**DREAMER_KW)


def test_dreamer_from_flax_maps_the_gru_gates_and_refuses_bad_leaves():
    """flax's GRUCell (biases on ir, iz, in, hn only) becomes nn.GRUCell's
    (r, z, n) stacks with bias_hh [0, 0, b_hn]; one cell step agrees; the
    MLPs keep flax's names; a missing or mis-shaped leaf is refused."""
    from flax import linen as fnn

    jl, state, cfg = _dreamer_state()
    out = dreamer_from_flax(state, cfg, 5, 3)
    assert set(out) == {"wm", "actor", "critic", "target_critic"}
    gru, d = state["wm"]["gru"], cfg.deter_size
    bias_hh = out["wm"]["gru.bias_hh"].numpy()
    np.testing.assert_array_equal(bias_hh[:2 * d], 0.0)
    np.testing.assert_array_equal(bias_hh[2 * d:], gru["hn"]["bias"])
    np.testing.assert_array_equal(out["wm"]["gru.bias_ih"].numpy()[d:2 * d], gru["iz"]["bias"])
    np.testing.assert_array_equal(out["wm"]["gru.weight_hh"].numpy()[:d], gru["hr"]["kernel"].T)
    assert out["wm"]["prior.LayerNorm_0.weight"].shape == (16,)
    cell = torch.nn.GRUCell(gru["ir"]["kernel"].shape[0], d)
    cell.load_state_dict({k[4:]: v for k, v in out["wm"].items() if k.startswith("gru.")})
    rng = np.random.default_rng(4)
    h = rng.standard_normal((5, d)).astype(np.float32)
    x = rng.standard_normal((5, gru["ir"]["kernel"].shape[0])).astype(np.float32)
    want, _ = fnn.GRUCell(features=d).apply({"params": gru}, jnp.asarray(h), jnp.asarray(x))
    with torch.no_grad():
        got = cell(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bad = jax.tree_util.tree_map(lambda a: a, state)
    del bad["wm"]["gru"]["hn"]["bias"]
    with pytest.raises(ValueError, match="gru: leaves"):
        dreamer_from_flax(bad, cfg, 5, 3)
    bad = jax.tree_util.tree_map(lambda a: a, state)
    bad["wm"]["gru"]["hz"]["kernel"] = np.zeros((d, d + 1), np.float32)
    with pytest.raises(ValueError, match="gru.hz.kernel"):
        dreamer_from_flax(bad, cfg, 5, 3)
    bad = jax.tree_util.tree_map(lambda a: a, state)
    del bad["wm"]["decoder"]["LayerNorm_0"]
    with pytest.raises(ValueError, match="missing leaves.*decoder.LayerNorm_0"):
        dreamer_from_flax(bad, cfg, 5, 3)
    with pytest.raises(ValueError, match="is"):
        dreamer_from_flax(state, cfg, 6, 3)  # the encoder's and decoder's widths
