"""The port's DreamerV3 against the JAX package's at a small config (deter
16, 4 x 4 stochastic, hidden (16,), sequences of 4, horizon 3): the RSSM's
posterior and prior steps, the world-model loss and its gradients, the
lambda-returns, and one whole update (world model, actor, critic, the
critic's EMA target), on the same weights (``dreamer_from_flax``) and
batches.

The reference samples its categoricals inside the jitted update; the
tests rebuild its Gumbel draws from its keys (``jax.random.categorical(k,
l)`` is ``argmax(l + jax.random.gumbel(k, l.shape))``, which each test
checks first) and pass them to the port.  The reference's world-model
loss, imagination and lambda-returns are closures inside its update;
the tests take them from there.

Tolerances: forwards, losses and returns at 2e-4; gradients at 5e-3 of
each tensor's largest (the update's read from AdamW's first moment,
``(1 - b1) g`` in both libraries); after an AdamW step each parameter
within 1e-2 lr where its gradient is at least 1e-2 of its tensor's
largest, else 2 lr (tests/test_torch_train.py's rule).
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3Config as JConfig  # noqa: E402
from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3Learner as JLearner  # noqa: E402
from ray_tpu_torch.models.convert import dreamer_from_flax  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (  # noqa: E402
    DreamerV3Config,
    DreamerV3Learner,
    _SequenceReplay,
)
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

KW = dict(deter_size=16, stoch_groups=4, stoch_classes=4, hidden=(16,), seq_len=4,
          batch_seqs=3, horizon=3)
OBS, ACTS = 5, 3
G, C = KW["stoch_groups"], KW["stoch_classes"]


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _pair(seed: int = 1):
    """The reference learner on perturbed weights and the port's on the
    same; fresh AdamW states on both sides."""
    jcfg = JConfig().training(**KW)
    jl = JLearner(jcfg, OBS, ACTS)
    state = perturbed(jl.get_state(), seed)
    state["target_critic"] = perturbed(state["critic"], seed + 1)
    jl.set_state(state)
    jl.wm_os = jl.wm_opt.init(jl.wm_params)
    jl.actor_os = jl.actor_opt.init(jl.actor_params)
    jl.critic_os = jl.critic_opt.init(jl.critic_params)
    cfg = DreamerV3Config().training(**KW).learners(device="cpu")
    tl = DreamerV3Learner(cfg, OBS, ACTS)
    tl.set_state({k: _np(v) for k, v in dreamer_from_flax(state, cfg, OBS, ACTS).items()})
    return jl, tl


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    B, L = KW["batch_seqs"], KW["seq_len"]
    is_first = (rng.random((B, L)) < 0.2).astype(np.float32)
    is_first[:, 0] = 1.0
    return {"obs": (2.0 * rng.standard_normal((B, L, OBS))).astype(np.float32),
            "prev_actions": np.eye(ACTS, dtype=np.float32)[rng.integers(0, ACTS, (B, L))],
            "rewards": rng.standard_normal((B, L)).astype(np.float32),
            "terminateds": (rng.random((B, L)) < 0.2).astype(np.float32),
            "is_first": is_first}


def _checked_gumbel(key, shape):
    """``jax.random.gumbel(key, shape)``, checked to be the noise behind
    ``jax.random.categorical(key, logits)`` for logits of that shape."""
    g = jax.random.gumbel(key, shape)
    logits = jax.random.normal(jax.random.PRNGKey(17), shape)
    assert bool((jax.random.categorical(key, logits, axis=-1) == jnp.argmax(logits + g, -1)).all())
    return np.asarray(g)


def _draws(jl):
    """The Gumbel noise of the reference's next update, rebuilt from its
    key: update_from_batch splits the key, the update splits r_wm and
    r_img; the world model splits r_wm once a step, the imagination r_img
    once a step, each into the action's key and the prior sample's."""
    B, L, H = KW["batch_seqs"], KW["seq_len"], KW["horizon"]
    n = B * L
    _, rng = jax.random.split(jl._rng)
    r_wm, r_img = jax.random.split(rng)
    post = [_checked_gumbel(k, (B, G, C)) for k in jax.random.split(r_wm, L)]
    act, img = [], []
    for k in jax.random.split(r_img, H):
        r1, r2 = jax.random.split(k)
        act.append(_checked_gumbel(r1, (n, ACTS)))
        img.append(_checked_gumbel(r2, (n, G, C)))
    return {"post": np.stack(post), "act": np.stack(act), "img": np.stack(img)}, (r_wm, r_img)


def _closures(jl) -> dict:
    """The reference update's inner functions: wm_loss and imagine from
    its closure, lambda_returns rebuilt from its code object over the same
    free variables."""
    update = jl._build_update_fn().__wrapped__
    cells = dict(zip(update.__code__.co_freevars, update.__closure__))
    out = {name: cells[name].cell_contents for name in ("wm_loss", "imagine")}
    code = next(c for c in update.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "lambda_returns")
    out["lambda_returns"] = types.FunctionType(
        code, update.__globals__, "lambda_returns", None,
        tuple(cells[name] for name in code.co_freevars))
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_rssm_steps_match_the_reference():
    """obs_step (GRU, prior and posterior heads, the straight-through
    sample) and img_step on the same Gumbel draws as the reference's
    keys; the sample is the reference's own one-hot."""
    jl, tl = _pair(2)
    rng = np.random.default_rng(3)
    n, s = 6, G * C
    h = rng.standard_normal((n, KW["deter_size"])).astype(np.float32)
    z = np.eye(C, dtype=np.float32)[rng.integers(0, C, (n, G))].reshape(n, s)
    embed = rng.standard_normal((n, KW["deter_size"])).astype(np.float32)
    a = np.eye(ACTS, dtype=np.float32)[rng.integers(0, ACTS, n)]
    key = jax.random.PRNGKey(5)
    g = _checked_gumbel(key, (n, G, C))
    jh, jz, jprior, jpost = jl.nets.obs_step(jl.wm_params, h, embed, z, a, key)
    ih, iz = jl.nets.img_step(jl.wm_params, h, z, a, key)
    with torch.no_grad():
        th, tz, tprior, tpost = tl.nets.obs_step(*map(torch.from_numpy, (h, embed, z, a, g)))
        uh, uz = tl.nets.img_step(*map(torch.from_numpy, (h, z, a, g)))
    for got, want in ((th, jh), (tz, jz), (tprior, jprior), (tpost, jpost), (uh, ih), (uz, iz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the straight-through sample is the one-hot of the reference's class
    np.testing.assert_array_equal(tz.numpy().reshape(n, G, C).argmax(-1),
                                  np.asarray(jz).reshape(n, G, C).argmax(-1))


def test_world_model_loss_gradients_and_lambda_returns_match_the_reference():
    """The world model's loss terms and feats over a sequence with resets
    inside it, its gradients for every world-model leaf (the GRU's
    through the gate mapping, r's and z's hidden biases at zero), the
    imagination's feats, logp, entropy, rewards and continues, and the
    lambda-returns on them."""
    jl, tl = _pair(4)
    batch = _batch(5)
    noise, (r_wm, r_img) = _draws(jl)
    ref = _closures(jl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jfeat, jmet)), jgrads = jax.jit(jax.value_and_grad(ref["wm_loss"], has_aux=True))(
        jl.wm_params, jb, r_wm)
    tl.wm_opt.zero_grad(set_to_none=True)
    loss, feat, met = tl._wm_loss(_tensors(batch), torch.from_numpy(noise["post"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), **TOL)
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), **TOL, err_msg=k)
    state = jax.device_get(jl.get_state())
    want = dreamer_from_flax({**state, "wm": jax.device_get(jgrads)}, tl.cfg, OBS, ACTS)["wm"]
    hold_grads({n: p.grad.numpy() for n, p in tl.nets.named_parameters()}, _np(want))

    feat0 = jfeat.reshape(-1, tl.nets.feat_dim)
    jfeats, jlogps, jents, jrews, jconts = jax.jit(ref["imagine"])(
        jl.wm_params, jl.actor_params, feat0, r_img)
    with torch.no_grad():
        feats, logps, ents, rews, conts = tl._imagine(
            torch.from_numpy(np.asarray(feat0)), torch.from_numpy(noise["act"]),
            torch.from_numpy(noise["img"]))
    for got, want in ((feats, jfeats), (logps, jlogps), (ents, jents), (rews, jrews),
                      (conts, jconts)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    values = np.asarray(jrews) * 0.5 + 1.0  # any values: the recursion is what is held
    jrets = jax.jit(ref["lambda_returns"])(jrews, jconts, jnp.asarray(values))
    rets = tl.lambda_returns(rews, conts, torch.from_numpy(values))
    assert rets.shape == (KW["horizon"] - 1, feat0.shape[0])
    np.testing.assert_allclose(rets.numpy(), np.asarray(jrets), **TOL)


def test_one_update_matches_the_reference():
    """A whole update with the reference's draws: every metric at 2e-4;
    the world model's, the actor's and the critic's gradients and
    parameters after their AdamW steps (weight decay 1e-4, optax's); the
    critic's EMA target; then a second update from the reference's next
    draws."""
    jl, tl = _pair(6)
    cfg = tl.cfg
    for step in range(2):
        batch = _batch(10 + step)
        noise, _ = _draws(jl)
        jm = jl.update_from_batch(batch)
        m = tl.update_from_batch(batch, noise=noise)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=(step, k))
        state = jax.device_get(jl.get_state())
        want = {k: _np(v) for k, v in dreamer_from_flax(state, cfg, OBS, ACTS).items()}
        got = tl.get_state()
        if step == 0:
            mus = {key: jax.tree_util.tree_map(lambda x: np.asarray(x) / (1 - B1), adam_mu(os))
                   for key, os in (("wm", jl.wm_os), ("actor", jl.actor_os),
                                   ("critic", jl.critic_os))}
            grad_want = {k: _np(v) for k, v in dreamer_from_flax(
                {**mus, "target_critic": mus["critic"]}, cfg, OBS, ACTS).items()}
            for key, opt, module, lr in (("wm", tl.wm_opt, tl.nets, cfg.lr),
                                         ("actor", tl.actor_opt, tl.actor, cfg.actor_lr),
                                         ("critic", tl.critic_opt, tl.critic, cfg.critic_lr)):
                grads = torch_grads(opt, module)
                hold_grads(grads, grad_want[key])
                hold_params(got[key], want[key], grads, lr)
        for k, w in want["target_critic"].items():
            np.testing.assert_allclose(got["target_critic"][k], w, **TOL, err_msg=k)
    # r's and z's hidden biases never move off zero (flax has none)
    d = cfg.deter_size
    np.testing.assert_array_equal(tl.get_state()["wm"]["gru.bias_hh"][:2 * d], 0.0)


def test_update_draws_its_noise_from_the_learners_generator():
    """Without ``noise`` two learners of one seed take the same update;
    ``act`` returns a one-hot of the action it takes."""
    _, a = _pair(7)
    _, b = _pair(7)
    batch = _batch(12)
    assert a.update_from_batch(batch) == b.update_from_batch(batch)
    state, act, onehot = a.act((*a.policy_state(), None), np.ones(OBS, np.float32))
    assert onehot.shape == (1, ACTS) and onehot[0, act] == 1.0 and onehot.sum() == 1.0
    assert state[0].shape == (1, KW["deter_size"])


def test_sequence_replay_windows_wrap_with_is_first():
    """The numpy fork of the reference's replay: [B, L] windows, a window
    that crosses its episode's end wraps to its start with is_first set."""
    replay = _SequenceReplay(capacity_steps=30, seq_len=6, seed=0)
    for n in (5, 9, 20):
        replay.add_episode({"obs": np.arange(n, dtype=np.float32)[:, None],
                            "prev_actions": np.zeros((n, 2), np.float32),
                            "rewards": np.arange(n, dtype=np.float32),
                            "terminateds": np.zeros(n, np.float32)})
    assert len(replay) == 29 and len(replay.episodes) == 2  # the first was evicted
    out = replay.sample(64)
    assert out["obs"].shape == (64, 6, 1) and out["is_first"].shape == (64, 6)
    assert (out["is_first"][:, 0] == 1.0).all()
    wrapped = out["rewards"] == 0.0
    assert (out["is_first"][wrapped] == 1.0).all()
