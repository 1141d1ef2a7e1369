"""The podracer plane's arithmetic against the JAX package's: V-trace,
IMPALA's and APPO's losses and gradients, PPO's GAE over fragments
(``prepare_fragments``, also against the host GAE), the time-major merge
of K fragments and one ``update_from_fragments`` step on IMPALA's and
PPO's branches.  The same weights (carried by ``models/convert.py``) and
inputs made from a numpy seed go through both packages.

Nothing here draws: the updates take one minibatch that is the whole
fragment, so the reference's in-jit permutation and the port's generator
only reorder a mean.  Tolerances: values, metrics and losses 2e-4;
gradients within 5e-3 of each tensor's largest entry; parameters and
Adam's moments after a step by ``tests/test_torch_rllib.py``'s rule.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib.algorithms import impala as jimpala  # noqa: E402
from ray_tpu.rllib.algorithms.appo import APPOLearner as JAPPOLearner  # noqa: E402
from ray_tpu.rllib.algorithms.ppo import PPOLearner as JPPOLearner  # noqa: E402
from ray_tpu.rllib.core.learner import Learner as JLearner  # noqa: E402
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_from_flax  # noqa: E402
from ray_tpu_torch.rllib.algorithms import impala  # noqa: E402
from ray_tpu_torch.rllib.algorithms.appo import APPOLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner  # noqa: E402
from ray_tpu_torch.rllib.core.learner import Learner  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.utils.postprocessing import compute_gae  # noqa: E402
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch  # noqa: E402
from test_torch_rllib import SPECS, TOL, _hold, _jparams, _obs  # noqa: E402

torch.set_num_threads(2)

GRAD_TOL = 5e-3
COLS = ("obs", "actions", "rewards", "terminateds", "truncateds", "action_logp", "vf_preds",
        "loss_mask")
CFG = dict(gamma=0.95, lambda_=0.9, vtrace_clip_rho=1.0, vtrace_clip_c=0.9,
           vf_loss_coeff=0.5, entropy_coeff=0.01, clip_param=0.3, vf_clip_param=3.0,
           kl_coeff=0.7, lr=1e-3, seed=0)


def _fragment(name: str, T: int, N: int, seed: int) -> dict:
    """One [T, N] fragment as a runner writes it: a termination and a
    truncation mid-fragment, each followed by its autoreset row (loss
    mask 0), numpy columns of the runner's dtypes."""
    rng = np.random.default_rng(seed)
    term = np.zeros((T, N), bool)
    trunc = np.zeros((T, N), bool)
    term[T // 3, 0] = True
    trunc[T // 2, N - 1] = True
    mask = np.ones((T, N), np.float32)
    mask[T // 3 + 1, 0] = 0.0
    mask[T // 2 + 1, N - 1] = 0.0
    return {
        "cols": {
            "obs": _obs(name, T * N, seed).reshape(T, N, -1),
            "actions": rng.integers(0, SPECS[name]["action_dim"], size=(T, N)).astype(np.int64),
            "rewards": rng.standard_normal((T, N)).astype(np.float32),
            "terminateds": term,
            "truncateds": trunc,
            "action_logp": (np.log(1.0 / SPECS[name]["action_dim"])
                            + 0.3 * rng.standard_normal((T, N))).astype(np.float32),
            "vf_preds": rng.standard_normal((T, N)).astype(np.float32),
            "loss_mask": mask,
        },
        "last_values": rng.standard_normal(N).astype(np.float32),
        "env_steps": int(mask.sum()),
    }


def _jcols(frag: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if k == "actions" else v)
            for k, v in frag["cols"].items()}


def _tcols(frag: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in frag["cols"].items()}


def _pair(jcls, tcls, name: str, seed: int, **over):
    """The reference's learner and the port's (on the CPU) on the same
    perturbed weights, Adam fresh on both."""
    cfg = {**CFG, **over}
    jspec, tspec = JSpec(**SPECS[name]), RLModuleSpec(**SPECS[name])
    jl = jcls(jspec, dict(cfg))
    params = _jparams(jspec, seed)
    jl.params = jax.tree_util.tree_map(jnp.asarray, params)
    jl.opt_state = jl.optimizer.init(jl.params)
    tl = tcls(tspec, {**cfg, "device": "cpu"})
    tl.module.load_state_dict(rl_module_from_flax(params))
    if hasattr(jl, "old_params"):  # APPO: the target policy starts at these weights
        jl.old_params = jax.tree_util.tree_map(jnp.copy, jl.params)
        tl.old_params = tl._copy_params()
    return jl, tl


def _jgrads(jl, loss_of):
    """(loss, metrics, {name: gradient}) of the reference's ``loss_of``
    at its weights, in one jitted value-and-grad."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jl.params)
    grads = {k: v.numpy() for k, v in rl_module_from_flax(jax.device_get(grads)).items()}
    return loss, metrics, grads


def _tgrads(tl, loss_of):
    """(loss, metrics, {name: gradient}) of ``loss_of()`` at the port's
    weights (the module is left as it was)."""
    tl.module.zero_grad(set_to_none=True)
    loss, metrics = loss_of()
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in tl.module.named_parameters()}
    tl.module.zero_grad(set_to_none=True)
    return loss, metrics, grads


def _hold_loss(got, want):
    loss, metrics, grads = got
    jloss, jmetrics, jgrads = want
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **TOL, err_msg=k)
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        err = np.abs(grads[k] - g).max()
        assert err <= GRAD_TOL * np.abs(g).max() + 1e-8, (k, err, np.abs(g).max())


@pytest.mark.parametrize("bootstrap", [True, False])
def test_vtrace_returns_match_the_reference(bootstrap):
    """A [12, 3] sequence with a termination, a truncation and the
    runner's bootstrap value (or, on the flat path, none: the last row's
    value stands in); rho and c clips that bind."""
    rng = np.random.default_rng(11)
    T, B = 12, 3
    logp = (-1.0 + 0.6 * rng.standard_normal((T, B))).astype(np.float32)
    blogp = (-1.0 + 0.6 * rng.standard_normal((T, B))).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    done = np.zeros((T, B), np.float32)
    done[4, 0] = 1.0  # termination
    done[7, 2] = 1.0  # truncation: cuts the chain the same way
    discounts = (0.95 * (1.0 - done)).astype(np.float32)
    boot = rng.standard_normal(B).astype(np.float32) if bootstrap else None
    want = jimpala.vtrace_returns(*map(jnp.asarray, (logp, blogp, values, rewards, discounts)),
                                  1.0, 0.8, None if boot is None else jnp.asarray(boot))
    got = impala.vtrace_returns(*map(torch.as_tensor, (logp, blogp, values, rewards, discounts)),
                                1.0, 0.8, None if boot is None else torch.as_tensor(boot))
    for name, g, w in zip(("vs", "pg_adv", "rhos"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    assert (np.asarray(want[2]) > 1.0).any() and (np.asarray(want[2]) < 0.8).any()


@pytest.mark.parametrize("name", ["discrete", "conv"])
@pytest.mark.parametrize("path", ["flat", "fragment"])
def test_impala_losses_and_gradients_match_the_reference(name, path):
    """IMPALA's V-trace loss on the flat time-ordered path
    (``compute_loss``) and on a [T, N] fragment with its bootstrap values
    (``fragment_loss``): the loss, every metric and every gradient."""
    jl, tl = _pair(jimpala.IMPALALearner, impala.IMPALALearner, name, 2)
    frag = _fragment(name, 10, 3, 4)
    if path == "flat":  # one env's column as a time sequence
        jb = {k: v[:, 0] for k, v in _jcols(frag).items()}
        tb = {k: v[:, 0] for k, v in _tcols(frag).items()}

        def jloss(p):
            return jl.compute_loss(p, jb, None)

        def tloss():
            return tl.compute_loss(tb)
    else:
        jlast, tlast = jnp.asarray(frag["last_values"]), torch.as_tensor(frag["last_values"])

        def jloss(p):
            return jl.fragment_loss(p, _jcols(frag), jlast, None)

        def tloss():
            return tl.fragment_loss(_tcols(frag), tlast)
    want = _jgrads(jl, jloss)
    _hold_loss(_tgrads(tl, tloss), want)


@pytest.mark.parametrize("use_kl_loss", [False, True])
def test_appo_loss_and_gradients_match_the_reference(use_kl_loss):
    """APPO's clipped surrogate on V-trace advantages against the target
    policy: its ``target_logp`` (``before_update``, from the target's
    copy of the weights), then the loss, every metric and every
    gradient, with the KL term off and on."""
    jl, tl = _pair(JAPPOLearner, APPOLearner, "discrete", 3, use_kl_loss=use_kl_loss,
                   clip_param=0.1)
    # the current policy moves off the target, so ratios leave the clip
    with torch.no_grad():
        for p in tl.module.parameters():
            p.add_(0.05)
    jl.params = jax.tree_util.tree_map(lambda a: a + 0.05, jl.params)
    frag = _fragment("discrete", 16, 1, 5)
    jb = {k: np.asarray(v[:, 0]) for k, v in frag["cols"].items()}
    tb = SampleBatch({k: v[:, 0] for k, v in frag["cols"].items()})
    jl.before_update(jb)
    tl.before_update(tb)
    np.testing.assert_allclose(tb["target_logp"], jb["target_logp"], **TOL)
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}

    def jloss(p):
        return jl.compute_loss(p, jbatch, None)

    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in tb.items()}
    want = _jgrads(jl, jloss)
    got = _tgrads(tl, lambda: tl.compute_loss(tbatch))
    ratio = np.exp(np.asarray(jl.module.forward_train(jl.params, jb["obs"], jb["actions"])[0])
                   - jb["target_logp"])
    assert (np.abs(ratio - 1) > 0.1).any()  # the clip took part
    _hold_loss(got, want)


def test_prepare_fragments_matches_the_reference():
    """PPO's GAE over [T, N] fragment columns, the bootstrap values, the
    cut at a termination and a truncation, and the masked
    standardisation: every column it returns."""
    jl, tl = _pair(JPPOLearner, PPOLearner, "discrete", 6)
    frag = _fragment("discrete", 14, 4, 7)
    want = jl.prepare_fragments(_jcols(frag), jnp.asarray(frag["last_values"]))
    got = tl.prepare_fragments(_tcols(frag), torch.as_tensor(frag["last_values"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy().astype(np.float64),
                                   np.asarray(want[k]).astype(np.float64), **TOL, err_msg=k)


def test_prepare_fragments_matches_host_gae():
    """The port's copy of the reference's test_in_jit_gae_matches_host_gae:
    the fragment GAE equals the synchronous path's per-episode host GAE
    on the same data, with a mid-fragment termination and the
    fragment-end bootstrap."""
    spec = RLModuleSpec(observation_dim=4, action_dim=2, discrete=True, hidden=(8,))
    lrn = PPOLearner(spec, {"gamma": 0.9, "lambda_": 0.95, "device": "cpu"})
    T = 8
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, 1)).astype(np.float32)
    values = rng.normal(size=(T, 1)).astype(np.float32)
    term = np.zeros((T, 1), bool)
    term[3, 0] = True
    trunc = np.zeros((T, 1), bool)
    last_v = np.array([0.37], np.float32)
    cols = {
        "vf_preds": torch.as_tensor(values),
        "rewards": torch.as_tensor(rewards),
        "terminateds": torch.as_tensor(term),
        "truncateds": torch.as_tensor(trunc),
        "loss_mask": torch.ones((T, 1)),
        "obs": torch.zeros((T, 1, 4)),
        "actions": torch.zeros((T, 1), dtype=torch.int64),
        "action_logp": torch.zeros((T, 1)),
    }
    out = lrn.prepare_fragments(cols, torch.as_tensor(last_v))
    adv = out["advantages"].numpy()[:, 0]
    tgt = out["value_targets"].numpy()[:, 0]
    b1 = compute_gae(SampleBatch({"rewards": rewards[:4, 0], "vf_preds": values[:4, 0],
                                  "terminateds": term[:4, 0], "truncateds": trunc[:4, 0]}),
                     0.0, 0.9, 0.95)
    b2 = compute_gae(SampleBatch({"rewards": rewards[4:, 0], "vf_preds": values[4:, 0],
                                  "terminateds": term[4:, 0], "truncateds": trunc[4:, 0]}),
                     float(last_v[0]), 0.9, 0.95)
    adv_host = np.concatenate([b1["advantages"], b2["advantages"]])
    tgt_host = np.concatenate([b1["value_targets"], b2["value_targets"]])
    np.testing.assert_allclose(tgt, tgt_host, rtol=1e-5)
    std = (adv_host - adv_host.mean()) / max(1e-8, adv_host.std())
    np.testing.assert_allclose(adv, std, rtol=1e-4, atol=1e-5)


def test_merge_time_major_matches_the_reference():
    """[K, T, N, ...] -> [T, K*N, ...] at K = 3, with a trailing feature
    axis: runner k's env n lands in column k * N + n."""
    x = np.random.default_rng(8).standard_normal((3, 5, 2, 4)).astype(np.float32)
    want = np.asarray(JLearner._merge_time_major(jnp.asarray(x)))
    got = Learner._merge_time_major(torch.as_tensor(x)).numpy()
    assert got.shape == (5, 6, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 1 * 2 + 1], x[1, :, 1])


@pytest.mark.parametrize("algo", ["impala", "ppo"])
def test_one_fragment_update_matches_the_reference(algo):
    """update_from_fragments, one Adam step: IMPALA's time-order branch on
    one fragment; PPO's on K = 2 fragments through prepare_fragments with
    one minibatch of every row.  The metrics, then the parameters and
    Adam's moments by test_torch_rllib.py's rule."""
    if algo == "impala":
        jl, tl = _pair(jimpala.IMPALALearner, impala.IMPALALearner, "discrete", 9)
        frags = [_fragment("discrete", 12, 3, 10)]
        kw = {}
    else:
        jl, tl = _pair(JPPOLearner, PPOLearner, "discrete", 9)
        frags = [_fragment("discrete", 12, 3, 10), _fragment("discrete", 12, 3, 11)]
        kw = {"minibatch_size": 72, "num_epochs": 1}
    tm = {k: Learner._merge_time_major(torch.as_tensor(np.stack([f["cols"][k] for f in frags])))
          for k in COLS}
    last = torch.as_tensor(np.concatenate([f["last_values"] for f in frags]))
    if algo == "impala":
        grads = _tgrads(tl, lambda: tl.fragment_loss(tm, last))[2]
    else:
        rows = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in tl.prepare_fragments(tm, last).items()}
        grads = _tgrads(tl, lambda: tl.compute_loss(rows))[2]
    jfrags = [{**f, "cols": {k: (v.astype(np.int32) if k == "actions" else v)
                             for k, v in f["cols"].items()}} for f in frags]
    jm = jl.update_from_fragments(jfrags, **kw)
    m = tl.update_from_fragments(frags, **kw)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=k)
    _hold(tl, jl, grads, CFG["lr"])
