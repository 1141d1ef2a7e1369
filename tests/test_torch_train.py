"""The port's GPT-2 training step (ray_tpu_torch/models/{gpt2,common}.py)
held to the JAX package at the tiny config.  Both hold the same float32
weights, every leaf perturbed from a numpy seed (as in
tests/test_torch_gpt2.py), and see the same tokens.  The reference's
gradient tree is carried across by models/convert.py, since it has the
parameter tree's structure.

Tolerances: the loss at 2e-4 (a forward value, tests/test_ops.py's
forward tolerance); every gradient at 5e-3 (tests/test_ops.py's gradient
tolerance).  AdamW's first steps are close to lr * g / |g|, so an entry
whose gradient is within the two frameworks' float32 noise of zero (for
instance the key bias, whose exact gradient is 0) can move by up to 2 lr
a step in one and not the other.  The parameters after two steps are
therefore held at 1e-2 lr on the entries whose gradient, at both steps, is
at least 1e-2 of its tensor's largest (the rest: within the 2 lr a step
that bounds an AdamW update); the optimizer's own arithmetic is held to
optax's on identical gradients at float32 rounding."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import common as jcommon  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.models import common as tcommon  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
B, T = 2, 32
LR = 1e-3


@pytest.fixture(scope="module")
def tree():
    """The reference's tiny GPT-2 params as numpy, perturbed from a seed."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    params = jgpt2.init_params(jcfg, rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def _batch(seed, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port(tree, **kw):
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, **kw)
    model = tgpt2.GPT2(cfg)
    model.load_state_dict(gpt2_state_dict_from_jax(tree, cfg))
    return cfg, model


def _as_state_dict(jtree):
    """A tree shaped like the params (gradients, updated params) in the
    port's state_dict names."""
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    return gpt2_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtree), cfg)


def _port_grads(model, tok, tgt):
    model.zero_grad(set_to_none=True)
    loss = tgpt2.loss_fn(model, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=[False, True], ids=["no_remat", "remat"])
def loss_and_grads(request, tree):
    """(reference loss, reference grads, port loss, port grads) with
    remat on or off on both sides."""
    remat = request.param
    tok, tgt = _batch(1)
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, remat=remat)
    vg = jax.jit(jax.value_and_grad(jgpt2.loss_fn), static_argnums=3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = vg(params, jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    _, model = _port(tree, remat=remat)
    tloss, tgrads = _port_grads(model, tok, tgt)
    return float(jloss), _as_state_dict(jgrads), tloss, tgrads


def test_loss_matches(loss_and_grads):
    jloss, _, tloss, _ = loss_and_grads
    np.testing.assert_allclose(tloss, jloss, **LOSS_TOL)


def test_every_gradient_matches(loss_and_grads):
    _, jgrads, _, tgrads = loss_and_grads
    assert set(jgrads) == set(tgrads)
    for name, g in tgrads.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD_TOL)


def test_remat_leaves_the_gradients_unchanged(tree):
    """Recomputing each block's forward in the backward gives the same
    loss and gradients as keeping its activations."""
    tok, tgt = _batch(2)
    loss0, g0 = _port_grads(_port(tree, remat=False)[1], tok, tgt)
    loss1, g1 = _port_grads(_port(tree, remat=True)[1], tok, tgt)
    assert loss0 == loss1
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_two_adamw_steps_match(tree):
    """Two train steps through each framework's own entry points: the loss
    at each step, then the parameters (tolerances in the module doc)."""
    tok, tgt = _batch(3)
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, remat=False)
    opt = jgpt2.make_adamw(LR)
    step = jax.jit(jgpt2.make_train_step(jcfg, opt))
    vg = jax.jit(jax.value_and_grad(jgpt2.loss_fn), static_argnums=3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    cfg, model = _port(tree, remat=False)
    tstep = tgpt2.make_train_step(cfg, tgpt2.make_adamw(model.parameters(), LR))
    grads = []
    for _ in range(2):
        grads.append(_as_state_dict(vg(params, jnp.asarray(tok), jnp.asarray(tgt), jcfg)[1]))
        params, state, jloss = step(params, state, jnp.asarray(tok), jnp.asarray(tgt))
        tloss = tstep(model, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
        assert tloss.shape == () and not tloss.requires_grad
        np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    want = _as_state_dict(params)
    for name, p in model.named_parameters():
        got, ref = p.detach(), want[name]
        gmax = max(g[name].abs().max().item() for g in grads)
        sure = (grads[0][name].abs() >= 1e-2 * gmax) & (grads[1][name].abs() >= 1e-2 * gmax)
        diff = (got - ref).abs()
        assert diff.max().item() <= 2 * 2 * LR, name
        assert diff[sure].max().item() <= 1e-2 * LR, name


def test_adamw_matches_optax_on_the_same_gradients():
    """make_adamw's arithmetic against optax.adamw on identical params and
    gradients, zero and tiny gradients included."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((64, 48)).astype(np.float32)
    gs = [rng.standard_normal(p0.shape).astype(np.float32) * 1e-2 for _ in range(3)]
    gs[0][:4] = 0.0
    gs[1][4:8] = 1e-9
    opt = jgpt2.make_adamw(LR)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = tgpt2.make_adamw([tp], LR)
    assert len(topt.param_groups) == 1
    group = topt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.95), 1e-8, 0.1)
    for g in gs:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_next_token_loss_matches():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    targets = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    ref = jcommon.next_token_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = tcommon.next_token_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), **LOSS_TOL)


@pytest.mark.parametrize("preset", ["tiny", "small", "medium", "large"])
def test_flops_per_token_matches(preset):
    jcfg = getattr(jgpt2.GPT2Config, preset)()
    tcfg = getattr(tgpt2.GPT2Config, preset)()
    for seq in (128, 1024):
        assert tgpt2.flops_per_token(tcfg, seq) == jgpt2.flops_per_token(jcfg, seq)


def test_float32_params_with_bfloat16_compute(tree):
    """param_dtype=float32 with dtype=bfloat16, as the reference trains:
    weights and their gradients stay float32, the logits come out in
    bfloat16, and the loss agrees with the reference's bf16-compute loss
    to bf16 precision (the two frameworks round at other places: 2e-2)."""
    tok, tgt = _batch(6)
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.bfloat16, param_dtype=torch.float32, remat=False)
    model = tgpt2.GPT2(cfg)
    model.load_state_dict(gpt2_state_dict_from_jax(tree, cfg))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = model(torch.from_numpy(tok).long())
    assert logits.dtype == torch.bfloat16
    loss = tcommon.next_token_loss(logits, torch.from_numpy(tgt).long())
    loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    jcfg = jgpt2.GPT2Config.tiny(remat=False)  # bf16 compute, f32 params
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss = jgpt2.loss_fn(params, jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-2)


def test_train_step_refuses_a_model_of_another_config(tree):
    """The step is made for one config, as the reference's is; a model
    built from another is refused before any update."""
    cfg, model = _port(tree, remat=False)
    other = tgpt2.GPT2Config.tiny(dtype=torch.float32, remat=True)
    step = tgpt2.make_train_step(other, tgpt2.make_adamw(model.parameters(), LR))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tok, tgt = (torch.from_numpy(a).long() for a in _batch(7))
    with pytest.raises(ValueError, match="step made for"):
        step(model, tok, tgt)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert torch.isfinite(tgpt2.make_train_step(cfg, tgpt2.make_adamw(
        model.parameters(), LR))(model, tok, tgt))
