"""The port's ResNet, ViT and MLP (ray_tpu_torch/models/{resnet,vit,mlp}.py)
held to the JAX package in float32 at tiny sizes.  Both hold the same
weights (and, for ResNet, the same running statistics), every leaf
perturbed from a numpy seed, carried across by models/convert.py, and see
the same images.

Tolerances (ROADMAP.md): 2e-4 for forward values, losses and the new
running statistics, 5e-3 for gradients.  The optimizer steps are
each reference's make_train_step with optax.sgd(0.1, momentum=0.9)
against the port's with torch.optim.SGD(0.1, momentum=0.9):
a first step moves each parameter by lr x its gradient, so the
parameters after it are held at 2e-4 relative and lr x the gradient
tolerance absolute."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import mlp as jmlp  # noqa: E402
from ray_tpu.models import resnet as jresnet  # noqa: E402
from ray_tpu.models import vit as jvit  # noqa: E402
from ray_tpu_torch.models import common as tcommon  # noqa: E402
from ray_tpu_torch.models import mlp as tmlp  # noqa: E402
from ray_tpu_torch.models import resnet as tresnet  # noqa: E402
from ray_tpu_torch.models import vit as tvit  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    mlp_state_dict_from_jax,
    resnet_state_dict_from_jax,
    vit_state_dict_from_jax,
)

torch.set_num_threads(2)

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
LR = 0.1
STEP_TOL = dict(rtol=2e-4, atol=LR * 5e-3)
B = 4


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, size):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=B).astype(np.int32)
    return x, y


def _assert_tree_close(got: dict, want: dict, tol: dict):
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.detach().numpy(), want[name].numpy(), err_msg=name, **tol)


def _sgd():
    return optax.sgd(LR, momentum=0.9)


def _assert_step_matches(jloss, jparams, model, tloss, convert):
    """After one step on each side: the loss, then every parameter."""
    np.testing.assert_allclose(tloss.item(), float(jloss), **FWD_TOL)
    want = convert(_np_tree(jparams))
    _assert_tree_close(dict(model.named_parameters()), want, STEP_TOL)


# ----------------------------------------------------------------------
# ResNet
# ----------------------------------------------------------------------
RESNET_KW = dict(stage_sizes=(1, 1), num_filters=8, dtype=jnp.float32)


def _jres_cfg(bottleneck):
    return jresnet.ResNetConfig(bottleneck=bottleneck, **RESNET_KW)


def _tres_cfg(bottleneck):
    return tresnet.ResNetConfig(stage_sizes=(1, 1), num_filters=8, dtype=torch.float32,
                                bottleneck=bottleneck)


@pytest.fixture(scope="module", params=[False, True], ids=["basic", "bottleneck"])
def resnet_vars(request):
    """(bottleneck, the reference's variables as numpy: params perturbed,
    running means perturbed and running variances scaled from a seed)."""
    bottleneck = request.param
    variables = jax.jit(lambda r: jresnet.init_variables(_jres_cfg(bottleneck), r,
                                                         (1, 16, 16, 3)))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for bn in jax.tree_util.tree_leaves(stats, is_leaf=lambda t: "mean" in t):
        bn["mean"] = bn["mean"] + 0.1 * rng.standard_normal(bn["mean"].shape).astype(np.float32)
        bn["var"] = bn["var"] * (1 + 0.5 * rng.random(bn["var"].shape)).astype(np.float32)
    return bottleneck, {"params": _perturb(variables["params"], 2), "batch_stats": stats}


def _port_resnet(bottleneck, variables):
    cfg = _tres_cfg(bottleneck)
    model = tresnet.ResNet(cfg)
    model.load_state_dict(resnet_state_dict_from_jax(variables))
    return cfg, model


def test_resnet_train_forward_matches(resnet_vars):
    """Training mode: logits, loss and the new running statistics."""
    bottleneck, variables = resnet_vars
    x, y = _images(3, 16)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jloss, jstats = jax.jit(jresnet.loss_fn, static_argnums=4)(
        jvars["params"], jvars["batch_stats"], jnp.asarray(x), jnp.asarray(y),
        _jres_cfg(bottleneck))
    jlogits, _ = jax.jit(lambda v, a: jresnet.ResNet(_jres_cfg(bottleneck)).apply(
        v, a, train=True, mutable=["batch_stats"]))(jvars, jnp.asarray(x))
    _, model = _port_resnet(bottleneck, variables)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x), train=True)
        loss, stats = tresnet.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    want = resnet_state_dict_from_jax({"params": {}, "batch_stats": _np_tree(jstats)})
    _assert_tree_close(stats, want, FWD_TOL)


def test_resnet_eval_forward_matches(resnet_vars):
    """Inference mode normalises by the running statistics."""
    bottleneck, variables = resnet_vars
    x, _ = _images(4, 16)
    jlogits = jax.jit(lambda v, a: jresnet.ResNet(_jres_cfg(bottleneck)).apply(
        v, a, train=False))(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    _, model = _port_resnet(bottleneck, variables)
    with torch.no_grad():
        logits = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **FWD_TOL)


def test_resnet_every_gradient_matches(resnet_vars):
    bottleneck, variables = resnet_vars
    x, y = _images(5, 16)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    (_, _), jgrads = jax.jit(jax.value_and_grad(jresnet.loss_fn, has_aux=True),
                             static_argnums=4)(
        jvars["params"], jvars["batch_stats"], jnp.asarray(x), jnp.asarray(y),
        _jres_cfg(bottleneck))
    _, model = _port_resnet(bottleneck, variables)
    loss, _ = tresnet.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    want = resnet_state_dict_from_jax({"params": _np_tree(jgrads), "batch_stats": {}})
    _assert_tree_close({n: p.grad for n, p in model.named_parameters()}, want, GRAD_TOL)


def test_resnet_sgd_momentum_step_matches(resnet_vars):
    """One step of the reference's make_train_step against the port's:
    the loss, the parameters and the running statistics after it."""
    bottleneck, variables = resnet_vars
    x, y = _images(6, 16)
    jcfg = _jres_cfg(bottleneck)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    cfg, model = _port_resnet(bottleneck, variables)
    tstep = tresnet.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=LR,
                                                          momentum=0.9))
    opt = _sgd()
    params, jstats, _, jloss = jax.jit(jresnet.make_train_step(jcfg, opt))(
        jvars["params"], jvars["batch_stats"], opt.init(jvars["params"]), jnp.asarray(x),
        jnp.asarray(y))
    tloss = tstep(model, torch.from_numpy(x), torch.from_numpy(y))
    _assert_step_matches(jloss, params, model, tloss, lambda p: resnet_state_dict_from_jax(
        {"params": p, "batch_stats": {}}))
    want = resnet_state_dict_from_jax({"params": {}, "batch_stats": _np_tree(jstats)})
    _assert_tree_close(dict(model.named_buffers()), want, FWD_TOL)


def test_strided_same_padding_is_asymmetric():
    """A 3x3 stride-2 "SAME" conv on an even size pads 0 before and 1
    after, as flax pads; torch's symmetric padding=1 would shift every
    output by one input row and column."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False)
    ref = conv.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    port = tcommon.Conv(5, 6, 3, 2, torch.float32, torch.float32)
    port.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())})
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 8, 8, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_batchnorm_running_variance_is_biased():
    """On a batch of 18 positions the biased and unbiased variances differ
    by 1/17: the new running variance is flax's 0.9 * var + 0.1 *
    var(ddof=0), and the output is normalised by the batch's biased
    variance."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 3, 3, 4)) * 2 + 1).astype(np.float32)
    ra_mean, ra_var = rng.standard_normal(4).astype(np.float32), (1 + rng.random(4)).astype(
        np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(4)).astype(np.float32), rng.standard_normal(
        4).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    ref, new = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": ra_mean, "var": ra_var}},
                        jnp.asarray(x), mutable=["batch_stats"])
    port = tresnet.BatchNorm(4, tresnet.ResNetConfig(dtype=torch.float32))
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "mean": torch.from_numpy(ra_mean), "var": torch.from_numpy(ra_var)})
    stats = {}
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), stats).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    new_mean, new_var = stats[port]
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                               **FWD_TOL)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(new["batch_stats"]["var"]),
                               **FWD_TOL)


@pytest.mark.parametrize("preset", ["resnet18", "resnet50"])
def test_resnet_presets_match(preset):
    jcfg = getattr(jresnet.ResNetConfig, preset)()
    tcfg = getattr(tresnet.ResNetConfig, preset)()
    for field in ("stage_sizes", "num_filters", "num_classes", "bottleneck"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.dtype, tcfg.param_dtype) == (torch.bfloat16, torch.float32)


# ----------------------------------------------------------------------
# ViT
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def vit_tree():
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32)
    return _perturb(jax.jit(lambda r: jvit.init_params(jcfg, r))(jax.random.PRNGKey(0)), 9)


def _port_vit(tree):
    cfg = tvit.ViTConfig.tiny(dtype=torch.float32)
    model = tvit.ViT(cfg)
    model.load_state_dict(vit_state_dict_from_jax(tree))
    return cfg, model


def test_vit_logits_loss_and_gradients_match(vit_tree):
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32)
    x, y = _images(10, 32)
    params = jax.tree_util.tree_map(jnp.asarray, vit_tree)
    jlogits = jax.jit(lambda p, a: jvit.ViT(jcfg).apply({"params": p}, a))(params,
                                                                           jnp.asarray(x))
    jloss, jgrads = jax.jit(jax.value_and_grad(jvit.loss_fn), static_argnums=3)(
        params, jnp.asarray(x), jnp.asarray(y), jcfg)
    _, model = _port_vit(vit_tree)
    logits = model(torch.from_numpy(x))
    loss = tvit.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    _assert_tree_close({n: p.grad for n, p in model.named_parameters()},
                       vit_state_dict_from_jax(_np_tree(jgrads)), GRAD_TOL)


def test_vit_sgd_momentum_step_matches(vit_tree):
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32)
    x, y = _images(11, 32)
    cfg, model = _port_vit(vit_tree)
    tstep = tvit.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9))
    params, opt = jax.tree_util.tree_map(jnp.asarray, vit_tree), _sgd()
    params, _, jloss = jax.jit(jvit.make_train_step(jcfg, opt))(
        params, opt.init(params), jnp.asarray(x), jnp.asarray(y))
    tloss = tstep(model, torch.from_numpy(x), torch.from_numpy(y))
    _assert_step_matches(jloss, params, model, tloss, vit_state_dict_from_jax)


def test_vit_bfloat16_attention_follows_flax_dtypes(vit_tree):
    """bf16 compute with f32 params (the default): the forward agrees with
    the reference's bf16 forward to bf16 precision; each attention step
    runs in bf16 as flax's does."""
    x, _ = _images(12, 32)
    jcfg = jvit.ViTConfig.tiny()
    ref = jax.jit(lambda p, a: jvit.ViT(jcfg).apply({"params": p}, a))(
        jax.tree_util.tree_map(jnp.asarray, vit_tree), jnp.asarray(x))
    cfg = dataclasses.replace(tvit.ViTConfig.tiny(), dtype=torch.bfloat16)
    model = tvit.ViT(cfg)
    model.load_state_dict(vit_state_dict_from_jax(vit_tree))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mlp_tree():
    return _perturb(jax.jit(lambda r: jmlp.init_params(jmlp.MLPConfig(), r))(
        jax.random.PRNGKey(0)), 13)


def _mnist(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((16, 28, 28)).astype(np.float32),
            rng.integers(0, 10, size=16).astype(np.int32))


def _port_mlp(tree):
    cfg = tmlp.MLPConfig()
    model = tmlp.MLPNet(cfg)
    model.load_state_dict(mlp_state_dict_from_jax(tree))
    return cfg, model


def test_mlp_logits_loss_accuracy_and_gradients_match(mlp_tree):
    jcfg = jmlp.MLPConfig()
    x, y = _mnist(14)
    params = jax.tree_util.tree_map(jnp.asarray, mlp_tree)
    jlogits = jmlp.MLPNet(jcfg).apply({"params": params}, jnp.asarray(x))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmlp.loss_fn), static_argnums=3)(
        params, jnp.asarray(x), jnp.asarray(y), jcfg)
    _, model = _port_mlp(mlp_tree)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    logits = model(tx)
    loss = tmlp.loss_fn(model, tx, ty)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    assert tmlp.accuracy(model, tx, ty).item() == float(
        jmlp.accuracy(params, jnp.asarray(x), jnp.asarray(y), jcfg))
    _assert_tree_close({n: p.grad for n, p in model.named_parameters()},
                       mlp_state_dict_from_jax(_np_tree(jgrads)), GRAD_TOL)


def test_mlp_sgd_momentum_step_matches(mlp_tree):
    jcfg = jmlp.MLPConfig()
    x, y = _mnist(15)
    cfg, model = _port_mlp(mlp_tree)
    tstep = tmlp.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9))
    params, opt = jax.tree_util.tree_map(jnp.asarray, mlp_tree), _sgd()
    params, _, jloss = jax.jit(jmlp.make_train_step(jcfg, opt))(
        params, opt.init(params), jnp.asarray(x), jnp.asarray(y))
    tloss = tstep(model, torch.from_numpy(x), torch.from_numpy(y))
    _assert_step_matches(jloss, params, model, tloss, mlp_state_dict_from_jax)
