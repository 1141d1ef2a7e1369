"""The port's MoE MLP (ray_tpu_torch/models/moe.py) held to the JAX
package in float32: the output, the aux loss and every gradient, at a
capacity small enough that tokens are dropped.  Both hold the same
weights, perturbed from a numpy seed and carried across by
models/convert.py, and see the same input.

Tolerances (ROADMAP.md): 2e-4 for forward values and the aux loss, 5e-3
for gradients."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import moe as jmoe  # noqa: E402
from ray_tpu_torch.models import moe as tmoe  # noqa: E402
from ray_tpu_torch.models.convert import moe_state_dict_from_jax  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
B, T = 2, 16
# S = 32 tokens, 2 experts each over 8: capacity int(0.5 * 32 * 2 / 8) = 4
# slots an expert for 64 assignments, so most experts drop tokens
CF = 0.5


def _cfgs():
    return (jmoe.MoEConfig(dtype=jnp.float32, capacity_factor=CF),
            tmoe.MoEConfig(dtype=torch.float32, capacity_factor=CF))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _cfgs()
    x = jnp.zeros((B, T, jcfg.d_model))
    params = jax.jit(lambda r: jmoe.MoEMLP(jcfg).init(r, x))(jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _x(seed, d):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def test_output_aux_and_gradients_match_with_dropped_tokens(tree):
    jcfg, tcfg = _cfgs()
    x = _x(1, jcfg.d_model)
    w = _x(2, jcfg.d_model)  # a cotangent for the output

    def jloss(params, xx):
        out, aux = jmoe.MoEMLP(jcfg).apply({"params": params}, xx)
        return (out * w).sum() + aux, (out, aux)

    (_, (jout, jaux)), (jgrads, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree),
                                              jnp.asarray(x))
    model = tmoe.MoEMLP(tcfg)
    model.load_state_dict(moe_state_dict_from_jax(tree))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = model(tx)
    ((out * torch.from_numpy(w)).sum() + aux).backward()

    capacity = max(1, int(CF * B * T * jcfg.top_k / jcfg.num_experts))
    gates, _ = tmoe._top_k_gating(model.router(tx.detach().reshape(-1, jcfg.d_model)), tcfg)
    dispatch, _ = tmoe._dispatch_combine(gates, tcfg, capacity)
    assert capacity == 4 and dispatch.sum().item() < B * T * jcfg.top_k  # tokens dropped

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = moe_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_gating_and_dispatch_match():
    """The routing alone on one set of router logits: the gates and the
    aux loss (with its num_experts factor twice, as the reference has
    it), then dispatch and combine with capacity slots in token order."""
    jcfg, tcfg = _cfgs()
    logits = np.random.default_rng(3).standard_normal((40, jcfg.num_experts)).astype(np.float32)
    jgates, jaux = jmoe._top_k_gating(jnp.asarray(logits), jcfg)
    gates, aux = tmoe._top_k_gating(torch.from_numpy(logits), tcfg)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **FWD_TOL)
    for capacity in (1, 3, 10):
        jd, jc = jmoe._dispatch_combine(jgates, jcfg, capacity)
        d, c = tmoe._dispatch_combine(gates, tcfg, capacity)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **FWD_TOL)


def test_bfloat16_experts_with_float32_router(tree):
    """The default config: the router in float32 on float32 input, the
    experts in bf16 from f32 weights; the output agrees with the
    reference's to bf16 precision and the aux loss, computed from the
    float32 router, to 2e-4."""
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = (dataclasses.replace(jcfg, dtype=jnp.bfloat16),
                  dataclasses.replace(tcfg, dtype=torch.bfloat16))
    x = _x(4, jcfg.d_model)
    jout, jaux = jax.jit(lambda p, xx: jmoe.MoEMLP(jcfg).apply({"params": p}, xx))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    model = tmoe.MoEMLP(tcfg)
    model.load_state_dict(moe_state_dict_from_jax(tree))
    assert model.router.weight.dtype == torch.float32
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(aux.item(), float(jaux), **FWD_TOL)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_init_model_scales():
    """Synthetic weights at the reference's scales: lecun_normal over
    stacked experts counts E x fan_in."""
    cfg = tmoe.MoEConfig()
    model = tmoe.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    for w, fan_in in ((model.experts_gate, E * D), (model.experts_down, E * Fd),
                      (model.router.weight, D)):
        np.testing.assert_allclose(w.std().item(), fan_in ** -0.5, rtol=0.05)
