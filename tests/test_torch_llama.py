"""The port's Llama (ray_tpu_torch/models/llama.py) held to the JAX
package at the tiny config (4 query heads over 2 KV heads, head dim 32),
in float32.  Both hold the same weights, every leaf perturbed from a
numpy seed (as in tests/test_torch_train.py), carried across by
models/convert.py, and see the same tokens.  On the CPU the port's
attention runs the flash kernels' plain versions and the reference takes
its einsum path.

Tolerances (ROADMAP.md): 2e-4 for forward values and losses, 5e-3 for
gradients; the parameters after two AdamW steps as
tests/test_torch_train.py states and explains."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.convert import llama_state_dict_from_jax  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
B, T = 2, 32
LR = 1e-3


def _jcfg(**kw):
    return dataclasses.replace(jllama.LlamaConfig.tiny(dtype=jnp.float32), **kw)


def _tcfg(**kw):
    return dataclasses.replace(tllama.LlamaConfig.tiny(dtype=torch.float32), **kw)


@pytest.fixture(scope="module")
def tree():
    """The reference's tiny Llama params as numpy, perturbed from a seed."""
    params = jllama.init_params(_jcfg(), rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def _batch(seed, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port(tree, **kw):
    cfg = _tcfg(**kw)
    model = tllama.Llama(cfg)
    model.load_state_dict(llama_state_dict_from_jax(tree, cfg))
    return cfg, model


def _as_state_dict(jtree):
    return llama_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtree), _tcfg())


def test_logits_and_loss_match(tree):
    tok, tgt = _batch(1)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jlogits = jllama.Llama(_jcfg()).apply({"params": params}, jnp.asarray(tok))
    jloss = jllama.loss_fn(params, jnp.asarray(tok), jnp.asarray(tgt), _jcfg())
    _, model = _port(tree)
    with torch.no_grad():
        logits = model(torch.from_numpy(tok).long())
        loss = tllama.loss_fn(model, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    assert logits.shape == (B, T, 512) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)


def _port_grads(model, tok, tgt):
    model.zero_grad(set_to_none=True)
    loss = tllama.loss_fn(model, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_every_gradient_matches(tree, remat):
    tok, tgt = _batch(2)
    vg = jax.jit(jax.value_and_grad(jllama.loss_fn), static_argnums=3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = vg(params, jnp.asarray(tok), jnp.asarray(tgt), _jcfg(remat=remat))
    jgrads = _as_state_dict(jgrads)
    tloss, tgrads = _port_grads(_port(tree, remat=remat)[1], tok, tgt)
    np.testing.assert_allclose(tloss, float(jloss), **FWD_TOL)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD_TOL)


def test_two_adamw_steps_match(tree):
    """Two train steps through each framework's entry points with
    bench.py's AdamW (gpt2.make_adamw on both sides): the loss at each
    step, then the parameters (tolerances in tests/test_torch_train.py)."""
    tok, tgt = _batch(3)
    jcfg = _jcfg()
    opt = jgpt2.make_adamw(LR)
    step = jax.jit(jllama.make_train_step(jcfg, opt))
    vg = jax.jit(jax.value_and_grad(jllama.loss_fn), static_argnums=3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    cfg, model = _port(tree)
    tstep = tllama.make_train_step(cfg, tgpt2.make_adamw(model.parameters(), LR))
    grads = []
    for _ in range(2):
        grads.append(_as_state_dict(vg(params, jnp.asarray(tok), jnp.asarray(tgt), jcfg)[1]))
        params, state, jloss = step(params, state, jnp.asarray(tok), jnp.asarray(tgt))
        tloss = tstep(model, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
        np.testing.assert_allclose(tloss.item(), float(jloss), **FWD_TOL)
    want = _as_state_dict(params)
    for name, p in model.named_parameters():
        got, ref = p.detach(), want[name]
        gmax = max(g[name].abs().max().item() for g in grads)
        sure = (grads[0][name].abs() >= 1e-2 * gmax) & (grads[1][name].abs() >= 1e-2 * gmax)
        diff = (got - ref).abs()
        assert diff.max().item() <= 2 * 2 * LR, name
        assert diff[sure].max().item() <= 1e-2 * LR, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches(dtype):
    """Half-split RoPE against the reference's, over 40 positions of 3
    heads of 32: f32 at 2e-4; on bf16 input both compute the rotation in
    float32 and round once to bf16, so they agree to one bf16 ulp."""
    x = np.random.default_rng(4).standard_normal((2, 40, 3, 32)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(jllama.rope(jx, 10000.0).astype(jnp.float32))
    got = tllama.rope(tx, 10000.0)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = FWD_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_gqa_attention_matches(tree):
    """One attention layer with 4 query heads over 2 KV heads, port
    against reference on the same weights: query heads 0 and 1 read KV
    head 0 (jnp.repeat's order), which Tensor.repeat would not give."""
    x = np.random.default_rng(5).standard_normal((B, T, 128)).astype(np.float32)
    p = tree["h_0"]["attn"]
    ref = jllama.LlamaAttention(_jcfg()).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, p)}, jnp.asarray(x))
    cfg = _tcfg()
    attn = tllama.LlamaAttention(cfg)
    sd = llama_state_dict_from_jax(tree, cfg)
    attn.load_state_dict({k[len("h_0.attn."):]: v for k, v in sd.items()
                          if k.startswith("h_0.attn.")})
    with torch.no_grad():
        got = attn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_rmsnorm_matches_in_bfloat16():
    """RMSNorm on bf16 input with a float32 scale: both square, average
    and rsqrt in float32, multiply the scale, then round once."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    ref = jllama.RMSNorm(jllama.LlamaConfig.tiny()).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, dtype=jnp.bfloat16))
    norm = tllama.RMSNorm(tllama.LlamaConfig.tiny())
    norm.load_state_dict({"weight": torch.from_numpy(scale)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("preset", ["tiny", "llama_1b", "llama_7b"])
def test_presets_and_param_count_match(preset):
    jcfg = getattr(jllama.LlamaConfig, preset)()
    tcfg = getattr(tllama.LlamaConfig, preset)()
    for field in ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model", "d_ff",
                  "max_seq_len", "rope_theta", "rms_eps", "remat"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.dtype, tcfg.param_dtype) == (torch.bfloat16, torch.float32)
    if preset == "tiny":
        with torch.device("meta"):
            n = tllama.num_params(tllama.Llama(tcfg))
        assert n == jllama.num_params(jllama.init_params(_jcfg()))


def test_mesh_raises_not_implemented():
    model = tllama.init_model(_tcfg(sp_axis="sp"), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 8, dtype=torch.long))
