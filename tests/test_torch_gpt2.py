"""The port's GPT-2 (ray_tpu_torch/models) held to the JAX package at the
tiny config, with the reference's weights carried across by
models/convert.py.  Every parameter leaf is perturbed from a numpy seed
first, so zero biases and unit LayerNorm scales cannot hide a mapping
fault.  Float32 on the CPU at 2e-4 (tests/test_ops.py's forward
tolerance); greedy tokens must match exactly."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model) holding the same float32 weights.
    remat only trades memory for recompute in training: off here, where it
    would only slow the reference's eager forward passes."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, remat=False)
    params = jgpt2.init_params(jcfg, rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tcfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    model = tgpt2.GPT2(tcfg)
    model.load_state_dict(gpt2_state_dict_from_jax(tree, tcfg))
    return jcfg, params, model.eval()


def _tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)).astype(np.int32)


def test_converted_model_has_every_parameter():
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    params = jgpt2.init_params(jcfg, rng=jax.random.PRNGKey(1))
    tcfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    sd = gpt2_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    model = tgpt2.GPT2(tcfg)
    assert set(sd) == set(model.state_dict())
    assert tgpt2.num_params(model) == jgpt2.num_params(params)
    with pytest.raises(ValueError):
        gpt2_state_dict_from_jax(params, tgpt2.GPT2Config.small())


def test_bf16_model_casts_weights_once_and_keeps_layernorm_f32(pair):
    _, _, model = pair
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.bfloat16)
    m16 = tgpt2.GPT2(cfg)
    m16.load_state_dict(model.state_dict())
    assert m16.h_0.attn.qkv.weight.dtype == torch.bfloat16
    assert m16.wte.weight.dtype == torch.bfloat16
    assert m16.h_0.ln_1.weight.dtype == torch.float32
    assert m16.ln_f.bias.dtype == torch.float32
    assert torch.equal(m16.lm_head.weight, model.lm_head.weight.to(torch.bfloat16))


def test_full_forward_matches(pair):
    jcfg, params, model = pair
    toks = _tokens(2, 24, jcfg.vocab_size, seed=1)
    ref = jgpt2.GPT2(jcfg).apply({"params": params}, jnp.asarray(toks))
    with torch.inference_mode():
        out = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_prefill_forward_matches(pair):
    jcfg, params, model = pair
    toks = _tokens(2, 16, jcfg.vocab_size, seed=2)
    last = np.array([15, 9], dtype=np.int32)
    ref = jgpt2.prefill_forward(params, jcfg, jnp.asarray(toks), last_index=jnp.asarray(last))
    with torch.inference_mode():
        out = tgpt2.prefill_forward(model, torch.from_numpy(toks).long(),
                                    last_index=torch.from_numpy(last))
    for name, a, b in zip(("logits", "k", "v"), out, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_decode_forward_matches(pair):
    """One decode step over a right-padded context gathered from a
    prefill's K/V, with a different context length per lane."""
    jcfg, params, model = pair
    B, C = 2, 20
    toks = _tokens(B, C, jcfg.vocab_size, seed=3)
    _, k, v = jgpt2.prefill_forward(params, jcfg, jnp.asarray(toks))
    k, v = np.asarray(k), np.asarray(v)
    lens = np.array([12, 7])
    mask = np.arange(C)[None, :] < lens[:, None]
    k_ctx = np.where(mask[None, :, :, None, None], k, 0.0).astype(np.float32)
    v_ctx = np.where(mask[None, :, :, None, None], v, 0.0).astype(np.float32)
    tok = toks[np.arange(B), lens]
    pos = lens.astype(np.int32)
    ref = jgpt2.decode_forward(params, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(k_ctx), jnp.asarray(v_ctx), jnp.asarray(mask))
    with torch.inference_mode():
        out = tgpt2.decode_forward(
            model, torch.from_numpy(tok).long(), torch.from_numpy(pos).long(),
            torch.from_numpy(k_ctx), torch.from_numpy(v_ctx), torch.from_numpy(mask),
        )
    for name, a, b in zip(("logits", "k_new", "v_new"), out, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_greedy_sampling_matches():
    logits = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32)
    temp = np.zeros(5, dtype=np.float32)
    ref = jgpt2.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp), 8)
    got = tgpt2.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                              torch.from_numpy(temp), 8)
    assert got.tolist() == np.asarray(ref).tolist()


def test_temperature_sampling_matches_softmax_distribution():
    """The two frameworks draw different random bits, so sampled tokens
    are compared by distribution: 40000 draws at temperature 0.7 against
    softmax(logits / 0.7), and top_k keeps every draw among the top k."""
    V, N = 8, 40000
    logits = np.random.default_rng(5).standard_normal(V).astype(np.float32)
    lt = torch.from_numpy(np.tile(logits, (N, 1)))
    temp = torch.full((N,), 0.7)
    draws = tgpt2.sample_logits(lt, torch.Generator().manual_seed(1), temp)
    freq = np.bincount(draws.numpy(), minlength=V) / N
    p = np.exp(logits / 0.7 - (logits / 0.7).max())
    p /= p.sum()
    # 4 standard deviations of a binomial frequency at N draws
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / N) + 1e-9), (freq, p)
    top3 = set(np.argsort(logits)[-3:].tolist())
    d3 = tgpt2.sample_logits(lt[:2000], torch.Generator().manual_seed(2), temp[:2000], top_k=3)
    assert set(d3.tolist()) <= top3


def test_generate_greedy_matches(pair):
    jcfg, params, model = pair
    toks = _tokens(1, 6, jcfg.vocab_size, seed=6)
    # the reference re-runs its eager forward at every new length: keep it short
    ref = jgpt2.generate_greedy(params, jcfg, jnp.asarray(toks), 4)
    got = tgpt2.generate_greedy(model, torch.from_numpy(toks).long(), 4)
    assert got.tolist() == np.asarray(ref).tolist()
