"""The port's flash attention (ray_tpu_torch/ops) held to the JAX package:
the plain forward against the Pallas kernel run in interpret mode (O and
LSE), the plain backward against the Pallas backward kernels in interpret
mode (dQ, dK, dV), gradients through the port's autograd Function against
jax.grad of the reference's custom_vjp, and the attention dispatch against
the reference einsum attention.  Inputs are numpy arrays from a seed,
handed to both frameworks; everything is float32 on the CPU, at the 2e-4
tolerance of tests/test_ops.py for values computed directly (both sides
compute in float32 and differ only in the order of their sums) and its
5e-3 for gradients taken through autograd."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.attention import reference_causal_attention as jax_reference  # noqa: E402
from ray_tpu.ops.pallas_attention import _flash_bwd_impl, _flash_fwd_impl  # noqa: E402
from ray_tpu.ops.pallas_attention import flash_attention as jax_flash_attention  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.ops.attention import causal_attention, reference_causal_attention  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)


def _qkv(B, T, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D), dtype=np.float32) for _ in range(3)]


def _to_bh(a):
    B, T, H, D = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, T, D))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_fwd_matches_pallas_interpret(causal):
    B, T, H, D = 1, 128, 2, 64
    q, k, v = _qkv(B, T, H, D, seed=1)
    out, lse = _flash_fwd_impl(
        _to_bh(q), _to_bh(k), _to_bh(v), block_q=64, block_k=64,
        scale=1.0 / np.sqrt(D), causal=causal, interpret=True,
    )
    out_ref = np.asarray(out).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    lse_ref = np.asarray(lse).reshape(B, H, T)
    o_t, lse_t = fa.flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    assert o_t.dtype == torch.float32 and lse_t.shape == (B, H, T)
    np.testing.assert_allclose(o_t.numpy(), out_ref, **TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_ref, **TOL)


@pytest.mark.parametrize("T", [1, 8, 100])
def test_attention_matches_reference_at_ragged_lengths(T):
    """Prefill buckets start at 8 and prompts are any length: the port's
    dispatch and its einsum reference both agree with the JAX reference
    at lengths that fill no 64-row tile."""
    q, k, v = _qkv(2, T, 3, 64, seed=T)
    ref = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(causal_attention(qt, kt, vt).numpy(), ref, **TOL)
    np.testing.assert_allclose(reference_causal_attention(qt, kt, vt).numpy(), ref, **TOL)


def test_causal_attention_on_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 64, seed=3))
    before = fa.flash_attention_fwd.launches
    out = causal_attention(q, k, v)
    plain, _ = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    assert torch.equal(out, plain)
    assert fa.flash_attention_fwd.launches == before
    with pytest.raises(NotImplementedError):
        causal_attention(q, k, v, sp_axis="sp")


def test_plain_flash_fwd_strided_views_match_contiguous():
    """GPT-2 hands the kernel q/k/v as views of one fused projection; the
    plain version (like the kernel) must read them through their strides."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((1, 24, 3 * 2 * 64), dtype=np.float32))
    q, k, v = (t.unflatten(-1, (2, 64)) for t in qkv.split(128, dim=-1))
    assert not q.is_contiguous()
    a = fa.flash_attention_fwd_reference(q, k, v)
    b = fa.flash_attention_fwd_reference(q.contiguous(), k.contiguous(), v.contiguous())
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "shape", "last_stride", "bf16_align",
                                  "grad"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 64, seed=5))
    err = ValueError
    if case == "head_dim":
        q, k, v = (t[..., :32] for t in (q, k, v))
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
        err = TypeError
    elif case == "shape":
        k = k[:, :4]
    elif case == "last_stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)  # same shape, stride(-1) != 1
    elif case == "bf16_align":
        # a view one element into its storage: not 16-byte aligned
        q, k, v = (t.bfloat16().flatten() for t in (q, k, v))
        q, k, v = (torch.cat([t[:1], t])[1:].view(1, 8, 2, 64) for t in (q, k, v))
    else:
        q.requires_grad_(True)
        err = NotImplementedError
    with pytest.raises(err):
        fa._check(q, k, v)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_model
    from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(GPT2Config.tiny(dtype=torch.float32), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        LLMEngine(LLMConfig(model="tiny"))  # the engine's default device is cuda


def _from_bh(a, B, H):
    BH, T, D = a.shape
    return np.asarray(a).reshape(B, H, T, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_bwd_matches_pallas_interpret(causal):
    """The plain backward (B2 and B3's plain versions) against the Pallas
    dq and dkv kernels, from the same O, LSE and dO."""
    B, T, H, D = 1, 128, 2, 64
    q, k, v, do = _qkv(B, T, H, D, seed=6) + _qkv(B, T, H, D, seed=7)[:1]
    scale = 1.0 / np.sqrt(D)
    kw = dict(block_q=64, block_k=64, scale=scale, causal=causal, interpret=True)
    out, lse = _flash_fwd_impl(_to_bh(q), _to_bh(k), _to_bh(v), **kw)
    ref = _flash_bwd_impl(_to_bh(q), _to_bh(k), _to_bh(v), _to_bh(do), out, lse, **kw)
    got = fa.flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(_from_bh(out, B, H).copy()),
        torch.from_numpy(np.asarray(lse).reshape(B, H, T).copy()),
        torch.from_numpy(do), causal=causal,
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == (B, T, H, D), name
        np.testing.assert_allclose(a.numpy(), _from_bh(b, B, H), err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax_grad(causal):
    """torch.autograd through the port's flash_attention (Function over the
    plain forward and backward on the CPU) against jax.grad of the
    reference's flash_attention (custom_vjp over the Pallas kernels in
    interpret mode)."""
    B, T, H, D = 1, 128, 2, 64
    q, k, v, w = _qkv(B, T, H, D, seed=8) + _qkv(B, T, H, D, seed=9)[:1]

    def f(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_q=64, block_k=64,
                                  interpret=True)
        return (out * jnp.asarray(w)).sum()

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(w))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("T", [1, 8, 100])
def test_plain_flash_bwd_at_ragged_lengths_matches_autograd(T):
    """Any T works, as in the kernels: the port's gradients at lengths that
    fill no 64-row tile against autograd through the einsum reference."""
    q, k, v, w = _qkv(2, T, 3, 64, seed=10 + T) + _qkv(2, T, 3, 64, seed=20 + T)[:1]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    gt = torch.from_numpy(w)
    got = torch.autograd.grad(causal_attention(qt, kt, vt), (qt, kt, vt), gt)
    ref = torch.autograd.grad(reference_causal_attention(qt, kt, vt), (qt, kt, vt), gt)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


def test_backward_on_cpu_takes_the_plain_versions():
    """On CPU tensors the backward wrappers run their plain versions and
    launch nothing; the serving path's inference_mode forward still works
    through the Function."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 24, 2, 64, seed=11))
    do = torch.from_numpy(_qkv(1, 24, 2, 64, seed=12)[0])
    o, lse = fa.flash_attention_fwd_reference(q, k, v)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches) == before
    with torch.inference_mode():
        assert torch.equal(causal_attention(q, k, v), o)


@pytest.mark.parametrize("case", ["do_shape", "do_dtype", "do_last_stride", "lse_shape",
                                  "lse_dtype", "delta_layout"])
def test_flash_bwd_wrapper_rejects_what_the_kernels_do_not_take(case):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 64, seed=13))
    do = torch.from_numpy(_qkv(1, 8, 2, 64, seed=14)[0])
    lse = torch.zeros(1, 2, 8)
    delta = torch.zeros(1, 2, 8)
    if case == "do_shape":
        do = do[:, :4]
    elif case == "do_dtype":
        do = do.double()
    elif case == "do_last_stride":
        do = do.transpose(1, 3).contiguous().transpose(1, 3)
    elif case == "lse_shape":
        lse = lse[..., :4]
    elif case == "lse_dtype":
        lse = lse.double()
    else:
        delta = torch.zeros(1, 8, 2).transpose(1, 2)  # [B, H, T] but not contiguous
    with pytest.raises(ValueError):
        fa._check_bwd(q, k, v, do, lse, delta)
