"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card: the flash-attention forward (B1) and the dq and
dkv backward kernels (B2, B3), alone and through the autograd Function.
CUDA kernels have no CPU mode, so every test here skips without an
NVIDIA card; on the card run
``pytest -m cuda tests/test_torch_kernels.py`` (no JAX needed)."""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 100, 256])
def test_flash_kernel_matches_plain_on_card(T, dtype):
    """The hand-written kernel against its plain version on the card
    (tolerances as chip_smoke.py: f32 1e-4; bf16 2e-2 on O, which covers
    the kernel's bf16 probabilities and one bf16 ulp of O, and 1e-3 on the
    float32 LSE)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(T)
    q, k, v = (torch.randn(1, T, 12, 64, generator=g, device="cuda").to(dt) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
    o_tol, l_tol = (1e-4, 1e-4) if dt == torch.float32 else (2e-2, 1e-3)
    assert (out.float() - ref_out.float()).abs().max().item() <= o_tol
    assert (lse - ref_lse).abs().max().item() <= l_tol


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|: gradients' scale varies with T and the
    inputs, so backward tolerances are relative to the largest entry."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _row_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (all but the last dim) of max |got - ref| over that
    row's max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


# f32: both sides compute in f32, in another summation order.  bf16: the
# kernels round P and dS to bf16 before their products (2^-9 relative per
# entry) where the plain version keeps f32, and both round each output once
# to bf16 (2^-8 relative at most): 1e-2 of the largest entry covers both.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 100, 256])
def test_flash_bwd_kernels_match_plain_on_card(T, dtype):
    """dq (B2) and dkv (B3) against their plain versions from the same O,
    LSE and dO, each launched once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(100 + T)
    q, k, v, do = (torch.randn(2, T, 12, 64, generator=g, device="cuda").to(dt) for _ in range(4))
    o, lse = fa.flash_attention_fwd_reference(q, k, v)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dt and a.shape == q.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_function_on_card(dtype):
    """The autograd Function on the card: one launch of each kernel per
    forward and backward, strided q/k/v views of one fused projection,
    gradients against autograd through the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn(2, 130, 3 * 12 * 64, generator=g, device="cuda").to(dt)
    w = torch.randn(2, 130, 12, 64, generator=g, device="cuda").to(dt)

    def grads(x):
        x = x.detach().requires_grad_(True)
        q, k, v = (t.unflatten(-1, (12, 64)) for t in x.split(12 * 64, dim=-1))
        out = fa.flash_attention(q, k, v)
        (gx,) = torch.autograd.grad(out, x, w.to(x.device))
        return out, gx

    counts = lambda: (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,  # noqa: E731
                      fa.flash_attention_dkv.launches)
    before = counts()
    out, gx = grads(qkv)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    ref_out, ref_gx = grads(qkv.cpu())
    assert _rel_err(out.cpu(), ref_out) <= (1e-4 if dt == torch.float32 else 2e-2)
    assert _rel_err(gx.cpu(), ref_gx) <= BWD_TOL[dtype]


# The bf16 kernels load their tiles by TMA, which fills rows past T with
# zeros, in tiles of 64 keys (B1, B2 and B3 at D=64 and 128), 64 queries
# (B1 and B2; B3 at D=64) and 32 queries (B3 at D=128): T on both sides of
# the first and second tile edges, B=2 with q/k/v strided views of one
# fused projection, both head dims, causal and not.
EDGE_TS = [1, 31, 33, 63, 65, 127, 129, 1000]


def _fused_qkv(B, T, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3 * 12 * D, generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn(B, T, 12, D, generator=g, device="cuda").to(torch.bfloat16)
    return (*(t.unflatten(-1, (12, D)) for t in qkv.split(12 * D, dim=-1)), do)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", EDGE_TS)
def test_flash_fwd_bf16_tile_edges_on_card(T, D, causal):
    """B1 in bf16 against its plain version at the tile edges (tolerances
    as above: 2e-2 on O, 1e-3 on the float32 LSE)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    q, k, v, _ = _fused_qkv(2, T, D, seed=T * 4 + D + causal)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    assert out.shape == q.shape and lse.shape == (2, 12, T)
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", EDGE_TS)
def test_flash_bwd_bf16_tile_edges_on_card(T, D, causal):
    """B2 and B3 in bf16 against their plain versions at the tile edges,
    1e-2 of each gradient's largest entry.  At T=1 the softmax over one key
    is constant, so dQ and dK are zero but for rounding: there they are
    held within 1e-2 of the largest dV entry instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    q, k, v, do = _fused_qkv(2, T, D, seed=1000 + T * 4 + D + causal)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    dv_scale = ref[2].float().abs().max().item()
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        if T == 1 and name != "dv":
            assert a.float().abs().max().item() <= 1e-2 * dv_scale, name
        else:
            assert _rel_err(a, b) <= BWD_TOL["bfloat16"], name


@pytest.mark.cuda
@pytest.mark.parametrize("T", [65, 1000])
def test_flash_bf16_head_major_views_on_card(T):
    """B1, B2 and B3 on q/k/v/dO that are [B, H, T, D] tensors seen as
    [B, T, H, D] (the head stride above the time stride): the tensor maps
    order the outer dimensions by stride, so the kernels read these views
    without a copy.  Tolerances as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(T)
    q, k, v, do = (torch.randn(2, 12, T, 64, generator=g, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_err(a, b) <= BWD_TOL["bfloat16"], name


@pytest.mark.cuda
def test_flash_dq_bf16_is_deterministic_on_card():
    """B2 sums each dQ row over the key tiles in a fixed order, with no
    atomics: two calls on the same bf16 inputs give bitwise equal dQ."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    q, k, v, do = _fused_qkv(2, 1000, 64, seed=5)
    o, lse = fa.flash_attention_fwd_reference(q, k, v)
    delta = fa._delta(o, do)
    first = fa.flash_attention_dq(q, k, v, do, lse, delta)
    second = fa.flash_attention_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(first.float()).all())
    assert torch.equal(first, second)


def _llama_gqa_inputs(T, seed):
    """Llama-1B's attention inputs at B=1 in bf16: q [1, T, 16, 128], k and
    v drawn for 8 KV heads and repeated to 16 as LlamaAttention repeats
    them (contiguous), dO."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(heads):
        return torch.randn(1, T, heads, 128, generator=g, device="cuda").to(torch.bfloat16)

    q = draw(16)
    k, v = (torch.repeat_interleave(draw(8), 2, dim=2) for _ in range(2))
    return q, k, v, draw(16)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_flash_bf16_at_llama_shape_on_card(kernel):
    """B1, B2 and B3 in bf16, causal, at Llama-1B's attention [1, 4096, 16,
    128] with contiguous GQA-repeated k and v, against their plain
    versions (tolerances as above: 2e-2 on O and 1e-3 on the LSE; 1e-2 of
    each gradient's largest entry).  O is also held row by row, to 2e-2 of
    the row's largest entry, as chip_smoke.py holds it: at T=4096 the late
    rows' entries are about 0.02, so the absolute limit alone would miss a
    dropped V tile there; the test shows that the plain version with keys
    T-128..T-65 of V zeroed fails the row check."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    q, k, v, do = _llama_gqa_inputs(4096, seed=11)
    if kernel == "fwd":
        out, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
        assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
        assert _row_rel_err(out, ref_out) <= 2e-2
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        v_fault = v.clone()
        v_fault[:, -128:-64] = 0
        assert _row_rel_err(fa.flash_attention_fwd_reference(q, k, v_fault)[0], ref_out) > 2e-2
        return
    o, lse = fa.flash_attention_fwd_reference(q, k, v)
    delta = fa._delta(o, do)
    if kernel == "dq":
        got = (fa.flash_attention_dq(q, k, v, do, lse, delta),)
        ref = (fa.flash_attention_dq_reference(q, k, v, do, lse, delta),)
    else:
        got = fa.flash_attention_dkv(q, k, v, do, lse, delta)
        ref = fa.flash_attention_dkv_reference(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a.float()).all())
        assert _rel_err(a, b) <= BWD_TOL["bfloat16"]


@pytest.mark.cuda
def test_llama_block_on_card_matches_cpu():
    """One Llama block at Llama-1B's widths (d_model 2048, 16 heads over 8
    KV heads, d_ff 5504) in float32, B=1, T=256: forward and backward on
    the card (one launch each of B1, B2 and B3) against the same block on
    the CPU (the plain versions).  f32 on both sides in other summation
    orders: the output to 1e-4 and each gradient to 1e-3 of its largest
    entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (CUDA kernels have no CPU mode)")
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama_1b(dtype=torch.float32)
    cpu = llama.LlamaBlock(cfg)
    for i, p in enumerate(cpu.parameters()):
        g = torch.Generator().manual_seed(i)
        p.data = torch.randn(p.shape, generator=g) * (0.02 if p.dim() > 1 else 0.1) + (
            0.0 if p.dim() > 1 else 1.0)
    card = llama.LlamaBlock(cfg).cuda()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(99)
    x = torch.randn(1, 256, cfg.d_model, generator=g)
    w = torch.randn(1, 256, cfg.d_model, generator=g)
    counts = lambda: (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,  # noqa: E731
                      fa.flash_attention_dkv.launches)
    results = {}
    for name, block in (("cuda", card), ("cpu", cpu)):
        before = counts()
        xx = x.to(name).requires_grad_(True)
        out = block(xx)
        (out * w.to(name)).sum().backward()
        if name == "cuda":
            torch.cuda.synchronize()
            assert counts() == tuple(c + 1 for c in before)
        results[name] = [out.detach().cpu(), xx.grad.cpu()] + [
            p.grad.cpu() for p in block.parameters()]
    assert _rel_err(results["cuda"][0], results["cpu"][0]) <= 1e-4
    for a, b in zip(results["cuda"][1:], results["cpu"][1:]):
        assert _rel_err(a, b) <= 1e-3
