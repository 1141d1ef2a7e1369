"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  CUDA kernels have no CPU mode, so every test here
skips without an NVIDIA card; on the card run
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
