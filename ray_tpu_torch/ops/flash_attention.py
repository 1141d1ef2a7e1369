"""Flash attention forward: the Hopper kernel and its plain version.

Port of the forward half of ``ray_tpu/ops/pallas_attention.py``
(``_fwd_kernel`` / ``_flash_fwd_impl``).  ``flash_attention_fwd`` launches
the hand-written CUDA kernel (``csrc/flash_fwd.cu``) for a tensor on the
card and runs ``flash_attention_fwd_reference`` for a tensor on the CPU.
Both keep the reference's ``[B, T, H, D]`` layout at the interface and
return ``(out, lse)``: ``out`` in the input dtype, ``lse`` the per-row
log-sum-exp of the scaled scores, ``[B, H, T]`` in float32.

Only the forward is ported: prefill runs it under ``inference_mode``.
The backward kernels (``_dq_kernel``, ``_dkv_kernel``) come with training,
where this becomes a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30  # the reference's mask value

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the Pallas kernel's
    arithmetic: q, k, v upcast to float32, q scaled by 1/sqrt(D), masked
    scores set to -1e30, probabilities and P.V in float32, the output cast
    to the input dtype at the end."""
    B, T, H, D = q.shape
    qf = q.float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D] tensors, got q of shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    B, T, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd takes head dim 64 or 128, got {D}")
    if T < 1 or B * H < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)} (need T >= 1, 1 <= B*H <= 65535)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last (head) dimension")
        # the bf16 kernel moves rows in 16-byte vectors
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(
                f"bf16 {name} needs a 16-byte-aligned pointer and strides that are "
                f"multiples of 8 elements, got strides {t.stride()}"
            )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_fwd has no backward kernel yet: call it under "
            "torch.inference_mode() or torch.no_grad()"
        )


def _bind(lib: ctypes.CDLL):
    fn = lib.ray_tpu_flash_fwd  # ctypes caches this object on the library
    if fn.argtypes is not None:
        return fn
    lib.ray_tpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
    fn.restype = ctypes.c_int
    fn.argtypes = (  # set last: it marks the binding complete
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6
        + [ctypes.c_float]
        + [ctypes.c_longlong] * 9
        + [ctypes.c_void_p]
    )
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, H, D] flash attention forward -> (out [B, T, H, D],
    lse [B, H, T] float32).

    A CUDA tensor launches the kernel on the current stream (any T >= 1,
    D in {64, 128}, float32 or bfloat16, strided q/k/v whose last dimension
    is contiguous; in bfloat16 16-byte-aligned with strides that are
    multiples of 8) and raises on anything else; a CPU tensor runs the
    plain version.  bfloat16 runs on the tensor cores with its
    probabilities rounded to bfloat16 before P.V, as the reference's
    attention rounds them; float32 computes in float32 throughout.
    ``flash_attention_fwd.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    lib = _build.load("flash_fwd")
    fn = _bind(lib)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, T, D, _DTYPE_CODE[q.dtype], int(bool(causal)), 1.0 / math.sqrt(D),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            stream,
        )
    if err != 0:
        msg = lib.ray_tpu_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err} ({msg})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
