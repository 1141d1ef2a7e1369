"""Flash attention: the Hopper kernels, their plain versions and the
differentiable entry.

Port of ``ray_tpu/ops/pallas_attention.py``.  Three kernels, each behind a
wrapper that launches it for a tensor on the card and runs its plain
PyTorch version for a tensor on the CPU, and counts its launches in a
plain int (``<wrapper>.launches``):

- ``flash_attention_fwd`` (``csrc/flash_fwd.cu``, replaces ``_fwd_kernel``):
  ``(out, lse)``, ``out`` in the input dtype and ``lse`` the per-row
  log-sum-exp of the scaled scores, ``[B, H, T]`` float32;
- ``flash_attention_dq`` (``csrc/flash_bwd.cu``, replaces ``_dq_kernel``);
- ``flash_attention_dkv`` (``csrc/flash_bwd.cu``, replaces ``_dkv_kernel``).

``flash_attention_bwd`` computes Delta = rowsum(dO * O) in torch, as the
reference computes it in XLA, and calls the two backward wrappers.
``flash_attention`` is the ``torch.autograd.Function`` over all three, the
counterpart of the reference's ``custom_vjp`` ``flash_attention``.  Every
function keeps the reference's ``[B, T, H, D]`` layout at its interface.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

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


def _kernel_layout_ok(t: torch.Tensor) -> bool:
    """The kernels read rows through the strides, with a contiguous last
    dimension; in bf16 they load them by TMA (or 16-byte vectors), which
    needs 16-byte-aligned rows."""
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
    )


def _check_inputs(q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D] tensors, got q of shape {tuple(q.shape)}")
    for name, t in others:
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    B, T, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention takes head dim 64 or 128, got {D}")
    if T < 1 or B * H < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)} (need T >= 1, 1 <= B*H <= 65535)")
    for name, t in (("q", q), *others):
        if not _kernel_layout_ok(t):
            raise ValueError(
                f"{name} must be contiguous in its last (head) dimension and, in bf16, "
                f"have a 16-byte-aligned pointer and strides that are multiples of 8 "
                f"elements; got strides {t.stride()}"
            )


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_inputs(q, ("k", k), ("v", v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_fwd records no graph: call flash_attention for "
            "gradients, or call this under torch.inference_mode() or torch.no_grad()"
        )


# the C entries' argument types: (the backward's kernel selector,)
# pointers, then ints (sizes, dtype code, causal), the scale, the strides
# of each [B, T, H, D] input, the stream
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
_DQ, _DKV = 0, 1  # ray_tpu_flash_bwd's kernel argument


def _bind(lib: ctypes.CDLL, entry: str, argtypes: list):
    fn = getattr(lib, entry)  # ctypes caches this object on the library
    if fn.argtypes is not None:
        return fn
    lib.ray_tpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes  # set last: it marks the binding complete
    return fn


def _raise_on_error(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.ray_tpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def _strides(*ts: torch.Tensor) -> list:
    return [s for t in ts for s in t.stride()[:3]]


def _on_card(q: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
    return True


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
    if not _on_card(q, "flash_attention_fwd"):
        return flash_attention_fwd_reference(q, k, v, causal)
    _check(q, k, v)
    lib = _build.load("flash_fwd")
    fn = _bind(lib, "ray_tpu_flash_fwd", _FWD_ARGTYPES)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, T, D, _DTYPE_CODE[q.dtype], int(bool(causal)), 1.0 / math.sqrt(D),
            *_strides(q, k, v), stream,
        )
    _raise_on_error(lib, err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in float32, [B, H, T] contiguous (the
    reference's ``_flash_bwd_impl`` computes it outside its kernels)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, causal):
    """The Pallas backward kernels' arithmetic, in float32: P = exp(s - LSE)
    with s = (q k^T) * scale and masked scores -1e30, and
    dS = P * (dO v^T - Delta) * scale, each [B, H, Tq, Tk]."""
    T, D = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dov = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dov - delta[..., None]) * scale


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """Plain version of the dq kernel (B2): dQ = dS K, cast to q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dkv kernel (B3): dK = dS^T Q, dV = P^T dO,
    cast to the inputs' dtype."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True):
    """Plain backward: (dq, dk, dv) from the forward's O and LSE and the
    output gradient dO, all in float32, cast to the input dtype."""
    delta = _delta(o, do)
    dq = flash_attention_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *flash_attention_dkv_reference(q, k, v, do, lse, delta, causal))


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check_inputs(q, ("k", k), ("v", v), ("do", do))
    B, T, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [B, H, T] = {(B, H, T)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _launch_bwd(kernel: int, q, k, v, do, lse, delta, out0, out1, causal) -> None:
    lib = _build.load("flash_bwd")
    fn = _bind(lib, "ray_tpu_flash_bwd", _BWD_ARGTYPES)
    B, T, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), out0.data_ptr(), None if out1 is None else out1.data_ptr(),
            B, H, T, D, _DTYPE_CODE[q.dtype], int(bool(causal)), 1.0 / math.sqrt(D),
            *_strides(q, k, v, do), stream,
        )
    _raise_on_error(lib, err, ("flash_bwd dq", "flash_bwd dkv")[kernel])


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dQ [B, T, H, D] from q, k, v, dO [B, T, H, D] and the float32
    LSE and Delta [B, H, T]: the dq kernel (B2) for CUDA tensors, its
    plain version for CPU tensors.  The kernel takes what
    ``flash_attention_fwd``'s takes, dO included, and raises on anything
    else.  ``flash_attention_dq.launches`` counts kernel launches."""
    if not _on_card(q, "flash_attention_dq"):
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal)
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(_DQ, q, k, v, do, lse, delta, dq, None, causal)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta,
                        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, T, H, D], as ``flash_attention_dq``: the dkv kernel
    (B3) for CUDA tensors, its plain version for CPU tensors.
    ``flash_attention_dkv.launches`` counts kernel launches."""
    if not _on_card(q, "flash_attention_dkv"):
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, causal)
    _check_bwd(q, k, v, do, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(_DKV, q, k, v, do, lse, delta, dk, dv, causal)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) [B, T, H, D] from the forward's inputs, its output O
    and LSE, and the output gradient dO: Delta in torch, then the dq and
    dkv kernels for CUDA tensors (plain versions for CPU tensors).  dO
    arrives from autograd in any layout: it is copied once when the
    kernels cannot read it through its strides."""
    if _on_card(q, "flash_attention_bwd") and not _kernel_layout_ok(do):
        do = do.clone(memory_format=torch.contiguous_format)
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, causal))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        # autograd runs this with grad disabled: the forward wrapper's
        # refusal of tensors that require grad does not fire here
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """[B, T, H, D] flash attention, differentiable: the forward kernel
    (B1) saves q, k, v, O and the LSE; the backward runs the dq (B2) and
    dkv (B3) kernels.  CPU tensors take the plain versions of all three."""
    return _FlashAttention.apply(q, k, v, causal)
