#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device       — require CUDA; print the card's name and power limit.
2. build        — build every kernel from the sources in the checkout
                  (one nvcc per source, all started together).
3. kernels      — the flash forward (B1) against its plain PyTorch version
                  on the card at the shapes the serving path gives it,
                  then timed beside its plain version, its roofline bound
                  and one library call.
4. bwd kernels  — the flash backward kernels (B2 dq, B3 dkv) against their
                  plain versions at the same shapes; B1, B2 and B3 held
                  against their plain versions at the training shape
                  [16, 1024, 12, 64] bf16 causal, then timed there beside
                  their plain versions, bounds and the library's attention;
                  then the host's cost of a launch: the wall clock of 200
                  back-to-back calls of each wrapper at [1, 64, 12, 64],
                  bf16 (which encodes TMA tensor maps) and f32 (which
                  does not), beside the kernels' device time there.
   llama kernels — B1, B2 and B3 at Llama-1B's attention (head dim 128, k
                  and v of 8 KV heads repeated to 16): held against their
                  plain versions at the training path's [4, 4096, 16, 128]
                  bf16 causal (B1's O row by row, with a planted fault to
                  show the check's power), then timed there beside their
                  plain versions, bounds and the library's attention.
5. parity       — GPT-2 small at full width in float32: the engine's greedy
                  tokens equal the full-forward generate_greedy oracle's.
6. serve        — the serving path: GPT-2 small in bfloat16 serving 16
                  concurrent requests through LLMEngine; every request ends
                  with its max_tokens, no KV block leaks, and the flash
                  kernel launched n_layer times per prefill.
7. profile      — the same traffic under torch.profiler (device busy share,
                  time by kernel) and one T=1024 prefill timed alone.
8. train parity — one float32 AdamW step of GPT-2 small at full width
                  (B=2, T=128) on the card (kernels) and on the CPU (plain
                  versions) from the same weights: loss, every gradient,
                  every parameter after the step.
9. train        — the training path (bench.py's configuration): GPT-2 small,
                  float32 params with bfloat16 compute, B=16, T=1024, AdamW
                  lr 3e-4; 3 warm-up and 10 timed steps with a finite,
                  falling loss and B1 = B2 = B3 = n_layer launches a step;
                  one remat step (B1 twice a layer, the same loss); step
                  time, tokens/s, MFU, and the device's idle share and time
                  by kernel under torch.profiler.
10. llama parity — one float32 AdamW step at Llama-1B's full width and 2
                  of its layers (B=1, T=256) on the card and on the CPU.
11. llama train — the main path of the model families: Llama-1B at full
                  width and depth, f32 params, bf16 compute, remat, B=4,
                  T=4096, AdamW; 3 warm-up and 10 timed steps with a
                  finite, falling loss and B1 32, B2 16, B3 16 launches a
                  step; step time, tokens/s, MFU, peak memory, and one
                  step under torch.profiler.
12. resnet      — one float32 SGD-momentum step at resnet18's widths card
                  vs CPU (loss, gradients, parameters, new running
                  statistics); ResNet-50 at bench_resnet.py's configuration
                  (bf16, B=512, 32x32, SGD 0.1 momentum 0.9), 13 steps.
13. vit, mlp    — each at its default config: an f32 AdamW step card vs
                  CPU, then 13 bf16 steps with a falling loss.
14. moe         — MoEMLP at its default widths in float32: output, aux loss
                  and gradients, card vs CPU.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama, mlp, moe, resnet, vit
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
from ray_tpu_torch.serve.llm.engine import FINISHED

# H100 SXM published peaks (NVIDIA data sheet; dense bf16 tensor cores,
# HBM3), the denominators of every bound below
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
PROMPT_VOCAB = 50257  # GPT-2's tokenizer; the model's 50304 rows pad it
PARITY_LENS = (5, 37, 130, 300)
# the serving path's 16 prompts: every prefill bucket from 8 to 1024
SERVE_LENS = (5, 12, 30, 60, 100, 200, 300, 400, 520, 600, 700, 800, 900, 960, 20, 45)
# the training path: bench.py's GPT-2 small configuration
TRAIN_B, TRAIN_T, TRAIN_LR = 16, 1024, 3e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# kernel-vs-plain cases, (T, dtype, causal, D, fused q/k/v): the prefill
# buckets' range with ragged 100, both dtypes, one non-causal case and
# D=128 per dtype; then bf16 on both sides of the first and second TMA
# tile edges (64-key tiles in B1, B2 and B3; 64-query tiles in B1 and B2,
# and in B3 64 at D=64, 32 at D=128)
_DTYPES = (torch.bfloat16, torch.float32)
EDGE_TS = (1, 63, 65, 127, 129, 1000)
KERNEL_CASES = ([(T, dt, True, 64, True) for T in (8, 100, 256, 1024) for dt in _DTYPES]
                + [(100, dt, False, 64, False) for dt in _DTYPES]
                + [(256, dt, True, 128, False) for dt in _DTYPES]
                + [(T, torch.bfloat16, True, 64, True) for T in EDGE_TS]
                + [(T, torch.bfloat16, False, 128, True) for T in EDGE_TS])


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA card")
    card = _card()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_all(KERNEL_SOURCES)
    print(f"[build] {len(KERNEL_SOURCES)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in KERNEL_SOURCES:
        secs, log = _build.build_info[name]
        print(f"[build] {name}: nvcc {secs:.2f} s", flush=True)
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                print(f"[build]   {line.strip()}", flush=True)


def _qkv(T: int, H: int, D: int, dtype: torch.dtype, fused: bool, seed: int):
    """q, k, v [1, T, H, D] on the card: views of one fused [1, T, 3*H*D]
    projection (the serving path's layout) or three contiguous tensors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn(1, T, 3 * H * D, generator=g, device="cuda").to(dtype)
        return tuple(t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    return tuple(torch.randn(1, T, H, D, generator=g, device="cuda").to(dtype) for _ in range(3))


def _time_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median per-call device time over ``rounds`` runs of ``reps`` calls,
    CUDA events around each run; a device-side sleep before each run lets
    the host queue the calls ahead, so launch overhead is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_kernels(card: str) -> dict:
    """The flash forward against its plain version; returns its record
    (launches are filled in by the serving phase)."""
    # f32: both sides compute in f32 and differ only in summation order.
    # bf16: the kernel rounds P to bf16 before P.V (relative 2^-9 per
    # probability) where the plain version keeps f32, and both round O
    # once to bf16: 2e-2 covers one bf16 ulp for |O| in [2, 4) plus the P
    # rounding.  The LSE is f32 on both sides.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
    main_err = None
    for i, (T, dt, causal, D, fused) in enumerate(KERNEL_CASES):
        q, k, v = _qkv(T, 12, D, dt, fused, seed=i)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"non-finite kernel output at T={T} {dt} causal={causal} D={D}")
        e_o = (out.float() - ref_out.float()).abs().max().item()
        e_l = (lse - ref_lse).abs().max().item()
        o_tol, l_tol = tol[dt]
        ok = e_o <= o_tol and e_l <= l_tol
        print(f"[kernels] flash_fwd T={T:5d} {str(dt)[6:]:8s} causal={int(causal)} D={D:3d} "
              f"{'fused' if fused else 'contig'}: max|dO|={e_o:.3e} (tol {o_tol:g}) "
              f"max|dLSE|={e_l:.3e} (tol {l_tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version at T={T} {dt}")
        if (T, dt, causal, D) == (1024, torch.bfloat16, True, 64):
            main_err = (e_o, e_l)

    # timing at the largest prefill of the main path: B=1, T=1024, H=12,
    # D=64, bf16, q/k/v as views of the fused projection
    B, T, H, D = 1, 1024, 12, 64
    q, k, v = _qkv(T, H, D, torch.bfloat16, True, seed=99)
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain_ms = _time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v), reps=5, rounds=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    rec = _record("flash_attention_fwd", "serve", (B, T, H, D), ms, plain_ms, library_ms,
                  *_fwd_work(B, T, H, D), main_err[0], max_abs_err_lse=main_err[1])
    _print_record("kernels", rec, card)
    return rec


# the kernels' sources and the TPU kernels they replace
_SOURCES = {
    "flash_attention_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                            "ray_tpu/ops/pallas_attention.py:54"),
    "flash_attention_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                           "ray_tpu/ops/pallas_attention.py:136"),
    "flash_attention_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                            "ray_tpu/ops/pallas_attention.py:172"),
}


def _causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def _fwd_work(B, T, H, D, elt=2):
    """(FLOPs, bytes) of B1: QK^T and PV over the causal pairs; q, k, v
    read once, O and the f32 LSE written once."""
    return 4 * B * H * D * _causal_pairs(T), 4 * B * T * H * D * elt + B * H * T * 4


def _dq_work(B, T, H, D, elt=2):
    """B2: QK^T, dO V^T and dS K; q, k, v, dO, LSE, Delta in, dQ out."""
    return 6 * B * H * D * _causal_pairs(T), 5 * B * T * H * D * elt + 2 * B * H * T * 4


def _dkv_work(B, T, H, D, elt=2):
    """B3: K Q^T, V dO^T, P^T dO and dS^T Q; the same inputs, dK and dV out."""
    return 8 * B * H * D * _causal_pairs(T), 6 * B * T * H * D * elt + 2 * B * H * T * 4


def _record(name, path, shape, ms, plain_ms, library_ms, flops, bytes_moved, err, **extra):
    """One kernel's entry of the JSON line; launches are filled in by the
    phase that drives its path."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    source, replaces = _SOURCES[name]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "path": path,
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "at": "[B, T, H, D] = [%d, %d, %d, %d] bfloat16 causal" % shape,
        "gflop": flops / 1e9,
        "mb": bytes_moved / 1e6,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        **extra,
    }


def _print_record(tag: str, rec: dict, card: str) -> None:
    print(f"[{tag}] {rec['name']} @ {rec['at']}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['gflop']:.3f} GFLOP, "
          f"{rec['mb']:.3f} MB), {rec['achieved_tflops']:.2f} TFLOP/s — {card}", flush=True)


def _rel(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def phase_bwd_kernels(card: str) -> list:
    """The backward kernels against their plain versions, then B1, B2 and
    B3 timed at the training shape; returns their records."""
    # Relative to max |ref| of each gradient (their scale varies with T and
    # the inputs).  f32: both sides compute in f32 in another summation
    # order.  bf16: the kernels round P and dS to bf16 before their products
    # (2^-9 relative per entry) where the plain version keeps f32, and both
    # round each output once to bf16 (2^-8 relative at most): 1e-2.  At T=1
    # the softmax over one key is constant, so dQ and dK are zero but for
    # rounding: there they are measured against the largest dV entry.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    for i, (T, dt, causal, D, fused) in enumerate(KERNEL_CASES):
        q, k, v = _qkv(T, 12, D, dt, fused, seed=100 + i)
        do = _qkv(T, 12, D, dt, False, seed=200 + i)[0]
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        errs = []
        for j, (a, b) in enumerate(zip(got, ref)):
            err = (a.float() - b.float()).abs().max().item()
            norm = ref[2] if T == 1 and j < 2 else b
            errs.append((err, err / norm.float().abs().max().item()))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ok = finite and all(rel <= tol[dt] for _, rel in errs)
        print(f"[bwd kernels] T={T:5d} {str(dt)[6:]:8s} causal={int(causal)} D={D:3d} "
              f"{'fused' if fused else 'contig'}: max|err|/max|ref| dq {errs[0][1]:.3e} "
              f"dk {errs[1][1]:.3e} dv {errs[2][1]:.3e} (tol {tol[dt]:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash backward disagrees with its plain version at T={T} {dt}")

    # the training shape: q/k/v views of the fused projection, dO
    # contiguous (as autograd hands it over), O and LSE from B1
    B, T, H, D = TRAIN_B, TRAIN_T, 12, 64
    g = torch.Generator(device="cuda").manual_seed(300)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    errs = _hold_bf16_kernels("bwd kernels", "training shape", "fused", q, k, v, do)
    return _time_bf16_kernels("bwd kernels", "train", q, k, v, do, errs, card)


def _row_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (all but the last dim) of max |got - ref| over that
    row's max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


# B1's O held row by row: each row of O is a convex mix of V's rows, whose
# size falls as 1/sqrt(keys) along a causal T (late rows' entries are ~0.02
# at T=4096), so an absolute limit that covers the early rows' rounding
# hides a fault in the late ones.  Both sides round O once to bf16 (one ulp
# is at most 2^-7 of the row's largest entry) after the kernel's P rounding
# (2^-9 relative per probability, averaging out over the keys): 2e-2 of
# each row's largest entry
O_ROW_TOL = 2e-2


def _hold_bf16_kernels(tag: str, label: str, layout: str, q, k, v, do) -> dict:
    """B1, B2 and B3 in bf16 causal on these inputs against their plain
    versions: B1 at phase_kernels' bf16 tolerances (2e-2 on O, 1e-3 on the
    LSE) and O at O_ROW_TOL of each row's largest entry, B2/B3 at
    phase_bwd_kernels' 1e-2 of each gradient's largest entry.  The row
    check's power is shown on a planted fault: the plain version with one
    64-key V tile zeroed (keys T-128..T-65), which leaves the LSE exact and
    moves only the last 128 rows, must read above O_ROW_TOL.  Raises on a
    disagreement, else returns the errors that the records carry."""
    shape = tuple(q.shape)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
    fwd_err = (o.float() - ref_o.float()).abs().max().item()
    row_err = _row_rel(o, ref_o)
    lse_err = (lse - ref_lse).abs().max().item()
    v_fault = v.clone()
    v_fault[:, -128:-64] = 0
    fault_err = _row_rel(fa.flash_attention_fwd_reference(q, k, v_fault)[0], ref_o)
    del ref_o, ref_lse, v_fault
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    errs = dict(zip(("dq", "dk", "dv"), (_rel(a, b) for a, b in zip(got, ref))))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in (o, lse, *got))
    del got, ref
    ok = (finite and fwd_err <= 2e-2 and row_err <= O_ROW_TOL and lse_err <= 1e-3
          and all(rel <= 1e-2 for _, rel in errs.values()))
    print(f"[{tag}] {label} {shape} bfloat16 causal {layout}: flash_fwd "
          f"max|dO|={fwd_err:.3e} (tol 0.02), by row {row_err:.3e} of max|O_ref| (tol "
          f"{O_ROW_TOL:g}; one V tile zeroed reads {fault_err:.3e}) max|dLSE|={lse_err:.3e} "
          f"(tol 0.001); max|err|/max|ref| dq {errs['dq'][1]:.3e} dk {errs['dk'][1]:.3e} dv "
          f"{errs['dv'][1]:.3e} (tol 0.01) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain versions at the "
                             f"{label} {shape}")
    if fault_err <= O_ROW_TOL:
        raise AssertionError(f"B1's row check at the {label} {shape} cannot see a zeroed "
                             f"V tile ({fault_err:.3e} <= {O_ROW_TOL:g})")
    return {"fwd": fwd_err, "fwd_row": row_err, "fwd_fault_row": fault_err, "lse": lse_err,
            **errs}


def _time_bf16_kernels(tag: str, path: str, q, k, v, do, errs: dict, card: str,
                       plain_reps: int = 3) -> list:
    """B1, B2 and B3 timed on these inputs beside their plain versions,
    their bounds and the library's attention on the same q, k, v
    (``scaled_dot_product_attention``'s forward for B1, its backward for
    B2 and B3); returns the three records with ``errs`` from
    ``_hold_bf16_kernels``."""
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    shape = tuple(q.shape)
    fwd_ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    fwd_plain = _time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v), reps=plain_reps,
                         rounds=3)
    with torch.no_grad():
        fwd_lib = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    dq_ms = _time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, delta))
    dq_plain = _time_ms(lambda: fa.flash_attention_dq_reference(q, k, v, do, lse, delta),
                        reps=plain_reps, rounds=3)
    dkv_ms = _time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta))
    dkv_plain = _time_ms(lambda: fa.flash_attention_dkv_reference(q, k, v, do, lse, delta),
                         reps=plain_reps, rounds=3)
    bwd_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
    delta_ms = _time_ms(lambda: fa._delta(o, do))
    # the library computes dq, dk and dv in one backward call
    bwd_lib = _time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                   retain_graph=True))
    lib_note = {"library_call": "scaled_dot_product_attention backward: dq, dk and dv in "
                                "one call", "flash_attention_bwd_ms": bwd_ms,
                "delta_ms": delta_ms}
    recs = [
        _record("flash_attention_fwd", path, shape, fwd_ms, fwd_plain, fwd_lib,
                *_fwd_work(*shape), errs["fwd"], max_abs_err_lse=errs["lse"],
                max_row_rel_err=errs["fwd_row"], planted_fault_row_rel_err=errs["fwd_fault_row"]),
        _record("flash_attention_dq", path, shape, dq_ms, dq_plain, bwd_lib,
                *_dq_work(*shape), errs["dq"][0], max_rel_err=errs["dq"][1], **lib_note),
        _record("flash_attention_dkv", path, shape, dkv_ms, dkv_plain, bwd_lib,
                *_dkv_work(*shape), max(errs["dk"][0], errs["dv"][0]),
                max_rel_err=max(errs["dk"][1], errs["dv"][1]), **lib_note),
    ]
    for rec in recs:
        _print_record(tag, rec, card)
    print(f"[{tag}] backward at {shape}: Delta + dq + dkv {bwd_ms:.4f} ms (Delta alone, "
          f"in torch, {delta_ms:.4f} ms), library backward {bwd_lib:.4f} ms — {card}",
          flush=True)
    return recs


HOST_SHAPE, HOST_CALLS, HOST_ROUNDS = (1, 64, 12, 64), 200, 5


def _host_calls(dt: torch.dtype) -> dict:
    """The three wrappers as calls on HOST_SHAPE inputs of one dtype."""
    g = torch.Generator(device="cuda").manual_seed(400)
    q, k, v, do = (torch.randn(*HOST_SHAPE, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    return {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v),
        "flash_attention_dq": lambda: fa.flash_attention_dq(q, k, v, do, lse, delta),
        "flash_attention_dkv": lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta),
    }


def phase_host_cost(card: str) -> dict:
    """The host's cost of one call of each wrapper: the wall clock of
    HOST_CALLS back-to-back calls, synchronised only at the end, median of
    HOST_ROUNDS rounds with bf16 and f32 in turns, at a shape whose kernels
    take less device time than the host takes to launch them (the device
    time per call, timed apart, is printed beside it to show that).  A bf16
    call encodes four TMA tensor maps (three for B1), an f32 call none; the
    rest of the path (checks, allocation, ctypes) is the same."""
    calls = {dt: _host_calls(dt) for dt in (torch.bfloat16, torch.float32)}
    res = {}
    for name in calls[torch.bfloat16]:
        walls = {dt: [] for dt in calls}
        for _ in range(HOST_ROUNDS):
            for dt, fns in calls.items():
                fn = fns[name]
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fn()
                torch.cuda.synchronize()
                walls[dt].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        for dt, fns in calls.items():
            wall_us = statistics.median(walls[dt])
            # few calls a run, so that the host queues them within the
            # device-side sleep and only device time is timed
            device_us = _time_ms(fns[name], reps=4) * 1e3
            res[f"{name} {str(dt)[6:]}"] = {"wall_us_per_call": wall_us,
                                            "wall_us_rounds": walls[dt],
                                            "device_us_per_call": device_us}
            print(f"[host] {name} {str(dt)[6:]:8s} at {list(HOST_SHAPE)}: {wall_us:.2f} us a "
                  f"call, median of {HOST_ROUNDS} rounds of {HOST_CALLS} back-to-back calls "
                  f"({min(walls[dt]):.2f}..{max(walls[dt]):.2f}); device {device_us:.2f} us a "
                  f"call — {card}", flush=True)
    print("[host] " + json.dumps(res), flush=True)
    return res


async def _drain(req) -> list:
    toks = []
    while True:
        ev = await req.out.get()
        if ev is FINISHED:
            return toks
        toks.append(ev["token"])


def phase_parity(card: str) -> None:
    """Float32 GPT-2 small: paged prefill (kernel) + decode (einsum)
    tokens against the full-forward oracle (kernel) on the card."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, PROMPT_VOCAB, size=n).tolist() for n in PARITY_LENS]
    n_new = 8

    async def run():
        eng = LLMEngine(LLMConfig(model="small", dtype="float32", max_batch_size=4,
                                  block_size=16, num_blocks=256, temperature=0.0))
        reqs = [await eng.add_request(p, max_tokens=n_new) for p in prompts]
        outs = await asyncio.gather(*[_drain(r) for r in reqs])
        await eng.stop()
        return eng, outs

    t0 = time.perf_counter()
    eng, outs = asyncio.run(run())
    for p, got in zip(prompts, outs):
        want = gpt2.generate_greedy(eng.model, torch.tensor([p], device=eng.device), n_new)[0].tolist()
        if got != want:
            raise AssertionError(f"f32 greedy parity failed at prompt len {len(p)}: "
                                 f"engine {got} != oracle {want}")
    if eng.bm.blocks_in_use:
        raise AssertionError(f"f32 parity run leaked {eng.bm.blocks_in_use} KV blocks")
    print(f"[parity] GPT-2 small f32: {len(prompts)} prompts (len {min(PARITY_LENS)}.."
          f"{max(PARITY_LENS)}) x {n_new} greedy "
          f"tokens equal generate_greedy on the card ({time.perf_counter() - t0:.1f} s) — {card}",
          flush=True)


def _serve_mix():
    """The main path's configuration and traffic: bf16 GPT-2 small, 8
    lanes, 16 concurrent requests with prompts over every bucket from 8 to
    1024 and max_tokens from 16 to 64, made from a seed."""
    cfg = LLMConfig(model="small", dtype="bfloat16", max_batch_size=8, block_size=16,
                    num_blocks=256, temperature=0.0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, PROMPT_VOCAB, size=n).tolist() for n in SERVE_LENS]
    max_tokens = [int(m) for m in rng.integers(16, 65, size=len(SERVE_LENS))]
    return cfg, prompts, max_tokens


async def _serve_once(eng, prompts, max_tokens, on_start=None):
    """Warm the engine with one short request (set-up: cuBLAS state), then
    submit the mix at once and drain it."""
    await _drain(await eng.add_request([1, 2, 3], max_tokens=2))
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    reqs = [await eng.add_request(p, max_tokens=m) for p, m in zip(prompts, max_tokens)]
    outs = await asyncio.gather(*[_drain(r) for r in reqs])
    torch.cuda.synchronize()
    return reqs, outs, time.perf_counter() - t0


def phase_serve(card: str) -> dict:
    """The main path, driven once through LLMEngine with the launch count
    set to 0 just before and read just after."""
    cfg, prompts, max_tokens = _serve_mix()
    lens = list(SERVE_LENS)

    def reset_counts():
        fa.flash_attention_fwd.launches = 0

    async def run():
        eng = LLMEngine(cfg)
        reqs, outs, wall = await _serve_once(eng, prompts, max_tokens, on_start=reset_counts)
        launches = fa.flash_attention_fwd.launches
        stats = eng.stats()
        await eng.stop()
        return eng, reqs, outs, wall, launches, stats

    eng, reqs, outs, wall, launches, stats = asyncio.run(run())
    n_layer = eng.model_cfg.n_layer
    vocab = eng.model_cfg.vocab_size
    for r, out in zip(reqs, outs):
        if len(out) != r.max_tokens or r.finish_reason != "length":
            raise AssertionError(f"request {r.request_id} (prompt {len(r.prompt)}) ended "
                                 f"{r.finish_reason} after {len(out)}/{r.max_tokens} tokens")
        if not all(0 <= t < vocab for t in out):
            raise AssertionError(f"token outside the vocabulary in {r.request_id}")
    leak = eng.stats()["kv_leak_report"]
    if leak["blocks_in_use"] or leak["live_sequences"]:
        raise AssertionError(f"KV leak after stop(): {leak}")
    if stats["preemptions_total"]:
        raise AssertionError("unexpected preemption in anonymous FIFO traffic")
    if launches != n_layer * len(reqs):
        raise AssertionError(f"flash kernel launched {launches} times, expected "
                             f"{n_layer} x {len(reqs)} prefills")
    ttft = sorted(r.t_first_token - r.t_submit for r in reqs)
    total = sum(len(o) for o in outs)
    decode_tokens = total - len(reqs)
    res = {
        "requests": len(reqs),
        "prompt_lens": lens,
        "max_tokens": max_tokens,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "decode_tok_per_s": decode_tokens / wall,
        "output_tok_per_s": total / wall,
        "wall_s": wall,
        "decode_steps": stats["steps"],
        "flash_launches": launches,
        "kv_leak_report": leak,
        "card": card,
    }
    print(f"[serve] GPT-2 small bf16, {len(reqs)} requests (prompts {min(lens)}..{max(lens)}, "
          f"max_tokens {min(max_tokens)}..{max(max_tokens)}), {cfg.max_batch_size} lanes: "
          f"TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms p95 {res['ttft_p95_s'] * 1e3:.1f} ms, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s, wall {wall:.2f} s, "
          f"flash launches {launches} = {n_layer} x {len(reqs)}, KV leak 0 — {card}", flush=True)
    print("[serve] " + json.dumps(res), flush=True)
    return res


def _device_kernels(prof) -> list:
    """The profile's device events by name, without user annotations (such
    as the optimizer's step), whose device spans cover kernels already
    counted."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def phase_profile(card: str) -> dict:
    """Where the serving time goes: the same mix again under
    torch.profiler (device busy share, device time by kernel), and one
    T=1024 prefill timed alone with its attention share."""
    from torch.profiler import ProfilerActivity, profile

    cfg, prompts, max_tokens = _serve_mix()

    async def run():
        eng = LLMEngine(cfg)
        await _drain(await eng.add_request([1, 2, 3], max_tokens=2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, wall = await _serve_once(eng, prompts, max_tokens)
        await eng.stop()
        return eng, prof, wall

    eng, prof, wall = asyncio.run(run())
    kernels = _device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    res = {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }
    print(f"[profile] serving mix under torch.profiler: wall {res['wall_ms']:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {res['device_idle_share']:.3f} — {card}", flush=True)
    for k in res["top_kernels"]:
        print(f"[profile]   {k['ms']:9.3f} ms  x{k['count']:5d}  {k['name']}", flush=True)

    toks = torch.randint(0, PROMPT_VOCAB, (1, 1024), device=eng.device)
    with torch.inference_mode():
        def prefill():
            gpt2.prefill_forward(eng.model, toks)
            torch.cuda.synchronize()

        prefill()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            prefill()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill()
    res["prefill_1024_ms"] = statistics.median(times)
    kernels = _device_kernels(prof)
    res["prefill_1024_device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    res["prefill_1024_top"] = [
        {"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3}
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    ]
    print(f"[profile] one T=1024 prefill (12 layers, host clock to synchronize): "
          f"{res['prefill_1024_ms']:.3f} ms median of 5; device time "
          f"{res['prefill_1024_device_ms']:.3f} ms — {card}", flush=True)
    for k in res["prefill_1024_top"]:
        print(f"[profile]   {k['ms']:9.3f} ms  x{k['count']:5d}  {k['name']}", flush=True)
    print("[profile] " + json.dumps(res), flush=True)
    return res


def _train_batch(B: int, T: int, seed: int, device, vocab: int = PROMPT_VOCAB):
    """Tokens over the tokenizer's range from a seed, and their next-token
    targets."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1))
    toks = torch.from_numpy(toks).to(device)
    return toks[:, :-1], toks[:, 1:]


# A tensor whose largest CPU gradient entry is below this share of the
# model's largest has an exact gradient of zero and holds only rounding
# noise: an attention key bias (the softmax ignores a shift of all of a
# query's scores), or a ResNet branch behind a zero-initialised BatchNorm
# scale.  The ViT's key biases read 3.8e-10 to 4.6e-9 of the model's
# largest on the CPU, its next smallest tensor (a query bias) 1.9e-3.
ZERO_GRAD_SHARE = 1e-6


def _step_errors(card_model, cpu_model, grads: dict):
    """After one step from the same weights on the card and on the CPU:
    (max over tensors of max |g_card - g_cpu| / max |g_cpu|, max |p_card -
    p_cpu| over all entries, the same over the entries whose CPU gradient
    is at least 1e-2 of their tensor's largest, and {name: (max |g_card -
    g_cpu|, max |g_cpu|) over the model's largest CPU gradient entry} for
    the tensors at rounding level (ZERO_GRAD_SHARE)).  Noise agrees to no
    relative tolerance and AdamW follows its sign, so those tensors are
    held apart: none of their entries counts in the first and third
    numbers, and the caller holds the card's gradient there to rounding
    level too."""
    worst_g, worst_p, worst_p_sure = 0.0, 0.0, 0.0
    gtop = max(g.abs().max().item() for g in grads["cpu"].values())
    zero = {}
    params_cpu = dict(cpu_model.named_parameters())
    for n, p in card_model.named_parameters():
        gc, gr = grads["cuda"][n], grads["cpu"][n]
        gmax = gr.abs().max().item()
        diff = (p.detach().cpu() - params_cpu[n].detach()).abs()
        worst_p = max(worst_p, diff.max().item())
        if gmax < ZERO_GRAD_SHARE * gtop:
            zero[n] = ((gc - gr).abs().max().item() / gtop, gmax / gtop)
            continue
        worst_g = max(worst_g, (gc - gr).abs().max().item() / gmax)
        sure = gr.abs() >= 1e-2 * gmax
        if sure.any():
            worst_p_sure = max(worst_p_sure, diff[sure].max().item())
    return worst_g, worst_p, worst_p_sure, zero


def _zero_grads_ok(zero: dict) -> bool:
    return all(err <= ZERO_GRAD_SHARE for err, _ in zero.values())


def _fmt_zero(zero: dict) -> str:
    """The tensors at rounding level, for the phases' lines."""
    if not zero:
        return "no tensor at rounding level"
    return (f"{len(zero)} tensor(s) at rounding level (exact gradient zero, e.g. "
            f"{next(iter(zero))}): max|g_cpu| {max(g for _, g in zero.values()):.2e}, "
            f"max|g_card - g_cpu| {max(e for e, _ in zero.values()):.2e} of the model's "
            f"max|g| (tol {ZERO_GRAD_SHARE:g})")


def _adamw_step_parity(tag: str, label: str, cpu_model, make_step, batch, lr: float,
                       card: str, fwd_launches: int = None) -> dict:
    """One float32 AdamW step from the same weights on the card (copied
    from ``cpu_model``) and on the CPU, ``make_step(model)`` giving each its
    step: the loss, every gradient and every parameter after it.  With
    ``fwd_launches``, the card's step must launch B1 that many times.

    f32 on both sides, sums in other orders (cuBLAS, cuDNN and the kernels
    against the CPU's libraries and the plain versions): the loss to 1e-4
    relative, each gradient to 1e-3 of its largest entry; a tensor at
    rounding level (``_step_errors``) to ZERO_GRAD_SHARE of the model's
    largest.  After the step, AdamW's update is close to lr * g / |g|:
    entries whose gradient is at least 1e-2 of its tensor's largest agree
    to 1e-2 lr, the rest (gradients within float noise of zero) within 2
    lr."""
    card_model = copy.deepcopy(cpu_model).to("cuda")
    losses, grads = {}, {}
    for name, model in (("cuda", card_model), ("cpu", cpu_model)):
        step = make_step(model)
        launches = fa.flash_attention_fwd.launches
        losses[name] = step(model, *(t.to(name) for t in batch)).item()
        if (name == "cuda" and fwd_launches is not None
                and fa.flash_attention_fwd.launches - launches != fwd_launches):
            raise AssertionError(f"the card's {label} parity step did not run the flash kernels")
        grads[name] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst_g, worst_p, worst_p_sure, zero = _step_errors(card_model, cpu_model, grads)
    ok = (loss_err <= 1e-4 and worst_g <= 1e-3 and _zero_grads_ok(zero)
          and worst_p_sure <= 1e-2 * lr and worst_p <= 2 * lr and math.isfinite(losses["cuda"]))
    res = {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"], "loss_rel_err": loss_err,
           "grad_err_over_max": worst_g, "zero_grad_tensors": zero, "param_err": worst_p,
           "param_err_sure": worst_p_sure, "lr": lr}
    print(f"[{tag}] {label}, one AdamW step, card vs CPU: loss "
          f"{losses['cuda']:.6f} vs {losses['cpu']:.6f} (rel {loss_err:.2e}, tol 1e-4); "
          f"grads max|err|/max|g| {worst_g:.2e} (tol 1e-3); {_fmt_zero(zero)}; params "
          f"{worst_p_sure:.2e} where |g| >= 1e-2 max|g| (tol {1e-2 * lr:g}), {worst_p:.2e} "
          f"overall (tol {2 * lr:g}) {'ok' if ok else 'FAIL'} — {card}", flush=True)
    if not ok:
        raise AssertionError(f"{label} training parity failed: {res}")
    return res


def phase_train_parity(card: str) -> dict:
    """One float32 AdamW step of GPT-2 small at full width from the same
    weights, on the card (the three kernels) and on the CPU (their plain
    versions): the loss, every gradient and every parameter after it."""
    cfg = gpt2.GPT2Config.small(dtype=torch.float32, remat=False)
    cpu = gpt2.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return _adamw_step_parity(
        "train parity", "GPT-2 small f32 B=2 T=128", cpu,
        lambda m: gpt2.make_train_step(cfg, gpt2.make_adamw(m.parameters(), TRAIN_LR)),
        _train_batch(2, 128, seed=3, device="cpu"), TRAIN_LR, card, fwd_launches=cfg.n_layer)


def _launch_counts():
    return (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches)


def _reset_counts():
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0


def phase_train(card: str) -> dict:
    """The training path, driven through make_train_step with the launch
    counts set to 0 just before and read just after; then one remat step,
    and a profiled window."""
    cfg = gpt2.GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.float32, remat=False)
    model = gpt2.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = gpt2.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=TRAIN_LR))
    tokens, targets = _train_batch(TRAIN_B, TRAIN_T, seed=4, device="cuda")
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    losses, wall = _run_steps("training", step, model, (tokens, targets))
    launches = _launch_counts()
    want = (cfg.n_layer * n_steps,) * 3
    if launches != want:
        raise AssertionError(f"launches (B1, B2, B3) {launches} over {n_steps} steps, "
                             f"expected {want}: n_layer each a step")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = TRAIN_B * TRAIN_T * TRAIN_STEPS / wall
    flops_tok = gpt2.flops_per_token(cfg, TRAIN_T)
    mfu = tok_s * flops_tok / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # remat: the same weights in a remat model; its step recomputes each
    # block's forward in the backward, so B1 launches twice a layer; the
    # loss is the forward's, and equals the plain model's at those weights
    rcfg = gpt2.GPT2Config.small(dtype=torch.bfloat16, param_dtype=torch.float32, remat=True)
    rmodel = gpt2.GPT2(rcfg).to("cuda")
    rmodel.load_state_dict(model.state_dict())
    rstep = gpt2.make_train_step(rcfg, gpt2.make_adamw(rmodel.parameters(), lr=TRAIN_LR))
    _reset_counts()
    loss_remat = rstep(rmodel, tokens, targets).item()
    remat_launches = _launch_counts()
    _reset_counts()
    loss_plain = step(model, tokens, targets).item()
    plain_launches = _launch_counts()
    del rmodel, rstep
    if remat_launches != (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer):
        raise AssertionError(f"remat step launched (B1, B2, B3) {remat_launches}, expected "
                             f"({2 * cfg.n_layer}, {cfg.n_layer}, {cfg.n_layer})")
    if plain_launches != (cfg.n_layer,) * 3:
        raise AssertionError(f"plain step launched {plain_launches}")
    # the forward runs the same operations on the same inputs in both
    if abs(loss_remat - loss_plain) > 1e-5 * abs(loss_plain):
        raise AssertionError(f"remat loss {loss_remat} != plain loss {loss_plain}")

    # where the time goes: two steps under torch.profiler
    prof = _profile_step(lambda: step(model, tokens, targets), steps=2)
    flash = prof["flash_ms_per_step"]
    res = {
        "config": "GPT-2 small, float32 params, bfloat16 compute, remat=False, "
                  f"B={TRAIN_B}, T={TRAIN_T}, AdamW lr {TRAIN_LR}",
        "losses": losses,
        "step_ms": step_ms,
        "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "mfu": mfu,
        "peak_memory_gb": peak_gb,
        "launches": {"flash_attention_fwd": launches[0], "flash_attention_dq": launches[1],
                     "flash_attention_dkv": launches[2], "steps": n_steps},
        "remat_launches": list(remat_launches),
        "loss_remat": loss_remat,
        "loss_plain": loss_plain,
        **prof,
        "card": card,
    }
    print(f"[train] GPT-2 small bf16 compute / f32 params, B={TRAIN_B} T={TRAIN_T}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {n_steps} steps; step {step_ms:.2f} ms "
          f"(mean of {TRAIN_STEPS} timed steps), {tok_s:.0f} tok/s, MFU {mfu:.4f} at "
          f"{flops_tok / 1e9:.4f} GFLOP/token; peak memory {peak_gb:.2f} GB; launches "
          f"B1/B2/B3 {launches} = {cfg.n_layer} x {n_steps} — {card}", flush=True)
    print(f"[train] remat step: launches B1/B2/B3 {remat_launches}, loss {loss_remat:.6f} = "
          f"plain {loss_plain:.6f} — {card}", flush=True)
    print(f"[train] profiled: {res['profiled_step_ms']:.2f} ms a step, device busy "
          f"{res['device_busy_ms_per_step']:.2f} ms, idle share {res['device_idle_share']:.4f}; "
          f"flash per step: fwd {flash['flash_fwd_bf16_kernel']:.3f} ms, dq "
          f"{flash['flash_dq_bf16_kernel']:.3f} ms, dkv {flash['flash_dkv_bf16_kernel']:.3f} ms "
          f"— {card}", flush=True)
    for k in res["top_kernels"]:
        print(f"[train]   {k['ms_per_step']:9.3f} ms/step  x{k['count']:5d}  {k['name']}",
              flush=True)
    print("[train] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# Llama-1B: the kernels at head dim 128 behind the GQA repeat, an f32 step
# at full width against the CPU, and the training path
# ----------------------------------------------------------------------
LLAMA_B, LLAMA_T = 4, 4096  # llama_1b's max_seq_len: 16,384 tokens a step
LLAMA_VOCAB = 32000


def _gqa_inputs(B: int, T: int, seed: int):
    """Llama-1B's attention inputs on the card in bf16: q [B, T, 16, 128],
    k and v drawn for its 8 KV heads and repeated to 16 as LlamaAttention
    repeats them (contiguous), and dO [B, T, 16, 128]."""
    cfg = llama.LlamaConfig.llama_1b()
    rep = cfg.n_head // cfg.n_kv_head
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(heads):
        return torch.randn(B, T, heads, cfg.d_head, generator=g, device="cuda").to(torch.bfloat16)

    q = draw(cfg.n_head)
    k, v = (torch.repeat_interleave(draw(cfg.n_kv_head), rep, dim=2) for _ in range(2))
    return q, k, v, draw(cfg.n_head)


def phase_llama_kernels(card: str) -> list:
    """B1, B2 and B3 at Llama-1B's attention, the training path's [4, 4096,
    16, 128]: held against their plain versions (the tolerances of the
    training shape, relative for the gradients, since their scale grows
    with T), then timed there; returns the records (launches are filled in
    by the training phase)."""
    q, k, v, do = _gqa_inputs(LLAMA_B, LLAMA_T, seed=501)
    errs = _hold_bf16_kernels("llama kernels", "Llama-1B attention", "GQA-repeated k/v",
                              q, k, v, do)
    torch.cuda.empty_cache()
    recs = _time_bf16_kernels("llama kernels", "llama_train", q, k, v, do, errs, card,
                              plain_reps=1)
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def phase_llama_parity(card: str) -> dict:
    """One float32 AdamW step at Llama-1B's full width (d_model 2048, 16
    heads over 8 KV heads, d_ff 5504, vocab 32000) and 2 of its layers,
    B=1, T=256, on the card (the kernels at D=128) and on the CPU."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama_1b(dtype=torch.float32), n_layer=2,
                              remat=False)
    cpu = llama.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return _adamw_step_parity(
        "llama parity", "Llama-1B widths x 2 layers f32 B=1 T=256", cpu,
        lambda m: llama.make_train_step(cfg, gpt2.make_adamw(m.parameters(), TRAIN_LR)),
        _train_batch(1, 256, seed=6, device="cpu", vocab=LLAMA_VOCAB), TRAIN_LR, card,
        fwd_launches=cfg.n_layer)


def _llama_flops_per_token(cfg, n_params: int, T: int) -> float:
    """Model FLOPs a token of a training step (no remat recompute): 6 per
    weight outside the embedding, and 6 T d_model a layer for causal
    attention (QK^T and PV over T/2 keys on average, forward and
    backward)."""
    return 6.0 * (n_params - cfg.vocab_size * cfg.d_model) + 6.0 * cfg.n_layer * T * cfg.d_model


def _kind(kernel: str) -> str:
    """A device kernel's kind by its name: the port's flash kernels, the
    cuBLAS/cuDNN products, torch's elementwise kernels and copies, its
    reductions, or other."""
    if "flash_" in kernel:
        return "flash"
    if any(w in kernel for w in ("nvjet", "gemm", "cutlass", "sm90_", "conv", "wgrad",
                                 "dgrad", "fprop", "xmma", "cudnn")):
        return "matmul/conv"
    if "elementwise" in kernel or "copy" in kernel:
        return "elementwise"
    if "reduce" in kernel or "norm" in kernel.lower():
        return "reduction"
    return "other"


def _fmt_ms(by_kind: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in by_kind.items())


def _profile_step(run, steps: int = 1) -> dict:
    """``steps`` calls of ``run`` (a training step) under torch.profiler:
    a step's wall time to a synchronize, the device's busy time a step and
    idle share, device time a step by kind and by kernel (``count`` over
    all the steps), and the flash kernels' time a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / steps
    kernels = _device_kernels(prof)

    def ms(events):  # device time a step
        return sum(e.self_device_time_total for e in events) / 1e3 / steps

    busy_ms = ms(kernels)
    by_kind = {}
    for e in kernels:
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + ms([e])
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "profiled_step_ms": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "flash_ms_per_step": {
            name: ms([e for e in kernels if name in e.key])
            for name in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                         "flash_dkv_bf16_kernel")},
        "top_kernels": [{"name": e.key[:80], "count": e.count, "ms_per_step": ms([e])}
                        for e in top[:15]],
    }


def phase_llama_train(card: str) -> dict:
    """The main path: Llama-1B at full width and depth, float32 params
    with bfloat16 compute and remat (the reference's defaults), B=4,
    T=4096, AdamW at bench.py's hyperparameters, driven through
    make_train_step with the launch counts set to 0 just before and read
    just after (B1 twice a layer, B2 and B3 once); then one step under
    torch.profiler."""
    cfg = llama.LlamaConfig.llama_1b()
    model = llama.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = llama.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=TRAIN_LR))
    tokens, targets = _train_batch(LLAMA_B, LLAMA_T, seed=7, device="cuda", vocab=LLAMA_VOCAB)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    losses, wall = _run_steps("Llama training", step, model, (tokens, targets))
    launches = _launch_counts()
    L = cfg.n_layer
    want = (2 * L * n_steps, L * n_steps, L * n_steps)
    if launches != want:
        raise AssertionError(f"Llama launches (B1, B2, B3) {launches} over {n_steps} steps, "
                             f"expected {want}: B1 twice a layer (remat), B2 and B3 once")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = LLAMA_B * LLAMA_T * TRAIN_STEPS / wall
    n_params = llama.num_params(model)
    flops_tok = _llama_flops_per_token(cfg, n_params, LLAMA_T)
    mfu = tok_s * flops_tok / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof = _profile_step(lambda: step(model, tokens, targets))
    flash = prof["flash_ms_per_step"]
    res = {
        "config": f"Llama-1B (16 layers, d_model 2048, 16 heads over 8 KV heads, d_ff 5504, "
                  f"vocab 32000), float32 params, bfloat16 compute, remat=True, B={LLAMA_B}, "
                  f"T={LLAMA_T}, AdamW lr {TRAIN_LR}",
        "params": n_params,
        "losses": losses,
        "step_ms": step_ms,
        "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "mfu": mfu,
        "peak_memory_gb": peak_gb,
        "launches": {"flash_attention_fwd": launches[0], "flash_attention_dq": launches[1],
                     "flash_attention_dkv": launches[2], "steps": n_steps},
        **prof,
        "card": card,
    }
    print(f"[llama train] Llama-1B bf16 compute / f32 params, remat, B={LLAMA_B} T={LLAMA_T} "
          f"({n_params} params): loss {losses[0]:.4f} -> {losses[-1]:.4f} over {n_steps} "
          f"steps; step {step_ms:.2f} ms (mean of {TRAIN_STEPS} timed steps), {tok_s:.0f} "
          f"tok/s, MFU {mfu:.4f} at {flops_tok / 1e9:.4f} GFLOP/token; peak memory "
          f"{peak_gb:.2f} GB; launches B1/B2/B3 {launches} = ({2 * L}, {L}, {L}) x {n_steps} "
          f"— {card}", flush=True)
    print(f"[llama train] profiled step: {res['profiled_step_ms']:.2f} ms, device busy "
          f"{res['device_busy_ms_per_step']:.2f} ms, idle share {res['device_idle_share']:.4f}; "
          f"by kind {_fmt_ms(res['device_ms_by_kind'])}; flash per step: fwd "
          f"{flash['flash_fwd_bf16_kernel']:.3f} ms, dq {flash['flash_dq_bf16_kernel']:.3f} ms, "
          f"dkv {flash['flash_dkv_bf16_kernel']:.3f} ms — {card}", flush=True)
    for k in res["top_kernels"]:
        print(f"[llama train]   {k['ms_per_step']:9.3f} ms/step  x{k['count']:5d}  {k['name']}",
              flush=True)
    print("[llama train] " + json.dumps(res), flush=True)
    return res


# ----------------------------------------------------------------------
# Vision and small models: ResNet, ViT, MLP, MoE (cuDNN, cuBLAS and torch
# ops; no kernel of the port runs here)
# ----------------------------------------------------------------------
RESNET_B, RESNET_LR = 512, 0.1  # bench_resnet.py's batch and SGD(0.1, momentum 0.9)


def _class_images(B: int, shape: tuple, seed: int, device):
    """Synthetic labelled images from a seed: each of 10 classes has a
    random prototype, and an image is its class's prototype plus unit
    noise, so a few steps can lower the loss.  (x [B, *shape] float32,
    y [B] int64) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    protos = torch.randn(10, *shape, generator=g, device=device)
    y = torch.randint(0, 10, (B,), generator=g, device=device)
    return protos[y] + torch.randn(B, *shape, generator=g, device=device), y


def _run_steps(tag: str, step, model, batch) -> tuple:
    """TRAIN_WARMUP + TRAIN_STEPS steps on one batch: (losses, seconds of
    the timed steps); raises unless the loss is finite and falling."""
    losses = [step(model, *batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, *batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss not finite and falling: {losses}")
    return losses, wall


def phase_resnet(card: str) -> dict:
    """One float32 ResNet step at resnet18's widths (B=8, 32x32) on the card
    and on the CPU from the same weights, SGD with momentum: the loss,
    every gradient, the parameters and the new running statistics after
    it.  Then ResNet-50 at bench_resnet.py's configuration: bf16 compute,
    B=512 32x32x3 images, SGD lr 0.1 momentum 0.9, 13 steps."""
    cfg = resnet.ResNetConfig.resnet18(dtype=torch.float32)
    cpu = resnet.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu).to("cuda")
    x, y = _class_images(8, (32, 32, 3), seed=8, device="cpu")
    losses, grads = {}, {}
    for name, model in (("cuda", card_model), ("cpu", cpu)):
        step = resnet.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=RESNET_LR,
                                                           momentum=0.9))
        losses[name] = step(model, x.to(name), y.to(name)).item()
        grads[name] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    # f32 on both sides, cuDNN against the CPU's convolutions: the loss to
    # 1e-4 relative, each gradient and each new running statistic to 1e-3
    # and 1e-4 of its tensor's largest entry (a gradient at rounding level,
    # behind a zero-initialised BatchNorm scale, as _step_errors says); a
    # first SGD step moves each
    # parameter by lr x its gradient, so the parameters agree to lr x the
    # gradient tolerance (plus float32 rounding of the parameter, 1e-6 of
    # its largest entry)
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst_g, _, _, zero = _step_errors(card_model, cpu, grads)
    cpu_params, cpu_bufs = dict(cpu.named_parameters()), dict(cpu.named_buffers())
    worst_p = max(((p.detach().cpu() - cpu_params[n].detach()).abs().max()
                   / (RESNET_LR * 1e-3 * grads["cpu"][n].abs().max()
                      + 1e-6 * cpu_params[n].detach().abs().max())).item()
                  for n, p in card_model.named_parameters())
    worst_s = max(_rel(b.cpu(), cpu_bufs[n])[1] for n, b in card_model.named_buffers())
    ok = (math.isfinite(losses["cuda"]) and loss_err <= 1e-4 and worst_g <= 1e-3
          and _zero_grads_ok(zero) and worst_p <= 1.0 and worst_s <= 1e-4)
    res = {"parity": {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
                      "loss_rel_err": loss_err, "grad_err_over_max": worst_g,
                      "zero_grad_tensors": zero, "param_err_over_tol": worst_p,
                      "batch_stats_err_over_max": worst_s}}
    print(f"[resnet] resnet18 widths f32 B=8 32x32, one SGD-momentum step, card vs CPU: loss "
          f"{losses['cuda']:.6f} vs {losses['cpu']:.6f} (rel {loss_err:.2e}, tol 1e-4); grads "
          f"max|err|/max|g| {worst_g:.2e} (tol 1e-3); {_fmt_zero(zero)}; params "
          f"{worst_p:.2e} of their tolerance; "
          f"new batch stats max|err|/max {worst_s:.2e} (tol 1e-4) {'ok' if ok else 'FAIL'} "
          f"— {card}", flush=True)
    if not ok:
        raise AssertionError(f"ResNet training parity failed: {res}")
    del cpu, card_model

    cfg = resnet.ResNetConfig.resnet50()
    model = resnet.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = resnet.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=RESNET_LR,
                                                       momentum=0.9))
    batch = _class_images(RESNET_B, (32, 32, 3), seed=9, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses, wall = _run_steps("ResNet-50", step, model, batch)
    if not all(bool(torch.isfinite(b).all()) for b in model.buffers()):
        raise AssertionError("ResNet-50 running statistics not finite")
    res["resnet50"] = {"losses": losses, "step_ms": wall / TRAIN_STEPS * 1e3,
                       "images_per_s": RESNET_B * TRAIN_STEPS / wall,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "params": resnet.num_params(model), "card": card}
    r = res["resnet50"]
    r.update(_profile_step(lambda: step(model, *batch)))
    print(f"[resnet] ResNet-50 bf16 compute / f32 params, B={RESNET_B} 32x32x3, SGD lr "
          f"{RESNET_LR} momentum 0.9: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps; step {r['step_ms']:.2f} ms (mean of {TRAIN_STEPS}), "
          f"{r['images_per_s']:.0f} images/s, peak memory {r['peak_memory_gb']:.2f} GB; "
          f"profiled step {r['profiled_step_ms']:.2f} ms, device busy "
          f"{r['device_busy_ms_per_step']:.2f} ms, by kind {_fmt_ms(r['device_ms_by_kind'])} "
          f"— {card}", flush=True)
    for k in r["top_kernels"][:8]:
        print(f"[resnet]   {k['ms_per_step']:9.3f} ms/step  x{k['count']:5d}  {k['name']}",
              flush=True)
    print("[resnet] " + json.dumps(res), flush=True)
    return res


def _small_model(tag: str, label: str, module, f32_cfg, bf16_cfg, shape: tuple,
                 parity_b: int, train_b: int, card: str) -> dict:
    """An f32 AdamW step card against CPU at ``parity_b``, then 13 bf16
    AdamW steps at ``train_b`` with a falling loss (lr 3e-4, bench.py's
    AdamW)."""
    cpu = module.init_model(f32_cfg, torch.Generator().manual_seed(0), device="cpu")
    res = {"parity": _adamw_step_parity(
        tag, f"{label} f32 B={parity_b}", cpu,
        lambda m: module.make_train_step(f32_cfg, gpt2.make_adamw(m.parameters(), TRAIN_LR)),
        _class_images(parity_b, shape, seed=10, device="cpu"), TRAIN_LR, card)}
    model = module.init_model(bf16_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = module.make_train_step(bf16_cfg, gpt2.make_adamw(model.parameters(), TRAIN_LR))
    losses, wall = _run_steps(label, step, model,
                              _class_images(train_b, shape, seed=11, device="cuda"))
    res["bf16"] = {"losses": losses, "step_ms": wall / TRAIN_STEPS * 1e3,
                   "samples_per_s": train_b * TRAIN_STEPS / wall, "card": card}
    print(f"[{tag}] {label} bf16 compute, B={train_b}, AdamW lr {TRAIN_LR}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; step "
          f"{res['bf16']['step_ms']:.3f} ms, {res['bf16']['samples_per_s']:.0f} samples/s "
          f"— {card}", flush=True)
    return res


def phase_vit(card: str) -> dict:
    """ViT at its default config (32x32 images in 4x4 patches, d_model 192,
    6 layers, 3 heads): f32 step card vs CPU, then bf16 steps."""
    return _small_model("vit", "ViT (32/4, d 192, 6 layers, 3 heads)", vit,
                        vit.ViTConfig(dtype=torch.float32), vit.ViTConfig(), (32, 32, 3),
                        parity_b=8, train_b=256, card=card)


def phase_mlp(card: str) -> dict:
    """The MNIST MLP at its default config (784-256-256-10): f32 step card
    vs CPU, then bf16 steps."""
    return _small_model("mlp", "MLP 784-256-256-10", mlp, mlp.MLPConfig(),
                        mlp.MLPConfig(dtype=torch.bfloat16), (28, 28), parity_b=128,
                        train_b=512, card=card)


def phase_moe(card: str) -> dict:
    """MoEMLP at its default widths (d_model 128, d_ff 256, 8 experts, top
    2, capacity factor 2) in float32 on x [4, 256, 128]: the forward and a
    backward from a random cotangent on the card and on the CPU from the
    same weights.  f32 on both sides in other summation orders: the output
    to 1e-4 of its largest entry, the aux loss to 1e-4 relative, each
    gradient (the weights' and the input's) to 1e-3 of its largest."""
    cfg = moe.MoEConfig(dtype=torch.float32)
    cpu = moe.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_model = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(12)
    x = torch.randn(4, 256, cfg.d_model, generator=g)
    w = torch.randn(4, 256, cfg.d_model, generator=g)
    got = {}
    for name, model in (("cuda", card_model), ("cpu", cpu)):
        xx = x.to(name).requires_grad_(True)
        out, aux = model(xx)
        ((out * w.to(name)).sum() + aux).backward()
        got[name] = {"out": out.detach().cpu(), "aux": aux.item(), "dx": xx.grad.cpu(),
                     **{n: p.grad.cpu() for n, p in model.named_parameters()}}
    c, r = got["cuda"], got["cpu"]
    out_err = _rel(c["out"], r["out"])[1]
    aux_err = abs(c["aux"] - r["aux"]) / abs(r["aux"])
    grad_err = max(_rel(c[n], r[n])[1] for n in c if n not in ("out", "aux"))
    ok = out_err <= 1e-4 and aux_err <= 1e-4 and grad_err <= 1e-3
    res = {"out_err_over_max": out_err, "aux_cuda": c["aux"], "aux_cpu": r["aux"],
           "aux_rel_err": aux_err, "grad_err_over_max": grad_err, "card": card}
    print(f"[moe] MoEMLP f32 (d 128, d_ff 256, 8 experts, top 2) x [4, 256, 128], card vs CPU: "
          f"out max|err|/max {out_err:.2e} (tol 1e-4); aux {c['aux']:.6f} vs {r['aux']:.6f} "
          f"(rel {aux_err:.2e}, tol 1e-4); grads max|err|/max|g| {grad_err:.2e} (tol 1e-3) "
          f"{'ok' if ok else 'FAIL'} — {card}", flush=True)
    if not ok:
        raise AssertionError(f"MoE parity failed: {res}")
    return res


def main() -> int:
    card = phase_device()
    phase_build()
    fwd_rec = phase_kernels(card)
    train_recs = phase_bwd_kernels(card)
    phase_host_cost(card)
    llama_recs = phase_llama_kernels(card)
    phase_parity(card)
    serve = phase_serve(card)
    fwd_rec["launches"] = serve["flash_launches"]
    phase_profile(card)
    phase_train_parity(card)
    train = phase_train(card)
    for rec in train_recs:
        rec["launches"] = train["launches"][rec["name"]]
    phase_llama_parity(card)
    llama_train = phase_llama_train(card)
    for rec in llama_recs:
        rec["launches"] = llama_train["launches"][rec["name"]]
    phase_resnet(card)
    phase_vit(card)
    phase_mlp(card)
    phase_moe(card)
    print(json.dumps({"kernels": [fwd_rec, *train_recs, *llama_recs]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
