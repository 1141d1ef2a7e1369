#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device   — require CUDA; print the card's name and power limit.
2. build    — build every kernel from the sources in the checkout
              (one nvcc per source, all started together).
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the shapes the serving path gives it, then timed beside
              its plain version, its roofline bound and one library call.
4. parity   — GPT-2 small at full width in float32: the engine's greedy
              tokens equal the full-forward generate_greedy oracle's.
5. serve    — the main path: GPT-2 small in bfloat16 serving 16
              concurrent requests through LLMEngine; every request ends
              with its max_tokens, no KV block leaks, and the flash kernel
              launched n_layer times per prefill.
6. profile  — the same traffic under torch.profiler (device busy share,
              time by kernel) and one T=1024 prefill timed alone.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
from ray_tpu_torch.serve.llm.engine import FINISHED

# H100 SXM published peaks (NVIDIA data sheet; dense bf16 tensor cores,
# HBM3), the denominators of every bound below
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

KERNEL_SOURCES = ("flash_fwd",)
PROMPT_VOCAB = 50257  # GPT-2's tokenizer; the model's 50304 rows pad it
PARITY_LENS = (5, 37, 130, 300)
# the main path's 16 prompts: every prefill bucket from 8 to 1024
SERVE_LENS = (5, 12, 30, 60, 100, 200, 300, 400, 520, 600, 700, 800, 900, 960, 20, 45)


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
            if "registers" in line or "spill" in line or "error" in line.lower():
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
    # (T, dtype, causal, D, fused): the prefill buckets' range, ragged 100,
    # both dtypes, one non-causal case per dtype, D=128 per dtype
    cases = [(T, dt, True, 64, True) for T in (8, 100, 256, 1024)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(100, dt, False, 64, False) for dt in (torch.bfloat16, torch.float32)]
    cases += [(256, dt, True, 128, False) for dt in (torch.bfloat16, torch.float32)]
    # f32: both sides compute in f32 and differ only in summation order.
    # bf16: the kernel rounds P to bf16 before P.V (relative 2^-9 per
    # probability) where the plain version keeps f32, and both round O
    # once to bf16: 2e-2 covers one bf16 ulp for |O| in [2, 4) plus the P
    # rounding.  The LSE is f32 on both sides.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
    main_err = None
    for i, (T, dt, causal, D, fused) in enumerate(cases):
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
    elt = q.element_size()
    bytes_moved = 3 * B * T * H * D * elt + B * T * H * D * elt + B * H * T * 4
    flops = 4 * B * H * D * (T * (T + 1) // 2)  # QK^T and PV over the causal pairs
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    rec = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/pallas_attention.py:54",
        "launches": None,
        "max_abs_err": main_err[0],
        "max_abs_err_lse": main_err[1],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "at": f"[B, T, H, D] = [{B}, {T}, {H}, {D}] bfloat16 causal",
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
    }
    print(f"[kernels] flash_fwd @ [1,1024,12,64] bf16 causal: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}; {flops / 1e9:.3f} GFLOP, {bytes_moved / 1e6:.3f} MB), "
          f"{rec['achieved_tflops']:.2f} TFLOP/s — {card}", flush=True)
    return rec


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


def phase_profile(card: str) -> dict:
    """Where the serving time goes: the same mix again under
    torch.profiler (device busy share, device time by kernel), and one
    T=1024 prefill timed alone with its attention share."""
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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


def main() -> int:
    card = phase_device()
    phase_build()
    rec = phase_kernels(card)
    phase_parity(card)
    serve = phase_serve(card)
    rec["launches"] = serve["flash_launches"]
    phase_profile(card)
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
