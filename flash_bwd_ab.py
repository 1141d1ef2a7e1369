"""The port's flash backward kernels timed from several source trees in
turns on one card in one call, to compare two versions of a kernel.

    python3 flash_bwd_ab.py ROOT [ROOT ...] [--out PATH]

Each ROOT is a directory holding a ``ray_tpu_torch/`` package (``.`` for
this checkout; for a variant, copy ``ray_tpu_torch/`` under a directory
that ``.gitignore`` lists, such as ``build/<name>/``, and edit the copy:
it builds its kernels into its own ``build/kernels/``).  Give the roots in
the order to run them, for example ``build/parent . . build/parent``.
Each root runs in a subprocess of its own, which builds its kernels and
times, in bf16 causal at Llama-1B's [4, 4096, 16, 128] and GPT-2 medium's
[16, 1024, 16, 64], the dq kernel forming Delta (``o=``), the dq kernel
reading a given Delta, the dkv kernel and the whole backward: the median
of 7 runs of 20 calls, CUDA events around each run behind a device-side
sleep, as ``chip_smoke.py``'s ``_time_ms`` times them.  Prints one line a
root (``AB {...}``) with the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = ((4, 4096, 16, 128), (16, 1024, 16, 64))

CHILD = r"""
import json, statistics, subprocess, sys
sys.path.insert(0, sys.argv[1])
import torch
from ray_tpu_torch.ops import _build, flash_attention as fa

if not torch.cuda.is_available():
    raise SystemExit("flash_bwd_ab: needs an NVIDIA card")
_build.load_all(["flash_fwd", "flash_bwd"])


def time_ms(fn, reps=20, rounds=7):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


out = {"root": sys.argv[1], "card": subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip().splitlines()[0]}
for B, T, H, D in json.loads(sys.argv[2]):
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    out[f"[{B}, {T}, {H}, {D}]"] = {
        "dq_with_delta_ms": time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, o=o)),
        "dq_given_delta_ms": time_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, delta)),
        "dkv_ms": time_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta)),
        "bwd_ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)),
    }
print("AB " + json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None, help="also append each AB line to this file")
    args = ap.parse_args()
    failed = 0
    for root in args.roots:
        p = subprocess.run([sys.executable, "-c", CHILD, root, json.dumps(SHAPES)],
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            failed += 1
            print(f"AB-FAILED {root}: exit {p.returncode}\n{p.stdout[-2000:]}{p.stderr[-4000:]}",
                  flush=True)
            continue
        print(lines[0], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(lines[0] + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
