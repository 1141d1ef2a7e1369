"""Phase 6 of chip_smoke.py (GPT-2 small's bf16 serving mix through
LLMEngine on the card) run from several checkouts in turn, to compare
their engine-level decode rates on one card in one call.

    python3 serve_ab.py [--reps 3] [--out PATH] LABEL=DIR[:VARIANT] ...

Each argument runs in a process of its own, from DIR (a checkout that
holds chip_smoke.py), in the order given, and drives the mix ``--reps``
times after one build of the kernels.  VARIANT changes the engine of
that checkout for the run, to take one suspect off its step path:

- ``nohooks``: the 1 Hz telemetry tick (``_push_metrics``), the request
  spans, the TTFT observer and the trace minting do nothing;
- ``noclamp``: ``gpt2.decode_forward`` looks positions up unclamped.

Prints one JSON line a process (``AB {...}``), then a summary with each
label's decode tok/s and the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, runpy, sys
variant, reps = sys.argv[1], int(sys.argv[2])
g = runpy.run_path("chip_smoke.py", run_name="__ab__")
card = g["phase_device"]()
g["phase_build"]()
if variant == "nohooks":
    from ray_tpu_torch.serve.llm.engine import LLMEngine
    LLMEngine._push_metrics = lambda self, force=False: None
    LLMEngine._record_spans = lambda self, req: None
    LLMEngine._observe_ttft = lambda self, req: None
    LLMEngine._mint_trace = lambda self: ("", "", None)
elif variant == "noclamp":
    from ray_tpu_torch.models import gpt2
    src = open(gpt2.__file__).read()
    clamped = "model.wpe(pos.clamp(max=cfg.max_seq_len - 1))"
    assert src.count(clamped) == 1, "no position clamp to take out"
    exec(compile(src.replace(clamped, "model.wpe(pos)"), gpt2.__file__, "exec"), gpt2.__dict__)
elif variant:
    raise SystemExit(f"unknown variant {variant!r}")
runs = [g["phase_serve"](card) for _ in range(reps)]
keys = ("decode_tok_per_s", "ttft_p50_s", "ttft_p95_s", "wall_s", "decode_steps",
        "flash_launches")
print("AB " + json.dumps({"card": card, "runs": [{k: r[k] for k in keys} for r in runs]}),
      flush=True)
"""


def _power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", help="LABEL=DIR[:VARIANT]")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    args = ap.parse_args()
    results = []
    for spec in args.runs:
        label, _, where = spec.partition("=")
        path, _, variant = where.partition(":")
        proc = subprocess.run([sys.executable, "-c", _CHILD, variant, str(args.reps)],
                              cwd=os.path.abspath(path), capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode or not lines:
            sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"{label}: exit {proc.returncode}", flush=True)
            return 1
        rec = {"label": label, "dir": path, "variant": variant, **json.loads(lines[-1][3:])}
        results.append(rec)
        rates = [r["decode_tok_per_s"] for r in rec["runs"]]
        print(f"{label} ({path}{':' + variant if variant else ''}): decode tok/s "
              f"{', '.join(repr(x) for x in rates)}", flush=True)
    power = _power()
    print(f"card: {power}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": power, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
