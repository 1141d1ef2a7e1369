"""chip_smoke.py's bf16 serving mix over HTTP (phases 16 and 17) with the
routers on actor RPC and on the channel dataplane, in turns on one card in
one call, to compare the two transports' client-side rates.

    python3 dataplane_ab.py [--order rpc,dp,nohot,nohot,dp,rpc] [--out PATH]

Each entry of ``--order`` starts a cluster of its own, deploys the counting
LLMServer through ``llm.build_app`` with its replica on the card, warms it
with one stream, sends phase 6's 16 requests as concurrent chunked HTTP
streams, and reads what the replica served.  ``rpc`` turns
``serve_channel_dataplane`` off for the cluster; ``dp`` keeps the default
(the dataplane); ``nohot`` is ``dp`` with the channels' hot spin
(``Channel._HOT_SPINS``) set to 0 in the proxy and the replica, so a
waiting reader yields its core (and the interpreter lock) from its first
poll.  Prints one JSON line an entry (``AB {...}``), then each label's
runs with the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import statistics
import sys
import time


def _no_hot_spin(_self=None):
    from ray_tpu_torch.experimental.channel import Channel

    Channel._HOT_SPINS = 0
    return Channel._HOT_SPINS


def run_one(g: dict, card: str, label: str) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch import serve

    env = "RAY_TPU_TORCH_serve_channel_dataplane"
    saved = os.environ.get(env)
    if label == "rpc":
        os.environ[env] = "0"
    cfg, prompts, max_tokens = g["_serve_mix"]()
    cfg = g["dataclasses"].replace(cfg, name="llm_bf16")
    mix = [{"prompt": p, "max_tokens": m} for p, m in zip(prompts, max_tokens)]
    port = g["_free_port"]()
    try:
        ray_tpu_torch.init(num_cpus=4)
        try:
            serve.start(http_port=port)
            handle = serve.run(g["_build_app"](cfg, g["CountingLLMServer"], cfg.to_dict()),
                               name="llm_bf16_app", http_port=port)
            g["_wait_route"](port, "/llm_bf16")
            if label == "nohot":
                replica = [n for n in g["_serve_actor_pids"]()
                           if n.startswith("SERVE_REPLICA::llm_bf16#")]
                for name in ["SERVE_PROXY", *replica]:
                    actor = ray_tpu_torch.get_actor(name, "serve")
                    ray_tpu_torch.get(actor.__ray_call__.remote(_no_hot_spin), timeout=60)
            g["_http_call"](port, "/llm_bf16", {"prompt": [1, 2, 3], "max_tokens": 2},
                            stream=True)
            handle.reset_launches.remote().result(timeout=120)
            t0 = time.perf_counter()
            got = g["_http_concurrent"](port, "/llm_bf16", mix, stream=True)
            wall = max(r["t_end"] for r in got) - t0
            served = handle.served.remote().result(timeout=120)
        finally:
            try:
                serve.shutdown()
            finally:
                ray_tpu_torch.shutdown()
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved
    total = sum(len(r["tokens"]) for r in got)
    ttft = sorted(r["ttft_s"] for r in got)
    if any(len(r["tokens"]) != m for r, m in zip(got, max_tokens)):
        raise AssertionError(f"{label}: a request ended short of its max_tokens")
    on_channel = served["dataplane"]["stream"]
    if on_channel != (0 if label == "rpc" else len(got)):
        raise AssertionError(f"{label}: the replica's dataplane served {on_channel} streams")
    return {"label": label, "card": card, "decode_tok_per_s": (total - len(got)) / wall,
            "ttft_p50_s": statistics.median(ttft), "ttft_p95_s": ttft[int(0.95 * len(ttft))],
            "wall_s": wall, "tokens": total, "served": served}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="rpc,dp,nohot,nohot,dp,rpc")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    g = runpy.run_path("chip_smoke.py", run_name="__ab__")
    card = g["phase_device"]()
    g["phase_build"]()
    rows = []
    for label in args.order.split(","):
        row = run_one(g, card, label)
        print("AB " + json.dumps(row), flush=True)
        rows.append(row)
    for label in dict.fromkeys(r["label"] for r in rows):
        mine = [r for r in rows if r["label"] == label]
        print(f"{label}: decode tok/s {[round(r['decode_tok_per_s'], 2) for r in mine]}, "
              f"TTFT p50 ms {[round(r['ttft_p50_s'] * 1e3, 1) for r in mine]}, "
              f"wall s {[round(r['wall_s'], 3) for r in mine]} — {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
