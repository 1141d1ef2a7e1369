"""GPT-2's data-parallel training loop for ``TorchTrainer`` (the port's
counterpart of ``bench.py``'s in-framework body: the same train step the
raw run drives, inside ``fit()``).

Each rank builds the model, from ``config["state_dict"]`` when it is given
and otherwise from ``config["seed"]``, takes its contiguous share of the
global batch ``config["tokens"]`` ([B, T + 1] token ids, B a multiple of
the world size), and takes ``warmup + steps`` AdamW steps
(``models/gpt2.py``'s ``make_train_step`` and ``make_adamw``).  With more
than one rank the gradients are all-reduced to their mean over the
process group before each optimizer step, so every rank takes the step
the whole batch gives.

It reports once, after the last step, through ``train.report``: every
step's loss (averaged over the ranks), the mean time of the timed steps,
tokens per second over all ranks, the model FLOPs utilisation a card against
``config["peak_flops"]`` when that is given, and the flash kernels'
launches in this process (B1, B2, B3), counted from 0 at the first step.
With ``config["checkpoint"]`` rank 0 also reports the parameters.

Runs on ``config["device"]`` (default ``cuda``); float32 there means
float32 (no TF32).  Every worker sees all of its node's cards, so on
``cuda`` each rank takes the card of its local rank.
"""

from __future__ import annotations

from typing import Any, Dict


def worker_device(name: str, local_rank: int):
    """The device a rank trains on: ``cuda`` without an index becomes the
    card ``cuda:<local rank>``, made the process's current card so that
    NCCL and the kernels run there too; any other device is taken as
    named."""
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    return device


def _allreduce_mean_grads(optimizer, args, kwargs) -> None:
    """Optimizer step pre-hook: every gradient becomes its mean over the
    process group."""
    import torch.distributed as dist

    world = dist.get_world_size()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                dist.all_reduce(p.grad)
                p.grad.div_(world)


def train_loop_per_worker(config: Dict[str, Any]) -> None:
    import math
    import time

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = worker_device(config.get("device", "cuda"), ctx.get_local_rank())
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = config["cfg"]
    if config.get("state_dict") is not None:
        model = gpt2.GPT2(cfg)
        model.load_state_dict(config["state_dict"])
        model = model.to(device)
    else:
        gen = torch.Generator(device=device).manual_seed(config.get("seed", 0))
        model = gpt2.init_model(cfg, gen, device=device)
    optimizer = gpt2.make_adamw(model.parameters(), lr=config["lr"])
    if world > 1:
        optimizer.register_step_pre_hook(_allreduce_mean_grads)
    step = gpt2.make_train_step(cfg, optimizer)

    toks = torch.tensor(config["tokens"], dtype=torch.long)  # a copy: the arg is read-only
    if toks.shape[0] % world:
        raise ValueError(f"global batch {toks.shape[0]} does not split over {world} ranks")
    share = toks.shape[0] // world
    local = toks[rank * share:(rank + 1) * share].to(device)
    tokens, targets = local[:, :-1], local[:, 1:]
    warmup, steps = config.get("warmup", 0), config["steps"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0
    losses = [step(model, tokens, targets) for _ in range(warmup)]
    sync()
    t0 = time.perf_counter()
    losses += [step(model, tokens, targets) for _ in range(steps)]
    sync()
    wall = time.perf_counter() - t0
    launches = [fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
                fa.flash_attention_dkv.launches]
    losses = torch.stack(losses)
    if world > 1:
        dist.all_reduce(losses)
        losses /= world
    losses = losses.tolist()

    tok_s = toks.shape[0] * tokens.shape[1] * steps / wall
    metrics = {
        "losses": losses,
        "finite": all(math.isfinite(x) for x in losses),
        "step_ms": wall / steps * 1e3,
        "tokens_per_s": tok_s,
        "launches": launches,
        "steps_run": warmup + steps,
        "world_size": world,
        "device": str(device),
    }
    if config.get("peak_flops"):
        metrics["mfu"] = (tok_s / world) * gpt2.flops_per_token(cfg, tokens.shape[1]) / (
            config["peak_flops"])
    if device.type == "cuda":
        metrics["device_name"] = torch.cuda.get_device_name(device)
    ckpt = None
    if config.get("checkpoint") and rank == 0:
        ckpt = train.Checkpoint.from_pytree(model.state_dict())
    train.report(metrics, checkpoint=ckpt)
