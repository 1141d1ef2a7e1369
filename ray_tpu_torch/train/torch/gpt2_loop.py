"""GPT-2's data-parallel training loop for ``TorchTrainer`` (the port's
counterpart of ``bench.py``'s in-framework body: the same train step the
raw run drives, inside ``fit()``).

Each rank builds the model, from ``config["state_dict"]`` when it is given
and otherwise from ``config["seed"]``, and takes ``warmup + steps`` AdamW
steps (``models/gpt2.py``'s ``make_train_step`` and ``make_adamw``). Its
batches come from one of two sources:

- ``config["tokens"]`` ([B, T + 1] token ids, B a multiple of the world
  size): every step takes the rank's contiguous share of that one global
  batch;
- otherwise the trainer's ``"train"`` dataset: each step takes the next
  ``config["batch_size"]`` rows ([T + 1] token ids each) of the rank's
  ``streaming_split`` shard through ``iter_device_batches``, which copies
  the next batch to the card while this one trains. The metrics then also
  hold each step's wait in ``next()`` (the timed window includes it) and a
  fingerprint of each batch as the step received it: per row, the int64
  sum of the token ids weighted by position (1, 2, ...).

With more than one rank the gradients are all-reduced to their mean over
the process group before each optimizer step, so every rank takes the
step the whole batch gives.

When the trainer carries a ``sharding_config``, the loop is the GSPMD
plan's instead (``train/sharding/gspmd.py``): ``plan_from_context()``
binds the config to a ``DeviceMesh`` over the group, ``shard_init``
builds the model (the same weights as above) with each parameter and
AdamW moment a DTensor on it, and ``jit_train_step`` runs the step.  Every
rank then takes the whole global batch and keeps its window: the batch
is ``config["tokens"]``, or, at world size 1, the dataset shard's
batches laid over the mesh by
``iter_device_batches(sharding=plan.data_sharding())`` (a split gives
each rank other rows, so a multi-rank plan over a dataset is refused).  The metrics add the mesh, whether every parameter and moment
holds the rule table's placements, and the batches' placements.  With
``config["resume_at"]`` = k, a second model from the same seed replays
the first k batches and saves a sharded checkpoint
(``plan.save_checkpoint``); a fresh plan and a model from another seed
load it and take the remaining steps, whose losses are reported as
``resumed_losses`` (with ``replay_losses`` for the first k).  With
``config["resume_layers"]`` = n as well, that drill runs on the model cut
to n layers (the same widths, a smaller checkpoint), after an unbroken
run of it over every batch (``unbroken_losses``) that the replay and the
resume are held to.

It reports once, after the last step, through ``train.report``: every
step's loss (averaged over the ranks) and the last as ``loss``, the mean time of the timed steps,
tokens per second over all ranks, the model FLOPs utilisation a card against
``config["peak_flops"]`` when that is given, the flash kernels'
launches in this process (B1, B2, B3), counted from 0 at the first step,
the process id and, on ``cuda``, the card's peak memory over the steps.
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
    import dataclasses
    import math
    import os
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

    def init_model(gen):
        if config.get("state_dict") is not None:
            model = gpt2.GPT2(cfg)
            model.load_state_dict(config["state_dict"])
            return model.to(device)
        return gpt2.init_model(cfg, gen, device=device)

    def make_optimizer(params):
        return gpt2.make_adamw(params, lr=config["lr"])

    def seeded(offset=0):
        return torch.Generator(device=device).manual_seed(config.get("seed", 0) + offset)

    plan = None
    if ctx.get_sharding_config() is not None:
        from ray_tpu_torch.train import sharding

        plan = sharding.plan_from_context(device_type=device.type)
        model, optimizer = plan.shard_init(init_model, make_optimizer, seeded())
        step = plan.jit_train_step(gpt2.make_train_step(cfg, optimizer), model, optimizer)
    else:
        model = init_model(seeded())
        optimizer = make_optimizer(model.parameters())
        if world > 1:
            optimizer.register_step_pre_hook(_allreduce_mean_grads)
        step = gpt2.make_train_step(cfg, optimizer)

    warmup, steps = config.get("warmup", 0), config["steps"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    from_data = config.get("tokens") is None
    if not from_data:
        toks = torch.tensor(config["tokens"], dtype=torch.long)  # a copy: the arg is read-only
        if toks.shape[0] % world:
            raise ValueError(f"global batch {toks.shape[0]} does not split over {world} ranks")
        share = toks.shape[0] // world
        # the plan's step takes the global batch and keeps each rank's window
        local = (toks if plan is not None else toks[rank * share:(rank + 1) * share]).to(device)
        global_batch = toks.shape[0]

        def next_batch():
            return local
    else:
        if plan is not None and world > 1:
            raise ValueError(
                "a sharded loop takes the global batch on every rank, and "
                "streaming_split gives each rank other rows: pass config['tokens'] "
                "or train on one rank")
        # under a plan each rank's batch is the global batch
        global_batch = config["batch_size"] * (1 if plan is not None else world)
        batches = train.get_dataset_shard("train").iter_device_batches(
            batch_size=config["batch_size"], dtypes={"data": torch.int64}, device=device,
            drop_last=True, prefetch_batches=2,
            sharding=plan.data_sharding() if plan is not None else None,
        )
        taken, waits = [], []

        def next_batch():
            t = time.perf_counter()
            try:
                batch = next(batches)["data"]
            except StopIteration:
                raise ValueError(
                    f"the train dataset ran out after {len(taken)} of {warmup + steps} "
                    f"batches of {config['batch_size']} rows"
                ) from None
            waits.append(time.perf_counter() - t)
            taken.append(batch)
            return batch

    def one_step():
        batch = next_batch()
        return step(model, batch[:, :-1], batch[:, 1:])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0
    losses = [one_step() for _ in range(warmup)]
    sync()
    t0 = time.perf_counter()
    losses += [one_step() for _ in range(steps)]
    sync()
    wall = time.perf_counter() - t0
    launches = [fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
                fa.flash_attention_dkv.launches]
    losses = torch.stack(losses)
    if world > 1 and plan is None:  # a plan's loss is the global batch's already
        dist.all_reduce(losses)
        losses /= world
    losses = losses.tolist()

    seq_len = (taken[0] if from_data else local).shape[1] - 1
    data = {}
    if from_data:
        batches.close()  # stops the producer thread; the rest stays unread
        weights = torch.arange(1, seq_len + 2, dtype=torch.int64, device=device)
        timed_waits = waits[warmup:]
        whole = [b.full_tensor() if plan is not None else b for b in taken]
        data = {
            "data_wait_ms": [w * 1e3 for w in waits],
            "data_wait_ms_mean": sum(timed_waits) / len(timed_waits) * 1e3,
            "data_wait_ms_max": max(timed_waits) * 1e3,
            "fingerprints": [(b * weights).sum(dim=1).tolist() for b in whole],
            "batch_kinds": sorted({(str(b.device), str(b.dtype)) for b in taken}),
        }
        if plan is not None:
            data["batch_placements"] = sorted({(type(b).__name__, str(b.device_mesh),
                                                str(tuple(b.placements))) for b in taken})
    tok_s = global_batch * seq_len * steps / wall
    metrics = {
        "losses": losses,
        "loss": losses[-1],  # a scalar for Tune's metric and schedulers
        "finite": all(math.isfinite(x) for x in losses),
        "step_ms": wall / steps * 1e3,
        "tokens_per_s": tok_s,
        "launches": launches,
        "steps_run": warmup + steps,
        "world_size": world,
        "device": str(device),
        "pid": os.getpid(),
        **data,
    }
    if config.get("peak_flops"):
        metrics["mfu"] = (tok_s / world) * gpt2.flops_per_token(cfg, seq_len) / (
            config["peak_flops"])
    if device.type == "cuda":
        metrics["device_name"] = torch.cuda.get_device_name(device)
        metrics["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if plan is not None:
        metrics.update(_plan_metrics(plan, model, optimizer))
        if config.get("resume_at"):
            del model, optimizer, step  # the card's memory goes to the next two
            batches_run = taken if from_data else [local] * (warmup + steps)
            rcfg, rinit = cfg, init_model
            if config.get("resume_layers"):
                rcfg = dataclasses.replace(cfg, n_layer=config["resume_layers"])

                def rinit(gen):
                    return gpt2.init_model(rcfg, gen, device=device)
            metrics.update(_resume(plan, batches_run, config["resume_at"], rcfg, rinit,
                                   make_optimizer, seeded, unbroken=rcfg is not cfg))
    ckpt = None
    if config.get("checkpoint") and rank == 0:
        ckpt = train.Checkpoint.from_pytree(model.state_dict())
    train.report(metrics, checkpoint=ckpt)


def _plan_metrics(plan, model, optimizer) -> Dict[str, Any]:
    """The mesh, and whether every parameter and AdamW moment is a DTensor
    on it with the placements the plan's rules give the parameter."""
    from torch.distributed.tensor import DTensor

    want = plan.param_placements(model)
    ok, moments_ok = True, True
    for name, p in model.named_parameters():
        on_mesh = isinstance(p, DTensor) and p.device_mesh == plan.mesh
        ok = ok and on_mesh and list(p.placements) == list(want[name])
        for key in ("exp_avg", "exp_avg_sq"):
            m = optimizer.state[p].get(key)
            moments_ok = moments_ok and isinstance(m, DTensor) and (
                m.device_mesh == plan.mesh and m.placements == p.placements)
    qkv = model.get_parameter("h_0.attn.qkv.weight")
    return {
        "mesh": dict(zip(plan.mesh.mesh_dim_names, plan.mesh.shape)),
        "mesh_device_type": plan.mesh.device_type,
        "params_on_rule_placements": ok,
        "moments_follow_params": moments_ok,
        "qkv_placements": str(tuple(qkv.placements)),
        "qkv_local_shape": list(qkv.to_local().shape),
    }


def _resume(plan, batches, k: int, cfg, init_model, make_optimizer, seeded,
            unbroken: bool = False) -> Dict[str, Any]:
    """Replay the first ``k`` batches on a second model from the same seed
    and save a sharded checkpoint; load it into a fresh plan's model from
    another seed and take the remaining batches.  With ``unbroken``, first
    an unbroken run of every batch from the seed (the losses the other two
    are held to when ``cfg`` is not the fit's)."""
    import os
    import tempfile
    import time

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import sharding

    def run(plan, model, optimizer, batches):
        """(losses, mean ms a step: the host clock to the losses' sync)"""
        step = plan.jit_train_step(gpt2.make_train_step(cfg, optimizer), model, optimizer)
        t = time.perf_counter()
        losses = [step(model, b[:, :-1], b[:, 1:]) for b in batches]
        losses = [x.item() for x in losses]
        return losses, (time.perf_counter() - t) / len(batches) * 1e3

    path = os.path.join(train.get_context().get_storage() or tempfile.gettempdir(),
                        f"gspmd_step{k}")
    out: Dict[str, Any] = {}
    if unbroken:
        model, optimizer = plan.shard_init(init_model, make_optimizer, seeded())
        out["unbroken_losses"], out["unbroken_step_ms"] = run(plan, model, optimizer, batches)
        del model, optimizer
    model, optimizer = plan.shard_init(init_model, make_optimizer, seeded())
    replay, replay_ms = run(plan, model, optimizer, batches[:k])
    t = time.perf_counter()
    plan.save_checkpoint(sharding.train_state(model, optimizer), path)
    save_s = time.perf_counter() - t
    del model, optimizer
    fresh = sharding.plan_from_context(device_type=plan.mesh.device_type)
    model, optimizer = fresh.shard_init(init_model, make_optimizer, seeded(1))
    t = time.perf_counter()
    like = sharding.train_state(model, optimizer)
    sharding.set_train_state(model, optimizer, fresh.load_checkpoint(path, like))
    load_s = time.perf_counter() - t
    resumed, resumed_ms = run(fresh, model, optimizer, batches[k:])
    return {**out, "replay_losses": replay, "resumed_losses": resumed, "resume_at": k,
            "resume_layers": cfg.n_layer,
            "replay_step_ms": replay_ms, "resumed_step_ms": resumed_ms,
            "checkpoint_save_s": save_s, "checkpoint_load_s": load_s,
            "checkpoint_bytes": sum(os.path.getsize(os.path.join(path, f))
                                    for f in os.listdir(path)),
            "checkpoint_path": path, "checkpoint_files": sorted(os.listdir(path))}
