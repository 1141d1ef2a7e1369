"""Rank groups for the port's multi-rank CPU tests, and the tests of the
harness itself (no JAX here: each rank imports this module, the port and
torch only).

``run_group(fn, world, tmp_path, *args)`` starts ``world`` ranks,
each of which joins a gloo process group through a ``FileStore`` under the
test's own ``tmp_path`` (never a fixed port) with a 60 s timeout, runs on
one torch thread, calls ``fn(rank, world, *args)`` (a function of this
module, so that a rank imports nothing else of the tests) and hands its
return value back.  The parent waits for the ranks against a deadline:
past it, or when a rank fails, every rank is killed and the test fails
with each rank's traceback.  Inputs and results are numpy arrays, so the
JAX side stays in the pytest process.

Ranks start from a forkserver (never a fork of the pytest process, whose
JAX threads a fork would copy mid-flight) that imports torch and the
port's modules once for the group, where spawned ranks would each import
them at once on a loaded box; the server is stopped with its group, so
nothing of a group outlives it (the suite's tail runs near the box's
memory).
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np

DEADLINE_S = 120.0
_PRELOAD = ["numpy", "torch", "torch.distributed.tensor", "test_torch_spmd"]


def _entry(rank, world, store_path, out_dir, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(fn, world: int, tmp_path, *args, deadline_s: float = DEADLINE_S) -> list:
    """[fn's result on rank 0, ..., rank world - 1]; raises AssertionError
    with each rank's traceback when a rank fails or the deadline passes."""
    import multiprocessing
    from multiprocessing import forkserver

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    multiprocessing.get_context("forkserver").set_forkserver_preload(_PRELOAD)
    root = os.path.join(str(tmp_path), f"group_{fn.__name__}_{time.monotonic_ns()}")
    os.makedirs(root)
    ctx = mp.start_processes(_entry, args=(world, os.path.join(root, "store"), root, fn, args),
                             nprocs=world, join=False, start_method="forkserver")
    deadline = time.monotonic() + deadline_s
    failure = None
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"rank group {fn.__name__} passed its {deadline_s:.0f} s deadline"
                break
    except ProcessException as e:
        failure = f"rank group {fn.__name__}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        forkserver._forkserver._stop()  # CPython's own teardown of the server
    if failure is not None:
        errs = []
        for r in range(world):
            path = os.path.join(root, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"--- rank {r} ---\n{f.read()}")
        raise AssertionError("\n".join([failure, *errs]))
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def within(fn, deadline_s: float = DEADLINE_S):
    """``fn()``'s result, or AssertionError once ``deadline_s`` passes (for
    a call that waits on ranks this module did not start, such as a
    trainer's workers: the thread is a daemon, and the cluster's teardown
    ends what it waits on)."""
    import concurrent.futures
    import threading

    fut: concurrent.futures.Future = concurrent.futures.Future()

    def run():
        try:
            fut.set_result(fn())
        except BaseException as e:  # handed to the waiting test
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    try:
        return fut.result(timeout=deadline_s)
    except concurrent.futures.TimeoutError:
        raise AssertionError(f"{fn} passed its {deadline_s:.0f} s deadline") from None


def _np(t):
    """A DTensor's global value (or a tensor) as a numpy copy."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy().copy()


def _gpt2_from(cfg, state):
    """init_fn(generator) of a GPT-2 holding ``state`` (numpy, the
    converter's output) on the CPU."""
    import torch

    from ray_tpu_torch.models import gpt2

    def init(_gen):
        model = gpt2.GPT2(cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        return model

    return init


# ----------------------------------------------------------------------
# tests/test_torch_parallel.py: the mesh and the models' sharded recipes
# ----------------------------------------------------------------------
def ranks_models(rank, world, gpt2_state, llama_state, batch, llama_batch):
    import dataclasses
    import time

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from ray_tpu_torch.models import common, gpt2, llama
    from ray_tpu_torch.parallel import create_mesh, local_mesh
    from ray_tpu_torch.parallel.mesh import mesh_axis_size
    from ray_tpu_torch.parallel.sharding import (batch_spec, constrain, gpt_sharding_rules,
                                                 infer_param_spec, shard_module, shard_tree)

    out = {}
    mesh = create_mesh({"tp": 2, "dp": 2}, device_type="cpu")
    out["dp_tp_names"] = tuple(mesh.mesh_dim_names)
    out["dp_tp_shape"] = tuple(mesh.shape)
    out["tp_size"] = mesh_axis_size(mesh, "tp")
    out["sp_size"] = mesh_axis_size(mesh, "sp")
    lm = local_mesh(device_type="cpu")
    out["local_mesh"] = dict(zip(lm.mesh_dim_names, lm.shape))

    # GPT-2 tiny forward under dp=2 x tp=2 (tests/test_models.py:49)
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    tokens = torch.from_numpy(batch[0])
    model = _gpt2_from(cfg, gpt2_state)(None)
    specs = infer_param_spec(model, gpt_sharding_rules(), mesh)
    shard_module(model, mesh, specs)
    out["specs"] = specs
    out["placements"] = {n: str(tuple(p.placements)) for n, p in model.named_parameters()}
    placed = shard_tree({k: torch.from_numpy(v) for k, v in gpt2_state.items()}, mesh, specs)
    out["shard_tree_equal"] = all(
        str(tuple(t.placements)) == out["placements"][n] and torch.equal(
            t.to_local(), model.get_parameter(n).to_local()) for n, t in placed.items())
    with torch.no_grad(), implicit_replication():
        out["logits"] = _np(model(constrain(tokens[:2, :32], mesh, batch_spec(mesh))))

    # five sharded GPT-2 steps over tp=2 x sp=2, ring attention over sp
    # (tests/test_models.py:27, which runs dp=2 x tp=2 x sp=2 on 8 devices)
    mesh = create_mesh({"tp": 2, "sp": 2}, device_type="cpu")
    scfg = dataclasses.replace(cfg, remat=False, mesh=mesh, sp_axis="sp")
    model, opt, _ = common.make_sharded_train_state(
        _gpt2_from(scfg, gpt2_state), mesh, lambda ps: gpt2.make_adamw(ps, lr=1e-2))
    step = gpt2.make_sharded_train_step(scfg, mesh, opt)
    tokens, targets = (torch.from_numpy(a) for a in batch)
    out["gpt2_losses"] = [step(model, tokens, targets).item() for _ in range(5)]

    # one Llama step over dp=2 x tp=2, three times (tests/test_models.py:118)
    mesh = create_mesh({"dp": 2, "tp": 2}, device_type="cpu")
    lcfg = llama.LlamaConfig.tiny(dtype=torch.float32, mesh=mesh)

    def init_llama(_gen):
        m = llama.Llama(lcfg)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in llama_state.items()})
        return m

    model, opt, lspecs = common.make_sharded_train_state(
        init_llama, mesh, lambda ps: torch.optim.SGD(ps, lr=1e-2))
    step = llama.make_sharded_train_step(lcfg, mesh, opt)
    tokens, targets = (torch.from_numpy(a) for a in llama_batch)
    out["llama_losses"] = [step(model, tokens, targets).item() for _ in range(3)]
    out["llama_specs"] = lspecs
    return out


# ----------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ----------------------------------------------------------------------
def ranks_ring(rank, world, qkv, qkv_dp):
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.ops import attention, ring_attention
    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.parallel.sharding import place

    def ring(arrays, mesh, placements):
        """The ring's output and the gradients of sum(out^2), whole."""
        q, k, v = (place(torch.from_numpy(a), mesh, placements).requires_grad_(True)
                   for a in arrays)
        o = ring_attention.ring_causal_attention(q, k, v, mesh=mesh, axis="sp")
        (o ** 2).sum().backward()
        return _np(o), [_np(t.grad) for t in (q, k, v)]

    out = {}
    # sp=4
    mesh4 = create_mesh({"sp": 4}, device_type="cpu")
    out["sp4_out"], out["sp4_grads"] = ring(qkv, mesh4, [Shard(1)])
    # composed with dp: dp=2 x sp=2 (the reference's dp=2 x sp=4 needs 8)
    mesh = create_mesh({"dp": 2, "sp": 2}, device_type="cpu")
    out["dp2_sp2_out"], out["dp2_sp2_grads"] = ring(qkv_dp, mesh, [Shard(0), Shard(1)])

    # the dispatch: an sp axis of size 1 takes the plain path, a larger
    # one the ring
    calls = []
    real = ring_attention.ring_causal_attention
    ring_attention.ring_causal_attention = lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
    try:
        q, k, v = (torch.from_numpy(a) for a in qkv)
        mesh1 = create_mesh({"dp": 4, "sp": 1}, device_type="cpu")
        plain = attention.causal_attention(q, k, v)
        got1 = attention.causal_attention(q, k, v, mesh=mesh1, sp_axis="sp")
        out["sp1_equal_plain"] = bool(torch.equal(got1, plain))
        out["sp1_ring_calls"] = len(calls)
        q, k, v = (place(t, mesh4, [Replicate()]) for t in (q, k, v))
        out["sp4_dispatch_out"] = _np(attention.causal_attention(q, k, v, mesh=mesh4,
                                                                 sp_axis="sp"))
        out["sp4_ring_calls"] = len(calls)
    finally:
        ring_attention.ring_causal_attention = real
    return out


# ----------------------------------------------------------------------
# tests/test_torch_sharded_train.py: the GSPMD plan and its checkpoints
# ----------------------------------------------------------------------
def _plan_run(plan, cfg, state, data, lr=1e-3):
    """shard_init from ``state``, then a step a batch: (model, opt, losses)."""
    import torch

    from ray_tpu_torch.models import gpt2

    model, opt = plan.shard_init(_gpt2_from(cfg, state), lambda ps: gpt2.make_adamw(ps, lr=lr))
    step = plan.jit_train_step(gpt2.make_train_step(cfg, opt), model, opt)
    losses = []
    for toks in data:
        toks = torch.from_numpy(toks)
        losses.append(step(model, toks[:, :-1], toks[:, 1:]).item())
    return model, opt, losses


def ranks_plan(rank, world, cfg, state, data, path, rows):
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.data.block import build_block
    from ray_tpu_torch.data.iterator import DataIterator
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding
    from ray_tpu_torch.train import sharding

    out = {}
    # batch x model=2 over 4 ranks: the params and moments it shards
    plan = sharding.build_plan(sharding.ShardingConfig(mesh_shape={"batch": -1, "model": 2}),
                               device_type="cpu")
    out["tp_mesh"] = dict(zip(plan.mesh.mesh_dim_names, plan.mesh.shape))
    model, opt, out["tp_losses"] = _plan_run(plan, cfg, state, data)
    qkv = model.get_parameter("h_0.attn.qkv.weight")
    out["qkv_placements"] = str(tuple(qkv.placements))
    out["qkv_shape"], out["qkv_local_shape"] = tuple(qkv.shape), tuple(qkv.to_local().shape)
    want = plan.param_placements(model)
    out["params_on_rules"] = all(
        isinstance(p, DTensor) and list(p.placements) == list(want[n])
        for n, p in model.named_parameters())
    moments = [(p, opt.state[p]) for p in model.parameters()]
    out["moments_follow"] = all(
        s[key].placements == p.placements for p, s in moments for key in ("exp_avg", "exp_avg_sq"))
    out["steps_plain"] = all(type(s["step"]) is torch.Tensor for _, s in moments)
    del model, opt

    # the same data on a data-parallel plan: batch=4, every leaf replicated
    dp = sharding.build_plan(sharding.ShardingConfig(
        mesh=("batch",), mesh_shape={"batch": 4}, partition_rules=[(r".*", ())]),
        device_type="cpu")
    out["dp_losses"] = _plan_run(dp, cfg, state, data)[2]

    # the 2-rank checkpoint onto batch x model=4
    plan_b = sharding.build_plan(sharding.ShardingConfig(mesh_shape={"batch": -1, "model": 4}),
                                 device_type="cpu")
    model, opt = plan_b.shard_init(
        _gpt2_from(cfg, {k: np.zeros_like(v) for k, v in state.items()}),
        lambda ps: gpt2.make_adamw(ps, lr=1e-3))
    restored = plan_b.load_checkpoint(path, sharding.train_state(model, opt))
    out["restored"] = {n: _np(p) for n, p in restored["params"].items()}
    qkv = restored["params"]["h_0.attn.qkv.weight"]
    out["restored_qkv_model"] = dict(zip(qkv.device_mesh.mesh_dim_names, qkv.device_mesh.shape))
    out["restored_qkv_placements"] = str(tuple(qkv.placements))
    sharding.set_train_state(model, opt, restored)
    step = plan_b.jit_train_step(gpt2.make_train_step(cfg, opt), model, opt)
    toks = torch.from_numpy(data[0])
    out["resumed_loss"] = step(model, toks[:, :-1], toks[:, 1:]).item()

    # iter_device_batches(sharding=...): the global batch, each rank its
    # window over dp (and sp's window of the sequence)
    mesh = create_mesh({"dp": 2, "sp": 2}, device_type="cpu")
    it = DataIterator(lambda: iter([build_block({"data": rows})]))
    got = []
    for b in it.iter_device_batches(batch_size=4, device="cpu", prefetch_batches=1,
                                    dtypes={"data": torch.int64},
                                    sharding=NamedSharding(mesh, ("dp", "sp"))):
        t = b["data"]
        got.append((type(t).__name__, str(tuple(t.placements)), str(t.dtype), _np(t.to_local()),
                    _np(t)))
    out["batches"] = got
    out["coordinate"] = tuple(mesh.get_coordinate())
    return out


# ----------------------------------------------------------------------
# the harness's own deadline and error report
# ----------------------------------------------------------------------
def _rank_sleeps(rank, world):
    time.sleep(60)


def _rank_fails(rank, world):
    import torch.distributed as dist

    dist.barrier()  # the group formed: the failure is the rank's own
    if rank == 1:
        raise ValueError("rank 1 was told to fail")
    return rank


def test_a_group_past_its_deadline_is_killed_and_fails(tmp_path):
    import pytest

    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="passed its 2 s deadline"):
        run_group(_rank_sleeps, 2, tmp_path, deadline_s=2)
    assert time.monotonic() - t0 < 30  # the ranks were killed, not waited for


def test_a_failing_rank_fails_the_group_with_its_traceback(tmp_path):
    import pytest

    with pytest.raises(AssertionError) as ei:
        run_group(_rank_fails, 2, tmp_path)
    assert "--- rank 1 ---" in str(ei.value) and "rank 1 was told to fail" in str(ei.value)
