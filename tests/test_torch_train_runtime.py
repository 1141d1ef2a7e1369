"""GPT-2 trained inside the port's ``TorchTrainer.fit()`` on the CPU,
held to the JAX package's train step and to the port's own
single-process step.

Both packages hold the same float32 tiny GPT-2: the reference's params,
every leaf perturbed from a numpy seed (as in tests/test_torch_train.py),
carried across by models/convert.py.  The loop the workers run is
``ray_tpu_torch.train.torch.gpt2_loop.train_loop_per_worker``, a module
that imports no JAX: a worker imports a pickled function's module, so a
loop defined here would load JAX in every worker.

Tolerances are tests/test_torch_train.py's: losses at 2e-4; parameters
after AdamW at 1e-2 lr on the entries whose gradient is at least 1e-2 of
its tensor's largest, and within the 2 lr that bounds one AdamW update
elsewhere (a gradient within float noise of zero, such as the key bias's,
may move one way in one run and the other in the other).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402
from ray_tpu_torch.train import RunConfig, ScalingConfig  # noqa: E402
from ray_tpu_torch.train.torch import TorchTrainer  # noqa: E402
from ray_tpu_torch.train.torch.gpt2_loop import train_loop_per_worker, worker_device  # noqa: E402

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
B, T = 4, 32
LR = 1e-3


@pytest.fixture(scope="module")
def ray_cluster():
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def tree():
    """The reference's tiny GPT-2 params as numpy, perturbed from a seed."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    params = jgpt2.init_params(jcfg, rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def _tokens(seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1)).astype(np.int64)


def _cfg():
    return tgpt2.GPT2Config.tiny(dtype=torch.float32, remat=False)


def _fit(tmp_path, name, tree, toks, steps, num_workers):
    cfg = _cfg()
    trainer = TorchTrainer(
        train_loop_per_worker,
        train_loop_config={
            "cfg": cfg, "state_dict": gpt2_state_dict_from_jax(tree, cfg), "tokens": toks,
            "lr": LR, "steps": steps, "device": "cpu", "checkpoint": True,
        },
        scaling_config=ScalingConfig(num_workers=num_workers),
        run_config=RunConfig(name=name, storage_path=str(tmp_path)),
    )
    return trainer.fit()


def test_two_steps_in_the_trainer_match_the_jax_step(ray_cluster, tmp_path, tree):
    """Two AdamW steps inside TorchTrainer(num_workers=1): each step's
    loss equals the JAX package's train step's on the same weights and
    batch."""
    toks = _tokens(3)
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, remat=False)
    opt = jgpt2.make_adamw(LR)
    step = jax.jit(jgpt2.make_train_step(jcfg, opt))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    tok, tgt = jnp.asarray(toks[:, :-1].astype(np.int32)), jnp.asarray(toks[:, 1:].astype(np.int32))
    jlosses = []
    for _ in range(2):
        params, state, loss = step(params, state, tok, tgt)
        jlosses.append(float(loss))

    result = _fit(tmp_path, "gpt2_jax_parity", tree, toks, steps=2, num_workers=1)
    m = result.metrics
    assert m["world_size"] == 1 and m["device"] == "cpu" and m["steps_run"] == 2
    assert m["launches"] == [0, 0, 0]  # the CPU runs the kernels' plain versions
    np.testing.assert_allclose(m["losses"], jlosses, **LOSS_TOL)


def test_gpu_ranks_take_the_card_of_their_local_rank(monkeypatch):
    """Every worker sees all of its node's cards: two GPU ranks on a node
    take cuda:0 and cuda:1 and make it their current card; a named index
    and the CPU are kept."""
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: picked.append(torch.device(d)))
    got = [worker_device("cuda", local_rank) for local_rank in (0, 1)]
    assert got == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert picked == got
    assert worker_device("cuda:3", 1) == torch.device("cuda", 3) and picked[-1].index == 3
    assert worker_device("cpu", 1) == torch.device("cpu") and len(picked) == 3


def test_two_gloo_ranks_match_the_single_process_step(ray_cluster, tmp_path, tree):
    """Two ranks on a gloo group, each with half of the batch and the
    gradients all-reduced to their mean, take the step the whole batch
    gives in one process: the same loss and the same parameters after one
    AdamW step."""
    toks = _tokens(4)
    cfg = _cfg()
    model = tgpt2.GPT2(cfg)
    model.load_state_dict(gpt2_state_dict_from_jax(tree, cfg))
    tokens, targets = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    model.zero_grad(set_to_none=True)
    tgpt2.loss_fn(model, tokens, targets).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    loss = tgpt2.make_train_step(cfg, tgpt2.make_adamw(model.parameters(), LR))(
        model, tokens, targets).item()

    result = _fit(tmp_path, "gpt2_gloo", tree, toks, steps=1, num_workers=2)
    m = result.metrics
    assert m["world_size"] == 2
    np.testing.assert_allclose(m["losses"], [loss], **LOSS_TOL)
    got = result.checkpoint.to_pytree()
    assert set(got) == set(grads)
    for name, p in model.named_parameters():
        diff = (got[name] - p.detach()).abs()
        sure = grads[name].abs() >= 1e-2 * grads[name].abs().max()
        assert diff.max().item() <= 2 * LR, name
        assert diff[sure].max().item() <= 1e-2 * LR, name
