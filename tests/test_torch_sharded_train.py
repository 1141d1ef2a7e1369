"""The port's GSPMD plan (``ray_tpu_torch/train/sharding/gspmd.py`` and
``checkpoint.py``) held to the JAX package's: the counterparts of
tests/test_sharded_train.py, GPT-2 over a batch x model mesh with the
reference's losses and with loss parity against the data-parallel
layout, per-shard checkpoints that re-shard from a 2-rank mesh onto a
4-rank one and refuse a corrupt shard, and ``TorchTrainer`` carrying a
``sharding_config`` to two gloo workers of the port's runtime.

The reference runs on its 8 virtual CPU devices (here, in the pytest
process); the port runs in spawned gloo ranks (``test_torch_spmd``, no JAX
there) of at most 4, so its batch x model=2 mesh is 2 x 2 where the
reference's is 4 x 2 (the loss is the same function of the same global
batch).  Weights cross over through ``models/convert.py``.  f32: losses
at 2e-4 against the reference and 1e-4 between the port's own layouts,
as the reference holds its two.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu.train.sharding as jsharding  # noqa: E402
import ray_tpu_torch  # noqa: E402
import test_torch_spmd as torch_spmd  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.models import gpt2  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402
from ray_tpu_torch.train import RunConfig, ScalingConfig  # noqa: E402
from ray_tpu_torch.train import sharding  # noqa: E402
from ray_tpu_torch.train.checkpoint_plane import CheckpointCorruptionError  # noqa: E402
from ray_tpu_torch.train.torch import TorchTrainer  # noqa: E402
from ray_tpu_torch.train.torch.gpt2_loop import train_loop_per_worker  # noqa: E402

LOSS = dict(rtol=2e-4, atol=2e-4)


def _jcfg():
    # f32 end-to-end so parity checks are exact-ish, not bf16-fuzzy.
    return jgpt2.GPT2Config(vocab_size=256, n_layer=2, n_head=2, d_model=64, max_seq_len=64,
                            dtype=jnp.float32, remat=False)


def _cfg():
    return gpt2.GPT2Config(vocab_size=256, n_layer=2, n_head=2, d_model=64, max_seq_len=64,
                           dtype=torch.float32, remat=False)


def _jinit(rng):
    return jgpt2.GPT2(_jcfg()).init(rng, jnp.zeros((2, 16), dtype=jnp.int32))["params"]


DATA = np.random.default_rng(0).integers(0, 256, (3, 8, 17)).astype(np.int64)


def _jax_losses(*datas):
    """The reference's batch x model=2 plan (on its 8 devices) from seed 0,
    one run of steps per sequence of batches: [losses, ...]."""
    plan = jsharding.build_plan(jsharding.ShardingConfig(mesh_shape={"batch": -1, "model": 2}))
    opt = jgpt2.make_adamw(1e-3)
    step = None
    out = []
    for data in datas:
        params, opt_state = plan.shard_init(_jinit, opt)
        if step is None:
            step = plan.jit_train_step(jgpt2.make_train_step(_jcfg(), opt), params, opt_state)
        losses = []
        for toks in data:
            toks = toks.astype(np.int32)
            params, opt_state, loss = step(params, opt_state, toks[:, :-1], toks[:, 1:])
            losses.append(float(loss))
        out.append(losses)
    return out


def _tree():
    """The reference's weights (seed 0) as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(_jinit(jax.random.PRNGKey(0))))


@pytest.fixture(scope="module")
def ray_cluster():
    with pytest.MonkeyPatch.context() as mp:
        # no shm arena prefault per raylet, and no memory monitor, which
        # watches the whole machine and would kill this test's workers for
        # the other tests' memory
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_trainer_plan_and_checkpoint_reshard(ray_cluster, tmp_path):
    """``TorchTrainer(sharding_config=...)`` on two gloo workers of the
    port's runtime, then four gloo ranks on the checkpoint it saved:

    - the trainer carries the config to every rank: the 2-worker group
      forms one batch x model=2 mesh (1 x 2) on which gpt2_loop trains the
      reference's losses, saves a sharded checkpoint at step 1 and
      resumes from it on a fresh plan to the same loss;
    - on four ranks the mesh shards params and state: batch x model=2 is
      2 x 2, the qkv weight's rows split over model, every parameter on
      the rule placements, the moments on their parameter's, the step
      counts plain;
    - loss parity: the tp plan's three losses equal the data-parallel
      plan's (batch=4, every leaf replicated) and the reference's;
    - the trainer's checkpoint, written by the 2-rank mesh, re-shards
      onto a 4-rank model=4 mesh: values identical to the host's
      reassembly of it, the new layout, and training goes on from it;
    - ``iter_device_batches(sharding=...)`` over dp=2 x sp=2: every rank
      receives each batch as a DTensor, its window of the rows over dp
      and of the sequence over sp, in the dataset's order."""
    want_tp, want_trainer = _jax_losses(DATA, [DATA[0], DATA[0]])
    state = gpt2_state_dict_from_jax(_tree(), _cfg())
    cfg = sharding.ShardingConfig(mesh_shape={"batch": -1, "model": 2})
    trainer = TorchTrainer(
        train_loop_per_worker,
        train_loop_config={"cfg": _cfg(), "state_dict": state, "tokens": DATA[0], "lr": 1e-3,
                           "steps": 2, "device": "cpu", "resume_at": 1},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="gspmd_cfg", storage_path=str(tmp_path)),
        sharding_config=cfg,
    )
    assert trainer._constructor_state()["sharding_config"] is cfg
    m = torch_spmd.within(trainer.fit).metrics
    assert m["world_size"] == 2 and m["mesh"] == {"batch": 1, "model": 2}
    assert m["params_on_rule_placements"] and m["moments_follow_params"]
    np.testing.assert_allclose(m["losses"], want_trainer, **LOSS)
    np.testing.assert_allclose(m["replay_losses"], m["losses"][:1], rtol=1e-6)
    np.testing.assert_allclose(m["resumed_losses"], m["losses"][1:], rtol=1e-6)
    path = m["checkpoint_path"]
    assert {"meta.json", "MANIFEST.json", "shards_p0.npz", "shards_p1.npz",
            "entries_p1.json"} <= set(os.listdir(path))
    # the like tree in train_state's order: the model's parameters
    with torch.device("meta"):
        names = [n for n, _ in gpt2.GPT2(_cfg()).named_parameters()]
    zeros = {k: torch.zeros(state[k].shape) for k in names}
    host = sharding.load_sharded(path, {"params": zeros, "opt": {
        k: {"step": torch.zeros(()), "exp_avg": z, "exp_avg_sq": z} for k, z in zeros.items()}})

    rows = np.arange(8 * 9, dtype=np.int64).reshape(8, 9)
    loaded = torch_spmd.run_group(torch_spmd.ranks_plan, 4, tmp_path, _cfg(),
                                  {k: v.numpy() for k, v in state.items()}, DATA, path, rows)
    for r in loaded:
        assert r["tp_mesh"] == {"batch": 2, "model": 2}
        assert r["qkv_placements"] == "(Replicate(), Shard(dim=0))"
        assert r["qkv_local_shape"] == (r["qkv_shape"][0] // 2, r["qkv_shape"][1])
        assert r["params_on_rules"] and r["moments_follow"] and r["steps_plain"]
        np.testing.assert_allclose(r["tp_losses"], r["dp_losses"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["tp_losses"], want_tp, **LOSS)
        assert r["restored"].keys() == host["params"].keys()
        for name, value in host["params"].items():
            np.testing.assert_array_equal(r["restored"][name], value.numpy())
        assert r["restored_qkv_model"] == {"batch": 1, "model": 4}
        assert r["restored_qkv_placements"] == "(Replicate(), Shard(dim=0))"
        assert np.isfinite(r["resumed_loss"])
        dp, sp = r["coordinate"]
        assert len(r["batches"]) == 2
        for i, (kind, placements, dtype, local, whole) in enumerate(r["batches"]):
            assert (kind, placements, dtype) == ("DTensor", "(Shard(dim=0), Shard(dim=1))",
                                                 "torch.int64")
            want = rows[4 * i:4 * (i + 1)]
            np.testing.assert_array_equal(whole, want)
            np.testing.assert_array_equal(local, want[2 * dp:2 * dp + 2, 5 * sp:5 * sp + 5])


def test_sharded_checkpoint_refuses_a_corrupt_shard(tmp_path):
    """A bit flipped in a shard file: load_sharded raises before it adopts
    a byte (a committed save carries the manifest's CRC32s)."""
    tree = {"w": torch.randn(64, 64, generator=torch.Generator().manual_seed(0))}
    sharding.save_sharded(tree, str(tmp_path))
    shard = tmp_path / "shards_p0.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    shard.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptionError):
        sharding.load_sharded(str(tmp_path), {"w": torch.zeros(64, 64)})


def test_checkpoint_leaf_mismatch_is_typed(tmp_path):
    tree = {"a": torch.zeros(4, 4)}
    sharding.save_sharded(tree, str(tmp_path))
    with pytest.raises(ValueError, match="leaves"):
        sharding.load_sharded(str(tmp_path), {"a": tree["a"], "b": tree["a"]})
    back = sharding.load_sharded(str(tmp_path), {"a": torch.ones(4, 4, dtype=torch.bfloat16)})
    assert torch.equal(back["a"], tree["a"])


def test_bfloat16_leaves_round_trip(tmp_path):
    """bf16 has no numpy dtype: its bit patterns go through the npz."""
    t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    sharding.save_sharded({"w": t}, str(tmp_path))
    back = sharding.load_sharded(str(tmp_path), {"w": torch.zeros(5, 3, dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
