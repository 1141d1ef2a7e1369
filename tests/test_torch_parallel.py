"""The port's mesh (``ray_tpu_torch/parallel/mesh.py``) and the model
families' sharded recipes (``models/common.py``, ``gpt2.py``,
``llama.py``) held to the JAX package's (tests/test_models.py:27,49,118).

The pure mesh functions run here beside the reference's.  Everything on
a ``DeviceMesh`` runs in four spawned gloo ranks
(``test_torch_spmd.ranks_models``, no JAX there) from the reference's weights
carried across by ``models/convert.py``; the JAX side runs here on the
conftest's virtual CPU devices.  A rank group holds at most 4 ranks, so
the reference's 8-device dp=2 x tp=2 x sp=2 GPT-2 step becomes tp=2 x
sp=2 on both sides.  The reference's Llama step computes in bfloat16;
here both sides compute in float32, so losses can be held at 2e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import test_torch_spmd as torch_spmd  # noqa: E402
from ray_tpu import parallel as jparallel  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu_torch.models import gpt2, llama  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    gpt2_state_dict_from_jax,
    llama_state_dict_from_jax,
)
from ray_tpu_torch.parallel import mesh  # noqa: E402

LOSS = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("axes,n", [
    ({}, 8), ({"dp": -1, "tp": 2}, 8), ({"tp": 4}, 8), ({"sp": 4}, 8), ({"dp": 2, "tp": 2}, 4),
    ({"dp": -1, "tp": -1}, 8), ({"dp": -1, "tp": 3}, 8), ({"dp": 4, "tp": 4}, 8),
])
def test_mesh_config_resolve_matches_reference(axes, n):
    try:
        want = jmesh.MeshConfig(dict(axes)).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            mesh.MeshConfig(dict(axes)).resolve(n)
        return
    assert mesh.MeshConfig(dict(axes)).resolve(n) == want


def test_auto_mesh_shape_and_axis_order_match_reference():
    assert mesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for n in range(1, 17):
        assert mesh.auto_mesh_shape(n) == jmesh.auto_mesh_shape(n)
        assert mesh.auto_mesh_shape(n, tp=1) == jmesh.auto_mesh_shape(n, tp=1)
    assert mesh.mesh_axis_size({"dp": 2, "tp": 4}, "tp") == 4
    assert mesh.mesh_axis_size({"dp": 2}, "sp") == 1


def _batch(vocab, B, T, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, T + 1)).astype(np.int64)
    return toks[:, :-1], toks[:, 1:]


def _numpy_state(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _reference():
    """The JAX package's side: the weights the ranks start from and what
    each check is held to."""
    devs = jax.devices()[:4]
    out = {}
    # five dp x tp x sp steps, here tp=2 x sp=2 (tests/test_models.py:27)
    m = jparallel.create_mesh({"tp": 2, "sp": 2}, devs)
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, remat=False, mesh=m, sp_axis="sp")
    opt = jgpt2.make_adamw(lr=1e-2)
    params, opt_state, _ = jgpt2.make_sharded_train_state(cfg, m, opt)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    out["gpt2_state"] = _numpy_state(gpt2_state_dict_from_jax(
        tree, gpt2.GPT2Config.tiny(dtype=torch.float32)))
    out["batch"] = _batch(cfg.vocab_size, 4, 64, seed=0)
    step = jgpt2.make_sharded_train_step(cfg, m, opt)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, *(jnp.asarray(a) for a in out["batch"]))
        losses.append(float(loss))
    out["gpt2_losses"] = losses
    # the unsharded forward (tests/test_models.py:49)
    plain = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    out["logits"] = np.asarray(jax.jit(lambda p, t: jgpt2.GPT2(plain).apply({"params": p}, t))(
        tree, jnp.asarray(out["batch"][0][:2, :32])))
    # the Llama step over dp=2 x tp=2 (tests/test_models.py:118), in f32
    m = jparallel.create_mesh({"dp": 2, "tp": 2}, devs)
    lcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, mesh=m)
    opt = optax.sgd(1e-2)
    params, opt_state, _ = jllama.make_sharded_train_state(lcfg, m, opt)
    ltree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    out["llama_state"] = _numpy_state(llama_state_dict_from_jax(
        ltree, llama.LlamaConfig.tiny(dtype=torch.float32)))
    out["llama_batch"] = _batch(lcfg.vocab_size, 4, 64, seed=1)
    step = jllama.make_sharded_train_step(lcfg, m, opt)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state,
                                       *(jnp.asarray(a) for a in out["llama_batch"]))
        losses.append(float(loss))
    out["llama_losses"] = losses
    return out


def test_mesh_and_sharded_models_match_reference(tmp_path):
    """Four gloo ranks, one group for every check that needs a mesh:

    - ``create_mesh`` names its axes in the reference's order, sizes
      them, and ``local_mesh`` takes ``auto_mesh_shape``;
    - the Megatron rules hit the tp axes (tests/test_models.py:69) and
      ``shard_tree`` places a state dict as the module's parameters;
    - GPT-2 tiny's forward under dp=2 x tp=2 computes the reference's
      unsharded function (tests/test_models.py:49);
    - five GPT-2 steps with params tp-sharded and the sequence sp-sharded
      through ring attention: the reference's losses, falling;
    - three Llama steps over dp=2 x tp=2: the reference's losses."""
    ref = _reference()
    ranks = torch_spmd.run_group(torch_spmd.ranks_models, 4, tmp_path, ref["gpt2_state"],
                                 ref["llama_state"], ref["batch"], ref["llama_batch"])
    want = jparallel.create_mesh({"tp": 2, "dp": 2}, jax.devices()[:4])
    for r in ranks:
        assert r["dp_tp_names"] == tuple(want.axis_names) == ("dp", "tp")
        assert r["dp_tp_shape"] == (2, 2)
        assert (r["tp_size"], r["sp_size"]) == (2, 1)
        assert r["local_mesh"] == jmesh.auto_mesh_shape(4)
        assert r["specs"]["h_0.attn.qkv.weight"] == ("tp", None)
        assert r["specs"]["h_0.mlp.mlp_down.weight"] == (None, "tp")
        assert r["placements"]["h_0.attn.qkv.weight"] == "(Replicate(), Shard(dim=0))"
        assert r["placements"]["h_0.mlp.mlp_down.weight"] == "(Replicate(), Shard(dim=1))"
        assert r["placements"]["h_0.ln_1.weight"] == "(Replicate(), Replicate())"
        assert r["llama_specs"]["h_0.attn.q_proj.weight"] == ("tp", None)
        assert r["shard_tree_equal"]
        np.testing.assert_allclose(r["logits"], ref["logits"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["gpt2_losses"], ref["gpt2_losses"], **LOSS)
        np.testing.assert_allclose(r["llama_losses"], ref["llama_losses"], **LOSS)
    assert ref["gpt2_losses"][-1] < ref["gpt2_losses"][0]
    assert ref["llama_losses"][-1] < ref["llama_losses"][0]
