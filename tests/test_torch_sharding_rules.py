"""The port's partition rules (``ray_tpu_torch/train/sharding/rules.py``
and ``ray_tpu_torch/parallel/sharding.py``) held to the JAX package's:
the counterparts of tests/test_sharding_rules.py, and the GPT-2 and
Llama rule tables leaf by leaf against the reference's specs for the same
models, through ``models/convert.py``'s name map (tests/test_models.py:69).

The reference matches flax paths on flax layouts; the port's tables name
the torch parameters, whose Dense weights the converter transposes, so a
port spec must be the reference's, transposed where the converter
transposes.  No process group is needed: specs take the mesh's axis sizes
as a mapping.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import ray_tpu.train.sharding as jsharding  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.parallel import create_mesh as jcreate_mesh  # noqa: E402
from ray_tpu.parallel.sharding import gpt_sharding_rules as j_gpt_rules  # noqa: E402
from ray_tpu.parallel.sharding import infer_param_spec as j_infer  # noqa: E402
from ray_tpu_torch.models import gpt2, llama  # noqa: E402
from ray_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from ray_tpu_torch.parallel.sharding import (  # noqa: E402
    gpt_sharding_rules,
    infer_param_spec,
    spec_to_placements,
)
from ray_tpu_torch.train.sharding import (  # noqa: E402
    ShardingConfig,
    UnmatchedParamError,
    gpt2_partition_rules,
    match_partition_rules,
)


def _leaf(*shape):
    return torch.zeros(shape)


def _jleaf(*shape):
    return jnp.zeros(shape, dtype=jnp.float32)


def test_first_match_wins_precedence():
    """Rules are ORDERED: an earlier, broader rule shadows a later, more
    specific one — the reference's outcome, rule order for rule order."""
    for rules in ([(r"weight", ("model", None)), (r"qkv/weight", (None, "model"))],
                  [(r"qkv/weight", (None, "model")), (r"weight", ("model", None))]):
        spec = match_partition_rules(rules, {"attn": {"qkv": {"weight": _leaf(8, 24)}}})
        jrules = [(pat.replace("weight", "kernel"), s) for pat, s in rules]
        want = jsharding.match_partition_rules(jrules, {"attn": {"qkv": {"kernel": _jleaf(8, 24)}}})
        assert spec["attn"]["qkv"]["weight"] == tuple(want["attn"]["qkv"]["kernel"])
    assert spec["attn"]["qkv"]["weight"] == (None, "model")


def test_unmatched_leaf_raises_typed_error_naming_all_gaps():
    params = {"a": {"weight": _leaf(4, 4)}, "b": {"mystery": _leaf(4, 4)},
              "c": {"enigma": _leaf(4)}}
    with pytest.raises(UnmatchedParamError) as ei:
        match_partition_rules([(r"weight", (None, "model"))], params)
    assert sorted(ei.value.paths) == ["b/mystery", "c/enigma"]
    assert "b/mystery" in str(ei.value)
    # a dotted state_dict name reads as the same path
    with pytest.raises(UnmatchedParamError) as ei:
        match_partition_rules([(r"weight", (None, "model"))], {"b.mystery": _leaf(4, 4)})
    assert ei.value.paths == ["b/mystery"]


def test_scalars_and_size_one_replicate_without_rules():
    spec = match_partition_rules([], {"count": _leaf(), "one": _leaf(1)})
    want = jsharding.match_partition_rules([], {"count": _jleaf(), "one": _jleaf(1)})
    assert spec == {"count": (), "one": ()}
    assert {k: tuple(v) for k, v in want.items()} == spec


def test_non_strict_replicates_unmatched():
    assert match_partition_rules([], {"mystery": _leaf(4, 4)}, strict=False) == {"mystery": ()}


def test_spec_clipped_to_rank_and_mesh_divisibility():
    rules = [(r"v/weight", (None, "model")), (r"odd/weight", ("model", "model")),
             (r"ghost/weight", ("expert", "model"))]
    params = {"v": {"weight": _leaf(6)}, "odd": {"weight": _leaf(7, 8)},
              "ghost": {"weight": _leaf(8, 8)}}
    spec = match_partition_rules(rules, params, {"batch": 2, "model": 2})
    assert spec == {"v": {"weight": (None,)}, "odd": {"weight": (None, "model")},
                    "ghost": {"weight": (None, "model")}}
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("batch", "model"))
    jparams = {k: {"kernel": _jleaf(*v["weight"].shape)} for k, v in params.items()}
    want = jsharding.match_partition_rules(
        [(p.replace("weight", "kernel"), s) for p, s in rules], jparams, jmesh)
    assert {k: tuple(v["kernel"]) for k, v in want.items()} == {
        k: v["weight"] for k, v in spec.items()}


def _name_map(tree):
    """{flax path: (port name, transposed)} from the converter itself: each
    leaf carries its own index pattern, so a transposed square kernel is
    told from one that is not."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    probe, rng = {}, np.random.default_rng(0)
    nested: dict = {}
    for path, shape in flat.items():
        probe[path] = rng.standard_normal(shape).astype(np.float32)
        node = nested
        *mods, name = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = probe[path]
    sd = state_dict_from_jax(nested)
    out = {}
    for (path, a), (name, t) in zip(probe.items(), sd.items()):
        t = t.numpy()
        transposed = a.ndim == 2 and not np.array_equal(t, a)
        assert np.array_equal(t, a.T if transposed else a.reshape(t.shape)), path
        out[path] = (name, transposed)
    return out


def _port_specs_equal_reference(jspecs, tree, port_specs):
    """Each port parameter's spec is its flax counterpart's, reversed where
    the converter transposes."""
    names = _name_map(tree)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
             for path, s in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    assert len(jflat) == len(port_specs) == len(names)
    for path, jspec in jflat.items():
        name, transposed = names[path]
        want = tuple(reversed(jspec)) if transposed else jspec
        assert port_specs[name] == want, (path, name, port_specs[name], jspec)


def test_gpt2_rule_set_covers_and_shards_gpt2_tiny():
    """The port's GPT-2 rule set covers EVERY port leaf and gives each the
    reference's spec for its flax counterpart (transposed for the Dense
    weights): the Megatron pairing on [out, in]."""
    jcfg = jgpt2.GPT2Config.tiny(remat=False)
    tree = jax.eval_shape(lambda: jgpt2.init_params(jcfg))
    jspec = jsharding.match_partition_rules(jsharding.gpt2_partition_rules(), tree)
    with torch.device("meta"):
        model = gpt2.GPT2(gpt2.GPT2Config.tiny(remat=False))
    spec = match_partition_rules(gpt2_partition_rules(), model)
    _port_specs_equal_reference(jspec, tree, spec)
    assert spec["h_0.attn.qkv.weight"] == ("model", None)
    assert spec["h_0.attn.attn_out.weight"] == (None, "model")
    assert spec["wte.weight"] == ("model", None)
    assert spec["lm_head.weight"] == ("model", None)
    assert spec["h_0.ln_1.weight"] == (None,) and spec["h_0.attn.qkv.bias"] == (None,)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 4}, {"fsdp": 2, "tp": 2}])
def test_megatron_rules_match_reference_leaf_by_leaf(family, axes):
    """``infer_param_spec`` with ``gpt_sharding_rules`` over a mesh's axis
    sizes: every port leaf's spec equals the reference's on a real JAX mesh
    of those sizes, through the converter's name map."""
    if family == "gpt2":
        tree = jax.eval_shape(lambda: jgpt2.init_params(jgpt2.GPT2Config.tiny(dtype=jnp.float32)))
        build = lambda: gpt2.GPT2(gpt2.GPT2Config.tiny(dtype=torch.float32))  # noqa: E731
    else:
        tree = jax.eval_shape(
            lambda: jllama.init_params(jllama.LlamaConfig.tiny(dtype=jnp.float32)))
        build = lambda: llama.Llama(llama.LlamaConfig.tiny(dtype=torch.float32))  # noqa: E731
    n = int(np.prod(list(axes.values())))
    jspec = j_infer(tree, j_gpt_rules(), jcreate_mesh(axes, jax.devices()[:n]))
    with torch.device("meta"):
        model = build()
    spec = infer_param_spec(model, gpt_sharding_rules(), axes)
    _port_specs_equal_reference(jspec, tree, spec)
    qkv = [s for name, s in spec.items() if name.endswith(("qkv.weight", "q_proj.weight"))]
    assert qkv and all(s[0] == "tp" for s in qkv)


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh2:
        mesh_dim_names = ("dp", "fsdp", "tp")

    assert spec_to_placements(("tp", None), Mesh2) == [Replicate(), Replicate(), Shard(0)]
    assert spec_to_placements((("dp", "fsdp"), "tp"), Mesh2) == [Shard(0), Shard(0), Shard(1)]
    assert spec_to_placements(("ep", None), Mesh2) == [Replicate()] * 3
    with pytest.raises(ValueError, match="twice"):
        spec_to_placements(("tp", "tp"), Mesh2)


def test_sharding_config_validation_and_defaults():
    with pytest.raises(ValueError, match="batch_axis"):
        ShardingConfig(mesh=("data", "model"), batch_axis="batch")
    with pytest.raises(ValueError, match="mesh_shape"):
        ShardingConfig(mesh_shape={"expert": 2})
    for shape in (None, {"model": 2}, {"batch": 4}, {"model": -1}, {"batch": -1, "model": 1}):
        for n in (1, 4, 6, 8):
            assert (ShardingConfig(mesh_shape=shape).resolve_shape(n)
                    == jsharding.ShardingConfig(mesh_shape=shape).resolve_shape(n))
    assert ShardingConfig(mesh_shape={"model": 2}).resolve_shape(8) == {"model": 2, "batch": -1}
    assert ShardingConfig(mesh_shape={"batch": 4}).resolve_shape(8) == {"batch": 4, "model": 1}
    assert ShardingConfig(mesh_shape={"model": -1}).resolve_shape(8) == {"model": -1, "batch": 1}


def test_pipeline_plane_names_raise_until_ported():
    import ray_tpu_torch.train.sharding as sharding

    for name in ("PipelineConfig", "PipelinePlane", "gpt2_pipeline_programs"):
        with pytest.raises(NotImplementedError, match=r"4\(f\)"):
            getattr(sharding, name)
