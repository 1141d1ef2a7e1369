"""The port's SPMD pipeline (ray_tpu_torch/parallel/pipeline.py and
models/gpt2_pp.py) and the MoE's expert-parallel rules, held to the JAX
package.

Every case of tests/test_pipeline.py runs the port's schedule emulated on
one device (``emulate_pipeline``, ``emulate_pipeline_interleaved``: the
same per-step body as the real ranks) against the JAX package's
``shard_map`` pipeline on its virtual CPU devices, from the same numpy
inputs and GPT-2 weights carried across by models/convert.py.  The real
transport (point-to-point shifts, the replicated sum) runs in gloo rank
groups (``test_torch_spmd``: at most 4 ranks, a 120 s deadline) held to
the emulation.  f32 throughout: forward values and losses to 2e-4,
gradients to 5e-3 (ROADMAP.md); the emulation against the real ranks,
the same arithmetic in the same order, to 1e-6.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_spmd as torch_spmd  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import gpt2_pp as jgpt2_pp  # noqa: E402
from ray_tpu.parallel import pipeline as jpipe  # noqa: E402
from ray_tpu_torch.models import gpt2, gpt2_pp, moe  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402
from ray_tpu_torch.parallel import pipeline  # noqa: E402

torch.set_num_threads(2)

FWD = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=5e-3)
SAME = dict(rtol=1e-6, atol=1e-6)


def _mesh(pp):
    return Mesh(np.array(jax.devices()[:pp]), ("pp",))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


# ----------------------------------------------------------------------
# tests/test_pipeline.py, case for case
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 8)])
def test_pipeline_matches_sequential(pp, n_micro):
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((8, 8)) * 0.3).astype(np.float32) for _ in range(pp)]
    bs = [(rng.standard_normal(8) * 0.1).astype(np.float32) for _ in range(pp)]
    x = rng.standard_normal((16, 8)).astype(np.float32)

    jsp = jpipe.stack_stage_params([{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                                    for w, b in zip(ws, bs)])
    jpipe_fn = jpipe.pipeline_spmd(lambda p, h: jax.nn.relu(h @ p["w"] + p["b"]), _mesh(pp), "pp")
    want = np.asarray(jax.jit(jpipe_fn)(jsp, jpipe.microbatch(jnp.asarray(x), n_micro)))

    sp = pipeline.stack_stage_params([{"w": _t(w), "b": _t(b)} for w, b in zip(ws, bs)])
    pipe = pipeline.emulate_pipeline(lambda p, h: torch.relu(h @ p["w"] + p["b"]), pp)
    out = pipe(sp, pipeline.microbatch(_t(x), n_micro))
    assert out.shape == (n_micro, 16 // n_micro, 8)
    np.testing.assert_allclose(out.numpy(), want, **FWD)
    ref = _t(x)
    for w, b in zip(ws, bs):
        ref = torch.relu(ref @ _t(w) + _t(b))
    np.testing.assert_allclose(out.reshape(16, 8).numpy(), ref.numpy(), **FWD)


def _tanh_stages(seed=1):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((6, 6)) * 0.3).astype(np.float32) for _ in range(2)]
    return ws, rng.standard_normal((8, 6)).astype(np.float32)


def test_pipeline_gradients_match():
    """grad through the schedule == grad of the stack, and == the JAX
    pipeline's grad through its scan and ppermute."""
    ws, x = _tanh_stages()
    jsp = jpipe.stack_stage_params([{"w": jnp.asarray(w)} for w in ws])
    jpipe_fn = jpipe.pipeline_spmd(lambda p, h: jnp.tanh(h @ p["w"]), _mesh(2), "pp")
    jgrad = jax.jit(jax.grad(
        lambda sp: (jpipe_fn(sp, jpipe.microbatch(jnp.asarray(x), 4)) ** 2).sum()))(jsp)

    sp = pipeline.stack_stage_params([{"w": _t(w)} for w in ws])
    sp["w"].requires_grad_(True)
    pipe = pipeline.emulate_pipeline(lambda p, h: torch.tanh(h @ p["w"]), 2)
    (pipe(sp, pipeline.microbatch(_t(x), 4)) ** 2).sum().backward()
    np.testing.assert_allclose(sp["w"].grad.numpy(), np.asarray(jgrad["w"]), **GRAD)

    wr = _t(np.stack(ws), grad=True)
    h = _t(x)
    for i in range(2):
        h = torch.tanh(h @ wr[i])
    (h ** 2).sum().backward()
    np.testing.assert_allclose(sp["w"].grad.numpy(), wr.grad.numpy(), **GRAD)


def _tiny():
    return (jgpt2.GPT2Config.tiny(remat=False, dtype=jnp.float32),
            gpt2.GPT2Config.tiny(remat=False, dtype=torch.float32))


def _interleaved_cfgs(pp, v):
    kw = dict(vocab_size=128, n_layer=pp * v, n_head=2, d_model=32, max_seq_len=32, remat=False)
    return jgpt2.GPT2Config(dtype=jnp.float32, **kw), gpt2.GPT2Config(dtype=torch.float32, **kw)


def _gpt2_pair(cfgs, seed=0):
    """(JAX params as numpy, the port's params, JAX cfg, port cfg), f32."""
    jcfg, cfg = cfgs
    jparams = jax.tree_util.tree_map(np.asarray, jgpt2.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jparams, gpt2_state_dict_from_jax(jparams, cfg), jcfg, cfg


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _requires_grad(*trees):
    for tree in trees:
        for t in tree.values():
            t.requires_grad_(True)


def _merged_grads(stage_params, rest, cfg):
    return gpt2_pp.merge_pipeline_params({k: t.grad for k, t in stage_params.items()},
                                         {k: t.grad for k, t in rest.items()}, cfg)


def _assert_grads_match(got, jgrads_full, cfg):
    want = gpt2_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads_full), cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **GRAD)


def test_gpt2_pp_loss_matches_unpipelined():
    pp = 2
    jparams, params, jcfg, cfg = _gpt2_pair(_tiny())
    tokens = _tokens(2, cfg.vocab_size, (4, 32))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    jsp, jrest = jgpt2_pp.split_pipeline_params(jparams, jcfg, pp)
    jloss = float(jax.jit(jgpt2_pp.make_pp_loss_fn(jcfg, _mesh(pp), n_micro=2))(
        jsp, jrest, jnp.asarray(inputs), jnp.asarray(targets)))

    stage_params, rest = gpt2_pp.split_pipeline_params(params, cfg, pp)
    ti, tt = torch.from_numpy(inputs), torch.from_numpy(targets)
    loss = gpt2_pp.make_pp_loss_fn(cfg, pp, n_micro=2)(stage_params, rest, ti, tt)
    model = gpt2.GPT2(cfg)
    model.load_state_dict(params)
    ref = gpt2.loss_fn(model, ti, tt)
    np.testing.assert_allclose(loss.item(), jloss, **FWD)
    np.testing.assert_allclose(loss.item(), ref.item(), **FWD)
    # Round-trip of the param split (checkpoint interop).
    merged = gpt2_pp.merge_pipeline_params(stage_params, rest, cfg)
    assert merged.keys() == params.keys()
    assert all(torch.equal(merged[k], params[k]) for k in params)


def test_gpt2_pp_grads_flow():
    pp = 2
    jparams, params, jcfg, cfg = _gpt2_pair(_tiny())
    tokens = _tokens(3, cfg.vocab_size, (4, 32))
    jsp, jrest = jgpt2_pp.split_pipeline_params(jparams, jcfg, pp)
    jloss_fn = jgpt2_pp.make_pp_loss_fn(jcfg, _mesh(pp), n_micro=4)
    jg_sp, jg_rest = jax.jit(jax.grad(jloss_fn, argnums=(0, 1)))(
        jsp, jrest, jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))

    stage_params, rest = gpt2_pp.split_pipeline_params(params, cfg, pp)
    _requires_grad(stage_params, rest)
    toks = torch.from_numpy(tokens)
    gpt2_pp.make_pp_loss_fn(cfg, pp, n_micro=4)(stage_params, rest, toks[:, :-1],
                                                toks[:, 1:]).backward()
    got = _merged_grads(stage_params, rest, cfg)
    norms = [float(torch.linalg.norm(g)) for g in got.values()]
    assert all(np.isfinite(n) for n in norms)
    assert sum(norms) > 0
    _assert_grads_match(got, jgpt2_pp.merge_pipeline_params(jg_sp, jg_rest, jcfg), cfg)


@pytest.mark.parametrize("pp,v,n_micro", [(4, 1, 4), (4, 2, 4), (2, 2, 2), (4, 2, 2), (4, 2, 3)])
def test_gpt2_pp_interleaved_matches_unpipelined(pp, v, n_micro):
    """Non-uniform stages (embed/head IN the pipeline) + interleaved
    virtual chunks must still compute exactly the sequential loss."""
    jparams, params, jcfg, cfg = _gpt2_pair(_interleaved_cfgs(pp, v))
    tokens = _tokens(4, cfg.vocab_size, (n_micro * 2, 17))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    jf, jc, jl = jgpt2_pp.split_pipeline_params_interleaved(jparams, jcfg, pp, v)
    jloss = float(jax.jit(jgpt2_pp.make_pp_loss_fn_interleaved(
        jcfg, _mesh(pp), n_micro=n_micro, n_virtual=v))(
            jf, jc, jl, jnp.asarray(inputs), jnp.asarray(targets)))

    first, chunks, last = gpt2_pp.split_pipeline_params_interleaved(params, cfg, pp, v)
    ti, tt = torch.from_numpy(inputs), torch.from_numpy(targets)
    loss = gpt2_pp.make_pp_loss_fn_interleaved(cfg, pp, n_micro=n_micro, n_virtual=v)(
        first, chunks, last, ti, tt)
    model = gpt2.GPT2(cfg)
    model.load_state_dict(params)
    np.testing.assert_allclose(loss.item(), jloss, **FWD)
    np.testing.assert_allclose(loss.item(), gpt2.loss_fn(model, ti, tt).item(), **FWD)


def _interleaved_grads(first, chunks, last, cfg, pp, v):
    """The per-layer gradients of the interleaved trees, by the port's names."""
    per = cfg.n_layer // (pp * v)
    out = {k: t.grad for k, t in (*first.items(), *last.items())}
    for name, t in chunks.items():
        for d in range(pp):
            for lap in range(v):
                for i in range(per):
                    out[f"h_{(d + lap * pp) * per + i}.{name}"] = t.grad[d, lap, i]
    return out


def test_gpt2_pp_interleaved_grads_flow_through_all_stages():
    pp, v = 4, 2
    jparams, params, jcfg, cfg = _gpt2_pair(_interleaved_cfgs(pp, v))
    tokens = _tokens(5, cfg.vocab_size, (8, 17))
    jf, jc, jl = jgpt2_pp.split_pipeline_params_interleaved(jparams, jcfg, pp, v)
    jloss_fn = jgpt2_pp.make_pp_loss_fn_interleaved(jcfg, _mesh(pp), n_micro=4, n_virtual=v)
    jg_first, jg_chunks, jg_last = jax.jit(jax.grad(jloss_fn, argnums=(0, 1, 2)))(
        jf, jc, jl, jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))

    first, chunks, last = gpt2_pp.split_pipeline_params_interleaved(params, cfg, pp, v)
    _requires_grad(first, chunks, last)
    toks = torch.from_numpy(tokens)
    gpt2_pp.make_pp_loss_fn_interleaved(cfg, pp, n_micro=4, n_virtual=v)(
        first, chunks, last, toks[:, :-1], toks[:, 1:]).backward()
    # EVERY stage's params must receive gradient — embed (first), all
    # pp*v block chunks, and the head (last)
    assert float(torch.linalg.norm(first["wte.weight"].grad)) > 0
    assert float(torch.linalg.norm(last["lm_head.weight"].grad)) > 0
    per_chunk = sum(t.grad.reshape(pp * v, -1).norm(dim=-1) for t in chunks.values())
    assert (per_chunk > 0).all(), per_chunk
    # the JAX chunks [pp, v, per, ...] back to per-layer trees
    per = cfg.n_layer // (pp * v)
    jfull = {**jg_first, **jg_last}
    for d in range(pp):
        for lap in range(v):
            for i in range(per):
                jfull[f"h_{(d + lap * pp) * per + i}"] = jax.tree_util.tree_map(
                    lambda g: g[d, lap, i], jg_chunks)
    _assert_grads_match(_interleaved_grads(first, chunks, last, cfg, pp, v), jfull, cfg)


def test_interleaved_bubble_fraction_smaller():
    """Same S=8 total stages: interleaving v=2 over pp=4 shrinks the
    bubble vs plain GPipe over 8 stages (the scheduling win the
    interleaved schedule exists for); the values are the reference's."""
    m = 4
    gpipe = pipeline.bubble_fraction(8, m, 1)          # 8 devices, 1 chunk each
    interleaved = pipeline.bubble_fraction(4, m, 2)    # 4 devices, 2 chunks each
    assert interleaved < gpipe
    assert interleaved == 3 / 11 and gpipe == 7 / 11
    for args in [(8, 4, 1), (4, 4, 2), (2, 4, 1), (4, 3, 2), (1, 1, 1)]:
        assert pipeline.bubble_fraction(*args) == jpipe.bubble_fraction(*args)


def test_interleaved_schedule_refuses_more_microbatches_than_stages():
    _, params, _, cfg = _gpt2_pair(_interleaved_cfgs(2, 1))
    first, chunks, last = gpt2_pp.split_pipeline_params_interleaved(params, cfg, 2, 1)
    toks = torch.from_numpy(_tokens(6, cfg.vocab_size, (6, 17)))
    with pytest.raises(ValueError, match="n_micro"):
        gpt2_pp.make_pp_loss_fn_interleaved(cfg, 2, n_micro=3)(first, chunks, last,
                                                               toks[:, :-1], toks[:, 1:])


# ----------------------------------------------------------------------
# the real transport: gloo rank groups held to the emulation
# ----------------------------------------------------------------------
def test_real_ranks_pipeline_spmd_matches_emulation(tmp_path):
    """pp=2, M=4 over two gloo ranks: the output (the same on both ranks),
    each rank's slice of the stage weights' gradient (zero elsewhere) and
    the replicated input's gradient (summed over the group) against the
    emulation and the JAX pipeline."""
    ws, x = _tanh_stages()
    ranks = torch_spmd.run_group(torch_spmd.ranks_pipeline, 2, tmp_path, ws, x, 4)

    sp = pipeline.stack_stage_params([{"w": _t(w)} for w in ws])
    sp["w"].requires_grad_(True)
    xx = _t(x, grad=True)
    out = pipeline.emulate_pipeline(lambda p, h: torch.tanh(h @ p["w"]), 2)(
        sp, pipeline.microbatch(xx, 4))
    (out ** 2).sum().backward()
    jsp = jpipe.stack_stage_params([{"w": jnp.asarray(w)} for w in ws])
    jpipe_fn = jpipe.pipeline_spmd(lambda p, h: jnp.tanh(h @ p["w"]), _mesh(2), "pp")
    jout = np.asarray(jax.jit(jpipe_fn)(jsp, jpipe.microbatch(jnp.asarray(x), 4)))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], out.detach().numpy(), **SAME)
        np.testing.assert_allclose(r["out"], jout, **FWD)
        np.testing.assert_allclose(r["w_grad_row"], sp["w"].grad[rank].numpy(), **SAME)
        assert r["w_grad_rows_elsewhere_zero"]
        np.testing.assert_allclose(r["x_grad"], xx.grad.numpy(), **SAME)


def test_real_ranks_interleaved_gpt2_matches_emulation(tmp_path):
    """pp=4, v=2, M=4 make_pp_loss_fn_interleaved over four gloo ranks:
    the loss on every rank, the embedding's and the head's gradients
    (summed over the group: only ranks 0 and 3 use them) and each rank's
    chunk slice of the block gradients against the emulation, and the
    loss against the JAX pipeline."""
    pp, v = 4, 2
    jparams, params, jcfg, cfg = _gpt2_pair(_interleaved_cfgs(pp, v))
    tokens = _tokens(5, cfg.vocab_size, (8, 17)).astype(np.int64)
    state = {k: t.numpy() for k, t in params.items()}
    ranks = torch_spmd.run_group(torch_spmd.ranks_pipeline_interleaved, pp, tmp_path, cfg,
                                 state, tokens, 4, v)

    first, chunks, last = gpt2_pp.split_pipeline_params_interleaved(params, cfg, pp, v)
    _requires_grad(first, chunks, last)
    toks = torch.from_numpy(tokens)
    loss = gpt2_pp.make_pp_loss_fn_interleaved(cfg, pp, n_micro=4, n_virtual=v)(
        first, chunks, last, toks[:, :-1], toks[:, 1:])
    loss.backward()
    jf, jc, jl = jgpt2_pp.split_pipeline_params_interleaved(jparams, jcfg, pp, v)
    jloss = float(jax.jit(jgpt2_pp.make_pp_loss_fn_interleaved(
        jcfg, _mesh(pp), n_micro=4, n_virtual=v))(
            jf, jc, jl, jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["loss"], loss.item(), **SAME)
        np.testing.assert_allclose(r["loss"], jloss, **FWD)
        for tree, key in ((first, "first_grads"), (last, "last_grads")):
            for k, t in tree.items():
                np.testing.assert_allclose(r[key][k], t.grad.numpy(), err_msg=k, **SAME)
        for k, t in chunks.items():
            np.testing.assert_allclose(r["chunk_grad_rows"][k], t.grad[rank].numpy(),
                                       err_msg=k, **SAME)


# ----------------------------------------------------------------------
# models/moe.py moe_sharding_rules
# ----------------------------------------------------------------------
def test_moe_sharding_rules_give_the_reference_specs():
    """The port's table gives the reference's specs for the expert stacks
    (the same layouts) and the router (replicated; [E, D] here, [D, E]
    there), then the transformer table's."""
    from ray_tpu.models.moe import moe_sharding_rules as jrules

    port, ref = moe.moe_sharding_rules(), jrules()
    cases = [("experts_gate", "experts_gate", (8, 32, 64)),
             ("experts_up", "experts_up", (8, 32, 64)),
             ("experts_down", "experts_down", (8, 64, 32)),
             ("moe/experts_gate", "moe/experts_gate", (8, 32, 64)),
             ("router/weight", "router/kernel", (8, 32))]
    for path, jpath, shape in cases:
        assert port.spec_for(path, shape) == tuple(ref.spec_for(jpath, shape)), path
    assert port.spec_for("experts_up", (8, 32, 64)) == ("ep", "fsdp", "tp")
    assert port.spec_for("experts_down", (8, 64, 32)) == ("ep", "tp", "fsdp")
    # the transformer table follows: the port's names, the reference's specs transposed
    for path, jpath, shape in [("h_0/attn/qkv/weight", "h_0/attn/qkv/kernel", (96, 32)),
                               ("h_0/mlp/mlp_down/weight", "h_0/mlp/mlp_down/kernel", (32, 128)),
                               ("ln_f/scale", "ln_f/scale", (32,))]:
        assert port.spec_for(path, shape) == tuple(reversed(tuple(
            ref.spec_for(jpath, tuple(reversed(shape)))))), path


def test_moe_expert_parallel_matches_single_device(tmp_path):
    """ep=4 over four gloo ranks: each rank holds 2 of the 8 experts, and
    the output and aux loss equal one device's and the JAX package's
    (tests/test_models.py:180)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import moe as jmoe
    from ray_tpu.parallel.sharding import infer_param_spec, tree_shardings
    from ray_tpu_torch.models.convert import moe_state_dict_from_jax

    jcfg = jmoe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2, dtype=jnp.float32)
    cfg = moe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2, dtype=torch.float32)
    x = np.random.default_rng(4).standard_normal((2, 16, 32)).astype(np.float32)
    mod = jmoe.MoEMLP(jcfg)
    jparams = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    specs = infer_param_spec(jparams, jmoe.moe_sharding_rules(), mesh)
    jout, jaux = jax.jit(lambda p, v: mod.apply({"params": p}, v))(
        jax.device_put(jparams, tree_shardings(mesh, specs)),
        jax.device_put(jnp.asarray(x), NamedSharding(mesh, P())))
    state = {k: t.numpy() for k, t in moe_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}

    ranks = torch_spmd.run_group(torch_spmd.ranks_moe, 4, tmp_path, cfg, state, x)
    model = moe.MoEMLP(cfg)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in state.items()})
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    for r in ranks:
        assert r["specs"]["experts_gate"] == ("ep", None, None)
        assert r["specs"]["router.weight"] == (None, None)
        assert r["local_shapes"]["experts_down"] == (2, 64, 32)
        np.testing.assert_allclose(r["out"], out.numpy(), **SAME)
        np.testing.assert_allclose(r["aux"], aux.item(), **SAME)
        np.testing.assert_allclose(r["out"], np.asarray(jout), **FWD)
        np.testing.assert_allclose(r["aux"], float(jaux), **FWD)
