"""A compiled DAG of the port over tiny GPT-2 against the JAX package's
forward: ``Prefill.forward.bind(inp)`` runs the port's GPT-2 in float32 in
one actor, ``Argmax.pick.bind(logits)`` takes the greedy ids in another,
and ``MultiOutputNode([logits, ids])`` returns both over the channels.
The weights are the JAX package's, perturbed from a numpy seed and carried
across by models/convert.py; the last-position logits must equal the JAX
forward's to 2e-4 (tests/test_torch_gpt2.py's tolerance), and the ids
its argmax.  The actor classes are defined inside the test (pickled by
value), so no worker imports JAX.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.dag import InputNode, MultiOutputNode  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # many clusters share the machine under xdist: no 2 GiB arena
        # prefault, and no memory monitor killing this test's workers for
        # the others' memory
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_compiled_dag_gpt2_matches_jax_forward(ray_cluster):
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, remat=False)
    params = jgpt2.init_params(jcfg, rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )
    tcfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    state = gpt2_state_dict_from_jax(tree, tcfg)
    jmodel = jgpt2.GPT2(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)

    @ray_tpu_torch.remote
    class Prefill:
        def __init__(self, state):
            import torch

            from ray_tpu_torch.models import gpt2

            torch.set_num_threads(2)
            self.model = gpt2.GPT2(gpt2.GPT2Config.tiny(dtype=torch.float32))
            self.model.load_state_dict(state)
            self.model.eval()

        def forward(self, tokens):
            import torch

            with torch.inference_mode():
                return self.model(torch.from_numpy(tokens).long())[:, -1]

    @ray_tpu_torch.remote
    class Argmax:
        def pick(self, logits):
            return logits.argmax(-1).tolist()

    with InputNode() as inp:
        logits = Prefill.bind(state).forward.bind(inp)
        ids = Argmax.bind().pick.bind(logits)
        dag = MultiOutputNode([logits, ids])
    compiled = dag.experimental_compile()
    try:
        assert compiled._channels_on
        batches = [np.random.default_rng(s).integers(0, jcfg.vocab_size, size=(2, 24))
                   .astype(np.int32) for s in range(3)]
        refs = compiled.execute_many(batches[:2]) + [compiled.execute(batches[2])]
        for toks, ref in zip(batches, refs):
            got_logits, got_ids = ray_tpu_torch.get(ref)
            want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(toks)))[:, -1]
            assert isinstance(got_logits, torch.Tensor) and got_logits.dtype == torch.float32
            np.testing.assert_allclose(got_logits.numpy(), want, **TOL)
            assert got_ids == got_logits.argmax(-1).tolist()
            assert got_ids == want.argmax(-1).tolist()
    finally:
        compiled.teardown()
