"""The port's ring attention (``ray_tpu_torch/ops/ring_attention.py``)
held to the JAX package's ``ring_causal_attention`` and to its
``reference_causal_attention`` (tests/test_ops.py:31,44).

The JAX side runs here on the conftest's virtual CPU devices; the port's
ring runs in four spawned gloo ranks (``test_torch_spmd.ranks_ring``), which
import no JAX and take and return numpy.  The reference composes the ring
with dp as dp=2 x sp=4 on 8 devices; a rank group here holds at most 4,
so the port (and the JAX ring it is held to) runs dp=2 x sp=2.  f32:
forward values at 2e-4, gradients at 5e-3.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_spmd as torch_spmd  # noqa: E402
from ray_tpu.ops.attention import reference_causal_attention  # noqa: E402
from ray_tpu.ops.ring_attention import ring_causal_attention  # noqa: E402
from ray_tpu.parallel import create_mesh  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.ops import ring_attention as ra  # noqa: E402

FWD = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=5e-3)


def _qkv(B, T, H, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))


QKV = _qkv(2, 128, 4, 16, seed=0)  # tests/test_ops.py:31's shape
QKV_DP = _qkv(4, 64, 2, 8, seed=1)  # tests/test_ops.py:44's shape


def _jax_ring(qkv, axes):
    """The JAX ring's output and the gradients of sum(out^2), and the
    reference attention's, on ``axes`` over the first virtual devices."""
    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(axes, jax.devices()[:n])

    def ring(q, k, v):
        return ring_causal_attention(q, k, v, mesh=mesh, axis="sp")

    out = {}
    for name, fn in (("ring", ring), ("reference", reference_causal_attention)):
        args = tuple(jnp.asarray(a) for a in qkv)
        out[name] = np.asarray(jax.jit(fn)(*args))
        grads = jax.jit(jax.grad(lambda q, k, v: (fn(q, k, v) ** 2).sum(), argnums=(0, 1, 2)))(
            *args)
        out[name + "_grads"] = [np.asarray(g) for g in grads]
    return out


def test_ring_attention_matches_reference(tmp_path):
    """Four gloo ranks, one group for every check that needs a mesh:

    - sp=4: the ring's output against the JAX ring and the reference
      attention, and the gradients of sum(out^2) against both;
    - composed with dp (dp=2 x sp=2): output and gradients;
    - the dispatch: ``causal_attention`` with an ``sp`` axis of size 1
      takes the plain path value for value, as the reference
      (ray_tpu/ops/attention.py:42-45), and over sp=4 the ring, once."""
    ranks = torch_spmd.run_group(torch_spmd.ranks_ring, 4, tmp_path, QKV, QKV_DP)
    sp4 = _jax_ring(QKV, {"sp": 4})
    dp2 = _jax_ring(QKV_DP, {"dp": 2, "sp": 2})
    for r in ranks:
        np.testing.assert_allclose(r["sp4_out"], sp4["ring"], **FWD)
        np.testing.assert_allclose(r["sp4_out"], sp4["reference"], **FWD)
        for got, want_ring, want_ref in zip(r["sp4_grads"], sp4["ring_grads"],
                                            sp4["reference_grads"]):
            np.testing.assert_allclose(got, want_ring, **GRAD)
            np.testing.assert_allclose(got, want_ref, **GRAD)
        np.testing.assert_allclose(r["dp2_sp2_out"], dp2["ring"], **FWD)
        np.testing.assert_allclose(r["dp2_sp2_out"], dp2["reference"], **FWD)
        for got, want in zip(r["dp2_sp2_grads"], dp2["reference_grads"]):
            np.testing.assert_allclose(got, want, **GRAD)
        assert r["sp1_ring_calls"] == 0 and r["sp1_equal_plain"], "sp of size 1 took the ring"
        assert r["sp4_ring_calls"] == 1, "sp=4 did not take the ring"
        np.testing.assert_allclose(r["sp4_dispatch_out"], sp4["reference"], **FWD)


@pytest.mark.parametrize("n", [2, 4])
def test_emulated_ring_matches_whole_sequence(n):
    """The per-block steps for n ranks emulated on one device (what the
    card runs at world size 1), against whole-sequence attention and its
    backward: the merge through B1's LSE and the dK/dV accumulators."""
    g = torch.Generator().manual_seed(n)
    q, k, v, do = (torch.randn(2, 64, 2, 64, generator=g) for _ in range(4))
    out, dq, dk, dv = ra.emulate_ring(q, k, v, do, n)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    np.testing.assert_allclose(out.numpy(), o.numpy(), **FWD)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD)


def test_merge_is_the_reference_running_softmax():
    """Merging two blocks' normalised outputs through their LSEs gives the
    reference's online softmax over the union of their keys."""
    q, k, v = (jnp.asarray(a) for a in _qkv(1, 32, 2, 8, seed=3))
    whole = np.asarray(reference_causal_attention(q, k, v))[:, 16:]
    tq, tk, tv = (torch.from_numpy(np.array(a)) for a in (q, k, v))
    o0, l0 = ra.block_forward(tq[:, 16:], tk[:, :16], tv[:, :16], causal=False)
    o1, l1 = ra.block_forward(tq[:, 16:], tk[:, 16:], tv[:, 16:], causal=True)
    o, _ = ra.merge(*ra.merge(None, None, o1, l1), o0, l0)
    np.testing.assert_allclose(o.numpy(), whole, **FWD)
