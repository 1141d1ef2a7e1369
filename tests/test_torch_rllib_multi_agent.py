"""The port's MultiAgentEnvRunner against the JAX package's: greedy
rollouts of two policies over two multi-agent envs (a plain-Python one
whose agents leave the episode on their own, and two CartPoles ended
together by ``__all__``) on the same weights (carried by
``models/convert.py``) give the same per-policy batches, GAE columns
included.  Tolerances: values, advantages and targets at 2e-4; the rest
exactly."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec  # noqa: E402
from ray_tpu.rllib.env.multi_agent_env import MultiAgentEnvRunner as JRunner  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_from_flax  # noqa: E402
from ray_tpu_torch.rllib import MultiAgentEnvRunner, RLModuleSpec  # noqa: E402
from test_torch_rllib_copies import _TwoWalkers  # noqa: E402
from test_torch_rllib_learning import _DoubleCartPole  # noqa: E402
from test_torch_rllib_offpolicy import TOL, perturbed  # noqa: E402

torch.set_num_threads(2)


ENVS = {"walkers": (_TwoWalkers, 3), "double_cartpole": (_DoubleCartPole, 4)}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_greedy_multi_agent_rollouts_match_the_reference(env):
    """sample(explore=False) twice (the second fragment starts mid
    episode): each policy's batch, its rows in the same order, with the
    same GAE columns; the runners' episode metrics agree."""
    creator, obs_dim = ENVS[env]
    mapping = lambda agent: "p" + agent[-1]  # noqa: E731
    kw = {pid: dict(observation_dim=obs_dim, action_dim=2, hidden=(16,)) for pid in ("p0", "p1")}
    params = {pid: perturbed(JSpec(**k).build().init(jax.random.PRNGKey(i)), 10 + i)
              for i, (pid, k) in enumerate(kw.items())}
    args = dict(rollout_fragment_length=40, gamma=0.95, lambda_=0.9, worker_index=1, seed=3)
    jr = JRunner(creator, {p: JSpec(**k) for p, k in kw.items()}, mapping, **args)
    tr = MultiAgentEnvRunner(creator, {p: RLModuleSpec(**k) for p, k in kw.items()}, mapping,
                             **args)
    jr.set_weights(params)
    tr.set_weights({p: {k: v.numpy() for k, v in rl_module_from_flax(w).items()}
                    for p, w in params.items()})
    for _ in range(2):
        want, got = jr.sample(explore=False), tr.sample(explore=False)
        assert set(got) == set(want) == {"p0", "p1"}
        for pid in want:
            assert set(got[pid]) == set(want[pid])
            assert got[pid].count == want[pid].count
            for k in ("obs", "actions", "rewards", "terminateds", "truncateds", "eps_id"):
                np.testing.assert_array_equal(got[pid][k], np.asarray(want[pid][k]),
                                              err_msg=(pid, k))
            for k in ("vf_preds", "advantages", "value_targets", "action_logp"):
                np.testing.assert_allclose(got[pid][k], want[pid][k], **TOL, err_msg=(pid, k))
    assert tr.get_metrics() == jr.get_metrics()
    assert tr.get_metrics()["num_episodes"] >= 2
    jr.stop()
    tr.stop()
