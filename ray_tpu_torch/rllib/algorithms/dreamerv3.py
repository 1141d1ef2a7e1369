"""DreamerV3 — model-based RL via latent imagination (reference:
rllib/algorithms/dreamerv3/ — Hafner et al. 2023; the reference wraps
the authors' TF implementation in its new API stack).

One update, on the learner's device (``cuda`` by default): world-model
(RSSM) sequence learning, an imagination rollout, the actor's and the
critic's steps and the critic's EMA target, each network with its own
AdamW.  The world model's scan over the sequence and the imagination's
scan over the horizon are Python loops over ``seq_len`` and ``horizon``;
the lambda-returns are a reversed loop without gradient.

Kept from the paper (the parts that carry the method):
  * RSSM with categorical latents (straight-through gradients), KL
    balancing with free bits between dyn/rep losses;
  * symlog regression for decoder/reward/critic heads;
  * imagination training from every posterior state with lambda-returns,
    percentile return normalization for the actor, EMA critic
    regularizer.
Simplified vs the paper (documented, CI-scale): MLP encoder/decoder
(vector obs), plain symlog-MSE critic instead of twohot, fixed entropy
scale instead of the full return-scaling schedule.

Randomness: the reference samples its categoricals inside the jitted
update.  Here every categorical sample is ``argmax(logits + g)`` with
Gumbel noise ``g`` the update takes as tensors (``noise=``); when the
caller passes none, ``update_from_batch`` draws it from the learner's
``torch.Generator`` in one place.  ``jax.random.categorical`` is that same
argmax over its own Gumbel draws, so only the noise's source differs.

Constants kept from the reference's libraries where torch's differ:
flax's LayerNorm epsilon 1e-6 and ``optax.adamw``'s weight decay 1e-4.
The GRU is ``nn.GRUCell`` with flax's gate layout: flax has no hidden
bias on the reset and update gates, so those two thirds of ``bias_hh``
stay zero (their gradient is masked)."""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import batch_tensor, learner_device
from ray_tpu_torch.rllib.core.rl_module import _init_params, load_weights, weights_of


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 4e-4            # world model
        self.actor_lr = 4e-5
        self.critic_lr = 1e-4
        self.deter_size = 128
        self.stoch_groups = 8     # categorical groups
        self.stoch_classes = 8    # classes per group
        self.hidden = (128,)
        self.seq_len = 16
        self.batch_seqs = 16
        self.horizon = 10
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.free_bits = 1.0
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.entropy_scale = 3e-3
        self.critic_ema_decay = 0.98
        self.replay_capacity_steps = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.sample_batch_size = 256
        self.updates_per_iteration = 8
        self.num_env_runners = 0

    @property
    def algo_class(self):
        return DreamerV3


class _MLP(nn.Module):
    """Dense -> LayerNorm -> SiLU per hidden width, then a Dense ``out``
    (flax's names: ``d{i}``, ``LayerNorm_{i}``, ``out``)."""

    def __init__(self, in_dim: int, sizes: tuple, out: int):
        super().__init__()
        self.sizes = tuple(sizes)
        width = in_dim
        for i, w in enumerate(self.sizes):
            self.add_module(f"d{i}", nn.Linear(width, w))
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(w, eps=1e-6))  # flax's epsilon
            width = w
        self.out = nn.Linear(width, out)

    def forward(self, x):
        for i in range(len(self.sizes)):
            x = F.silu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"d{i}")(x)))
        return self.out(x)


class _RSSMNets(nn.Module):
    """The world model: encoder, GRU, prior and posterior heads, decoder,
    reward and continue heads (the reference's params keys: ``encoder``,
    ``gru``, ``prior``, ``post``, ``decoder``, ``reward``, ``cont``), with
    the latent steps."""

    def __init__(self, cfg: DreamerV3Config, obs_dim: int, n_actions: int):
        super().__init__()
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        s = cfg.stoch_groups * cfg.stoch_classes
        feat = cfg.deter_size + s
        self.feat_dim = feat
        self.encoder = _MLP(obs_dim, cfg.hidden, cfg.deter_size)
        self.gru = nn.GRUCell(s + n_actions, cfg.deter_size)
        self.prior = _MLP(cfg.deter_size, cfg.hidden, s)
        self.post = _MLP(2 * cfg.deter_size, cfg.hidden, s)
        self.decoder = _MLP(feat, cfg.hidden, obs_dim)
        self.reward = _MLP(feat, cfg.hidden, 1)
        self.cont = _MLP(feat, cfg.hidden, 1)
        # flax's GRUCell has no hidden bias on r and z: keep them at zero
        d = cfg.deter_size
        self.gru.bias_hh.register_hook(
            lambda g: torch.cat([torch.zeros_like(g[:2 * d]), g[2 * d:]]))

    def init_weights(self, generator: torch.Generator) -> None:
        """Dense kernels normal of std 1/sqrt(fan_in), zero biases; the
        GRU's input kernels likewise, its hidden kernels orthogonal per
        gate (flax's initialisers' kinds, from ``generator``)."""
        _init_params(self, generator)
        d = self.cfg.deter_size
        with torch.no_grad():
            w = torch.randn(self.gru.weight_ih.shape, generator=generator)
            self.gru.weight_ih.copy_(w / self.gru.weight_ih.shape[1] ** 0.5)
            for g in range(3):
                nn.init.orthogonal_(self.gru.weight_hh[g * d:(g + 1) * d], generator=generator)
            self.gru.bias_ih.zero_()
            self.gru.bias_hh.zero_()

    # -- latent helpers ---------------------------------------------------
    def _unimix(self, logits):
        """Flat logits → grouped log-probs with 1% uniform mix (paper §B:
        keeps all classes reachable)."""
        cfg = self.cfg
        logits = logits.reshape(logits.shape[:-1] + (cfg.stoch_groups, cfg.stoch_classes))
        probs = 0.99 * torch.softmax(logits, dim=-1) + 0.01 / cfg.stoch_classes
        return torch.log(probs)

    def _sample_st(self, logits, gumbel):
        """Straight-through categorical sample per group → flat one-hot:
        the class ``argmax(log-probs + gumbel)``.  Accepts flat logits;
        returns (flat sample, grouped log-probs)."""
        glogits = self._unimix(logits)
        probs = torch.exp(glogits)
        idx = torch.argmax(glogits.detach() + gumbel, dim=-1)
        onehot = F.one_hot(idx, self.cfg.stoch_classes).to(probs.dtype)
        st = onehot + probs - probs.detach()  # straight-through
        return st.reshape(st.shape[:-2] + (-1,)), glogits

    def obs_step(self, h, embed, z_prev, a_prev, gumbel):
        """Posterior step: (h, z, a) x obs embed → (h', z_post, prior
        log-probs, posterior log-probs)."""
        h = self.gru(torch.cat([z_prev, a_prev], -1), h)
        prior_logits = self.prior(h)
        post_logits = self.post(torch.cat([h, embed], -1))
        z, post_glogits = self._sample_st(post_logits, gumbel)
        return h, z, self._unimix(prior_logits), post_glogits

    def img_step(self, h, z, a, gumbel):
        """Prior (imagination) step: no observation."""
        h = self.gru(torch.cat([z, a], -1), h)
        z, _ = self._sample_st(self.prior(h), gumbel)
        return h, z


def _gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)), u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class DreamerV3Learner:
    """World model + actor + critic on the learner's device; one update
    steps the three AdamWs and the critic's EMA target."""

    def __init__(self, cfg: DreamerV3Config, obs_dim: int, n_actions: int, seed: int = 0):
        self.cfg = cfg
        self.device = learner_device(cfg.learner_device)
        self._gen = torch.Generator().manual_seed(int(seed))
        self.nets = _RSSMNets(cfg, obs_dim, n_actions)
        self.nets.init_weights(self._gen)
        self.actor = _MLP(self.nets.feat_dim, cfg.hidden, n_actions)
        self.critic = _MLP(self.nets.feat_dim, cfg.hidden, 1)
        _init_params(self.actor, self._gen)
        _init_params(self.critic, self._gen)
        for m in (self.nets, self.actor, self.critic):
            m.to(self.device)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)

        def adamw(module, lr):
            # optax.adamw's defaults: weight decay 1e-4 (torch's is 1e-2)
            return torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)

        self.wm_opt = adamw(self.nets, cfg.lr)
        self.actor_opt = adamw(self.actor, cfg.actor_lr)
        self.critic_opt = adamw(self.critic, cfg.critic_lr)
        self._metrics: Dict[str, float] = {}

    # -- acting (per env step) --------------------------------------------
    def policy_state(self):
        cfg = self.cfg
        s = cfg.stoch_groups * cfg.stoch_classes
        return (torch.zeros((1, cfg.deter_size), device=self.device),
                torch.zeros((1, s), device=self.device))

    def act(self, state, obs, greedy: bool = False):
        """One posterior step on ``obs`` and an action from the actor:
        returns ((h, z), action, its one-hot as a [1, n_actions] float32
        array).  Noise from the learner's generator."""
        nets, cfg = self.nets, self.cfg
        h, z, a_prev = state
        if a_prev is None:
            a_prev = np.zeros((1, nets.n_actions), np.float32)
        g_post = _gumbel((1, cfg.stoch_groups, cfg.stoch_classes), self._gen).to(self.device)
        g_act = _gumbel((1, nets.n_actions), self._gen).to(self.device)
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, np.float32)[None]).to(self.device)
            embed = nets.encoder(symlog(obs))
            a_prev = torch.as_tensor(np.asarray(a_prev, np.float32)).to(self.device)
            h, z, _, _ = nets.obs_step(h, embed, z, a_prev, g_post)
            logits = self.actor(torch.cat([h, z], -1))
            a = logits.argmax(-1) if greedy else torch.argmax(logits + g_act, -1)
        a = int(a[0])
        return (h, z), a, np.eye(nets.n_actions, dtype=np.float32)[a][None]

    # -- update -----------------------------------------------------------
    def draw_noise(self, n_seqs: int, seq_len: int) -> Dict[str, torch.Tensor]:
        """One update's Gumbel noise: the posterior samples along the
        sequence ``[L, B, G, C]``, and along the horizon the actions ``[H,
        N, A]`` and the prior samples ``[H, N, G, C]`` (N = L * B, the
        imagination's starts)."""
        cfg, nets = self.cfg, self.nets
        gc = (cfg.stoch_groups, cfg.stoch_classes)
        n = n_seqs * seq_len
        return {"post": _gumbel((seq_len, n_seqs) + gc, self._gen),
                "act": _gumbel((cfg.horizon, n, nets.n_actions), self._gen),
                "img": _gumbel((cfg.horizon, n) + gc, self._gen)}

    def _wm_loss(self, b, g_post):
        cfg, nets = self.cfg, self.nets
        B, L = b["obs"].shape[:2]
        obs_sym = symlog(b["obs"])
        embeds = nets.encoder(obs_sym)
        h = torch.zeros((B, cfg.deter_size), device=self.device)
        z = torch.zeros((B, cfg.stoch_groups * cfg.stoch_classes), device=self.device)
        hs, zs, priors, posts = [], [], [], []
        for t in range(L):
            # reset state at episode starts inside the sequence
            keep = 1.0 - b["is_first"][:, t, None]
            h, z, prior_l, post_l = nets.obs_step(
                h * keep, embeds[:, t], z * keep, b["prev_actions"][:, t] * keep, g_post[t])
            hs.append(h)
            zs.append(z)
            priors.append(prior_l)
            posts.append(post_l)
        prior_l, post_l = torch.stack(priors), torch.stack(posts)
        feat = torch.cat([torch.stack(hs), torch.stack(zs)], -1)  # [L, B, feat]
        recon = nets.decoder(feat)
        rew = nets.reward(feat)[..., 0]
        cont = nets.cont(feat)[..., 0]
        obs_t = obs_sym.transpose(0, 1)
        rew_t = b["rewards"].transpose(0, 1)
        cont_t = 1.0 - b["terminateds"].transpose(0, 1)

        recon_loss = ((recon - obs_t) ** 2).sum(-1).mean()
        reward_loss = ((rew - symlog(rew_t)) ** 2).mean()
        cont_loss = F.binary_cross_entropy_with_logits(cont, cont_t)

        def kl(a_logits, b_logits):
            # logits are already grouped normalized log-probs
            return (torch.exp(a_logits) * (a_logits - b_logits)).sum((-2, -1))

        dyn = torch.clamp(kl(post_l.detach(), prior_l), min=cfg.free_bits).mean()
        rep = torch.clamp(kl(post_l, prior_l.detach()), min=cfg.free_bits).mean()
        loss = (recon_loss + reward_loss + cont_loss
                + cfg.kl_dyn_scale * dyn + cfg.kl_rep_scale * rep)
        metrics = {"wm_recon_loss": recon_loss.detach(), "wm_reward_loss": reward_loss.detach(),
                   "wm_cont_loss": cont_loss.detach(), "wm_kl_dyn": dyn.detach()}
        return loss, feat, metrics

    def _imagine(self, feat0, g_act, g_img):
        """Roll the prior ``horizon`` steps with the actor from ``feat0``:
        feats, action logp and entropy (with the actor's gradient),
        rewards and continues (the world model's, without gradient)."""
        cfg, nets = self.cfg, self.nets
        h, z = feat0[:, :cfg.deter_size], feat0[:, cfg.deter_size:]
        feats, logps, ents = [], [], []
        for k in range(cfg.horizon):
            feat = torch.cat([h, z], -1)
            logits = self.actor(feat)
            a = torch.argmax(logits.detach() + g_act[k], -1)
            logsm = torch.log_softmax(logits, -1)
            logps.append(logsm.gather(-1, a[:, None])[:, 0])
            ents.append(-(torch.softmax(logits, -1) * logsm).sum(-1))
            with torch.no_grad():
                h, z = nets.img_step(h, z, F.one_hot(a, nets.n_actions).to(feat.dtype), g_img[k])
            feats.append(feat)
        feats = torch.stack(feats)
        with torch.no_grad():
            rews = symexp(nets.reward(feats)[..., 0])
            conts = torch.sigmoid(nets.cont(feats)[..., 0])
        return feats, torch.stack(logps), torch.stack(ents), rews, conts

    def lambda_returns(self, rews, conts, values):
        """ret_t from state t: reward/continue of the NEXT state
        (arrival-aligned layout) + bootstrapped value; [H-1, N]."""
        cfg = self.cfg
        with torch.no_grad():
            disc = conts * cfg.gamma
            nxt = values[-1]
            rets = torch.empty_like(values[1:])
            for t in range(values.shape[0] - 2, -1, -1):
                nxt = rews[t + 1] + disc[t + 1] * ((1 - cfg.lambda_) * values[t + 1] + cfg.lambda_ * nxt)
                rets[t] = nxt
        return rets

    def _update(self, b, noise) -> Dict[str, Any]:
        cfg, nets = self.cfg, self.nets
        # world model
        self.wm_opt.zero_grad(set_to_none=True)
        wloss, feat, metrics = self._wm_loss(b, noise["post"])
        wloss.backward()
        self.wm_opt.step()

        # imagination from every posterior state (no world-model gradient),
        # on the updated world model
        feat0 = feat.detach().reshape(-1, nets.feat_dim)
        self.actor_opt.zero_grad(set_to_none=True)
        feats, logps, ents, rews, conts = self._imagine(feat0, noise["act"], noise["img"])
        with torch.no_grad():
            values = symexp(self.target_critic(feats)[..., 0])
            rets = self.lambda_returns(rews, conts, values)
            # percentile return normalization (paper: 5th-95th)
            flat = rets.reshape(-1)
            scale = torch.clamp(torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05), min=1.0)
            adv = (rets - values[:-1]) / scale
            # discount-weight imagined steps by accumulated continues
            # (includes each state's own arrival flag: imagination
            # seeded from a terminal posterior state gets weight ~0)
            weight = torch.cumprod(conts, 0)[:-1]
        pg = -(weight * adv * logps[:-1]).mean()
        ent_bonus = -cfg.entropy_scale * (weight * ents[:-1]).mean()
        aloss = pg + ent_bonus
        aloss.backward()
        self.actor_opt.step()

        # critic regression to lambda-returns (symlog space) + EMA reg
        feats_sg = feats[:-1]
        self.critic_opt.zero_grad(set_to_none=True)
        v = self.critic(feats_sg)[..., 0]
        with torch.no_grad():
            tgt = self.target_critic(feats_sg)[..., 0]
        closs = ((v - symlog(rets)) ** 2).mean() + 0.1 * ((v - tgt) ** 2).mean()
        closs.backward()
        self.critic_opt.step()
        with torch.no_grad():
            d = cfg.critic_ema_decay
            for t, o in zip(self.target_critic.parameters(), self.critic.parameters()):
                t.copy_(d * t + (1 - d) * o)
        return dict(metrics, world_model_loss=wloss.detach(), actor_loss=aloss.detach(),
                    critic_loss=closs.detach(), imagined_entropy=ents.detach().mean())

    def update_from_batch(self, batch: Dict[str, np.ndarray],
                          noise: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """One update on ``batch`` ([B, L] sequences of ``obs``,
        ``prev_actions``, ``rewards``, ``terminateds``, ``is_first``);
        ``noise`` (``draw_noise``'s keys) from the learner's generator
        when not given."""
        b = {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device) for k, v in batch.items()}
        if noise is None:
            noise = self.draw_noise(*b["rewards"].shape[:2])
        noise = {k: batch_tensor(v, self.device) for k, v in noise.items()}
        metrics = self._update(b, noise)
        self._metrics = {k: float(v) for k, v in metrics.items()}
        return self._metrics

    # -- state -----------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {
            "wm": weights_of(self.nets),
            "actor": weights_of(self.actor),
            "critic": weights_of(self.critic),
            "target_critic": weights_of(self.target_critic),
        }

    def set_state(self, state: Dict[str, Any]):
        load_weights(self.nets, state["wm"])
        load_weights(self.actor, state["actor"])
        load_weights(self.critic, state["critic"])
        load_weights(self.target_critic, state["target_critic"])


class _SequenceReplay:
    """Episode store sampling fixed-length windows with is_first flags
    (reference: dreamerv3's uniform replay over sequence chunks)."""

    def __init__(self, capacity_steps: int, seq_len: int, seed: int = 0):
        self.capacity = capacity_steps
        self.seq_len = seq_len
        self.episodes: list = []
        self.total = 0
        self._rng = np.random.default_rng(seed)

    def add_episode(self, ep: Dict[str, np.ndarray]):
        self.episodes.append(ep)
        self.total += len(ep["rewards"])
        while self.total > self.capacity and len(self.episodes) > 1:
            self.total -= len(self.episodes[0]["rewards"])
            self.episodes.pop(0)

    def __len__(self):
        return self.total

    def sample(self, n_seqs: int) -> Dict[str, np.ndarray]:
        L = self.seq_len
        out = {k: [] for k in ("obs", "prev_actions", "rewards", "terminateds", "is_first")}
        for _ in range(n_seqs):
            ep = self.episodes[self._rng.integers(len(self.episodes))]
            T = len(ep["rewards"])
            start = int(self._rng.integers(0, max(1, T - 1)))
            idx = np.arange(start, start + L)
            # windows crossing the episode end wrap into its start with
            # is_first set — state resets inside the scan handle it
            wrapped = idx % T
            is_first = np.zeros(L, np.float32)
            is_first[0] = 1.0
            is_first[np.where(wrapped == 0)[0]] = 1.0
            out["obs"].append(ep["obs"][wrapped])
            out["prev_actions"].append(ep["prev_actions"][wrapped])
            out["rewards"].append(ep["rewards"][wrapped])
            out["terminateds"].append(ep["terminateds"][wrapped])
            out["is_first"].append(is_first)
        return {k: np.stack(v) for k, v in out.items()}


class DreamerV3(Algorithm):
    config_class = DreamerV3Config

    def _needs_advantages(self) -> bool:
        return False

    def setup(self, config: Dict[str, Any]):
        import gymnasium as gym

        cfg = self.algo_config
        self._env = cfg.make_env_creator()()
        if not isinstance(self._env.action_space, gym.spaces.Discrete):
            raise ValueError("this DreamerV3 implementation is discrete-action")
        obs_dim = int(np.prod(self._env.observation_space.shape))
        self.learner = DreamerV3Learner(
            cfg, obs_dim, int(self._env.action_space.n), seed=cfg.seed
        )
        self.replay = _SequenceReplay(cfg.replay_capacity_steps, cfg.seq_len, cfg.seed)
        self._timesteps_total = 0
        self._episode_returns: list = []
        self._reset_episode()

    def _reset_episode(self):
        obs, _ = self._env.reset(seed=self.algo_config.seed + self._timesteps_total)
        self._obs = np.asarray(obs, np.float32).ravel()
        self._state = self.learner.policy_state()
        self._a_prev = None
        n_act = self.learner.nets.n_actions
        # Dreamer row layout: (x_t, a_{t-1}, r_t, c_t) — the reward and
        # continue flag belong to the state they ARRIVE with (h_t already
        # encodes a_{t-1} through the GRU, so the reward head can predict
        # r_t; aligning r with the source state instead gives the
        # imagination no action-dependent reward signal)
        self._ep = {
            "obs": [self._obs.copy()],
            "prev_actions": [np.zeros(n_act, np.float32)],
            "rewards": [0.0],
            "terminateds": [0.0],
        }
        self._ep_ret = 0.0

    def _collect(self, n_steps: int):
        cfg = self.algo_config
        n_act = self.learner.nets.n_actions
        for _ in range(n_steps):
            if self._timesteps_total < cfg.num_steps_sampled_before_learning_starts:
                a = int(np.random.default_rng(self._timesteps_total).integers(n_act))
                a_oh = np.eye(n_act, dtype=np.float32)[a][None]
                state = self._state
            else:
                state, a, a_oh = self.learner.act((*self._state, self._a_prev), self._obs)
            obs, r, term, trunc, _ = self._env.step(a)
            self._obs = np.asarray(obs, np.float32).ravel()
            self._ep["obs"].append(self._obs.copy())
            self._ep["prev_actions"].append(np.asarray(a_oh, np.float32)[0])
            self._ep["rewards"].append(float(r))
            self._ep["terminateds"].append(float(term))
            self._ep_ret += float(r)
            self._timesteps_total += 1
            self._state = state
            self._a_prev = np.asarray(a_oh)
            if term or trunc:
                self.replay.add_episode(
                    {k: np.asarray(v, np.float32) for k, v in self._ep.items()}
                )
                self._episode_returns.append(self._ep_ret)
                self._reset_episode()

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        self._collect(cfg.sample_batch_size)
        metrics: Dict[str, Any] = {"replay_steps": len(self.replay)}
        if (self._timesteps_total >= cfg.num_steps_sampled_before_learning_starts
                and len(self.replay.episodes) >= 2):
            for _ in range(cfg.updates_per_iteration):
                batch = self.replay.sample(cfg.batch_seqs)
                metrics.update(self.learner.update_from_batch(batch))
        metrics["num_env_steps_sampled"] = self._timesteps_total
        rets = self._episode_returns[-100:]
        metrics["episode_return_mean"] = float(np.mean(rets)) if rets else None
        return metrics

    def evaluate(self) -> Dict[str, Any]:
        """Greedy latent-state rollouts on a fresh env."""
        cfg = self.algo_config
        env = cfg.make_env_creator()()
        returns = []
        for ep in range(cfg.evaluation_duration):
            obs, _ = env.reset(seed=cfg.seed + 30_000 + ep)
            state = (*self.learner.policy_state(), None)
            done, total = False, 0.0
            while not done:
                st, a, a_oh = self.learner.act(
                    state, np.asarray(obs, np.float32).ravel(), greedy=True
                )
                state = (*st, a_oh)
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
        env.close()
        return {
            "num_episodes": len(returns),
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_return_max": float(np.max(returns)),
        }

    def save_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        import cloudpickle

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(
                {"learner": self.learner.get_state(),
                 "timesteps_total": self._timesteps_total,
                 # from_checkpoint rebuilds the algo from the config
                 # (base Algorithm contract)
                 "config": self.algo_config.to_dict(),
                 "config_blob": cloudpickle.dumps(self.algo_config)}, f,
            )

    def load_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_state(state["learner"])
        self._timesteps_total = state.get("timesteps_total", 0)

    def get_policy_weights(self):
        return self.learner.get_state()["actor"]

    def cleanup(self):
        self._env.close()

    stop = cleanup
