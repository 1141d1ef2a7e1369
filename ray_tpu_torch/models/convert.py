"""Carry weights from the reference's flax parameter trees into the
port's ``state_dict``s, one function per model family.

The tree comes in as nested dicts of numpy arrays (the caller turns the
JAX arrays into numpy), so this module never imports JAX.  Each port's
module tree mirrors its flax tree name for name, so one mapping carries
every family leaf by leaf (``state_dict_from_jax``); the ViT, MLP and
MoE converters are that function under their family's name.  The
tensors stay float32; ``load_state_dict`` casts them once to each
parameter's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.llama import LlamaConfig


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a.b.c": leaf} for a nested mapping of arrays."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flat(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax tree carried across leaf by leaf: a 2-D Dense kernel [in,
    out] -> ``Linear.weight`` [out, in]; a 4-D Conv kernel HWIO -> OIHW;
    the attention's 3-D kernels ([D, H, Dh] for query/key/value, [H, Dh,
    D] for ``out``) -> ``Linear`` weights over the flattened heads, their
    [H, Dh] biases flattened; ``Embed.embedding`` and a norm's ``scale``
    -> ``weight``; every other leaf (BatchNorm's running ``mean`` and
    ``var``, the ViT's tokens, the stacked experts) as it is."""
    sd: Dict[str, torch.Tensor] = {}
    for name, a in _flat(tree).items():
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 3:
                a = (a.reshape(-1, a.shape[-1]) if module.rpartition(".")[2] == "out"
                     else a.reshape(a.shape[0], -1)).T
            elif a.ndim == 2:
                a = a.T
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf == "bias":
            a = a.reshape(-1)
        sd[f"{module}.{leaf}" if module else leaf] = _t(np.ascontiguousarray(a))
    return sd


def _check_table(name: str, table: Any, shape: tuple) -> None:
    if np.shape(table) != shape:
        raise ValueError(f"{name} is {np.shape(table)}, config wants {shape}")


def gpt2_state_dict_from_jax(tree: Mapping[str, Any], cfg: GPT2Config) -> Dict[str, torch.Tensor]:
    """The port's ``GPT2`` state_dict from the reference's parameter tree."""
    _check_table("wte", tree["wte"]["embedding"], (cfg.vocab_size, cfg.d_model))
    return state_dict_from_jax(tree)


def llama_state_dict_from_jax(tree: Mapping[str, Any],
                              cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's ``Llama`` state_dict from the reference's parameter tree."""
    _check_table("token_embed", tree["token_embed"]["embedding"],
                 (cfg.vocab_size, cfg.d_model))
    return state_dict_from_jax(tree)


def resnet_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``ResNet`` state_dict, parameters and running-statistics
    buffers, from the reference's variables (``params`` and
    ``batch_stats``)."""
    return {**state_dict_from_jax(variables["params"]), **state_dict_from_jax(variables["batch_stats"])}


vit_state_dict_from_jax = state_dict_from_jax
mlp_state_dict_from_jax = state_dict_from_jax
moe_state_dict_from_jax = state_dict_from_jax


def rl_module_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``RLModule`` state_dict from the reference's RLModule
    ``params`` (its ``_PiVfNet``: ``pi_*``/``vf_*`` Dense and Conv
    layers, the heads, ``log_std`` for continuous actions)."""
    return state_dict_from_jax(params)


def q_module_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``QModule`` state_dict from the reference's ``_QNet``
    ``params`` (``q_dense_*``, ``adv_head``, ``val_head``)."""
    return state_dict_from_jax(params)


def _check_against(name: str, sd: Mapping[str, torch.Tensor], module: torch.nn.Module) -> None:
    """Refuse a converted state_dict that misses a leaf of ``module``, has
    one it lacks, or has a leaf of another shape."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{name}: missing leaves {missing}, unexpected leaves {extra}")
    for k, shape in want.items():
        if got[k] != shape:
            raise ValueError(f"{name}: {k} is {got[k]}, the module wants {shape}")


def sac_from_flax(state: Mapping[str, Any], spec, hidden) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's SAC state_dicts (``pi``, ``q``, ``target_q``) from the
    reference's ``SACLearner.get_state()``: the squashed-Gaussian policy
    (``pi_dense_*``, ``pi_mean``, ``pi_log_std``) and the twin critics
    (``q1_*``, ``q2_*``) and their target, each held to the port's module
    for ``spec`` (observation and action widths) and ``hidden``."""
    from ray_tpu_torch.rllib.algorithms.sac import _SquashedGaussianPi, _TwinQ

    with torch.device("meta"):
        pi = _SquashedGaussianPi(spec.observation_dim, tuple(hidden), spec.action_dim)
        q = _TwinQ(spec.observation_dim, spec.action_dim, tuple(hidden))
    out = {}
    for key, module in (("pi", pi), ("q", q), ("target_q", q)):
        out[key] = state_dict_from_jax(state[key])
        _check_against(f"sac {key}", out[key], module)
    return out


_GRU_GATES = {"ir": ("kernel", "bias"), "iz": ("kernel", "bias"), "in": ("kernel", "bias"),
              "hr": ("kernel",), "hz": ("kernel",), "hn": ("kernel", "bias")}


def _gru_from_flax(tree: Mapping[str, Any], in_dim: int, hidden: int) -> Dict[str, torch.Tensor]:
    """flax's ``GRUCell`` (input kernels and biases ``ir``, ``iz``,
    ``in``; hidden kernels ``hr``, ``hz``, ``hn``, a bias on ``hn`` only)
    as ``nn.GRUCell``'s gate-stacked (r, z, n) tensors: ``bias_ih`` is
    [b_ir, b_iz, b_in] and ``bias_hh`` [0, 0, b_hn]."""
    leaves = {g: tuple(sorted(v)) for g, v in tree.items()}
    want = {g: tuple(sorted(ks)) for g, ks in _GRU_GATES.items()}
    if leaves != want:
        raise ValueError(f"gru: leaves {leaves}, flax's GRUCell has {want}")
    for g, ks in _GRU_GATES.items():
        _check_table(f"gru.{g}.kernel", tree[g]["kernel"], (in_dim if g[0] == "i" else hidden, hidden))
        if "bias" in ks:
            _check_table(f"gru.{g}.bias", tree[g]["bias"], (hidden,))
    k = {g: np.asarray(tree[g]["kernel"], np.float32) for g in _GRU_GATES}
    b = {g: np.asarray(tree[g]["bias"], np.float32) for g in ("ir", "iz", "in", "hn")}
    zeros = np.zeros(hidden, np.float32)
    return {
        "weight_ih": _t(np.concatenate([k[g].T for g in ("ir", "iz", "in")])),
        "weight_hh": _t(np.concatenate([k[g].T for g in ("hr", "hz", "hn")])),
        "bias_ih": _t(np.concatenate([b[g] for g in ("ir", "iz", "in")])),
        "bias_hh": _t(np.concatenate([zeros, zeros, b["hn"]])),
    }


def dreamer_from_flax(state: Mapping[str, Any], cfg, obs_dim: int,
                      n_actions: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's DreamerV3 state_dicts (``wm``, ``actor``, ``critic``,
    ``target_critic``) from the reference's ``DreamerV3Learner.get_state()``:
    the world model's MLPs (``d{i}``, ``LayerNorm_{i}``, ``out``) leaf by
    leaf, its GRU by ``_gru_from_flax``; each held to the port's modules
    for ``cfg``, ``obs_dim`` and ``n_actions``."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _MLP, _RSSMNets

    with torch.device("meta"):
        nets = _RSSMNets(cfg, obs_dim, n_actions)
        actor = _MLP(nets.feat_dim, cfg.hidden, n_actions)
        critic = _MLP(nets.feat_dim, cfg.hidden, 1)
    wm = {}
    for key, tree in state["wm"].items():
        sd = (_gru_from_flax(tree, nets.gru.input_size, nets.gru.hidden_size) if key == "gru"
              else state_dict_from_jax(tree))
        wm.update({f"{key}.{k}": v for k, v in sd.items()})
    _check_against("dreamer wm", wm, nets)
    out = {"wm": wm}
    for key, module in (("actor", actor), ("critic", critic), ("target_critic", critic)):
        out[key] = state_dict_from_jax(state[key])
        _check_against(f"dreamer {key}", out[key], module)
    return out
