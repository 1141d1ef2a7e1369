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
