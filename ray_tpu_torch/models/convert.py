"""Carry GPT-2 weights from the reference's flax parameter tree into the
port's ``state_dict``.

The tree comes in as nested dicts of numpy arrays (the caller turns the
JAX arrays into numpy), so this module never imports JAX.  Names map one
to one (``models/gpt2.py``); flax ``Dense.kernel`` ``[in, out]`` becomes
``Linear.weight`` ``[out, in]``, ``Embed.embedding`` becomes
``Embedding.weight`` and LayerNorm ``scale`` becomes ``weight``.  The
tensors stay float32; ``GPT2.load_state_dict`` casts them once to the
serving dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.gpt2 import GPT2Config


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(into: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    into[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        into[f"{prefix}.bias"] = _t(p["bias"])


def _layer_norm(into: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    into[f"{prefix}.weight"] = _t(p["scale"])
    into[f"{prefix}.bias"] = _t(p["bias"])


def gpt2_state_dict_from_jax(tree: Mapping[str, Any], cfg: GPT2Config) -> Dict[str, torch.Tensor]:
    """The port's ``GPT2`` state_dict from the reference's parameter tree."""
    wte = np.asarray(tree["wte"]["embedding"])
    if wte.shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(
            f"wte is {wte.shape}, config wants {(cfg.vocab_size, cfg.d_model)}"
        )
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": _t(wte),
        "wpe.weight": _t(tree["wpe"]["embedding"]),
    }
    for i in range(cfg.n_layer):
        blk = tree[f"h_{i}"]
        p = f"h_{i}"
        _layer_norm(sd, f"{p}.ln_1", blk["ln_1"])
        _dense(sd, f"{p}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{p}.attn.attn_out", blk["attn"]["attn_out"])
        _layer_norm(sd, f"{p}.ln_2", blk["ln_2"])
        _dense(sd, f"{p}.mlp.mlp_up", blk["mlp"]["mlp_up"])
        _dense(sd, f"{p}.mlp.mlp_down", blk["mlp"]["mlp_down"])
    _layer_norm(sd, "ln_f", tree["ln_f"])
    _dense(sd, "lm_head", tree["lm_head"])
    return sd
