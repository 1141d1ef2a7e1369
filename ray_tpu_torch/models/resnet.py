"""ResNet for CIFAR in PyTorch (port of ``ray_tpu/models/resnet.py``):
basic and bottleneck blocks with BatchNorm, float32 params with bfloat16
compute by default.

It takes NHWC images, as the reference does, and computes on NCHW
tensors kept in ``torch.channels_last`` memory (the same bytes as NHWC)
with cuDNN's convolutions: the reference's convolutions and BatchNorm are
XLA ops, not Pallas kernels.  The module tree mirrors the flax tree name
for name (``stem``, ``stem_bn``, ``stage{i}_block{j}.{Conv_n,
BatchNorm_n, proj, proj_bn}``, ``head``), with each BatchNorm's running
``mean`` and ``var`` as buffers, so ``models/convert.py`` carries
``params`` and ``batch_stats`` across key by key.

Parity with the reference, each visible below: "SAME" padding of a
stride-2 3x3 conv on an even size is 0 before and 1 after
(``models/common.py`` ``Conv``); BatchNorm normalises a training batch by
its own mean and biased variance in float32 (torch's fused batch norm),
eps 1e-5, the result in the compute dtype, and updates the running statistics as flax's
does, ``momentum * running + (1 - momentum) * batch`` with the biased
variance (``torch.nn.BatchNorm2d`` would fold in the unbiased one), so the
port keeps its own, with the blocks' ``momentum=0.9`` and the stem's flax
default of 0.99; the last BatchNorm of each block starts at a zero
scale; the head follows a global mean over H and W; the loss is
``log_softmax`` in float32 against one-hot labels.

``loss_fn`` returns the new running statistics beside the loss, as the
reference's does, without writing them; ``make_train_step`` writes them
into the buffers after the optimizer's step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import common

_BN_EPS = 1e-5  # flax.linen.BatchNorm default
# flax's running = momentum * running + (1 - momentum) * batch: the blocks
# pass momentum=0.9; the stem's BatchNorm keeps flax's default, 0.99
_BN_MOMENTUM = 0.9
_STEM_BN_MOMENTUM = 0.99


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)  # resnet18
    num_filters: int = 64
    num_classes: int = 10
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bottleneck: bool = False

    @staticmethod
    def resnet18(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True, **kw)


Stats = Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum)`` over the channels of an NCHW
    tensor, float32 statistics and scale, the result in the input's dtype.
    ``forward(x, stats)``: with ``stats`` (training) it normalises by the
    batch's statistics and records the new running ones in
    ``stats[self]``; with ``None`` it normalises by the running ones."""

    def __init__(self, c: int, cfg: ResNetConfig, zero_scale: bool = False,
                 momentum: float = _BN_MOMENTUM):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(c, dtype=cfg.param_dtype))
        self.register_buffer("mean", torch.zeros(c, dtype=torch.float32))
        self.register_buffer("var", torch.ones(c, dtype=torch.float32))
        self.zero_scale = zero_scale
        self.momentum = momentum

    def forward(self, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
        if stats is None:
            return F.batch_norm(x, self.mean, self.var, self.weight, self.bias, False, 0.0,
                                _BN_EPS)
        # torch's fused batch norm (cuDNN on the card) normalises by the
        # batch's mean and biased variance in float32 and returns them as
        # (mean, 1 / sqrt(var + eps)); it takes the variance by Welford,
        # where flax takes E[x^2] - E[x]^2: the same value to float32
        # rounding.  Given no running buffers, it updates none.
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, _BN_EPS)
        var = invstd.detach().pow(-2) - _BN_EPS
        m = self.momentum
        stats[self] = (m * self.mean + (1 - m) * mean.detach(), m * self.var + (1 - m) * var)
        return y


def _conv(c_in: int, c_out: int, k: int, cfg: ResNetConfig, stride: int = 1) -> common.Conv:
    return common.Conv(c_in, c_out, k, stride, cfg.dtype, cfg.param_dtype)


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, cfg: ResNetConfig, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(c_in, filters, 3, cfg, stride)
        self.BatchNorm_0 = BatchNorm(filters, cfg)
        self.Conv_1 = _conv(filters, filters, 3, cfg)
        self.BatchNorm_1 = BatchNorm(filters, cfg, zero_scale=True)
        self.has_proj = stride != 1 or c_in != filters
        if self.has_proj:
            self.proj = _conv(c_in, filters, 1, cfg, stride)
            self.proj_bn = BatchNorm(filters, cfg)

    def forward(self, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = self.BatchNorm_1(self.Conv_1(y), stats)
        residual = self.proj_bn(self.proj(x), stats) if self.has_proj else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, cfg: ResNetConfig, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(c_in, filters, 1, cfg)
        self.BatchNorm_0 = BatchNorm(filters, cfg)
        self.Conv_1 = _conv(filters, filters, 3, cfg, stride)
        self.BatchNorm_1 = BatchNorm(filters, cfg)
        self.Conv_2 = _conv(filters, 4 * filters, 1, cfg)
        self.BatchNorm_2 = BatchNorm(4 * filters, cfg, zero_scale=True)
        self.has_proj = stride != 1 or c_in != 4 * filters
        if self.has_proj:
            self.proj = _conv(c_in, 4 * filters, 1, cfg, stride)
            self.proj_bn = BatchNorm(4 * filters, cfg)

    def forward(self, x: torch.Tensor, stats: Optional[Stats]) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(self.Conv_2(y), stats)
        residual = self.proj_bn(self.proj(x), stats) if self.has_proj else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.stem = _conv(3, cfg.num_filters, 3, cfg)
        self.stem_bn = BatchNorm(cfg.num_filters, cfg, momentum=_STEM_BN_MOMENTUM)
        block = BottleneckBlock if cfg.bottleneck else ResNetBlock
        c = cfg.num_filters
        self.blocks = []
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blk = block(c, cfg.num_filters * 2**i, cfg, stride)
                self.add_module(f"stage{i}_block{j}", blk)
                self.blocks.append(blk)
                c = cfg.num_filters * 2**i * block.expansion
        self.head = common.Linear(c, cfg.num_classes, True, cfg.dtype, cfg.param_dtype)

    def forward(self, x: torch.Tensor, train: bool = True):
        """x [B, H, W, 3] (NHWC) -> logits [B, classes] in the compute
        dtype; with ``train``, (logits, new running statistics by
        state_dict name), as the reference's ``apply(...,
        mutable=["batch_stats"])``."""
        stats: Optional[Stats] = {} if train else None
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.stem_bn(self.stem(x), stats))
        for blk in self.blocks:
            x = blk(x, stats)
        logits = self.head(x.mean((2, 3)))
        if not train:
            return logits
        new = {}
        for name, mod in self.named_modules():
            if mod in stats:
                new[f"{name}.mean"], new[f"{name}.var"] = stats[mod]
        return logits, new


def init_model(cfg: ResNetConfig, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda") -> ResNet:
    """Synthetic weights from ``generator`` (``models/common.py``
    ``init_model``: std 1/sqrt(fan_in) for the convolutions and the head,
    unit BatchNorm scales but a zero scale on each block's last one), zero
    running means and unit running variances, on ``device`` (the card
    unless the caller asks for the CPU)."""
    model = common.init_model(lambda: ResNet(cfg), generator, device)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.mean.zero_()
                mod.var.fill_(1.0)
                if mod.zero_scale:
                    mod.weight.zero_()
    return model


def loss_fn(model: ResNet, x: torch.Tensor, y: torch.Tensor):
    """(cross entropy of the float32 log-softmax against one-hot labels,
    the new running statistics), the model in training mode."""
    logits, new_stats = model(x, train=True)
    return common.one_hot_loss(logits.float(), y, model.cfg.num_classes), new_stats


def make_train_step(cfg: ResNetConfig, optimizer: torch.optim.Optimizer):
    """step(model, x, y) -> loss: one optimizer step of ``model`` in place,
    then its running statistics replaced by the step's new ones, as the
    reference's step returns them; ``model`` must be built from ``cfg``."""

    def step(model: ResNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError(f"model built from {model.cfg}, step made for {cfg}")
        optimizer.zero_grad(set_to_none=True)
        loss, new_stats = loss_fn(model, x, y)
        loss.backward()
        optimizer.step()
        buffers = dict(model.named_buffers())
        with torch.no_grad():
            for name, value in new_stats.items():
                buffers[name].copy_(value)
        return loss.detach()

    return step


num_params = common.num_params
