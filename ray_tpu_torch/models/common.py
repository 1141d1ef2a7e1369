"""Shared training scaffolding for the model families (port of
``ray_tpu/models/common.py``: the loss, the train step, the parameter
count), and the layers and initialiser the families share.

The reference's step is pure: it returns new params and optimizer state.
Here the model and the optimizer are updated in place, which keeps one
copy of the weights and of the AdamW moments on the card.  The sharded
recipes (``make_sharded_train_state``, ``make_sharded_train_step``) put
the parameters and the moments on a ``DeviceMesh`` as DTensors with the
Megatron layout of ``parallel/sharding.py``, and lay each batch over the
batch (and sequence) axes; DTensor dispatch inserts the collectives.

``Linear`` and ``Embedding`` store their weights in ``param_dtype`` and
compute in ``dtype``, as flax's ``Dense(dtype, param_dtype)`` and
``Embed`` do; ``init_model`` builds a model on its device without the
default initialisers and draws its weights at the scales of flax's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device


class Linear(nn.Linear):
    """``nn.Linear`` stored in ``param_dtype``, computing in ``dtype`` (the
    cast is a no-op when the two agree)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__(d_in, d_out, bias=bias, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x, self.weight.to(self.compute_dtype), bias)


class Embedding(nn.Embedding):
    """``nn.Embedding`` stored in ``param_dtype``; the gathered rows are
    cast to ``dtype`` (the same values as casting the table)."""

    def __init__(self, n: int, d: int, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__(n, d, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        out = F.embedding(idx, self.weight)
        if type(out) is not torch.Tensor:  # a DTensor: a vocab-sharded table's
            out = _reduce_partial(out)     # rows arrive as masked partial sums
        return out.to(self.compute_dtype)


def split_heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    """[..., n_head * d] -> [..., n_head, d] (a view of a plain tensor).  A
    DTensor sharded on its last dim over mesh dims whose sizes do not
    divide the heads is first gathered on those dims: a view cannot split
    one rank's shard across heads (GSPMD would, the reference never asks)."""
    if type(t) is not torch.Tensor:
        from torch.distributed.tensor import Replicate, Shard

        last = t.ndim - 1
        over = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == last]
        if n_head % math.prod(t.device_mesh.size(i) for i in over):
            t = t.redistribute(t.device_mesh, [Replicate() if i in over else p
                                               for i, p in enumerate(t.placements)])
    return t.unflatten(-1, (n_head, t.shape[-1] // n_head))


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[..., n_head, d] -> [..., n_head * d].  A DTensor merges its local
    heads and keeps its placements (a head shard is a shard of the merged
    dim), so the backward never views a gradient sharded on the merged dim
    as heads it may not divide into."""
    if type(t) is torch.Tensor:
        return t.flatten(-2)
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import contiguous_stride

    shape = (*t.shape[:-2], t.shape[-2] * t.shape[-1])
    return DTensor.from_local(t.to_local().flatten(-2), t.device_mesh, t.placements,
                              run_check=False, shape=shape, stride=contiguous_stride(shape))


def _reduce_partial(t):
    """A DTensor with its partial placements summed (Megatron's all-reduce
    after a vocab-parallel embedding): DTensor reduces the masked partial
    rows of a sharded table only to ``Replicate``, not on into a shard."""
    from torch.distributed.tensor import Partial, Replicate

    if any(isinstance(p, Partial) for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                           for p in t.placements])
    return t


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dimension: the output has
    ceil(size / stride) positions and the padding they need is split with
    the odd one after (a 3x3 stride-2 conv on an even size pads 0 before
    and 1 after, where torch's padding=1 would pad 1 and 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW tensors (the callers keep them in
    ``torch.channels_last`` memory, the reference's NHWC): a k x k kernel
    stored ``[out, in, k, k]`` in ``param_dtype`` (channels-last) and cast
    to ``dtype`` on every call, "SAME" or "VALID" padding, an optional
    bias."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, padding: str = "SAME", bias: bool = False):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k, dtype=param_dtype,
                                               memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.empty(c_out, dtype=param_dtype)) if bias else None
        self.k, self.stride, self.padding, self.compute_dtype = k, stride, padding, dtype

    @property
    def in_features(self) -> int:  # fan-in, for init_model
        return self.weight.shape[1] * self.k * self.k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = 0
        if self.padding == "SAME":
            (top, bottom), (left, right) = (_same_pads(n, self.k, self.stride)
                                            for n in x.shape[2:])
            if (top, left) == (bottom, right):
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.conv2d(x, self.weight.to(self.compute_dtype), bias, self.stride, pad)


class _SkipDefaultInit(torch.overrides.TorchFunctionMode):
    """Skips ``torch.nn.init``'s initialisers (each returns its tensor
    untouched) while a module is built whose weights are drawn or loaded
    afterwards.  On the meta device they compute nothing, and their meta
    path (like ``empty_like`` of a meta tensor) imports ``torch._dynamo``
    and sympy: 8 to 10 s in a fresh process on the card machine."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__module__", None) == "torch.nn.init":
            return args[0] if args else kwargs["tensor"]
        return func(*args, **kwargs)


def meta_build(build: Callable[[], nn.Module]) -> nn.Module:
    """``build()`` on the meta device, its modules' default initialisers
    skipped: shapes and dtypes, no storage."""
    with torch.device("meta"), _SkipDefaultInit():
        return build()


def init_model(build: Callable[[], nn.Module], generator: Optional[torch.Generator],
               device: Union[str, torch.device]) -> nn.Module:
    """``build()`` on ``device`` with the default initialisers skipped
    (the parameters' storage is allocated there once, uninitialised),
    then synthetic weights from ``generator``: normal draws with std
    1/sqrt(fan_in) for ``Linear`` weights and 1/sqrt(d) for ``Embedding``
    rows, zero ``Linear`` biases; every other module's own ``weight`` is
    set to 1 and ``bias`` to 0 (the norms).  ``Conv`` kernels draw as
    ``Linear`` weights, with fan-in in x k x k.  Draws are in float32, cast
    once to each parameter's dtype, in module order.  Parameters that are
    no module's ``weight`` or ``bias`` are left for the caller to set.
    Returns the model in eval mode."""
    dev = resolve_device(device)
    with torch.device(dev), _SkipDefaultInit():
        model = build()
    gen_dev = generator.device if generator is not None else dev
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Embedding):
                std = 1.0 / math.sqrt(mod.embedding_dim)
            elif isinstance(mod, (nn.Linear, Conv)):
                std = 1.0 / math.sqrt(mod.in_features)
                if mod.bias is not None:
                    mod.bias.zero_()
            else:
                for name, p in mod.named_parameters(recurse=False):
                    if name in ("weight", "bias"):
                        p.fill_(1.0 if name == "weight" else 0.0)
                continue
            mod.weight.copy_(normal(mod.weight.shape, std, generator, gen_dev))
    return model.eval()


def normal(shape, std: float, generator: Optional[torch.Generator],
           device: Union[str, torch.device]) -> torch.Tensor:
    """float32 normal draws of ``std`` from ``generator``."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * std


def next_token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy in logsumexp form, in float32: mean over positions
    of logsumexp(logits) - logits[target]."""
    # [..., 1] until the mean: a vocab-sharded DTensor's gather is a
    # masked partial sum, which DTensor reduces only at the gather's shape
    lse = torch.logsumexp(logits.float(), dim=-1, keepdim=True)
    tgt = logits.gather(-1, targets[..., None].long())
    return (lse - tgt.float()).mean()


def make_train_step(loss_fn: Callable, cfg: Any, optimizer: torch.optim.Optimizer):
    """train_step(model, tokens, targets) -> loss for a
    loss_fn(model, tokens, targets).  The reference's step passes ``cfg``
    to its loss_fn to build the model from; a module carries its own, so
    here the step refuses a model built from another config before any
    update.

    Each call computes the loss and its gradients and takes one optimizer
    step, updating ``model``'s parameters and ``optimizer``'s state in
    place.  The loss comes back as a detached tensor on the model's device,
    with no host sync: read it with ``.item()`` when it is needed."""

    def train_step(model: nn.Module, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError(f"model built from {model.cfg}, step made for {cfg}")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_sharded_train_state(init_fn: Callable[[Optional[torch.Generator]], nn.Module], mesh,
                             make_optimizer: Callable[[Any], torch.optim.Optimizer],
                             rules=None, generator: Optional[torch.Generator] = None):
    """Build the model with ``init_fn(generator)`` (the whole model on
    every rank, the same draws as an unsharded init from that generator;
    default seed 0 on the mesh's device), then keep each rank's shard of
    every parameter as a DTensor with the layout of ``parallel/sharding.py``
    (``gpt_sharding_rules`` unless ``rules`` is given) and build the
    optimizer over them with ``make_optimizer(params)``, its moments
    following the parameters' placements.  Returns (model, optimizer,
    specs)."""
    from ray_tpu_torch.parallel.mesh import mesh_device
    from ray_tpu_torch.parallel.sharding import (gpt_sharding_rules, infer_param_spec,
                                                 shard_module, shard_optimizer)

    if generator is None:
        generator = torch.Generator(device=mesh_device(mesh)).manual_seed(0)
    rules = rules if rules is not None else gpt_sharding_rules()
    model = init_fn(generator)
    specs = infer_param_spec(model, rules, mesh)
    shard_module(model, mesh, specs)
    return model, shard_optimizer(make_optimizer(model.parameters())), specs


def make_sharded_train_step(step_fn: Callable, mesh):
    """run(model, tokens, targets) -> loss for a ``step_fn`` of
    ``make_train_step``'s kind over a model from
    ``make_sharded_train_state``: the batch is laid out over the mesh
    (``batch_spec``: dp and fsdp over the batch, sp over the sequence; a
    host batch is the global batch, the same on every rank, and each rank
    keeps its window), the step runs under DTensor dispatch (plain tensors
    the model makes, such as positions, count as replicated), and the loss
    comes back as a plain tensor, the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ray_tpu_torch._private import profiling
    from ray_tpu_torch.parallel.sharding import NamedSharding, batch_spec, constrain

    data_sharding = NamedSharding(mesh, batch_spec(mesh))

    def run(model: nn.Module, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        tokens = constrain(tokens, mesh, data_sharding.spec)
        targets = constrain(targets, mesh, data_sharding.spec)
        with implicit_replication():
            loss = step_fn(model, tokens, targets)
        profiling.report_device_memory()
        return loss.full_tensor()

    run.data_sharding = data_sharding
    return run


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def one_hot_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The classifiers' loss: -(one_hot(labels) * log_softmax(logits)).sum(-1)
    averaged over the batch, ``log_softmax`` in the logits' dtype (the
    callers cast first where the reference does)."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    return -(onehot * logp).sum(-1).mean()
