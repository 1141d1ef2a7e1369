"""GSPMD execution plan: mesh construction + DTensor-sharded steps (port of
``ray_tpu/train/sharding/gspmd.py``).

``build_plan(config)`` turns a :class:`ShardingConfig` into a
:class:`GspmdPlan` bound to a concrete ``DeviceMesh``.  The plan owns the
three recipes of the reference's pjit path:

* ``shard_init``  — the model's parameters and the optimizer's moments as
  DTensors on the mesh with the rule layout, from the same draws as the
  unsharded init;
* ``jit_train_step`` — the step over those DTensors with the batch laid
  over the ``batch`` axis and the loss replicated (eager: no
  ``torch.compile``; DTensor dispatch inserts the collectives XLA would);
* ``save_checkpoint`` / ``load_checkpoint`` — per-shard persistence that
  re-shards onto the CURRENT mesh at load, which makes the elastic
  resize path a plain restore.

The reference's state is a pytree of arrays its step returns anew; here
the model and the optimizer are updated in place, and ``train_state``
names their tensors as the tree a checkpoint holds.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

from ray_tpu_torch.train.sharding.rules import ShardingConfig, match_partition_rules


def build_mesh(config: ShardingConfig, devices: Optional[Sequence[int]] = None,
               device_type: str = "cuda"):
    """``DeviceMesh`` with the config's axes over ``devices`` (global
    ranks; default every rank of the default process group, which under a
    ``TorchTrainer`` spans the whole worker group, and is formed at world
    size one for a lone process)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import create_mesh, ensure_process_group

    ensure_process_group(device_type)
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    shape = config.resolve_shape(len(devices))
    # create_mesh orders known dp/tp-style axes first; batch/model are
    # unknown to AXIS_ORDER so dict order (config.mesh order) is kept.
    ordered = {a: shape[a] for a in config.mesh}
    return create_mesh(ordered, devices, device_type=device_type)


class GspmdPlan:
    """A ShardingConfig bound to a mesh; every tensor of the step is a
    DTensor with placements from the config's rules."""

    def __init__(self, config: ShardingConfig, mesh):
        self.config = config
        self.mesh = mesh

    # -- specs ----------------------------------------------------------
    def param_specs(self, params: Any) -> Any:
        """Spec tree for a parameter tree (or a module's parameters)."""
        return match_partition_rules(self.config.rules(), params, self.mesh)

    def param_placements(self, params: Any) -> Any:
        from ray_tpu_torch.parallel.sharding import spec_to_placements, tree_map

        return tree_map(lambda s: spec_to_placements(s, self.mesh), self.param_specs(params))

    def data_sharding(self):
        """[batch, ...] tensors shard their leading dim over the batch
        axis (everything else replicated)."""
        from ray_tpu_torch.parallel.mesh import mesh_axis_size
        from ray_tpu_torch.parallel.sharding import NamedSharding

        axis = self.config.batch_axis
        return NamedSharding(self.mesh, (axis if mesh_axis_size(self.mesh, axis) > 1 else None,))

    def data_placement(self) -> list:
        return self.data_sharding().placements

    def replicated(self) -> list:
        from torch.distributed.tensor import Replicate

        return [Replicate() for _ in range(self.mesh.ndim)]

    # -- state ----------------------------------------------------------
    def shard_init(self, init_fn: Callable[[Any], Any], make_optimizer: Callable[[Any], Any],
                   generator=None) -> Tuple[Any, Any]:
        """(model, optimizer) on the mesh: ``init_fn(generator)`` builds the
        whole model on every rank (default generator: seed 0 on the mesh's
        device), so the weights are the unsharded init's for that seed;
        each rank keeps its shard of every parameter as a DTensor with the
        rule layout.  ``make_optimizer(params)`` builds the optimizer over
        them, its moments made now with the parameters' placements (the
        reference's optimizer init on the mesh) and each gradient reduced
        to its parameter's placements before a step."""
        import torch

        from ray_tpu_torch.parallel.mesh import mesh_device
        from ray_tpu_torch.parallel.sharding import shard_module, shard_optimizer

        if generator is None:
            generator = torch.Generator(device=mesh_device(self.mesh)).manual_seed(0)
        model = init_fn(generator)
        shard_module(model, self.mesh, self.param_specs(model))
        return model, shard_optimizer(make_optimizer(model.parameters()))

    def jit_train_step(self, step_fn: Callable, model: Any, optimizer: Any):
        """``step_fn(model, tokens, targets) -> loss`` (``make_train_step``'s
        kind) over a model and optimizer from ``shard_init``.  The returned
        callable lays host batches (the global batch, the same on every
        rank) over the batch axis before the step, runs it under DTensor
        dispatch, and returns the loss as a plain tensor, the same on every
        rank.  The name is the reference's; the step runs eagerly."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        from ray_tpu_torch.parallel.sharding import constrain

        for name, p in model.named_parameters():
            if not isinstance(p, DTensor) or p.device_mesh != self.mesh:
                raise ValueError(f"parameter {name} is not on this plan's mesh: "
                                 f"build the model with shard_init")
        data_sh = self.data_sharding()

        def run(model, tokens, targets):
            tokens = constrain(tokens, self.mesh, data_sh.spec)
            targets = constrain(targets, self.mesh, data_sh.spec)
            with implicit_replication():
                loss = step_fn(model, tokens, targets)
            return loss.full_tensor()

        run.data_sharding = data_sh
        return run

    # -- checkpoint -----------------------------------------------------
    def save_checkpoint(self, state: Any, path: str) -> None:
        from ray_tpu_torch.train.sharding.checkpoint import save_sharded

        save_sharded(state, path, self.mesh)

    def load_checkpoint(self, path: str, like: Any) -> Any:
        """Restore ``state`` re-sharded onto THIS plan's mesh.  ``like``
        supplies the target layout (a live state tree, e.g.
        ``train_state`` of a fresh ``shard_init``); the saved mesh may have
        had a different size — shards are reassembled host-side and
        re-placed."""
        from ray_tpu_torch.train.sharding.checkpoint import load_sharded

        return load_sharded(path, like)


def train_state(model: Any, optimizer: Any) -> dict:
    """The tree a checkpoint holds: ``{"params": {name: parameter},
    "opt": {name: {state key: tensor}}}``, the live tensors of ``model``
    and of ``optimizer``'s per-parameter state (AdamW's ``exp_avg``,
    ``exp_avg_sq`` and ``step``)."""
    params = dict(model.named_parameters())
    return {"params": params,
            "opt": {name: dict(optimizer.state[p]) for name, p in params.items()
                    if optimizer.state.get(p)}}


def set_train_state(model: Any, optimizer: Any, state: dict) -> None:
    """Copy a ``train_state``-shaped tree (say, from ``load_checkpoint``)
    into ``model`` and ``optimizer`` in place."""
    import torch

    from ray_tpu_torch.parallel.sharding import tree_leaves

    with torch.no_grad():
        for dst, src in zip(tree_leaves(train_state(model, optimizer)), tree_leaves(state)):
            dst.copy_(src)


def build_plan(config: Optional[ShardingConfig] = None, devices: Optional[Sequence[int]] = None,
               device_type: str = "cuda") -> GspmdPlan:
    config = config or ShardingConfig()
    return GspmdPlan(config, build_mesh(config, devices, device_type))


def plan_from_context(device_type: str = "cuda") -> GspmdPlan:
    """Inside ``train_loop_per_worker``: bind the trainer's ShardingConfig
    to the CURRENT process group (which spans the whole worker group;
    under elastic training it changes per generation, so call this on
    every loop (re)entry).  The mesh is on the cards unless
    ``device_type="cpu"``."""
    from ray_tpu_torch.train.context import get_context

    config = get_context().get_sharding_config()
    if config is None:
        raise RuntimeError(
            "this run has no ShardingConfig — pass "
            "TorchTrainer(..., sharding_config=ShardingConfig(...))"
        )
    return build_plan(config, device_type=device_type)
