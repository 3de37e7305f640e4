"""Train steps over a mesh: the data-parallel step with int8 gradient
compression (PyTorch port of `repro.training.dp_step`) and the sharded
step of `launch/train.py --mesh` (the JAX launcher's jitted step over
sharded state, `src/repro/launch/train.py:51-72`).

`make_dp_train_step_compressed`: parameters and optimizer state are
replicated (plain tensors, the same on every rank); the batch is split
over the mesh's data axes. Each rank runs `loss_fn` and backward on its
slice, the gradients are summed over each data axis with
`compressed_psum` (int8 codes and one scale a leaf, stochastic rounding;
`compress=False` gives the exact all_reduce twin for A/B tests) and
divided by the shard count, the loss is averaged, and AdamW runs
replicated. As in JAX, loss and gradients are the mean of the ranks'
per-slice means. This is the pattern for DCN-limited multi-pod gradient
sync (the `pod` axis of the production mesh).

`make_sharded_train_step`: see its docstring. Both steps sum over the
data axes with `sum_over_data`.

Correctness: tests/test_torch_dp_step.py holds the exact twin and the
sharded step to the single-device step and the compressed step's loss to
the exact one's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding_ctx import (
    data_groups,
    local_batch,
    local_shard,
    set_parameter,
)
from repro_torch.training.compression import compressed_psum
from repro_torch.training.optimizer import (
    OptimizerConfig,
    adamw_update,
    global_norm,
)
from repro_torch.training.train_loop import TrainState, loss_and_grads


def sum_over_data(grads: dict, scalars: torch.Tensor, groups,
                  generator: torch.Generator | None = None) -> tuple:
    """(grads, scalars) summed over each data group in turn: the scalars
    by an exact all_reduce in place, the gradients by `compressed_psum`
    with `generator`'s noise, or in place by an exact all_reduce when
    `generator` is None."""
    for group in groups:
        dist.all_reduce(scalars, group=group)
        if generator is not None:
            grads = compressed_psum(grads, group, generator)
        else:
            for g in grads.values():
                dist.all_reduce(g, group=group)
    return grads, scalars


def make_dp_train_step_compressed(cfg: ModelConfig, opt: OptimizerConfig,
                                  mesh, *, compress: bool = True):
    """Build the DP step over `mesh` (a DeviceMesh). Returns fn(state,
    batch, generator) -> (state, {"loss", "lr", "grad_norm"}): `batch` is
    the global batch, `generator` this rank's noise (unused when
    `compress=False`)."""
    groups, n_shards = data_groups(mesh)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        params = state.params
        loss, _, grads = loss_and_grads(params, cfg, local_batch(batch, mesh))
        grads, loss = sum_over_data(grads, loss, groups,
                                    generator if compress else None)
        grads = {n: g / n_shards for n, g in grads.items()}
        params.zero_grad(set_to_none=True)
        params, opt_state, opt_metrics = adamw_update(
            opt, grads, state.opt_state, params)
        return (TrainState(params=params, opt_state=opt_state),
                {"loss": loss / n_shards, **opt_metrics})

    return step


def make_sharded_train_step(cfg: ModelConfig, opt: OptimizerConfig, mesh,
                            grad_accum: int = 1):
    """The sharded step over `mesh` (a DeviceMesh) on a state whose
    parameters and moments are DTensors (`launch.shardings
    .shard_train_state`). Returns fn(state, global batch) -> (state,
    metrics): the single-device step's metrics over the global batch.

    Each step all-gathers every parameter into the model as a plain
    tensor, runs `loss_and_grads` on the rank's rows of each microbatch
    (`local_batch`), all-reduces the gradients over the data axes, takes
    the global norm from the full gradients and updates each local shard.
    Each rank's loss is weighted by its share of its microbatch's valid
    labels (the counts all-reduced first), so loss and gradients are one
    mean over the global microbatch's valid labels, as JAX's jitted step
    takes it, also when ranks hold unequal numbers of masked labels.
    (The MoE aux loss has no such split; MoE is refused under a mesh.)

    Cost: between steps a rank holds its shards only, but within a step
    it holds the full float32 parameters and the full float32 gradients
    besides, whatever the mesh's size; so a config whose float32
    parameters and gradients do not fit on one device does not train
    here. All-reducing full gradients moves about twice the bytes a
    reduce-scatter onto the local shards would (ROADMAP A9 queues both
    fixes). The ranks of a model axis repeat the same compute."""
    groups, _ = data_groups(mesh)
    coord = mesh.get_coordinate()

    def step(state: TrainState, batch: dict):
        model, opt_state = state
        shards = dict(model.named_parameters())
        local = local_batch(batch, mesh, grad_accum)
        dev = next(iter(shards.values())).to_local().device
        valid = (local["labels"].reshape(grad_accum, -1) >= 0).sum(1).to(
            dev, torch.float32)
        total = valid.clone()
        for group in groups:
            dist.all_reduce(total, group=group)
        weights = valid / total.clamp(min=1.0)
        with torch.no_grad():
            full = {n: nn.Parameter(p.full_tensor(), requires_grad=True)
                    for n, p in shards.items()}
        for n, p in full.items():
            set_parameter(model, n, p)
        try:
            loss, metrics, grads = loss_and_grads(model, cfg, local,
                                                  grad_accum, weights)
        finally:
            for n, p in shards.items():
                set_parameter(model, n, p)
        del full
        grads, scalars = sum_over_data(
            grads, torch.stack([loss, *metrics.values()]), groups)
        gnorm = global_norm(grads.values())
        local_grads = {
            n: local_shard(g, mesh, shards[n].placements, coord)
            for n, g in grads.items()}
        moments = {k: {n: t.to_local() for n, t in opt_state[k].items()}
                   for k in ("m", "v")}
        _, new, opt_metrics = adamw_update(
            opt, local_grads, {**moments, "step": opt_state["step"]},
            {n: p.to_local() for n, p in shards.items()}, grad_norm=gnorm)
        del grads, local_grads
        metrics = (dict(zip(["loss", *metrics], scalars.unbind()))
                   | opt_metrics)
        return (TrainState(model, {"m": opt_state["m"], "v": opt_state["v"],
                                   "step": new["step"]}), metrics)

    return step
