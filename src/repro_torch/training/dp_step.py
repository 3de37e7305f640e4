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

`make_sharded_train_step`: see its docstring; it gathers a unit at a
time and reduce-scatters the gradients (`models/fsdp.py`).

Correctness: tests/test_torch_dp_step.py holds the exact twin and the
sharded step to the single-device step and the compressed step's loss to
the exact one's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.fsdp import ShardedParams
from repro_torch.models.tensor_parallel import make_plan
from repro_torch.models.sharding_ctx import (
    data_groups,
    local_batch,
    sharding_rules,
)
from repro_torch.training.compression import compressed_psum
from repro_torch.training.optimizer import OptimizerConfig, adamw_update
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
                            grad_accum: int = 1,
                            overrides: dict | None = None):
    """The sharded step over `mesh` (a DeviceMesh) on a state whose
    parameters and moments are DTensors (`launch.shardings
    .shard_train_state`). Returns fn(state, global batch) -> (state,
    metrics): the single-device step's metrics over the global batch.
    `overrides`: rules over `DEFAULT_RULES` (the dry-run's `no_sp` is
    {"res_seq": None}).

    The model runs on the rank's rows of each microbatch (`local_batch`:
    split over the data axes, the whole sequence on every rank of the
    model axis) within `models/fsdp.py`'s `ShardedParams` and
    `sharding_rules(mesh, overrides)`: each remat unit, the embedding and
    the head gather their parameters in float32 as the forward (and a
    remat recompute) reaches them, and their backward reduce-scatters
    each gradient over the data axes onto this rank's shard (all-reduces
    a parameter replicated over them), where the microbatches' gradients
    accumulate in float32. The global norm comes from the shards
    (`ShardedParams.global_norm`), and AdamW updates each local shard.
    Each rank's cross-entropy is weighted by its share of its
    microbatch's valid labels (the counts all-reduced over the data axes
    first), so loss and gradients are one mean over the global
    microbatch's valid labels, as JAX's jitted step takes it, also when
    ranks hold unequal numbers of masked labels; a MoE block's aux loss
    is already the data rank's share of the global one (`models/moe.py`,
    both dispatch modes), the same on every model rank: each model rank
    computes its part of it and the parts are summed over "model" with an
    identity backward, so the router's gradient, summed over "model",
    counts the aux once. The labels are not split over the model axis (the
    logits are gathered over the sequence), and the scalars are summed
    over the data axes only: every model rank holds the same loss and aux.

    Every family splits its compute over the model axis
    (`models/tensor_parallel.py`): a rank computes its h/tp heads (or,
    where the kv heads do not tile the axis, its s/tp queries against the
    gathered K/V), its d_ff/tp MLP columns, a MoE block's E/tp experts on
    every token of its rows (global dispatch) or its own token slab
    (manual SPMD), a Mamba2 block's H/tp heads, an mLSTM block's di/tp
    channels and its heads (its cell whole where they do not tile), an
    sLSTM block's ff/tp columns beside the whole recurrence, and its
    padded-vocab/tp logits, and carries its s/tp slice of the residual
    between units (whole under `no_sp`).

    Cost: a rank holds its shards, one unit's gathered parameters and
    gradients at a time (two units' while a backward overlaps the next
    gather), and its activations: the residuals a tp-th of the sequence
    and the logits a tp-th of the vocabulary in the split families. Each
    parameter is gathered once a forward (again in a remat recompute or
    an unpacked saved weight) and its gradient reduce-scattered once a
    microbatch, over the data axes alone where the unit computes on its
    model shard; the split adds an all-gather and a reduce-scatter of a
    (rows, s, d) activation around each attention and MLP (K/V gathers on
    the context-parallel path), again in a recompute and in the backward.
    On a mesh whose every axis has size 1 the step is the single-device
    step, op for op."""
    groups, _ = data_groups(mesh)

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
        with sharding_rules(mesh, overrides):
            plan = make_plan(cfg, mesh)
        sharded = ShardedParams(model, mesh, plan=plan)
        with sharded, sharding_rules(mesh, overrides):
            loss, metrics, grads = loss_and_grads(
                model, cfg, local, grad_accum, weights, sharded.leaves)
        scalars = torch.stack([loss, *metrics.values()])
        for group in groups:
            dist.all_reduce(scalars, group=group)
        gnorm = sharded.global_norm(grads)
        moments = {k: {n: t.to_local() for n, t in opt_state[k].items()}
                   for k in ("m", "v")}
        _, new, opt_metrics = adamw_update(
            opt, grads, {**moments, "step": opt_state["step"]},
            {n: p.to_local() for n, p in shards.items()}, grad_norm=gnorm)
        del grads, sharded
        metrics = (dict(zip(["loss", *metrics], scalars.unbind()))
                   | opt_metrics)
        return (TrainState(model, {"m": opt_state["m"], "v": opt_state["v"],
                                   "step": new["step"]}), metrics)

    return step
