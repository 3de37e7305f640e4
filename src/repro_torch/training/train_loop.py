"""Train step construction (PyTorch port of `repro.training.train_loop`):
loss and gradients over microbatches, then AdamW.

The returned step is a (state, batch) -> (state, metrics) function, as
the JAX package's, run eagerly. Microbatches run as a Python loop: each
`backward()` adds its gradients into the parameters' `.grad`, which are
float32 because training keeps float32 master weights (the JAX package
accumulates in float32 zeros, `train_loop.py:161-175`); loss and
gradients are then averaged over the microbatches (`loss_and_grads`).
`train_state_specs` gives the logical sharding names of a TrainState;
the steps over a mesh (the sharded step of `launch/train.py --mesh` and
the int8-compressed data-parallel step) are `training/dp_step.py`'s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.models.model import AUX_LOSS_WEIGHT, loss_fn
from repro_torch.training.optimizer import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
)


class TrainState(NamedTuple):
    params: nn.Module
    opt_state: dict


def init_train_state(cfg: ModelConfig, params: nn.Module) -> TrainState:
    """Make `params` trainable and give them zero AdamW moments. The
    parameters must be float32 masters (`init_params(...,
    param_dtype=torch.float32)`), as the JAX package's are: their `.grad`
    is the float32 gradient accumulator."""
    low = [n for n, p in params.named_parameters()
           if p.dtype != torch.float32]
    if low:
        raise ValueError(f"training keeps float32 master weights; {low[0]} "
                         f"and {len(low) - 1} more are not float32 (use "
                         "init_params(..., param_dtype=torch.float32))")
    params.requires_grad_(True)
    return TrainState(params=params, opt_state=adamw_init(params))


def train_state_from_jax(state, cfg: ModelConfig, device=None) -> TrainState:
    """A JAX `TrainState` (numpy arrays: `jax.device_get` of it) as the
    port's: float32 trainable parameters and the AdamW moments keyed by
    parameter name, float32."""
    dev = resolve_device(device)
    params, opt = state
    model = params_from_jax(params, cfg, dev, torch.float32)
    model.requires_grad_(True)

    def moments(tree) -> dict[str, torch.Tensor]:
        return {k: torch.tensor(a, device=dev)
                for k, a in named_from_jax(tree, cfg).items()}
    return TrainState(model, {"m": moments(opt["m"]), "v": moments(opt["v"]),
                              "step": int(opt["step"])})


def loss_and_grads(params: nn.Module, cfg: ModelConfig, batch: dict,
                   grad_accum: int = 1, weights=None, leaves=None) -> tuple:
    """(loss, the last microbatch's metrics, {name: gradient}) averaged
    over `grad_accum` microbatches of the batch's leading dimension, in
    order (it must divide). The gradients are the `.grad` of `leaves`
    ({name: tensor}; None: the parameters). `weights` (one scalar a
    microbatch) scales each microbatch's cross-entropy, and so its
    gradients and metric, before the average: the sharded step's share of
    the global mean. The aux loss is not scaled: under a mesh it already
    is this rank's share (`models/moe.py`)."""
    n = len(batch["labels"])
    if n % grad_accum:
        raise ValueError(f"batch {n} is not a multiple of grad_accum "
                         f"{grad_accum}")
    mb = n // grad_accum
    if leaves is None:
        leaves = dict(params.named_parameters())
    for t in leaves.values():
        t.grad = None
    loss_sum = None
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics = loss_fn(params, cfg, micro)
        if weights is not None:
            ce = metrics["ce"] * weights[i]
            loss = ce + AUX_LOSS_WEIGHT * metrics["aux"]
            metrics = {"ce": ce, "aux": metrics["aux"]}
        loss.backward()
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = {name: t.grad for name, t in leaves.items()}
    if grad_accum > 1:
        for g in grads.values():
            g.div_(grad_accum)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss_sum / grad_accum, metrics, grads


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                    grad_accum: int = 1):
    """Build the train step. grad_accum > 1 splits the batch's leading
    dimension into that many microbatches, in order (it must divide)."""

    def train_step(state: TrainState, batch: dict):
        params = state.params
        loss, metrics, grads = loss_and_grads(params, cfg, batch, grad_accum)
        params, opt_state, opt_metrics = adamw_update(
            opt, grads, state.opt_state, params)
        del grads
        params.zero_grad(set_to_none=True)
        metrics = metrics | opt_metrics | {"loss": loss}
        return TrainState(params=params, opt_state=opt_state), metrics

    return train_step


def train_state_specs(param_spec_tree) -> TrainState:
    """Sharding spec tree for TrainState given the param logical specs
    (optimizer moments shard exactly like their params)."""
    return TrainState(params=param_spec_tree,
                      opt_state={"m": param_spec_tree, "v": param_spec_tree,
                                 "step": ()})
