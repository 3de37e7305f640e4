"""Mesh shardings for params / optimizer / batches / decode state (PyTorch
port of `repro.launch.shardings`).

Single source of truth: the logical-axis rule table in
`models/sharding_ctx.py` plus the spec trees (`models.model.param_specs`
/ `state_specs`, `training.train_loop.train_state_specs`), keyed by the
port's parameter names through `models/convert.py` `named_specs`.

The counterpart of a JAX `NamedSharding` is `NamedSharding` here: a mesh
and a spec (one entry a tensor dimension: None, a mesh axis, or a tuple of
mesh axes), whose `placements` are one DTensor placement a mesh
dimension (`Shard(d)` or `Replicate()`). A dimension over several mesh
axes is split major to minor in the mesh's order, as JAX splits it, so a
rank's local shard (`sharding_ctx.local_shard`) is exactly the slice
that JAX's `addressable_shards` gives the device at the same mesh
coordinates.
Only even splits are made: `sanitize_shardings` drops an axis whose
shard count does not divide its dimension, as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import named_specs
from repro_torch.models.model import param_specs, state_specs
from repro_torch.models.sharding_ctx import (
    DEFAULT_RULES,
    axes_size,
    axis_sizes,
    canonical,
    distribute,
    filter_rules,
    logical_to_spec,
    placements_of,
    set_parameter,
)
from repro_torch.training.train_loop import TrainState, train_state_specs


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the spec of a tensor on it (`jax.sharding.NamedSharding`
    with its `PartitionSpec` as a tuple)."""

    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec", canonical(self.spec))

    @property
    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)


def resolve_rules(mesh, overrides: dict | None = None) -> dict:
    """DEFAULT_RULES filtered to the mesh's axes (+ per-arch overrides)."""
    return filter_rules({**DEFAULT_RULES, **(overrides or {})}, mesh)


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and named tuples (TrainState),
    with matching trees `rest` alongside; a plain tuple (a logical spec)
    is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def _to_named(mesh, rules: dict, spec_tree):
    return _tree_map(lambda spec: NamedSharding(
        mesh, logical_to_spec(spec, rules)), spec_tree)


def param_shardings(mesh, cfg: ModelConfig,
                    overrides: dict | None = None) -> dict:
    """{port parameter name: NamedSharding}."""
    rules = resolve_rules(mesh, overrides)
    return _to_named(mesh, rules, named_specs(param_specs(cfg), cfg))


def train_state_shardings(mesh, cfg: ModelConfig,
                          overrides: dict | None = None) -> TrainState:
    """A TrainState of NamedShardings: params and both AdamW moments keyed
    by the port's parameter names, "step" replicated."""
    rules = resolve_rules(mesh, overrides)
    ts = train_state_specs(param_specs(cfg))
    opt = ts.opt_state
    port = TrainState(named_specs(ts.params, cfg),
                      {"m": named_specs(opt["m"], cfg),
                       "v": named_specs(opt["v"], cfg),
                       "step": opt["step"]})
    return _to_named(mesh, rules, port)


def decode_state_shardings(mesh, cfg: ModelConfig,
                           overrides: dict | None = None) -> dict:
    """The decode state's shardings (`init_decode_state`'s tree)."""
    rules = resolve_rules(mesh, overrides)
    sizes = axis_sizes(mesh)
    if ("model" in sizes and cfg.num_kv_heads % sizes["model"] != 0
            and (overrides is None or "kv_seq" not in overrides)):
        # split-KV decode: shard the cache SEQUENCE over the TP axis when
        # the kv heads can't tile it
        rules = {**rules, "kv_heads": None, "kv_seq": "model"}
    return _to_named(mesh, rules, state_specs(cfg))


def batch_shardings(mesh, cfg: ModelConfig,
                    overrides: dict | None = None) -> dict:
    """tokens/labels (B, S) or frames (B, S, D): batch over (pod, data)."""
    b = resolve_rules(mesh, overrides).get("batch")
    tok = NamedSharding(mesh, (b, None))
    if cfg.frontend == "frames":
        return {"frames": NamedSharding(mesh, (b, None, None)),
                "labels": tok}
    return {"tokens": tok, "labels": tok}


def logits_sharding(mesh, overrides: dict | None = None) -> NamedSharding:
    rules = resolve_rules(mesh, overrides)
    return NamedSharding(mesh, (rules.get("batch"), None,
                                rules.get("act_vocab")))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def sanitize_shardings(shard_tree, shape_tree, mesh):
    """Drop sharding axes whose shard count doesn't divide the dimension
    (e.g. 4 kv heads on a 16-wide model axis -> replicate that dim).

    shape_tree: the matching tree of tensors or shapes (`state_shapes` of
    a TrainState)."""
    sizes = axis_sizes(mesh)

    def one(sh: NamedSharding, shape) -> NamedSharding:
        dims = tuple(getattr(shape, "shape", shape))
        spec = list(sh.spec) + [None] * (len(dims) - len(sh.spec))
        return NamedSharding(mesh, tuple(
            v if d % axes_size(v, sizes) == 0 else None
            for d, v in zip(dims, spec)))

    return _tree_map(one, shard_tree, shape_tree)


def state_shapes(state: TrainState) -> TrainState:
    """A TrainState's shapes as `sanitize_shardings` takes them: the
    parameters and moments keyed by name, the step a scalar ()."""
    model, opt = state
    return TrainState({n: tuple(p.shape) for n, p in model.named_parameters()},
                      {"m": {n: tuple(t.shape) for n, t in opt["m"].items()},
                       "v": {n: tuple(t.shape) for n, t in opt["v"].items()},
                       "step": ()})


@torch.no_grad()
def shard_train_state(state: TrainState, shardings: TrainState
                      ) -> TrainState:
    """The same TrainState with its parameters and moments as DTensors at
    `shardings` (`sanitize_shardings(train_state_shardings(...))`); every
    rank must hold the same full state. The parameters are swapped into
    the state's `Model` in place."""
    model, opt = state
    p_shd, o_shd = shardings
    for name, p in list(model.named_parameters()):
        sh = p_shd[name]
        set_parameter(model, name, distribute(p.detach(), sh.mesh,
                                              sh.placements))
    moments = {key: {n: distribute(t, o_shd[key][n].mesh,
                                   o_shd[key][n].placements)
                     for n, t in opt[key].items()} for key in ("m", "v")}
    return TrainState(model, {**moments, "step": opt["step"]})
