"""Fault-tolerant checkpointing (PyTorch port of
`repro.training.checkpoint`): atomic, step-tagged, and in the JAX
package's format, so a run checkpointed by either package resumes in the
other.

Layout: <dir>/step_<N>.npz (+ .meta.json), written via tmp + os.replace so
a crash mid-write never corrupts the latest checkpoint; the meta file is
renamed last, and `latest_step` only counts steps that have both. One npz
holds every leaf of a `TrainState`, keyed as `repro.training.checkpoint`
flattens JAX's `TrainState` (pytree paths joined by "/", a named-tuple
field as ".<field>"): ".params/blocks/attn/wq" with the layers stacked
and projections as (in, out) matrices, ".opt_state/m/...",
".opt_state/v/...", ".opt_state/step". The parameters and moments go
through `models/convert.py` (`to_jax_layout` to write, `named_from_jax`
to read) and are stored as float32; the step as int32. Restore copies
INTO a like-state on any device, in place.

A sharded state (DTensors, `launch/shardings.py` `shard_train_state`)
saves the same file: every rank takes part in gathering the full tensors,
rank 0 writes. `restore_checkpoint(..., shardings)` places every leaf at
a target sharding tree, as the JAX package's does: the elastic path, where
the writer's mesh shape is irrelevant.
"""

from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.convert import named_from_jax, to_jax_layout
from repro_torch.models.sharding_ctx import (
    distribute,
    local_shard,
    set_parameter,
)
from repro_torch.training.train_loop import TrainState

_SEP = "/"
_MOMENTS = ("m", "v")


def _flatten(tree, prefix: str) -> dict[str, np.ndarray]:
    """{JAX checkpoint key: array} of a nested dict of arrays."""
    flat = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            flat.update(_flatten(leaf, f"{prefix}{key}{_SEP}"))
        else:
            flat[prefix + key] = leaf
    return flat


def _unflatten(data, prefix: str) -> dict:
    """The nested dict of the arrays of `data` whose keys start with
    `prefix`, split at "/"."""
    tree: dict = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        *path, last = key[len(prefix):].split(_SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = data[key]
    return tree


class _Gathered(dict):
    """{name: tensor} whose DTensors are gathered as each is read (a
    collective: every rank reads the leaves in the same order), so one
    leaf at a time is full on a device."""

    def __getitem__(self, name):
        t = super().__getitem__(name)
        return t.full_tensor() if isinstance(t, DTensor) else t


def _require_state(tree) -> None:
    if not isinstance(tree, TrainState):
        raise TypeError(f"checkpoints hold a TrainState, got "
                        f"{type(tree).__name__}")


def save_checkpoint(ckpt_dir: str, step: int, tree: TrainState,
                    extra_meta: dict | None = None,
                    async_write: bool = False) -> str:
    """Atomic save of a TrainState in the JAX package's layout. Returns the
    final path. The leaves are copied to the host first; async_write then
    returns and writes the file in a daemon thread (done when its meta
    file exists). A sharded state is gathered on every rank and written
    by rank 0; without async_write the ranks then wait for the file."""
    _require_state(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    model, opt = tree
    sharded = any(isinstance(p, DTensor) for p in model.parameters())
    flat = _flatten(to_jax_layout(_Gathered(model.named_parameters()),
                                  model), f".params{_SEP}")
    for key in _MOMENTS:
        flat.update(_flatten(to_jax_layout(_Gathered(opt[key]), model),
                             f".opt_state{_SEP}{key}{_SEP}"))
    if sharded and dist.get_rank() != 0:
        if not async_write:
            dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    flat[f".opt_state{_SEP}step"] = np.asarray(opt["step"], np.int32)
    meta = {"step": step, **(extra_meta or {})}

    def write():
        tmp = final + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        with open(final + ".meta.json.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(final + ".meta.json.tmp", final + ".meta.json")

    if async_write:
        threading.Thread(target=write, daemon=True).start()
    else:
        write()
        if sharded:
            dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with BOTH the npz and its meta present (a crash between
    the two renames leaves a checkpoint that is ignored, not half-read)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))
             and os.path.exists(os.path.join(ckpt_dir, f + ".meta.json"))]
    return max(steps) if steps else None


@torch.no_grad()
def _copy_into(tensors: dict[str, torch.Tensor], arrays: dict) -> None:
    """Each array into its tensor in place; into a DTensor's local shard,
    the slice its placements give this rank."""
    for name, t in tensors.items():
        a = torch.from_numpy(arrays[name])
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            t.to_local().copy_(local_shard(a, mesh, t.placements,
                                           mesh.get_coordinate()))
        else:
            t.copy_(a)


@torch.no_grad()
def _placed(like: dict, arrays: dict, shardings: dict) -> dict:
    """{name: DTensor of the array at its target sharding}, in `like`'s
    dtype, on the target mesh's device."""
    out = {}
    for n, t in like.items():
        mesh = shardings[n].mesh
        full = torch.from_numpy(arrays[n]).to(device=mesh.device_type,
                                              dtype=t.dtype)
        out[n] = distribute(full, mesh, shardings[n].placements)
    return out


def restore_checkpoint(ckpt_dir: str, step: int, like: TrainState,
                       shardings: TrainState | None = None) -> TrainState:
    """Restore a checkpoint of either package into `like` (a TrainState
    of the same model), copying each leaf into `like`'s tensor in place —
    on the device and in the dtype it has there (a DTensor's local shard
    for a sharded state). With `shardings` (`train_state_shardings`'s
    tree, on any mesh) every parameter and moment is placed at its target
    sharding instead: the parameters are swapped into `like`'s model, the
    moments are new dicts. Returns the restored state."""
    _require_state(like)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    model, opt = like
    params = dict(model.named_parameters())
    with np.load(path) as data:
        named = {key: named_from_jax(_unflatten(data, prefix), model)
                 for key, prefix in (
                     ("params", f".params{_SEP}"),
                     *((k, f".opt_state{_SEP}{k}{_SEP}") for k in _MOMENTS))}
        step_now = int(data[f".opt_state{_SEP}step"])
    if shardings is None:
        _copy_into(params, named["params"])
        for key in _MOMENTS:
            _copy_into(opt[key], named[key])
        return TrainState(model, {**opt, "step": step_now})
    p_shd, o_shd = shardings
    for name, t in _placed(params, named["params"], p_shd).items():
        set_parameter(model, name, t)
    moments = {key: _placed(opt[key], named[key], o_shd[key])
               for key in _MOMENTS}
    return TrainState(model, {**moments, "step": step_now})
