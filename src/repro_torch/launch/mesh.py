"""The device mesh of the row-sharded index (port of `repro.launch.mesh`'s
`make_mesh`).

A `Mesh` names its axes and their sizes, as a JAX mesh does, and holds
ONE device: every shard of a `ShardedJasperIndex` lives on it, and the
shard merge runs there. Shards on more than one card (with the merge as a
collective) are not supported yet: a mesh over more than one CUDA device
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes (`shape`, a dict as `jax.sharding.Mesh`'s)
    and the one device the mesh's shards live on."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of `shape` over `axes` on one device: `device=None` means the
    card (raises without one, as `resolve_device` does), "cpu" the CPU. A
    sequence of devices must name one device; more than one CUDA device
    raises NotImplementedError."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes must be distinct, got {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    if isinstance(device, (list, tuple)):
        devs = {resolve_device(d) for d in device}
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} devices: every shard lives on one "
                "card in this port (ROADMAP A9, shards on more than one "
                "card)")
        device = next(iter(devs)) if devs else None
    return Mesh(axis_names=axes, axis_sizes=shape,
                device=resolve_device(device))
