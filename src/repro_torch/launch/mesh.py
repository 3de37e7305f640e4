"""Device meshes (port of `repro.launch.mesh`).

Two kinds, as the JAX package uses them:
  * the row-sharded index's `Mesh` (`make_mesh`): axis names and sizes,
    as a JAX mesh has, and its positions' devices. Given one device the
    mesh has ONE position, which holds every shard of a
    `ShardedJasperIndex` stacked; given a list of `prod(shape)` devices
    it has a position an entry, row-major over the axes as
    `jax.make_mesh` lays devices out, each holding its own shard (and
    searching its own slice of the queries). One process drives every
    position, as JAX's single controller does; entries may repeat a
    device (`["cpu"] * 4`, `["cuda:0"] * 4`: a layout for tests, as JAX's
    fake host devices are). The first position's device is the mesh's
    home, where queries arrive and the shards' results are merged;
  * the training meshes (`make_debug_mesh`, `make_production_mesh`): a
    `torch.distributed` `DeviceMesh` over ("data", "model") or ("pod",
    "data", "model"), one process a device, on the process group that is
    already initialised (`init_distributed` does that from torchrun's
    environment). The card takes NCCL; `gloo` only when the CPU is asked
    for; nothing falls back from one to the other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes (`shape`, a dict as `jax.sharding.Mesh`'s)
    and the devices of its positions: one entry (one position holding
    every shard), or one a position, row-major over the axes."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device(self) -> torch.device:
        """The home device (position 0's): queries arrive and the shards'
        results are merged there."""
        return self.devices[0]

    def coords(self, position: int) -> dict:
        """{axis: index} of a position, row-major over the axes."""
        out, rest = {}, position
        for ax, size in zip(reversed(self.axis_names),
                            reversed(self.axis_sizes)):
            out[ax] = rest % size
            rest //= size
        return {ax: out[ax] for ax in self.axis_names}


def _position_device(device) -> torch.device:
    """One entry of a device list: a CUDA device gets its index (the
    current card's where none is given), and must exist."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    count = torch.cuda.device_count()
    if dev.index >= count:
        raise ValueError(f"mesh device {dev} is past the {count} CUDA "
                         f"device(s) of this machine")
    return dev


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of `shape` over `axes`. `device` is one device — `None`
    means the card (raises without one, as `resolve_device` does), "cpu"
    the CPU — and the mesh then has one position; or a list of exactly
    `prod(shape)` devices, one a position (row-major over `axes`; entries
    may repeat). A list of another length, a CUDA device past the
    machine's count, or a list mixing the CPU and CUDA raises."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes must be distinct, got {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    if not isinstance(device, (list, tuple)):
        return Mesh(axis_names=axes, axis_sizes=shape,
                    devices=(resolve_device(device),))
    size = 1
    for s in shape:
        size *= s
    if len(device) != size:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh takes one "
                         f"device a position, {size} in all; got "
                         f"{len(device)}")
    kinds = {torch.device(d).type for d in device}
    if len(kinds) > 1:
        raise ValueError(f"a mesh's positions lie on one kind of device, "
                         f"got {sorted(kinds)}")
    return Mesh(axis_names=axes, axis_sizes=shape,
                devices=tuple(_position_device(d) for d in device))


def init_distributed(device=None) -> bool:
    """Initialise the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the
    card): NCCL on the card, `gloo` on the CPU. Returns False, and does
    nothing, when WORLD_SIZE is not set; a group already initialised must
    have the device's backend."""
    dev = resolve_device(device)
    if dist.is_initialized():
        _check_backend(dev)
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_BACKEND[dev.type], init_method="env://")
    return True


def _check_backend(dev: torch.device) -> None:
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type]:
        raise RuntimeError(f"the process group's backend is {backend}; a "
                           f"{dev.type} mesh takes {_BACKEND[dev.type]}")


def _training_mesh(shape: tuple, axes: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    size = 1
    for s in shape:
        size *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        have = ("no process group is initialised" if world is None
                else f"the process group has world size {world}")
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} mesh over {axes} needs a "
            f"process group of world size {size}, one process a device "
            f"({have}; run under torchrun --nproc-per-node {size})")
    _check_backend(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def production_layout(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axes) of the production training mesh: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production training mesh (`production_layout`) — 256 or 512
    processes."""
    return _training_mesh(*production_layout(multi_pod), device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device=None):
    """A small (n_data, n_model) training mesh over ("data", "model")."""
    return _training_mesh((n_data, n_model), ("data", "model"), device)
