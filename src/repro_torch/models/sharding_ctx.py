"""Logical-axis sharding context (PyTorch port of
`repro.models.sharding_ctx`).

Parameters and activations carry LOGICAL axis names ("batch", "embed",
"heads", ...); a rules table maps each to a mesh axis, a tuple of mesh
axes, or None. `sharding_rules(mesh)` installs the table (filtered to the
mesh's axes) in thread-local state for the block; `launch/shardings.py`
turns the spec trees of the models into DTensor placements with it.

A spec here is a tuple with one entry a tensor dimension: None, a mesh
axis name, or a tuple of mesh axis names (a `PartitionSpec`'s entries).
`constrain(x, names)` is the identity on a plain tensor and outside any
block; on a `DTensor` it redistributes to the placements of
`resolve_spec`, JAX's resolution. The port's models do not call it: their
activations are plain local tensors (see `training/dp_step.py`'s
sharded step), so no DTensor reaches a hand-written kernel; the
collectives XLA derives from JAX's `constrain` calls are written by hand
in `models/tensor_parallel.py`.

`local_shard`, `distribute`, `set_parameter` and `local_batch` put a full
tensor on a mesh: a rank's slice of it is cut locally, with no
collective. `data_groups` gives the process groups of the data axes,
`data_rank` a rank's place among the data shards and `gather_over_data`
an all-gather over them in that order; `model_group` and `model_rank`
give the "model" axis' group and its size with a rank's place on it, and
`seq_parallel` whether the installed rules put the residual sequence
("res_seq") on it, as the tensor-parallel step reads them
(`models/tensor_parallel.py`). Within `sharding_rules` the
activations' rows are this rank's share of the batch, split over the data
axes as `local_batch` splits it (`split_rows=True`), or the whole batch on
every rank (`rows_split()` says which; `models/moe.py` reads it).

A mesh is anything with axis names and sizes: a
`torch.distributed.device_mesh.DeviceMesh` (`mesh_dim_names`) or the
one-device `launch.mesh.Mesh` (`axis_names`), so the specs of a
512-device mesh resolve without 512 processes.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

_state = threading.local()
# torch 2.13 renames the tensor collectives; older releases have only the
# old names (same signatures)
all_gather_tensor = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

# logical axis -> mesh axis (or tuple of mesh axes, or None); the JAX
# package's table (its comments give each choice's reason). Param axes
# and activation axes are distinct namespaces: params FSDP-shard their
# "embed" rows over `data` (ZeRO-3) while activation embed dims stay
# unsharded — TP lives on the `model` axis for both.
DEFAULT_RULES: dict[str, object] = {
    # --- activations
    "batch": ("pod", "data"),   # data parallel over pod+data
    "seq": None,
    "act_embed": None,
    "act_ff": "model",
    "act_vocab": "model",
    "act_heads": "model",
    "act_kv": "model",
    "act_ssm": "model",
    "expert_cap": None,
    "res_seq": "model",         # Megatron sequence parallelism
    "kv_seq": None,             # split-KV decode (remapped per arch)
    "moe_chunk": ("pod", "data", "model"),
    "attn_seq": "model",        # context-parallel attention fallback
    # --- params
    "embed": "data",            # FSDP / ZeRO-3 within pod
    "ff": "model",              # tensor parallel
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "expert": "model",          # expert parallel (shared w/ activations)
    "ssm_inner": "model",
    "layers": None,             # scan-stacked leading dim
}


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a DeviceMesh or a `launch.mesh.Mesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def filter_rules(rules: dict, mesh) -> dict:
    """`rules` with the mesh axes the mesh lacks dropped (e.g. "pod" on a
    single-pod mesh); an entry left with no axis becomes None."""
    names = set(axis_sizes(mesh))

    def keep(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        return kept if kept else None

    return {k: keep(v) for k, v in rules.items()}


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def rows_split() -> bool:
    """Whether the activations' rows are this rank's share of the batch
    (split over the data axes) rather than the whole batch."""
    return getattr(_state, "split_rows", True)


def snapshot() -> tuple:
    """This thread's installed (rules, mesh, split_rows), for `restored`."""
    return (getattr(_state, "rules", None), getattr(_state, "mesh", None),
            getattr(_state, "split_rows", True))


@contextmanager
def restored(snap: tuple):
    """Install a `snapshot` on this thread within the block: a remat
    recompute runs where the autograd engine runs it, on its device thread
    for CUDA tensors, where the forward's rules are not installed."""
    prev = snapshot()
    _state.rules, _state.mesh, _state.split_rows = snap
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.split_rows = prev


def sharding_rules(mesh, rules: dict | None = None, *,
                   split_rows: bool = True):
    """Install mesh + logical rules for constrain() within the block;
    `split_rows`: the rows each rank runs are its share of the batch over
    the data axes (False: the whole batch on every rank)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    return restored((filter_rules(merged, mesh), mesh, split_rows))


def logical_to_spec(names: tuple[str | None, ...],
                    rules: dict | None = None) -> tuple:
    """The spec of logical `names` under `rules` (None: the installed
    ones); () outside any block. A one-axis tuple becomes the axis name,
    as a `PartitionSpec` canonicalises it."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return ()
    return canonical(rules.get(n) if n is not None else None for n in names)


def canonical(spec) -> tuple:
    """`spec` as a tuple with each one-axis tuple replaced by its axis
    name, as a `PartitionSpec` canonicalises it."""
    return tuple(v[0] if isinstance(v, tuple) and len(v) == 1 else v
                 for v in spec)


def axes_size(v, sizes: dict) -> int:
    """The shard count of a spec entry (None, an axis, a tuple of axes)
    under {axis: size}."""
    if v is None:
        return 1
    n = 1
    for a in ((v,) if isinstance(v, str) else v):
        n *= sizes[a]
    return n


def shard_count(name: str) -> int:
    """How many ways logical axis `name` shards on the current mesh."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return 1
    return axes_size(rules.get(name), axis_sizes(mesh))


def resolve_spec(shape, names: tuple[str | None, ...], rules: dict,
                 mesh) -> tuple:
    """JAX's `constrain` resolution of logical `names` for a tensor of
    `shape`: first come, first served on mesh axes (an axis an earlier
    dimension took is dropped from later ones), and an entry whose shard
    count does not divide its dimension is dropped (replicated)."""
    sizes = axis_sizes(mesh)
    resolved = []
    used: set = set()
    for dim, name in zip(shape, names):
        v = rules.get(name) if name is not None else None
        if v is not None:
            axes = (v,) if isinstance(v, str) else tuple(v)
            axes = tuple(a for a in axes if a not in used)
            v = (axes[0] if len(axes) == 1 else axes) if axes else None
        if v is not None and dim % axes_size(v, sizes) == 0:
            resolved.append(v)
            used.update((v,) if isinstance(v, str) else v)
        else:
            resolved.append(None)
    return tuple(resolved)


def constrain(x, names: tuple[str | None, ...]):
    """Redistribute a DTensor to the placements of its logical `names`
    (`resolve_spec`); the identity on a plain tensor or with no rules
    installed."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(x.shape, names, rules, x.device_mesh)
    return x.redistribute(x.device_mesh, placements_of(x.device_mesh, spec))


def placements_of(mesh, spec: tuple) -> tuple:
    """One DTensor placement a mesh dimension for `spec`: `Shard(d)` where
    tensor dimension d names the mesh axis, else `Replicate()`. A
    dimension over several mesh axes is split major to minor in the
    mesh's order, as JAX splits it; another order, or an axis named twice,
    raises ValueError."""
    order = list(axis_sizes(mesh))
    where: dict[str, int] = {}
    for d, v in enumerate(spec):
        axes = () if v is None else (v,) if isinstance(v, str) else tuple(v)
        if [order.index(a) for a in axes] != sorted(
                order.index(a) for a in axes):
            raise ValueError(f"spec {spec}: {axes} is not in the mesh's "
                             f"axis order {tuple(order)}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in order)


# ------------------------------------------------------------ DTensors
def local_shard(full: torch.Tensor, mesh, placements, coordinate
                ) -> torch.Tensor:
    """The slice of `full` that the device at mesh `coordinate` holds under
    `placements` (a view): each mesh dimension's `Shard(d)` splits
    dimension d evenly, in mesh order."""
    sizes = list(axis_sizes(mesh).values())
    t = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            if t.shape[p.dim] % sizes[i]:
                raise ValueError(f"dimension {p.dim} of {tuple(full.shape)}"
                                 f" does not split {sizes[i]} ways")
            t = t.chunk(sizes[i], p.dim)[coordinate[i]]
    return t


def distribute(full: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor of `full` at `placements` on `mesh` (a DeviceMesh): this
    rank keeps a copy of its own slice; no collective runs, so every rank
    must hold the same `full`."""
    local = local_shard(full, mesh, placements, mesh.get_coordinate()
                        ).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def set_parameter(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """Replace parameter `name` of `model` by `value`: a parameter as it
    is, a tensor or a DTensor as a frozen parameter."""
    if not isinstance(value, nn.Parameter):
        value = nn.Parameter(value, requires_grad=False)
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner), leaf, value)


def local_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows of a global batch: split over the data axes (the
    "batch" rule), the same on every rank of a model axis; each
    microbatch must split evenly. With grad_accum > 1 the rows are
    microbatch-major: microbatch i of the result is the rank's part of
    the global batch's microbatch i, as a jitted step over the global
    batch shards it."""
    spec = (None, filter_rules(DEFAULT_RULES, mesh).get("batch"))
    placements = placements_of(mesh, spec)
    coord = mesh.get_coordinate()
    out = {}
    for k, v in batch.items():
        micro = v.reshape(grad_accum, -1, *v.shape[1:])
        out[k] = local_shard(micro, mesh, placements, coord).reshape(
            -1, *v.shape[1:])
    return out


def data_rank(mesh) -> tuple[int, int]:
    """(the number of data shards, this rank's index among them) in the
    "batch" rule's order: major to minor over ("pod", "data"), as
    `local_batch` deals the rows."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    n, r = 1, 0
    for a in ("pod", "data"):
        if a in sizes:
            n, r = n * sizes[a], r * sizes[a] + coord[a]
    return n, r


def gather_over_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """(data shards, *t.shape): every data shard's `t`, in `data_rank`
    order (over "data", then over "pod")."""
    sizes = axis_sizes(mesh)
    out = t[None].contiguous()
    for a in ("data", "pod"):
        if a in sizes and sizes[a] > 1:
            buf = out.new_empty((sizes[a] * out.shape[0], *t.shape))
            all_gather_tensor(buf, out, group=mesh.get_group(a))
            out = buf
    return out


def data_groups(mesh) -> tuple[list, int]:
    """The process groups of the mesh's data axes ("pod", "data") and the
    number of data shards; ValueError if it has none."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    if not axes:
        raise ValueError("mesh has no data axes")
    n = 1
    for a in axes:
        n *= sizes[a]
    return [mesh.get_group(a) for a in axes], n


def model_group(mesh):
    """The process group of the mesh's "model" axis; ValueError if it has
    none."""
    if "model" not in axis_sizes(mesh):
        raise ValueError("mesh has no model axis")
    return mesh.get_group("model")


def model_rank(mesh) -> tuple[int, int]:
    """(the "model" axis' size, this rank's coordinate on it); (1, 0) on a
    mesh without one."""
    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        return 1, 0
    return sizes["model"], dict(zip(sizes, mesh.get_coordinate()))["model"]


def seq_parallel() -> bool:
    """Whether the installed rules put the residual stream's sequence
    ("res_seq") on the "model" axis (Megatron sequence parallelism); the
    dry-run's `no_sp` maps it to None, as JAX's does
    (`src/repro/launch/dryrun.py:85`)."""
    rules = current_rules()
    return rules is not None and rules.get("res_seq") == "model"
