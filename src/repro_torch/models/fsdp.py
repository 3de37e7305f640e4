"""Parameters gathered a unit at a time: the sharded train step's FSDP
(ZeRO-3 within the step, as XLA partitions the JAX launcher's jitted step
over its ZeRO-3 shardings, `src/repro/launch/train.py:51-72`).

`ShardedParams(model, mesh)` holds a model whose parameters are DTensors
(`launch/shardings.py`'s train-state shardings) as one float32 leaf a
parameter: this rank's local shard, which takes the gradient. Entered as
a context, it makes `gathered(*modules)` (a no-op otherwise) swap each
of the modules' parameters for a full tensor for the block:

  * forward: `_Gather` all-gathers the leaf along each `Shard` placement,
    minor mesh axis first, so the result equals `full_tensor()` bit for
    bit;
  * backward, one mesh axis at a time, in mesh order: on a data axis
    ("pod", "data") the full gradient is reduce-scattered onto the
    shard's slice where the parameter is `Shard`ed and all-reduced where
    it is `Replicate`d. So the leaf's gradient is `sum_over_data` +
    `local_shard`, done as the backward reaches the unit, and no full
    gradient outlives it.

The gather follows the compute on the "model" axis: with a tensor-parallel
plan (`models/tensor_parallel.py`, every family) each parameter has a mode
(`Plan.mode`):

  * "local": the unit computes on the parameter's "model" shard (q/k/v
    and `wo` on this rank's heads, the MLP on its ff columns, a MoE
    block's experts on its E/tp under global dispatch, a Mamba2 block's
    per-head vectors, norm and `out_proj` on its heads, the mLSTM's
    projections on its channels, the sLSTM's feed-forward on its
    columns, the table and the head on its vocabulary rows), so only the
    data axes are gathered, and the gradient needs no "model" collective;
  * "partial": the unit needs it whole, and each model rank's gradient is
    a partial sum over its slice of the sequence, its experts' routes,
    its token slab or its heads (the norm scales and the frames
    projection under sequence parallelism, the attention weights of the
    context-parallel fallback, the MoE router, the experts under manual
    SPMD, Mamba2's fused `in_proj` and conv, the mLSTM's forget bias where
    its cell splits by heads): it is gathered over "model" too, and its
    gradient summed over "model" like a data axis' (reduce-scattered
    where `Shard`ed, all-reduced where `Replicate`d);
  * "replica": every model rank repeats the same compute and sees the
    same gradient (no plan; the sLSTM recurrence, an mLSTM cell whose
    heads do not tile the axis), so this rank's slice is taken with no
    collective.

Serving runs under a serving plan (`make_plan(..., serving=True)`): the
same modes without a gradient, the fallback's attention weights "local"
too. A model of any family on a model axis larger than 1 is refused
without a plan (`tensor_parallel.current`): it never repeats the compute
on the model ranks.

The units are the model's remat units (`models/model.py` `_layers`: a
block, an xLSTM pair, a Mamba2 group with the shared attention block),
the input embedding and the head; a parameter used by several units
(zamba2's shared block, a tied table) is gathered at each use and the
gradients of its uses add up in its leaf.

Without remat, autograd would keep every gathered weight a unit saves for
the backward. With `pack=True` a saved tensor whose storage is a gathered
weight's, or a cast of one made in the block (`Tensor.to`,
`Tensor.float`), is packed as a reference to its leaf and gathered again
when the backward unpacks it (`torch.autograd.graph.saved_tensors_hooks`).
Under `torch.utils.checkpoint` (remat "full") the gather runs inside the
checkpointed function, so the recompute gathers again, and nothing is
packed; the function carries the forward's `context()` and installs it
again (`restored`), since the autograd engine runs a CUDA backward, and so
the recompute, on its own device thread.

On a mesh whose every axis has size 1 a unit uses the leaves themselves:
the step is the single-device step, op for op.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.overrides import TorchFunctionMode

from repro_torch.models.sharding_ctx import (
    all_gather_tensor,
    axis_sizes,
    reduce_scatter_tensor,
    snapshot,
)
from repro_torch.models.sharding_ctx import restored as restored_rules

DATA_AXES = ("pod", "data")

_state = threading.local()


def active() -> "ShardedParams | None":
    return getattr(_state, "params", None)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Layout:
    """One parameter's placements on a mesh: per mesh axis (name, size,
    process group, the tensor dimension it splits or None, its role). A
    data axis' role is "sum"; the other axes' follow `mode` (see the
    module note): "keep" for "local", "sum" for "partial", "slice" for
    "replica"."""

    def __init__(self, placements, axes: list[tuple], mode: str = "replica"):
        role = {"local": "keep", "partial": "sum", "replica": "slice"}[mode]
        self.axes = [(name, size, group,
                      p.dim if isinstance(p, Shard) else None,
                      "sum" if name in DATA_AXES else role)
                     for (name, size, group), p in zip(axes, placements)]
        # gathered: some gathered axis of size > 1 splits it (else the
        # gather is a copy); trivial: every axis has size 1 (no collective
        # at all)
        self.gathered = any(s > 1 and d is not None and r != "keep"
                            for _, s, _, d, r in self.axes)
        self.trivial = all(s == 1 for _, s, _, _, _ in self.axes)
        # ranks holding the same shard: the replicated axes' sizes
        self.replicas = 1
        for _, s, _, d, _ in self.axes:
            if d is None:
                self.replicas *= s

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The parameter as the unit uses it from this rank's shard: the
        Shard axes gathered minor first (`local_shard` splits major
        first), a kept axis left split."""
        t = local
        for name, size, group, d, role in reversed(self.axes):
            if d is None or size == 1 or role == "keep":
                continue
            moved = t.movedim(d, 0).contiguous()
            out = moved.new_empty((size * moved.shape[0], *moved.shape[1:]))
            all_gather_tensor(out, moved, group=group)
            t = out.movedim(0, d)
        return t.contiguous() if self.gathered else t.clone()

    def scatter(self, grad: torch.Tensor, coord: dict) -> torch.Tensor:
        """This rank's shard of the gradient summed over the axes whose
        role is "sum" (see the module note). The splits come in mesh order
        (as `local_shard` makes them), but a slice whose dimension no
        other axis splits comes first and the all-reduces over replicated
        summed axes last, so each sum moves the fewest bytes; sums
        commute, so the result is the same."""
        live = [a for a in self.axes if a[1] > 1 and a[4] != "keep"]
        dims = [a[3] for a in live if a[3] is not None]
        first = [a for a in live if a[4] == "slice"
                 and a[3] is not None and dims.count(a[3]) == 1]
        last = [a for a in live if a[4] == "sum" and a[3] is None]
        middle = [a for a in live if a not in first and a not in last]
        g = grad
        for name, size, group, d, role in first + middle:
            if role == "slice":
                if d is not None:
                    g = g.chunk(size, d)[coord[name]]
                continue
            moved = g.movedim(d, 0).contiguous()
            out = moved.new_empty((moved.shape[0] // size, *moved.shape[1:]))
            reduce_scatter_tensor(out, moved, group=group)
            g = out.movedim(0, d)
        if last:
            # a copy: autograd's gradient is not this function's
            g = g.clone(memory_format=torch.contiguous_format)
            for _, _, group, _, _ in last:
                dist.all_reduce(g, group=group)
        return g.contiguous()


def _check_local(name: str, placements, axes: list[str]) -> None:
    """A "local" parameter's "model" shard must be a block of the full
    tensor: split over "model" along a dimension no other axis splits."""
    dims = {a: p.dim for a, p in zip(axes, placements)
            if isinstance(p, Shard)}
    d = dims.pop("model", None)
    if d is None or d in dims.values():
        raise ValueError(f"{name} computes on its model shard, but its "
                         f"placements {tuple(placements)} do not split it "
                         "over 'model' alone along one dimension")


class _Gather(torch.autograd.Function):
    """leaf (this rank's shard) -> the full parameter; the backward
    returns the leaf's gradient (`_Layout.scatter`)."""

    @staticmethod
    def forward(ctx, local, layout, coord):
        ctx.layout, ctx.coord = layout, coord
        return layout.gather(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout.scatter(grad, ctx.coord), None, None


class _WeightRef:
    """A saved tensor packed as its leaf: gathered (and cast) again on
    unpack, then viewed as it was."""

    __slots__ = ("name", "dtype", "size", "stride", "offset")

    def __init__(self, name, dtype, t: torch.Tensor):
        self.name, self.dtype = name, dtype
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class _CastTracker(TorchFunctionMode):
    """Records the casts of gathered weights made in a block, so that a
    saved cast packs as its leaf too. Holds every full tensor it knows of
    until the block ends, so no storage key is reused meanwhile."""

    def __init__(self, known: dict):
        super().__init__()
        self.known, self.keep = known, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in (torch.Tensor.to, torch.Tensor.float) and args
                and isinstance(out, torch.Tensor)
                and isinstance(args[0], torch.Tensor)):
            src = self.known.get(_storage_key(args[0]))
            # only a cast of the float32 gather itself: a cast of a cast
            # is not the one cast the unpack makes
            if src is not None and src[1] is None \
                    and _storage_key(out) != _storage_key(args[0]):
                self.known[_storage_key(out)] = (src[0], out.dtype)
                self.keep.append(out)
        return out


class ShardedParams:
    """`model`'s DTensor parameters as float32 leaves (its local shards,
    sharing their storage) on `mesh` (a DeviceMesh). `leaves` maps each
    parameter name to its leaf; a leaf's `.grad` is its gradient shard.
    `plan`: the tensor-parallel plan (`models/tensor_parallel.py`) whose
    `mode` sets each parameter's use of "model"; None: every parameter
    "replica". Enter it to make `gathered` gather from it."""

    def __init__(self, model: torch.nn.Module, mesh, plan=None):
        sizes = axis_sizes(mesh)
        self.axes = [(a, s, mesh.get_group(a)) for a, s in sizes.items()]
        self.coord = dict(zip(sizes, mesh.get_coordinate()))
        self.plan = plan
        self.leaves: dict[str, torch.Tensor] = {}
        self.layouts: dict[str, _Layout] = {}
        self._names: dict[int, str] = {}
        for name, p in model.named_parameters():
            if not isinstance(p, DTensor):
                raise TypeError(f"{name} is not a DTensor: ShardedParams "
                                "takes a model stored at its shardings")
            mode = "replica" if plan is None else plan.mode(name)
            if mode == "local":
                _check_local(name, p.placements, list(sizes))
            self.leaves[name] = p.to_local().detach().requires_grad_()
            self.layouts[name] = _Layout(p.placements, self.axes, mode)
            self._names[id(p)] = name

    def __enter__(self):
        if active() is not None:
            raise RuntimeError("a ShardedParams is already active")
        _state.params = self
        return self

    def __exit__(self, *exc):
        _state.params = None

    def full(self, name: str) -> torch.Tensor:
        """Parameter `name` gathered, on the autograd graph of its leaf."""
        layout = self.layouts[name]
        if layout.trivial:
            return self.leaves[name]
        return _Gather.apply(self.leaves[name], layout, self.coord)

    def regather(self, ref: _WeightRef) -> torch.Tensor:
        """A packed saved tensor, gathered again off the graph."""
        with torch.no_grad():
            t = self.layouts[ref.name].gather(self.leaves[ref.name].detach())
            if ref.dtype is not None:
                t = t.to(ref.dtype)
        return t.as_strided(ref.size, ref.stride, ref.offset)

    @contextmanager
    def gathered(self, modules, pack: bool):
        """`gathered` on this instance (the module-level function)."""
        swapped, known, seen = [], {}, set()
        for mod in modules:
            if mod is None:
                continue
            for m in mod.modules():
                if id(m) in seen:
                    continue
                seen.add(id(m))
                for attr, p in m._parameters.items():
                    name = self._names.get(id(p))
                    if name is None:
                        continue
                    full = self.full(name)
                    # an attribute in the instance dict shadows the
                    # registered parameter; `named_parameters` is unchanged
                    m.__dict__[attr] = full
                    swapped.append((m, attr))
                    if not self.layouts[name].trivial:
                        known[_storage_key(full)] = (name, None)
        packing = pack and bool(known) and torch.is_grad_enabled()
        tracker = _CastTracker(known) if packing else nullcontext()
        hooks = (torch.autograd.graph.saved_tensors_hooks(
            self._packer(known), self._unpack) if packing else nullcontext())
        try:
            with hooks, tracker:
                yield
        finally:
            for m, attr in swapped:
                del m.__dict__[attr]

    @staticmethod
    def _packer(known: dict):
        def pack(t):
            src = known.get(_storage_key(t))
            return t if src is None else _WeightRef(src[0], src[1], t)
        return pack

    def _unpack(self, obj):
        return self.regather(obj) if isinstance(obj, _WeightRef) else obj

    def global_norm(self, grads: dict) -> torch.Tensor:
        """`global_norm` of the full gradients from the shards' `grads`
        ({name: this rank's gradient shard}): each shard's squared norm
        over the ranks holding the same shard, summed over every mesh
        axis. Where every axis has size 1 it is `global_norm`'s arithmetic
        (sqrt(fl(n²)) = n in binary floating point)."""
        names = list(grads)
        norms = torch.stack([torch.linalg.vector_norm(grads[n],
                                                      dtype=torch.float32)
                             for n in names])
        reps = torch.tensor([float(self.layouts[n].replicas) for n in names],
                            device=norms.device)
        sq = norms * norms / reps
        for _, size, group in self.axes:
            if size > 1:
                dist.all_reduce(sq, group=group)
        return torch.linalg.vector_norm(torch.sqrt(sq))


def context() -> tuple:
    """The active `ShardedParams` and sharding rules of this thread, for
    `restored`."""
    return active(), snapshot()


@contextmanager
def restored(ctx: tuple):
    """Install a `context()` on this thread within the block. A remat
    recompute runs on the thread the autograd engine runs the backward on
    (a device thread for CUDA tensors), where neither is installed."""
    sp, rules = ctx
    prev = active()
    _state.params = sp
    try:
        with restored_rules(rules):
            yield
    finally:
        _state.params = prev


def gathered(*modules, pack: bool = True):
    """Within the block each of `modules`' parameters is its full tensor,
    gathered from the active `ShardedParams` (see the module note); a
    no-op when none is active. `pack`: pack the gathered weights the
    block saves for the backward (off inside a checkpointed function)."""
    sp = active()
    if sp is None:
        return nullcontext()
    return sp.gathered(modules, pack)
