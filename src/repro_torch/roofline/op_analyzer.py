"""Dispatch-level FLOP / byte / collective counting (the port's counterpart
of `repro.roofline.hlo_analyzer`).

JAX needs an HLO parser because `cost_analysis()` counts a while-loop body
once. Eager PyTorch dispatches every iteration of a Python loop, so a
`TorchDispatchMode` that sees each op counts loops as they run, and
`analyze` returns `analyze_hlo`'s dict:

  * flops: the products `torch.utils.flop_counter` knows (mm, bmm, addmm,
    baddbmm, convolutions, SDPA and their backwards) — as `hlo_analyzer`
    counts dots and convolutions only — plus each hand-written kernel's
    formula; "flops_f32" is the part at the float32 rate (products with
    float32 operands, kernels that run on the SIMT units);
  * bytes_accessed: operand bytes plus result bytes per op; views,
    metadata and factory ops count nothing (`hlo_analyzer._FREE_OPS`),
    nor do collectives, whose payload is the collective term;
  * collectives: the c10d and `_c10d_functional` ops by result bytes,
    under JAX's five kinds, plus "total"; "collectives_by_dtype" splits
    each kind's bytes by the result's dtype (in the sharded train step,
    float32 is the parameters and their gradients, bf16 the
    activations).

Hand-written kernels launch through `ctypes`, where the dispatcher never
sees them. Each kernel function in `kernels/*/ops.py` checks the module
attribute `ACTIVE` (one `None` test when no analyzer runs) and, under an
analyzer, runs through `OpAnalyzer.kernel`: the call's ops are not
counted, its `kernel_costs` formula is, once — whether the CUDA kernel or
its plain version ran, so a dry run and a run on the card count the same
work. On fake tensors (a dry run) the kernel function returns outputs of
its shapes without running; its formula counts the most the data could
need. A captured CUDA graph's replay calls no Python and reports nothing:
count an eager run of the same work.

Host reads of fake tensors (a search loop's stop test) have no value: the
analyzer answers them "continue" (True, 1), so every loop runs to its
`max_iters` — the trip count `hlo_analyzer` weighs a while body by.
Host reads of real tensors return their values.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.kernel_costs import Cost

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the analyzer the kernel functions report to (None: no analyzer runs)
ACTIVE: "OpAnalyzer | None" = None

aten = torch.ops.aten


def _ops(*names) -> set:
    """The overload packets of `names` that this torch build has."""
    out = set()
    for name in names:
        ns, _, op = name.rpartition(".")
        space = getattr(torch.ops, ns or "aten")
        try:
            out.add(getattr(space, op))
        except (AttributeError, RuntimeError):
            pass
    return out


# a c10d op's kind (result bytes counted: the payload a device receives)
_COLLECTIVES = {}
for _kind, _names in {
        "all-reduce": ("c10d.allreduce_", "c10d.allreduce_coalesced_",
                       "_c10d_functional.all_reduce",
                       "_c10d_functional.all_reduce_",
                       "_c10d_functional.all_reduce_coalesced"),
        "all-gather": ("c10d.allgather_", "c10d._allgather_base_",
                       "c10d.allgather_into_tensor_coalesced_",
                       "_c10d_functional.all_gather_into_tensor",
                       "_c10d_functional.all_gather_into_tensor_coalesced",
                       "_c10d_functional.all_gather_into_tensor_out"),
        "reduce-scatter": ("c10d.reduce_scatter_",
                           "c10d._reduce_scatter_base_",
                           "c10d.reduce_scatter_tensor_coalesced_",
                           "_c10d_functional.reduce_scatter_tensor",
                           "_c10d_functional.reduce_scatter_tensor_coalesced"),
        "all-to-all": ("c10d.alltoall_", "c10d.alltoall_base_",
                       "_c10d_functional.all_to_all_single"),
        "collective-permute": ("c10d.send", "c10d.recv_",
                               "c10d.broadcast_",
                               "_c10d_functional.broadcast")}.items():
    for _op in _ops(*_names):
        _COLLECTIVES[_op] = _kind

# ops that move no bytes of their own (aliasing, metadata, host reads,
# synchronisation, allocation)
_FREE = _ops(
    "detach", "alias", "_unsafe_view", "lift_fresh", "_local_scalar_dense",
    "is_nonzero",
    "item", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "record_stream", "set_", "resize_", "empty_like",
    "zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
    "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full",
    "empty_strided", "empty", "_c10d_functional.wait_tensor",
    "c10d.barrier", "c10d.monitored_barrier_", "prim.device",
    "prim.layout")
_HOST_READS = _ops("_local_scalar_dense", "is_nonzero", "item")


_KERNEL_KEYS = ("CPU", "CUDA", "CompositeExplicitAutograd",
                "CompositeExplicitAutogradNonFunctional")


def _has_kernel(func) -> bool:
    """Does the op run a kernel of its own (a backend's or an explicit
    composite's)? Otherwise it only decomposes."""
    return any(torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), k)
               for k in _KERNEL_KEYS)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def any_fake(*trees) -> bool:
    return any(is_fake(t) for tree in trees for t in _tensors(tree))


class OpAnalyzer(TorchDispatchMode):
    """Counts the ops dispatched inside `with OpAnalyzer() as a:` and the
    kernel functions called there; `a.analyze()` gives the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_f32 = 0.0
        self.bytes_accessed = 0.0
        self.collectives = {k: {"bytes": 0.0, "count": 0.0}
                            for k in COLLECTIVE_KINDS}
        self.collectives_by_dtype: dict[str, dict[str, float]] = {
            k: {} for k in COLLECTIVE_KINDS}
        self.kernels: dict[str, dict] = {}
        self.by_op: dict[str, dict] = {}
        self.host_reads_answered = 0
        self._quiet = 0
        self._outer = None

    # ------------------------------------------------------------ the mode
    def __enter__(self):
        global ACTIVE
        self._outer, ACTIVE = ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _HOST_READS and any_fake(args):
            # a fake tensor has no value: "continue"
            self.host_reads_answered += 1
            return True if packet is not aten._local_scalar_dense else (
                True if args[0].dtype == torch.bool else 1)
        if (packet not in flop_registry and packet not in _COLLECTIVES
                and packet not in _FREE and not func.is_view
                and not _has_kernel(func)):
            # a composite op with no kernel of its own that reaches the
            # mode whole (linear, einsum, matmul under inference_mode):
            # run its decomposition here, so its products are counted as
            # they run
            TorchDispatchMode.__enter__(self)
            try:
                r = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        kind = _COLLECTIVES.get(packet)
        if kind is not None:
            c = self.collectives[kind]
            # the result; an op that writes its output argument in place
            # and returns only its work handle (alltoall_base_): that
            received = (_tensors(out) or _tensors(args[:1]))
            c["bytes"] += sum(_nbytes(t) for t in received)
            c["count"] += 1
            by = self.collectives_by_dtype[kind]
            for t in received:
                key = str(t.dtype).replace("torch.", "")
                by[key] = by.get(key, 0.0) + _nbytes(t)
            return out
        f = 0.0
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            ins = _tensors(args)
            if ins and ins[0].dtype in (torch.float32, torch.float64):
                self.flops_f32 += f
        if func.is_view or packet in _FREE:
            return out
        ins = _tensors((args, kwargs))
        if not ins:                      # a factory: allocation only
            return out
        b = (sum(_nbytes(t) for t in ins)
             + sum(_nbytes(t) for t in _tensors(out)))
        self.bytes_accessed += b
        rec = self.by_op.setdefault(str(packet), {"count": 0, "bytes": 0.0,
                                                  "flops": 0.0})
        rec["count"] += 1
        rec["bytes"] += b
        rec["flops"] += f
        return out

    # ------------------------------------------------------------ kernels
    def kernel(self, name: str, fn, cost, outputs, *args, **kwargs):
        """Run kernel function `fn(*args, **kwargs)` uncounted and count
        `cost(out, *args, **kwargs)` (a `kernel_costs.Cost`) once. On fake
        tensors `outputs(*args, **kwargs)` stands in for the run: empty
        tensors of the kernel's output shapes."""
        global ACTIVE
        ACTIVE = None
        self._quiet += 1
        try:
            fake = any_fake(args, kwargs)
            out = (outputs if fake else fn)(*args, **kwargs)
            c: Cost = cost(out, *args, fake=fake, **kwargs)
        finally:
            self._quiet -= 1
            ACTIVE = self
        self.add(name, c)
        return out

    def add(self, name: str, c: Cost) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                             "flops": 0.0, "rate": c.rate})
        rec["calls"] += 1
        rec["bytes"] += c.bytes
        rec["flops"] += c.flops
        self.bytes_accessed += c.bytes
        self.flops += c.flops
        if c.rate == "f32":
            self.flops_f32 += c.flops

    # ------------------------------------------------------------ totals
    def analyze(self) -> dict:
        coll = {k: dict(v) for k, v in self.collectives.items()}
        coll["total"] = {"bytes": sum(v["bytes"] for v in coll.values()),
                         "count": sum(v["count"] for v in coll.values())}
        return {"flops": self.flops, "flops_f32": self.flops_f32,
                "bytes_accessed": self.bytes_accessed, "collectives": coll,
                "collectives_by_dtype": {
                    k: dict(v) for k, v in self.collectives_by_dtype.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}

    def top_ops(self, n: int = 10) -> list[tuple[str, dict]]:
        """The `n` ops (by overload packet) that moved the most bytes, with
        their counts, bytes and flops — the split of the memory term."""
        return sorted(self.by_op.items(), key=lambda kv: -kv[1]["bytes"])[:n]
