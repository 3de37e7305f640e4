"""Search plans: what an index's `PlanCache` holds for one key
("search", resolved spec, query shape, liveness mode), a callable
`(queries, filter_bytes) -> core_search's tuple`. They are the port's
counterpart of the JAX package's jitted `core_search`.

  * `GraphPlan` — on the card, the megakernel lanes (`fusion="megakernel"`,
    exact or quantized, with or without the rerank, the filter and the
    telemetry), whose search makes no host synchronisation: the search is
    captured once in a `torch.cuda.CUDAGraph` and replayed. The plan owns
    a static query buffer, a static filter-byte buffer and the graph's
    outputs (in the graph's private memory pool). A lane that should be
    captured and fails to capture raises; nothing runs eagerly in its
    place.
  * `EagerPlan` — on the CPU, and for the lanes whose loops synchronise
    with the host (hop: a convergence check a hop; unfused: one an
    iteration): `core_search` run eagerly at each call.
  * `HostTierPlan` — a search of an index whose rows are on the host
    tier (`rerank_source="host"`, core/storage.py): two plans of the
    cache, the traversal above (keyed as any search) and a
    `HostRerankPlan` keyed ("rerank_host", resolved spec, query shape),
    captured on the card, with the frontier ids' trip to the host and
    the store's gather of their rows between them.

A capture counts one trace in the cache's stats, as a jit trace does; so
does an eager plan's first call, and its first call after the core's
shapes changed (a grow), where jit re-traces. A captured graph reads the
core's buffers at fixed addresses and sizes, so each dispatch checks a
fingerprint of what it captured — every searched tensor's address, shape
and dtype — and recaptures (counting a trace) on a mismatch; it never
replays stale. `JasperIndex` keeps that from happening where the JAX
package would not re-trace: shape-preserving mutations write into the
core's existing buffers (`keep_buffers`), and `n_valid` and `medoid`,
host ints on the core, reach a captured search as 0-d int32 device
mirrors (`DeviceScalars`) that the kernels read through a pointer.

A plan runs its index's `_plan_search(core, queries, spec, liveness,
filter_bytes, mirrors=...)` and syncs its mirrors through
`_sync_mirrors(core)`: for a `JasperIndex` that is `core_search` on its
core; for a `ShardedJasperIndex` (core/distributed.py) every shard's
`core_search` on its slices of the stacked core, then the merge — so a
sharded megakernel search is ONE captured graph, each shard reading its
own mirrors, and `fingerprint` of the stacked core covers every shard's
buffers. `ShardedHostTierPlan` is the sharded host-tier search: one
gather of the stacked frontier's rows, then the sharded rerank plan.

Launch counters: the kernel wrappers count their launches in Python, and
a replay bypasses them. So a capture takes back what its warm-up and the
capture itself counted, and each replay adds the captured launches: one
search through a plan counts what one eager search counts.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import numpy as np
import torch

from repro_torch.core.index_core import IndexCore
from repro_torch.core.storage import build_host_rerank_plan

def launch_counters() -> dict:
    """The search path's kernel wrappers by name (each counts its
    launches in `.launches`)."""
    from repro_torch.kernels.distance.ops import (gather_l2, gather_l2_tiled,
                                                  pairwise_l2)
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_distance, rabitq_gather_distance, rabitq_search_step)
    from repro_torch.kernels.search_step.ops import fused_hop, fused_search
    from repro_torch.kernels.topk.ops import topk
    return {"fused_search": fused_search, "fused_hop": fused_hop,
            "gather_l2": gather_l2, "gather_l2_tiled": gather_l2_tiled,
            "pairwise_l2": pairwise_l2, "rabitq_distance": rabitq_distance,
            "rabitq_gather_distance": rabitq_gather_distance,
            "rabitq_search_step": rabitq_search_step, "topk": topk}


def searched_tensors(core: IndexCore) -> list:
    """The core's tensors a search reads (None where absent)."""
    codes, rq = core.codes, core.rq_params
    return [core.vectors, core.vec_sqnorm, core.adjacency,
            core.mut.tombstone_bits, core.mut.labels,
            *((codes.packed, codes.data_add, codes.data_rescale)
              if codes is not None else (None,) * 3),
            *((rq.rotation, rq.centroid) if rq is not None else (None,) * 2)]


def shape_signature(core: IndexCore) -> tuple:
    """What a jit keys its trace on: the searched tensors' shapes and
    dtypes, and which of them exist."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in searched_tensors(core))


def fingerprint(core: IndexCore) -> tuple:
    """What a captured graph depends on: the searched tensors' addresses,
    shapes and dtypes."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape),
                                         t.dtype)
                 for t in searched_tensors(core))


def keep_buffers(old, new):
    """`new` with each tensor that has the same shape, dtype and device as
    its counterpart in `old` written into that counterpart (`copy_`) and
    put in its place, recursively through the core's dataclasses. A
    mutation that keeps shapes then keeps every buffer's address, so a
    captured plan replays on it without a recapture. Returns `new` as is
    where the structure differs."""
    if isinstance(new, torch.Tensor):
        if (isinstance(old, torch.Tensor) and old.shape == new.shape
                and old.dtype == new.dtype and old.device == new.device):
            if old.data_ptr() != new.data_ptr():
                old.copy_(new)
            return old
        return new
    if (is_dataclass(new) and type(old) is type(new)):
        changes = {}
        for f in fields(new):
            a, b = getattr(old, f.name), getattr(new, f.name)
            kept = keep_buffers(a, b)
            if kept is not b:
                changes[f.name] = kept
        return replace(new, **changes) if changes else new
    return new


class DeviceScalars:
    """0-d int32 device mirrors of a core's `n_valid` and `medoid`, which
    are host ints: a captured search reads them through a pointer, so an
    insert or a consolidate that moves them needs no recapture. `sync`
    writes a changed value before a replay, on the same stream."""

    def __init__(self, device) -> None:
        self.n_valid = torch.zeros((), dtype=torch.int32, device=device)
        self.medoid = torch.zeros((), dtype=torch.int32, device=device)
        self._host = (None, None)

    def sync(self, core: IndexCore) -> None:
        host = (core.n_valid, core.medoid)
        if host != self._host:
            self.n_valid.fill_(core.n_valid)
            self.medoid.fill_(core.medoid)
            self._host = host

    def view(self, core: IndexCore) -> IndexCore:
        """`core` with the mirrors in place of its host scalars."""
        return replace(core, n_valid=self.n_valid, medoid=self.medoid)


def capturable(rspec) -> bool:
    """Whether a lane's search makes no host synchronisation, so that it
    can be captured: the megakernel lanes."""
    return rspec.fusion == "megakernel"


def make_plan(index, rspec, q_shape: tuple, filt: bool):
    """The plan for one cache key: captured on the card when the lane
    allows it, else eager."""
    if index.device.type == "cuda" and capturable(rspec):
        return GraphPlan(index, rspec, q_shape, filt)
    return EagerPlan(index, rspec, filt)


class EagerPlan:
    """`core_search` at each call; a trace counted where a jit would
    trace: the first call, and the first after the shapes changed."""

    def __init__(self, index, rspec, filt: bool) -> None:
        self.index = index
        self.rspec = rspec
        self.filt = filt
        self._signature = None

    def __call__(self, queries, filter_bytes=None) -> tuple:
        core = self.index.core
        sig = shape_signature(core)
        if sig != self._signature:
            self.index.plans.count_trace()
            self._signature = sig
        return self.index._plan_search(
            core, queries, self.rspec, self.filt,
            filter_bytes if self.rspec.filtered else None, mirrors=False)


_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """One side stream a device for every plan's warm-up and capture (a
    stream of its own each would also hold a cuBLAS workspace each)."""
    key = str(device)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


def capture(run, device, what: str):
    """`run()` captured in a CUDA graph after an eager warm-up, both on
    the device's capture stream. Returns (graph, the captured outputs,
    {kernel: launches a replay}); the wrappers' launch counters are put
    back to their values before the warm-up. A failed capture raises."""
    counters = launch_counters()
    before = {n: w.launches for n, w in counters.items()}
    # first use builds the kernels and sets each instance's launch
    # attributes, and the schedule tensor is made and cached: all in an
    # eager warm-up before the capture, on the capture's own stream
    cur = torch.cuda.current_stream()
    stream = _capture_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        run()
        warmed = {n: w.launches for n, w in counters.items()}
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = run()
        except Exception as e:
            try:
                graph.capture_end()
            except RuntimeError:
                pass
            raise RuntimeError(f"capturing {what} failed: {e}") from e
        graph.capture_end()
    cur.wait_stream(stream)
    launched = {n: w.launches - warmed[n] for n, w in counters.items()
                if w.launches != warmed[n]}
    for n, w in counters.items():
        w.launches = before[n]
    return graph, out, launched


def replay(graph, out, launched: dict):
    """Replay a captured graph, add its launches to the wrappers'
    counters and return clones of its outputs."""
    graph.replay()
    counters = launch_counters()
    for name, n in launched.items():
        counters[name].launches += n
    return _clone(out)


def _clone(out):
    """A search output with every tensor copied out of the graph's
    memory (the next replay overwrites it)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        items = [_clone(x) for x in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out


class GraphPlan:
    """One megakernel search captured in a CUDA graph and replayed.

    Each call copies the queries into the static query buffer and the
    filter value into the static filter buffer (a device-to-device copy
    of a per-value device tensor), syncs the index's device scalars,
    recaptures when the fingerprint changed, replays, adds the captured
    launches to the wrappers' counters and returns clones of the outputs.
    """

    def __init__(self, index, rspec, q_shape: tuple, filt: bool) -> None:
        dev = index.device
        self.index = index
        self.rspec = rspec
        self.filt = filt
        self._q = torch.zeros(q_shape, dtype=torch.float32, device=dev)
        self._fb = (torch.zeros((4,), dtype=torch.uint8, device=dev)
                    if rspec.filtered else None)
        self._fb_values: dict = {}
        self._graph = None
        self._out = None
        self._fingerprint = None
        self._launched: dict = {}

    def _run(self, core: IndexCore) -> tuple:
        return self.index._plan_search(core, self._q, self.rspec, self.filt,
                                       self._fb, mirrors=True)

    def _capture(self, core: IndexCore) -> None:
        self._graph = self._out = self._fingerprint = None
        self._graph, self._out, self._launched = capture(
            lambda: self._run(core), self._q.device,
            f"the {self.rspec.fusion} search plan (q {tuple(self._q.shape)}, "
            f"quantized={self.rspec.quantized})")
        self._fingerprint = fingerprint(core)
        self.index.plans.count_trace()

    def _filter_value(self, filter_bytes) -> torch.Tensor:
        """The device copy of one filter value (made once a value)."""
        key = bytes(np.asarray(filter_bytes, dtype=np.uint8).ravel())
        t = self._fb_values.get(key)
        if t is None:
            t = torch.as_tensor(np.frombuffer(key, dtype=np.uint8).copy(),
                                device=self._q.device)
            self._fb_values[key] = t
        return t

    def __call__(self, queries, filter_bytes=None) -> tuple:
        index = self.index
        core = index.core
        if tuple(queries.shape) != tuple(self._q.shape):
            raise ValueError(f"plan for queries {tuple(self._q.shape)} got "
                             f"{tuple(queries.shape)}")
        index._sync_mirrors(core)
        self._q.copy_(queries)
        if self._fb is not None:
            self._fb.copy_(self._filter_value(filter_bytes))
        if fingerprint(core) != self._fingerprint:
            self._capture(core)
        return replay(self._graph, self._out, self._launched)


# ---------------------------------------------------------------------------
# Host-tier plans: the traversal, the rows' fetch, then the rerank
# ---------------------------------------------------------------------------

class HostRerankPlan:
    """Stage two of a host-tier search, keyed ("rerank_host", resolved
    spec, query shape): the rerank over the gathered frontier rows —
    `storage.build_host_rerank_plan`'s, or the one given as `body`
    (`storage.build_sharded_host_rerank_plan`'s, which also takes the
    per-shard hops and merges the shards).

    On the card it owns static buffers for its operands (made at the
    first call, from their shapes) and a CUDA graph of the rerank over
    them, captured once (one trace) and replayed: the gathered rows reach
    the table by a non-blocking copy from the store's pinned staging
    buffer (`upload`). On the CPU the rerank runs eagerly and counts one
    trace at its first call, where a jit would trace (its operands'
    shapes never depend on the core's).
    """

    def __init__(self, index, rspec, body=None) -> None:
        self.index = index
        self.rspec = rspec
        self._body = build_host_rerank_plan(rspec) if body is None else body
        self._traced = False
        self._bufs = None          # (queries, ids, table, table_sq, *extra)
        self._ids_host = None      # pinned copy of the frontier ids
        self._graph = self._out = None
        self._launched: dict = {}

    def ids_to_host(self, frontier_ids: torch.Tensor) -> torch.Tensor:
        """The frontier ids on the host: the search's one synchronisation
        (through a pinned buffer on the card)."""
        if not frontier_ids.is_cuda:
            return frontier_ids
        if self._ids_host is None:
            self._ids_host = torch.empty(frontier_ids.shape,
                                         dtype=frontier_ids.dtype,
                                         pin_memory=True)
        self._ids_host.copy_(frontier_ids, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self._ids_host

    def upload(self, queries, frontier_ids, rows, sq, *extra) -> None:
        """Copy one batch's operands into the static buffers (card)."""
        if self._bufs is None:
            dev = queries.device
            self._bufs = (torch.empty_like(queries),
                          torch.empty_like(frontier_ids),
                          torch.empty(rows.shape, dtype=torch.float32,
                                      device=dev),
                          torch.empty(sq.shape, dtype=torch.float32,
                                      device=dev),
                          *(torch.empty_like(e) for e in extra))
        q, ids, table, table_sq, *ex = self._bufs
        q.copy_(queries)
        ids.copy_(frontier_ids)
        for buf, e in zip(ex, extra):
            buf.copy_(e)
        self.index.store.upload(rows, sq, table, table_sq)

    def replay(self) -> tuple:
        """The rerank over the static buffers (captured at first use)."""
        if self._graph is None:
            self._graph, self._out, self._launched = capture(
                lambda: self._body(*self._bufs), self._bufs[0].device,
                f"the host-tier rerank plan (q {tuple(self._bufs[0].shape)})")
            self.index.plans.count_trace()
        return replay(self._graph, self._out, self._launched)

    def __call__(self, queries, frontier_ids, rows, sq, *extra) -> tuple:
        if not queries.is_cuda:
            if not self._traced:
                self.index.plans.count_trace()
                self._traced = True
            return self._body(queries, frontier_ids, rows, sq, *extra)
        self.upload(queries, frontier_ids, rows, sq, *extra)
        return self.replay()


class HostTierPlan:
    """A host-tier search (rerank_source="host"): the traversal plan
    (keyed as any search; captured on the megakernel lanes) returns the
    full-width estimator frontier; its ids come to the host, the store
    gathers their rows, and the rerank plan scores them. Returns what
    `core_search` returns on the device tier, bit for bit."""

    def __init__(self, index, traversal, rerank: HostRerankPlan) -> None:
        self.index = index
        self.traversal = traversal
        self.rerank = rerank

    def __call__(self, queries, filter_bytes=None) -> tuple:
        out = self.traversal(queries, filter_bytes)
        f_ids = out[0]
        rows, sq = self.index.store.gather(self.rerank.ids_to_host(f_ids))
        ids, dists = self.rerank(queries, f_ids, rows, sq)
        return (ids, dists, out[2]) + tuple(out[3:])


class ShardedHostTierPlan(HostTierPlan):
    """A host-tier search of a `ShardedJasperIndex`: the traversal returns
    each shard's frontier stacked (S, Q, L), the store holds the stacked
    rows (S*cap, D), so a frontier entry's row is at shard*cap + local;
    one gather a search, then the sharded rerank plan reranks each shard
    and merges them. Telemetry, stacked by the traversal, sums over the
    shards in int32. Returns what the device tier returns, bit for bit."""

    def __call__(self, queries, filter_bytes=None) -> tuple:
        out = self.traversal(queries, filter_bytes)
        f_ids = out[0]
        ids_h = self.rerank.ids_to_host(f_ids).to(torch.int64)
        shard = torch.arange(ids_h.shape[0]).reshape(-1, 1, 1) \
            * self.index.cap
        positions = torch.where(ids_h >= 0, ids_h + shard,
                                torch.full_like(ids_h, -1))
        rows, sq = self.index.store.gather(positions)
        merged = tuple(self.rerank(queries, f_ids, rows, sq, out[2]))
        if len(out) > 3:
            tel = out[3]
            merged += (type(tel)(*(t.sum(0, dtype=t.dtype) for t in tel)),)
        return merged
