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
    `HostRerankPlan` keyed ("rerank_host", resolved spec, query shape)
    (a sharded index's: a `ShardedRerankPlan`, one a position), captured
    on the card, with the frontier ids' trip to the host and the store's
    gather of their rows between them.

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

A plan searches a `PlanTarget`: a device, the core to search (read at
each call), the search itself `(core, queries, spec, liveness,
filter_bytes, mirrors=...)`, the sync of the device mirrors before a
replay, and what counts a trace. `target_of(index)` is an index's:
for a `JasperIndex` `core_search` on its core; for a
`ShardedJasperIndex` (core/distributed.py) on a mesh of one position
every shard's `core_search` on its slices of the stacked core, then the
merge — so a sharded megakernel search is ONE captured graph, each shard
reading its own mirrors, and `fingerprint` of the stacked core covers
every shard's buffers.

On a mesh of several positions (each on its own device, or repeating
one) a search is a `PositionsPlan`: one of the plans above a searching
position, whose target is that position's core, device, search of its
shards over its query slice and mirrors, run with the position's device
current, so each position's graph is captured on its device's capture
stream and replayed on its current stream; then the outputs gathered on
the home device and merged there. A sharded index's host-tier search,
on one position or several, reranks with a `ShardedRerankPlan`: one
gather of every position's frontier rows, each position's part uploaded
to its device and reranked there, then gathered and merged.

Launch counters: the kernel wrappers count their launches in Python, and
a replay bypasses them. So a capture takes back what its warm-up and the
capture itself counted, and each replay adds the captured launches: one
search through a plan counts what one eager search counts.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Callable

import numpy as np
import torch

from repro_torch.core.index_core import IndexCore
from repro_torch.core.storage import (build_host_rerank_plan,
                                      build_shard_rerank)
from repro_torch.device import on_device


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


@dataclass(frozen=True)
class PlanTarget:
    """What a plan searches: `device`; `core()`, the core to search (read
    at each call); `search(core, queries, rspec, filt, filter_bytes,
    mirrors=...)`; `sync_mirrors(core)`, run before a replay; and
    `on_trace()`, called at each (re)capture or trace."""

    device: torch.device
    core: Callable[[], IndexCore]
    search: Callable[..., tuple]
    sync_mirrors: Callable[[IndexCore], None]
    on_trace: Callable[[], None]


def target_of(index) -> PlanTarget:
    """An index's own target: its device, its core, its `_plan_search`
    and `_sync_mirrors`, and its plan cache's trace count."""
    return PlanTarget(index.device, lambda: index.core, index._plan_search,
                      index._sync_mirrors, index.plans.count_trace)


def make_plan(target: PlanTarget, rspec, q_shape: tuple, filt: bool):
    """The plan for one cache key: captured on the card when the lane
    allows it, else eager."""
    if target.device.type == "cuda" and capturable(rspec):
        return GraphPlan(target, rspec, q_shape, filt)
    return EagerPlan(target, rspec, filt)


class EagerPlan:
    """`core_search` at each call; a trace counted where a jit would
    trace: the first call, and the first after the shapes changed."""

    def __init__(self, target: PlanTarget, rspec, filt: bool) -> None:
        self.target = target
        self.rspec = rspec
        self.filt = filt
        self._signature = None

    def __call__(self, queries, filter_bytes=None) -> tuple:
        core = self.target.core()
        sig = shape_signature(core)
        if sig != self._signature:
            self.target.on_trace()
            self._signature = sig
        return self.target.search(
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
    cur = torch.cuda.current_stream(device)
    stream = _capture_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.device(device), torch.cuda.stream(stream):
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

    def __init__(self, target: PlanTarget, rspec, q_shape: tuple,
                 filt: bool) -> None:
        dev = target.device
        self.target = target
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
        return self.target.search(core, self._q, self.rspec, self.filt,
                                  self._fb, mirrors=True)

    def _capture(self, core: IndexCore) -> None:
        self._graph = self._out = self._fingerprint = None
        self._graph, self._out, self._launched = capture(
            lambda: self._run(core), self._q.device,
            f"the {self.rspec.fusion} search plan (q {tuple(self._q.shape)}, "
            f"quantized={self.rspec.quantized})")
        self._fingerprint = fingerprint(core)
        self.target.on_trace()

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
        core = self.target.core()
        if tuple(queries.shape) != tuple(self._q.shape):
            raise ValueError(f"plan for queries {tuple(self._q.shape)} got "
                             f"{tuple(queries.shape)}")
        self.target.sync_mirrors(core)
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
    (`storage.build_shard_rerank`'s, a sharded index's shards reranked
    and their ids made global). It uploads through `store` and calls
    `on_trace` where it traces.

    On the card it owns static buffers for its operands (made at the
    first call, from their shapes) and a CUDA graph of the rerank over
    them, captured once (one trace) and replayed: the gathered rows reach
    the table by a non-blocking copy from the store's pinned staging
    buffer (`upload`). On the CPU the rerank runs eagerly and counts one
    trace at its first call, where a jit would trace (its operands'
    shapes never depend on the core's).
    """

    def __init__(self, rspec, body=None, *, store, on_trace) -> None:
        self.rspec = rspec
        self.store = store
        self.on_trace = on_trace
        self._body = build_host_rerank_plan(rspec) if body is None else body
        self._traced = False
        self._bufs = None          # (queries, ids, table, table_sq)
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
        torch.cuda.current_stream(frontier_ids.device).synchronize()
        return self._ids_host

    def upload(self, queries, frontier_ids, rows, sq) -> None:
        """Copy one batch's operands into the static buffers (card)."""
        if self._bufs is None:
            dev = queries.device
            self._bufs = (torch.empty_like(queries),
                          torch.empty_like(frontier_ids),
                          torch.empty(rows.shape, dtype=torch.float32,
                                      device=dev),
                          torch.empty(sq.shape, dtype=torch.float32,
                                      device=dev))
        q, ids, table, table_sq = self._bufs
        q.copy_(queries)
        ids.copy_(frontier_ids)
        self.store.upload(rows, sq, table, table_sq)

    def replay(self) -> tuple:
        """The rerank over the static buffers (captured at first use)."""
        if self._graph is None:
            self._graph, self._out, self._launched = capture(
                lambda: self._body(*self._bufs), self._bufs[0].device,
                f"the host-tier rerank plan (q {tuple(self._bufs[0].shape)})")
            self.on_trace()
        return replay(self._graph, self._out, self._launched)

    def finish(self, queries, out: tuple) -> tuple:
        """A single-device search's end from its traversal's output: the
        frontier ids to the host, their rows gathered from the store and
        reranked; the hops and telemetry passed on."""
        f_ids = out[0]
        rows, sq = self.store.gather(self.ids_to_host(f_ids))
        ids, dists = self(queries, f_ids, rows, sq)
        return (ids, dists, out[2]) + tuple(out[3:])

    def __call__(self, queries, frontier_ids, rows, sq) -> tuple:
        if not queries.is_cuda:
            if not self._traced:
                self.on_trace()
                self._traced = True
            return self._body(queries, frontier_ids, rows, sq)
        self.upload(queries, frontier_ids, rows, sq)
        return self.replay()


class HostTierPlan:
    """A host-tier search (rerank_source="host"): the traversal plan
    (keyed as any search; captured on the megakernel lanes) returns the
    full-width estimator frontier — for a sharded index each searching
    position's, a list — and the rerank plan finishes the search from it
    (`HostRerankPlan.finish`, `ShardedRerankPlan.finish`). Returns what
    the device tier returns, bit for bit."""

    def __init__(self, traversal, rerank) -> None:
        self.traversal = traversal
        self.rerank = rerank

    def __call__(self, queries, filter_bytes=None) -> tuple:
        return self.rerank.finish(queries,
                                  self.traversal(queries, filter_bytes))


# ---------------------------------------------------------------------------
# The sharded index's plans: its positions, its host tier
# ---------------------------------------------------------------------------

class PositionsPlan:
    """A search of a `ShardedJasperIndex` whose shards lie on several mesh
    positions: a plan a searching position (`make_plan` on the position's
    target, `index.position_target`: captured on the card's megakernel
    lanes, else eager) run with the position's device current over its
    slice of the queries, then the outputs gathered onto the home device
    in shard order and merged there (`index._gather`, `index._merge`). A
    call that (re)captures or traces any position counts one trace."""

    def __init__(self, index, rspec, q_shape: tuple, filt: bool) -> None:
        self.index = index
        self.rspec = rspec
        self.positions = index.searching_positions()
        self._traced = False
        self.plans = [make_plan(index.position_target(p, self._note_trace),
                                rspec, index.slice_shape(p, q_shape), filt)
                      for p in self.positions]

    def _note_trace(self) -> None:
        self._traced = True

    def local(self, queries, filter_bytes=None) -> list:
        """Each searching position's own outputs, on its device."""
        self._traced = False
        outs = []
        for p, plan in zip(self.positions, self.plans):
            with on_device(p.device):
                outs.append(plan(self.index.query_slice(p, queries),
                                 filter_bytes))
        if self._traced:
            self.index.plans.count_trace()
        return outs

    def __call__(self, queries, filter_bytes=None) -> tuple:
        outs = self.local(queries, filter_bytes)
        return self.index._merge(self.index._gather(self.positions, outs),
                                 self.rspec)


class ShardedRerankPlan:
    """Stage two of a `ShardedJasperIndex`'s host-tier search, keyed
    ("rerank_host", cap, resolved spec, query shape), on one position or
    several: a `HostRerankPlan` a searching position over its shards
    (`storage.build_shard_rerank`).

    `finish(queries, outs)` takes each position's traversal output — its
    shards' frontiers stacked (S', Q_m, L), on its device — brings their
    ids to the host (a synchronisation a position), gathers every frontier
    row at once (one fetch a search; row shard*cap + local of the stacked
    host rows), uploads each position's part to its device and reranks it
    there, then gathers the reranked shards home and merges them
    (`index._gather`, `index._merge_global`): n_hops the max over shards,
    telemetry the int32 sum. Returns what the device tier returns, bit for
    bit. A call that captures or traces any position's rerank counts one
    trace."""

    def __init__(self, index, rspec) -> None:
        self.index = index
        self.rspec = rspec
        self.positions = index.searching_positions()
        self._traced = False
        self.reranks = [HostRerankPlan(
            rspec, build_shard_rerank(rspec, id_stride=index.id_stride,
                                      first_shard=p.shards.start),
            store=index.store, on_trace=self._note_trace)
            for p in self.positions]

    def _note_trace(self) -> None:
        self._traced = True

    def finish(self, queries, outs: list) -> tuple:
        index = self.index
        self._traced = False
        rows_at = []
        for p, rerank, out in zip(self.positions, self.reranks, outs):
            ids = rerank.ids_to_host(out[0]).to(torch.int64)
            shard = (p.shards.start
                     + torch.arange(ids.shape[0])).reshape(-1, 1, 1)
            rows_at.append(torch.where(ids >= 0, ids + shard * index.cap,
                                       torch.full_like(ids, -1)))
        rows, sq = index.store.gather(torch.cat([r.reshape(-1)
                                                 for r in rows_at]))
        reranked, at = [], 0
        for p, rerank, out, r in zip(self.positions, self.reranks, outs,
                                     rows_at):
            m = r.numel()
            with on_device(p.device):
                gids, dists = rerank(index.query_slice(p, queries), out[0],
                                     rows[at:at + m], sq[at:at + m])
            reranked.append((gids, dists) + tuple(out[2:]))
            at += m
        if self._traced:
            index.plans.count_trace()
        g = index._gather(self.positions, reranked)
        return index._merge_global(g[0], g[1], g[2],
                                   g[3] if len(g) > 3 else None,
                                   self.rspec.k)
