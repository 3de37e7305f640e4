"""Online ANNS update/serve loop over one index (port of
`repro.serving.anns_service`: the same names, stats and contract), a
`JasperIndex` or a row-sharded `ShardedJasperIndex`
(core/distributed.py).

The paper's deployment ("built for change"): one index serves
interleaved insert / delete / search batches with no rebuilds and no
downtime.

  * mutations and searches are BATCHED — the host loop is the stream
    scheduler, the device sees fixed-shape work: on the card each search
    is a replayed CUDA graph (core/plans.py);
  * the search configuration is a `SearchSpec`, resolved once into a
    `Searcher` session whose plans every tick reuses;
  * every mutation bumps the index's generation counter; every search
    result is stamped with the generation it was served at. All work
    runs on one stream in the order it is queued, so a search reads the snapshot of
    its generation even while later mutations are queued behind it;
  * searches NEVER return tombstoned ids. The index guarantees it; the
    service re-checks every served batch with `verify=True` (O(Q*k) on
    the host) — the generation stamp plus this invariant is the
    service's serving contract;
  * deletes are tombstone-cheap; `consolidate` triggers automatically
    once the tombstone load factor passes `consolidate_threshold`;
  * consecutive search batches pipeline through the Searcher's
    `submit()/drain()` double buffer.

`step()` is one tick (deletes -> maybe-consolidate -> inserts ->
searches); `run()` drives a whole op stream; `serve()` replays an
open-loop arrival trace through the standing-query scheduler
(serving/scheduler.py). With a `rebalance_threshold`, a tick over a
sharded index whose per-shard live counts drift apart (skewed deletes)
runs `index.rebalance()` and surfaces the old->new id translation for
outstanding tickets in `StepResult.rebalanced`; on a single-device index
`maybe_rebalance` returns None.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Iterable, NamedTuple

import numpy as np

import torch

from repro_torch.core.mutations import N_LABELS
from repro_torch.core.search_spec import (
    SearchResult,
    SearchSpec,
    to_host,
    check_quantized_backend,
    check_rows_tier,
)
from repro_torch.obs.tracing import span as obs_span

# One stamped-result type across the stack: the service's ticket IS the
# core's search result (ids, dists, n_hops, generation).
SearchTicket = SearchResult

__all__ = ["AnnsService", "SearchTicket", "StepResult", "ServiceStats",
           "TenantStats"]


class StepResult(NamedTuple):
    """Outcome of one scheduler tick."""

    inserted_ids: np.ndarray | None
    n_deleted: int
    consolidated: dict | None
    search: SearchTicket | None
    # rebalance stats when the shard-imbalance trigger fired this tick;
    # rebalanced["translation"] remaps outstanding ticket ids (moved rows
    # get new global ids — unmoved ids translate to themselves)
    rebalanced: dict | None = None


@dataclass
class ServiceStats:
    """Monotonic service counters (host-side, cheap)."""

    n_inserts: int = 0
    n_insert_rows: int = 0
    n_deletes: int = 0
    n_delete_rows: int = 0
    n_searches: int = 0
    n_search_queries: int = 0
    n_consolidations: int = 0
    n_rebalances: int = 0
    n_rebalance_rows: int = 0
    n_grows: int = 0
    last_generation: int = 0
    # greedy-walk work actually served (SearchResult.n_hops, summed over
    # every query): hops_sum/n_search_queries is the service-lifetime
    # mean, last_mean_hops the most recent tick's
    hops_sum: float = 0.0
    last_mean_hops: float = 0.0

    @property
    def mean_hops(self) -> float:
        """Mean greedy-walk hops per served query (service lifetime)."""
        return self.hops_sum / self.n_search_queries \
            if self.n_search_queries else 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__, mean_hops=self.mean_hops)

    def to_dict(self) -> dict:
        """Plain-JSON snapshot: guarded derived rates included, every
        value a native scalar (numpy leaks coerced) — `json.dumps`-able
        as-is."""
        from repro_torch.obs.metrics import plain_json
        return plain_json(self.as_dict())


@dataclass
class TenantStats:
    """One tenant namespace's counters: the label bit that encodes the
    namespace, the row quota, and per-tenant activity. `live` is the
    row count the quota is enforced against."""

    label: int
    quota_rows: int | None = None
    n_inserted: int = 0
    n_deleted: int = 0
    n_searches: int = 0
    n_search_queries: int = 0
    last_generation: int = 0

    @property
    def live(self) -> int:
        return self.n_inserted - self.n_deleted

    def as_dict(self) -> dict:
        return dict(self.__dict__, live=self.live)


class AnnsService:
    """Interleaved insert/delete/search serving over one index
    (the port's JasperIndex).

    Multi-tenancy is a thin veneer over label filtering: a tenant is a
    label bit (`register_tenant`), tenant inserts stamp that bit on their
    rows, and tenant searches serve the service spec with
    `filter=(bit,)` — partition-valued filters through the SAME fused
    kernel epilogue as liveness, so tenant isolation costs one extra
    byte-gather per candidate and ZERO extra compiled plans (filter
    values are runtime operands; only filter PRESENCE is in the plan
    key)."""

    def __init__(self, index, *, spec: SearchSpec | None = None,
                 k: int = 10, beam_width: int | None = None,
                 use_kernels: bool = False, quantized: bool | None = None,
                 consolidate_threshold: float = 0.25,
                 rebalance_threshold: float = 0.0,
                 verify: bool = True):
        """
        spec: the search configuration to serve (a `SearchSpec`) — the
        preferred surface. When omitted, the legacy tuning kwargs
        (k/beam_width/use_kernels/quantized) build one, with a
        DeprecationWarning on any non-default value; `quantized=None`
        auto-detects (True iff the index was built with
        quantization='rabitq') and never warns. Passing BOTH a spec and
        legacy tuning kwargs is an error.
        consolidate_threshold: tombstone load factor that triggers automatic
        graph repair at the next tick (<= 0 disables auto-consolidation).
        rebalance_threshold: per-shard live-count imbalance ((max-min)/mean)
        that triggers a rebalance between ticks (<= 0 disables; only
        meaningful for indexes that expose `rebalance`, i.e. the
        sharded backend — a single-device index never triggers).
        verify: re-check the no-tombstoned-ids contract on every served
        batch (host-side O(Q*k); raise on violation).
        """
        self.index = index
        legacy = (k != 10 or beam_width is not None or use_kernels
                  or quantized is not None)
        if spec is not None:
            if legacy:
                raise ValueError(
                    "pass either spec= or the legacy tuning kwargs "
                    "(k/beam_width/use_kernels/quantized), not both")
            self.spec = spec
        else:
            if legacy:
                warnings.warn(
                    "AnnsService legacy tuning kwargs are deprecated — "
                    "pass spec=SearchSpec(...) instead "
                    "(see the SearchSpec documentation)",
                    DeprecationWarning, stacklevel=2)
            self.spec = SearchSpec(
                k=k, beam_width=beam_width, use_kernels=use_kernels,
                quantized=(index.quantization == "rabitq"
                           if quantized is None else quantized))
        # fail fast on static spec errors and backend mismatch; the
        # codes-presence half of the check runs at session creation — a
        # quantized service may legitimately be constructed BEFORE the
        # first build/insert trains the quantizer
        resolved = self.spec.resolve()
        if self.spec.quantized:
            check_quantized_backend(index, need_codes=False)
        # tier mismatch fails HERE, at service construction, not at the
        # first tick's trace: a host-source service needs the rows
        # evicted, a device-source one needs them resident
        check_rows_tier(index, resolved.rerank_source)
        self.consolidate_threshold = consolidate_threshold
        self.rebalance_threshold = rebalance_threshold
        self.verify = verify
        self.stats = ServiceStats()
        self._searcher = None             # lazy compiled session
        self._tenants: dict[str, TenantStats] = {}
        self._tenant_searchers: dict = {}  # (name, mode) -> session
        self._metrics = None              # lazy MetricsRegistry
        self._hops_hist = None
        self._occ_hist = None
        self._lat_hist = None
        self._scheduler = None            # last standing-query scheduler
        self._batch_occ_hist = None

    # ------------------------------------------------------------------ ops
    @property
    def generation(self) -> int:
        return self.index.generation

    @property
    def k(self) -> int:
        return self.spec.k

    def searcher(self, k: int | None = None, **overrides):
        """The service's compiled search session (k / legacy-kwarg
        overrides derive a sibling session; plans share the index's
        cache either way)."""
        if k is not None and k != self.spec.k:
            overrides["k"] = k
        if overrides:
            return self.index.searcher(self.spec.with_(**overrides))
        if self._searcher is None:
            self._searcher = self.index.searcher(self.spec)
        return self._searcher

    def metrics(self):
        """The service's unified metrics plane (lazily created).

        One `MetricsRegistry` folding ServiceStats (`service.*`), the
        index's plan-cache counters (`plan_cache.*`), and per-shard
        live/imbalance gauges (`shards.*`) as snapshot-time collectors,
        plus the search histograms (`search.latency_us`, `search.hops`,
        `search.beam_occupancy` — occupancy fills only when the served
        spec has telemetry="on"). Never touching this method keeps the
        serve loop metrics-free: histograms observe only once the
        registry exists.
        """
        if self._metrics is None:
            from repro_torch.obs import metrics as obs_metrics
            reg = obs_metrics.MetricsRegistry()
            reg.register_collector(
                "service", obs_metrics.service_stats_collector(self))
            reg.register_collector(
                "plan_cache", obs_metrics.plan_cache_collector(self.index))
            reg.register_collector(
                "shards", obs_metrics.shard_gauge_collector(self.index))
            # the CURRENT standing-query scheduler (no scheduler yet ->
            # no scheduler.* keys, not stale zeros)
            reg.register_collector(
                "scheduler", obs_metrics.scheduler_stats_collector(
                    lambda: self._scheduler))
            # per-tenant namespaces: tenants.<name>.<counter> (no
            # tenants registered -> no tenants.* keys)
            reg.register_collector(
                "tenants", lambda: {
                    f"{n}.{k}": v
                    for n, t in self._tenants.items()
                    for k, v in t.as_dict().items()})
            # tiered-storage plane: per-tier resident bytes + host-fetch
            # counters (no tiered store on the index -> no storage.* keys)
            reg.register_collector(
                "storage", obs_metrics.storage_stats_collector(self.index))
            store = getattr(self.index, "store", None)
            if store is not None:
                store.fetch_hist = reg.histogram(
                    "storage.fetch_latency_us",
                    obs_metrics.FETCH_LATENCY_BUCKETS_US)
            self._lat_hist = reg.histogram(
                "search.latency_us", obs_metrics.SEARCH_LATENCY_BUCKETS_US)
            self._hops_hist = reg.histogram(
                "search.hops", obs_metrics.HOPS_BUCKETS)
            self._occ_hist = reg.histogram(
                "search.beam_occupancy", obs_metrics.BEAM_OCCUPANCY_BUCKETS)
            self._batch_occ_hist = reg.histogram(
                "scheduler.batch_occupancy",
                obs_metrics.BATCH_OCCUPANCY_BUCKETS)
            if self._scheduler is not None:
                self._scheduler.occupancy_hist = self._batch_occ_hist
            self._metrics = reg
        return self._metrics

    def metrics_snapshot(self) -> dict:
        """ONE plain-JSON dict over service, plan-cache, per-shard gauges,
        and the search histograms — the telemetry plane's export."""
        return self.metrics().snapshot()

    def insert(self, vectors, *, labels=None) -> np.ndarray:
        """Batch insert; returns assigned row ids (freed slots reused).
        labels: optional per-row label sets stamped at insert (see
        `core.mutations.pack_label_rows` for accepted forms)."""
        with obs_span("service.insert"):
            cap_before = self.index.capacity
            ids = self.index.insert(vectors, labels=labels)
            self.stats.n_inserts += 1
            self.stats.n_insert_rows += int(ids.size)
            self.stats.n_grows += int(self.index.capacity != cap_before)
            self._stamp()
        return ids

    def delete(self, ids) -> int:
        """Batch tombstone delete; graph repair is deferred/amortized."""
        with obs_span("service.delete"):
            n = self.index.delete(ids)
            self.stats.n_deletes += 1
            self.stats.n_delete_rows += n
            self._stamp()
        return n

    def _finish(self, res: SearchResult) -> SearchTicket:
        """Host-land a search result: verify the serving contract, fold
        the hop counts into the stats, stamp the ticket."""
        ids = to_host(res.ids)
        n_hops = to_host(res.n_hops)
        if self.verify:
            # O(Q*k): gather only the returned ids' tombstone bits — the
            # full bitmap never unpacks on the serving path (the index's
            # shared `tombstoned` hook also folds the high-water check;
            # for the sharded backend it is per shard)
            returned = ids[ids >= 0]
            dead = returned[self.index.tombstoned(returned)]
            if dead.size:
                raise AssertionError(
                    f"serving contract violated: tombstoned ids returned "
                    f"at generation {res.generation}: {dead[:8].tolist()}")
        self.stats.n_searches += 1
        self.stats.n_search_queries += int(ids.shape[0])
        self.stats.hops_sum += float(n_hops.sum())
        self.stats.last_mean_hops = float(n_hops.mean()) if n_hops.size \
            else 0.0
        self._stamp()
        tel = res.telemetry
        if tel is not None:
            tel = type(tel)(*(to_host(t) for t in tel))
        if self._metrics is not None:
            self._hops_hist.observe_many(n_hops.tolist())
            if tel is not None:
                occ = tel.occupancy
                # hops a row never ran stay 0 in the log — only real
                # per-hop occupancies feed the histogram
                self._occ_hist.observe_many(occ[occ > 0].tolist())
        return SearchTicket(ids=ids, dists=to_host(res.dists),
                            n_hops=n_hops, generation=res.generation,
                            telemetry=tel, estimated=res.estimated)

    def search(self, queries, k: int | None = None, **kw) -> SearchTicket:
        """Serve one search batch at the current snapshot generation.

        Extra keyword overrides (beam_width, use_kernels, ...) are the
        legacy per-call surface: they derive a sibling spec for this call
        (DeprecationWarning) — prefer one spec per configuration."""
        # None means "keep the service default" in the legacy surface
        kw = {f: v for f, v in kw.items() if v is not None}
        if kw:
            warnings.warn(
                "per-call search kwargs are deprecated — serve a "
                "spec=SearchSpec(...) configuration instead "
                "(see the SearchSpec documentation)",
                DeprecationWarning, stacklevel=2)
        with obs_span("service.search"):
            t0 = time.perf_counter()
            ticket = self._finish(self.searcher(k, **kw).search(queries))
            if self._metrics is not None:
                self._lat_hist.observe((time.perf_counter() - t0) * 1e6)
        return ticket

    MAX_INFLIGHT = 2        # double buffer: bound queued device work
    _FLUSH_EVERY = 16       # run(): bound the buffered search-op payloads

    def search_many(self, query_batches, k: int | None = None
                    ) -> list[SearchTicket]:
        """Serve several batches through the session's submit/drain double
        buffer: host scheduling of batch i+1 overlaps device search of
        batch i (async dispatch), with at most `MAX_INFLIGHT` batches
        queued on the device — so an arbitrarily long batch list runs in
        bounded memory. Between-batch mutations are impossible here, so
        every ticket carries the same snapshot generation."""
        ses = self.searcher(k)
        tickets: list[SearchTicket] = []
        for q in query_batches:
            if ses.submit(q) >= self.MAX_INFLIGHT:
                tickets += [self._finish(r) for r in ses.drain(1)]
        return tickets + [self._finish(r) for r in ses.drain()]

    # ------------------------------------------------------ tenant namespaces
    def register_tenant(self, name: str, *,
                        quota_rows: int | None = None) -> int:
        """Open a tenant namespace: assigns the next free label bit and
        returns it. At most `core.mutations.N_LABELS` tenants per index
        (the label-plane width). quota_rows bounds the tenant's live rows
        — `tenant_insert` raises past it."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        used = {t.label for t in self._tenants.values()}
        free = [b for b in range(N_LABELS) if b not in used]
        if not free:
            raise ValueError(
                f"label plane exhausted: at most {N_LABELS} tenants "
                "per index (core.mutations.N_LABELS)")
        self._tenants[name] = TenantStats(label=free[0],
                                          quota_rows=quota_rows)
        return free[0]

    @property
    def tenants(self) -> tuple:
        return tuple(self._tenants)

    def tenant_spec(self, name: str, **overrides) -> SearchSpec:
        """The service spec scoped to a tenant: `filter=(bit,)` plus any
        overrides — the spec to hand a scheduler lane. Lanes for two
        tenants differ only in the filter VALUE, so they share every
        compiled plan (presence-only plan keys)."""
        ts = self._tenants[name]
        return self.spec.with_(filter=(ts.label,), **overrides)

    def _tenant_member_mask(self, ts: TenantStats, ids) -> np.ndarray:
        """Host-side membership test: does each GLOBAL id's label row
        carry the tenant's bit? (O(n) gather over the label plane — the
        verify/ownership check, never on the device hot path.)"""
        ids = np.asarray(ids, np.int64)
        idx = self.index
        if hasattr(idx, "id_stride"):       # sharded: stacked row position
            pos = (ids // idx.id_stride) * idx.cap + ids % idx.id_stride
            n_rows = idx.capacity
            row = idx.label_rows(ids)
        else:
            pos = ids
            labs = idx.core.mut.labels
            n_rows = labs.shape[0]
            row = labs[torch.as_tensor(np.clip(pos, 0, n_rows - 1),
                                       device=labs.device)].cpu().numpy()
        bit = np.uint8(1 << (ts.label & 7))
        ok = (row[:, ts.label >> 3] & bit) != 0
        return ok & (pos >= 0) & (pos < n_rows)

    def tenant_insert(self, name: str, vectors) -> np.ndarray:
        """Insert rows into a tenant's namespace: stamps the tenant's
        label bit at insert time. Raises ValueError when the batch would
        push the tenant past its row quota (checked BEFORE any mutation)."""
        ts = self._tenants[name]
        n = int(np.asarray(vectors).shape[0])
        if ts.quota_rows is not None and ts.live + n > ts.quota_rows:
            raise ValueError(
                f"tenant {name!r} quota exceeded: {ts.live} live + {n} "
                f"new > quota_rows {ts.quota_rows}")
        ids = self.insert(vectors, labels=ts.label)
        ts.n_inserted += int(ids.size)
        ts.last_generation = self.index.generation
        return ids

    def tenant_delete(self, name: str, ids) -> int:
        """Delete rows from a tenant's namespace. Raises on ids that do
        not carry the tenant's label (cross-tenant deletes never touch
        the index)."""
        ts = self._tenants[name]
        ids = np.atleast_1d(np.asarray(ids, np.int64)).ravel()
        foreign = ids[~self._tenant_member_mask(ts, ids)]
        if foreign.size:
            raise ValueError(
                f"ids not owned by tenant {name!r}: "
                f"{foreign[:8].tolist()}")
        n = self.delete(ids)
        ts.n_deleted += n
        ts.last_generation = self.index.generation
        return n

    def tenant_search(self, name: str, queries, *,
                      filter_mode: str = "traverse") -> SearchTicket:
        """Serve one batch scoped to a tenant: the service spec with the
        tenant's partition-valued filter. filter_mode="exclude" gates the
        walk itself in the kernel epilogue; "traverse" (default) walks
        the full graph and filters the returned frontier — both return
        ONLY the tenant's rows. With `verify` the isolation contract is
        re-checked host-side per batch."""
        ts = self._tenants[name]
        key = (name, filter_mode)
        ses = self._tenant_searchers.get(key)
        if ses is None:
            ses = self.index.searcher(
                self.tenant_spec(name, filter_mode=filter_mode))
            self._tenant_searchers[key] = ses
        with obs_span("service.tenant_search", tenant=name):
            t0 = time.perf_counter()
            ticket = self._finish(ses.search(queries))
            if self._metrics is not None:
                self._lat_hist.observe((time.perf_counter() - t0) * 1e6)
        if self.verify:
            returned = ticket.ids[ticket.ids >= 0]
            leak = returned[~self._tenant_member_mask(ts, returned)]
            if leak.size:
                raise AssertionError(
                    f"tenant isolation violated: ids outside tenant "
                    f"{name!r} returned: {leak[:8].tolist()}")
        ts.n_searches += 1
        ts.n_search_queries += int(ticket.ids.shape[0])
        ts.last_generation = ticket.generation
        return ticket

    def tenant_stats(self, name: str | None = None) -> dict:
        """Per-tenant counters: one tenant's dict, or {name: dict} for
        all (the `tenants.*` metrics namespace)."""
        if name is not None:
            return self._tenants[name].as_dict()
        return {n: t.as_dict() for n, t in self._tenants.items()}

    # ----------------------------------------- standing-query serving front
    def scheduler(self, *, lanes: dict | None = None, clock=None,
                  **config):
        """Open a standing-query scheduler over this service's index
        (serving/scheduler.py): shape-bucketed coalescing into the plan
        cache's padded batch shapes, deadline-aware flushes, overlapped
        double-buffered dispatch, bounded-queue backpressure.

        The `"default"` lane serves the service's spec; `lanes` adds
        workload classes as {name: spec} or {name: (spec, priority)}
        (lower priority value = dispatched first). `config` kwargs are
        `SchedulerConfig` fields (buckets, slo_budget_s, flush_fraction,
        max_queue, max_inflight). Each call opens a FRESH scheduler
        (fresh queues and counters) — compiled plans persist in the
        index's shared `PlanCache`, so a re-opened scheduler retraces
        nothing. The metrics plane always reads the newest one.
        """
        from repro_torch.serving.scheduler import StandingQueryScheduler
        kw = {"clock": clock} if clock is not None else {}
        sched = StandingQueryScheduler(self.index, self.spec,
                                       **config, **kw)
        for name, entry in (lanes or {}).items():
            spec, priority = entry if isinstance(entry, tuple) \
                else (entry, 0)
            sched.add_lane(name, spec, priority=priority)
        if self._batch_occ_hist is not None:
            sched.occupancy_hist = self._batch_occ_hist
        self._scheduler = sched
        return sched

    def serve(self, trace, queries, *, lanes: dict | None = None,
              scheduler=None, realtime: bool = True, clock=None,
              **config) -> tuple[dict, list]:
        """Replay an open-loop arrival trace (serving/loadgen.py) through
        the standing-query scheduler; THE serving front-end loop.

        trace:    iterable of `Arrival(at, query_id, lane, slo_budget_s)`.
        queries:  (N, D) pool the trace's query_ids index into.
        realtime: honor arrival times (open loop: submission never waits
                  for completions — while the next arrival is in the
                  future the loop keeps polling, so harvest/dispatch
                  overlap admission). False = saturation replay: every
                  arrival is admitted as fast as the queue bound allows
                  (the offered-load -> infinity limit).

        Returns `(report, handles)`: an open-loop serving report (QPS,
        p50/p99 latency, SLO hit rate, flush-reason breakdown, batch
        occupancy) and the
        per-query handles. Completed queries fold into `ServiceStats`
        and the serving contract (no tombstoned ids, ever) is verified
        over every returned ticket when `verify=True`.
        """
        import time as _time

        from repro_torch.serving.scheduler import summarize_handles
        clk = clock or _time.monotonic
        sched = scheduler if scheduler is not None else \
            self.scheduler(lanes=lanes, clock=clk, **config)
        queries = np.asarray(queries, dtype=np.float32)
        handles = []
        t0 = clk()
        with obs_span("service.serve", realtime=realtime):
            for a in trace:
                if realtime:
                    while clk() - t0 < a.at:
                        sched.poll()       # overlap: harvest + dispatch
                handles.append(sched.submit(
                    queries[a.query_id], lane=a.lane,
                    slo_budget_s=a.slo_budget_s))
                sched.poll()
            sched.drain()
        wall = clk() - t0
        done = [h for h in handles if h.status == "done"]
        if done:
            ids = np.concatenate([h.ids for h in done])
            if self.verify:
                returned = ids[ids >= 0]
                dead = returned[self.index.tombstoned(returned)]
                if dead.size:
                    raise AssertionError(
                        "serving contract violated: tombstoned ids "
                        f"returned by the scheduler: {dead[:8].tolist()}")
            self.stats.n_searches += sched.stats.batches
            self.stats.n_search_queries += len(done)
            hops = np.asarray([h.n_hops for h in done], dtype=np.float64)
            self.stats.hops_sum += float(hops.sum())
            self.stats.last_mean_hops = float(hops.mean())
            self._stamp()
            if self._metrics is not None:
                self._hops_hist.observe_many(hops.tolist())
                self._lat_hist.observe_many(
                    [h.latency_s * 1e6 for h in done])
        report = summarize_handles(handles, wall)
        report["flush_reasons"] = sched.stats.flush_reasons()
        report["batches"] = sched.stats.batches
        report["mean_batch_occupancy"] = round(
            sched.stats.mean_batch_occupancy, 4)
        report["padded_rows"] = sched.stats.padded_rows
        return report, handles

    def maybe_consolidate(self, force: bool = False) -> dict | None:
        """Repair the graph if the tombstone load factor warrants it."""
        thresh = self.consolidate_threshold
        trigger = force or (thresh > 0
                            and self.index.deleted_fraction >= thresh
                            and self.index.n_deleted > 0)
        if not trigger:
            return None
        with obs_span("service.consolidate",
                      deleted_fraction=float(self.index.deleted_fraction)):
            stats = self.index.consolidate()
            self.stats.n_consolidations += 1
            self._stamp()
        return stats

    def maybe_rebalance(self, force: bool = False) -> dict | None:
        """Level shard loads if the live-count imbalance warrants it.

        Skewed deletes drift a `ShardedJasperIndex`'s shards uneven; the
        loop repairs that BETWEEN ticks, when `shard_imbalance` reaches
        `rebalance_threshold` (or with `force`). The rebalance runs on
        the one stream after every search queued before it, so no search
        observes a half-moved row. Returns the index's rebalance stats
        (the old->new `translation` for outstanding tickets included), or
        None when the trigger did not fire, nothing moved, or the index
        has no shards (a `JasperIndex`).
        """
        idx = self.index
        if not hasattr(idx, "rebalance"):
            return None                       # single-device backend
        thresh = self.rebalance_threshold
        trigger = force or (thresh > 0 and idx.shard_imbalance >= thresh)
        if not trigger:
            return None
        with obs_span("service.rebalance",
                      imbalance=float(idx.shard_imbalance)):
            stats = idx.rebalance()
        if stats.get("n_moved"):
            self.stats.n_rebalances += 1
            self.stats.n_rebalance_rows += stats["n_moved"]
            self._stamp()
            return stats
        return None

    # ----------------------------------------------------------------- loop
    def step(self, *, inserts=None, deletes=None, queries=None,
             k: int | None = None) -> StepResult:
        """One scheduler tick: deletes -> auto-consolidate -> inserts ->
        searches.

        Deletes run first and consolidation (when the load factor triggers
        it) immediately after, so the insert half of the same tick can
        reuse the slots they free; a shard rebalance (when the imbalance
        trigger fires) follows while the freed slots are still empty;
        searches run last and observe every mutation of the tick, stamped
        with the post-mutation generation.
        """
        with obs_span("service.step"):
            n_del = self.delete(deletes) if deletes is not None else 0
            cons = self.maybe_consolidate()
            reb = self.maybe_rebalance()
            ins = self.insert(inserts) if inserts is not None else None
            ticket = self.search(queries, k) if queries is not None else None
        return StepResult(inserted_ids=ins, n_deleted=n_del,
                          consolidated=cons, search=ticket, rebalanced=reb)

    def run(self, ops: Iterable[tuple[str, Any]]) -> list:
        """Drive an op stream: ("insert", vecs) | ("delete", ids) |
        ("search", queries) | ("consolidate", None) | ("rebalance", None).
        Returns per-op results in order. The stream is consumed LAZILY
        (generators / unbounded queues work); runs of consecutive search
        ops buffer and pipeline through `search_many` (double-buffered
        dispatch, bounded in-flight depth), flushing at the next mutation
        op or every `_FLUSH_EVERY` buffered batches — so a search-only
        unbounded stream still produces tickets and stays in bounded
        memory. Result order is unchanged."""
        out: list = []
        searches: list = []

        def flush() -> None:
            if searches:
                out.extend(self.search_many(searches))
                searches.clear()

        for kind, payload in ops:
            if kind == "search":
                searches.append(payload)
                if len(searches) >= self._FLUSH_EVERY:
                    flush()
                continue
            flush()
            if kind == "insert":
                out.append(self.insert(payload))
            elif kind == "delete":
                out.append(self.delete(payload))
                # deletes drive the load factor — check right away so an
                # insert/delete-only stream still consolidates (and the
                # freed slots recycle), matching step()'s ordering
                self.maybe_consolidate()
                self.maybe_rebalance()
            elif kind == "consolidate":
                out.append(self.maybe_consolidate(force=True))
            elif kind == "rebalance":
                out.append(self.maybe_rebalance(force=True))
            else:
                raise ValueError(f"unknown op {kind!r}")
        flush()
        return out

    def _stamp(self) -> None:
        self.stats.last_generation = self.index.generation
