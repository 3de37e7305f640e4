"""Standing query scheduler: shape-bucketed coalescing, deadline-aware
dispatch, and overlapped streams for open-loop traffic (port of
`repro.serving.scheduler`: the same policy, names and stats).

The paper's throughput headline is measured on pre-formed query batches;
production traffic is a continuous open-loop stream of SINGLE queries
with mixed k/spec and latency SLOs, where one-query-at-a-time dispatch
wastes nearly all of the fused kernels' compute. This module is the
admission-and-dispatch layer that recovers batch-level throughput at
single-query latency (the shape of the real-time adaptive multi-stream
GPU ANNS system, arXiv:2408.02937 — adaptive batch sizing + concurrent
per-class streams):

  * **Shape-bucketed coalescing.** Arrivals queue per *lane* (one lane =
    one `SearchSpec` + priority class) and are coalesced into the padded
    batch shapes of a small static bucket ladder (`BUCKET_LADDER`,
    default 1/8/32/128). A partial batch pads up to its rung
    (`pad_to_bucket`), so every dispatch reuses a full-bucket compiled
    plan: the index's `PlanCache` holds at most lanes x ladder search
    executables and steady-state retraces stay at ZERO across mixed-spec
    traffic, whatever the arrival pattern.
  * **Deadline-aware adaptive batching.** Every query carries an SLO
    budget. A lane flushes when (a) its queue fills the top bucket
    ("full"), (b) ANY queued query's budget is `flush_fraction` spent —
    the earliest deadline across the lane's queue, since per-query
    budgets vary ("deadline" — default half), or (c) the device has
    NOTHING in flight
    ("idle" — batching only ever trades latency for throughput while the
    device is busy; an idle device serves whatever is queued
    immediately). Throughput when loaded, latency when idle.
  * **Overlapped streams.** Dispatch goes through the `Searcher`
    sessions, whose plans are captured CUDA graphs replayed without
    waiting: up to `max_inflight` coalesced batches are queued on the
    device while the host keeps admitting and coalescing the next ones —
    host scheduling of batch t+1 overlaps device execution of batch t.
    Each batch's results are copied to pinned host memory behind a
    `torch.cuda.Event`, and completion is harvested non-blockingly
    (`Event.query`), so `poll()` never stalls the admission loop.
  * **Backpressure.** The standing queue is bounded (`max_queue`): an
    arrival past the bound is shed as a `rejected` ticket instead of
    growing the queue without bound — open-loop overload degrades to
    explicit rejections, not to latency collapse.

The scheduler is a host-driven, single-threaded event loop — the same
execution model as the rest of the serving stack (the host loop is the
stream scheduler, the device only sees fixed-shape captured work). Drive it
with `submit()` + `poll()` from your arrival loop, `drain()` to flush.
`AnnsService.serve()` wraps exactly that loop around a load-generator
trace (serving/loadgen.py). The clock is injectable so every policy
decision is unit-testable with a fake clock (tests/test_torch_scheduler.py) —
no wall-clock sleeps anywhere.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.search_spec import (
    BUCKET_LADDER,
    PendingResult,
    SearchResult,
    SearchSpec,
    pad_to_bucket,
)
from repro_torch.obs.tracing import span as obs_span

__all__ = [
    "FLUSH_REASONS", "QueryHandle", "SchedulerConfig", "SchedulerStats",
    "StandingQueryScheduler", "summarize_handles",
]

# Why a batch left the queue — the flush-reason breakdown the metrics
# plane exports (scheduler.flush_full / _deadline / _idle / _drain).
FLUSH_REASONS = ("full", "deadline", "idle", "drain")

QUEUED, INFLIGHT, DONE, REJECTED = "queued", "inflight", "done", "rejected"


@dataclass(frozen=True)
class SchedulerConfig:
    """The scheduler's tuning knobs.

    buckets:        static padded-batch shape ladder. Keep it SMALL and
                    stable — each rung is one compiled plan per lane.
    slo_budget_s:   default per-query latency budget (submit() can
                    override per query).
    flush_fraction: flush a partial batch once the oldest query has spent
                    this fraction of its budget queueing (0.5 = the
                    budget-half-spent rule: the remaining half covers
                    device execution + queue-behind-inflight time).
    max_queue:      standing-queue bound across all lanes; arrivals past
                    it are shed as `rejected` tickets (backpressure).
    max_inflight:   coalesced batches queued on the device at once (2 =
                    double buffer: host coalesces t+1 while t executes).
    """

    buckets: tuple = BUCKET_LADDER
    slo_budget_s: float = 0.050
    flush_fraction: float = 0.5
    max_queue: int = 1024
    max_inflight: int = 2

    def __post_init__(self):
        if not self.buckets or min(self.buckets) < 1:
            raise ValueError(f"buckets must be positive ints, "
                             f"got {self.buckets!r}")
        if not (0.0 < self.flush_fraction <= 1.0):
            raise ValueError("flush_fraction must be in (0, 1], "
                             f"got {self.flush_fraction}")
        if self.max_queue < 1 or self.max_inflight < 1:
            raise ValueError("max_queue and max_inflight must be >= 1")
        object.__setattr__(self, "buckets",
                           tuple(sorted(int(b) for b in self.buckets)))


class QueryHandle:
    """One standing query's lifecycle: queued -> inflight -> done (or
    rejected at admission). Carries its own slice of the coalesced
    batch's result — padding rows are never visible here."""

    __slots__ = ("query", "lane", "slo_budget_s", "status",
                 "t_submit", "t_dispatch", "t_done",
                 "ids", "dists", "n_hops", "generation", "estimated")

    def __init__(self, query, lane: str, slo_budget_s: float,
                 t_submit: float, status: str = QUEUED):
        self.query = query
        self.lane = lane
        self.slo_budget_s = slo_budget_s
        self.status = status
        self.t_submit = t_submit
        self.t_dispatch: float | None = None
        self.t_done: float | None = None
        self.ids = self.dists = self.n_hops = None
        self.generation: int | None = None
        self.estimated: bool = False

    @property
    def latency_s(self) -> float | None:
        """Queue + execution latency (submission to host-landed result)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def slo_met(self) -> bool | None:
        lat = self.latency_s
        return None if lat is None else lat <= self.slo_budget_s

    @property
    def result(self) -> SearchResult | None:
        """This query's row as a 1-query SearchResult ticket."""
        if self.status != DONE:
            return None
        return SearchResult(ids=self.ids[None], dists=self.dists[None],
                            n_hops=np.asarray([self.n_hops]),
                            generation=self.generation,
                            estimated=self.estimated)

    def __repr__(self) -> str:
        return (f"QueryHandle(lane={self.lane!r}, status={self.status!r}, "
                f"slo={self.slo_budget_s * 1e3:.1f}ms)")


@dataclass
class SchedulerStats:
    """Monotonic scheduler counters (host-side, cheap). Gauges (queue
    depth, in-flight) live on the scheduler itself; `stats_view()` folds
    both into the `scheduler.*` metrics namespace."""

    submitted: int = 0          # admitted queries
    rejected: int = 0           # shed at admission (queue full)
    dispatched: int = 0         # queries dispatched (padding excluded)
    completed: int = 0          # queries host-landed
    batches: int = 0            # coalesced dispatches
    padded_rows: int = 0        # padding rows dispatched (wasted lanes)
    slo_misses: int = 0         # completed with latency > budget
    flush_full: int = 0
    flush_deadline: int = 0
    flush_idle: int = 0
    flush_drain: int = 0
    occupancy_sum: float = 0.0  # sum over batches of valid/bucket

    @property
    def mean_batch_occupancy(self) -> float:
        """Mean valid-rows fraction of dispatched buckets (1.0 = every
        dispatch was a full bucket, no padding waste)."""
        return self.occupancy_sum / self.batches if self.batches else 0.0

    def flush_reasons(self) -> dict:
        return {r: getattr(self, f"flush_{r}") for r in FLUSH_REASONS}

    def as_dict(self) -> dict:
        return dict(self.__dict__,
                    mean_batch_occupancy=self.mean_batch_occupancy)


class _AsyncBatch:
    """A dispatched coalesced batch: its SearchResult on the way to pinned
    host memory, with a `torch.cuda.Event` recorded after the batch's
    device work and its copy (`PendingResult`); on CPU tensors it is
    ready at once. The default seam between the scheduler and a Searcher
    session; tests substitute fakes with manual readiness (the
    `ready()/take()` protocol is the whole contract)."""

    def __init__(self, res: SearchResult):
        self._pending = PendingResult(res._replace(telemetry=None))

    def ready(self) -> bool:
        return self._pending.ready()

    def take(self) -> SearchResult:
        """Host-land the result (waits for the event)."""
        return self._pending.result()


class _Lane:
    """One workload class: a spec-bound dispatch fn, a priority, and a
    FIFO standing queue. Lower priority value = served first."""

    def __init__(self, name: str, spec: SearchSpec | None, priority: int,
                 dispatch: Callable[[np.ndarray], Any]):
        self.name = name
        self.spec = spec
        self.priority = priority
        self.dispatch = dispatch
        self.queue: deque[QueryHandle] = deque()


@dataclass
class _Inflight:
    lane: _Lane
    handles: list            # the batch's VALID rows, in dispatch order
    bucket: int
    reason: str
    batch: Any               # ready()/take() protocol


class StandingQueryScheduler:
    """Admission-and-dispatch layer over compiled `Searcher` sessions.

    Usage (see AnnsService.serve for the packaged loop):

        sched = StandingQueryScheduler(index, SearchSpec(k=10))
        sched.add_lane("exact", SearchSpec(k=10), priority=1)
        h = sched.submit(q, lane="default")   # or rejected at admission
        sched.poll()                          # harvest + dispatch, no block
        done = sched.drain()                  # flush everything, block

    Single-threaded by design: the host loop IS the stream scheduler.
    """

    def __init__(self, index=None, spec: SearchSpec | None = None, *,
                 config: SchedulerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 **config_overrides):
        self.index = index
        self.config = config or SchedulerConfig(**config_overrides)
        if config is not None and config_overrides:
            raise ValueError("pass either config= or config field kwargs, "
                             "not both")
        self.clock = clock
        self.stats = SchedulerStats()
        self._lanes: dict[str, _Lane] = {}
        self._inflight: deque[_Inflight] = deque()
        # (lane, reason, n_valid, bucket) of recent flushes — the debug /
        # test view of the policy; bounded so long-running serving can't
        # grow it without bound
        self.flush_log: deque = deque(maxlen=1024)
        # optional obs Histogram observed with valid/bucket per flush —
        # AnnsService wires scheduler.batch_occupancy here
        self.occupancy_hist = None
        if spec is not None:
            self.add_lane("default", spec)

    # ------------------------------------------------------------- lanes
    def add_lane(self, name: str, spec: SearchSpec | None = None, *,
                 priority: int = 0,
                 dispatch: Callable[[np.ndarray], Any] | None = None
                 ) -> "_Lane":
        """Register a workload class. `spec` lanes dispatch through a
        compiled `Searcher` session on the scheduler's index (plans land
        in the index's shared `PlanCache`); a custom `dispatch` callable
        (queries -> SearchResult, or any ready()/take() object) replaces
        the session — the unit-test seam."""
        if name in self._lanes:
            raise ValueError(f"lane {name!r} already registered")
        if dispatch is None:
            if self.index is None or spec is None:
                raise ValueError(
                    f"lane {name!r}: need an index and a spec (or a "
                    "custom dispatch callable)")
            session = self.index.searcher(spec)
            dispatch = lambda q: _AsyncBatch(session.search(q))  # noqa: E731
        lane = _Lane(name, spec, priority, dispatch)
        self._lanes[name] = lane
        return lane

    @property
    def lanes(self) -> tuple:
        return tuple(self._lanes)

    # --------------------------------------------------------- admission
    def submit(self, query, *, lane: str = "default",
               slo_budget_s: float | None = None) -> QueryHandle:
        """Admit one standing query (or shed it: a full queue returns a
        `rejected` handle immediately — backpressure, never unbounded
        growth). Returns the query's lifecycle handle."""
        ln = self._lanes[lane]
        budget = self.config.slo_budget_s if slo_budget_s is None \
            else float(slo_budget_s)
        now = self.clock()
        if self.queue_depth >= self.config.max_queue:
            self.stats.rejected += 1
            return QueryHandle(None, lane, budget, now, status=REJECTED)
        q = np.asarray(query)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]                      # accept a (1, D) singleton batch
        h = QueryHandle(q, lane, budget, now)
        ln.queue.append(h)
        self.stats.submitted += 1
        return h

    # ------------------------------------------------------------ gauges
    @property
    def queue_depth(self) -> int:
        """Standing queries admitted but not yet dispatched (all lanes)."""
        return sum(len(ln.queue) for ln in self._lanes.values())

    @property
    def inflight_depth(self) -> int:
        """Coalesced batches currently queued on the device."""
        return len(self._inflight)

    def stats_view(self) -> dict:
        """The `scheduler.*` metrics namespace: monotonic counters +
        live gauges, plain-JSON (obs_metrics.scheduler_stats_collector
        folds this into the unified snapshot)."""
        d = self.stats.as_dict()
        d["queue_depth"] = self.queue_depth
        d["inflight"] = self.inflight_depth
        d["lanes"] = len(self._lanes)
        return d

    # ------------------------------------------------------ the scheduler
    def poll(self) -> list[QueryHandle]:
        """One scheduler iteration, never blocking: harvest every
        completed in-flight batch, then dispatch every lane the flush
        policy says is ready (until the in-flight bound). Returns the
        handles completed by this call."""
        done = self._harvest(block=False)
        self._dispatch_ready()
        return done

    def drain(self) -> list[QueryHandle]:
        """Flush every standing query and block until all in-flight work
        has host-landed. Returns the handles completed by this call."""
        done: list[QueryHandle] = []
        while any(ln.queue for ln in self._lanes.values()):
            if len(self._inflight) >= self.config.max_inflight:
                done += self._harvest(block=True, limit=1)
            lane = self._pick_lane(lambda ln: bool(ln.queue))
            self._flush(lane, "drain")
        done += self._harvest(block=True)
        return done

    # ----------------------------------------------------------- internals
    def _pick_lane(self, want) -> _Lane | None:
        """Highest-priority lane satisfying `want`; ties break to the
        lane whose oldest query has waited longest."""
        best = None
        for ln in self._lanes.values():
            if not want(ln):
                continue
            key = (ln.priority,
                   ln.queue[0].t_submit if ln.queue else float("inf"))
            if best is None or key < best[0]:
                best = (key, ln)
        return best[1] if best else None

    def _dispatch_ready(self) -> None:
        cfg = self.config
        top = cfg.buckets[-1]
        while len(self._inflight) < cfg.max_inflight:
            now = self.clock()

            def overdue(ln: _Lane) -> bool:
                # the lane's flush deadline is the MINIMUM over its queue,
                # not the head's: submit() takes per-query slo_budget_s
                # overrides, so a tight-budget arrival queued BEHIND a lax
                # one must still pull the flush forward (FIFO order means
                # the tight query can only leave when the head does)
                return bool(ln.queue) and now >= min(
                    h.t_submit + cfg.flush_fraction * h.slo_budget_s
                    for h in ln.queue)

            # 1. a full top bucket is always worth dispatching
            lane = self._pick_lane(lambda ln: len(ln.queue) >= top)
            reason = "full"
            if lane is None:
                # 2. some queued query somewhere has spent flush_fraction
                #    of its SLO budget queueing — partial flush now
                lane, reason = self._pick_lane(overdue), "deadline"
            if lane is None and not self._inflight:
                # 3. device idle: batching would trade latency for
                #    nothing — serve whatever is queued immediately
                lane, reason = self._pick_lane(
                    lambda ln: bool(ln.queue)), "idle"
            if lane is None:
                return                    # wait to fill a bucket
            self._flush(lane, reason)

    def _flush(self, lane: _Lane | None, reason: str) -> None:
        if lane is None or not lane.queue:
            return
        cfg = self.config
        n = min(len(lane.queue), cfg.buckets[-1])
        handles = [lane.queue.popleft() for _ in range(n)]
        padded, n_valid = pad_to_bucket(
            np.stack([h.query for h in handles]), cfg.buckets)
        bucket = padded.shape[0]
        now = self.clock()
        with obs_span("scheduler.flush", lane=lane.name, reason=reason,
                      n=n_valid, bucket=bucket):
            batch = lane.dispatch(padded)
        self._inflight.append(_Inflight(lane, handles, bucket, reason, batch))
        for h in handles:
            h.status = INFLIGHT
            h.t_dispatch = now
        st = self.stats
        st.batches += 1
        st.dispatched += n_valid
        st.padded_rows += bucket - n_valid
        st.occupancy_sum += n_valid / bucket
        setattr(st, f"flush_{reason}", getattr(st, f"flush_{reason}") + 1)
        if self.occupancy_hist is not None:
            self.occupancy_hist.observe(n_valid / bucket)
        self.flush_log.append((lane.name, reason, n_valid, bucket))

    def _harvest(self, *, block: bool,
                 limit: int | None = None) -> list[QueryHandle]:
        """Host-land completed batches in dispatch order. Non-blocking
        mode stops at the first not-yet-ready batch (in-order completion:
        one stream runs its work in order, so the head batch finishes
        first)."""
        out: list[QueryHandle] = []
        while self._inflight and (limit is None or len(out) < limit):
            head = self._inflight[0]
            if not block and not head.batch.ready():
                break
            self._inflight.popleft()
            with obs_span("scheduler.harvest", lane=head.lane.name,
                          n=len(head.handles), bucket=head.bucket):
                res = head.batch.take()
            now = self.clock()
            # slice the coalesced result back to its queries: rows
            # [0, n_valid) in dispatch order; padding rows [n_valid,
            # bucket) are dropped HERE and can never reach a ticket
            for i, h in enumerate(head.handles):
                h.ids = res.ids[i]
                h.dists = res.dists[i]
                h.n_hops = res.n_hops[i]
                h.generation = res.generation
                # code-only lanes surface estimator distances honestly:
                # the flag rides the coalesced batch down to every ticket
                h.estimated = getattr(res, "estimated", False)
                h.status = DONE
                h.t_done = now
                self.stats.completed += 1
                if h.latency_s > h.slo_budget_s:
                    self.stats.slo_misses += 1
            out.append(head)
        return [h for b in out for h in b.handles]


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def summarize_handles(handles, wall_s: float) -> dict:
    """Open-loop serving report over a set of query handles: completed /
    rejected counts, achieved QPS, latency percentiles (ms), SLO hit
    rate. Plain-JSON."""
    done = [h for h in handles if h.status == DONE]
    lat_ms = np.asarray(sorted(h.latency_s * 1e3 for h in done)) \
        if done else np.zeros((0,))
    pct = (lambda p: float(np.percentile(lat_ms, p))) if done \
        else (lambda p: None)
    met = sum(1 for h in done if h.slo_met)
    return {
        "n": len(handles),
        "completed": len(done),
        "rejected": sum(1 for h in handles if h.status == REJECTED),
        "wall_s": round(float(wall_s), 6),
        "qps": round(len(done) / wall_s, 1) if wall_s > 0 else None,
        "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
        "mean_ms": float(lat_ms.mean()) if done else None,
        "max_ms": float(lat_ms.max()) if done else None,
        "slo_hit_rate": met / len(done) if done else None,
    }
