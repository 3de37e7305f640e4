"""One query surface: declarative `SearchSpec` + compiled `Searcher`
sessions (port of `repro.core.search_spec`, the same names and
behaviour).

  * `SearchSpec` — frozen, hashable, JSON-serialisable description of one
    search configuration. `resolve()` is the single definition site of
    every default formula and validation rule.
  * `ResolvedSearchSpec` — the fully concrete, normalised form; with the
    query shape and the liveness mode it keys the plan cache.
  * `SearchResult` — ids, dists, per-query hop counts, generation.
  * `BUCKET_LADDER`, `bucket_for`, `pad_to_bucket` — the padded batch
    shapes coalesced serving dispatches (serving/scheduler.py).
  * `CacheStats`, `PlanCache` — the index's LRU plan cache and its
    hit/miss/trace/eviction counters. A plan is a captured CUDA graph on
    the card's megakernel lanes and an eager callable elsewhere
    (core/plans.py); a capture counts one trace, as a jit trace does.
  * `Searcher` — a session from `index.searcher(spec)`: the spec resolved
    once, `search` (synchronous), `submit`/`drain` (asynchronous: results
    copied to pinned host memory behind a CUDA event), `pending`,
    `cache_stats`.
  * `SearchSurface` — `searcher` and `recall`, the surface `JasperIndex`
    inherits; `measure_recall` — recall@k at the exact served
    configuration.
"""

from __future__ import annotations

import json
import numbers
from collections import OrderedDict, deque
from dataclasses import asdict, dataclass, fields, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.beam_search import MERGE_STRATEGIES
from repro_torch.core.mutations import N_LABELS, filter_to_bytes
from repro_torch.obs.tracing import span as obs_span

SPEC_VERSION = 1

FUSION_MODES = ("none", "hop", "megakernel")

TELEMETRY_MODES = ("off", "on")

# Where the exact rerank reads its f32 rows: "device" (core.vectors),
# "host" (the host rows tier, core/storage.py), "none" (estimator distances,
# `SearchResult.estimated`). Quantized rerank=False normalises to "none".
RERANK_SOURCES = ("device", "host", "none")

FILTER_MODES = ("exclude", "traverse")

# The default shape ladder for coalesced serving (serving/scheduler.py):
# standing queries are padded up to the next rung, so every dispatched
# batch has one of these shapes and the plan cache holds at most
# len(ladder) plans per (spec, liveness) pair.
BUCKET_LADDER = (1, 8, 32, 128)


def bucket_for(n: int, ladder: tuple = BUCKET_LADDER) -> int:
    """The smallest ladder rung >= n (the top rung for n above it)."""
    if n < 1:
        raise ValueError(f"bucket_for needs n >= 1, got {n}")
    for b in sorted(ladder):
        if n <= b:
            return int(b)
    return int(max(ladder))


def pad_to_bucket(queries: np.ndarray, ladder: tuple = BUCKET_LADDER
                  ) -> tuple[np.ndarray, int]:
    """Pad a (n, D) query batch up to its ladder rung: returns `(padded
    (bucket, D), n)`. Padding rows repeat the last real query, and the
    caller slices results back to the first n rows."""
    q = np.asarray(queries)
    n = int(q.shape[0])
    bucket = bucket_for(n, ladder)
    if bucket == n:
        return q, n
    pad = np.repeat(q[-1:], bucket - n, axis=0)
    return np.concatenate([q, pad], axis=0), n


def check_quantized_backend(index, *, need_codes: bool = True) -> None:
    """The quantized-capability check: the index must be a RaBitQ backend
    and (unless `need_codes=False`) already hold packed codes."""
    if getattr(index, "quantization", None) != "rabitq":
        raise ValueError(
            "quantized=True requires an index built with "
            "quantization='rabitq' (this core has no packed codes)")
    # a sharded index's shards hold their codes alike (its mesh positions
    # may have no one stacked core)
    core = (index.shard_core(0) if hasattr(index, "shard_core")
            else getattr(index, "core", None))
    if need_codes and core is not None and core.codes is None:
        raise ValueError(
            "quantized=True on a codeless core: this "
            "quantization='rabitq' index has not trained its quantizer "
            "yet — build or insert data before opening a quantized "
            "search session")


def check_rows_tier(index, rerank_source: str) -> None:
    """The rows-tier check: a resolved `rerank_source` must match where
    the index's f32 rows live."""
    tier = getattr(index, "rows_tier", "device")
    if rerank_source == "host" and tier != "host":
        raise ValueError(
            "rerank_source='host' requires the index's f32 rows to be "
            "evicted to the host tier (index.rows_tier == 'host'; call "
            "evict_rows_to_host()) — this index's rows are "
            "device-resident, so use rerank_source='device' "
            "(bit-identical) or evict first")
    if rerank_source == "device" and tier != "device":
        raise ValueError(
            "rerank_source='device' needs device-resident f32 rows, but "
            "this index's rows are evicted to the host tier — use "
            "rerank_source='host' (bit-identical exact rerank) or "
            "'none' (estimator-only), or call restore_rows_to_device()")


def _as_int(name: str, value, *, floor: int) -> int:
    """Coerce an integral spec field (python or numpy int) to a plain int;
    bool and everything non-integral are configuration errors."""
    if isinstance(value, bool) or not isinstance(value, numbers.Integral):
        raise ValueError(f"{name} must be an int, got {value!r}")
    value = int(value)
    if value < floor:
        raise ValueError(f"{name} must be >= {floor}, got {value}")
    return value


@dataclass(frozen=True)
class SearchSpec:
    """Declarative description of one search configuration (the same
    fields, defaults and meaning as `repro.core.search_spec.SearchSpec`;
    see there for the per-field documentation)."""

    k: int = 10
    beam_width: int | None = None
    max_iters: int | None = None
    expand: int = 1
    quantized: bool = False
    rerank: bool = True
    rerank_source: str = "device"
    rerank_tile: int = 512
    use_kernels: bool = False
    merge: str = "topk"
    traverse_deleted: bool = True
    fusion: str = "none"
    beam_schedule: tuple | None = None
    telemetry: str = "off"
    filter: tuple | int | None = None
    filter_mode: str = "traverse"

    def resolve(self, index: Any = None) -> "ResolvedSearchSpec":
        """Fill defaults, validate, normalise — the one definition site."""
        k = _as_int("k", self.k, floor=1)
        expand = _as_int("expand", self.expand, floor=1)
        if self.merge not in MERGE_STRATEGIES:
            raise ValueError(
                f"merge must be one of {MERGE_STRATEGIES}, "
                f"got {self.merge!r}")
        if self.fusion not in FUSION_MODES:
            raise ValueError(
                f"fusion must be one of {FUSION_MODES}, got {self.fusion!r}")
        if self.telemetry not in TELEMETRY_MODES:
            raise ValueError(
                f"telemetry must be one of {TELEMETRY_MODES}, "
                f"got {self.telemetry!r}")
        if self.filter_mode not in FILTER_MODES:
            raise ValueError(
                f"filter_mode must be one of {FILTER_MODES}, "
                f"got {self.filter_mode!r}")
        filt = self.filter
        if filt is not None:
            if isinstance(filt, bool) or (
                    not isinstance(filt, numbers.Integral)
                    and not hasattr(filt, "__iter__")):
                raise ValueError(
                    f"filter must be a label id, a sequence of label ids, "
                    f"or None, got {filt!r}")
            labels = ((filt,) if isinstance(filt, numbers.Integral)
                      else tuple(filt))
            if not labels:
                raise ValueError(
                    "filter must be a non-empty label set or None (an "
                    "empty filter would match no rows; pass None to "
                    "search unfiltered)")
            for lab in labels:
                lab = _as_int("filter labels", lab, floor=0)
                if lab >= N_LABELS:
                    raise ValueError(
                        f"filter label {lab} out of range "
                        f"[0, {N_LABELS})")
        filtered = filt is not None
        filter_mode = self.filter_mode if filtered else "traverse"
        schedule = self.beam_schedule
        if schedule is not None:
            try:
                schedule = tuple(_as_int("beam_schedule entries", w, floor=1)
                                 for w in schedule)
            except TypeError:
                raise ValueError(
                    f"beam_schedule must be a sequence of ints, "
                    f"got {self.beam_schedule!r}") from None
            if not schedule:
                raise ValueError("beam_schedule must be non-empty or None")
            if min(schedule) < k:
                raise ValueError(
                    f"every beam_schedule entry must be >= k={k}, got "
                    f"{schedule} (a hop narrower than k cannot carry k "
                    "results to the output)")
        bw = (max(schedule) if schedule is not None
              else max(k, 32) if self.beam_width is None
              else _as_int("beam_width", self.beam_width, floor=1))
        if self.beam_width is not None and schedule is not None:
            bw = _as_int("beam_width", self.beam_width, floor=1)
            if max(schedule) > bw:
                raise ValueError(
                    f"beam_schedule entries must be <= beam_width={bw}, "
                    f"got {schedule} (the frontier buffer is beam_width "
                    "wide; a hop cannot be wider than the buffer)")
        if bw < k:
            raise ValueError(
                f"beam_width must be an int >= k={k}, got {bw!r} "
                "(the final frontier is the result buffer: a beam narrower "
                "than k cannot hold k results)")
        mi = ((2 * bw + 8) // expand + 4 if self.max_iters is None
              else _as_int("max_iters", self.max_iters, floor=1))
        rerank_tile = _as_int("rerank_tile", self.rerank_tile, floor=1)
        source = self.rerank_source
        if source not in RERANK_SOURCES:
            raise ValueError(
                f"rerank_source must be one of {RERANK_SOURCES}, "
                f"got {source!r}")
        if not self.quantized:
            if source != "device":
                raise ValueError(
                    f"rerank_source={source!r} requires quantized=True: "
                    "the exact path scores device-resident rows directly "
                    "(there is no estimator to serve and no separate "
                    "rerank stage to redirect)")
            rerank = True
        else:
            rerank = bool(self.rerank)
            if source == "none":
                rerank = False
            elif not rerank:
                if source == "host":
                    raise ValueError(
                        "rerank_source='host' with rerank=False is "
                        "contradictory: the host tier exists to feed the "
                        "exact rerank — use rerank_source='none' for "
                        "code-only serving")
                source = "none"
        if index is not None:
            if self.quantized:
                check_quantized_backend(index)
            check_rows_tier(index, source)
        if not (self.quantized and rerank):
            rerank_tile = 512
        merge = self.merge
        if self.fusion != "none":
            if expand != 1:
                raise ValueError(
                    f"fusion={self.fusion!r} supports expand=1 only "
                    f"(got expand={expand}): the fused kernels expand one "
                    "frontier node per hop — use fusion='none' for "
                    "multi-expansion")
            merge = "topk"
        return ResolvedSearchSpec(
            k=k, beam_width=bw, max_iters=mi, expand=expand,
            quantized=bool(self.quantized), rerank=rerank,
            rerank_source=source,
            rerank_tile=rerank_tile, use_kernels=bool(self.use_kernels),
            merge=merge, traverse_deleted=bool(self.traverse_deleted),
            fusion=self.fusion, beam_schedule=schedule,
            telemetry=self.telemetry, filtered=filtered,
            filter_mode=filter_mode)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"version": SPEC_VERSION, **asdict(self)}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "SearchSpec":
        d = dict(d)
        version = d.pop("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"SearchSpec version {version} is newer than "
                             f"this build supports ({SPEC_VERSION})")
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SearchSpec fields: {sorted(unknown)}")
        if d.get("beam_schedule") is not None:
            d["beam_schedule"] = tuple(d["beam_schedule"])
        filt = d.get("filter")
        if filt is not None and not isinstance(filt, numbers.Integral):
            d["filter"] = tuple(filt)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SearchSpec":
        return cls.from_dict(json.loads(s))

    def with_(self, **kw) -> "SearchSpec":
        """Functional update (specs are frozen)."""
        return replace(self, **kw)

    def filter_bytes(self) -> np.ndarray | None:
        """The runtime operand for `filter`: a uint8[N_LABEL_BYTES] byte
        mask (or None when unfiltered)."""
        if self.filter is None:
            return None
        labels = (self.filter,) if isinstance(
            self.filter, numbers.Integral) else tuple(self.filter)
        return filter_to_bytes(labels)


@dataclass(frozen=True)
class ResolvedSearchSpec:
    """Fully concrete, validated, normalised search configuration.
    `filtered` records filter presence only; the value is a runtime
    operand (`SearchSpec.filter_bytes()`)."""

    k: int
    beam_width: int
    max_iters: int
    expand: int
    quantized: bool
    rerank: bool
    rerank_source: str
    rerank_tile: int
    use_kernels: bool
    merge: str
    traverse_deleted: bool
    fusion: str
    beam_schedule: tuple | None
    telemetry: str
    filtered: bool
    filter_mode: str

    def to_spec(self) -> SearchSpec:
        """Back to declarative form (lossy for filtered specs)."""
        d = asdict(self)
        d.pop("filtered")
        d["filter"] = None
        d["filter_mode"] = "traverse"
        return SearchSpec(**d)


class SearchResult(NamedTuple):
    """One served search batch."""

    ids: Any        # (Q, k) int32, -1 padded, never tombstoned
    dists: Any      # (Q, k) f32
    n_hops: Any     # (Q,) int32 — greedy-walk hops per query
    generation: int
    telemetry: Any = None   # SearchTelemetry iff spec.telemetry == "on"
    estimated: bool = False  # True iff dists are estimator values


def to_host(x):
    """A tensor (or anything array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy of a card tensor into pinned host memory, on
    the current stream."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class PendingResult:
    """A `SearchResult` on its way to the host. On the card its tensors
    are copied into pinned host memory without blocking, and a CUDA event
    recorded after the copies says when they have landed; `ready()`
    queries the event, `result()` waits for it. Results on the CPU are
    ready at once."""

    def __init__(self, res: SearchResult):
        self._res = res
        self._event = None
        if isinstance(res.ids, torch.Tensor) and res.ids.is_cuda:
            tel = res.telemetry
            self._res = res._replace(
                ids=_pinned_copy(res.ids), dists=_pinned_copy(res.dists),
                n_hops=_pinned_copy(res.n_hops),
                telemetry=(None if tel is None else
                           type(tel)(*(_pinned_copy(t) for t in tel))))
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> SearchResult:
        """The result with numpy arrays (blocks until they have landed)."""
        if self._event is not None:
            self._event.synchronize()
        r = self._res
        tel = r.telemetry
        if tel is not None:
            tel = type(tel)(*(to_host(t) for t in tel))
        return SearchResult(ids=to_host(r.ids), dists=to_host(r.dists),
                            n_hops=to_host(r.n_hops),
                            generation=r.generation, telemetry=tel,
                            estimated=r.estimated)


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

@dataclass
class CacheStats:
    """Counters for the plan cache (monotonic; `clear()` keeps them)."""

    hits: int = 0
    misses: int = 0
    traces: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        """Hits per lookup; 0.0 on a never-used cache."""
        lookups = self.hits + self.misses
        return self.hits / lookups if lookups else 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__, hit_rate=self.hit_rate)

    def delta(self, since: "CacheStats") -> dict:
        return {k: v - getattr(since, k) for k, v in self.__dict__.items()}

    def snapshot(self) -> "CacheStats":
        return CacheStats(**self.__dict__)


class PlanCache:
    """Plan cache keyed on (kind, resolved spec, query shape, liveness),
    LRU-bounded when given a capacity.

    `get` returns the cached plan or builds it. Plans call `count_trace`
    when they trace: a captured plan at each capture (the first dispatch,
    and again when the buffers it captured were reallocated, as by a
    grow), an eager plan when the core's shapes are new to it — where a
    jit re-traces. `capacity=None` keeps every plan; with a capacity, a
    hit refreshes the key and an insert past capacity drops the least
    recently used plan (`stats.evictions`)."""

    def __init__(self, capacity: int | None = None) -> None:
        self._plans: OrderedDict = OrderedDict()
        self.stats = CacheStats()
        self.capacity = capacity

    @property
    def capacity(self) -> int | None:
        return self._capacity

    @capacity.setter
    def capacity(self, capacity: int | None) -> None:
        if capacity is not None and capacity < 1:
            raise ValueError(f"PlanCache capacity must be >= 1 or None, "
                             f"got {capacity}")
        self._capacity = capacity
        self._evict()

    def get(self, key, build):
        try:
            plan = self._plans[key]
            self._plans.move_to_end(key)      # LRU refresh
            self.stats.hits += 1
            return plan
        except KeyError:
            self.stats.misses += 1
            plan = self._plans[key] = build()
            self._evict()
            return plan

    def _evict(self) -> None:
        while (self._capacity is not None
               and len(self._plans) > self._capacity):
            self._plans.popitem(last=False)   # least recently used
            self.stats.evictions += 1

    def count_trace(self) -> None:
        """Called by a plan each time it traces (captures)."""
        self.stats.traces += 1

    def clear(self) -> None:
        """Drop the plans; stats persist."""
        self._plans.clear()

    def __len__(self) -> int:
        return len(self._plans)


# ---------------------------------------------------------------------------
# The search session
# ---------------------------------------------------------------------------

class Searcher:
    """A search session over one index, from `index.searcher(spec)`.

    The spec is resolved once, at construction; each query shape then
    takes one plan from the index's shared `PlanCache`, so repeated
    searches — and every other session or legacy call with the same
    configuration — reuse it.

    `search()` is the synchronous path (device tensors at the current
    generation). `submit()` dispatches a batch and starts copying its
    results to pinned host memory without waiting; `drain()` returns the
    completed results as numpy arrays in submission order. Work runs on
    one stream, so a mutation made after a `submit` runs after that
    batch's search: a drained result is the snapshot of its generation.
    """

    def __init__(self, index, spec: SearchSpec):
        self.index = index
        self.spec = spec
        self.resolved = spec.resolve(index)
        # the filter value, lowered once to its runtime byte-mask operand;
        # the resolved spec (and hence the plan) only knows its presence
        self._filter_bytes = spec.filter_bytes()
        self._inflight: deque = deque()

    def _dispatch(self, queries) -> SearchResult:
        idx = self.index
        q = idx._prep_query(queries)
        generation = idx.generation
        plan = idx._search_plan(self.resolved, tuple(q.shape),
                                idx._filter_tombstones)
        out = plan(q, self._filter_bytes)
        # plans return (ids, dists, n_hops), plus a SearchTelemetry
        # fourth element iff the resolved spec has telemetry on
        ids, dists, n_hops = out[:3]
        tel = out[3] if len(out) > 3 else None
        return SearchResult(ids=ids, dists=dists, n_hops=n_hops,
                            generation=generation, telemetry=tel,
                            estimated=self.resolved.rerank_source == "none")

    def search(self, queries) -> SearchResult:
        """Synchronous search at the current snapshot generation."""
        return self._dispatch(queries)

    def submit(self, queries) -> int:
        """Dispatch a batch without waiting; returns the in-flight depth."""
        with obs_span("searcher.submit", pending=len(self._inflight)):
            self._inflight.append(PendingResult(self._dispatch(queries)))
        return len(self._inflight)

    def drain(self, limit: int | None = None) -> list[SearchResult]:
        """Wait for the oldest `limit` in-flight batches (None = all);
        results in submission order, host-resident (numpy arrays)."""
        out = []
        with obs_span("searcher.drain", pending=len(self._inflight)):
            while self._inflight and (limit is None or len(out) < limit):
                out.append(self._inflight.popleft().result())
        return out

    @property
    def pending(self) -> int:
        return len(self._inflight)

    @property
    def cache_stats(self) -> CacheStats:
        """The index's shared plan-cache counters."""
        return self.index.plans.stats


class SearchSurface:
    """The spec-driven query surface an index inherits: session
    opening and recall. The index supplies `_prep_query`,
    `_filter_tombstones`, `generation`, `brute_force`, `plans` and
    `_search_plan`."""

    def searcher(self, spec: SearchSpec | None = None, **kw) -> Searcher:
        """Open a search session; `spec` (or keyword fields building one;
        keywords beside a spec derive `spec.with_(**kw)`) is resolved once."""
        spec = SearchSpec(**kw) if spec is None else \
            (spec.with_(**kw) if kw else spec)
        return Searcher(self, spec)

    def recall(self, queries, k: int = 10, *,
               beam_width: int | None = None, quantized: bool = False,
               use_kernels: bool = False, expand: int = 1,
               spec: SearchSpec | None = None) -> float:
        """Recall@k vs brute force at the exact served configuration."""
        spec = spec or SearchSpec(k=k, beam_width=beam_width,
                                  quantized=quantized,
                                  use_kernels=use_kernels, expand=expand)
        return measure_recall(self, queries, spec)


def measure_recall(index, queries, spec: SearchSpec) -> float:
    """Recall@k vs the index's own brute force (paper's Recall k@k), at the
    exact configuration described by `spec`."""
    gt, _ = index.brute_force(queries, spec.resolve(index).k)
    res = index.searcher(spec).search(queries)
    ids, gt = to_host(res.ids), to_host(gt)
    hits = (ids[:, :, None] == gt[:, None, :]) & (ids >= 0)[:, :, None]
    return float(np.mean(hits.any(axis=2).sum(axis=1) / gt.shape[1]))
