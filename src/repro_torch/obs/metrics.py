"""Metrics registry: counters, gauges, fixed-bucket histograms, one snapshot
(the port's copy of `repro.obs.metrics`: same instruments, bucket sets,
collectors and snapshot keys).

The repo's runtime counters were scattered before this module existed —
`ServiceStats` on the service, `CacheStats` on each index's plan cache,
live counts / imbalance on the sharded index — with no common export.
`MetricsRegistry` is the single namespaced view: instruments are created
through the registry, external stats objects are folded in through
`register_collector`, and `snapshot()` returns ONE plain-JSON dict
(`{"name": value_or_struct}`) that round-trips through `json.dumps`
unchanged (numpy scalars are coerced at the edge).

Naming convention (docs/observability.md): dot-separated lowercase
namespaces — `service.*` (ServiceStats), `plan_cache.*` (CacheStats),
`shards.*` (per-shard gauges), `search.*` (instruments fed from kernel
telemetry). Collectors run at snapshot time, so gauges like shard
imbalance are always current, never stale copies.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SEARCH_LATENCY_BUCKETS_US", "HOPS_BUCKETS", "BEAM_OCCUPANCY_BUCKETS",
    "BATCH_OCCUPANCY_BUCKETS", "FETCH_LATENCY_BUCKETS_US",
    "service_stats_collector", "plan_cache_collector", "shard_gauge_collector",
    "scheduler_stats_collector", "storage_stats_collector",
]

# Fixed bucket sets for the three paper-relevant distributions. Upper
# bounds are inclusive; everything above the last bound lands in +inf.
SEARCH_LATENCY_BUCKETS_US = (
    100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0, 25_000.0,
    50_000.0, 100_000.0, 250_000.0, 1_000_000.0)
HOPS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0)
BEAM_OCCUPANCY_BUCKETS = (4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
# coalesced-batch fill fraction (valid rows / padded bucket size) per
# dispatched batch — 1.0 means no padding waste at all
BATCH_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.5, 0.75, 0.9, 1.0)
# host-tier frontier gathers (core/storage.py VectorStore.gather) — µs
# per fetch; a gather moves Q*L rows over PCIe-equivalent paths, so the
# tail sits orders of magnitude above per-row arithmetic
FETCH_LATENCY_BUCKETS_US = (
    50.0, 100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0,
    25_000.0, 100_000.0)


def _plain(v: Any):
    """Coerce to a plain JSON scalar; numpy scalars/0-d arrays via .item()."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    item = getattr(v, "item", None)
    if callable(item) and not isinstance(v, (int, float)):
        try:
            v = item()
        except (TypeError, ValueError):
            return str(v)
    if isinstance(v, float):
        return float(v) if math.isfinite(v) else None
    if isinstance(v, int):
        return int(v)
    return str(v)


def plain_json(obj: Any):
    """Recursively coerce a snapshot-like structure to plain JSON types."""
    if isinstance(obj, Mapping):
        return {str(k): plain_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_json(v) for v in obj]
    return _plain(obj)


class Counter:
    """Monotonic counter. `inc()` accepts negative deltas never — clamp
    at the call site if a source can regress."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, delta: int | float = 1) -> None:
        if delta < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        with self._lock:
            self._value += _plain(delta)

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return _plain(self._value)


class Gauge:
    """Point-in-time value, set directly or lazily via a callable."""

    def __init__(self, name: str, fn: Callable[[], Any] | None = None) -> None:
        self.name = name
        self._fn = fn
        self._value: Any = 0

    def set(self, value: Any) -> None:
        self._value = _plain(value)

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._value

    def snapshot(self):
        return _plain(self.value)


class Histogram:
    """Fixed-bucket histogram with cumulative-style summary.

    Buckets are inclusive upper bounds plus an implicit +inf; snapshot
    reports per-bucket counts (non-cumulative, easier to eyeball),
    count/sum/min/max, and the bounds themselves so the snapshot is
    self-describing.
    """

    def __init__(self, name: str, buckets: Iterable[float]) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        self.name = name
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        v = float(_plain(value))
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": _plain(self._sum),
                "mean": _plain(self._sum / self._count) if self._count else None,
                "min": _plain(self._min) if self._count else None,
                "max": _plain(self._max) if self._count else None,
            }


class MetricsRegistry:
    """Instrument factory + collector fold + one `snapshot()`.

    Instruments are keyed by name (re-requesting a name returns the same
    instrument; a type mismatch is an error). Collectors are zero-arg
    callables returning a flat-or-nested mapping merged into the snapshot
    under their namespace at snapshot time.
    """

    def __init__(self) -> None:
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._collectors: list[tuple[str, Callable[[], Mapping]]] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ factories
    def _get(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str,
              fn: Callable[[], Any] | None = None) -> Gauge:
        g = self._get(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None:
            g._fn = fn
        return g

    def histogram(self, name: str, buckets: Iterable[float]) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, buckets))

    # ----------------------------------------------------------- collectors
    def register_collector(self, namespace: str,
                           fn: Callable[[], Mapping]) -> None:
        """Fold `fn()`'s mapping under `namespace.` at snapshot time."""
        with self._lock:
            self._collectors.append((namespace, fn))

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """One plain-JSON dict over every instrument and collector."""
        out: dict[str, Any] = {}
        with self._lock:
            instruments = list(self._instruments.items())
            collectors = list(self._collectors)
        for name, inst in instruments:
            out[name] = inst.snapshot()
        for ns, fn in collectors:
            for key, val in fn().items():
                out[f"{ns}.{key}"] = plain_json(val)
        return out


# ---------------------------------------------------------------------------
# Adapters for the repo's pre-existing stats objects
# ---------------------------------------------------------------------------

def service_stats_collector(service) -> Callable[[], Mapping]:
    """`service.*` from an AnnsService's ServiceStats (guarded to_dict)."""
    return lambda: service.stats.to_dict()


def plan_cache_collector(index) -> Callable[[], Mapping]:
    """`plan_cache.*` from an index's PlanCache: raw counters (including
    LRU `evictions`) + entry count + configured capacity + guarded
    hit_rate."""
    def collect() -> Mapping:
        d = dict(index.plans.stats.as_dict())
        d["entries"] = len(index.plans)
        d["capacity"] = index.plans.capacity
        return d
    return collect


def scheduler_stats_collector(get_scheduler) -> Callable[[], Mapping]:
    """`scheduler.*` from a StandingQueryScheduler's `stats_view()` —
    flush-reason counters, queue-depth/in-flight gauges, mean batch
    occupancy. `get_scheduler` is the scheduler itself or a zero-arg
    callable returning it (the service registers the callable form so
    the snapshot always reads the CURRENT scheduler; no scheduler yet
    means no scheduler.* keys, not stale zeros)."""
    def collect() -> Mapping:
        sched = get_scheduler() if callable(get_scheduler) else get_scheduler
        return sched.stats_view() if sched is not None else {}
    return collect


def storage_stats_collector(index) -> Callable[[], Mapping]:
    """`storage.*` from an index's `storage_stats()`: per-tier
    resident bytes (device codes vs device rows vs host rows), effective
    device-memory compression ratio, and host-fetch counters
    (fetch_n_bytes / fetch_total_s and friends). Indexes without a
    tiered store (pre-tiering or foreign backends) report nothing —
    no storage.* keys, not fake zeros."""
    def collect() -> Mapping:
        fn = getattr(index, "storage_stats", None)
        return fn() if fn is not None else {}
    return collect


def shard_gauge_collector(index) -> Callable[[], Mapping]:
    """`shards.*` gauges from a ShardedJasperIndex: count, per-shard live
    vectors, imbalance ratio. For single-device indexes (no shard
    methods) reports a degenerate single-shard view."""
    def collect() -> Mapping:
        live_fn = getattr(index, "shard_live_counts", None)
        if live_fn is None:
            return {"count": 1, "live": [int(index.size)], "imbalance": 1.0}
        live = [int(x) for x in live_fn()]
        return {"count": len(live), "live": live,
                "imbalance": float(index.shard_imbalance)}
    return collect
