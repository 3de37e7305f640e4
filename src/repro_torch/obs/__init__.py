"""One telemetry plane for the port: metrics, spans, kernel counters (the
same exports as `repro.obs`).

Three layers, one import:

- `MetricsRegistry` (metrics.py) — counters / gauges / fixed-bucket
  histograms plus adapters folding ServiceStats, PlanCache stats, and
  per-shard gauges into a single namespaced `snapshot()` JSON dict.
- `SpanTracer` / `span` (tracing.py) — thread-safe nestable host spans
  exported as Chrome trace-event JSON (Perfetto-viewable). `obs.span()`
  with no tracer installed is a shared no-op.
- Per-search kernel telemetry rides the search path itself behind
  `SearchSpec(telemetry="on")` (see core/search_spec.py and
  docs/observability.md) — this package only consumes the resulting
  `SearchTelemetry` arrays when feeding histograms.
"""

from repro_torch.obs.metrics import (
    BATCH_OCCUPANCY_BUCKETS,
    BEAM_OCCUPANCY_BUCKETS,
    HOPS_BUCKETS,
    SEARCH_LATENCY_BUCKETS_US,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    plain_json,
    plan_cache_collector,
    scheduler_stats_collector,
    service_stats_collector,
    shard_gauge_collector,
)
from repro_torch.obs.tracing import (
    SpanTracer,
    get_tracer,
    set_tracer,
    span,
    use_tracer,
)

__all__ = [
    "BATCH_OCCUPANCY_BUCKETS",
    "BEAM_OCCUPANCY_BUCKETS",
    "HOPS_BUCKETS",
    "SEARCH_LATENCY_BUCKETS_US",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanTracer",
    "get_tracer",
    "plain_json",
    "plan_cache_collector",
    "scheduler_stats_collector",
    "service_stats_collector",
    "set_tracer",
    "shard_gauge_collector",
    "span",
    "use_tracer",
]
