"""Host-side span tracer exporting Chrome trace-event JSON (the port's
copy of `repro.obs.tracing`: same names, events and export).

The paper's serving claims — latency hiding in the fused search kernel,
p99 flat through a consolidate + reshard cycle — are timing claims, and
this module is the ONE place the repo measures host-side time: a
thread-safe, nestable span tracer whose export is the Chrome trace-event
format (`{"traceEvents": [...]}` of "ph": "X" complete events), so a
churn run drops a file that opens directly in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

Usage (docs/observability.md):

    from repro_torch import obs
    tracer = obs.SpanTracer()
    with obs.use_tracer(tracer):
        with obs.span("consolidate", n_deleted=37):
            ...
    tracer.export("trace.json")

`obs.span(...)` is safe to leave in hot paths permanently: with no tracer
installed it returns a shared no-op context manager — no allocation, no
clock read, no lock (the zero-overhead off mode of the telemetry plane).

Span taxonomy (the names the serving/search stack emits — keep stable,
dashboards key on them):

    service.step            one scheduler tick (parent of the phases)
    service.delete / service.insert / service.search
    service.consolidate / service.rebalance
    searcher.submit / searcher.drain
    index.build             bulk construction (either backend)
    reshard.cores           shard-count-changing restore
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

__all__ = ["SpanTracer", "span", "use_tracer", "set_tracer", "get_tracer"]


class SpanTracer:
    """Thread-safe, nestable span recorder.

    Spans are recorded as Chrome trace "complete" events (ph "X"): wall
    timestamp + duration in microseconds, pid = this process, tid = the
    recording thread — nesting falls out of the format (Perfetto stacks
    events on the same tid by time containment), so the tracer itself
    keeps no explicit stack.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[dict] = []
        # one origin for both clocks: wall time anchors the trace, the
        # monotonic perf counter measures spans (immune to clock steps)
        self._t0_wall_us = time.time() * 1e6
        self._t0_perf = time.perf_counter()

    # ------------------------------------------------------------- recording
    def _now_us(self) -> float:
        return self._t0_wall_us + (time.perf_counter() - self._t0_perf) * 1e6

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """Record one span around the body. Nestable and thread-safe;
        `args` land in the trace event's args dict (JSON-coerced)."""
        start = self._now_us()
        try:
            yield
        finally:
            end = self._now_us()
            evt = {"name": name, "ph": "X", "ts": start,
                   "dur": end - start, "pid": os.getpid(),
                   "tid": threading.get_ident()}
            if args:
                evt["args"] = {k: _jsonable(v) for k, v in args.items()}
            with self._lock:
                self._events.append(evt)

    # --------------------------------------------------------------- exports
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write the Chrome trace JSON to `path`."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def summary(self) -> dict[str, dict]:
        """Per-span-name aggregates: {name: {count, total_us, mean_us,
        max_us}} — the no-browser view scripts/obs_report.py prints."""
        out: dict[str, dict] = {}
        for e in self.events():
            s = out.setdefault(e["name"], {"count": 0, "total_us": 0.0,
                                           "max_us": 0.0})
            s["count"] += 1
            s["total_us"] += e["dur"]
            s["max_us"] = max(s["max_us"], e["dur"])
        for s in out.values():
            s["mean_us"] = s["total_us"] / s["count"]
        return out


def _jsonable(v: Any):
    """Coerce span args to plain JSON scalars (numpy scalars included)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return str(v)


# ---------------------------------------------------------------------------
# Module-level active tracer — the `obs.span(...)` hot-path surface
# ---------------------------------------------------------------------------

_active: SpanTracer | None = None


class _NoopSpan:
    """Shared reusable no-op context manager: `obs.span()` with tracing
    disabled costs one global read and returns this singleton — no
    allocation, no clock, no lock."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def set_tracer(tracer: SpanTracer | None) -> SpanTracer | None:
    """Install (or clear, with None) the process-wide active tracer.
    Returns the previous one."""
    global _active
    prev, _active = _active, tracer
    return prev


def get_tracer() -> SpanTracer | None:
    return _active


@contextmanager
def use_tracer(tracer: SpanTracer) -> Iterator[SpanTracer]:
    """Scoped activation: install `tracer` for the block, restore after."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, **args: Any):
    """Span against the active tracer; a shared no-op when none is set."""
    t = _active
    if t is None:
        return _NOOP
    return t.span(name, **args)
