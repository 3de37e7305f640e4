"""Open-loop load generation: seeded Poisson and bursty arrival traces
(the port's copy of `repro.serving.loadgen`: numpy only, so a seed gives
the same trace in either package).

An OPEN-loop generator emits arrivals on its own clock, independent of
service completions — the traffic model for "millions of users" (each
client is oblivious to the others and to server load), and the one under
which queueing actually happens: a closed loop (send, wait, send) can
never overload the server, so it cannot measure p99-under-load at all.

Traces are plain tuples of `Arrival` records (relative arrival time,
query-pool row, lane, optional per-query SLO budget), fully determined
by the seed — the benchmark sweeps and the tier-1 smoke lane replay
byte-identical traffic every run. `AnnsService.serve()` replays a trace
against the standing-query scheduler in real time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Arrival", "poisson_trace", "bursty_trace"]


class Arrival(NamedTuple):
    """One open-loop arrival: at `at` seconds from trace start, query
    `query_id` (a row of the caller's query pool) enters lane `lane`
    with an optional per-query SLO budget override."""

    at: float
    query_id: int
    lane: str = "default"
    slo_budget_s: float | None = None


def _assign(rng, n: int, lanes, lane_weights) -> list:
    lanes = tuple(lanes)
    if lane_weights is None:
        p = None
    else:
        w = np.asarray(lane_weights, dtype=np.float64)
        if w.shape != (len(lanes),):
            raise ValueError(f"lane_weights must match lanes "
                             f"({len(lanes)}), got shape {w.shape}")
        p = w / w.sum()
    return [lanes[i] for i in rng.choice(len(lanes), size=n, p=p)]


def poisson_trace(rate_qps: float, n: int, *, n_queries: int,
                  seed: int = 0, lanes=("default",), lane_weights=None,
                  slo_budget_s: float | None = None) -> tuple:
    """n Poisson arrivals at `rate_qps` offered load: i.i.d. exponential
    inter-arrival gaps (THE memoryless open-loop baseline), query ids
    uniform over a pool of `n_queries`, lanes drawn per arrival
    (optionally weighted) — mixed-spec traffic from one seed."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    qids = rng.integers(0, n_queries, size=n)
    lane_of = _assign(rng, n, lanes, lane_weights)
    return tuple(Arrival(float(t), int(q), ln, slo_budget_s)
                 for t, q, ln in zip(at, qids, lane_of))


def bursty_trace(rate_qps: float, n: int, *, n_queries: int,
                 burst_factor: float = 8.0, burst_fraction: float = 0.25,
                 period_s: float = 0.25, seed: int = 0,
                 lanes=("default",), lane_weights=None,
                 slo_budget_s: float | None = None) -> tuple:
    """n arrivals from an on/off-modulated Poisson process: time is cut
    into `period_s` windows; a window is a burst with probability
    `burst_fraction`, during which the instantaneous rate is
    `burst_factor` x the off-rate. The off/burst rates are chosen so the
    LONG-RUN mean offered load is still `rate_qps` — bursty and Poisson
    sweeps at the same nominal load are directly comparable; the bursts
    are what exercise deadline flushes and backpressure."""
    if burst_factor < 1 or not (0.0 < burst_fraction < 1.0):
        raise ValueError("need burst_factor >= 1 and 0 < burst_fraction < 1")
    rng = np.random.default_rng(seed)
    # mean rate = off * (1 - f) + off * factor * f == rate_qps
    off_rate = rate_qps / (1.0 + burst_fraction * (burst_factor - 1.0))
    times, t = [], 0.0
    while len(times) < n:
        burst = rng.random() < burst_fraction
        rate = off_rate * (burst_factor if burst else 1.0)
        end = t + period_s
        t_next = t + float(rng.exponential(1.0 / rate))
        while t_next < end and len(times) < n:
            times.append(t_next)
            t_next += float(rng.exponential(1.0 / rate))
        t = end
    qids = rng.integers(0, n_queries, size=n)
    lane_of = _assign(rng, n, lanes, lane_weights)
    return tuple(Arrival(float(t), int(q), ln, slo_budget_s)
                 for t, q, ln in zip(times, qids, lane_of))
