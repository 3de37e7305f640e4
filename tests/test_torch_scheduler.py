"""The port's standing-query scheduler and load generator against the JAX
package's.

  * The flush-policy cases run on both packages' schedulers with the same
    fake clock and the same dispatch seam (no wall-clock sleeps): each
    case asserts the policy and returns a record of its handles (lane,
    status, flush reason, latency, SLO met), the stats and the flush log,
    which must be equal between the packages.
  * `poisson_trace` / `bursty_trace` give array-equal traces for a seed.
  * On the port's index: a coalesced padded dispatch equals per-query
    dispatch bit for bit, mixed-spec traffic retraces nothing once warm,
    `serve` folds its report into the service's stats and metrics, and the
    plan cache's capacity bounds it.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import search_spec as jss
from repro.serving import loadgen as jload
from repro.serving import scheduler as jsched
from repro_torch.core import search_spec as tss
from repro_torch.core.construction import ConstructionParams
from repro_torch.core.index import JasperIndex
from repro_torch.serving import loadgen as tload
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.anns_service import AnnsService

SMALL = ConstructionParams(degree_bound=16, alpha=1.2, beam_width=16,
                           max_iters=24, rev_cap=16, prune_chunk=256)
DIMS = 24
PACKAGES = [(tsched, tss), (jsched, jss)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Deterministic harness: fake clock + fake dispatch (manual readiness)
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeBatch:
    """ready()/take() protocol with manual readiness."""

    def __init__(self, result_cls, n: int, k: int = 3):
        self.ready_flag = False
        self._cls, self._n, self._k = result_cls, n, k

    def ready(self) -> bool:
        return self.ready_flag

    def take(self):
        n, k = self._n, self._k
        ids = np.arange(n * k, dtype=np.int32).reshape(n, k)
        return self._cls(ids=ids, dists=ids.astype(np.float32),
                         n_hops=np.zeros(n, np.int32), generation=0)


class FakeLaneDispatch:
    def __init__(self, result_cls):
        self.cls = result_cls
        self.batches: list = []
        self.shapes: list = []

    def __call__(self, queries):
        self.shapes.append(tuple(queries.shape))
        b = FakeBatch(self.cls, queries.shape[0])
        self.batches.append(b)
        return b

    def finish_all(self) -> None:
        for b in self.batches:
            b.ready_flag = True


def make_sched(pkg, clock, *, lanes=("default",), priorities=None, **cfg):
    sched_mod, spec_mod = pkg
    cfg.setdefault("buckets", (1, 8, 32))
    cfg.setdefault("slo_budget_s", 1.0)
    sched = sched_mod.StandingQueryScheduler(clock=clock, **cfg)
    dispatches = {}
    for i, name in enumerate(lanes):
        d = FakeLaneDispatch(spec_mod.SearchResult)
        sched.add_lane(name, dispatch=d, priority=(priorities[i]
                                                    if priorities else 0))
        dispatches[name] = d
    return sched, dispatches


Q = np.zeros(DIMS, np.float32)


def _record(sched, handles, dispatches):
    """What the two packages must agree on."""
    return dict(
        handles=[(h.lane, h.status, h.latency_s, h.slo_met,
                  None if h.ids is None else np.asarray(h.ids).tolist())
                 for h in handles],
        stats=sched.stats.as_dict(), view=sched.stats_view(),
        flush_log=list(sched.flush_log),
        shapes={k: d.shapes for k, d in dispatches.items()})


# ---------------------------------------------------------------------------
# Flush-policy cases (each asserts the JAX package's expectations)
# ---------------------------------------------------------------------------

def case_idle_flush(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk)
    hs = [sched.submit(Q), sched.submit(Q)]
    sched.poll()
    assert d["default"].shapes == [(8, DIMS)]
    assert sched.stats.flush_idle == 1
    assert sched.stats.padded_rows == 6 and sched.stats.dispatched == 2
    return _record(sched, hs, d)


def case_full_flush_while_busy(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=2)
    hs = [sched.submit(Q)]
    sched.poll()
    hs += [sched.submit(Q) for _ in range(32)]
    sched.poll()
    assert d["default"].shapes == [(1, DIMS), (32, DIMS)]
    assert sched.stats.flush_full == 1
    assert sched.stats.mean_batch_occupancy == 1.0
    return _record(sched, hs, d)


def case_deadline_flush(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=2, slo_budget_s=1.0,
                          flush_fraction=0.5)
    hs = [sched.submit(Q)]
    sched.poll()
    hs.append(sched.submit(Q, slo_budget_s=1.0))
    clk.advance(0.49)
    sched.poll()
    assert len(d["default"].shapes) == 1
    clk.advance(0.02)
    sched.poll()
    assert d["default"].shapes[-1] == (1, DIMS)
    assert sched.stats.flush_deadline == 1
    return _record(sched, hs, d)


def case_per_query_slo(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=2, slo_budget_s=10.0)
    hs = [sched.submit(Q)]
    sched.poll()
    hs.append(sched.submit(Q, slo_budget_s=0.010))
    clk.advance(0.006)
    sched.poll()
    assert sched.stats.flush_deadline == 1
    return _record(sched, hs, d)


def case_deadline_min_over_queue(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=2, slo_budget_s=10.0)
    hs = [sched.submit(Q)]
    sched.poll()
    hs.append(sched.submit(Q, slo_budget_s=10.0))
    clk.advance(0.001)
    hs.append(sched.submit(Q, slo_budget_s=0.010))
    clk.advance(0.004)
    sched.poll()
    assert sched.stats.flush_deadline == 0
    clk.advance(0.003)
    sched.poll()
    assert sched.stats.flush_deadline == 1
    assert d["default"].shapes[-1] == (8, DIMS)
    assert sched.stats.dispatched == 3
    return _record(sched, hs, d)


def case_priority_lanes(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, lanes=("lo", "hi"), priorities=(1, 0),
                          max_inflight=2, slo_budget_s=1.0)
    hs = [sched.submit(Q, lane="lo")]
    sched.poll()
    assert sched.flush_log[-1][0] == "lo"
    hs.append(sched.submit(Q, lane="lo"))
    clk.advance(0.01)
    hs.append(sched.submit(Q, lane="hi"))
    clk.advance(0.6)
    sched.poll()
    assert sched.flush_log[-1][0] == "hi" and sched.inflight_depth == 2
    d["hi"].finish_all()
    d["lo"].finish_all()
    sched.poll()
    sched.poll()
    assert [e[0] for e in sched.flush_log] == ["lo", "hi", "lo"]
    return _record(sched, hs, d)


def case_backpressure(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_queue=4, max_inflight=1)
    hs = [sched.submit(Q)]
    sched.poll()
    hs += [sched.submit(Q) for _ in range(4)]
    shed = sched.submit(Q)
    assert all(h.status == "queued" for h in hs[1:])
    assert shed.status == "rejected" and shed.result is None
    assert sched.stats.rejected == 1 and sched.queue_depth == 4
    rep = pkg[0].summarize_handles([*hs[1:], shed], wall_s=1.0)
    assert rep["rejected"] == 1 and rep["completed"] == 0
    rec = _record(sched, [*hs, shed], d)
    rec["report"] = rep
    return rec


def case_overlap_inorder(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=2, slo_budget_s=0.1)
    hs = [sched.submit(Q)]
    sched.poll()
    hs.append(sched.submit(Q))
    clk.advance(1.0)
    sched.poll()
    assert sched.inflight_depth == 2
    hs.append(sched.submit(Q))
    clk.advance(1.0)
    sched.poll()
    assert sched.inflight_depth == 2
    d["default"].batches[0].ready_flag = True
    done = sched.poll()
    assert [h.status for h in hs] == ["done", "inflight", "inflight"]
    assert done and done[0] is hs[0]
    assert len(d["default"].shapes) == 3
    d["default"].finish_all()
    sched.poll()
    assert all(h.status == "done" for h in hs)
    assert sched.stats.completed == 3
    res = hs[0].result
    assert res.ids.shape == (1, 3) and res.generation == 0
    return _record(sched, hs, d)


def case_drain(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=1)
    cls = pkg[1].SearchResult

    class AutoBatch(FakeBatch):
        def ready(self):
            return True

    auto = []
    sched.add_lane("auto", dispatch=lambda q: (
        auto.append(tuple(q.shape)), AutoBatch(cls, q.shape[0]))[1])
    hs = [sched.submit(Q, lane="auto") for _ in range(70)]
    done = sched.drain()
    assert all(h.status == "done" for h in hs) and len(done) == 70
    assert sched.queue_depth == 0 and sched.inflight_depth == 0
    assert sched.stats.flush_drain >= 1
    assert sum(n for _, _, n, _ in sched.flush_log) == 70
    rec = _record(sched, hs, d)
    rec["auto"] = auto
    return rec


def case_slo_miss(pkg):
    clk = FakeClock()
    sched, d = make_sched(pkg, clk, max_inflight=1, slo_budget_s=0.05)
    h = sched.submit(Q)
    sched.poll()
    clk.advance(1.0)
    d["default"].finish_all()
    sched.poll()
    assert h.status == "done" and h.slo_met is False
    assert sched.stats.slo_misses == 1
    return _record(sched, [h], d)


def case_config_validation(pkg):
    sched_mod = pkg[0]
    msgs = []
    for kw, match in ((dict(flush_fraction=0.0), "flush_fraction"),
                      (dict(buckets=()), "buckets"),
                      (dict(max_inflight=0), ">= 1"),
                      (dict(max_queue=0), ">= 1")):
        with pytest.raises(ValueError, match=match) as e:
            sched_mod.SchedulerConfig(**kw)
        msgs.append(str(e.value))
    assert sched_mod.SchedulerConfig(buckets=(32, 1, 8)).buckets == (1, 8, 32)
    with pytest.raises(KeyError):
        sched_mod.StandingQueryScheduler(clock=FakeClock()).submit(
            Q, lane="nope")
    with pytest.raises(ValueError, match="need an index"):
        sched_mod.StandingQueryScheduler(clock=FakeClock()).add_lane("x")
    with pytest.raises(ValueError, match="not both"):
        sched_mod.StandingQueryScheduler(
            config=sched_mod.SchedulerConfig(), clock=FakeClock(),
            max_queue=3)
    return dict(msgs=msgs, reasons=sched_mod.FLUSH_REASONS)


CASES = [case_idle_flush, case_full_flush_while_busy, case_deadline_flush,
         case_per_query_slo, case_deadline_min_over_queue,
         case_priority_lanes, case_backpressure, case_overlap_inorder,
         case_drain, case_slo_miss, case_config_validation]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_flush_policy_matches_jax(case):
    port, jax_ = (case(pkg) for pkg in PACKAGES)
    assert port == jax_


# ---------------------------------------------------------------- loadgen
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 9, 123])
def test_traces_equal_jax(kind, seed):
    kw = dict(n_queries=64, seed=seed, lanes=("default", "exact"),
              lane_weights=(0.7, 0.3), slo_budget_s=0.1)
    if kind == "poisson":
        t, j = (m.poisson_trace(5000.0, 400, **kw) for m in (tload, jload))
    else:
        t, j = (m.bursty_trace(500.0, 400, burst_factor=8.0, **kw)
                for m in (tload, jload))
    assert t == j
    assert np.array_equal(np.asarray([a.at for a in t]),
                          np.asarray([a.at for a in j]))
    assert all(type(a).__name__ == "Arrival" for a in t)


def test_trace_validation_matches_jax():
    for m in (tload, jload):
        with pytest.raises(ValueError):
            m.poisson_trace(0.0, 4, n_queries=2)
        with pytest.raises(ValueError):
            m.bursty_trace(10.0, 4, n_queries=2, burst_factor=0.5)
        with pytest.raises(ValueError, match="lane_weights"):
            m.poisson_trace(10.0, 4, n_queries=2, lanes=("a", "b"),
                            lane_weights=(1.0,))


def test_bursty_trace_mean_rate_and_determinism():
    t1 = tload.bursty_trace(500.0, 400, n_queries=8, seed=9)
    assert t1 == tload.bursty_trace(500.0, 400, n_queries=8, seed=9)
    assert 0.5 * 500 <= len(t1) / t1[-1].at <= 2.0 * 500
    ats = [a.at for a in t1]
    assert all(b > a for a, b in zip(ats, ats[1:]))
    assert all(0 <= a.query_id < 8 for a in t1)


# ---------------------------------------------------------------------------
# The port's index: padding hygiene and plan-cache behaviour
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(11)
    idx = JasperIndex(DIMS, 640, construction=SMALL, quantization="rabitq",
                      bits=4, device="cpu")
    idx.build(rng.normal(size=(500, DIMS)).astype(np.float32))
    queries = rng.normal(size=(5, DIMS)).astype(np.float32)
    return idx, queries


GRID = [
    ("exact/plain", tss.SearchSpec(k=5, beam_width=16)),
    ("rabitq/plain", tss.SearchSpec(k=5, beam_width=16, quantized=True)),
    ("exact/megakernel", tss.SearchSpec(k=5, beam_width=16,
                                        fusion="megakernel")),
    ("rabitq/megakernel", tss.SearchSpec(k=5, beam_width=16, quantized=True,
                                         use_kernels=True,
                                         fusion="megakernel")),
]


@pytest.mark.parametrize("label,spec", GRID, ids=[g[0] for g in GRID])
def test_coalesced_padded_equals_per_query_dispatch(built, label, spec):
    """5 queries coalesced and padded to the 8-bucket equal, per query,
    one-at-a-time dispatch through the same bucket, bit for bit; tickets
    are exactly k wide."""
    idx, queries = built
    sched = tsched.StandingQueryScheduler(idx, spec, buckets=(8,),
                                          slo_budget_s=10.0)
    handles = [sched.submit(q) for q in queries]
    sched.drain()
    assert sched.stats.batches == 1 and sched.stats.padded_rows == 3
    solo_sched = tsched.StandingQueryScheduler(idx, spec, buckets=(8,),
                                               slo_budget_s=10.0)
    ses = idx.searcher(spec)
    for i, h in enumerate(handles):
        assert h.status == "done"
        solo_sched.submit(queries[i])
        (solo,) = solo_sched.drain()
        assert np.array_equal(h.ids, solo.ids), label
        assert np.array_equal(h.dists, solo.dists), label
        assert h.n_hops == solo.n_hops and h.generation == solo.generation
        assert h.ids.shape == (5,) and h.dists.shape == (5,)
        raw = ses.search(queries[i:i + 1])
        assert np.array_equal(h.ids, raw.ids.numpy()[0]), label
        np.testing.assert_allclose(h.dists, raw.dists.numpy()[0], rtol=1e-6)


def test_mixed_spec_traffic_zero_steady_state_retraces(built):
    idx, _ = built
    rng = np.random.default_rng(7)
    pool = rng.normal(size=(64, DIMS)).astype(np.float32)
    lanes = {"exact": (tss.SearchSpec(k=5, beam_width=16), 1)}
    svc = AnnsService(idx, spec=tss.SearchSpec(k=5, beam_width=16,
                                               quantized=True))
    trace = tload.poisson_trace(5000.0, 150, n_queries=64, seed=3,
                                lanes=("default", "exact"),
                                lane_weights=(0.7, 0.3))
    for spec in (svc.spec, lanes["exact"][0]):
        ses = idx.searcher(spec)
        for b in (1, 8, 32):
            ses.search(pool[:b])
    svc.serve(trace, pool, lanes=lanes, buckets=(1, 8, 32), realtime=False)
    before = idx.plans.stats.snapshot()
    rep, handles = svc.serve(trace, pool, lanes=lanes, buckets=(1, 8, 32),
                             realtime=False)
    delta = idx.plans.stats.delta(before)
    assert delta["traces"] == 0 and delta["misses"] == 0, delta
    assert rep["completed"] == 150 and rep["rejected"] == 0
    assert sum(rep["flush_reasons"].values()) == rep["batches"]
    assert not idx.tombstoned(np.concatenate([h.ids for h in handles])).any()


def _obs_report():
    loc = importlib.util.spec_from_file_location(
        "obs_report", pathlib.Path(__file__).resolve().parents[1]
        / "scripts" / "obs_report.py")
    mod = importlib.util.module_from_spec(loc)
    loc.loader.exec_module(mod)
    return mod


def test_serve_folds_service_stats_and_metrics(built):
    idx, _ = built
    rng = np.random.default_rng(8)
    pool = rng.normal(size=(16, DIMS)).astype(np.float32)
    svc = AnnsService(idx, spec=tss.SearchSpec(k=5, beam_width=16,
                                               quantized=True))
    svc.metrics()
    trace = tload.poisson_trace(3000.0, 40, n_queries=16, seed=5)
    rep, handles = svc.serve(trace, pool, buckets=(1, 8), realtime=False)
    assert svc.stats.n_search_queries == 40 and svc.stats.hops_sum > 0
    snap = svc.metrics_snapshot()
    assert snap["scheduler.completed"] == 40
    assert snap["scheduler.queue_depth"] == 0
    assert snap["scheduler.batch_occupancy"]["count"] == \
        snap["scheduler.batches"]
    assert snap["search.latency_us"]["count"] >= 40
    json.dumps(snap)
    report = _obs_report()
    report.check_snapshot(snap)
    series = report.check_scheduler(snap)
    assert series["batches"] == sum(
        series[f"flush_{r}"] for r in ("full", "deadline", "idle", "drain"))


def test_serve_realtime_replays_arrival_times(built):
    """A realtime replay waits for each arrival's time on the clock."""
    idx, _ = built
    pool = np.random.default_rng(9).normal(size=(8, DIMS)).astype(np.float32)
    svc = AnnsService(idx, spec=tss.SearchSpec(k=5, beam_width=16))
    trace = tload.poisson_trace(2000.0, 20, n_queries=8, seed=1,
                                slo_budget_s=5.0)
    rep, handles = svc.serve(trace, pool, buckets=(1, 8), realtime=True)
    assert rep["completed"] == 20 and rep["wall_s"] >= trace[-1].at
    assert all(h.slo_budget_s == 5.0 for h in handles)


def test_rejected_handles_carry_no_query_payload(built):
    idx, queries = built
    sched = tsched.StandingQueryScheduler(
        idx, tss.SearchSpec(k=5, beam_width=16), buckets=(1,),
        max_queue=1, max_inflight=1, slo_budget_s=10.0)
    a = sched.submit(queries[0])
    b = sched.submit(queries[1])
    assert b.status == "rejected" and b.query is None
    done = sched.drain()
    assert a.status == "done" and len(done) == 1


# ------------------------------------------------------- LRU plan cache
def test_plan_cache_lru_eviction_and_counter():
    cache = tss.PlanCache(capacity=2)
    built = []

    def make_build(tag):
        def build():
            built.append(tag)
            return tag
        return build

    assert cache.get("a", make_build("a")) == "a"
    assert cache.get("b", make_build("b")) == "b"
    assert cache.get("a", make_build("a2")) == "a"
    assert cache.get("c", make_build("c")) == "c"
    assert cache.stats.evictions == 1
    assert cache.get("a", make_build("a3")) == "a"
    assert cache.get("b", make_build("b2")) == "b2"
    assert cache.stats.evictions == 2 and len(cache) == 2
    assert built == ["a", "b", "c", "b2"]
    assert cache.stats.as_dict()["evictions"] == 2


def test_plan_cache_capacity_validation_and_shrink():
    with pytest.raises(ValueError):
        tss.PlanCache(capacity=0)
    cache = tss.PlanCache()
    for i in range(5):
        cache.get(i, lambda i=i: (lambda: i))
    assert len(cache) == 5 and cache.stats.evictions == 0
    cache.capacity = 2
    assert len(cache) == 2 and cache.stats.evictions == 3


def test_index_plan_cache_capacity_kwarg_and_snapshot():
    rng = np.random.default_rng(3)
    idx = JasperIndex(DIMS, 320, construction=SMALL, plan_cache_capacity=2,
                      device="cpu")
    idx.build(rng.normal(size=(200, DIMS)).astype(np.float32))
    q = rng.normal(size=(4, DIMS)).astype(np.float32)
    base = len(idx.plans)
    for k in (3, 4, 5):
        idx.searcher(tss.SearchSpec(k=k, beam_width=16)).search(q)
    assert len(idx.plans) <= 2
    assert idx.plans.stats.evictions >= 1 + max(0, base - 2)
    svc = AnnsService(idx, spec=tss.SearchSpec(k=5, beam_width=16))
    snap = svc.metrics_snapshot()
    assert snap["plan_cache.capacity"] == 2
    assert snap["plan_cache.evictions"] == idx.plans.stats.evictions
    assert snap["plan_cache.entries"] == len(idx.plans)
