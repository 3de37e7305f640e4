"""The port's telemetry plane (`repro_torch.obs`) against the JAX
package's: span tracing (nesting, ordering, the no-op without a tracer,
thread safety, the Chrome trace export), the metrics registry and its
histograms (the same sequence gives equal snapshots in both packages),
the stats objects' plain-JSON snapshots, and the spans the port's index,
sessions and service emit."""

import json
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.core.construction import ConstructionParams
from repro_torch.core.index import JasperIndex
from repro_torch.core.search_spec import SearchSpec

D = 16
SMALL = ConstructionParams(degree_bound=16, alpha=1.2, beam_width=16,
                           max_iters=24, rev_cap=16, prune_chunk=256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_exports_match_jax():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in ("SEARCH_LATENCY_BUCKETS_US", "HOPS_BUCKETS",
                 "BEAM_OCCUPANCY_BUCKETS", "BATCH_OCCUPANCY_BUCKETS"):
        assert getattr(tobs, name) == getattr(jobs, name), name
    from repro.obs import metrics as jm
    from repro_torch.obs import metrics as tm
    assert tm.FETCH_LATENCY_BUCKETS_US == jm.FETCH_LATENCY_BUCKETS_US
    assert sorted(tm.__all__) == sorted(jm.__all__)


# ------------------------------------------------------------ span tracing
def test_span_nesting_and_ordering():
    tr = tobs.SpanTracer()
    with tobs.use_tracer(tr):
        with tobs.span("outer", tick=1):
            with tobs.span("inner_a"):
                pass
            with tobs.span("inner_b"):
                pass
    events = tr.events()
    assert [e["name"] for e in events] == ["inner_a", "inner_b", "outer"]
    by = {e["name"]: e for e in events}
    for child in ("inner_a", "inner_b"):
        assert by["outer"]["ts"] <= by[child]["ts"]
        assert (by[child]["ts"] + by[child]["dur"]
                <= by["outer"]["ts"] + by["outer"]["dur"] + 1)
    assert by["inner_a"]["ts"] + by["inner_a"]["dur"] <= by["inner_b"]["ts"]
    assert by["outer"]["args"] == {"tick": 1}
    doc = tr.to_chrome_trace()
    json.dumps(doc)
    assert doc["displayTimeUnit"] == "ms"
    for e in doc["traceEvents"]:
        assert e["ph"] == "X"
        for field in ("name", "ts", "dur", "pid", "tid"):
            assert field in e
    s = tr.summary()
    assert s["outer"]["count"] == 1
    assert s["outer"]["total_us"] >= s["inner_a"]["total_us"]
    assert set(s["outer"]) == {"count", "total_us", "max_us", "mean_us"}


def test_span_noop_without_tracer():
    assert tobs.get_tracer() is None
    with tobs.span("never_recorded"):
        pass
    assert tobs.get_tracer() is None
    assert tobs.span("a") is tobs.span("b")       # the shared no-op


def test_span_thread_safety():
    tr = tobs.SpanTracer()
    n_threads, n_spans = 8, 50
    gate = threading.Barrier(n_threads)

    def worker(i):
        gate.wait()
        for _ in range(n_spans):
            with tobs.span(f"t{i}"):
                pass

    with tobs.use_tracer(tr):
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(tr) == n_threads * n_spans
    s = tr.summary()
    assert all(s[f"t{i}"]["count"] == n_spans for i in range(n_threads))
    assert len({e["tid"] for e in tr.events()}) == n_threads


def test_chrome_traces_have_the_jax_keys(tmp_path):
    """The same spans through both packages' tracers: the same event keys,
    names, args and summary keys; both exports load as JSON."""
    docs, sums = [], []
    for mod in (tobs, jobs):
        tr = mod.SpanTracer()
        with mod.use_tracer(tr):
            with mod.span("service.step", n=np.int64(3)):
                with mod.span("service.search", k=10):
                    pass
        path = tmp_path / f"{mod.__name__}.json"
        tr.export(str(path))
        docs.append(json.loads(path.read_text()))
        sums.append(tr.summary())
        tr.clear()
        assert len(tr) == 0
    (t, j) = docs
    assert sorted(t) == sorted(j)
    assert [sorted(e) for e in t["traceEvents"]] == \
        [sorted(e) for e in j["traceEvents"]]
    assert [(e["name"], e.get("args")) for e in t["traceEvents"]] == \
        [(e["name"], e.get("args")) for e in j["traceEvents"]]
    assert {k: sorted(v) for k, v in sums[0].items()} == \
        {k: sorted(v) for k, v in sums[1].items()}


# ------------------------------------------------------- metrics registry
def _registry_script(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("requests")
    c.inc()
    c.inc(np.int64(4))
    with pytest.raises(ValueError):
        c.inc(-1)
    reg.gauge("depth").set(3)
    reg.gauge("live", fn=lambda: np.int32(7))
    h = reg.histogram("lat", buckets=(10, 100, 1000))
    h.observe_many([5, 50, 500, 5000, 10, 100.0])
    for bounds, name in ((mod.SEARCH_LATENCY_BUCKETS_US, "search.latency_us"),
                         (mod.HOPS_BUCKETS, "search.hops"),
                         (mod.BEAM_OCCUPANCY_BUCKETS, "occ"),
                         (mod.BATCH_OCCUPANCY_BUCKETS, "batch")):
        hist = reg.histogram(name, bounds)
        hist.observe_many(np.linspace(0.0, 2 * max(bounds), 37).tolist())
    reg.histogram("empty", buckets=(1.0,))
    reg.register_collector("svc", lambda: {"x": np.float32(1.5),
                                           "nested": {"a": np.int64(2)},
                                           "nan": float("nan")})
    with pytest.raises(TypeError):
        reg.gauge("requests")
    with pytest.raises(ValueError):
        mod.Histogram("none", ())
    assert reg.counter("requests") is c
    return reg.snapshot()


def test_registry_snapshots_equal_in_both_packages():
    t, j = _registry_script(tobs), _registry_script(jobs)
    assert t == j
    json.dumps(t)
    assert t["requests"] == 5 and t["lat"]["counts"] == [2, 2, 1, 1]
    assert t["svc.nan"] is None and t["empty"]["mean"] is None
    assert tobs.plain_json({"a": (np.int8(1), [np.float64(2.5)])}) == \
        jobs.plain_json({"a": (np.int8(1), [np.float64(2.5)])})


def test_service_stats_roundtrip():
    from repro_torch.serving.anns_service import ServiceStats
    st = ServiceStats()
    assert st.mean_hops == 0.0
    d = st.to_dict()
    assert json.loads(json.dumps(d)) == d
    st.n_searches, st.n_search_queries, st.hops_sum = 2, 10, 55.0
    assert st.to_dict()["mean_hops"] == pytest.approx(5.5)


# --------------------------------------------------------- the port's spans
def test_index_session_and_service_spans():
    """A build, a session's submit/drain and one service tick with the
    tracer installed: every span the JAX package emits on these paths,
    under the same names, and a snapshot with the JAX namespaces."""
    from repro_torch.serving.anns_service import AnnsService
    rng = np.random.default_rng(3)
    data = rng.normal(size=(300, D)).astype(np.float32)
    idx = JasperIndex(D, 512, construction=SMALL, quantization="rabitq",
                      bits=4, seed=3, device="cpu")
    tr = tobs.SpanTracer()
    q = rng.normal(size=(4, D)).astype(np.float32)
    with tobs.use_tracer(tr):
        idx.build(data[:256])
        ses = idx.searcher(k=5, beam_width=16, quantized=True)
        ses.submit(q)
        ses.drain()
        svc = AnnsService(idx, spec=SearchSpec(k=5, beam_width=16,
                                               quantized=True,
                                               telemetry="on"),
                          consolidate_threshold=0.05)
        svc.metrics()
        res = svc.step(queries=q, inserts=data[256:],
                       deletes=np.arange(30, dtype=np.int64))
    assert res.search.telemetry is not None
    names = {e["name"] for e in tr.events()}
    assert {"index.build", "searcher.submit", "searcher.drain",
            "service.step", "service.delete", "service.insert",
            "service.search", "service.consolidate"} <= names
    build = next(e for e in tr.events() if e["name"] == "index.build")
    assert build["args"] == {"n": 256, "sharded": False}
    snap = svc.metrics_snapshot()
    json.dumps(snap)
    for key in ("service.n_searches", "plan_cache.hit_rate",
                "shards.live", "search.latency_us", "search.hops",
                "search.beam_occupancy"):
        assert key in snap, key
    assert snap["search.latency_us"]["count"] == 1
    assert snap["search.hops"]["count"] == 4
    assert snap["service.n_deletes"] == 1
