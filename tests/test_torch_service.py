"""The port's `AnnsService` against the JAX package's, and its own
contract.

One op stream — ticks of deletes, inserts and searches, two tenants, an
auto-consolidate, a search_many and a run — goes through both packages'
services over one index (built by the JAX package, crossed into the port
by its checkpoint; integer-valued rows, so every distance is exact and
both packages build the same graph). The tickets' ids agree to the
conformance bar (>= 0.95) and their dists within rtol 1e-3 / atol 1e-2;
generations, `ServiceStats`, tenant stats, the tick that consolidates and
the `metrics_snapshot()` keys, `storage.*` (the tiered store) included,
are equal.

Then the service's own cases: the generation stamp through consolidate,
auto-grow mid-churn, refused deletes, the single-device rebalance no-op,
spec versus legacy kwargs, pipelined searches, lazy op streams, and
construction-time refusals.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import search_spec as jss
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro.serving.anns_service import AnnsService as JService
from repro_torch.core import search_spec as tss
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.index import JasperIndex as TIndex
from repro_torch.serving.anns_service import AnnsService, SearchTicket

PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
SMALL = TParams(**PARAMS)
ID_AGREEMENT = 0.95
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ one stream, two packages
def _ints(rng, n, d=24):
    return rng.integers(-8, 9, (n, d)).astype(np.float32)


def _stream(svc, rng_seed):
    """Drive one service; return what the packages must agree on."""
    rng = np.random.default_rng(rng_seed)
    out = {"tickets": [], "consolidated_at": [], "ids": []}
    svc.register_tenant("acme", quota_rows=200)
    svc.register_tenant("beta")
    live = list(range(400))
    for tick in range(8):
        dead = sorted(rng.choice(live, 12, replace=False).tolist())
        live = [i for i in live if i not in set(dead)]
        res = svc.step(deletes=np.asarray(dead), inserts=_ints(rng, 10),
                       queries=_ints(rng, 6))
        live += res.inserted_ids.tolist()
        out["ids"].append(res.inserted_ids.tolist())
        if res.consolidated is not None:
            out["consolidated_at"].append((tick, res.consolidated))
        out["tickets"].append(res.search)
        for name in ("acme", "beta"):
            out["ids"].append(svc.tenant_insert(name, _ints(rng, 5)).tolist())
            for mode in ("traverse", "exclude"):
                out["tickets"].append(
                    svc.tenant_search(name, _ints(rng, 3), filter_mode=mode))
    out["tickets"] += svc.search_many([_ints(rng, 4), _ints(rng, 7)])
    ran = svc.run([("search", _ints(rng, 5)), ("delete", np.asarray(live[:3])),
                   ("insert", _ints(rng, 4)), ("search", _ints(rng, 5)),
                   ("consolidate", None)])
    out["tickets"] += [ran[0], ran[3]]
    out["ids"].append(ran[2].tolist())
    out["stats"] = svc.stats.as_dict()
    out["tenants"] = svc.tenant_stats()
    out["keys"] = set(svc.metrics_snapshot())
    out["generation"] = svc.generation
    return out


def test_op_stream_matches_jax(tmp_path):
    rng = np.random.default_rng(31)
    jidx = JIndex(24, 512, construction=JParams(**PARAMS),
                  quantization="rabitq", bits=4, seed=2)
    jidx.build(_ints(rng, 400))
    path = os.path.join(tmp_path, "idx.npz")
    jidx.save(path)
    tidx = TIndex.load(path, device="cpu")
    kw = dict(consolidate_threshold=0.05, verify=True)
    j = _stream(JService(jidx, spec=jss.SearchSpec(
        k=10, beam_width=32, quantized=True), **kw), 5)
    t = _stream(AnnsService(tidx, spec=tss.SearchSpec(
        k=10, beam_width=32, quantized=True), **kw), 5)
    assert t["ids"] == j["ids"]
    assert t["consolidated_at"] == j["consolidated_at"]
    assert t["consolidated_at"], "the stream never auto-consolidated"
    assert len(t["tickets"]) == len(j["tickets"])
    for a, b in zip(t["tickets"], j["tickets"]):
        assert a.generation == b.generation
        assert isinstance(a.ids, np.ndarray)
        assert float(np.mean(a.ids == np.asarray(b.ids))) >= ID_AGREEMENT
        np.testing.assert_allclose(a.dists, np.asarray(b.dists),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)
    assert t["stats"] == j["stats"]
    assert t["tenants"] == j["tenants"]
    assert t["generation"] == j["generation"]
    assert t["keys"] == j["keys"]
    assert {k.split(".")[0] for k in t["keys"]} >= {
        "service", "plan_cache", "shards", "search", "tenants", "storage"}


# ------------------------------------------------------ the service's cases
@pytest.fixture()
def svc():
    rng = np.random.default_rng(77)
    idx = TIndex(24, 640, construction=SMALL, quantization="rabitq", bits=4,
                 device="cpu")
    idx.build(rng.normal(size=(500, 24)).astype(np.float32))
    with pytest.warns(DeprecationWarning):
        service = AnnsService(idx, k=10, beam_width=32,
                              consolidate_threshold=0.2, verify=True)
    return service, rng


def test_stale_generation_after_consolidate(svc):
    service, rng = svc
    q = rng.normal(size=(16, 24)).astype(np.float32)
    t0 = service.search(q)
    dead = np.asarray(t0.ids[0][t0.ids[0] >= 0][:5])
    service.delete(dead)
    forced = service.maybe_consolidate(force=True)
    assert forced is not None and forced["n_freed"] == dead.size
    t1 = service.search(q)
    assert t1.generation > t0.generation
    assert t1.generation == service.index.generation
    assert service.index.tombstoned(dead).all()
    assert not np.isin(t1.ids[t1.ids >= 0], dead).any()


def test_insert_at_capacity_triggers_auto_grow(svc):
    service, rng = svc
    idx = service.index
    q = rng.normal(size=(8, 24)).astype(np.float32)
    cap0 = idx.capacity
    gen_before = idx.generation
    res = service.step(
        deletes=np.arange(10),
        inserts=rng.normal(size=(cap0 - 500 + 60, 24)).astype(np.float32),
        queries=q)
    assert idx.capacity == 2 * cap0
    assert service.stats.n_grows == 1
    assert res.inserted_ids.size == cap0 - 500 + 60
    assert not idx.tombstoned(res.search.ids[res.search.ids >= 0]).any()
    assert res.search.generation > gen_before
    assert res.search.generation == idx.generation
    t2 = service.search(q)
    assert t2.generation >= res.search.generation
    assert not idx.tombstoned(t2.ids[t2.ids >= 0]).any()


def test_delete_already_tombstoned_id_raises_and_preserves_generation(svc):
    service, rng = svc
    q = rng.normal(size=(8, 24)).astype(np.float32)
    service.delete([3, 5])
    gen = service.index.generation
    stats_before = service.stats.as_dict()
    with pytest.raises(ValueError, match="already deleted"):
        service.delete([5])
    with pytest.raises(ValueError, match="out of range"):
        service.delete([10_000])
    assert service.index.generation == gen
    assert service.stats.as_dict()["n_delete_rows"] == \
        stats_before["n_delete_rows"]
    t = service.search(q)
    assert t.generation == gen
    assert not np.isin(t.ids, [3, 5]).any()


def test_rebalance_is_a_no_op_on_one_device(svc):
    service, rng = svc
    service.rebalance_threshold = 0.5
    q = rng.normal(size=(8, 24)).astype(np.float32)
    gen = service.index.generation
    assert service.maybe_rebalance(force=True) is None
    res = service.step(queries=q)
    assert res.rebalanced is None
    assert service.stats.n_rebalances == 0
    assert res.search.generation == gen


# ------------------------------------------ spec versus legacy kwargs
N, D, Q = 600, 24, 24


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(99)
    idx = TIndex(D, N + 64, construction=SMALL, quantization="rabitq",
                 bits=4, device="cpu")
    idx.build(rng.normal(size=(N, D)).astype(np.float32))
    return idx, rng.normal(size=(Q, D)).astype(np.float32)


def test_service_accepts_spec_and_rejects_mixed_kwargs(built):
    idx, q = built
    spec = tss.SearchSpec(k=10, beam_width=32, quantized=True)
    svc = AnnsService(idx, spec=spec, verify=True)
    t = svc.search(q)
    assert isinstance(t, SearchTicket) and isinstance(t, tss.SearchResult)
    assert t.n_hops.shape == (Q,) and (t.n_hops > 0).all()
    assert svc.stats.mean_hops == pytest.approx(float(t.n_hops.mean()))
    assert svc.stats.last_mean_hops == pytest.approx(float(t.n_hops.mean()))
    with pytest.warns(DeprecationWarning, match="SearchSpec"):
        legacy = AnnsService(idx, k=10, beam_width=32, quantized=True)
    t2 = legacy.search(q)
    assert (t.ids == t2.ids).all() and t.generation == t2.generation
    with pytest.raises(ValueError, match="not both"):
        AnnsService(idx, spec=spec, beam_width=16)


def test_service_search_many_pipelines_one_generation(built):
    idx, q = built
    svc = AnnsService(idx, spec=tss.SearchSpec(k=10, beam_width=32),
                      verify=True)
    tickets = svc.search_many([q, q[: Q // 2], q])
    assert len(tickets) == 3
    assert len({t.generation for t in tickets}) == 1
    ref = svc.search(q)
    assert (tickets[0].ids == ref.ids).all()
    assert svc.stats.n_searches == 4
    out = svc.run([("search", q), ("search", q[: Q // 2])])
    assert (out[0].ids == ref.ids).all()
    assert out[1].ids.shape == (Q // 2, 10)


def test_service_run_consumes_stream_lazily(built):
    idx, q = built
    svc = AnnsService(idx, spec=tss.SearchSpec(k=10, beam_width=32),
                      verify=True)
    executed = []

    def stream():
        yield ("insert", np.random.default_rng(1)
               .normal(size=(8, D)).astype(np.float32))
        executed.append(svc.stats.n_inserts)
        yield ("search", q)
        yield ("search", q[: Q // 2])

    out = svc.run(stream())
    assert executed == [1] and len(out) == 3
    assert out[1].ids.shape == (Q, 10) and out[2].ids.shape == (Q // 2, 10)
    with pytest.raises(ValueError, match="unknown op"):
        svc.run([("bogus", None)])


def test_service_per_call_kwarg_override_deprecated_but_working(built):
    idx, q = built
    svc = AnnsService(idx, spec=tss.SearchSpec(k=10, beam_width=32))
    with pytest.warns(DeprecationWarning, match="per-call"):
        t = svc.search(q, beam_width=64)
    ref = idx.searcher(tss.SearchSpec(k=10, beam_width=64)).search(q)
    assert (t.ids == ref.ids.numpy()).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        t2 = svc.search(q, beam_width=None)
    assert (t2.ids == svc.search(q).ids).all()


def test_service_invalid_spec_fails_at_construction(built):
    idx, _ = built
    with pytest.raises(ValueError):
        AnnsService(idx, spec=tss.SearchSpec(k=0))
    codeless = TIndex(D, 64, construction=SMALL, device="cpu")
    with pytest.raises(ValueError, match="rabitq"):
        AnnsService(codeless, spec=tss.SearchSpec(quantized=True))
    # host-tier reranks need evicted rows, as in the JAX package
    with pytest.raises(ValueError, match="rerank_source='host'"):
        AnnsService(idx, spec=tss.SearchSpec(quantized=True,
                                             rerank_source="host"))


def test_tenants_are_isolated_and_quota_bound(built):
    idx, q = built
    rng = np.random.default_rng(4)
    svc = AnnsService(idx, spec=tss.SearchSpec(k=10, beam_width=32,
                                               quantized=True))
    a = svc.register_tenant("a", quota_rows=20)
    b = svc.register_tenant("b")
    assert (a, b) == (0, 1) and svc.tenants == ("a", "b")
    ida = svc.tenant_insert("a", rng.normal(size=(20, D)).astype(np.float32))
    idb = svc.tenant_insert("b", rng.normal(size=(30, D)).astype(np.float32))
    with pytest.raises(ValueError, match="quota"):
        svc.tenant_insert("a", rng.normal(size=(1, D)).astype(np.float32))
    for mode in ("traverse", "exclude"):
        ta = svc.tenant_search("a", q, filter_mode=mode)
        tb = svc.tenant_search("b", q, filter_mode=mode)
        assert np.isin(ta.ids[ta.ids >= 0], ida).all()
        assert np.isin(tb.ids[tb.ids >= 0], idb).all()
    with pytest.raises(ValueError, match="not owned"):
        svc.tenant_delete("a", idb[:2])
    assert svc.tenant_delete("a", ida[:3]) == 3
    assert svc.tenant_stats("a")["live"] == 17
    with pytest.raises(ValueError, match="already registered"):
        svc.register_tenant("a")
