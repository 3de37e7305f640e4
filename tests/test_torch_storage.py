"""The host rows tier (`repro_torch.core.storage`) against its own device
tier and against the JAX package's host tier.

Part 1 is the single-device half of tests/test_tiering.py asserted on the
port's `JasperIndex` on the CPU. Its anchor is bit identity: with the rows
evicted to the host, `rerank_source="host"` reproduces the device tier's
ids, dists, hops and telemetry bit for bit on every lane (the traversal
runs on the same packed codes either way, and the host rerank runs the
same `rerank_frontier` on the same gathered rows, then the same stable
sort). Then the resolve-time checks, the plan-cache keys (a host-tier
search is two plans), zero steady-state retraces on both tiers, churn
write-through across a grow, the checkpoint's tier, brute force with the
rows evicted, `VectorStore.gather` and `rows_staged` re-entrancy.

Part 2 crosses one JAX-built index into the port by its checkpoint
(integer-valued rows, so every exact distance is exact in any order):
the port's host tier against the JAX package's host tier on the six
lanes (ids and hops equal, dists within rtol 1e-3 / atol 1e-2, the
conformance tolerances), `memory_stats` / `storage_stats` keys and byte
values equal on both tiers, and host-tier checkpoints across the
packages both ways.
"""

import numpy as np
import pytest
import torch

from repro.core import search_spec as jss
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro_torch.core import search_spec as tss
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.index import JasperIndex as TIndex

SEED = 77
N, D, Q, K, BEAM = 512, 16, 16, 10, 32
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
# the timing keys of storage_stats: host clocks, never equal across runs
CLOCK_KEYS = ("fetch_total_s", "fetch_last_s")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    this file from competing with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _dataset():
    rng = np.random.default_rng(SEED)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(Q, D)).astype(np.float32))


def _index(capacity=N, quantization="rabitq", **kw):
    return TIndex(D, capacity, construction=TParams(**PARAMS),
                  quantization=quantization, bits=4, seed=SEED,
                  device="cpu", **kw)


def _same(a, b) -> bool:
    """Two SearchResults bit-equal in ids, dists, hops and telemetry."""
    same = (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.n_hops, b.n_hops))
    if a.telemetry is not None or b.telemetry is not None:
        same = same and all(torch.equal(x, y)
                            for x, y in zip(a.telemetry, b.telemetry))
    return same


@pytest.fixture(scope="module")
def built():
    """One rabitq index + queries, shared read-only by the spec tests."""
    data, queries = _dataset()
    idx = _index(2 * N)
    idx.build(data)
    idx.delete(np.arange(0, N, 11))
    return idx, queries


# ------------------------------------------------------------- resolution
def test_rerank_source_resolution_rules():
    SearchSpec = tss.SearchSpec
    r = SearchSpec(k=K, quantized=True).resolve()
    assert (r.rerank, r.rerank_source) == (True, "device")
    r = SearchSpec(k=K, quantized=True, rerank_source="none").resolve()
    assert (r.rerank, r.rerank_source) == (False, "none")
    a = SearchSpec(k=K, quantized=True, rerank=False).resolve()
    b = SearchSpec(k=K, quantized=True, rerank=True,
                   rerank_source="none").resolve()
    assert a == b and a.rerank_source == "none"
    r = SearchSpec(k=K, quantized=True, rerank_source="host").resolve()
    assert (r.rerank, r.rerank_source) == (True, "host")
    with pytest.raises(ValueError, match="contradict"):
        SearchSpec(k=K, quantized=True, rerank=False,
                   rerank_source="host").resolve()
    with pytest.raises(ValueError, match="exact"):
        SearchSpec(k=K, quantized=False, rerank_source="host").resolve()
    with pytest.raises(ValueError, match="exact"):
        SearchSpec(k=K, quantized=False, rerank_source="none").resolve()
    with pytest.raises(ValueError, match="rerank_source"):
        SearchSpec(k=K, quantized=True, rerank_source="bogus").resolve()
    for spec in (SearchSpec(k=K), SearchSpec(k=K, quantized=True),
                 SearchSpec(k=K, quantized=True, rerank=False),
                 SearchSpec(k=K, quantized=True, rerank_source="none")):
        r = spec.resolve()
        assert (r.rerank, r.rerank_source) in (
            (True, "device"), (True, "host"), (False, "none"))


def test_resolve_checks_index_tier(built):
    idx, _ = built
    assert idx.rows_tier == "device"
    with pytest.raises(ValueError, match="evicted"):
        tss.SearchSpec(k=K, quantized=True,
                       rerank_source="host").resolve(idx)
    data, _ = _dataset()
    ev = _index(rows_tier="host")
    ev.build(data)
    assert ev.rows_tier == "host" and ev.vectors is None
    with pytest.raises(ValueError, match="device-resident"):
        tss.SearchSpec(k=K, quantized=True).resolve(ev)
    # code-only serving never touches the rows: legal on either tier
    tss.SearchSpec(k=K, quantized=True, rerank_source="none").resolve(ev)
    tss.SearchSpec(k=K, quantized=True, rerank_source="none").resolve(idx)


def test_evict_requires_quantizer():
    data, _ = _dataset()
    idx = _index(quantization=None)
    idx.build(data)
    with pytest.raises(ValueError, match="rabitq"):
        idx.evict_rows_to_host()
    with pytest.raises(ValueError, match="rabitq"):
        TIndex(D, N, rows_tier="host", device="cpu")
    with pytest.raises(ValueError, match="rows_tier"):
        TIndex(D, N, quantization="rabitq", rows_tier="disk", device="cpu")
    with pytest.raises(ValueError, match="already device-resident"):
        idx.restore_rows_to_device()


def test_service_construction_fails_fast(built):
    from repro_torch.serving.anns_service import AnnsService
    idx, _ = built
    with pytest.raises(ValueError, match="evicted"):
        AnnsService(idx, spec=tss.SearchSpec(k=K, quantized=True,
                                             rerank_source="host"))
    data, _ = _dataset()
    ev = _index()
    ev.build(data)
    ev.evict_rows_to_host()
    with pytest.raises(ValueError, match="device-resident"):
        AnnsService(ev, spec=tss.SearchSpec(k=K, quantized=True))


# ------------------------------------------------------------ bit identity
HOST_LANES = {
    "jnp": {},
    "kernel": {"use_kernels": True},
    "hop": {"fusion": "hop"},
    "megakernel": {"fusion": "megakernel"},
    "telemetry": {"telemetry": "on"},
    "filtered": {"filter": (1,)},
}


@pytest.fixture(scope="module")
def tier_pair():
    """Device-tier results for every lane, then the same index evicted."""
    data, queries = _dataset()
    idx = _index(2 * N)
    idx.build(data, labels=(np.arange(N) % 2).astype(np.int32))
    idx.delete(np.arange(0, N, 11))
    device = {lane: idx.searcher(tss.SearchSpec(
        k=K, beam_width=BEAM, quantized=True, **kw)).search(queries)
        for lane, kw in HOST_LANES.items()}
    idx.evict_rows_to_host()
    return idx, queries, device


@pytest.mark.parametrize("lane", list(HOST_LANES))
def test_host_tier_bit_identical(tier_pair, lane):
    idx, queries, device = tier_pair
    spec = tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                          rerank_source="host", **HOST_LANES[lane])
    host = idx.searcher(spec).search(queries)
    assert _same(device[lane], host)
    assert (host.telemetry is not None) == (lane == "telemetry")
    assert host.estimated is False


def test_memory_stats_track_tiers(tier_pair):
    idx, _, _ = tier_pair
    ms = idx.memory_stats()
    assert ms["rows_tier"] == "host"
    assert ms["device_rows_bytes"] == 0.0
    assert ms["host_rows_bytes"] == idx.capacity * (D + 1) * 4
    assert ms["device_codes_bytes"] == ms["rabitq_resident_bytes"] > 0
    ss = idx.storage_stats()
    assert ss["fetch_n_fetches"] >= 1
    assert ss["fetch_n_bytes"] > 0
    rows_full = idx.capacity * (idx.store_dims + 1) * 4
    expect = (rows_full + ms["device_codes_bytes"]) / ms["device_codes_bytes"]
    assert ms["device_compression_ratio"] == pytest.approx(expect)


def test_code_only_lane_reports_estimated(tier_pair):
    idx, queries, _ = tier_pair
    res = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                      rerank_source="none")).search(queries)
    assert res.estimated is True
    host = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                       rerank_source="host")).search(queries)
    assert host.estimated is False
    assert not torch.equal(res.dists, host.dists)


def test_plan_cache_keys_by_rerank_source(tier_pair):
    """A host-tier search is two plans (the traversal, keyed as any
    search, and the ("rerank_host", ...) rerank); code-only adds one, and
    its two spellings share it."""
    idx, queries, _ = tier_pair
    base = dict(k=K, beam_width=BEAM, quantized=True)
    r_host = tss.SearchSpec(**base, rerank_source="host").resolve()
    r_none = tss.SearchSpec(**base, rerank_source="none").resolve()
    r_dev = tss.SearchSpec(**base).resolve()
    assert len({r_host, r_none, r_dev}) == 3
    idx.plans.clear()
    before = idx.plans.stats.snapshot()
    idx.searcher(tss.SearchSpec(**base, rerank_source="host")).search(queries)
    assert len(idx.plans) == 2
    assert idx.plans.stats.delta(before)["traces"] == 2
    idx.searcher(tss.SearchSpec(**base, rerank_source="none")).search(queries)
    assert len(idx.plans) == 3
    idx.searcher(tss.SearchSpec(**base, rerank_source="none")).search(queries)
    idx.searcher(tss.SearchSpec(**base, rerank=False)).search(queries)
    idx.searcher(tss.SearchSpec(**base, rerank_source="host")).search(queries)
    assert len(idx.plans) == 3
    assert idx.plans.stats.delta(before)["traces"] == 3


def test_scheduler_zero_steady_state_retraces_both_tiers():
    from repro_torch.serving.anns_service import AnnsService
    data, queries = _dataset()
    idx = _index()
    idx.build(data)

    def serve_twice(svc):
        sched = svc.scheduler()
        for q in queries:
            sched.submit(q)
        sched.drain()
        warm = idx.plans.stats.traces
        for q in queries:
            sched.submit(q)
        done = sched.drain()
        assert len(done) == Q and all(h.status == "done" for h in done)
        return warm, idx.plans.stats.traces

    warm, steady = serve_twice(AnnsService(
        idx, spec=tss.SearchSpec(k=K, beam_width=BEAM, quantized=True)))
    assert steady == warm, "device tier retraced in steady state"
    idx.evict_rows_to_host()
    warm, steady = serve_twice(AnnsService(
        idx, spec=tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                 rerank_source="host")))
    assert steady == warm, "host tier retraced in steady state"


def test_host_tier_service_metrics():
    """A host-tier service serves, and its snapshot carries `storage.*`
    with one `storage.fetch_latency_us` observation a served batch."""
    from repro_torch.serving.anns_service import AnnsService
    data, queries = _dataset()
    idx = _index(rows_tier="host")
    idx.build(data)
    svc = AnnsService(idx, spec=tss.SearchSpec(
        k=K, beam_width=BEAM, quantized=True, rerank_source="host"))
    svc.metrics()
    n0 = idx.store.fetch_stats.n_fetches
    for _ in range(3):
        (t,) = svc.run([("search", queries)])
        assert t.ids.shape == (Q, K)
    snap = svc.metrics_snapshot()
    assert snap["storage.rows_tier"] == "host"
    assert snap["storage.device_rows_bytes"] == 0.0
    assert snap["storage.fetch_n_fetches"] == n0 + 3
    assert snap["storage.fetch_latency_us"]["count"] == 3


# ------------------------------------------------------------------ churn
def test_churn_keeps_tiers_in_sync():
    """insert/delete/consolidate/grow with the rows on the host keep the
    device codes and the host rows consistent: host == device bit for bit
    after the churn (the device twin is the same index restored)."""
    rng = np.random.default_rng(SEED + 1)
    data, queries = _dataset()
    idx = _index()
    idx.build(data)
    idx.evict_rows_to_host()
    cap0 = idx.capacity
    ids = idx.insert(rng.normal(size=(64, D)).astype(np.float32))
    idx.delete(ids[:16])
    idx.delete(np.arange(0, N, 7))
    idx.consolidate()
    idx.insert(rng.normal(size=(cap0, D)).astype(np.float32))  # grows
    assert idx.capacity > cap0
    assert idx.rows_tier == "host" and idx.vectors is None
    host = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                       rerank_source="host")).search(queries)
    idx.restore_rows_to_device()
    dev = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM,
                                      quantized=True)).search(queries)
    assert torch.equal(dev.ids, host.ids)
    assert torch.equal(dev.dists, host.dists)
    idx.evict_rows_to_host()
    assert idx.store.host_bytes == idx.capacity * (idx.store_dims + 1) * 4


def test_staged_churn_keeps_plans():
    """Delete, insert and consolidate on a host-tier index retrace neither
    stage (staging moves only the rows); a grow retraces the traversal
    once, and the rerank, whose operands never depend on the core's
    shapes, not at all."""
    rng = np.random.default_rng(SEED + 2)
    data, queries = _dataset()
    idx = _index(2 * N)
    idx.build(data)
    idx.evict_rows_to_host()
    ses = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                      rerank_source="host"))
    idx.delete(np.arange(3))          # the liveness mode: on
    ses.search(queries)
    base = idx.plans.stats.snapshot()
    idx.delete(np.arange(10, 40))
    ses.search(queries)
    idx.insert(rng.normal(size=(32, D)).astype(np.float32))
    ses.search(queries)
    idx.consolidate()
    ses.search(queries)
    assert idx.plans.stats.delta(base)["traces"] == 0
    idx.grow()
    ses.search(queries)
    assert idx.plans.stats.delta(base)["traces"] == 1


def test_checkpoint_round_trips_tier(tmp_path):
    data, queries = _dataset()
    idx = _index()
    idx.build(data)
    idx.evict_rows_to_host()
    path = str(tmp_path / "tiered.npz")
    idx.save(path)
    assert idx.rows_tier == "host"          # saving does not flip tiers
    idx2 = TIndex.load(path, device="cpu")
    assert idx2.rows_tier == "host"
    ms = idx2.memory_stats()
    assert ms["device_rows_bytes"] == 0.0 and ms["host_rows_bytes"] > 0
    host = idx2.searcher(tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                        rerank_source="host")).search(queries)
    idx2.restore_rows_to_device()
    dev = idx2.searcher(tss.SearchSpec(k=K, beam_width=BEAM,
                                       quantized=True)).search(queries)
    assert torch.equal(dev.ids, host.ids)
    assert torch.equal(dev.dists, host.dists)


def test_brute_force_works_rows_evicted():
    """Ground-truth scans stage the rows in and put them back."""
    data, queries = _dataset()
    idx = _index()
    idx.build(data)
    gt_dev, d_dev = idx.brute_force(queries, K)
    idx.evict_rows_to_host()
    gt_host, d_host = idx.brute_force(queries, K)
    assert idx.rows_tier == "host" and idx.vectors is None
    assert torch.equal(gt_dev, gt_host) and torch.equal(d_dev, d_host)


# ------------------------------------------------------------ vector store
def test_vector_store_gather():
    from dataclasses import replace

    from repro_torch.core.index_core import init_core
    from repro_torch.core.storage import VectorStore, strip_rows
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(32, D)).astype(np.float32)
    core = init_core(32, D, 8, "cpu")
    t = torch.as_tensor(rows)
    core = replace(core, vectors=t.clone(), vec_sqnorm=(t * t).sum(dim=-1))
    store = VectorStore()
    stripped = store.evict(core)
    assert stripped.vectors is None and stripped.vec_sqnorm is None
    got, sq = store.gather(np.array([[3, -1], [0, 31]]))
    assert got.shape == (4, D) and sq.shape == (4,)
    np.testing.assert_array_equal(_np(got[0]), rows[3])
    np.testing.assert_array_equal(_np(got[1]), 0.0)     # -1 -> zero row
    assert float(sq[1]) == 0.0
    np.testing.assert_array_equal(_np(got[3]), rows[31])
    np.testing.assert_array_equal(_np(sq[3]), (rows[31] ** 2).sum())
    st = store.fetch_stats
    assert st.n_fetches == 1 and st.n_rows == 3         # -1 not counted
    assert st.n_bytes == 3 * (D + 1) * 4
    assert store.stats()["fetch_bytes_per_fetch"] == st.n_bytes
    back = store.attach(stripped)
    np.testing.assert_array_equal(_np(back.vectors), rows)
    assert strip_rows(back).vectors is None
    with pytest.raises(ValueError, match="already evicted"):
        store.evict(stripped)
    store.restore(stripped)
    with pytest.raises(ValueError, match="device-tier"):
        store.gather(np.array([0]))


def test_rows_staged_is_reentrant():
    from repro_torch.core.storage import rows_resident, rows_staged
    data, _ = _dataset()
    idx = _index()
    idx.build(data)
    idx.evict_rows_to_host()
    assert not rows_resident(idx.core)
    with rows_staged(idx):
        assert rows_resident(idx.core)
        with rows_staged(idx):                      # nested: no-op
            assert rows_resident(idx.core)
        assert rows_resident(idx.core)              # inner exit kept rows
    assert not rows_resident(idx.core)
    assert idx.rows_tier == "host"


# ------------------------------------------------ part 2: the JAX package
@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """One JAX-built index (integer rows, labels, tombstones) and its
    checkpoint loaded into the port; both evicted to the host tier after
    their device-tier stats are taken."""
    rng = np.random.default_rng(SEED + 3)
    data = rng.integers(-6, 7, (N, D)).astype(np.float32)
    queries = rng.integers(-6, 7, (Q, D)).astype(np.float32)
    jidx = JIndex(D, 2 * N, construction=JParams(**PARAMS),
                  quantization="rabitq", bits=4, seed=SEED)
    jidx.build(data, labels=(np.arange(N) % 2).astype(np.int32))
    jidx.delete(np.arange(0, N, 9))
    path = str(tmp_path_factory.mktemp("crossed") / "device.npz")
    jidx.save(path)
    tidx = TIndex.load(path, device="cpu")
    stats = {"device": (jidx.memory_stats(), tidx.memory_stats(),
                        jidx.storage_stats(), tidx.storage_stats())}
    jidx.evict_rows_to_host()
    tidx.evict_rows_to_host()
    return dict(jidx=jidx, tidx=tidx, queries=queries, stats=stats)


@pytest.mark.parametrize("lane", list(HOST_LANES))
def test_host_tier_matches_jax(crossed, lane):
    q = crossed["queries"]
    kw = dict(k=K, beam_width=BEAM, quantized=True, rerank_source="host",
              **HOST_LANES[lane])
    j = crossed["jidx"].searcher(jss.SearchSpec(**kw)).search(q)
    t = crossed["tidx"].searcher(tss.SearchSpec(**kw)).search(q)
    assert np.array_equal(_np(t.ids), np.asarray(j.ids))
    assert np.array_equal(_np(t.n_hops), np.asarray(j.n_hops))
    np.testing.assert_allclose(_np(t.dists), np.asarray(j.dists),
                               rtol=DIST_RTOL, atol=DIST_ATOL)
    assert t.estimated is j.estimated is False


@pytest.mark.parametrize("tier", ["device", "host"])
def test_memory_and_storage_stats_match_jax(crossed, tier):
    if tier == "device":
        jm, tm, js, ts = crossed["stats"]["device"]
    else:
        q = crossed["queries"]
        kw = dict(k=K, beam_width=BEAM, quantized=True, rerank_source="host")
        jidx, tidx = crossed["jidx"], crossed["tidx"]
        jidx.searcher(jss.SearchSpec(**kw)).search(q)
        tidx.searcher(tss.SearchSpec(**kw)).search(q)
        jm, tm = jidx.memory_stats(), tidx.memory_stats()
        js, ts = jidx.storage_stats(), tidx.storage_stats()
    assert tm == jm
    assert tm["rows_tier"] == tier
    assert set(ts) == set(js)
    assert {k: v for k, v in ts.items() if k not in CLOCK_KEYS} == \
        {k: v for k, v in js.items() if k not in CLOCK_KEYS}


def _tier_search(idx, spec_mod, q):
    res = idx.searcher(spec_mod.SearchSpec(
        k=K, beam_width=BEAM, quantized=True,
        rerank_source="host")).search(q)
    return _np(res.ids), _np(res.dists)


def test_jax_host_checkpoint_loads_into_the_port(crossed, tmp_path):
    path = str(tmp_path / "jax_host.npz")
    crossed["jidx"].save(path)
    tidx = TIndex.load(path, device="cpu")
    assert tidx.rows_tier == "host" and tidx.vectors is None
    assert tidx.store.host_bytes == crossed["jidx"].store.host_bytes
    ids, dists = _tier_search(tidx, tss, crossed["queries"])
    j_ids, j_dists = _tier_search(crossed["jidx"], jss, crossed["queries"])
    assert np.array_equal(ids, j_ids)
    np.testing.assert_allclose(dists, j_dists, rtol=DIST_RTOL,
                               atol=DIST_ATOL)


def test_port_host_checkpoint_loads_into_jax(crossed, tmp_path):
    path = str(tmp_path / "port_host.npz")
    crossed["tidx"].save(path)
    jidx = JIndex.load(path)
    assert jidx.rows_tier == "host" and jidx.core.vectors is None
    assert jidx.store.host_bytes == crossed["tidx"].store.host_bytes
    ids, dists = _tier_search(jidx, jss, crossed["queries"])
    t_ids, t_dists = _tier_search(crossed["tidx"], tss, crossed["queries"])
    assert np.array_equal(ids, t_ids)
    np.testing.assert_allclose(dists, t_dists, rtol=DIST_RTOL,
                               atol=DIST_ATOL)
