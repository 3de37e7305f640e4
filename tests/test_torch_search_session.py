"""The session half of the port's search surface against the JAX package:
the bucket ladder, the LRU `PlanCache` and its counters, `Searcher`
sessions (plans shared across sessions and the legacy calls, zero
retraces on reuse, submit/drain), `SearchSurface.recall`, the plans'
bookkeeping (trace counts across mutations, buffers kept by
shape-preserving mutations, the device scalars' view), and one search
sequence through both packages' `Searcher`s on a crossed index.

Float results are held to the conformance suite's tolerances
(tests/test_conformance.py): id agreement >= 0.95, dists rtol 1e-3 /
atol 1e-2; integers, counters and stats exactly.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import search_spec as jss
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro_torch.core import plans as tplans
from repro_torch.core import search_spec as tss
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.index import JasperIndex as TIndex

PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
N, D, Q = 600, 24, 24
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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(99)
    idx = TIndex(D, N + 64, construction=TParams(**PARAMS),
                 quantization="rabitq", bits=4, device="cpu")
    idx.build(rng.normal(size=(N, D)).astype(np.float32))
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    return idx, queries


# ------------------------------------------------------------ bucket ladder
@pytest.mark.parametrize("ladder", [tss.BUCKET_LADDER, (4, 16), (3, 5, 64)],
                         ids=["default", "4-16", "3-5-64"])
def test_bucket_for_and_padding_match_jax(ladder):
    rng = np.random.default_rng(1)
    assert tss.BUCKET_LADDER == jss.BUCKET_LADDER
    for n in range(1, 301):
        assert tss.bucket_for(n, ladder) == jss.bucket_for(n, ladder), n
        q = rng.normal(size=(n, 3)).astype(np.float32)
        if n > max(ladder):       # callers split batches above the top rung
            for mod in (tss, jss):
                with pytest.raises(ValueError):
                    mod.pad_to_bucket(q, ladder)
            continue
        tp, tn = tss.pad_to_bucket(q, ladder)
        jp, jn = jss.pad_to_bucket(q, ladder)
        assert tn == jn == n
        assert tp.shape == jp.shape and np.array_equal(tp, np.asarray(jp))
    for mod in (tss, jss):
        with pytest.raises(ValueError):
            mod.bucket_for(0, ladder)


# --------------------------------------------------------------- plan cache
def _cache_script(mod):
    """One sequence of get / count_trace / clear / capacity changes; the
    stats after each step and the plans built, in order."""
    cache = mod.PlanCache(capacity=3)
    built, snaps = [], []

    def get(key):
        def build():
            built.append(key)
            cache.count_trace()
            return key
        cache.get(key, build)
        snaps.append((cache.stats.as_dict(), len(cache)))

    for key in ("a", "b", "a", "c", "d", "b", "a", "e", "e"):
        get(key)
    cache.capacity = 1                      # shrinking evicts at once
    snaps.append((cache.stats.as_dict(), len(cache)))
    get("a")
    cache.clear()                           # plans go, stats stay
    snaps.append((cache.stats.as_dict(), len(cache)))
    cache.capacity = None
    for key in ("x", "y", "z", "x"):
        get(key)
    errors = []
    for bad in (0, -2):
        with pytest.raises(ValueError) as e:
            mod.PlanCache(capacity=bad)
        errors.append(str(e.value))
    before = cache.stats.snapshot()
    get("w")
    return built, snaps, errors, cache.stats.delta(before)


def test_plan_cache_sequence_matches_jax():
    t, j = _cache_script(tss), _cache_script(jss)
    assert t == j
    built, snaps, _, delta = t
    assert snaps[8][0]["evictions"] >= 1      # LRU evicted under capacity 3
    assert delta == {"hits": 0, "misses": 1, "traces": 1, "evictions": 0}


def test_cache_stats_guarded_and_equal():
    for mod in (tss, jss):
        empty = mod.CacheStats()
        assert empty.hit_rate == 0.0 and empty.as_dict()["hit_rate"] == 0.0
    t = tss.CacheStats(hits=3, misses=1, traces=1, evictions=2)
    j = jss.CacheStats(hits=3, misses=1, traces=1, evictions=2)
    assert t.as_dict() == j.as_dict()
    assert t.snapshot().as_dict() == j.snapshot().as_dict()
    assert t.delta(tss.CacheStats(hits=1)) == j.delta(jss.CacheStats(hits=1))


# ------------------------------------------- sessions on the port's index
def test_search_result_fields(built):
    idx, q = built
    res = idx.searcher(k=5, beam_width=32).search(q)
    assert isinstance(res, tss.SearchResult)
    assert tuple(res.ids.shape) == (Q, 5) and tuple(res.dists.shape) == (Q, 5)
    hops = _np(res.n_hops)
    assert hops.shape == (Q,) and (hops > 0).all()
    assert res.generation == idx.generation
    assert type(idx.searcher(k=3)) is tss.Searcher
    assert isinstance(idx, tss.SearchSurface)


def test_searcher_session_zero_retraces(built):
    idx, q = built
    ses = idx.searcher(tss.SearchSpec(k=10, beam_width=24, quantized=True))
    ses.search(q)
    mid = idx.plans.stats.snapshot()
    for _ in range(3):
        ses.search(q)
    after = idx.plans.stats
    assert after.traces == mid.traces          # zero retraces
    assert after.misses == mid.misses          # no new plan entries
    assert after.hits == mid.hits + 3          # pure cache hits
    assert ses.cache_stats is idx.plans.stats


def test_plan_cache_shared_across_sessions_and_shims(built):
    idx, q = built
    spec = tss.SearchSpec(k=10, beam_width=28)
    idx.searcher(spec).search(q)
    mid = idx.plans.stats.snapshot()
    idx.searcher(tss.SearchSpec(k=10, beam_width=28)).search(q)
    idx.search(q, 10, beam_width=28)                          # legacy shim
    after = idx.plans.stats
    assert after.traces == mid.traces
    assert after.hits == mid.hits + 2


def test_new_shape_or_spec_compiles_new_plan(built):
    idx, q = built
    ses = idx.searcher(tss.SearchSpec(k=10, beam_width=26))
    ses.search(q)
    mid = idx.plans.stats.snapshot()
    ses.search(q[: Q // 2])                    # new query shape
    idx.searcher(tss.SearchSpec(k=10, beam_width=27)).search(q)
    after = idx.plans.stats
    assert after.misses == mid.misses + 2
    assert after.traces == mid.traces + 2


def test_submit_drain_matches_sync_search(built):
    idx, q = built
    ses = idx.searcher(tss.SearchSpec(k=10, beam_width=32, quantized=True,
                                      telemetry="on"))
    ref = ses.search(q)
    assert ses.submit(q) == 1
    assert ses.submit(q[: Q // 2]) == 2
    assert ses.pending == 2
    out = ses.drain()
    assert ses.pending == 0 and len(out) == 2
    assert (out[0].ids == _np(ref.ids)).all()
    assert (out[0].dists == _np(ref.dists)).all()
    assert (out[1].ids == _np(ref.ids)[: Q // 2]).all()
    assert isinstance(out[0].ids, np.ndarray)  # drained results are host
    assert isinstance(out[0].n_hops, np.ndarray)
    assert all(isinstance(t, np.ndarray) for t in out[0].telemetry)
    assert out[0].generation == ref.generation
    ses.submit(q)
    ses.submit(q)
    assert len(ses.drain(limit=1)) == 1 and ses.pending == 1
    assert len(ses.drain()) == 1


def test_recall_honors_full_spec(built):
    idx, q = built
    spec = tss.SearchSpec(k=10, beam_width=48, quantized=True,
                          use_kernels=True, expand=2)
    r = idx.recall(q, spec=spec)
    assert 0.5 < r <= 1.0
    r2 = idx.recall(q, k=10, beam_width=48, quantized=True,
                    use_kernels=True, expand=2)
    assert r == r2
    assert r == tss.measure_recall(idx, q, spec)


# ------------------------------------------------- the plans' bookkeeping
def _fresh(seed=5, n=300, cap=320):
    rng = np.random.default_rng(seed)
    idx = TIndex(D, cap, construction=TParams(**PARAMS),
                 quantization="rabitq", bits=4, device="cpu")
    idx.build(rng.normal(size=(n, D)).astype(np.float32))
    return idx, rng


def test_shape_preserving_mutations_keep_every_buffer():
    """Delete, insert (fresh tail and reused slots), consolidate and
    relabel keep every core buffer's address; a grow reallocates."""
    idx, rng = _fresh()
    ptrs = tplans.fingerprint(idx.core)
    free_ptr = idx.core.mut.free_ids.data_ptr()
    idx.delete(np.arange(0, 40, 2))
    idx.insert(rng.normal(size=(5, D)).astype(np.float32))
    idx.consolidate()
    idx.insert(rng.normal(size=(8, D)).astype(np.float32), labels=3)
    idx.set_labels([1, 3], 7)
    assert tplans.fingerprint(idx.core) == ptrs
    assert idx.core.mut.free_ids.data_ptr() == free_ptr
    assert not idx.tombstoned(
        _np(idx.searcher(k=5, quantized=True).search(
            rng.normal(size=(4, D)).astype(np.float32)).ids)).any()
    idx.grow()
    grown = tplans.fingerprint(idx.core)
    # the capacity-major buffers move; the quantizer's rotation and
    # centroid (the last two) stay
    assert all(a[0] != b[0] for a, b in zip(ptrs[:-2], grown[:-2]))
    assert ptrs[-2:] == grown[-2:]


def test_keep_buffers_writes_into_the_old_tensors():
    a = torch.zeros(4)
    new = torch.arange(4.0)
    kept = tplans.keep_buffers(a, new)
    assert kept is a and torch.equal(a, new)
    assert tplans.keep_buffers(a, torch.ones(5)).shape == (5,)
    assert tplans.keep_buffers(a, torch.ones(4, dtype=torch.int32)).dtype \
        == torch.int32


def test_eager_plan_traces_like_jit_across_mutations():
    """The JAX package's trace counts for one session across a delete
    (new liveness mode: a new plan), shape-preserving mutations (none)
    and a grow (one), reproduced by the port's plans."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(500, D)).astype(np.float32)
    q = rng.normal(size=(8, D)).astype(np.float32)
    adds = [rng.normal(size=(m, D)).astype(np.float32) for m in (5, 30, 200)]
    stats = []
    for mod, Index, Params, kw in (
            (tss, TIndex, TParams, {"device": "cpu"}),
            (jss, JIndex, JParams, {})):
        idx = Index(D, 640, construction=Params(**PARAMS),
                    quantization="rabitq", bits=4, **kw)
        idx.build(data)
        ses = idx.searcher(mod.SearchSpec(k=5, beam_width=16, quantized=True))
        out = []
        for step in ("first", "delete", "delete2", "insert", "consolidate",
                     "insert2", "grow", "again"):
            if step.startswith("delete"):
                idx.delete(np.arange(10) + (10 if step == "delete2" else 0))
            elif step == "insert":
                idx.insert(adds[0])
            elif step == "insert2":
                idx.insert(adds[1])
            elif step == "consolidate":
                idx.consolidate()
            elif step == "grow":
                idx.insert(adds[2])
            ses.search(q)
            out.append((step, idx.plans.stats.as_dict(), idx.capacity))
        stats.append(out)
    assert stats[0] == stats[1]
    assert stats[0][-1][1]["traces"] == 3 and stats[0][-1][2] == 1280


def test_device_scalars_view_and_plain_pointer_operands(built):
    """The mirrors' view of a core searches as the core does: the plain
    versions read n_valid and the medoid from 0-d tensors as from ints."""
    idx, q = built
    scalars = tplans.DeviceScalars("cpu")
    scalars.sync(idx.core)
    assert int(scalars.n_valid) == idx.core.n_valid
    assert int(scalars.medoid) == idx.core.medoid
    from repro_torch.core.index_core import core_search
    for fusion in ("megakernel", "hop"):
        for quantized in (True, False):
            spec = tss.SearchSpec(k=10, beam_width=24, quantized=quantized,
                                  fusion=fusion, telemetry="on").resolve()
            qt = torch.as_tensor(q)
            a = core_search(idx.core, qt, spec=spec)
            b = core_search(scalars.view(idx.core), qt, spec=spec)
            for x, y in zip(a[:3], b[:3]):
                assert torch.equal(x, y)
            for x, y in zip(a[3], b[3]):
                assert torch.equal(x, y)


def test_plans_are_eager_on_the_cpu(built):
    idx, q = built
    spec = tss.SearchSpec(k=10, beam_width=24, quantized=True,
                          fusion="megakernel").resolve()
    plan = idx._search_plan(spec, (Q, D), idx._filter_tombstones)
    assert isinstance(plan, tplans.EagerPlan)
    assert tplans.capturable(spec)
    for fusion in ("hop", "none"):
        assert not tplans.capturable(tss.SearchSpec(fusion=fusion).resolve())


# --------------------------------------- one sequence through both packages
SEQUENCE = [
    dict(k=10, beam_width=32, quantized=True, fusion="megakernel"),
    dict(k=10, beam_width=32, quantized=True, fusion="hop"),
    dict(k=10, beam_width=32, quantized=True, fusion="none",
         use_kernels=True),
    dict(k=10, beam_width=24, fusion="megakernel"),
    dict(k=5, beam_width=24, quantized=True, fusion="megakernel",
         filter=(1, 2), filter_mode="exclude"),
]


def test_searcher_sequence_matches_jax(tmp_path):
    """A JAX-built index crosses into the port by its checkpoint; the same
    sequence of sessions, shapes, a delete and a grow through both
    packages' Searchers: ids (>= 0.95 agreement) and hops, dists within
    tolerance, and equal CacheStats after every search."""
    rng = np.random.default_rng(12)
    data = rng.normal(size=(400, 16)).astype(np.float32)
    queries = rng.normal(size=(12, 16)).astype(np.float32)
    jidx = JIndex(16, 448, construction=JParams(**PARAMS),
                  quantization="rabitq", bits=4, seed=3)
    jidx.build(data, labels=rng.integers(0, 4, 400))
    path = os.path.join(tmp_path, "idx.npz")
    jidx.save(path)
    tidx = TIndex.load(path, device="cpu")
    grow_rows = rng.normal(size=(60, 16)).astype(np.float32)

    def step(label, shapes=(12, 5)):
        for kw in SEQUENCE:
            jses = jidx.searcher(jss.SearchSpec(**kw))
            tses = tidx.searcher(tss.SearchSpec(**kw))
            for n in shapes:
                jr, tr = jses.search(queries[:n]), tses.search(queries[:n])
                ji, ti = np.asarray(jr.ids), _np(tr.ids)
                assert float(np.mean(ji == ti)) >= ID_AGREEMENT, (label, kw)
                assert np.array_equal(np.asarray(jr.n_hops), _np(tr.n_hops))
                np.testing.assert_allclose(_np(tr.dists), np.asarray(jr.dists),
                                           rtol=DIST_RTOL, atol=DIST_ATOL)
                assert tr.generation == jr.generation
                assert tidx.plans.stats.as_dict() == \
                    jidx.plans.stats.as_dict(), (label, kw, n)

    step("fresh")
    step("again")
    dead = np.arange(3, 60, 7)
    jidx.delete(dead)
    tidx.delete(dead)
    step("after delete", shapes=(12,))
    jidx.insert(grow_rows)
    tidx.insert(grow_rows)
    assert tidx.capacity == jidx.capacity == 896
    step("after grow", shapes=(12,))
