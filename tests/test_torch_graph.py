"""Port parity: Vamana graph, medoid, RobustPrune, construction.

Inputs are made from a seed with numpy and fed to both packages. With
small-integer vectors every distance is an exact float sum, so the pieces
are held BIT-EXACT to the JAX reference (ids, distances, adjacency) —
ties included, which exercises the stable tie order everywhere. The whole
build on float data is held at the recall level: a port-built index has
recall within `BUILD_RECALL_SLACK` of a JAX-built one and passes
`validate_graph`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import construction as jc
from repro.core import medoid as jmed
from repro.core import robust_prune as jp
from repro.core import vamana as jv
from repro_torch.core import construction as tc
from repro_torch.core import medoid as tmed
from repro_torch.core import robust_prune as tp
from repro_torch.core import vamana as tv

SEED = 21
BUILD_RECALL_SLACK = 0.02
SMALL = dict(degree_bound=8, alpha=1.2, beam_width=12, max_iters=16,
             rev_cap=8, prune_chunk=64)


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


def _int_vectors(n, d, seed=SEED):
    rng = np.random.default_rng(seed)
    return rng.integers(-6, 7, (n, d)).astype(np.float32), rng


def test_medoid_matches():
    x, rng = _int_vectors(300, 8)
    mask = rng.random(300) < 0.5
    assert tmed.compute_medoid(torch.as_tensor(x)) == int(
        jmed.compute_medoid(jnp.asarray(x)))
    assert tmed.compute_medoid(torch.as_tensor(x), torch.as_tensor(mask)) \
        == int(jmed.compute_medoid(jnp.asarray(x), jnp.asarray(mask)))


def test_dedup_sort_candidates_bit_exact():
    rng = np.random.default_rng(SEED)
    v, c, n_valid = 20, 24, 40
    cand = rng.integers(-1, 48, (v, c)).astype(np.int32)
    dists = rng.integers(0, 5, (v, c)).astype(np.float32)   # many ties
    piv = rng.integers(0, n_valid, (v,)).astype(np.int32)
    live = rng.random(48) < 0.8
    for lv in (None, live):
        wi, wd = jp.dedup_sort_candidates(
            jnp.asarray(cand), jnp.asarray(dists), jnp.asarray(piv),
            jnp.int32(n_valid), None if lv is None else jnp.asarray(lv))
        gi, gd = tp.dedup_sort_candidates(
            torch.as_tensor(cand), torch.as_tensor(dists),
            torch.as_tensor(piv), n_valid,
            None if lv is None else torch.as_tensor(lv))
        assert np.array_equal(_np(gi), np.asarray(wi))
        assert np.array_equal(_np(gd), np.asarray(wd))


@pytest.mark.parametrize("with_live", [False, True])
def test_robust_prune_bit_exact(with_live):
    x, rng = _int_vectors(200, 8)
    v, c = 37, 30
    piv = rng.integers(0, 200, (v,)).astype(np.int32)
    piv[-3:] = -1                                         # padding rows
    cand = rng.integers(-1, 200, (v, c)).astype(np.int32)
    d = ((x[np.maximum(cand, 0)] - x[np.maximum(piv, 0)][:, None]) ** 2
         ).sum(-1).astype(np.float32)
    live = rng.random(200) < 0.85 if with_live else None
    kw = dict(degree_bound=8, alpha=1.2, chunk_size=16)
    want = jp.robust_prune_batch(
        jnp.asarray(x), jnp.asarray(piv), jnp.asarray(cand), jnp.asarray(d),
        jnp.int32(190), live=None if live is None else jnp.asarray(live),
        **kw)
    got = tp.robust_prune_batch(
        torch.as_tensor(x), torch.as_tensor(piv), torch.as_tensor(cand),
        torch.as_tensor(d), 190,
        live=None if live is None else torch.as_tensor(live), **kw)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_group_reverse_edges_bit_exact():
    rng = np.random.default_rng(SEED)
    e = 300
    dst = rng.integers(-1, 40, (e,)).astype(np.int32)
    src = rng.integers(0, 100, (e,)).astype(np.int32)
    dist = rng.integers(0, 6, (e,)).astype(np.float32)     # many ties
    want = jc._group_reverse_edges(jnp.asarray(dst), jnp.asarray(src),
                                   jnp.asarray(dist), 5)
    got = tc._group_reverse_edges(torch.as_tensor(dst), torch.as_tensor(src),
                                  torch.as_tensor(dist), 5)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_adjacency_distances_match():
    x, rng = _int_vectors(100, 8)
    piv = rng.integers(-1, 100, (23,)).astype(np.int32)
    rows = rng.integers(-1, 100, (23, 6)).astype(np.int32)
    want = jc._adjacency_distances(jnp.asarray(x), jnp.asarray(piv),
                                   jnp.asarray(rows), 8)
    got = tc._adjacency_distances(torch.as_tensor(x), torch.as_tensor(piv),
                                  torch.as_tensor(rows), 8)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.fixture(scope="module")
def int_build():
    """Bootstrap + two insertion batches on integer vectors, both packages."""
    x, _ = _int_vectors(160, 8, seed=SEED + 1)
    jparams = jc.ConstructionParams(**SMALL)
    tparams = tc.ConstructionParams(**SMALL)
    jg = jc.bootstrap_graph(jnp.asarray(x), jv.init_graph(160, 8), n0=64,
                            params=jparams)
    tg = tc.bootstrap_graph(torch.as_tensor(x),
                            tv.init_graph(160, 8, "cpu"), n0=64,
                            params=tparams)
    stages = [(jg, tg)]
    for start, size in ((64, 32), (96, 64)):
        jg = jc.batch_insert(jnp.asarray(x), jg, jnp.int32(start),
                             batch_size=size, params=jparams)
        tg = tc.batch_insert(torch.as_tensor(x),
                             tg._replace(adjacency=tg.adjacency.clone()),
                             start, batch_size=size, params=tparams)
        stages.append((jg, tg))
    return stages


@pytest.mark.parametrize("stage", [0, 1, 2],
                         ids=["bootstrap", "batch1", "batch2"])
def test_construction_bit_exact_on_integer_vectors(int_build, stage):
    jg, tg = int_build[stage]
    assert np.array_equal(_np(tg.adjacency), np.asarray(jg.adjacency))
    assert tg.n_valid == int(jg.n_valid)
    assert tg.medoid == int(jg.medoid)


def test_graph_helpers_match(int_build):
    jg, tg = int_build[-1]
    want = jv.graph_degree_stats(jg)
    got = tv.graph_degree_stats(tg)
    for key in want:
        assert float(_np(torch.as_tensor(got[key]))) == float(want[key]), key
    live = np.random.default_rng(0).random(160) < 0.9
    wv = jv.validate_graph(jg, jnp.asarray(live))
    gv = tv.validate_graph(tg, torch.as_tensor(live))
    assert {k: bool(v) for k, v in gv.items()} == \
        {k: bool(v) for k, v in wv.items()}
    assert all(bool(v) for v in tv.validate_graph(tg).values())


def test_build_recall_matches_reference():
    """Float data: a port-built graph searches as well as a JAX-built one
    (exact beam search, each package over its own graph)."""
    from repro.core.index import JasperIndex as JIndex
    from repro_torch.core.index import JasperIndex as TIndex
    rng = np.random.default_rng(SEED)
    n, d, q = 2048, 32, 64
    data = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    params = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
                  rev_cap=16, prune_chunk=256)
    j = JIndex(d, n, construction=jc.ConstructionParams(**params))
    j.build(data)
    t = TIndex(d, n, construction=tc.ConstructionParams(**params),
               device="cpu")
    t.build(data)
    checks = tv.validate_graph(t.graph)
    assert all(bool(v) for v in checks.values()), checks
    stats = tv.graph_degree_stats(t.graph)
    assert float(stats["mean_degree"]) > 0.5 * 16
    r_j = j.recall(queries, 10, beam_width=48)
    r_t = t.recall(queries, 10, beam_width=48)
    assert r_t >= r_j - BUILD_RECALL_SLACK, (r_t, r_j)
    assert r_t >= 0.75
