"""The deprecated PQ baseline (`repro_torch.core.pq`, `JasperIndex(
quantization="pq")`, `search_pq`) against the JAX package's.

The pieces, on the same operands: one Lloyd step from the JAX package's
own initial centroid rows (its `jax.random.choice` draws) on
well-separated clusters, codebooks rtol 1e-5; `pq_encode` codes equal on
integer-valued rows and codebooks (every distance exact); the lookup
table rtol 1e-6; `pq_distance` and the beam-search scorer rtol 1e-5. The
index: a JAX PQ checkpoint loads into the port and `search_pq` agrees at
the conformance bars (ids >= 0.95, dists rtol 1e-3 / atol 1e-2), a port
PQ checkpoint loads into JAX, and the opt-in and warning behaviour of
tests/test_core_anns.py's `test_pq_requires_explicit_opt_in`.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as jpq
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro_torch.core import pq as tpq
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.index import JasperIndex as TIndex

SEED = 12
ID_AGREEMENT = 0.95
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2
SMALL = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
             rev_cap=16, prune_chunk=256)


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


def _clusters(rng, init, n=320, dsub=4, spread=0.05):
    """Well-separated clusters, one a centroid: centres 10 apart on a grid,
    tight noise; row init[i] lies in cluster i, so every cluster starts
    with exactly one centroid and no assignment is near a tie."""
    n_c = init.size
    centres = 10.0 * rng.choice(np.arange(-20, 21), (n_c, dsub))
    label = rng.integers(0, n_c, n)
    label[init] = np.arange(n_c)
    x = centres[label] + spread * rng.normal(size=(n, dsub))
    return x.astype(np.float32)


def _codebooks(rng, k=4, c=256, dsub=4):
    return rng.integers(-4, 5, (k, c, dsub)).astype(np.float32)


@pytest.mark.parametrize("iters", [1, 3])
def test_lloyd_steps_match_jax(iters):
    """The port's Lloyd iterations from JAX's initial rows."""
    rng = np.random.default_rng(SEED)
    key = jax.random.PRNGKey(SEED)
    n, n_c = 320, 8
    # the rows the JAX package's Lloyd's starts from (its own draw)
    init = np.array(jax.random.choice(key, n, (n_c,), replace=False))
    x = _clusters(rng, init, n)
    j = jpq._kmeans_one(key, jnp.asarray(x), n_c, iters)
    t = tpq.kmeans_lloyd(torch.as_tensor(x), torch.as_tensor(init), iters)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_train_shapes_and_seed():
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.normal(size=(600, 32)).astype(np.float32))
    a = tpq.pq_train(torch.Generator().manual_seed(3), x, n_subspaces=8,
                     iters=2)
    b = tpq.pq_train(torch.Generator().manual_seed(3), x, n_subspaces=8,
                     iters=2)
    assert a.codebooks.shape == (8, 256, 4)
    assert (a.n_subspaces, a.subdim) == (8, 4)
    assert torch.equal(a.codebooks, b.codebooks)
    idx = tpq.initial_indices(torch.Generator().manual_seed(0), 600, 256)
    assert idx.unique().numel() == 256          # distinct rows when n >= C
    assert tpq.initial_indices(torch.Generator().manual_seed(0), 10,
                               256).shape == (256,)
    with pytest.raises(ValueError, match="not divisible"):
        tpq.pq_train(torch.Generator(), x, n_subspaces=7)


def test_encode_matches_jax():
    rng = np.random.default_rng(SEED + 1)
    books = _codebooks(rng)
    x = rng.integers(-5, 6, (300, 16)).astype(np.float32)
    j = jpq.pq_encode(jpq.PQParams(jnp.asarray(books)), jnp.asarray(x))
    t = tpq.pq_encode(tpq.PQParams(torch.as_tensor(books)),
                      torch.as_tensor(x))
    assert t.dtype == torch.uint8 and t.shape == (300, 4)
    assert np.array_equal(_np(t), np.asarray(j))


def test_lookup_table_matches_jax():
    rng = np.random.default_rng(SEED + 2)
    books = rng.normal(size=(4, 256, 4)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    j = jpq.pq_lookup_table(jpq.PQParams(jnp.asarray(books)), jnp.asarray(q))
    t = tpq.pq_lookup_table(tpq.PQParams(torch.as_tensor(books)),
                            torch.as_tensor(q))
    assert t.shape == (9, 4, 256)
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("mode", ["all", "candidates", "scorer"])
def test_distance_and_scorer_match_jax(mode):
    rng = np.random.default_rng(SEED + 3)
    books = rng.normal(size=(4, 256, 4)).astype(np.float32)
    codes = rng.integers(0, 256, (200, 4)).astype(np.uint8)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    cand = rng.integers(-1, 200, (7, 12)).astype(np.int32)
    jp, tp = jpq.PQParams(jnp.asarray(books)), tpq.PQParams(
        torch.as_tensor(books))
    jc, tc = jnp.asarray(codes), torch.as_tensor(codes)
    if mode == "all":
        j = jpq.pq_distance(jp, jc, jnp.asarray(q))
        t = tpq.pq_distance(tp, tc, torch.as_tensor(q))
    elif mode == "candidates":
        j = jpq.pq_distance(jp, jc, jnp.asarray(q), jnp.asarray(cand))
        t = tpq.pq_distance(tp, tc, torch.as_tensor(q), torch.as_tensor(cand))
    else:
        j = jpq.make_pq_scorer(jp, jc, jnp.asarray(q))(jnp.asarray(cand))
        t = tpq.make_pq_scorer(tp, tc, torch.as_tensor(q))(
            torch.as_tensor(cand))
    assert t.shape == np.asarray(j).shape
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5)


# ------------------------------------------------------------ the index
@pytest.fixture(scope="module")
def pq_pair(tmp_path_factory):
    """A JAX PQ index (with tombstones) and its checkpoint in the port."""
    rng = np.random.default_rng(SEED + 4)
    data = rng.normal(size=(400, 32)).astype(np.float32)
    queries = rng.normal(size=(20, 32)).astype(np.float32)
    with pytest.warns(DeprecationWarning):
        jidx = JIndex(32, 500, quantization="pq", construction=JParams(**SMALL),
                      seed=SEED)
    jidx.build(data)
    jidx.delete(np.arange(0, 400, 13))
    path = str(tmp_path_factory.mktemp("pq") / "jax_pq.npz")
    jidx.save(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)   # load is quiet
        tidx = TIndex.load(path, device="cpu")
    return jidx, tidx, queries


def _search(idx, q, **kw):
    with pytest.warns(DeprecationWarning, match="search_pq is deprecated"):
        ids, dists = idx.search_pq(q, 10, beam_width=48, **kw)
    return _np(ids), _np(dists)


@pytest.mark.parametrize("rerank", [True, False])
def test_search_pq_on_a_jax_checkpoint(pq_pair, rerank):
    jidx, tidx, q = pq_pair
    assert tidx.quantization == "pq"
    assert np.array_equal(_np(tidx.pq_codes), np.asarray(jidx.pq_codes))
    assert np.array_equal(_np(tidx.pq_params.codebooks),
                          np.asarray(jidx.pq_params.codebooks))
    j_ids, j_d = _search(jidx, q, rerank=rerank)
    t_ids, t_d = _search(tidx, q, rerank=rerank)
    assert t_ids.shape == j_ids.shape == (20, 10)
    assert float(np.mean(t_ids == j_ids)) >= ID_AGREEMENT
    np.testing.assert_allclose(t_d, j_d, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert not tidx.tombstoned(t_ids[t_ids >= 0]).any()


def test_search_pq_merge_kernel_lane(pq_pair):
    """merge="kernel" (the `topk` kernel's plain version on the CPU)
    equals the default merge."""
    _, tidx, q = pq_pair
    a = _search(tidx, q)
    b = _search(tidx, q, merge="kernel")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_port_pq_checkpoint_loads_into_jax(tmp_path):
    rng = np.random.default_rng(SEED + 5)
    data = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(12, 16)).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="NEGATIVE result"):
        tidx = TIndex(16, 400, quantization="pq",
                      construction=TParams(**SMALL), seed=SEED, device="cpu")
    tidx.build(data)
    tidx.insert(rng.normal(size=(50, 16)).astype(np.float32))
    path = str(tmp_path / "port_pq.npz")
    tidx.save(path)
    jidx = JIndex.load(path)
    assert np.array_equal(np.asarray(jidx.pq_codes), _np(tidx.pq_codes))
    t_ids, t_d = _search(tidx, q)
    j_ids, j_d = _search(jidx, q)
    assert float(np.mean(t_ids == j_ids)) >= ID_AGREEMENT
    np.testing.assert_allclose(t_d, j_d, rtol=DIST_RTOL, atol=DIST_ATOL)


def test_pq_requires_explicit_opt_in():
    """The LUT-based PQ path is gated and deprecated; recall, grow and the
    refusals of tests/test_core_anns.py's opt-in case."""
    rng = np.random.default_rng(12)
    data = rng.normal(size=(400, 32)).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="NEGATIVE result"):
        idx = TIndex(32, 500, quantization="pq",
                     construction=TParams(**SMALL), device="cpu")
    idx.build(data)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    ids, _ = _search(idx, q)
    gt, _ = idx.brute_force(q, 10)
    gt = _np(gt)
    rec = np.mean([len(set(ids[i]) & set(gt[i])) / 10 for i in range(20)])
    assert rec > 0.7, rec
    idx.grow()
    assert idx.pq_codes.shape == (1000, 16)
    assert not idx.pq_codes[500:].any()
    plain = TIndex(32, 100, construction=TParams(**SMALL), device="cpu")
    with pytest.raises(RuntimeError, match="quantization='pq'"):
        plain.search_pq(q, 5)
    with pytest.raises(ValueError, match="quantization"):
        TIndex(32, 100, quantization="opq", device="cpu")
    with pytest.raises(ValueError, match="rabitq"):
        idx.evict_rows_to_host()
