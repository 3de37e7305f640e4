"""Port parity of the scan and load-strategy kernels: `pairwise_l2`,
`gather_l2_tiled` (and `make_kernel_scorer(strategy="tiled")`),
`rabitq_distance` and `rabitq_gather_distance`.

Each wrapper, called with CPU tensors, runs its plain PyTorch version —
held here against the JAX wrapper it replaces (Pallas in interpret mode,
as the JAX package's own tests run it) and against the JAX oracles, at the
shapes and tolerances of `tests/test_kernels.py`:

  * `pairwise_l2`: rtol 1e-4 / atol 1e-3 on float32, rtol 5e-2 / atol 5 on
    bfloat16 inputs, bit-equal on integer-valued inputs;
  * `gather_l2_tiled`: the same +inf mask, values rtol 1e-4 / atol 1e-3;
    the tiled scorer bit-equal to JAX's on integer vectors under every
    mask, and a whole exact beam search through it bit-equal (ids, dists,
    hops) on integer vectors;
  * `rabitq_distance`: rtol 1e-3 / atol 1e-2 against JAX's kernel, on
    codes and queries the JAX package made; its plain version against the
    port's `rabitq_estimate` at rtol 1e-4 / atol 1e-3;
  * `rabitq_gather_distance`: rtol 1e-3 / atol 1e-2 against JAX's kernel.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mutations as jm
from repro.core import rabitq as jr
from repro.core.vamana import VamanaGraph as JGraph
from repro.kernels.distance import ops as jdops
from repro.kernels.distance.ref import gather_l2_ref, pairwise_l2_ref
from repro.kernels.rabitq_dot import ops as jrops
from repro_torch.core import beam_search as tbs
from repro_torch.core import rabitq as tr
from repro_torch.core.vamana import VamanaGraph as TGraph
from repro_torch.kernels.distance import ops as tdops
from repro_torch.kernels.rabitq_dot import ops as trops

# `repro.core` re-exports a function named beam_search: import the module
jbs = importlib.import_module("repro.core.beam_search")


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


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------ pairwise_l2
@pytest.mark.parametrize("q,c,d", [
    (8, 128, 128),          # exact tile multiples
    (37, 211, 96),          # ragged everything
    (1, 1, 1),              # degenerate
    (130, 4, 960),          # Gist-dim, tiny C
    (16, 300, 1536),        # OpenAI-dim
])
def test_pairwise_l2_matches_jax(q, c, d):
    rng = np.random.default_rng(q * 1000 + c)
    qv = rng.normal(size=(q, d)).astype(np.float32)
    xv = rng.normal(size=(c, d)).astype(np.float32)
    got = _np(tdops.pairwise_l2(_t(qv), _t(xv)))
    assert got.shape == (q, c) and got.dtype == np.float32
    for want in (jdops.pairwise_l2(jnp.asarray(qv), jnp.asarray(xv)),
                 pairwise_l2_ref(jnp.asarray(qv), jnp.asarray(xv))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-3)


def test_pairwise_l2_bf16_inputs():
    """bfloat16 in, float32 out, as the JAX wrapper casts."""
    rng = np.random.default_rng(5)
    qj = jnp.asarray(rng.normal(size=(16, 128)), jnp.bfloat16)
    xj = jnp.asarray(rng.normal(size=(64, 128)), jnp.bfloat16)
    qt = _t(np.asarray(qj.astype(jnp.float32))).to(torch.bfloat16)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = tdops.pairwise_l2(qt, xt)
    assert got.dtype == torch.float32
    for want in (jdops.pairwise_l2(qj, xj), pairwise_l2_ref(qj, xj)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=5e-2,
                                   atol=5)


def test_pairwise_l2_bit_equal_on_integers():
    """Integer-valued operands: every float sum is exact, so the port and
    both JAX functions agree bit for bit."""
    rng = np.random.default_rng(6)
    qv = rng.integers(-9, 10, (37, 96)).astype(np.float32)
    xv = rng.integers(-9, 10, (211, 96)).astype(np.float32)
    got = _np(tdops.pairwise_l2(_t(qv), _t(xv)))
    for want in (jdops.pairwise_l2(jnp.asarray(qv), jnp.asarray(xv)),
                 pairwise_l2_ref(jnp.asarray(qv), jnp.asarray(xv))):
        assert np.array_equal(got, np.asarray(want))


# --------------------------------------------------------- gather_l2_tiled
@pytest.mark.parametrize("q,k,d,n", [
    (8, 16, 128, 200),
    (33, 7, 96, 100),
    (4, 64, 960, 64),
])
def test_gather_l2_tiled_matches_jax(q, k, d, n):
    rng = np.random.default_rng(q + k + d + n)
    qv = rng.normal(size=(q, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    db_sq = (db * db).sum(-1)
    ids = rng.integers(-1, n, (q, k)).astype(np.int32)
    got = _np(tdops.gather_l2_tiled(_t(qv), _t(db), _t(db_sq), _t(ids)))
    want = np.asarray(jdops.gather_l2_tiled(
        jnp.asarray(qv), jnp.asarray(db), jnp.asarray(db_sq),
        jnp.asarray(ids)))
    ref = np.asarray(gather_l2_ref(jnp.asarray(qv), jnp.asarray(db),
                                   jnp.asarray(ids)))
    for w in (want, ref):
        assert np.array_equal(np.isinf(got), ids < 0)
        assert np.array_equal(np.isinf(w), ids < 0)
        fin = ids >= 0
        np.testing.assert_allclose(got[fin], w[fin], rtol=1e-4, atol=1e-3)


class IntCase:
    """Integer-valued rows, queries, graph and masks, the same numbers in
    both packages. Adjacency rows are full, distinct and self-loop free."""

    def __init__(self, seed, n=96, d=16, r=8, q=4):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.adj = np.stack([rng.permutation(np.delete(np.arange(n), i))[:r]
                             for i in range(n)]).astype(np.int32)
        self.n_valid = n - 5          # the tail ids are out of range
        self.medoid = int(rng.integers(0, self.n_valid))
        self.vectors = rng.integers(-5, 6, (n, d)).astype(np.float32)
        self.sqnorm = (self.vectors ** 2).sum(-1).astype(np.float32)
        self.queries = rng.integers(-5, 6, (q, d)).astype(np.float32)
        self.tomb = np.asarray(jm.pack_bitmap(
            jnp.asarray(rng.random(n) < 0.15)))
        self.labels = (rng.integers(0, 16, (n, 4)) *
                       np.array([1, 0, 0, 0])).astype(np.uint8)
        self.fb = np.array([0x05, 0, 0, 0], np.uint8)


@pytest.mark.parametrize("masks", ["none", "tomb", "labels", "both"])
def test_tiled_kernel_scorer_matches_jax(masks):
    c = IntCase(7, q=6)
    kw_j, kw_t = {}, {}
    if masks in ("tomb", "both"):
        kw_j["tombstone_bits"] = jnp.asarray(c.tomb)
        kw_t["tombstone_bits"] = _t(c.tomb)
    if masks in ("labels", "both"):
        kw_j.update(labels=jnp.asarray(c.labels),
                    filter_bytes=jnp.asarray(c.fb))
        kw_t.update(labels=_t(c.labels), filter_bytes=_t(c.fb))
    ids = c.rng.integers(-1, c.adj.shape[0], (6, 8)).astype(np.int32)
    want = jdops.make_kernel_scorer(
        jnp.asarray(c.vectors), jnp.asarray(c.queries), jnp.int32(c.n_valid),
        jnp.asarray(c.sqnorm), strategy="tiled", **kw_j)(jnp.asarray(ids))
    scorer = tdops.make_kernel_scorer(
        _t(c.vectors), _t(c.queries), c.n_valid, _t(c.sqnorm),
        strategy="tiled", **kw_t)
    assert scorer.self_masking
    got = scorer(_t(ids))
    assert np.array_equal(_np(got), np.asarray(want))
    # the two strategies are one function
    chunked = tdops.make_kernel_scorer(
        _t(c.vectors), _t(c.queries), c.n_valid, _t(c.sqnorm), **kw_t)
    assert torch.equal(chunked(_t(ids)), got)


def test_kernel_scorer_rejects_unknown_strategy():
    c = IntCase(8)
    with pytest.raises(ValueError, match="strategy"):
        tdops.make_kernel_scorer(_t(c.vectors), _t(c.queries), c.n_valid,
                                 strategy="bulk")


def test_tiled_beam_search_matches_jax():
    """A whole exact beam search through the tiled scorer, bit-equal to
    JAX's (ids, dists, hops) on integer vectors."""
    c = IntCase(9)
    q = c.queries.shape[0]
    jres = jbs.beam_search(
        JGraph(jnp.asarray(c.adj), jnp.int32(c.n_valid), jnp.int32(c.medoid)),
        jdops.make_kernel_scorer(jnp.asarray(c.vectors),
                                 jnp.asarray(c.queries), jnp.int32(c.n_valid),
                                 jnp.asarray(c.sqnorm), strategy="tiled"),
        q, beam_width=8, max_iters=12)
    tres = tbs.beam_search(
        TGraph(adjacency=_t(c.adj), n_valid=c.n_valid, medoid=c.medoid),
        tdops.make_kernel_scorer(_t(c.vectors), _t(c.queries), c.n_valid,
                                 _t(c.sqnorm), strategy="tiled"),
        q, beam_width=8, max_iters=12)
    for g, w in ((tres.frontier_ids, jres.frontier_ids),
                 (tres.frontier_dists, jres.frontier_dists),
                 (tres.n_hops, jres.n_hops)):
        assert np.array_equal(_np(g), np.asarray(w))
    assert int(_np(tres.n_hops).min()) > 2          # the walks did work


# ------------------------------------------------------------------ rabitq
def _jax_quantized(bits, n, d, q, seed):
    """Codes and rotated queries made by the JAX package, and the same
    arrays carried into the port."""
    rng = np.random.default_rng(seed)
    db = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    qv = jnp.asarray(rng.normal(size=(q, d)).astype(np.float32))
    params = jr.rabitq_train(jax.random.PRNGKey(seed), db, bits=bits)
    codes = jr.rabitq_encode(params, db)
    qq = jr.rabitq_preprocess_query(params, qv)
    tcodes = tr.RaBitQCodes(packed=_t(codes.packed), data_add=_t(codes.data_add),
                            data_rescale=_t(codes.data_rescale), bits=bits,
                            dims=d)
    tq = tr.RaBitQQuery(q_rot=_t(qq.q_rot), query_add=_t(qq.query_add),
                        query_sumq=_t(qq.query_sumq))
    return codes, qq, tcodes, tq, rng


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("q,n,d", [(8, 64, 128), (19, 100, 96), (4, 32, 960)])
def test_rabitq_distance_matches_jax(bits, q, n, d):
    codes, qq, tcodes, tq, _ = _jax_quantized(bits, n, d, q, seed=bits + d)
    want = jrops.rabitq_distance(codes.packed, codes.data_add,
                                 codes.data_rescale, qq.q_rot, qq.query_add,
                                 qq.query_sumq, bits=bits)
    got = trops.rabitq_distance(tcodes.packed, tcodes.data_add,
                                tcodes.data_rescale, tq.q_rot, tq.query_add,
                                tq.query_sumq, bits=bits)
    assert tuple(got.shape) == (q, n)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-3,
                               atol=1e-2)
    # the plain version is the port's own estimator, all-pairs form
    np.testing.assert_allclose(_np(got), _np(tr.rabitq_estimate(tcodes, tq)),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_rabitq_gather_distance_matches_jax(bits):
    n, d, q, k = 90, 128, 12, 9
    codes, qq, tcodes, tq, rng = _jax_quantized(bits, n, d, q, seed=bits)
    ids = rng.integers(0, n, (q, k)).astype(np.int32)
    want = jrops.rabitq_gather_distance(
        codes.packed[ids], codes.data_add[ids], codes.data_rescale[ids],
        qq.q_rot, qq.query_add, qq.query_sumq, bits=bits)
    tid = _t(ids).long()
    got = trops.rabitq_gather_distance(
        tcodes.packed[tid], tcodes.data_add[tid], tcodes.data_rescale[tid],
        tq.q_rot, tq.query_add, tq.query_sumq, bits=bits)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-3,
                               atol=1e-2)
    # the candidate form of the all-pairs estimate
    full = _np(trops.rabitq_distance(tcodes.packed, tcodes.data_add,
                                     tcodes.data_rescale, tq.q_rot,
                                     tq.query_add, tq.query_sumq, bits=bits))
    np.testing.assert_allclose(_np(got), np.take_along_axis(full, ids, 1),
                               rtol=1e-4, atol=1e-3)
