"""Port parity of the three kernel modules of the search slice.

Each wrapper, called with CPU tensors, runs its plain PyTorch version —
held here against the JAX wrapper it replaces (JAX's Pallas kernels run in
interpret mode off a TPU, as the JAX package's own tests run them):

  * `gather_l2` vs `gather_l2_chunked`, `make_kernel_scorer` vs its JAX
    twin: rtol 1e-5, atol 1e-4 on float data;
  * `rabitq_search_step` / `make_rabitq_kernel_scorer` vs the JAX scorer
    (tombstone + label masks included): rtol 1e-5, atol 1e-4, identical
    +inf masks;
  * the plain fused search vs `fused_search_ref`: BIT-EXACT (ids, dists,
    hops, telemetry) on integer-valued inputs, over quantized 4/1-bit and
    exact scoring, tombstone and label exclude, telemetry, a beam
    schedule, and L > R + 1;
  * `fused_beam_search(mode="megakernel")` vs the JAX megakernel:
    bit-exact on integer-valued inputs at L = R (where the JAX kernel's
    merge agrees with its oracle, see ROADMAP queue C).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mutations as jm
from repro.core import rabitq as jr
from repro.core.vamana import VamanaGraph as JGraph
from repro.kernels.search_step import ref as jref
from repro_torch.core import beam_search as tbs
from repro_torch.core import rabitq as tr
from repro_torch.core.vamana import VamanaGraph as TGraph
from repro_torch.kernels.search_step import ops as tops
from repro_torch.kernels.search_step import ref as tref

# `repro.core` re-exports a function named beam_search: import the module
jbs = importlib.import_module("repro.core.beam_search")

RTOL, ATOL = 1e-5, 1e-4
N, D, R, Q = 256, 32, 16, 12


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


class Case:
    """Integer-valued index operands, the same numbers in both packages.

    Adjacency rows are full, distinct and self-loop free, so from the
    first hop on the frontier holds >= L finite entries whenever L <= R+1.
    """

    def __init__(self, seed, bits=4):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.bits = bits
        adj = np.stack([rng.permutation(np.delete(np.arange(N), i))[:R]
                        for i in range(N)]).astype(np.int32)
        self.adj = adj
        self.n_valid = N - 6          # the tail ids are out of range
        self.medoid = int(rng.integers(0, self.n_valid))
        self.vectors = rng.integers(-5, 6, (N, D)).astype(np.float32)
        self.sqnorm = (self.vectors ** 2).sum(-1).astype(np.float32)
        self.queries = rng.integers(-5, 6, (Q, D)).astype(np.float32)
        p = jr.packed_dim(D, bits)
        self.packed = rng.integers(0, 256, (N, p)).astype(np.uint8)
        self.add = rng.integers(0, 4000, (N,)).astype(np.float32)
        self.rescale = rng.choice([-2.0, -1.0, 1.0, 2.0], N).astype(np.float32)
        self.q_rot = rng.integers(-3, 4, (Q, D)).astype(np.float32)
        self.q_add = rng.integers(0, 500, (Q,)).astype(np.float32)
        self.q_sum = rng.integers(-50, 50, (Q,)).astype(np.float32)
        self.tomb = np.asarray(jm.pack_bitmap(jnp.asarray(rng.random(N) < 0.15)))
        self.labels = (rng.integers(0, 16, (N, 4)) *
                       np.array([1, 0, 0, 0])).astype(np.uint8)
        self.fb = np.array([0x05, 0, 0, 0], np.uint8)

    def jax_codes(self):
        return (jr.RaBitQCodes(jnp.asarray(self.packed), jnp.asarray(self.add),
                               jnp.asarray(self.rescale), self.bits, D),
                jr.RaBitQQuery(jnp.asarray(self.q_rot),
                               jnp.asarray(self.q_add),
                               jnp.asarray(self.q_sum)))

    def torch_codes(self):
        return (tr.RaBitQCodes(_t(self.packed), _t(self.add),
                               _t(self.rescale), self.bits, D),
                tr.RaBitQQuery(_t(self.q_rot), _t(self.q_add),
                               _t(self.q_sum)))


# ------------------------------------------------------------ gather_l2
def test_gather_l2_matches_jax():
    from repro.kernels.distance.ops import gather_l2_chunked
    from repro_torch.kernels.distance.ops import gather_l2
    rng = np.random.default_rng(1)
    table = rng.normal(size=(N, D)).astype(np.float32)
    sq = (table ** 2).sum(-1)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    ids = rng.integers(-1, N, (Q, 20)).astype(np.int32)
    want = gather_l2_chunked(jnp.asarray(q), jnp.asarray(table),
                             jnp.asarray(sq), jnp.asarray(ids))
    got = gather_l2(_t(q), _t(table), _t(sq), _t(ids))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert np.array_equal(np.isinf(_np(got)), ids < 0)


@pytest.mark.parametrize("masks", ["none", "tomb", "labels", "both"])
def test_exact_kernel_scorer_matches_jax(masks):
    from repro.kernels.distance.ops import make_kernel_scorer as jmk
    from repro_torch.kernels.distance.ops import make_kernel_scorer as tmk
    c = Case(2)
    kw_j, kw_t = {}, {}
    if masks in ("tomb", "both"):
        kw_j["tombstone_bits"] = jnp.asarray(c.tomb)
        kw_t["tombstone_bits"] = _t(c.tomb)
    if masks in ("labels", "both"):
        kw_j.update(labels=jnp.asarray(c.labels), filter_bytes=jnp.asarray(c.fb))
        kw_t.update(labels=_t(c.labels), filter_bytes=_t(c.fb))
    ids = c.rng.integers(-1, N, (Q, R)).astype(np.int32)
    want = jmk(jnp.asarray(c.vectors), jnp.asarray(c.queries),
               jnp.int32(c.n_valid), jnp.asarray(c.sqnorm), **kw_j)(
        jnp.asarray(ids))
    got = tmk(_t(c.vectors), _t(c.queries), c.n_valid, _t(c.sqnorm),
              **kw_t)(_t(ids))
    assert np.array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------- rabitq_search_step
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("masks", ["none", "tomb", "labels", "both"])
def test_rabitq_kernel_scorer_matches_jax(bits, masks):
    from repro.kernels.rabitq_dot.ops import make_rabitq_kernel_scorer as jmk
    from repro_torch.kernels.rabitq_dot.ops import (
        make_rabitq_kernel_scorer as tmk)
    c = Case(3, bits=bits)
    rng = np.random.default_rng(bits)
    # realistic float query operands: tolerance, not bit-equality
    c.q_rot = rng.normal(size=(Q, D)).astype(np.float32)
    c.rescale = rng.normal(size=(N,)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if masks in ("tomb", "both"):
        kw_j["tombstone_bits"] = jnp.asarray(c.tomb)
        kw_t["tombstone_bits"] = _t(c.tomb)
    if masks in ("labels", "both"):
        kw_j.update(labels=jnp.asarray(c.labels), filter_bytes=jnp.asarray(c.fb))
        kw_t.update(labels=_t(c.labels), filter_bytes=_t(c.fb))
    jcodes, jq = c.jax_codes()
    tcodes, tq = c.torch_codes()
    ids = c.rng.integers(-1, N, (Q, R)).astype(np.int32)
    want = np.asarray(jmk(jcodes, jq, n_valid=jnp.int32(c.n_valid),
                          **kw_j)(jnp.asarray(ids)))
    got = _np(tmk(tcodes, tq, n_valid=c.n_valid, **kw_t)(_t(ids)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_rabitq_search_step_matches_jax_wrapper():
    """The bare wrapper against JAX's `rabitq_search_step` (pre-gathered
    codes + per-candidate live flags)."""
    from repro.kernels.rabitq_dot.ops import rabitq_search_step as jstep
    from repro_torch.kernels.rabitq_dot.ops import rabitq_search_step
    c = Case(4)
    ids = c.rng.integers(-1, N, (Q, R)).astype(np.int32)
    safe = np.maximum(ids, 0)
    live = ~np.asarray(jm.bitmap_gather(jnp.asarray(c.tomb),
                                        jnp.asarray(safe)))
    want = jstep(jnp.asarray(c.packed[safe]), jnp.asarray(c.add[safe]),
                 jnp.asarray(c.rescale[safe]), jnp.asarray(ids),
                 jnp.int32(c.n_valid), jnp.asarray(c.q_rot),
                 jnp.asarray(c.q_add), jnp.asarray(c.q_sum), bits=4,
                 live=jnp.asarray(live.astype(np.int32)))
    got = rabitq_search_step(_t(ids), _t(c.packed), _t(c.add),
                             _t(c.rescale), c.n_valid, _t(c.q_rot),
                             _t(c.q_add), _t(c.q_sum), bits=4,
                             tombstone_bits=_t(c.tomb))
    assert np.array_equal(_np(got), np.asarray(want))


# ------------------------------------------------------- fused search
FUSED_VARIANTS = [
    # name, quantized, bits, beam, masks, telemetry, schedule
    ("quant4", True, 4, 16, "none", False, None),
    ("quant4-tel", True, 4, 16, "none", True, None),
    ("quant1-tel", True, 1, 16, "none", True, None),
    ("exact-tel", False, 4, 16, "none", True, None),
    ("quant4-tomb-tel", True, 4, 16, "tomb", True, None),
    ("quant4-labels-tel", True, 4, 16, "labels", True, None),
    ("exact-both-tel", False, 4, 16, "both", True, None),
    ("quant4-schedule-tel", True, 4, 16, "none", True, (16, 12, 10)),
    ("quant4-L40-tel", True, 4, 40, "none", True, None),   # L > R + 1
    ("exact-L40-tomb-tel", False, 4, 40, "tomb", True, None),
]


def _fused_both(name, quantized, bits, beam, masks, telemetry, schedule,
                max_iters=48):
    """Run the port's megakernel wrapper (plain version on CPU) and JAX's
    `fused_search_ref` oracle on one integer-valued case."""
    c = Case(zlib.crc32(name.encode()) % 1000, bits=bits)
    jmask, tmask = {}, {}
    if masks in ("tomb", "both"):
        jmask.update(tombstone_bits=jnp.asarray(c.tomb),
                     traverse_deleted=False)
        tmask.update(tombstone_bits=_t(c.tomb), traverse_deleted=False)
    if masks in ("labels", "both"):
        jmask.update(labels=jnp.asarray(c.labels),
                     filter_bytes=jnp.asarray(c.fb), filter_exclude=True)
        tmask.update(labels=_t(c.labels), filter_bytes=_t(c.fb),
                     filter_exclude=True)
    if quantized:
        jcodes, jq = c.jax_codes()
        score = jbs.make_rabitq_scorer(jcodes, jq)
        tcodes, tq = c.torch_codes()
        table = dict(codes=tcodes, rq_query=tq)
    else:
        score = jbs.make_exact_scorer(jnp.asarray(c.vectors),
                                      jnp.asarray(c.queries), c.n_valid,
                                      jnp.asarray(c.sqnorm))
        table = dict(queries=_t(c.queries), vectors=_t(c.vectors),
                     vec_sqnorm=_t(c.sqnorm))
    want = jref.fused_search_ref(
        jnp.asarray(c.adj), jnp.int32(c.n_valid), jnp.int32(c.medoid), score,
        Q, beam_width=beam, max_iters=max_iters, beam_schedule=schedule,
        telemetry=telemetry, **jmask)
    graph = TGraph(adjacency=_t(c.adj), n_valid=c.n_valid, medoid=c.medoid)
    got = tops.fused_beam_search(
        graph, mode="megakernel", beam_width=beam, max_iters=max_iters,
        beam_schedule=schedule, telemetry=telemetry, **table, **tmask)
    return c, want, got, jmask, tmask, table


def _assert_result_equal(got, want, telemetry):
    assert np.array_equal(_np(got.frontier_ids), np.asarray(want[0]))
    assert np.array_equal(_np(got.frontier_dists), np.asarray(want[1]))
    assert np.array_equal(_np(got.n_hops), np.asarray(want[2]))
    if telemetry:
        for g, w in zip(got.telemetry, want[3]):
            assert np.array_equal(_np(g), np.asarray(w))
    else:
        assert got.telemetry is None


@pytest.mark.parametrize("variant", FUSED_VARIANTS,
                         ids=[v[0] for v in FUSED_VARIANTS])
def test_plain_fused_search_bit_exact_vs_ref(variant):
    c, want, got, *_ = _fused_both(*variant)
    _assert_result_equal(got, want, variant[5])
    assert float(np.mean(np.asarray(want[2]))) > 3   # the walks did work


@pytest.mark.parametrize("variant", FUSED_VARIANTS[:4],
                         ids=[v[0] for v in FUSED_VARIANTS[:4]])
def test_port_oracle_bit_exact_vs_ref(variant):
    """The port's own `fused_search_ref` (with the port's scorers) equals
    JAX's on the same inputs."""
    name, quantized, bits, beam, masks, telemetry, schedule = variant
    c, want, _, _, _, table = _fused_both(*variant)
    if quantized:
        score = tbs.make_rabitq_scorer(table["codes"], table["rq_query"])
    else:
        score = tbs.make_exact_scorer(table["vectors"], table["queries"],
                                      c.n_valid, table["vec_sqnorm"])
    got = tref.fused_search_ref(_t(c.adj), c.n_valid, c.medoid, score, Q,
                                beam_width=beam, max_iters=48,
                                beam_schedule=schedule, telemetry=telemetry)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(_np(g), np.asarray(w))
    if telemetry:
        for g, w in zip(got[3], want[3]):
            assert np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("quantized", [True, False], ids=["quant", "exact"])
def test_megakernel_wrapper_bit_exact_vs_jax_megakernel(quantized):
    """Port `fused_beam_search` vs JAX `fused_beam_search` (Pallas
    megakernel, interpret mode) at L = R, telemetry on."""
    from repro.kernels.search_step.ops import fused_beam_search as jfbs
    name = "mk-quant" if quantized else "mk-exact"
    c, want, got, _, _, _ = _fused_both(name, quantized, 4, R, "none", True,
                                        None, max_iters=40)
    jgraph = JGraph(jnp.asarray(c.adj), jnp.int32(c.n_valid),
                    jnp.int32(c.medoid))
    if quantized:
        jcodes, jq = c.jax_codes()
        table = dict(codes=jcodes, rq_query=jq)
    else:
        table = dict(queries=jnp.asarray(c.queries),
                     vectors=jnp.asarray(c.vectors),
                     vec_sqnorm=jnp.asarray(c.sqnorm))
    jres = jfbs(jgraph, mode="megakernel", beam_width=R, max_iters=40,
                telemetry=True, **table)
    _assert_result_equal(got, (jres.frontier_ids, jres.frontier_dists,
                               jres.n_hops, jres.telemetry), True)


def test_merge_keeps_the_inf_tail_empty():
    """The input on which the JAX megakernel's `_merge_topl` repeats an
    entry into the +inf tail (ROADMAP queue C): the port's merge, like
    `merge_frontier_topk`, leaves the tail empty."""
    f_ids, f_d, f_v = [[5, -1]], [[1.0, np.inf]], [[True, False]]
    c_ids, c_d = [[7, -1]], [[2.0, np.inf]]
    want = jbs.merge_frontier_topk(jnp.asarray(f_ids), jnp.asarray(f_d),
                                   jnp.asarray(f_v), jnp.asarray(c_ids),
                                   jnp.asarray(c_d), 4)
    got = tbs.merge_frontier_topk(_t(f_ids).int(), _t(f_d).float(),
                                  _t(f_v), _t(c_ids).int(), _t(c_d).float(),
                                  4)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    assert _np(got[0]).tolist() == [[5, 7, -1, -1]]
    assert _np(got[2]).tolist() == [[True, False, False, False]]


def test_unported_modes_raise():
    c = Case(9)
    graph = TGraph(adjacency=_t(c.adj), n_valid=c.n_valid, medoid=c.medoid)
    with pytest.raises(NotImplementedError, match="queue B"):
        tops.fused_beam_search(graph, mode="hop", beam_width=16,
                               max_iters=4, queries=_t(c.queries),
                               vectors=_t(c.vectors),
                               vec_sqnorm=_t(c.sqnorm))
    with pytest.raises(NotImplementedError, match="queue B"):
        tbs.merge_frontier_kernel(None, None, None, None, None, 4)
