"""Port parity of the kernel modules of the search and churn slices.

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
    merge agrees with its oracle, see ROADMAP queue C);
  * the hop loop (`fused_beam_search(mode="hop")`, one plain `fused_hop`
    per hop) vs `fused_search_ref` and vs the megakernel's plain path:
    BIT-EXACT, telemetry included, over the same variants;
  * `topk` vs `topk_ref` and `merge_frontier_kernel` vs
    `merge_frontier_topk`: BIT-EXACT on ties and +inf tails (the JAX
    `topk_pallas` repeats an entry into such a tail; pinned below).

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


# ------------------------------------------------------ hop loop (#4)
@pytest.mark.parametrize("variant", FUSED_VARIANTS,
                         ids=[v[0] for v in FUSED_VARIANTS])
def test_hop_loop_bit_exact_vs_ref_and_megakernel(variant):
    """One plain `fused_hop` per hop, driven by the host loop, equals the
    JAX oracle and the port's megakernel path bit for bit — ids, dists,
    hops and telemetry."""
    c, want, mega, _, tmask, table = _fused_both(*variant)
    name, quantized, bits, beam, masks, telemetry, schedule = variant
    graph = TGraph(adjacency=_t(c.adj), n_valid=c.n_valid, medoid=c.medoid)
    before = tops.fused_hop.launches
    got = tops.fused_beam_search(
        graph, mode="hop", beam_width=beam, max_iters=48,
        beam_schedule=schedule, telemetry=telemetry, **table, **tmask)
    assert tops.fused_hop.launches == before      # CPU: the plain version
    _assert_result_equal(got, want, telemetry)
    _assert_result_equal(got, (mega.frontier_ids, mega.frontier_dists,
                               mega.n_hops, mega.telemetry), telemetry)


def test_hop_plain_leaves_converged_rows_alone():
    """A row with no unvisited slot: frontier unchanged, increment 0,
    counters 0 — as `fused_hop_ref` leaves it."""
    c = Case(12)
    graph = TGraph(adjacency=_t(c.adj), n_valid=c.n_valid, medoid=c.medoid)
    tcodes, tq = c.torch_codes()
    ops = tops.fused_operands(graph, beam_width=16, max_iters=8,
                              codes=tcodes, rq_query=tq)
    ops["f_vis"][:3, 0] = 1                  # rows 0-2: converged
    f, hop_ops = tops.hop_operands(ops)
    ids, dists, vis, inc, cnt = tops.fused_hop(*f, 16, **hop_ops,
                                               telemetry=True)
    assert torch.equal(ids[:3], ops["f_ids"][:3])
    assert torch.equal(dists[:3], ops["f_dists"][:3])
    assert torch.equal(vis[:3], ops["f_vis"][:3])
    assert inc[:3].tolist() == [0, 0, 0] and (inc[3:] == 1).all()
    assert (cnt[:3] == 0).all() and (cnt[3:, 0] > 0).all()


# ----------------------------------------------------------- topk (#9)
TOPK_CASES = {
    "ties": ([[3., 1., 3., 1., 2., 1.]], [[10, 11, 12, 13, 14, 15]], 4),
    "inf-tail": ([[1., np.inf, 2., np.inf]], [[5, -1, 7, -1]], 4),
    "all-inf": ([[np.inf] * 5], [[4, 3, 2, 1, 0]], 5),
    "c-not-32": (None, None, 9),     # random ties, C = 45
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_plain_matches_topk_ref(case):
    from repro.kernels.topk.ref import topk_ref
    from repro_torch.kernels.topk.ops import topk
    d, ids, k = TOPK_CASES[case]
    if d is None:
        rng = np.random.default_rng(5)
        d = rng.integers(0, 6, (7, 45)).astype(np.float32)
        d[rng.random(d.shape) < 0.3] = np.inf
        ids = rng.integers(-1, 1000, (7, 45))
    d, ids = np.asarray(d, np.float32), np.asarray(ids, np.int32)
    wd, wi = topk_ref(jnp.asarray(d), jnp.asarray(ids), k)
    gd, gi = topk(_t(d), _t(ids), k)
    assert np.array_equal(_np(gd), np.asarray(wd))
    assert np.array_equal(_np(gi), np.asarray(wi))


MERGE_INPUT = dict(f_ids=[[5, -1]], f_d=[[1.0, np.inf]], f_v=[[True, False]],
                   c_ids=[[7, -1]], c_d=[[2.0, np.inf]], width=4)


def test_merge_frontier_kernel_matches_topk_merge():
    """The port's kernel merge equals JAX's `merge_frontier_topk` bit for
    bit: on the +inf-tail input and on random ties."""
    m = MERGE_INPUT
    rng = np.random.default_rng(9)
    cases = [(m["f_ids"], m["f_d"], m["f_v"], m["c_ids"], m["c_d"], 4)]
    f_d = np.sort(rng.integers(0, 5, (6, 16)).astype(np.float32), axis=1)
    f_d[:, 12:] = np.inf
    cases.append((rng.integers(-1, 99, (6, 16)), f_d, rng.random((6, 16)) < 0.5,
                  rng.integers(-1, 99, (6, 16)),
                  rng.integers(0, 5, (6, 16)).astype(np.float32), 16))
    for f_ids, f_d, f_v, c_ids, c_d, w in cases:
        args = (np.asarray(f_ids, np.int32), np.asarray(f_d, np.float32),
                np.asarray(f_v, bool), np.asarray(c_ids, np.int32),
                np.asarray(c_d, np.float32))
        want = jbs.merge_frontier_topk(*map(jnp.asarray, args), w)
        got = tbs.merge_frontier_kernel(*map(_t, args), w)
        for g, x in zip(got, want):
            assert np.array_equal(_np(g), np.asarray(x))
    assert _np(got[0]).shape == (6, 16)


def test_jax_topk_pallas_repeats_into_the_inf_tail():
    """Pins the JAX `topk_pallas` fault (ROADMAP queue C, entry 2): its
    min-extraction takes an already-taken position again once only +inf
    remains. The port's `topk` follows `topk_ref`, which does not."""
    from repro.kernels.topk.ops import topk as jtopk
    from repro.kernels.topk.ref import topk_ref
    from repro_torch.kernels.topk.ops import topk
    d = jnp.asarray([[1.0, np.inf, 2.0, np.inf]], jnp.float32)
    ids = jnp.asarray([[5, -1, 7, -1]], jnp.int32)
    _, pallas_ids = jtopk(d, ids, 4)
    _, ref_ids = topk_ref(d, ids, 4)
    assert np.asarray(pallas_ids).tolist() == [[5, 7, 5, 5]]
    assert np.asarray(ref_ids).tolist() == [[5, 7, -1, -1]]
    _, port_ids = topk(_t(np.asarray(d)), _t(np.asarray(ids)), 4)
    assert _np(port_ids).tolist() == [[5, 7, -1, -1]]
    m = MERGE_INPUT
    args = [jnp.asarray(np.asarray(x)) for x in
            (m["f_ids"], m["f_d"], m["f_v"], m["c_ids"], m["c_d"])]
    jk = jbs.merge_frontier_kernel(*args, 4)
    assert np.asarray(jk[0]).tolist() == [[5, 7, 5, 5]]
    assert np.asarray(jk[2]).tolist() == [[True, False, True, True]]


def test_host_tier_and_pq_run():
    """The host rows tier and the PQ baseline run in the port: the
    host-source `core_search` returns the full-width estimator frontier,
    equal to the device-source search's frontier before its rerank; with
    the rows evicted it needs no rows; `quantization="pq"` builds and
    searches behind its DeprecationWarning."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    from repro_torch.core.index_core import core_search
    from repro_torch.core.search_spec import ResolvedSearchSpec, SearchSpec
    c = Case(9)
    params = ConstructionParams(degree_bound=R, beam_width=16, max_iters=16,
                                rev_cap=R, prune_chunk=64)
    idx = JasperIndex(D, N, quantization="rabitq", device="cpu",
                      construction=params)
    idx.build(c.vectors[:64])
    base = SearchSpec(quantized=True, fusion="hop").resolve()
    host = ResolvedSearchSpec(**{**base.__dict__, "rerank_source": "host"})
    none = ResolvedSearchSpec(**{**base.__dict__, "rerank_source": "none",
                                 "rerank": False, "k": base.beam_width})
    q = _t(c.queries)
    got = core_search(idx.core, q, spec=host)
    want = core_search(idx.core, q, spec=none)
    assert got[0].shape == (Q, base.beam_width)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    idx.evict_rows_to_host()
    assert idx.core.vectors is None
    for a, b in zip(core_search(idx.core, q, spec=host), want):
        assert torch.equal(a, b)
    with pytest.warns(DeprecationWarning, match="NEGATIVE"):
        pq = JasperIndex(D, N, quantization="pq", device="cpu",
                         construction=params)
    pq.build(c.vectors[:64])
    with pytest.warns(DeprecationWarning, match="search_pq"):
        ids, dists = pq.search_pq(q, 5, beam_width=16)
    assert ids.shape == dists.shape == (Q, 5)
    assert bool((ids >= 0).all()) and bool(torch.isfinite(dists).all())
