"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (and `nvcc`, which builds the kernels
at first use): each is marked `cuda` and skips without a CUDA device. The
file imports torch and the port only, so it runs on a machine without
JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Flash attention (#10, #11): float32 rtol 1e-4 / atol 1e-5 against the
plain version, bf16 rtol/atol 2e-2, lse atol 1e-4; #11's o bit-equal to
#10's. Its backward (#12): dq, dk, dv against the plain version at rtol
1e-4 and atol 1e-4 of the largest plain gradient in float32 (the kernel
sums up to Sq * G terms one after another, the plain version in blocks:
the difference grows like sqrt(n) * eps), rtol 2e-2 and atol 2e-2 of it in
bf16 (ds and p are rounded to bf16 before their products, and the outputs
once more); run twice, bit-equal (no atomics). The autograd Function
against torch autograd of `blockwise_attention`, float32, rtol 1e-4.

Tolerances: on integer-valued operands every float sum is exact in any
order, so kernel and plain version must agree BIT for bit (ids, dists,
hops, telemetry). On float operands: dists rtol 1e-4, ids >= 0.99; the
L2 kernels rtol 1e-4 of the distance plus 1e-6 of the cancelled terms
|q|^2 + |x|^2 (float32 ulps), the RaBitQ estimators rtol 1e-4 / atol 1e-3
(#5's grid, at D up to 18,432, and #6: rtol 1e-4 plus 1e-6 of the
magnitude the estimator cancels).
The `topk` selection does no arithmetic: bit-equal on any input.
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import rabitq as tr
from repro_torch.core.mutations import pack_bitmap
from repro_torch.core.vamana import VamanaGraph
from repro_torch.kernels.topk.ops import MAX_COLUMNS, WARP_MAX_COLUMNS

N, D, R, Q = 512, 32, 16, 24
SMALL = (N, D, R, Q)
MAIN = (2048, 128, 64, 32)   # the main path's D, R; a 64 B row at 4 bits

FUSED_VARIANTS = [
    # name, quantized, bits, beam, masks, telemetry, schedule
    ("quant4", True, 4, 16, "none", False, None),
    ("quant4-tel", True, 4, 16, "none", True, None),
    ("quant2-tel", True, 2, 16, "none", True, None),
    ("quant1-tel", True, 1, 16, "none", True, None),
    ("quant8-tel", True, 8, 16, "none", True, None),
    ("exact-tel", False, 4, 16, "none", True, None),
    ("quant4-tomb-tel", True, 4, 16, "tomb", True, None),
    ("quant4-labels-tel", True, 4, 16, "labels", True, None),
    ("exact-both-tel", False, 4, 16, "both", True, None),
    ("quant4-schedule-tel", True, 4, 24, "none", True, (24, 16, 12)),
    ("quant4-L40-tel", True, 4, 40, "none", True, None),   # L > R + 1
    ("exact-L40-tomb", False, 4, 40, "tomb", False, None),
]

# (variant, (N, D, R, Q)): the small shape's variants, then the main
# path's R = 64 and 64-byte rows (16-byte loads, 4 lanes a candidate) at
# L = 64 and L = 128, 1 and 8 bits (16 and 128 B rows), exact rows of
# 512 B, and rows that are not a multiple of 16 B (D = 40, 4 bits: 20 B,
# 4-byte loads) or of 4 B (D = 36: 18 B, byte loads)
FUSED_CASES = [(v, SMALL) for v in FUSED_VARIANTS] + [
    (("main4-L64-tel", True, 4, 64, "none", True, None), MAIN),
    (("main4-L128-tel", True, 4, 128, "none", True, None), MAIN),
    (("main4-both-tel", True, 4, 64, "both", True, None), MAIN),
    (("main4-L128-both-tel", True, 4, 128, "both", True, None), MAIN),
    (("main4-L64", True, 4, 64, "none", False, None), MAIN),
    (("main-exact-tel", False, 4, 64, "none", True, None), MAIN),
    (("main1-tel", True, 1, 64, "none", True, None), MAIN),
    (("main8-tel", True, 8, 64, "none", True, None), MAIN),
    (("d40-quant4-tel", True, 4, 64, "none", True, None), (2048, 40, 64, 32)),
    (("d36-quant4-tel", True, 4, 64, "none", True, None), (2048, 36, 64, 32)),
    (("d36-exact-both-tel", False, 4, 64, "both", True, None),
     (2048, 36, 64, 32)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


class Case:
    """Integer-valued operands on the card (numpy-seeded)."""

    def __init__(self, seed, device, bits=4, shape=SMALL):
        n_rows, d, r, q = shape
        rng = np.random.default_rng(seed)

        def t(x):
            return torch.as_tensor(x).to(device)

        self.rng = rng
        adj = rng.integers(-1, n_rows, (n_rows, r)).astype(np.int32)  # dups, pads, self
        self.graph = VamanaGraph(adjacency=t(adj), n_valid=n_rows - 7,
                                 medoid=int(rng.integers(0, n_rows - 7)))
        vec = rng.integers(-5, 6, (n_rows, d)).astype(np.float32)
        self.vectors, self.sqnorm = t(vec), t((vec ** 2).sum(-1))
        self.queries = t(rng.integers(-5, 6, (q, d)).astype(np.float32))
        p = tr.packed_dim(d, bits)
        self.codes = tr.RaBitQCodes(
            packed=t(rng.integers(0, 256, (n_rows, p)).astype(np.uint8)),
            data_add=t(rng.integers(0, 4000, n_rows).astype(np.float32)),
            data_rescale=t(rng.choice([-2., -1., 1., 2.], n_rows)
                           .astype(np.float32)),
            bits=bits, dims=d)
        self.rq = tr.RaBitQQuery(
            q_rot=t(rng.integers(-3, 4, (q, d)).astype(np.float32)),
            query_add=t(rng.integers(0, 500, q).astype(np.float32)),
            query_sumq=t(rng.integers(-50, 50, q).astype(np.float32)))
        self.tomb = pack_bitmap(t(rng.random(n_rows) < 0.15))
        self.labels = t((rng.integers(0, 16, (n_rows, 4))
                         * np.array([1, 0, 0, 0])).astype(np.uint8))
        self.fb = t(np.array([0x05, 0, 0, 0], np.uint8))


def _operands(variant, device, shape=SMALL):
    from repro_torch.kernels.search_step.ops import fused_operands
    name, quantized, bits, beam, masks, telemetry, schedule = variant
    c = Case(zlib.crc32(name.encode()), device, bits=bits, shape=shape)
    kw = {}
    if masks in ("tomb", "both"):
        kw.update(tombstone_bits=c.tomb, traverse_deleted=False)
    if masks in ("labels", "both"):
        kw.update(labels=c.labels, filter_bytes=c.fb, filter_exclude=True)
    table = (dict(codes=c.codes, rq_query=c.rq) if quantized else
             dict(queries=c.queries, vectors=c.vectors,
                  vec_sqnorm=c.sqnorm))
    return fused_operands(c.graph, beam_width=beam, max_iters=60,
                          beam_schedule=schedule, **table, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant, shape", FUSED_CASES,
                         ids=[v[0] for v, _ in FUSED_CASES])
def test_fused_search_bit_exact_vs_plain(cuda_device, variant, shape):
    from repro_torch.kernels.search_step.ops import (fused_search,
                                                     fused_search_plain)
    ops = _operands(variant, cuda_device, shape)
    telemetry = variant[5]
    before = fused_search.launches
    got = fused_search(**ops, telemetry=telemetry)
    want = fused_search_plain(**ops, telemetry=telemetry)
    torch.cuda.synchronize()
    assert fused_search.launches == before + 1
    assert len(got) == len(want) == (5 if telemetry else 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    assert float(got[2].float().mean()) > 3       # the walks did work


@pytest.mark.cuda
@pytest.mark.parametrize("variant, shape", FUSED_CASES,
                         ids=[v[0] for v, _ in FUSED_CASES])
def test_fused_hop_bit_exact_vs_plain(cuda_device, variant, shape):
    """Every hop of a whole search: the kernel and the plain version from
    the same frontier, bit-equal, the walk continuing from the kernel's
    output."""
    from repro_torch.kernels.search_step.ops import (
        fused_hop, fused_hop_plain, hop_operands)
    ops = _operands(variant, cuda_device, shape)
    telemetry = variant[5]
    sched = ops["schedule"].tolist()
    f, hop_ops = hop_operands(ops)
    hops = 0
    for t in range(ops["max_iters"]):
        before = fused_hop.launches
        got = fused_hop(*f, sched[t], **hop_ops, telemetry=telemetry)
        want = fused_hop_plain(*f, sched[t], **hop_ops, telemetry=telemetry)
        torch.cuda.synchronize()
        assert fused_hop.launches == before + 1
        assert len(got) == len(want) == (5 if telemetry else 4)
        for g, w in zip(got, want):
            assert torch.equal(g, w), t
        hops += int(got[3].sum())
        if int(got[3].sum()) == 0:
            break
        f = got[:3]
    assert hops > 3 * shape[3]                       # the walks did work


@pytest.mark.cuda
def test_fused_instances_fit_and_do_not_spill(cuda_device):
    """All 80 instances (2 kernels x exact / 1, 2, 4, 8 bits x tombstone x
    labels x telemetry) at the main shape: the block's shared memory is
    the layout `check_fused_shape` counts, and no thread spills to local
    memory."""
    from repro_torch.kernels.search_step.ops import (
        QUERIES_PER_BLOCK, occupancy, query_smem_bytes)
    seen = 0
    for hop in (False, True):
        for quantized, bits in ((False, 8), (True, 1), (True, 2), (True, 4),
                                (True, 8)):
            p = 128 * bits // 8 if quantized else 512
            for tomb in (False, True):
                for labels in (False, True):
                    for tel in (False, True):
                        dq = p * 8 // bits if quantized else 128
                        info = occupancy(
                            hop=hop, quantized=quantized, bits=bits,
                            l_width=64, r=64, dq=dq,
                            row_width=p if quantized else 128, tomb=tomb,
                            labels=labels, telemetry=tel)
                        assert info["smem_per_block"] == (
                            QUERIES_PER_BLOCK * query_smem_bytes(
                                64, 64, p, 128 // bits if quantized else 4))
                        assert info["local_bytes"] == 0, info
                        assert info["queries_per_sm"] > 0
                        seen += 1
    assert seen == 80


# (Q, C, k): the warp path at every values-a-lane width (C <= 32, 64, 128,
# 256) and just past each, C at both sides of WARP_MAX_COLUMNS, the block
# path up to MAX_COLUMNS; C not a multiple of 4 or of 32
TOPK_SHAPES = [(24, 6, 4), (300, 128, 64), (64, 45, 9), (7, 1000, 100),
               (33, 32, 32), (33, 33, 7), (20, 64, 64), (21, 65, 30),
               (20, 129, 64), (23, 255, 3), (20, WARP_MAX_COLUMNS, 128),
               (20, WARP_MAX_COLUMNS + 1, 100), (3, MAX_COLUMNS - 1, 64),
               (3, MAX_COLUMNS, MAX_COLUMNS)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TOPK_SHAPES)
def test_topk_bit_exact_vs_plain(cuda_device, shape):
    """Rows with ties, all-+inf tails, C not a multiple of 32; both sides
    of the warp path's width and the block path's."""
    from repro_torch.kernels.topk.ops import topk, topk_plain
    q, c, k = shape
    rng = np.random.default_rng(c)
    d = rng.integers(0, 8, (q, c)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf
    d[: q // 4, c // 2:] = np.inf
    d = torch.as_tensor(d).to(cuda_device)
    ids = torch.as_tensor(rng.integers(-1, 10**6, (q, c)).astype(np.int32)
                          ).to(cuda_device)
    before = topk.launches
    got = topk(d, ids, k)
    want = topk_plain(d, ids, k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("masks", ["none", "tomb", "labels", "both"])
def test_rabitq_search_step_bit_exact_vs_plain(cuda_device, bits, masks):
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_search_step, rabitq_search_step_plain)
    c = Case(bits, cuda_device, bits=bits)
    ids = torch.as_tensor(c.rng.integers(-1, N, (Q, 40)).astype(np.int32)
                          ).to(cuda_device)
    kw = {}
    if masks in ("tomb", "both"):
        kw["tombstone_bits"] = c.tomb
    if masks in ("labels", "both"):
        kw.update(labels=c.labels, filter_bytes=c.fb)
    args = (ids, c.codes.packed, c.codes.data_add, c.codes.data_rescale,
            c.graph.n_valid, c.rq.q_rot, c.rq.query_add, c.rq.query_sumq)
    got = rabitq_search_step(*args, bits=bits, **kw)
    want = rabitq_search_step_plain(*args, bits=bits, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 33, 128])
def test_gather_l2_vs_plain(cuda_device, d):
    """Bit-exact on integer rows; rtol 1e-4 (+ float32 ulps of the
    cancelled terms) on float rows; odd widths take the scalar path."""
    from repro_torch.kernels.distance.ops import gather_l2, gather_l2_plain
    rng = np.random.default_rng(d)
    ids = torch.as_tensor(rng.integers(-1, N, (Q, 50)).astype(np.int32)
                          ).to(cuda_device)
    for integer in (True, False):
        x = (rng.integers(-9, 10, (N, d)) if integer
             else rng.normal(size=(N, d))).astype(np.float32)
        q = (rng.integers(-9, 10, (Q, d)) if integer
             else rng.normal(size=(Q, d))).astype(np.float32)
        x, q = torch.as_tensor(x).to(cuda_device), \
            torch.as_tensor(q).to(cuda_device)
        sq = (x * x).sum(-1)
        got = gather_l2(q, x, sq, ids)
        want = gather_l2_plain(q, x, sq, ids)
        if integer:
            assert torch.equal(got, want)
        else:
            fin = torch.isfinite(want)
            assert torch.equal(torch.isfinite(got), fin)
            terms = (q * q).sum(-1, keepdim=True) + sq[ids.clamp(min=0).long()]
            tol = 1e-4 * want.abs() + 1e-6 * terms
            assert bool(((got - want).abs()[fin] <= tol[fin]).all())


@pytest.mark.cuda
def test_wrappers_reject_bad_operands(cuda_device):
    from repro_torch.kernels.distance.ops import gather_l2
    x = torch.zeros((8, 4), device=cuda_device)
    sq = torch.zeros((8,), device=cuda_device)
    ids = torch.zeros((2, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        gather_l2(x[:2], x, sq, ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather_l2(x[:2], x.t().contiguous().t(), sq, ids.to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        gather_l2(x[:2, :3].contiguous(), x, sq, ids.to(torch.int32))


@pytest.mark.cuda
def test_fused_wrappers_refuse_a_frontier_past_shared_memory(cuda_device):
    from repro_torch.kernels.search_step.ops import (
        SMEM_PER_BLOCK, fused_hop, fused_search, hop_operands)
    v = ("quant4", True, 4, 4096, "none", False, None)
    ops = _operands(v, cuda_device)
    with pytest.raises(ValueError, match=f"the limit is {SMEM_PER_BLOCK}"):
        fused_search(**ops)
    f, hop_ops = hop_operands(ops)
    with pytest.raises(ValueError, match=f"the limit is {SMEM_PER_BLOCK}"):
        fused_hop(*f, 16, **hop_ops)


@pytest.mark.cuda
def test_index_on_the_card_end_to_end(cuda_device):
    """Build and search a small index on the card: the megakernel path
    launches its kernels and matches the plain path's recall."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.kernels.distance.ops import gather_l2
    from repro_torch.kernels.search_step.ops import fused_search
    rng = np.random.default_rng(0)
    data = rng.normal(size=(4096, 32)).astype(np.float32)
    q = rng.normal(size=(128, 32)).astype(np.float32)
    idx = JasperIndex(32, 4096, quantization="rabitq", construction=
                      ConstructionParams(degree_bound=24, beam_width=32,
                                         max_iters=48, rev_cap=24))
    idx.build(data)
    assert idx.core.vectors.is_cuda
    before = (fused_search.launches, gather_l2.launches)
    mk = idx.recall(q, 10, spec=SearchSpec(
        k=10, beam_width=48, quantized=True, use_kernels=True,
        fusion="megakernel"))
    assert fused_search.launches == before[0] + 1
    assert gather_l2.launches == before[1] + 1
    plain = idx.recall(q, 10, spec=SearchSpec(k=10, beam_width=48,
                                              quantized=True))
    assert mk >= plain - 0.01 and mk >= 0.75


def _search(idx, q, **kw):
    from repro_torch.core.search_spec import SearchSpec
    return idx.searcher(SearchSpec(k=10, beam_width=48, quantized=True,
                                   use_kernels=True, **kw)).search(q)


@pytest.mark.cuda
def test_churn_round_on_the_card(cuda_device):
    """delete -> search (three lanes, both traversal modes) -> consolidate
    -> insert into freed slots + auto-grow -> search again, on the card:
    zero tombstoned ids, recall, exact per-lane launch counts, hop lane ==
    megakernel lane, merge-kernel lane == topk-merge lane."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    from repro_torch.kernels.distance.ops import gather_l2
    from repro_torch.kernels.rabitq_dot.ops import rabitq_search_step
    from repro_torch.kernels.search_step.ops import fused_hop, fused_search
    from repro_torch.kernels.topk.ops import topk
    wrappers = (fused_search, fused_hop, topk, rabitq_search_step, gather_l2)
    rng = np.random.default_rng(1)
    data = rng.normal(size=(4096, 32)).astype(np.float32)
    q = torch.as_tensor(rng.normal(size=(128, 32)).astype(np.float32)
                        ).to(cuda_device)
    idx = JasperIndex(32, 4096, quantization="rabitq", construction=
                      ConstructionParams(degree_bound=24, beam_width=32,
                                         max_iters=48, rev_cap=24))
    idx.build(data)
    dead = np.sort(rng.choice(4096, 400, replace=False))
    assert idx.delete(dead) == 400 and idx.size == 3696

    def lanes(traverse):
        out = {}
        for name, kw in (("megakernel", dict(fusion="megakernel")),
                         ("hop", dict(fusion="hop")),
                         ("merge-kernel", dict(merge="kernel")),
                         ("topk-merge", dict(merge="topk"))):
            for w in wrappers:
                w.launches = 0
            res = _search(idx, q, traverse_deleted=traverse, **kw)
            torch.cuda.synchronize()
            out[name] = (res, [w.launches for w in wrappers])
        return out

    gt, _ = idx.brute_force(q, 10)
    for traverse in (True, False):
        out = lanes(traverse)
        mk, hop, mg, tk = (out[n][0] for n in
                           ("megakernel", "hop", "merge-kernel", "topk-merge"))
        for res in (mk, hop, mg):
            assert not np.isin(res.ids.cpu().numpy(), dead).any()
            hit = (res.ids[:, :, None] == gt[:, None, :]).any(2)
            assert float(hit.float().mean()) >= 0.8
        for a, b in ((hop, mk), (mg, tk)):
            assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            assert torch.equal(a.n_hops, b.n_hops)
        iters = int(hop.n_hops.max())
        assert out["megakernel"][1] == [1, 0, 0, 0, 1]
        assert out["hop"][1] == [0, iters, 0, 0, 1]
        iters = int(mg.n_hops.max())
        assert out["merge-kernel"][1] == [0, 0, iters, iters + 1, 1]
    stats = idx.consolidate()
    assert stats["n_freed"] == 400
    new = rng.normal(size=(800, 32)).astype(np.float32)
    ids = idx.insert(new)                         # 400 reused + 400 fresh
    assert (ids[:400] == dead).all()
    assert (ids[400:] == np.arange(4096, 4496)).all()
    assert idx.capacity == 8192 and idx.size == 4496
    self_hit = _search(idx, torch.as_tensor(new[:400]).to(cuda_device),
                       fusion="hop").ids[:, 0].cpu().numpy() == dead
    assert self_hit.mean() >= 0.9
    mk = _search(idx, q, fusion="megakernel")
    hop = _search(idx, q, fusion="hop")
    assert torch.equal(mk.ids, hop.ids) and torch.equal(mk.n_hops, hop.n_hops)


def _sq(t):
    return (t.float() ** 2).sum(-1)


def _l2_close(got, want, terms):
    """rtol 1e-4 of the distance plus a few float32 ulps of the terms
    |q|^2 + |x|^2 that |q|^2 - 2 q.x + |x|^2 cancels."""
    tol = 1e-4 * want.abs() + 1e-6 * terms
    return bool(((got - want).abs() <= tol).all())


# (Q, C, D): Q = 1, C = 1, D in {96, 100, 960}, C and Q off the 128 tile;
# D off the 32-dim chunk and the 16-dim k-step, one dim, a tile exactly
PAIRWISE_SHAPES = [(1, 1, 96), (1, 300, 100), (37, 1, 960), (130, 211, 100),
                   (257, 1000, 128), (5, 129, 33), (129, 257, 31),
                   (128, 128, 32), (200, 300, 129), (3, 5, 1), (64, 96, 18)]


def _pairwise_operands(rng, q, c, d, kind):
    """(q, x) float32 of `kind`: integer (bit-exact), noisy queries against
    integer rows, real x real, or mixed (integer queries and rows in the
    first 128-row tile, real ones after: tiles vote differently)."""
    qv = rng.integers(-9, 10, (q, d)).astype(np.float32)
    xv = rng.integers(-9, 10, (c, d)).astype(np.float32)
    if kind in ("noisy", "real"):
        qv += rng.normal(size=qv.shape).astype(np.float32)
    if kind == "real":
        xv = rng.normal(size=xv.shape).astype(np.float32)
    if kind == "mixed":
        qv[128:] += rng.normal(size=qv[128:].shape).astype(np.float32)
        xv[128:] += rng.normal(size=xv[128:].shape).astype(np.float32)
    return qv, xv


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAIRWISE_SHAPES,
                         ids=["x".join(map(str, s)) for s in PAIRWISE_SHAPES])
def test_pairwise_l2_vs_plain(cuda_device, shape):
    """Bit-exact on integer operands; rtol 1e-4 (+ ulps of the cancelled
    terms) on noisy x integer, real x real and mixed operands; ragged Q, C
    and D."""
    from repro_torch.kernels.distance.ops import pairwise_l2, pairwise_l2_plain
    q, c, d = shape
    rng = np.random.default_rng(q * c + d)
    for kind in ("integer", "noisy", "real", "mixed"):
        qv, xv = (torch.as_tensor(t).to(cuda_device)
                  for t in _pairwise_operands(rng, q, c, d, kind))
        before = pairwise_l2.launches
        got = pairwise_l2(qv, xv)
        want = pairwise_l2_plain(qv, xv)
        torch.cuda.synchronize()
        assert pairwise_l2.launches == before + 1
        assert got.shape == (q, c)
        if kind == "integer":
            assert torch.equal(got, want)
        else:
            assert _l2_close(got, want, _sq(qv)[:, None] + _sq(xv)[None, :])


@pytest.mark.cuda
def test_pairwise_l2_on_the_tensor_cores_without_spills(cuda_device):
    """#7's kernel has HMMA (tensor-core) instructions and no spill
    stores, and holds two blocks an SM."""
    from repro_torch.kernels.distance.ops import pairwise_occupancy
    found = {fn: v for fn, v in _sass_hmma_and_spills("pairwise_l2").items()
             if "pairwise_l2_kernel" in fn}
    assert len(found) >= 1
    for fn, (hmma, spill) in found.items():
        assert hmma > 0, fn
        assert spill == 0, fn
    info = pairwise_occupancy()
    assert info["local_bytes"] == 0
    assert info["blocks_per_sm"] == 2


@pytest.mark.cuda
def test_pairwise_l2_bf16_inputs(cuda_device):
    """bfloat16 operands are read as float32: bit-equal to the plain
    version on integer values, within tolerance on random values."""
    from repro_torch.kernels.distance.ops import pairwise_l2, pairwise_l2_plain
    rng = np.random.default_rng(16)
    for integer in (True, False):
        qv, xv = (torch.as_tensor(
            (rng.integers(-9, 10, (n, 128)) if integer
             else rng.normal(size=(n, 128))).astype(np.float32)
        ).to(cuda_device, torch.bfloat16) for n in (16, 200))
        got = pairwise_l2(qv, xv)
        want = pairwise_l2_plain(qv, xv)
        assert got.dtype == torch.float32
        if integer:
            assert torch.equal(got, want)
        else:
            assert _l2_close(got, want, _sq(qv)[:, None] + _sq(xv)[None, :])


def _int_codes(rng, c, p, q, d, device):
    """Random packed bytes, integer metadata and integer queries."""
    def t(x):
        return torch.as_tensor(x).to(device)
    return (t(rng.integers(0, 256, (c, p)).astype(np.uint8)),
            t(rng.integers(0, 4000, c).astype(np.float32)),
            t(rng.choice([-2., -1., 1., 2.], c).astype(np.float32)),
            t(rng.integers(-3, 4, (q, d)).astype(np.float32)),
            t(rng.integers(0, 500, q).astype(np.float32)),
            t(rng.integers(-50, 50, q).astype(np.float32)))


# (Q, C, D, extra packed bytes past the D codes)
RABITQ_SHAPES = [(1, 1, 96, 0), (19, 300, 100, 0), (37, 1, 960, 0),
                 (130, 211, 128, 0), (8, 1000, 128, 3), (5, 129, 33, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", RABITQ_SHAPES,
                         ids=["x".join(map(str, s)) for s in RABITQ_SHAPES])
def test_rabitq_distance_bit_exact_vs_plain(cuda_device, bits, shape):
    """Integer operands: bit-equal, every bits variant, ragged shapes; only
    the first D unpacked codes count (packed rows may be wider)."""
    from repro_torch.kernels.rabitq_dot.ops import (rabitq_distance,
                                                    rabitq_distance_plain)
    q, c, d, extra = shape
    rng = np.random.default_rng(bits * 100 + c)
    p = tr.packed_dim(d, bits) + extra
    args = _int_codes(rng, c, p, q, d, cuda_device)
    before = rabitq_distance.launches
    got = rabitq_distance(*args, bits=bits)
    want = rabitq_distance_plain(*args, bits=bits)
    torch.cuda.synchronize()
    assert rabitq_distance.launches == before + 1
    assert got.shape == (q, c)
    assert torch.equal(got, want)


# (K, P) of #5: one round of rows or several (K 300 > 128 rows a round;
# P 2,304 B: 7 rows a round, the query transposed in shared memory),
# 16-byte, byte-width (33 B) and the main path's 64-byte rows
GATHER_GRID = [(k, p) for k in (1, 40, 64, 128, 300)
               for p in (16, 33, 64, 2304)]


def _estimator_close(got, want, add, qa, rescale, q, qs, bits):
    """Within rtol 1e-4 of the plain version plus 1e-6 of the magnitude the
    estimator cancels, |add| + |qa| + |rescale| (sum |q| (2^bits - 1) +
    |qsum|): chip_smoke.py's `within` bound, as #6's real operands are
    held. The kernel and the plain version sum D products in other
    orders."""
    qmag = q.abs().sum(1) * (2 ** bits - 1) + qs.abs()
    terms = add.abs() + qa.abs()[:, None] + rescale.abs() * qmag[:, None]
    return bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * terms)
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("k, p", GATHER_GRID,
                         ids=[f"K{k}-P{p}" for k, p in GATHER_GRID])
def test_rabitq_gather_distance_vs_plain_and_search_step(cuda_device, bits,
                                                         k, p):
    """Bit-equal to its plain version on integer operands, and to
    `rabitq_search_step` on the same in-range ids with every row live on
    integer and on real operands (both kernels score a row with
    rabitq_rows.cuh's scorer); real operands within `_estimator_close` of
    the plain version. Ragged Q (13: the last block holds one query); D
    below P * 8/bits at K 1, 40 and 300."""
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_gather_distance, rabitq_gather_distance_plain,
        rabitq_search_step)
    n, q = 512, 13
    rng = np.random.default_rng(bits * 10_000 + k * 10 + p)
    d = p * (8 // bits) - (3 if k in (1, 40, 300) else 0)

    def t(x):
        return torch.as_tensor(x).to(cuda_device)
    packed = t(rng.integers(0, 256, (n, p)).astype(np.uint8))
    ids = t(rng.integers(0, n, (q, k)).astype(np.int32))
    safe = ids.long()
    for integer in (True, False):
        if integer:
            meta = (rng.integers(0, 4000, n), rng.choice([-2, -1, 1, 2], n),
                    rng.integers(-3, 4, (q, d)), rng.integers(0, 500, q),
                    rng.integers(-50, 50, q))
        else:
            meta = (rng.normal(size=n) * 100, rng.normal(size=n),
                    rng.normal(size=(q, d)), rng.normal(size=q) * 100,
                    rng.normal(size=q) * 10)
        add, rescale, q_rot, qa, qs = (t(x.astype(np.float32)) for x in meta)
        cand = (packed[safe].contiguous(), add[safe], rescale[safe])
        before = rabitq_gather_distance.launches
        got = rabitq_gather_distance(*cand, q_rot, qa, qs, bits=bits)
        want = rabitq_gather_distance_plain(*cand, q_rot, qa, qs, bits=bits)
        step = rabitq_search_step(ids, packed, add, rescale, n, q_rot, qa, qs,
                                  bits=bits)
        torch.cuda.synchronize()
        assert rabitq_gather_distance.launches == before + 1
        assert got.shape == (q, k)
        assert torch.equal(got, step)
        if integer:
            assert torch.equal(got, want)
        else:
            assert _estimator_close(got, want, cand[1], qa, cand[2], q_rot,
                                    qs, bits)


# (Q, C, D): ragged queries, rows and dims, D not a multiple of 16 or 64
RABITQ_REAL_SHAPES = [(1, 1, 96), (19, 300, 100), (37, 5, 960),
                      (130, 513, 128), (65, 257, 33), (200, 1000, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", RABITQ_REAL_SHAPES,
                         ids=["x".join(map(str, s)) for s in RABITQ_REAL_SHAPES])
def test_rabitq_distance_real_operands_vs_plain(cuda_device, bits, shape):
    """Real queries and metadata: within rtol 1e-4 of the plain version plus
    1e-6 of the magnitude the estimator cancels, |add| + |qa| + |rescale|
    (sum |q| (2^bits - 1) + |qsum|) — chip_smoke.py's `within` bound. The
    tensor cores sum the exact products of the three bf16 parts in another
    order than the plain float32 product."""
    from repro_torch.kernels.rabitq_dot.ops import (rabitq_distance,
                                                    rabitq_distance_plain)
    q, c, d = shape
    rng = np.random.default_rng(bits * 1000 + d)
    p = tr.packed_dim(d, bits)

    def t(x):
        return torch.as_tensor(x.astype(np.float32)).to(cuda_device)
    packed = torch.as_tensor(rng.integers(0, 256, (c, p)).astype(np.uint8)
                             ).to(cuda_device)
    args = (packed, t(rng.normal(size=c) * 100), t(rng.normal(size=c)),
            t(rng.normal(size=(q, d))), t(rng.normal(size=q) * 100),
            t(rng.normal(size=q) * 10))
    got = rabitq_distance(*args, bits=bits)
    want = rabitq_distance_plain(*args, bits=bits)
    torch.cuda.synchronize()
    add, rescale, qr, qa, qs = args[1:]
    qmag = qr.abs().sum(1) * (2 ** bits - 1) + qs.abs()
    terms = (add.abs()[None, :] + qa.abs()[:, None]
             + rescale.abs()[None, :] * qmag[:, None])
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * terms)
                .all())


def _sass_hmma_and_spills(name):
    """{kernel: (HMMA instructions in its SASS, spill-store bytes from its
    ptxas report)} of the library `name` (built on first use)."""
    import re
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    lib = build.build_all()[name]
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    report = (build.BUILD_DIR / f"{name}.log").read_text(errors="replace")
    spills = dict(re.findall(r"Function properties for (\S+)\n\s*\d+ bytes "
                             r"stack frame, (\d+) bytes spill stores", report))
    return {fn: (body.count("HMMA"), int(spills.get(fn, -1)))
            for fn, body in re.findall(
                r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S)}


@pytest.mark.cuda
def test_rabitq_distance_on_the_tensor_cores_without_spills(cuda_device):
    """Every instance of #6 (BITS 1, 2, 4, 8) has HMMA (tensor-core)
    instructions and no spill stores."""
    found = {fn: v for fn, v in _sass_hmma_and_spills("rabitq_distance")
             .items() if "rabitq_distance_kernel" in fn}
    assert len(found) == 4
    for fn, (hmma, spill) in found.items():
        assert hmma > 0, fn
        assert spill == 0, fn


# (K, D at 4 bits): rows of 16 B (D 32), 64 B (the main path), 2,304 B (the
# RAG index's D 4,608: several rounds a query), and rows of 18 and 20 B
# (byte and 4-byte copies)
STEP_SHAPES = [(k, d) for k in (1, 33, 64, 128) for d in (32, 128, 4608)] + [
    (64, 36), (64, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("masks", ["none", "tomb", "labels", "both"])
@pytest.mark.parametrize("k, d", STEP_SHAPES,
                         ids=[f"K{k}-P{d // 2}" for k, d in STEP_SHAPES])
def test_rabitq_search_step_rows_in_flight(cuda_device, k, d, masks):
    """All of a query's rows staged at once, or in rounds: ids -1, ids in
    [n_valid, N), every mask combination; bit-equal to the plain version on
    integer operands."""
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_search_step, rabitq_search_step_plain)
    c = Case(k * 7 + d, cuda_device, bits=4, shape=(N, d, R, Q))
    ids = torch.as_tensor(c.rng.integers(-1, N, (Q, k)).astype(np.int32)
                          ).to(cuda_device)
    kw = {}
    if masks in ("tomb", "both"):
        kw["tombstone_bits"] = c.tomb
    if masks in ("labels", "both"):
        kw.update(labels=c.labels, filter_bytes=c.fb)
    args = (ids, c.codes.packed, c.codes.data_add, c.codes.data_rescale,
            c.graph.n_valid, c.rq.q_rot, c.rq.query_add, c.rq.query_sumq)
    before = rabitq_search_step.launches
    got = rabitq_search_step(*args, bits=4, **kw)
    want = rabitq_search_step_plain(*args, bits=4, **kw)
    torch.cuda.synchronize()
    assert rabitq_search_step.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rabitq_search_step_equals_gather_distance_on_real_codes(cuda_device):
    """#3 and #5 score a staged row with one scorer (rabitq_rows.cuh): on
    the same live rows they agree bit for bit on real operands, at the
    main path's 64-byte rows."""
    from repro_torch.kernels.rabitq_dot.ops import (rabitq_gather_distance,
                                                    rabitq_search_step)
    c = Case(64, cuda_device, bits=4, shape=MAIN)
    rng = np.random.default_rng(64)
    n = MAIN[0]
    ids = torch.as_tensor(rng.integers(0, n, (MAIN[3], 64)).astype(np.int32)
                          ).to(cuda_device)
    codes = tr.RaBitQCodes(
        packed=c.codes.packed,
        data_add=torch.as_tensor(rng.normal(size=n).astype(np.float32) * 50
                                 ).to(cuda_device),
        data_rescale=torch.as_tensor(rng.normal(size=n).astype(np.float32)
                                     ).to(cuda_device), bits=4, dims=128)
    qargs = (torch.as_tensor(rng.normal(size=(MAIN[3], 128)).astype(
        np.float32)).to(cuda_device), c.rq.query_add, c.rq.query_sumq)
    safe = ids.long()
    got5 = rabitq_gather_distance(codes.packed[safe].contiguous(),
                                  codes.data_add[safe],
                                  codes.data_rescale[safe], *qargs, bits=4)
    got3 = rabitq_search_step(ids, codes.packed, codes.data_add,
                              codes.data_rescale, n, *qargs, bits=4)
    torch.cuda.synchronize()
    assert torch.equal(got3, got5)


@pytest.mark.cuda
def test_rabitq_search_step_reports_its_occupancy(cuda_device):
    """The main path's instances of #3 and #5: STEP_WARPS_PER_BLOCK /
    `gather_warps_per_block` warps a block, resident blocks > 0, the slots
    `step_smem_bytes` / `gather_smem_bytes` count, nothing spilled; #5
    also at the RAG index's 2,304-byte rows; #6 two blocks an SM."""
    from repro_torch.kernels.rabitq_dot.ops import (
        STEP_WARPS_PER_BLOCK, gather_smem_bytes, gather_warps_per_block,
        occupancy, step_smem_bytes)
    info = occupancy("rabitq_search_step", bits=4, p=64, k=64)
    assert info["warps_per_block"] == STEP_WARPS_PER_BLOCK
    assert info["smem_per_block"] == (STEP_WARPS_PER_BLOCK
                                      * step_smem_bytes(64, 64, 4))
    assert info["blocks_per_sm"] > 0 and info["local_bytes"] == 0
    for p in (64, 2304):
        info = occupancy("rabitq_gather_distance", bits=4, p=p, k=64)
        wpb = gather_warps_per_block(64, p, 4)
        assert info["warps_per_block"] == wpb
        assert info["smem_per_block"] == wpb * gather_smem_bytes(64, p, 4)
        assert info["blocks_per_sm"] > 0 and info["local_bytes"] == 0
    info = occupancy("rabitq_distance", bits=4, p=64)
    assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 33, 96, 100, 960])
def test_gather_l2_tiled_vs_plain(cuda_device, d):
    """Bit-exact on integer rows (and equal to `gather_l2`); tolerance on
    float rows; ids < 0 -> +inf, ids past the table clamp; Q = 1 too."""
    from repro_torch.kernels.distance.ops import (gather_l2, gather_l2_plain,
                                                  gather_l2_tiled)
    rng = np.random.default_rng(d + 1)
    for q in (Q, 1):
        ids = torch.as_tensor(rng.integers(-1, N + 3, (q, 50)).astype(
            np.int32)).to(cuda_device)
        for integer in (True, False):
            x, qv = ((rng.integers(-9, 10, (n, d)) if integer
                      else rng.normal(size=(n, d))).astype(np.float32)
                     for n in (N, q))
            x = torch.as_tensor(x).to(cuda_device)
            qv = torch.as_tensor(qv).to(cuda_device)
            sq = (x * x).sum(-1)
            before = gather_l2_tiled.launches
            got = gather_l2_tiled(qv, x, sq, ids)
            want = gather_l2_plain(qv, x, sq, ids)
            torch.cuda.synchronize()
            assert gather_l2_tiled.launches == before + 1
            fin = torch.isfinite(want)
            assert torch.equal(fin, ids >= 0)
            assert torch.equal(torch.isfinite(got), fin)
            if integer:
                assert torch.equal(got, want)
                assert torch.equal(got, gather_l2(qv, x, sq, ids))
            else:
                terms = _sq(qv)[:, None] + sq[ids.clamp(0, N - 1).long()]
                assert _l2_close(got[fin], want[fin], terms[fin])


@pytest.mark.cuda
def test_scan_wrappers_reject_bad_operands(cuda_device):
    from repro_torch.kernels.distance.ops import gather_l2_tiled, pairwise_l2
    from repro_torch.kernels.rabitq_dot.ops import (rabitq_distance,
                                                    rabitq_gather_distance)
    x = torch.zeros((8, 4), device=cuda_device)
    sq = torch.zeros((8,), device=cuda_device)
    ids = torch.zeros((2, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        gather_l2_tiled(x[:2], x, sq, ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather_l2_tiled(x[:2], x.t().contiguous().t(), sq,
                        ids.to(torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        pairwise_l2(x.to(torch.int32), x)
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_l2(x, x.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        pairwise_l2(x[:, :3].contiguous(), x)
    packed = torch.zeros((8, 2), dtype=torch.uint8, device=cuda_device)
    q = torch.zeros((2, 4), device=cuda_device)
    qs = torch.zeros((2,), device=cuda_device)
    with pytest.raises(ValueError, match="bits"):
        rabitq_distance(packed, sq, sq, q, qs, qs, bits=3)
    with pytest.raises(ValueError, match="fit"):      # 4 dims > 2 B x 1 code
        rabitq_distance(packed, sq, sq, q, qs, qs, bits=8)
    with pytest.raises(ValueError, match="dtype"):
        rabitq_distance(packed.float(), sq, sq, q, qs, qs, bits=4)
    with pytest.raises(ValueError, match="match"):
        rabitq_distance(packed, sq[:5], sq, q, qs, qs, bits=4)
    cand = torch.zeros((2, 3, 2), dtype=torch.uint8, device=cuda_device)
    meta = torch.zeros((2, 3), device=cuda_device)
    with pytest.raises(ValueError, match="match"):
        rabitq_gather_distance(cand, meta[:, :2].contiguous(), meta, q, qs,
                               qs, bits=4)
    with pytest.raises(ValueError, match="3-D"):
        rabitq_gather_distance(cand[0], meta, meta, q, qs, qs, bits=4)


@pytest.mark.cuda
def test_exact_lanes_on_the_card(cuda_device):
    """Exact-vector search on a small integer-valued index: the tiled lane
    equals the chunked lane and the plain lane bit for bit, and each lane
    launches exactly its own kernels."""
    from repro_torch.core.beam_search import beam_search
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.kernels.distance.ops import (gather_l2, gather_l2_tiled,
                                                  make_kernel_scorer)
    from repro_torch.kernels.search_step.ops import fused_hop, fused_search
    wrappers = (fused_search, fused_hop, gather_l2, gather_l2_tiled)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 64, (4096, 32)).astype(np.float32)
    q = torch.as_tensor(rng.integers(0, 64, (128, 32)).astype(np.float32)
                        ).to(cuda_device)
    idx = JasperIndex(32, 4096, construction=ConstructionParams(
        degree_bound=24, beam_width=32, max_iters=48, rev_cap=24))
    idx.build(data)
    core = idx.core
    out = {}

    def run(name, fn):
        for w in wrappers:
            w.launches = 0
        res = fn()
        torch.cuda.synchronize()
        out[name] = (res, [w.launches for w in wrappers])

    for name, kw in (("megakernel", dict(use_kernels=True,
                                         fusion="megakernel")),
                     ("hop", dict(use_kernels=True, fusion="hop")),
                     ("chunked", dict(use_kernels=True)),
                     ("plain", dict(use_kernels=False))):
        run(name, lambda: idx.searcher(SearchSpec(
            k=10, beam_width=48, **kw)).search(q))
    spec = SearchSpec(k=10, beam_width=48).resolve()
    run("tiled", lambda: beam_search(
        core.graph, make_kernel_scorer(core.vectors, q, core.n_valid,
                                       core.vec_sqnorm, strategy="tiled"),
        q.shape[0], beam_width=spec.beam_width, max_iters=spec.max_iters))
    tiled = out["tiled"][0]
    for name in ("chunked", "plain"):
        res = out[name][0]
        assert torch.equal(res.ids, tiled.frontier_ids[:, :10])
        assert torch.equal(res.dists, tiled.frontier_dists[:, :10])
        assert torch.equal(res.n_hops, tiled.n_hops)
    iters = int(tiled.n_hops.max())
    hop_iters = int(out["hop"][0].n_hops.max())
    assert out["megakernel"][1] == [1, 0, 0, 0]
    assert out["hop"][1] == [0, hop_iters, 0, 0]
    assert out["chunked"][1] == [0, 0, iters + 1, 0]
    assert out["plain"][1] == [0, 0, 0, 0]
    assert out["tiled"][1] == [0, 0, 0, iters + 1]
    gt, _ = idx.brute_force(q, 10)
    hit = (tiled.frontier_ids[:, :10, None] == gt[:, None, :]).any(2)
    assert float(hit.float().mean()) >= 0.8


# ------------------------------------------------- flash attention (#10, #11)
# name, b, sq, skv, h, hk, dh, causal, window, q_offset
FLASH_GRID = [
    ("causal-g1-d64", 2, 130, 130, 4, 4, 64, True, 0, 0),
    ("causal-g2-d128", 1, 200, 200, 8, 4, 128, True, 0, 0),
    ("causal-g9-d128", 1, 257, 257, 36, 4, 128, True, 0, 0),
    ("bidir-g9-d64", 2, 100, 77, 18, 2, 64, False, 0, 0),
    ("window64-g2-d128", 1, 300, 300, 4, 2, 128, True, 64, 0),
    ("window64-g9-d64", 1, 193, 193, 9, 1, 64, True, 64, 0),
    ("qoffset-g9-d128", 2, 70, 333, 9, 1, 128, True, 0, 263),
    ("qoffset-window64-g2-d64", 1, 50, 250, 4, 2, 64, True, 64, 200),
    ("rows-past-the-keys-g2-d64", 1, 64, 100, 4, 2, 64, True, 16, 120),
    ("causal-g2-d32", 1, 65, 65, 4, 2, 32, True, 0, 0),
    # head dim 80 (stablelm-3b, zamba2-2.7b, hubert-xlarge)
    ("causal-g2-d80", 1, 200, 200, 8, 4, 80, True, 0, 0),
    ("window64-g1-d80", 1, 257, 257, 4, 4, 80, True, 64, 0),
    ("qoffset-g2-d80", 2, 70, 333, 4, 2, 80, True, 0, 263),
    ("bidir-g9-d80", 1, 129, 127, 9, 1, 80, False, 0, 0),
    # the edges of the bf16 kernels' tiles: 64 keys; 64 query rows, or 128
    # at Dh 128 (the backward: 64 rows and 64 keys at every Dh)
    ("edge-63-d128", 1, 63, 63, 4, 1, 128, True, 0, 0),
    ("edge-65-d80", 1, 65, 65, 4, 2, 80, True, 0, 0),
    ("edge-127-129-d64", 2, 127, 129, 4, 2, 64, False, 0, 0),
    ("edge-129-d128", 1, 129, 129, 4, 2, 128, True, 0, 0),
    ("edge-129-255-d80", 1, 129, 255, 4, 2, 80, True, 0, 126),
    ("edge-255-d32", 1, 255, 255, 6, 2, 32, True, 0, 0),
    ("edge-255-127-window-d128", 1, 255, 127, 4, 4, 128, True, 64, 0),
]
# float32: the sums differ only in order; bf16: p is rounded to bf16 at
# another running max and the output is rounded once more
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _flash_inputs(case, dtype, device):
    _, b, sq, skv, h, hk, dh, *_ = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               ).to(device=device, dtype=dtype)
    return t(b, sq, h, dh), t(b, skv, hk, dh), t(b, skv, hk, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_GRID, ids=[c[0] for c in FLASH_GRID])
def test_flash_attention_vs_plain(cuda_device, case, dtype):
    """#10 and #11 against their plain versions (the Pallas block loop at
    64 x 64), with GQA groups 1, 2 and 9, head dims 32/64/80/128, ragged
    lengths at the tiles' edges (63, 65, 127, 129, 255), windows, q_offset
    with Sq < Skv and rows that see no key;
    #11's o bit-equal to #10's, its lse within 1e-4 of the plain one."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_fwd, flash_attention_fwd_plain)
    q, k, v = _flash_inputs(case, dtype, cuda_device)
    causal, window, q_offset = case[7:]
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=64,
              block_kv=64)
    b10, b11 = flash_attention.launches, flash_attention_fwd.launches
    o10 = flash_attention(q, k, v, **kw)
    o11, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == b10 + 1
    assert flash_attention_fwd.launches == b11 + 1
    assert o10.dtype == dtype and o10.shape == q.shape
    assert torch.equal(o10, o11)
    torch.testing.assert_close(o10.float(), want.float(), **FLASH_TOL[dtype])
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_flash_attention_strided_operands(cuda_device):
    """q/k/v as views of fused projections (strided heads) read in place:
    the same numbers as from contiguous copies."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    b, s, h, hk, dh = 2, 96, 9, 1, 64
    qkv = torch.randn((b, s, (h + 2 * hk) * dh), device=cuda_device)
    q = qkv[..., :h * dh].view(b, s, h, dh)
    k = qkv[..., h * dh:(h + hk) * dh].view(b, s, hk, dh)
    v = qkv[..., (h + hk) * dh:].view(b, s, hk, dh)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_model_forward_flash_vs_blockwise(cuda_device):
    """Two layers of starcoder2-7b at full width (d_model 4608, 36 heads on
    4 KV heads, Dh 128) in bf16: the kernel path's final hidden states
    against the blockwise path's, per-token cosine >= 0.999; 2 launches
    of #10 (one per layer)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.model import forward, init_params
    cfg = dataclasses.replace(get_config("starcoder2-7b"), num_layers=2,
                              dtype="bfloat16", use_flash_kernel=True)
    params = init_params(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda_device)
    before = flash_attention.launches
    with torch.inference_mode():
        got = forward(params, cfg, {"tokens": toks}, return_hidden=True)
        want = forward(params, dataclasses.replace(cfg,
                                                   use_flash_kernel=False),
                       {"tokens": toks}, return_hidden=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(),
                                                dim=-1)
    assert float(cos.min()) >= 0.999


FAMILY_ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m", "chameleon-34b",
                "hubert-xlarge", "xlstm-125m", "zamba2-2.7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_the_card_matches_the_cpu(cuda_device, arch):
    """Each family's reduced config in float32, the same parameters on the
    card (the flash kernel) and on the CPU (its plain version): forward
    logits, then (decoders) a prefill of 16 tokens and 4 decode steps, the
    cosine of each position's logits >= 0.9999 (cuDNN's float32 conv runs
    in TF32); #10 launched once per attention application a forward."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              use_flash_kernel=True)
    cpu = init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    gen = torch.Generator().manual_seed(1)
    if cfg.frontend == "frames":
        batch = {"frames": torch.randn((2, 32, cfg.d_model), generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                         generator=gen)}

    def close(got, want):
        cos = torch.nn.functional.cosine_similarity(
            got.float().cpu().flatten(0, -2), want.flatten(0, -2), dim=-1)
        assert float(cos.min()) >= 0.9999, float(cos.min())

    applications = {"ssm": 0, "hybrid": cfg.num_layers // max(
        cfg.attn_every, 1)}.get(cfg.family, cfg.num_layers)
    before = flash_attention.launches
    with torch.inference_mode():
        close(forward(card, cfg, {k: v.to(cuda_device)
                                  for k, v in batch.items()}),
              forward(cpu, cfg, batch))
        torch.cuda.synchronize()
        assert flash_attention.launches == before + applications
        if cfg.is_encoder:
            return
        toks = batch["tokens"]
        got, g_state = prefill(card, cfg, {"tokens": toks[:, :16].to(
            cuda_device)}, max_len=32)
        want, w_state = prefill(cpu, cfg, {"tokens": toks[:, :16]},
                                max_len=32)
        close(got, want)
        for t in range(16, 20):
            got, g_state = decode_step(card, cfg, g_state,
                                       toks[:, t:t + 1].to(cuda_device))
            want, w_state = decode_step(cpu, cfg, w_state, toks[:, t:t + 1])
            close(got, want)


# the attention shapes the families train at (B=1, bf16): granite-moe's
# 16/8 heads at Dh 64, causal; zamba2's 32/32 at Dh 80 with its 4,096
# window, at 4,608 tokens so that the window cuts; hubert's 16/16 at Dh 80,
# bidirectional. The model path's blocks (256 x 1,024).
FAMILY_TRAIN_FLASH = [("granite-moe-16-8-d64", 2048, 16, 8, 64, True, 0),
                      ("zamba2-window4096-d80", 4608, 32, 32, 80, True, 4096),
                      ("hubert-bidir-d80", 1024, 16, 16, 80, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAMILY_TRAIN_FLASH,
                         ids=[c[0] for c in FAMILY_TRAIN_FLASH])
def test_flash_fwd_bwd_at_family_training_shapes(cuda_device, case):
    """#11 and #12 against their plain versions at the families' training
    shapes in bf16 (the tolerances of the grid above); #12 twice,
    bit-equal."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    _, s, h, hk, dh, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(s + h + dh)
    q, k, v, do = (torch.randn((1, s, n, dh), generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for n in (h, hk, hk, h))
    kw = dict(causal=causal, window=window, block_q=256, block_kv=1024)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    got = flash_attention_bwd(q, k, v, want, want_lse, do, **kw)
    again = flash_attention_bwd(q, k, v, want, want_lse, do, **kw)
    ref = flash_attention_bwd_plain(q, k, v, want, want_lse, do, **kw)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, ref):
        assert torch.equal(g, a), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=2e-2 * float(w.float().abs().max()), msg=name)


@pytest.mark.cuda
def test_dp_and_mesh_steps_at_world_size_one_nccl(cuda_device):
    """A one-process NCCL group on a 1 x 1 mesh: the DP step's exact twin
    and the `--mesh debug` sharded step equal the single-device step bit
    for bit (stablelm-1.6b reduced, float32, the flash kernels); the
    compressed step's loss falls."""
    import dataclasses
    import socket

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training import (OptimizerConfig, init_train_state,
                                      make_train_step)
    from repro_torch.training.dp_step import (
        make_dp_train_step_compressed, make_sharded_train_step)
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="float32", use_flash_kernel=True)
    opt = OptimizerConfig(peak_lr=1e-3, total_steps=10, warmup_steps=0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)

        def fresh():
            return init_train_state(cfg, init_params(
                cfg, 0, device=cuda_device, param_dtype=torch.float32))
        ref, dp, comp = fresh(), fresh(), fresh()
        sharded, _ = ltrain.sharded_state(cfg, 0, mesh, cuda_device)
        ref_step = make_train_step(cfg, opt)
        dp_step = make_dp_train_step_compressed(cfg, opt, mesh,
                                                compress=False)
        c_step = make_dp_train_step_compressed(cfg, opt, mesh)
        s_step = make_sharded_train_step(cfg, opt, mesh)
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        batch = make_lm_batch(cfg, 4, 64, 0, 0)
        losses = []
        for _ in range(3):
            ref, mr = ref_step(ref, batch)
            dp, md = dp_step(dp, batch, gen)
            sharded, ms = s_step(sharded, batch)
            comp, mc = c_step(comp, batch, gen)
            assert torch.equal(mr["loss"], md["loss"])
            assert torch.equal(mr["loss"], ms["loss"])
            losses.append(float(mc["loss"]))
        full = dict(sharded.params.named_parameters())
        for (n, p), q in zip(ref.params.named_parameters(),
                             dp.params.parameters()):
            assert torch.equal(p, q), n
            assert torch.equal(p, full[n].full_tensor()), n
        assert losses[-1] < losses[0]
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ flash attention backward (#12)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_GRID, ids=[c[0] for c in FLASH_GRID])
def test_flash_attention_bwd_vs_plain(cuda_device, case, dtype):
    """#12 against its plain version (the Pallas backward's block loops at
    64 x 64) on the forward's grid: groups 1, 2 and 9, Dh 32/64/80/128, ragged
    lengths, windows, q_offset with Sq < Skv and rows that see no key
    (their dq is 0 in both); a second launch is bit-equal."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_plain)
    q, k, v = _flash_inputs(case, dtype, cuda_device)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    causal, window, q_offset = case[7:]
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=64,
              block_kv=64)
    o, lse = flash_attention_fwd_plain(q, k, v, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    for name, g, a, w, like in zip(("dq", "dk", "dv"), got, again, want,
                                   (q, k, v)):
        assert g.dtype == dtype and g.shape == like.shape, name
        assert torch.equal(g, a), name
        tol = FLASH_TOL[dtype]["rtol"]     # 1e-4 (f32) or 2e-2 (bf16)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * float(w.float().abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_flash_autograd_vs_blockwise(cuda_device):
    """The autograd Function (#11 forward, #12 backward) against torch
    autograd of blockwise_attention, float32, GQA group 9, Dh 128, q,
    k and v views of one fused projection: rtol 1e-4, atol 1e-5."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.models.attention import blockwise_attention
    b, s, h, hk, dh = 2, 192, 9, 1, 128
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn((b, s, (h + 2 * hk) * dh), generator=gen,
                      device=cuda_device)
    ct = torch.randn((b, s, h, dh), generator=gen, device=cuda_device)
    grads = []
    for use_kernel in (True, False):
        x = qkv.clone().requires_grad_()
        q = x[..., :h * dh].view(b, s, h, dh)
        k = x[..., h * dh:(h + hk) * dh].view(b, s, hk, dh)
        v = x[..., (h + hk) * dh:].view(b, s, hk, dh)
        n11, n12 = flash_attention_fwd.launches, flash_attention_bwd.launches
        if use_kernel:
            out = flash_attention(q, k, v, causal=True, window=100)
        else:
            out = blockwise_attention(q, k, v, causal=True, window=100,
                                      q_chunk=64, kv_chunk=64)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches - n11 == int(use_kernel)
        assert flash_attention_bwd.launches - n12 == int(use_kernel)
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_backward_launch_counts(cuda_device, remat):
    """loss_fn + backward at a reduced minicpm (2 layers, bf16 compute on
    float32 masters, the flash path): #11 once per layer (twice with remat
    "full": the forward and the recompute), #12 once per layer, #10 never;
    the gradients match the blockwise path's (cosine >= 0.999)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.models.model import init_params, loss_fn
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              dtype="bfloat16", use_flash_kernel=True,
                              remat=remat)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen,
                         device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = []
    for flash in (True, False):
        params = init_params(dataclasses.replace(cfg, use_flash_kernel=flash),
                             0, device=cuda_device, param_dtype=torch.float32)
        params.requires_grad_(True)
        counters = (flash_attention, flash_attention_fwd, flash_attention_bwd)
        before = [c.launches for c in counters]
        loss, _ = loss_fn(params, dataclasses.replace(
            cfg, use_flash_kernel=flash), batch)
        loss.backward()
        torch.cuda.synchronize()
        launched = [c.launches - b_ for c, b_ in zip(counters, before)]
        layers = cfg.num_layers
        want = ([0, layers * (2 if remat == "full" else 1), layers] if flash
                else [0, 0, 0])
        assert launched == want, (flash, launched)
        assert all(p.grad.dtype == torch.float32 for p in params.parameters())
        flat.append(torch.cat([p.grad.flatten() for p in params.parameters()]))
    cos = torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0)
    assert float(cos) >= 0.999


@pytest.mark.cuda
def test_stablelm_3b_gradients_flash_vs_blockwise(cuda_device):
    """Two layers of stablelm-3b at full width (d_model 2,560, 32 heads of
    Dh 80), float32 masters, bf16 compute, B=1, S=2,048: the gradients of
    loss_fn through the flash kernels (#11, #12 at Dh 80) against the
    blockwise path's, cosine >= 0.999 over all parameters, the loss within
    1e-3 (relative), as chip_smoke.py phase 9 (c) holds minicpm-2b."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.models.model import init_params, loss_fn
    cfg = dataclasses.replace(get_config("stablelm-3b"), num_layers=2,
                              use_flash_kernel=True)
    assert cfg.head_dim == 80
    params = init_params(cfg, 0, device=cuda_device,
                         param_dtype=torch.float32)
    params.requires_grad_(True)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=gen,
                         device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for flash in (True, False):
        n11, n12 = flash_attention_fwd.launches, flash_attention_bwd.launches
        loss, _ = loss_fn(params, dataclasses.replace(
            cfg, use_flash_kernel=flash), batch)
        loss.backward()
        torch.cuda.synchronize()
        launched = (flash_attention_fwd.launches - n11,
                    flash_attention_bwd.launches - n12)
        assert launched == ((2 * cfg.num_layers, cfg.num_layers) if flash
                            else (0, 0)), launched
        out.append((float(loss.detach()), torch.cat(
            [p.grad.flatten() for p in params.parameters()])))
        params.zero_grad(set_to_none=True)
    (loss_k, g_k), (loss_b, g_b) = out
    assert abs(loss_k - loss_b) <= 1e-3 * abs(loss_b)
    cos = torch.nn.functional.cosine_similarity(g_k, g_b, dim=0)
    assert float(cos) >= 0.999


# ------------------------------------------- plans: captured CUDA graphs
PLAN_BUCKETS = (1, 8, 32, 128)
PLAN_LANES = {
    "quant": dict(quantized=True, use_kernels=True),
    "exact": dict(quantized=False),
}
PLAN_FILTERS = {"nofilter": {}, "exclude": dict(filter=(1, 2),
                                                filter_mode="exclude"),
                "traverse": dict(filter=(0, 3), filter_mode="traverse")}
PLAN_PARAMS = dict(degree_bound=24, beam_width=32, max_iters=48, rev_cap=24)


def _plan_index(rng, n=4096, d=32, labels=True, capacity=None):
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    idx = JasperIndex(d, capacity or n, quantization="rabitq",
                      construction=ConstructionParams(**PLAN_PARAMS))
    idx.build(rng.normal(size=(n, d)).astype(np.float32),
              labels=rng.integers(0, 4, n) if labels else None)
    return idx


@pytest.fixture(scope="module")
def plan_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    rng = np.random.default_rng(21)
    idx = _plan_index(rng)
    idx.delete(np.sort(rng.choice(4096, 300, replace=False)))
    queries = rng.normal(size=(128, 32)).astype(np.float32)
    return idx, queries


def _eager(idx, q, spec):
    """The same search run eagerly on the index's core."""
    from repro_torch.core.index_core import core_search
    return core_search(idx.core, idx._prep_query(q), spec=spec.resolve(idx),
                       filter_tombstones=idx._filter_tombstones,
                       filter_bytes=spec.filter_bytes())


def _assert_same(res, eager):
    assert torch.equal(res.ids, eager[0]) and torch.equal(res.dists, eager[1])
    assert torch.equal(res.n_hops, eager[2])
    if len(eager) > 3:
        for a, b in zip(res.telemetry, eager[3]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("filt", list(PLAN_FILTERS))
@pytest.mark.parametrize("telemetry", ["off", "on"])
@pytest.mark.parametrize("lane", list(PLAN_LANES))
@pytest.mark.parametrize("bucket", PLAN_BUCKETS)
def test_plan_replay_equals_eager(plan_index, bucket, lane, telemetry, filt):
    """A megakernel plan is a captured CUDA graph; its replays equal an
    eager `core_search` bit for bit (ids, dists, hops, telemetry), and a
    second search is a cache hit with no new trace."""
    from repro_torch.core.plans import GraphPlan
    from repro_torch.core.search_spec import SearchSpec
    idx, queries = plan_index
    spec = SearchSpec(k=10, beam_width=48, fusion="megakernel",
                      telemetry=telemetry, **PLAN_LANES[lane],
                      **PLAN_FILTERS[filt])
    q = queries[:bucket]
    ses = idx.searcher(spec)
    first = ses.search(q)
    plan = idx._search_plan(ses.resolved, (bucket, 32), idx._filter_tombstones)
    assert isinstance(plan, GraphPlan) and plan._graph is not None
    mid = idx.plans.stats.snapshot()
    second = ses.search(q)
    assert idx.plans.stats.traces == mid.traces
    eager = _eager(idx, q, spec)
    _assert_same(first, eager)
    _assert_same(second, eager)
    assert not idx.tombstoned(first.ids[first.ids >= 0].cpu().numpy()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("lane", list(PLAN_LANES))
def test_plan_counts_the_launches_of_an_eager_search(plan_index, lane):
    """One search through a plan — the capturing one and each replay —
    counts what one eager search counts: #1 once, and #2 once for the
    quantized rerank."""
    from repro_torch.core.plans import launch_counters
    from repro_torch.core.search_spec import SearchSpec
    idx, queries = plan_index
    spec = SearchSpec(k=10, beam_width=40, fusion="megakernel",
                      **PLAN_LANES[lane])
    want = {n: 0 for n in launch_counters()}
    want["fused_search"] = 1
    want["gather_l2"] = 1 if lane == "quant" else 0
    ses = idx.searcher(spec)
    for _ in range(3):
        for w in launch_counters().values():
            w.launches = 0
        ses.search(queries[:8])
        assert {n: w.launches for n, w in launch_counters().items()} == want
    for w in launch_counters().values():
        w.launches = 0
    _eager(idx, queries[:8], spec)
    assert {n: w.launches for n, w in launch_counters().items()} == want


@pytest.mark.cuda
def test_eager_main_search_under_the_analyzer(plan_index):
    """The eager main search (4-bit megakernel + exact rerank) under
    `roofline.op_analyzer.OpAnalyzer`: #1 reported once and #2 once, each
    launched once as without the analyzer, the results unchanged, and
    #1's formula fed by the telemetry's hops and scored candidates."""
    from repro_torch.core.plans import launch_counters
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.roofline import kernel_costs
    from repro_torch.roofline.op_analyzer import OpAnalyzer
    idx, queries = plan_index
    spec = SearchSpec(k=10, beam_width=40, fusion="megakernel",
                      telemetry="on", **PLAN_LANES["quant"])
    want = _eager(idx, queries, spec)
    for w in launch_counters().values():
        w.launches = 0
    with OpAnalyzer() as ana:
        got = _eager(idx, queries, spec)
    launched = {n: w.launches for n, w in launch_counters().items()}
    assert launched == {n: int(n in ("fused_search", "gather_l2"))
                        for n in launch_counters()}
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    kernels = ana.analyze()["kernels"]
    assert {n: k["calls"] for n, k in kernels.items()} == {
        "fused_search": 1, "gather_l2": 1}
    core, q = idx.core, queries.shape[0]
    p = core.codes.packed.shape[1]
    tel = got[3]
    cost = kernel_costs.fused_search(
        q, 40, core.degree_bound, p, 8, p * 8 // core.codes.bits,
        hops=float(got[2].sum()), scored=float(tel.scored.sum()))
    assert kernels["fused_search"]["bytes"] == cost.bytes
    assert kernels["fused_search"]["flops"] == cost.flops


@pytest.mark.cuda
def test_plan_follows_mutations_without_recapture(cuda_device):
    """After a delete, an insert and a consolidate a replay equals an
    eager search bit for bit, returns no tombstoned id and captures
    nothing new; a grow recaptures exactly once."""
    from repro_torch.core.search_spec import SearchSpec
    rng = np.random.default_rng(22)
    idx = _plan_index(rng, labels=False, capacity=8192)
    idx.delete(np.arange(5))                      # the liveness mode: on
    q = rng.normal(size=(32, 32)).astype(np.float32)
    specs = [SearchSpec(k=10, beam_width=48, fusion="megakernel", **kw)
             for kw in PLAN_LANES.values()]
    for spec in specs:
        idx.searcher(spec).search(q)
    base = idx.plans.stats.snapshot()

    def check(step):
        for spec in specs:
            res = idx.searcher(spec).search(q)
            _assert_same(res, _eager(idx, q, spec))
            assert not idx.tombstoned(res.ids[res.ids >= 0].cpu().numpy()
                                      ).any(), step
        assert idx.plans.stats.traces == base.traces, step

    idx.delete(np.arange(100, 500))
    check("delete")
    idx.insert(rng.normal(size=(200, 32)).astype(np.float32))
    check("insert")
    idx.consolidate()
    check("consolidate")
    idx.insert(rng.normal(size=(300, 32)).astype(np.float32))
    check("insert into freed slots")
    cap = idx.capacity
    idx.insert(rng.normal(size=(cap, 32)).astype(np.float32))
    assert idx.capacity > cap
    for spec in specs:
        res = idx.searcher(spec).search(q)
        _assert_same(res, _eager(idx, q, spec))
    assert idx.plans.stats.traces == base.traces + len(specs)


@pytest.mark.cuda
def test_submit_insert_drain_reads_the_submit_snapshot(cuda_device):
    """submit, insert, drain: the drained results equal the search before
    the insert and carry its generation."""
    from repro_torch.core.search_spec import SearchSpec
    rng = np.random.default_rng(23)
    idx = _plan_index(rng, labels=False, capacity=8192)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    new = np.repeat(q, 4, axis=0) + 1e-3      # rows right at the queries
    ses = idx.searcher(SearchSpec(k=10, beam_width=48, quantized=True,
                                  use_kernels=True, fusion="megakernel"))
    before = ses.search(q)
    gen = idx.generation
    for _ in range(4):
        ses.submit(q)
    idx.insert(new)
    out = ses.drain()
    after = ses.search(q)
    assert idx.generation > gen
    for r in out:
        assert r.generation == gen
        assert np.array_equal(r.ids, before.ids.cpu().numpy())
        assert np.array_equal(r.dists, before.dists.cpu().numpy())
    assert not torch.equal(after.ids, before.ids)     # the insert shows


@pytest.mark.cuda
def test_scheduler_harvests_through_cuda_events(plan_index):
    """The scheduler's batches are ready when their CUDA event is, and a
    coalesced batch equals the same queries dispatched one at a time."""
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.serving.scheduler import StandingQueryScheduler
    idx, queries = plan_index
    spec = SearchSpec(k=10, beam_width=48, quantized=True, use_kernels=True,
                      fusion="megakernel")
    sched = StandingQueryScheduler(idx, spec, buckets=(1, 8),
                                   slo_budget_s=10.0)
    handles = [sched.submit(q) for q in queries[:5]]
    sched.poll()
    (inflight,) = sched._inflight
    assert isinstance(inflight.batch._pending._event, torch.cuda.Event)
    torch.cuda.synchronize()
    assert inflight.batch.ready()
    sched.drain()
    for i, h in enumerate(handles):
        solo = StandingQueryScheduler(idx, spec, buckets=(8,),
                                      slo_budget_s=10.0)
        solo.submit(queries[i])
        (s,) = solo.drain()
        assert h.status == "done"
        assert np.array_equal(h.ids, s.ids) and np.array_equal(h.dists,
                                                               s.dists)


# ------------------------------------------- the host rows tier on the card
HOST_TIER_LANES = {
    "megakernel": dict(use_kernels=True, fusion="megakernel"),
    "megakernel-telemetry": dict(use_kernels=True, fusion="megakernel",
                                 telemetry="on"),
    "megakernel-filtered": dict(use_kernels=True, fusion="megakernel",
                                filter=(1, 2), filter_mode="exclude"),
    "hop": dict(use_kernels=True, fusion="hop"),
    "merge-kernel": dict(use_kernels=True, fusion="none", merge="kernel"),
}


def _host_spec(lane, **kw):
    from repro_torch.core.search_spec import SearchSpec
    return SearchSpec(k=10, beam_width=48, quantized=True,
                      **HOST_TIER_LANES[lane], **kw)


@pytest.fixture(scope="module")
def host_tier_index():
    """An index, each lane's device-tier eager result, then the same
    index with its rows evicted to pinned host memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    rng = np.random.default_rng(24)
    idx = _plan_index(rng, capacity=8192)
    idx.delete(np.sort(rng.choice(4096, 300, replace=False)))
    queries = rng.normal(size=(2, 64, 32)).astype(np.float32)
    device = {(lane, b): _eager(idx, queries[b], _host_spec(lane))
              for lane in HOST_TIER_LANES for b in range(2)}
    idx.evict_rows_to_host()
    return idx, queries, device


@pytest.mark.cuda
@pytest.mark.parametrize("lane", list(HOST_TIER_LANES))
def test_host_tier_replay_equals_device_eager(host_tier_index, lane):
    """A host-tier search (the traversal plan, the rows' gather, the
    captured rerank plan) equals the device tier's eager search bit for
    bit, capture and replay alike; the megakernel lane counts #1 1 + #2 1
    a search and its rerank stage is a captured graph."""
    from repro_torch.core.plans import (GraphPlan, HostRerankPlan,
                                        HostTierPlan, launch_counters)
    idx, queries, device = host_tier_index
    assert idx.core.vectors is None and idx.store._vectors.is_pinned()
    spec = _host_spec(lane, rerank_source="host")
    ses = idx.searcher(spec)
    for _ in range(2):
        for w in launch_counters().values():
            w.launches = 0
        res = ses.search(queries[0])
        _assert_same(res, device[(lane, 0)])
        launched = {n: w.launches for n, w in launch_counters().items()
                    if w.launches}
        assert launched.get("gather_l2") == 1
        if lane.startswith("megakernel"):
            assert launched == {"fused_search": 1, "gather_l2": 1}
    plan = idx._search_plan(ses.resolved, (64, 32), idx._filter_tombstones)
    assert isinstance(plan, HostTierPlan)
    assert isinstance(plan.rerank, HostRerankPlan)
    assert plan.rerank._graph is not None
    assert isinstance(plan.traversal, GraphPlan) == lane.startswith(
        "megakernel")


@pytest.mark.cuda
def test_host_tier_staging_buffer_survives_back_to_back_batches(
        host_tier_index):
    """Two batches of different queries submitted back to back reuse one
    pinned staging buffer; each drained result equals its own device-tier
    eager search (the second gather never overwrote rows the first
    batch's copy still read)."""
    idx, queries, device = host_tier_index
    ses = idx.searcher(_host_spec("megakernel", rerank_source="host"))
    for _ in range(2):
        for b in range(2):
            ses.submit(queries[b])
        out = ses.drain()
        for b, r in enumerate(out):
            want = device[("megakernel", b)]
            assert np.array_equal(r.ids, want[0].cpu().numpy())
            assert np.array_equal(r.dists, want[1].cpu().numpy())


@pytest.mark.cuda
def test_host_tier_staged_churn_keeps_both_stages(cuda_device):
    """Delete, insert and consolidate on a host-tier index recapture
    neither stage and keep the tiers in sync: host == device bit for bit
    after the churn."""
    rng = np.random.default_rng(25)
    idx = _plan_index(rng, labels=False, capacity=8192)
    idx.evict_rows_to_host()
    idx.delete(np.arange(5))
    q = rng.normal(size=(32, 32)).astype(np.float32)
    ses = idx.searcher(_host_spec("megakernel", rerank_source="host"))
    ses.search(q)
    base = idx.plans.stats.snapshot()
    idx.delete(np.arange(100, 500))
    ses.search(q)
    idx.insert(rng.normal(size=(200, 32)).astype(np.float32))
    ses.search(q)
    idx.consolidate()
    host = ses.search(q)
    assert idx.plans.stats.delta(base)["traces"] == 0
    assert idx.vectors is None and idx.rows_tier == "host"
    ids = host.ids.cpu().numpy()
    assert not idx.tombstoned(ids[ids >= 0]).any()
    idx.restore_rows_to_device()
    _assert_same(host, _eager(idx, q, _host_spec("megakernel")))


@pytest.mark.cuda
def test_evict_frees_the_device_rows(cuda_device):
    """Eviction releases the rows' device memory, captured device-tier
    plans included; restore brings them back, equal bit for bit."""
    import gc
    rng = np.random.default_rng(26)
    cap, d = 65536, 128
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    idx = JasperIndex(d, cap, quantization="rabitq",
                      construction=ConstructionParams(**PLAN_PARAMS))
    idx.build(rng.normal(size=(2048, d)).astype(np.float32))
    q = rng.normal(size=(16, d)).astype(np.float32)
    idx.searcher(_host_spec("megakernel")).search(q)   # a captured plan
    rows = idx.vectors.clone()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    idx.evict_rows_to_host()
    gc.collect()
    after = torch.cuda.memory_allocated()
    assert before - after >= 0.95 * cap * (d + 1) * 4
    ms = idx.memory_stats()
    assert ms["device_rows_bytes"] == 0.0
    assert ms["host_rows_bytes"] == cap * (d + 1) * 4
    idx.restore_rows_to_device()
    assert torch.equal(idx.vectors, rows)


# ------------------------------------------------------ the sharded index
SHARDED_LANES = {
    "quant": dict(quantized=True, use_kernels=True),
    "quant-telemetry": dict(quantized=True, use_kernels=True,
                            telemetry="on"),
    "quant-filtered": dict(quantized=True, use_kernels=True, filter=(1,),
                           filter_mode="exclude"),
    "exact": dict(quantized=False),
}


def _sharded_index(rng, per=1536, d=32, cap=2048):
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh
    idx = ShardedJasperIndex(make_mesh((4,), ("data",)), d, cap,
                             quantization="rabitq",
                             construction=ConstructionParams(**PLAN_PARAMS))
    idx.build(rng.normal(size=(4 * per, d)).astype(np.float32),
              labels=rng.integers(0, 4, 4 * per))
    return idx


def _sharded_eager(idx, q, spec):
    """The same sharded search run eagerly: every shard's core_search on
    its slices, then the merge."""
    return idx._plan_search(idx.core, idx._prep_query(q), spec.resolve(idx),
                            idx._filter_tombstones, spec.filter_bytes(),
                            mirrors=False)


@pytest.fixture(scope="module")
def sharded_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    rng = np.random.default_rng(31)
    idx = _sharded_index(rng)
    idx.delete(np.arange(0, 4 * idx.id_stride, 13)[
        ~idx.tombstoned(np.arange(0, 4 * idx.id_stride, 13))])
    return idx, rng.normal(size=(64, 32)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", list(SHARDED_LANES))
def test_sharded_plan_replay_equals_eager(sharded_index, lane):
    """A megakernel search over four shards and their merge is ONE
    captured graph; its replays equal the eager sharded search bit for
    bit, and each counts #1 four times (and #2 four times quantized)."""
    from repro_torch.core.plans import GraphPlan, launch_counters
    from repro_torch.core.search_spec import SearchSpec
    idx, q = sharded_index
    spec = SearchSpec(k=10, beam_width=48, fusion="megakernel",
                      **SHARDED_LANES[lane])
    ses = idx.searcher(spec)
    want = {n: 0 for n in launch_counters()}
    want["fused_search"] = 4
    want["gather_l2"] = 4 if spec.quantized else 0
    for _ in range(3):
        for w in launch_counters().values():
            w.launches = 0
        res = ses.search(q)
        assert {n: w.launches for n, w in launch_counters().items()} == want
        _assert_same(res, _sharded_eager(idx, q, spec))
    plan = idx._search_plan(ses.resolved, (64, 32), idx._filter_tombstones)
    assert isinstance(plan, GraphPlan) and plan._graph is not None
    ids = res.ids.cpu().numpy()
    assert not idx.tombstoned(ids[ids >= 0]).any()


@pytest.mark.cuda
def test_sharded_plan_follows_mutations_without_recapture(cuda_device):
    """Sharded delete, insert and consolidate recapture nothing (the
    shards write into the stacked buffers, the mirrors carry n_valid and
    medoid); a grow recaptures once a spec."""
    from repro_torch.core.search_spec import SearchSpec
    rng = np.random.default_rng(32)
    idx = _sharded_index(rng, per=1024, cap=1280)
    idx.delete(np.arange(5))
    q = rng.normal(size=(32, 32)).astype(np.float32)
    specs = [SearchSpec(k=10, beam_width=48, fusion="megakernel", **kw)
             for kw in (SHARDED_LANES["quant"], SHARDED_LANES["exact"])]
    for spec in specs:
        idx.searcher(spec).search(q)
    base = idx.plans.stats.snapshot()

    def check(step, traces):
        for spec in specs:
            res = idx.searcher(spec).search(q)
            _assert_same(res, _sharded_eager(idx, q, spec))
            ids = res.ids.cpu().numpy()
            assert not idx.tombstoned(ids[ids >= 0]).any(), step
        assert idx.plans.stats.traces == base.traces + traces, step

    idx.delete(np.arange(100, 600))               # all on shard 0
    check("delete", 0)
    idx.insert(rng.normal(size=(4 * 50, 32)).astype(np.float32))
    check("insert", 0)
    idx.consolidate()
    check("consolidate", 0)
    idx.insert(rng.normal(size=(4 * 300, 32)).astype(np.float32))  # grows
    assert idx.cap == 2560
    check("grow", len(specs))


@pytest.mark.cuda
def test_sharded_host_tier_equals_device_tier(cuda_device):
    """The sharded host tier (one gather a search, a captured rerank that
    merges the shards) equals the device tier bit for bit."""
    from repro_torch.core.search_spec import SearchSpec
    rng = np.random.default_rng(33)
    idx = _sharded_index(rng)
    idx.delete(np.arange(0, 900, 7))
    q = rng.normal(size=(64, 32)).astype(np.float32)
    lanes = {"megakernel": dict(fusion="megakernel"),
             "telemetry": dict(fusion="megakernel", telemetry="on"),
             "hop": dict(fusion="hop"),
             "merge-kernel": dict(merge="kernel")}

    def spec(kw, source):
        return SearchSpec(k=10, beam_width=48, quantized=True,
                          use_kernels=True, rerank_source=source, **kw)

    device = {n: idx.searcher(spec(kw, "device")).search(q)
              for n, kw in lanes.items()}
    idx.evict_rows_to_host()
    for _ in range(2):
        for n, kw in lanes.items():
            res = idx.searcher(spec(kw, "host")).search(q)
            d = device[n]
            _assert_same(res, (d.ids, d.dists, d.n_hops)
                         + ((d.telemetry,) if d.telemetry is not None else ()))


# ------------------------------------------ the sharded index on positions
def _positions_pair(rng, devices, per=1536, d=32, cap=2048,
                    shape=(4,), axes=("data",)):
    """The same 4-shard index on one device and on a mesh of positions on
    `devices`, built from the same rows — a tensor on cuda:0, so both
    train the quantizer there (a mesh of several positions trains it
    where the rows lie)."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh
    data = torch.as_tensor(rng.normal(size=(4 * per, d)).astype(np.float32),
                           device="cuda:0")
    labels = rng.integers(0, 4, 4 * per)
    return [ShardedJasperIndex(make_mesh(shape, axes, device=dev), d,
                               cap, quantization="rabitq",
                               construction=ConstructionParams(**PLAN_PARAMS))
            .build(data, labels=labels)
            for dev in ("cuda:0", devices)]


def _same_results(a, b) -> bool:
    pa = [a.ids, a.dists, a.n_hops] + list(a.telemetry or ())
    pb = [b.ids, b.dists, b.n_hops] + list(b.telemetry or ())
    return len(pa) == len(pb) and all(torch.equal(x, y)
                                      for x, y in zip(pa, pb))


def _positions_lanes_equal(one, many, q):
    """Every SHARDED_LANES lane and the hop lane: the positions' plan (one
    captured graph a position, #1 and #2 once each a position a search)
    and eager search equal the one-device layout's bit for bit."""
    from repro_torch.core.plans import GraphPlan, PositionsPlan, \
        launch_counters
    from repro_torch.core.search_spec import SearchSpec
    for lane, kw in list(SHARDED_LANES.items()) + [
            ("hop", dict(quantized=True, use_kernels=True, fusion="hop"))]:
        spec = SearchSpec(k=10, beam_width=48,
                          **({"fusion": "megakernel"} | kw))
        want = one.searcher(spec).search(q)
        ses = many.searcher(spec)
        for _ in range(2):
            for w in launch_counters().values():
                w.launches = 0
            res = ses.search(q)
            assert _same_results(res, want), lane
            if spec.fusion == "megakernel":
                got = {n: w.launches for n, w in launch_counters().items()
                       if w.launches}
                assert got == ({"fused_search": 4, "gather_l2": 4}
                               if spec.quantized else {"fused_search": 4})
        plan = many._search_plan(ses.resolved, tuple(q.shape),
                                 many._filter_tombstones)
        assert isinstance(plan, PositionsPlan)
        if spec.fusion == "megakernel":
            assert all(isinstance(g, GraphPlan) and g._graph is not None
                       for g in plan.plans)
        eager = many._eager_search(many._prep_query(q), ses.resolved,
                                   many._filter_tombstones,
                                   spec.filter_bytes())
        _assert_same(want, eager)


@pytest.mark.cuda
def test_sharded_positions_on_one_card(cuda_device):
    """Four positions repeating cuda:0 — each shard in its own buffers,
    one graph a position, the merge gathered home — search, mutate
    (delete / insert / consolidate recapture nothing, a grow once a spec)
    and evict exactly as the stacked layout does."""
    from repro_torch.core.search_spec import SearchSpec
    rng = np.random.default_rng(34)
    one, many = _positions_pair(rng, ["cuda:0"] * 4)
    assert many.n_positions == 4
    for ix in (one, many):
        ix.delete(np.arange(5))       # the liveness mode the steps keep
    q = rng.normal(size=(64, 32)).astype(np.float32)
    _positions_lanes_equal(one, many, q)
    specs = [SearchSpec(k=10, beam_width=48, fusion="megakernel", **kw)
             for kw in (SHARDED_LANES["quant"], SHARDED_LANES["exact"])]
    base = many.plans.stats.snapshot()

    def check(step, traces):
        for spec in specs:
            a = one.searcher(spec).search(q)
            b = many.searcher(spec).search(q)
            assert _same_results(a, b), step
            ids = b.ids.cpu().numpy()
            assert not many.tombstoned(ids[ids >= 0]).any(), step
        assert many.plans.stats.traces == base.traces + traces, step

    check("fresh", 0)
    for ix in (one, many):
        ix.delete(np.arange(100, 600))            # all on shard 0
    check("delete", 0)
    new = rng.normal(size=(4 * 50, 32)).astype(np.float32)
    for ix in (one, many):
        ix.insert(new)
    check("insert", 0)
    for ix in (one, many):
        ix.consolidate()
    check("consolidate", 0)
    new = rng.normal(size=(4 * 600, 32)).astype(np.float32)
    for ix in (one, many):
        ix.insert(new)                            # grows
    assert many.cap == one.cap == 4096
    check("grow", len(specs))
    host = SearchSpec(k=10, beam_width=48, quantized=True, use_kernels=True,
                      fusion="megakernel", rerank_source="host")
    want = one.searcher(host.with_(rerank_source="device")).search(q)
    for ix in (one, many):
        ix.evict_rows_to_host()
    for _ in range(2):
        assert _same_results(many.searcher(host).search(q), want)


@pytest.mark.cuda
def test_sharded_replicas_on_one_card(cuda_device):
    """A (4, 2) ("data", "model") mesh on eight positions of cuda:0: two
    replicas a shard, each searching half of the queries. Every mutation
    runs on each replica, which then equals the one-device layout's shard
    tensor for tensor, and the searches stay bit-equal."""
    from repro_torch.core.distributed import _row_tensors
    from repro_torch.core.search_spec import SearchSpec
    rng = np.random.default_rng(36)
    one, many = _positions_pair(rng, ["cuda:0"] * 8, shape=(4, 2),
                                axes=("data", "model"))
    assert many.n_positions == 8 and len(many.searching_positions()) == 8
    q = rng.normal(size=(64, 32)).astype(np.float32)
    specs = [SearchSpec(k=10, beam_width=48, fusion="megakernel", **kw)
             for kw in (SHARDED_LANES["quant"], SHARDED_LANES["exact"])]

    def check(step):
        for s in range(4):
            want = _row_tensors(one.shard_core(s))
            for rep in many.shard_replicas(s):
                assert all(a is None and b is None or torch.equal(a, b)
                           for a, b in zip(_row_tensors(rep), want)), step
        for spec in specs:
            a = one.searcher(spec).search(q)
            b = many.searcher(spec).search(q)
            assert _same_results(a, b), step

    check("build")
    new = rng.normal(size=(4 * 64, 32)).astype(np.float32)
    for ix in (one, many):
        ix.insert(new)
    check("insert")
    for ix in (one, many):
        ix.delete(np.arange(100, 400))
    check("delete")
    for ix in (one, many):
        ix.consolidate()
    check("consolidate")


@pytest.mark.cuda
def test_sharded_positions_on_four_cards(cuda_device):
    """The four shards on cuda:0..3: each position's kernels on its own
    card, the merge on cuda:0, bit-equal to the stacked layout."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    rng = np.random.default_rng(35)
    one, many = _positions_pair(rng, [f"cuda:{i}" for i in range(4)])
    assert [str(d) for d in many.position_devices()] == [
        f"cuda:{i}" for i in range(4)]
    assert many.shard_core(3).adjacency.device == torch.device("cuda:3")
    q = rng.normal(size=(64, 32)).astype(np.float32)
    _positions_lanes_equal(one, many, q)


@pytest.mark.cuda
def test_wrappers_refuse_operands_on_two_devices(cuda_device):
    """A kernel wrapper whose operands lie on more than one device raises
    (here the card and the CPU) and launches nothing."""
    from repro_torch.kernels.distance.ops import gather_l2, pairwise_l2
    from repro_torch.kernels.rabitq_dot.ops import rabitq_distance
    from repro_torch.kernels.topk.ops import topk
    dev = torch.device("cuda")
    q = torch.zeros((4, 32), device=dev)
    table = torch.zeros((16, 32), device=dev)
    cases = {
        "gather_l2": lambda: gather_l2(q, table, torch.zeros(16), torch.zeros(
            (4, 8), dtype=torch.int32, device=dev)),
        "pairwise_l2": lambda: pairwise_l2(q, table.cpu()),
        "topk": lambda: topk(torch.zeros((4, 32), device=dev),
                             torch.zeros((4, 32), dtype=torch.int32), 4),
        "rabitq_distance": lambda: rabitq_distance(
            torch.zeros((16, 16), dtype=torch.uint8, device=dev),
            torch.zeros(16, device=dev), torch.zeros(16), q,
            torch.zeros(4, device=dev), torch.zeros(4, device=dev), bits=4),
    }
    for name, fn in cases.items():
        before = {n: getattr(w, "launches", 0) for n, w in
                  (("w", gather_l2), ("p", pairwise_l2), ("t", topk),
                   ("r", rabitq_distance))}
        with pytest.raises(ValueError, match="one device expected"):
            fn()
        after = {n: getattr(w, "launches", 0) for n, w in
                 (("w", gather_l2), ("p", pairwise_l2), ("t", topk),
                  ("r", rabitq_distance))}
        assert before == after, name


# ------------------------------------------------------------ the examples
@pytest.mark.cuda
def test_example_churn_launches_the_search_kernels(cuda_device,
                                                   monkeypatch):
    """streaming_updates' churn at its --quick sizes on the card with the
    main path's spec: the megakernel (#1) and the exact rerank (#2) once a
    search and no other kernel; the example itself asserts zero tombstoned
    ids each tick; recall@10 >= 0.85."""
    from repro_torch.core.plans import launch_counters
    from repro_torch.core.search_spec import Searcher
    from repro_torch.examples import streaming_updates as su
    spec = su.SERVE_SPEC.with_(use_kernels=True, fusion="megakernel",
                               rerank_source="device")
    searches = []
    dispatch = Searcher._dispatch

    def counted(self, queries):
        searches.append(self.resolved)
        return dispatch(self, queries)
    monkeypatch.setattr(Searcher, "_dispatch", counted)
    counters = launch_counters()
    for w in counters.values():
        w.launches = 0
    out = su.run_churn(n0=600, rounds=3, batch=60, dims=64, quick=True,
                       device=cuda_device, spec=spec)
    torch.cuda.synchronize()
    launched = {n: w.launches for n, w in counters.items()}
    n = len(searches)
    assert n == 2 * 3 + 2
    assert launched == {name: (n if name in ("fused_search", "gather_l2")
                               else 0) for name in counters}, launched
    assert all(r["recall"] >= 0.85 for r in out["rows"]), out["rows"]
    assert [r["size"] for r in out["rows"]] == [600] * 3
