"""The search slice as a whole: the port against the JAX package.

One JAX-built index (N=2048, D=32, R=16, 4-bit RaBitQ — the conformance
suite's shape) crosses into the port through `core_to_arrays` ->
`core_from_arrays`, so both packages search the same graph, codes and
rotation. `core_search` then runs in both over {megakernel, hop, none,
merge-kernel} x {quantized, exact} x {kernels, plain} (the conformance
suite's lanes; "merge-kernel" is the unfused loop at merge="kernel"),
clean and with tombstones, held to the conformance bars
(tests/test_conformance.py): id agreement >= 0.95, dists rtol 1e-3 /
atol 1e-2, recall >= 0.75 at beam 48 and k=10, and zero tombstoned ids.

Also: `SearchSpec.resolve` and its JSON are equal to the JAX ones over a
grid (bit-exact), checkpoints cross both ways byte-equal, and the port's
fused path equals its unfused loop bit for bit (the oracle contract).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search_spec as jss
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro.core.index_core import core_search as j_core_search
from repro.core.index_core import core_to_arrays as j_to_arrays
from repro_torch.core import search_spec as tss
from repro_torch.core.index import JasperIndex as TIndex
from repro_torch.core.index_core import core_from_arrays, core_search
from repro_torch.core.index_core import core_to_arrays as t_to_arrays

jbs = importlib.import_module("repro.core.beam_search")

SEED = 321
N, D, Q, K, BEAM = 2048, 32, 64, 10, 48
N_DELETE = 200
MIN_RECALL = 0.75
ID_AGREEMENT = 0.95
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)

LANES = {"megakernel": dict(fusion="megakernel"), "hop": dict(fusion="hop"),
         "none": dict(fusion="none"),
         "merge-kernel": dict(fusion="none", merge="kernel")}
CELLS = [(lane, quantized, kernels)
         for lane in LANES
         for quantized in (True, False)
         for kernels in (True, False)]
CELL_IDS = [f"{f}-{'rabitq' if q else 'exact'}-{'kernel' if k else 'plain'}"
            for f, q, k in CELLS]


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


def _recall(ids, gt):
    return float(np.mean([len(set(ids[i]) & set(gt[i])) / gt.shape[1]
                          for i in range(ids.shape[0])]))


def _port_core(jidx):
    return core_from_arrays(j_to_arrays(jidx.core), bits=jidx.bits,
                            store_dims=jidx.store_dims,
                            quantized=jidx.quantization == "rabitq",
                            device="cpu")


@pytest.fixture(scope="module")
def slice_runs():
    """Both packages over every cell, clean and after deletes."""
    rng = np.random.default_rng(SEED)
    data = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    dead = np.sort(rng.choice(N, N_DELETE, replace=False))
    jidx = JIndex(D, N, construction=JParams(**PARAMS),
                  quantization="rabitq", bits=4, seed=SEED)
    jidx.build(data)
    out = {"dead": dead, "queries": queries, "jidx": jidx}
    for tomb in (False, True):
        if tomb:
            jidx.delete(dead)
        core = _port_core(jidx)
        out[("core", tomb)] = core
        gt, _ = jidx.brute_force(queries, K)
        out[("gt", tomb)] = np.asarray(gt)
        for lane, quantized, kernels in CELLS:
            spec = jss.SearchSpec(k=K, beam_width=BEAM, quantized=quantized,
                                  use_kernels=kernels, **LANES[lane])
            rj = j_core_search(jidx.core, jnp.asarray(queries),
                               spec=spec.resolve(), filter_tombstones=tomb)
            rt = core_search(core, torch.as_tensor(queries),
                             spec=tss.SearchSpec(**spec.__dict__).resolve(),
                             filter_tombstones=tomb)
            out[(lane, quantized, kernels, tomb)] = (
                [np.asarray(x) for x in rj], [_np(x) for x in rt])
    return out


@pytest.mark.parametrize("tomb", [False, True], ids=["clean", "tomb"])
@pytest.mark.parametrize("fusion,quantized,kernels", CELLS, ids=CELL_IDS)
def test_core_search_matches_jax(slice_runs, fusion, quantized, kernels,
                                 tomb):
    (j_ids, j_d, j_hops), (t_ids, t_d, t_hops) = slice_runs[
        (fusion, quantized, kernels, tomb)]
    assert t_ids.shape == (Q, K) and t_ids.dtype == np.int32
    agree = float(np.mean(t_ids == j_ids))
    assert agree >= ID_AGREEMENT, agree
    np.testing.assert_allclose(t_d, j_d, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert _recall(t_ids, slice_runs[("gt", tomb)]) >= MIN_RECALL
    assert t_hops.shape == (Q,) and (t_hops > 0).all()
    if tomb:
        assert not np.isin(t_ids, slice_runs["dead"]).any()


def test_brute_force_matches(slice_runs):
    core = slice_runs[("core", True)]
    from repro_torch.core.index_core import core_brute_force
    ids, d = core_brute_force(core, torch.as_tensor(slice_runs["queries"]),
                              k=K, chunk=16)
    assert _recall(_np(ids), slice_runs[("gt", True)]) == 1.0
    assert not np.isin(_np(ids), slice_runs["dead"]).any()


@pytest.mark.parametrize("quantized", [True, False], ids=["rabitq", "exact"])
@pytest.mark.parametrize("mode", ["traverse", "exclude"])
def test_fused_equals_unfused_bit_exact(slice_runs, quantized, mode):
    """The oracle contract inside the port: the megakernel path's plain
    version equals the unfused loop (merge="topk", expand=1) bit for bit —
    ids, dists, hops and telemetry — with tombstones and a label filter."""
    core = slice_runs[("core", True)]
    q = torch.as_tensor(slice_runs["queries"])
    labels = np.random.default_rng(3).integers(0, 4, N)
    from dataclasses import replace
    from repro_torch.core.mutations import pack_label_rows
    # a copy of the shared core with a label plane
    core = replace(core, mut=replace(
        core.mut, labels=torch.as_tensor(pack_label_rows(labels, N))))
    outs = []
    for fusion in ("megakernel", "none"):
        spec = tss.SearchSpec(k=K, beam_width=BEAM, quantized=quantized,
                              fusion=fusion, telemetry="on", filter=(1, 2),
                              filter_mode=mode, traverse_deleted=False,
                              rerank=False)
        rspec = spec.resolve()
        outs.append(core_search(core, q, spec=rspec,
                                filter_bytes=spec.filter_bytes()))
    (ai, ad, ah, at), (bi, bd, bh, bt) = outs
    assert torch.equal(ai, bi) and torch.equal(ad, bd)
    assert torch.equal(ah, bh)
    for x, y in zip(at, bt):
        assert torch.equal(x, y)
    kept = _np(ai)[_np(ai) >= 0]
    assert np.isin(labels[kept], [1, 2]).all()
    assert not np.isin(kept, slice_runs["dead"]).any()


# ------------------------------------------------------------ checkpoints
def test_jax_checkpoint_loads_in_port(slice_runs, tmp_path):
    jidx = slice_runs["jidx"]
    path = os.path.join(tmp_path, "idx.npz")
    jidx.save(path)
    tidx = TIndex.load(path, device="cpu")
    ja, ta = j_to_arrays(jidx.core), t_to_arrays(tidx.core)
    assert sorted(ja) == sorted(ta)
    for key in ja:
        assert ta[key].dtype == ja[key].dtype, key
        assert np.array_equal(ta[key], ja[key]), key
    assert tidx.generation == jidx.generation
    q = slice_runs["queries"]
    ids, _ = tidx.search_rabitq(q, K, beam_width=BEAM)
    assert not np.isin(_np(ids), slice_runs["dead"]).any()
    assert _recall(_np(ids), slice_runs[("gt", True)]) >= MIN_RECALL


def test_port_checkpoint_loads_in_jax(tmp_path):
    rng = np.random.default_rng(SEED + 1)
    data = rng.normal(size=(300, 16)).astype(np.float32)
    from repro_torch.core.construction import ConstructionParams as TParams
    tidx = TIndex(16, 320, quantization="rabitq", bits=2, device="cpu",
                  construction=TParams(**PARAMS))
    tidx.build(data, labels=rng.integers(0, 32, 300))
    path = os.path.join(tmp_path, "port.npz")
    tidx.save(path)
    jidx = JIndex.load(path)
    ta, ja = t_to_arrays(tidx.core), j_to_arrays(jidx.core)
    assert sorted(ja) == sorted(ta)
    for key in ta:
        assert ja[key].dtype == ta[key].dtype, key
        assert np.array_equal(ja[key], ta[key]), key
    with open(path + ".meta.json") as f:
        assert '"rows_tier": "device"' in f.read()


def test_legacy_checkpoint_forms():
    """Unpacked `rq_codes` and a missing label plane load as the JAX
    package loads them."""
    from repro.core.index_core import core_from_arrays as j_from
    rng = np.random.default_rng(4)
    n, d = 24, 8
    arrays = {
        "vectors": rng.normal(size=(n, d)).astype(np.float32),
        "adjacency": rng.integers(-1, n, (n, 4)).astype(np.int32),
        "n_valid": np.asarray(n, np.int32), "medoid": np.asarray(3, np.int32),
        "tombstone_bits": np.zeros(3, np.uint8),
        "free_ids": np.full(n, -1, np.int32),
        "n_free": np.asarray(0, np.int32),
        "n_deleted": np.asarray(0, np.int32),
        "generation": np.asarray(5, np.int32),
        "rq_codes": rng.integers(0, 16, (n, d)).astype(np.uint8),
        "rq_add": rng.random(n).astype(np.float32),
        "rq_rescale": rng.random(n).astype(np.float32),
        "rq_rotation": np.eye(d, dtype=np.float32),
        "rq_centroid": np.zeros(d, np.float32),
    }
    want = j_to_arrays(j_from(arrays, bits=4, store_dims=d, quantized=True))
    got = t_to_arrays(core_from_arrays(arrays, bits=4, store_dims=d,
                                       quantized=True, device="cpu"))
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    bare = {k: arrays[k] for k in ("vectors", "adjacency", "n_valid",
                                   "medoid")}
    want = j_to_arrays(j_from(bare, bits=4, store_dims=d, quantized=False))
    got = t_to_arrays(core_from_arrays(bare, bits=4, store_dims=d,
                                       quantized=False, device="cpu"))
    for key in want:
        assert np.array_equal(got[key], want[key]), key


# -------------------------------------------------------- spec + surface
SPEC_GRID = [
    dict(),
    dict(k=5, beam_width=64),
    dict(quantized=True, rerank=False),
    dict(quantized=True, rerank_source="none", rerank_tile=64),
    dict(quantized=True, use_kernels=True, fusion="megakernel"),
    dict(expand=3, merge="sort", max_iters=17),
    dict(beam_schedule=[48, 32, 16], k=16, fusion="hop"),
    dict(beam_schedule=(40, 20), beam_width=64, telemetry="on"),
    dict(filter=3, filter_mode="exclude"),
    dict(filter=[1, 30], traverse_deleted=False, merge="kernel"),
]
BAD_SPECS = [
    dict(k=0), dict(merge="bogus"), dict(fusion="x"), dict(telemetry="x"),
    dict(filter=[]), dict(filter=40), dict(beam_width=5, k=10),
    dict(beam_schedule=(4,), k=10), dict(rerank_source="host"),
    dict(quantized=True, rerank=False, rerank_source="host"),
    dict(fusion="megakernel", expand=2), dict(k=True),
]


@pytest.mark.parametrize("kw", SPEC_GRID, ids=[str(i) for i in
                                                range(len(SPEC_GRID))])
def test_spec_resolve_and_json_match_jax(kw):
    j, t = jss.SearchSpec(**kw), tss.SearchSpec(**kw)
    assert t.resolve().__dict__ == j.resolve().__dict__
    assert t.to_json() == j.to_json()
    assert tss.SearchSpec.from_json(t.to_json()).__dict__ == \
        jss.SearchSpec.from_json(j.to_json()).__dict__
    assert t.resolve().to_spec().__dict__ == j.resolve().to_spec().__dict__
    fb_t, fb_j = t.filter_bytes(), j.filter_bytes()
    assert (fb_t is None) == (fb_j is None)
    if fb_t is not None:
        assert np.array_equal(fb_t, fb_j)


@pytest.mark.parametrize("kw", BAD_SPECS, ids=[str(i) for i in
                                               range(len(BAD_SPECS))])
def test_spec_rejections_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        jss.SearchSpec(**kw).resolve()
    with pytest.raises(ValueError) as et:
        tss.SearchSpec(**kw).resolve()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("sched", [None, (8,), (12, 10, 9), (30, 20)])
def test_expand_schedule_matches(sched):
    from repro_torch.core.beam_search import expand_schedule
    assert expand_schedule(sched, 16, 11) == jbs.expand_schedule(sched, 16, 11)


def test_index_surface_on_cpu():
    """The port's JasperIndex on the CPU: build (l2 and mips), searcher,
    recall, memory stats; the host rows tier and the PQ baseline."""
    from repro_torch.core.construction import ConstructionParams as TParams
    rng = np.random.default_rng(8)
    data = rng.normal(size=(400, 12)).astype(np.float32)
    q = rng.normal(size=(16, 12)).astype(np.float32)
    for metric in ("l2", "mips"):
        idx = TIndex(12, 400, metric=metric, quantization="rabitq",
                     construction=TParams(**PARAMS), device="cpu")
        idx.build(data)
        res = idx.searcher(k=5, beam_width=32, quantized=True,
                           use_kernels=True,
                           fusion="megakernel").search(q)
        assert isinstance(res, tss.SearchResult)
        assert res.ids.shape == (16, 5) and res.generation == 1
        assert not res.estimated
        assert idx.recall(q, 5, beam_width=32) >= 0.75
        stats = idx.memory_stats()
        jstats = JIndex(12, 400, metric=metric, quantization="rabitq",
                        construction=JParams(**PARAMS)).memory_stats()
        for key in ("vector_bytes_per_row", "graph_bytes_per_row",
                    "rabitq_bytes_per_row", "compression_ratio"):
            assert stats[key] == jstats[key], key
    # the host rows tier: the same search, bit for bit, and the JAX
    # package's tier statistics
    spec = dict(k=5, beam_width=32, quantized=True, use_kernels=True,
                fusion="megakernel")
    dev = idx.searcher(**spec).search(q)
    idx.evict_rows_to_host()
    host = idx.searcher(**spec, rerank_source="host").search(q)
    assert torch.equal(host.ids, dev.ids) and torch.equal(host.dists,
                                                          dev.dists)
    from repro.core.storage import TIER_STAT_KEYS
    stats = idx.memory_stats()
    assert set(TIER_STAT_KEYS) <= set(stats)
    rows, codes = 400 * (13 + 1) * 4, stats["rabitq_resident_bytes"]
    assert (stats["rows_tier"], stats["device_rows_bytes"],
            stats["host_rows_bytes"], stats["device_codes_bytes"]) == (
        "host", 0.0, rows, codes)
    assert stats["device_compression_ratio"] == (rows + codes) / codes
    host_spec = tss.ResolvedSearchSpec(**{
        **tss.SearchSpec(quantized=True).resolve().__dict__,
        "rerank_source": "host"})
    out = core_search(idx.core, idx._prep_query(q), spec=host_spec)
    assert out[0].shape == (16, host_spec.beam_width)
    # the PQ baseline: opt-in behind its warning, as in the JAX package
    with pytest.warns(DeprecationWarning):
        pq = TIndex(12, 400, quantization="pq", construction=TParams(**PARAMS),
                    device="cpu")
    pq.build(data)
    assert pq.pq_codes.shape == (400, 4)
    with pytest.warns(DeprecationWarning):
        ids, _ = pq.search_pq(q, 5, beam_width=32)
    assert ids.shape == (16, 5)
    with pytest.raises(ValueError):
        TIndex(12, 10, metric="cosine", device="cpu")
