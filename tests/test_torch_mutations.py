"""The mutation lifecycle ("built for change") in the port vs the JAX package.

Part 1, bit-exact parity. A JAX-built index over small-integer vectors
(every distance an exact float sum, so construction is bit-exact across
the packages, see tests/test_torch_graph.py) crosses into the port through
`core_to_arrays` -> `core_from_arrays`. Both packages then run the same
chain of core ops — delete, consolidate (refine on and off), take free
slots, grow, insert into reused + fresh slots — and after every step the
whole checkpoint form (adjacency, tombstone bits, label plane, free pool,
counters, generation, medoid, rows and codes) must be BIT-EQUAL — except
the code rows the insert encodes: the RaBitQ encoder rounds after a float
matmul, so those rows follow its tolerance (tests/test_torch_rabitq.py:
>= 0.999 code agreement, metadata rtol 1e-5 / atol 1e-4).

Part 2, the lifecycle contracts of the JAX package's own tests
(tests/test_core_anns.py, mutation lifecycle) asserted on the port's
`JasperIndex` on the CPU: delete validation, zero tombstoned ids on every
search path, recall after consolidate, slot reuse, auto-grow,
delete-all-then-insert, MIPS re-augment, and checkpoints with tombstones
crossing both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index_core as jcore
from repro.core.construction import ConstructionParams as JParams
from repro.core.index import JasperIndex as JIndex
from repro_torch.core import index_core as tcore
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.index import JasperIndex as TIndex
from repro_torch.core.search_spec import SearchSpec

SEED = 77
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
N_BUILD, CAP, D = 900, 1024, 32
N_DEAD, N_INSERT = 120, 200
RTOL, ATOL = 1e-5, 1e-4
CODE_AGREEMENT = 0.999
NEW_CODE_KEYS = ("rq_packed", "rq_add", "rq_rescale")


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


# ------------------------------------------------------ part 1: parity
@pytest.fixture(scope="module")
def chains():
    """Both packages through the same op chain; {stage: (jax arrays,
    port arrays)} after each step."""
    rng = np.random.default_rng(SEED)
    data = rng.integers(-6, 7, (N_BUILD, D)).astype(np.float32)
    new_rows = rng.integers(-6, 7, (N_INSERT, D)).astype(np.float32)
    labels = rng.integers(0, 32, N_BUILD)
    dead = np.sort(rng.choice(N_BUILD, N_DEAD, replace=False))
    jp, tp = JParams(**PARAMS), TParams(**PARAMS)
    jidx = JIndex(D, CAP, construction=jp, quantization="rabitq", bits=4,
                  seed=SEED)
    jidx.build(data, labels=labels)
    j = jidx.core
    t = tcore.core_from_arrays(jcore.core_to_arrays(j), bits=4,
                               store_dims=D, quantized=True, device="cpu")
    out = {}

    def record(stage):
        # copies: on the CPU the port's arrays are views of tensors that
        # later steps write in place
        out[stage] = (jcore.core_to_arrays(j),
                      {k: v.copy() for k, v in
                       tcore.core_to_arrays(t).items()})

    record("crossed")
    j, jn = jcore.core_delete(j, jnp.asarray(dead, jnp.int32))
    t, tn = tcore.core_delete(t, torch.as_tensor(dead))
    assert int(jn) == tn == N_DEAD
    record("delete")
    deleted = (j, t)
    for refine in (False, True):
        j, t = deleted
        t = tcore.core_from_arrays(tcore.core_to_arrays(t), bits=4,
                                   store_dims=D, quantized=True,
                                   device="cpu")    # a private copy
        j, jstats = jcore.core_consolidate(j, params=jp, refine=refine)
        t, tstats = tcore.core_consolidate(t, params=tp, refine=refine)
        assert jstats == tstats and tstats["n_freed"] == N_DEAD
        record(f"consolidate-refine={refine}")
    # continue from the refine=True state: reuse 100 slots, grow, insert
    j, jtaken = jcore.core_take_free_slots(j, 100)
    t, ttaken = tcore.core_take_free_slots(t, 100)
    assert np.array_equal(jtaken, ttaken) and np.array_equal(ttaken,
                                                             dead[:100])
    record("take_free_slots")
    j = jcore.core_grow(j, 2 * CAP)
    t = tcore.core_grow(t, 2 * CAP)
    record("grow")
    ids = np.concatenate([ttaken, np.arange(N_BUILD, N_BUILD + 100)]
                         ).astype(np.int32)
    j = jcore.core_insert_at(j, jnp.asarray(ids), jnp.asarray(new_rows),
                             params=jp)
    t = tcore.core_insert_at(t, torch.as_tensor(ids),
                             torch.as_tensor(new_rows), params=tp)
    record("insert_at")
    out["inserted"] = ids
    return out


STAGES = ["crossed", "delete", "consolidate-refine=False",
          "consolidate-refine=True", "take_free_slots", "grow", "insert_at"]


@pytest.mark.parametrize("stage", STAGES)
def test_lifecycle_bit_equal_to_jax(chains, stage):
    want, got = chains[stage]
    assert sorted(got) == sorted(want)
    new = np.zeros(got["vectors"].shape[0], bool)
    if stage == "insert_at":
        new[chains["inserted"]] = True
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if key in NEW_CODE_KEYS:
            assert np.array_equal(got[key][~new], want[key][~new]), key
        else:
            assert np.array_equal(got[key], want[key]), (stage, key)
    if new.any():
        from repro_torch.core.rabitq import unpack_codes
        g, w = (unpack_codes(torch.as_tensor(a["rq_packed"][new]), 4, D)
                for a in (got, want))
        assert float((g == w).float().mean()) >= CODE_AGREEMENT
        np.testing.assert_allclose(got["rq_add"][new], want["rq_add"][new],
                                   rtol=RTOL, atol=ATOL)
        same = _np((g == w).all(dim=1))
        np.testing.assert_allclose(got["rq_rescale"][new][same],
                                   want["rq_rescale"][new][same],
                                   rtol=RTOL, atol=ATOL)


def test_grow_keeps_prefix_and_fills_tail(chains):
    before, _ = chains["take_free_slots"]
    _, after = chains["grow"]
    for key, fill in (("vectors", 0), ("adjacency", -1), ("rq_packed", 0),
                      ("labels", 0), ("free_ids", -1)):
        assert np.array_equal(after[key][:CAP], before[key][:CAP]), key
        assert (after[key][CAP:] == fill).all(), key
    assert np.array_equal(after["tombstone_bits"][:CAP // 8],
                          before["tombstone_bits"])


def test_tombstoned_lookup_and_live_mask_match(chains):
    want, got = chains["delete"]
    jc = jcore.core_from_arrays(want, bits=4, store_dims=D, quantized=True)
    tc = tcore.core_from_arrays(got, bits=4, store_dims=D, quantized=True,
                                device="cpu")
    assert np.array_equal(tcore.core_live_mask(tc), jcore.core_live_mask(jc))
    assert np.array_equal(tcore.core_live_locals(tc),
                          jcore.core_live_locals(jc))
    ids = np.array([-1, 0, 5, N_BUILD - 1, N_BUILD, CAP + 9])
    ids = np.concatenate([ids, np.arange(0, N_BUILD, 7)])
    assert np.array_equal(
        tcore.tombstoned_lookup(got["tombstone_bits"], N_BUILD, ids),
        jcore.tombstoned_lookup(want["tombstone_bits"], N_BUILD, ids))


# ------------------------------------------ part 2: lifecycle contracts
@pytest.fixture()
def churn_index():
    """Small quantized port index + its data (function-scoped: tests
    mutate it)."""
    rng = np.random.default_rng(4242)
    data = rng.normal(size=(700, 32)).astype(np.float32)
    idx = TIndex(32, capacity=900, construction=TParams(**PARAMS),
                 quantization="rabitq", bits=4, device="cpu")
    idx.build(data)
    queries = rng.normal(size=(60, 32)).astype(np.float32)
    return idx, data, queries, rng


LANES = {
    "exact": dict(),
    "exact-kernel": dict(use_kernels=True),
    "exact-exclude": dict(traverse_deleted=False),
    "rabitq": dict(quantized=True),
    "rabitq-kernel": dict(quantized=True, use_kernels=True),
    "rabitq-kernel-exclude": dict(quantized=True, use_kernels=True,
                                  traverse_deleted=False),
    "megakernel": dict(quantized=True, use_kernels=True, fusion="megakernel"),
    "hop": dict(quantized=True, use_kernels=True, fusion="hop"),
    "hop-exclude": dict(quantized=True, use_kernels=True, fusion="hop",
                        traverse_deleted=False),
    "merge-kernel": dict(quantized=True, use_kernels=True, merge="kernel"),
    "merge-kernel-exclude": dict(quantized=True, use_kernels=True,
                                 merge="kernel", traverse_deleted=False),
}


def test_delete_excludes_ids_all_paths(churn_index):
    """Tombstoned ids never surface — every lane, both traversal modes,
    and brute force."""
    idx, _, queries, rng = churn_index
    dead = rng.choice(700, 140, replace=False)
    assert idx.delete(dead) == 140
    assert idx.size == 700 - 140 and idx.n_deleted == 140
    assert idx.deleted_fraction == 140 / 700
    for name, kw in LANES.items():
        res = idx.searcher(SearchSpec(k=10, beam_width=48, **kw)).search(
            queries)
        assert not np.isin(_np(res.ids), dead).any(), name
        assert not idx.tombstoned(_np(res.ids)[_np(res.ids) >= 0]).any()
    ids, _ = idx.brute_force(queries, 10)
    assert not np.isin(_np(ids), dead).any()
    assert idx.recall(queries, k=10, beam_width=48) > 0.75


def test_delete_validates_ids(churn_index):
    idx, _, _, _ = churn_index
    with pytest.raises(ValueError, match="out of range"):
        idx.delete([700])
    with pytest.raises(ValueError, match="out of range"):
        idx.delete([-1])
    idx.delete([3, 5])
    with pytest.raises(ValueError, match="already deleted"):
        idx.delete([5])
    assert idx.delete(np.empty((0,), np.int64)) == 0


@pytest.mark.parametrize("refine", [True, False])
def test_consolidate_restores_recall(churn_index, refine):
    """Post-consolidate recall within 1pt of a fresh build of the
    surviving rows (refine) or above the floor (local repair); the
    repaired graph has no edges into deleted rows."""
    from repro_torch.core.vamana import validate_graph
    idx, data, queries, rng = churn_index
    dead = rng.choice(700, 140, replace=False)       # 20% churn
    idx.delete(dead)
    stats = idx.consolidate(refine=refine)
    assert stats["n_freed"] == 140 and stats["n_repaired"] > 0
    assert idx.n_deleted == 0 and idx.mut.n_free == 140
    checks = validate_graph(idx.graph, torch.as_tensor(idx.live_mask()))
    assert all(bool(v) for v in checks.values()), checks
    r_cons = idx.recall(queries, k=10, beam_width=48)
    fresh = TIndex(32, capacity=900, construction=TParams(**PARAMS),
                   device="cpu")
    fresh.build(data[np.setdiff1d(np.arange(700), dead)])
    r_fresh = fresh.recall(queries, k=10, beam_width=48)
    assert r_cons >= r_fresh - (0.01 if refine else 0.05), (r_cons, r_fresh)
    assert idx.recall(queries, k=10, beam_width=48, quantized=True) > 0.75


def test_insert_after_delete_reuses_slots(churn_index):
    idx, _, _, rng = churn_index
    dead = np.sort(rng.choice(700, 60, replace=False))
    idx.delete(dead)
    idx.consolidate()
    new = rng.normal(size=(60, 32)).astype(np.float32)
    got = idx.insert(new)
    # freed slots reused ascending; the high-water mark did not move
    assert (got == dead).all() and got.dtype == np.int32
    assert idx.graph.n_valid == 700 and idx.size == 700
    # reused rows are live again and findable under their new vectors
    ids, _ = idx.search(new[:20], 1, beam_width=48)
    assert (_np(ids)[:, 0] == got[:20]).mean() > 0.8


def test_grow_preserves_packed_codes(churn_index):
    idx, _, queries, _ = churn_index
    packed = _np(idx.rabitq_codes.packed).copy()
    adj = _np(idx.graph.adjacency).copy()
    i1, _ = idx.search_rabitq(queries, 10, beam_width=32)
    gen = idx.generation
    idx.grow()
    assert idx.capacity == 1800 and idx.generation == gen + 1
    assert (_np(idx.rabitq_codes.packed)[:900] == packed).all()
    assert (_np(idx.graph.adjacency)[:900] == adj).all()
    assert (_np(idx.graph.adjacency)[900:] == -1).all()
    i2, _ = idx.search_rabitq(queries, 10, beam_width=32)
    assert (_np(i1) == _np(i2)).all()


def test_insert_auto_grows(churn_index):
    idx, _, _, rng = churn_index
    extra = rng.normal(size=(400, 32)).astype(np.float32)  # 700+400 > 900
    ids = idx.insert(extra)
    assert idx.capacity == 1800 and idx.size == 1100
    assert (ids == np.arange(700, 1100)).all()


def test_delete_all_then_insert_rebuilds(churn_index):
    idx, _, _, rng = churn_index
    idx.delete(np.arange(700))
    assert idx.size == 0
    ids = idx.insert(rng.normal(size=(64, 32)).astype(np.float32))
    assert idx.size == 64 and (ids == np.arange(64)).all()
    q = rng.normal(size=(10, 32)).astype(np.float32)
    assert idx.recall(q, k=5, beam_width=32) > 0.9


def test_mips_streaming_reaugment():
    """A later batch raising the global max-norm re-augments earlier rows
    (as the JAX package re-augments them, to float32 rounding: the norms
    are float32 sums in another order), so the MIPS->L2 reduction stays
    exact under streaming."""
    rng = np.random.default_rng(11)
    d1 = rng.normal(size=(300, 24)).astype(np.float32)
    d2 = (10.0 * rng.normal(size=(150, 24))).astype(np.float32)  # norm jump
    idx = TIndex(24, capacity=500, metric="mips",
                 construction=TParams(**PARAMS), device="cpu")
    idx.build(d1)
    jidx = JIndex(24, capacity=500, metric="mips",
                  construction=JParams(**PARAMS))
    jidx.build(d1)
    idx.insert(d2)
    jidx._prep_data(d2)              # the re-augment step alone
    assert idx._mips_max_sqnorm == pytest.approx(jidx._mips_max_sqnorm,
                                                 rel=RTOL)
    np.testing.assert_allclose(_np(idx.vectors)[:300],
                               np.asarray(jidx.vectors)[:300],
                               rtol=RTOL, atol=ATOL)
    q = rng.normal(size=(40, 24)).astype(np.float32)
    ip = q @ np.concatenate([d1, d2]).T
    got, _ = idx.brute_force(q, 1)
    assert (_np(got)[:, 0] == ip.argmax(1)).all()


def test_checkpoints_with_tombstones_cross_both_packages(tmp_path,
                                                         churn_index):
    """A port checkpoint with tombstones loads in JAX and back; the free
    pool survives, and a post-consolidate insert reuses the freed slots
    in either package."""
    idx, _, queries, rng = churn_index
    dead = np.sort(rng.choice(700, 50, replace=False))
    idx.delete(dead)
    p = os.path.join(tmp_path, "m.npz")
    idx.save(p)
    jidx = JIndex.load(p)
    assert np.array_equal(np.asarray(jidx.mut.tombstone_bits),
                          _np(idx.mut.tombstone_bits))
    assert jidx.size == idx.size and jidx.generation == idx.generation
    ids, _ = jidx.search(queries, 10, beam_width=48)
    assert not np.isin(np.asarray(ids), dead).any()
    # consolidated in JAX, back into the port
    jidx.consolidate()
    jidx.save(p)
    back = TIndex.load(p, device="cpu")
    assert back.mut.n_free == 50 and back.size == 650
    ids, _ = back.search(queries, 10, beam_width=48)
    assert not np.isin(_np(ids), dead).any()
    got = back.insert(rng.normal(size=(50, 32)).astype(np.float32))
    assert (got == dead).all()
