"""Mutations, rebalancing, resharding and checkpoints of the port's
row-sharded index against the JAX package's.

One op stream (`_STREAM`, the same source run by both packages) drives a
4-shard exact index on integer-valued rows: a build with labels, a delete
skewed onto shard 0, a labelled insert, consolidate, an insert that
reuses shard 0's freed slots, one that overflows and grows every shard,
a delete skewed onto shard 1, `rebalance`, then checkpoints resharded
4 -> 2 and 2 -> 4. After every step the live counts, imbalance,
generation, capacity, plan-cache counters (hits, misses, traces,
plans), returned ids and `IdTranslation`s must be equal, and searches on
the plain, megakernel and filtered lanes give equal ids, hops and dists.
The port runs its stream first and saves its checkpoints; the JAX
subprocess (eight fake host devices) runs its own, loads the port's
checkpoints, and writes its checkpoints for the port: each package's
checkpoints load in the other, and the port's arrays equal JAX's shard
for shard at every saved point — the relinked adjacency of both reshards
included.

Beside the stream: `reshard_cores(relink="none")` on a RaBitQ index
(rows, sqnorms, labels and packed code bytes move bit for bit), MIPS
re-augmentation against the global max-norm, `rebalance_plan`,
`IdTranslation` and `pow2_rung`.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import search_spec as tss
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.distributed import ShardedJasperIndex, ShardSpec
from repro_torch.core.index_core import core_to_arrays
from repro_torch.core.resharding import (IdTranslation, pow2_rung,
                                         rebalance_plan, reshard_cores)
from repro_torch.launch.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, PER, CAP, D, Q, K, BEAM = 11, 384, 512, 32, 32, 10, 32
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2

# the op stream, run verbatim by both packages; `rec` collects what they
# must agree on, `idx` ends as the rebalanced index
_STREAM = """
def run_stream(make_mesh, Index, SearchSpec, params, out_dir):
    rec = {}
    rng = np.random.default_rng(SEED)
    data = rng.integers(-6, 7, (4 * PER, D)).astype(np.float32)
    queries = rng.integers(-6, 7, (Q, D)).astype(np.float32)

    def state(name, index, **extra):
        st = index.plans.stats
        rec[name] = dict(
            live=[int(x) for x in index.shard_live_counts()],
            imbalance=float(index.shard_imbalance),
            generation=int(index.generation), size=int(index.size),
            capacity=int(index.capacity), n_deleted=int(index.n_deleted),
            plans=[st.hits, st.misses, st.traces, len(index.plans)],
            **extra)

    def search(name, index):
        for lane, kw in (("plain", {}), ("megakernel", {"fusion": "megakernel"}),
                         ("filtered", {"fusion": "megakernel",
                                       "filter": (1,)})):
            r = index.searcher(SearchSpec(k=K, beam_width=BEAM, **kw)).search(
                queries)
            rec[name + "/" + lane] = dict(
                ids=np.asarray(r.ids).tolist(),
                hops=np.asarray(r.n_hops).tolist(),
                dists=np.asarray(r.dists).tolist())

    def translation(t):
        return None if t is None else [t.old_ids.tolist(), t.new_ids.tolist()]

    mesh = make_mesh((4, 2), ("data", "model"))
    idx = Index(mesh, D, CAP, construction=params, seed=SEED)
    idx.build(data, labels=(np.arange(4 * PER) % 4).astype(np.int32))
    state("build", idx)
    search("build", idx)
    stride = idx.id_stride
    dead = np.concatenate([rng.choice(PER, 120, replace=False),
                           2 * stride + rng.choice(PER, 10, replace=False)])
    n = idx.delete(dead)
    state("delete", idx, n=int(n))
    search("delete", idx)
    ids = idx.insert(rng.integers(-6, 7, (4 * 40, D)).astype(np.float32),
                     labels=1)
    state("insert", idx, ids=np.asarray(ids).tolist())
    stats = idx.consolidate()
    state("consolidate", idx, stats=stats)
    search("consolidate", idx)
    ids = idx.insert(rng.integers(-6, 7, (4, 50, D)).astype(np.float32))
    state("reuse", idx, ids=np.asarray(ids).tolist())
    ids = idx.insert(rng.integers(-6, 7, (4, 200, D)).astype(np.float32))
    state("grow", idx, ids=np.asarray(ids).tolist())
    search("grow", idx)
    idx.delete(stride + rng.choice(PER, 150, replace=False))
    state("delete2", idx)
    st = idx.rebalance(tolerance=0.05)
    state("rebalance", idx, n_moved=st["n_moved"],
          counts=[st["counts_before"], st["counts_after"]],
          before=st["imbalance"], translation=translation(st["translation"]))
    search("rebalance", idx)
    again = idx.rebalance(tolerance=0.05)
    state("rebalance-noop", idx, n_moved=again["n_moved"],
          translation=translation(again["translation"]))
    idx.save(out_dir + "/stream")
    two = Index.load(make_mesh((2, 2), ("data", "model")),
                     out_dir + "/stream")
    state("reshard2", two, cap=two.cap, stride=two.id_stride,
          translation=translation(two.reshard_translation))
    search("reshard2", two)
    two.save(out_dir + "/two")
    four = Index.load(make_mesh((4, 2), ("data", "model")), out_dir + "/two",
                      n_shards=4)
    state("reshard4", four, cap=four.cap, stride=four.id_stride,
          translation=translation(four.reshard_translation))
    search("reshard4", four)
    four.save(out_dir + "/four")
    same = Index.load(mesh, out_dir + "/stream")
    state("restore", same, translation=translation(same.reshard_translation))
    search("restore", same)
    return rec
"""

_JAX_SCRIPT = """
import json, sys, numpy as np
from repro.launch.mesh import make_mesh
from repro.core.construction import ConstructionParams
from repro.core.distributed import ShardedJasperIndex
from repro.core.index_core import core_to_arrays
from repro.core.resharding import reshard_cores
from repro.core.search_spec import SearchSpec

out_dir, port_dir = sys.argv[1], sys.argv[2]
SEED, PER, CAP, D, Q, K, BEAM = {SEED}, {PER}, {CAP}, {D}, {Q}, {K}, {BEAM}
params = ConstructionParams(**{PARAMS!r})
{STREAM}
report = dict(stream=run_stream(make_mesh, ShardedJasperIndex, SearchSpec,
                                params, out_dir))
rng = np.random.default_rng(SEED + 1)
queries = rng.integers(-6, 7, (Q, D)).astype(np.float32)
report["queries"] = queries.tolist()

# the port's checkpoints, loaded and searched here
port = {{}}
for name, shape in (("stream", (4, 2)), ("two", (2, 2)), ("four", (4, 2))):
    j = ShardedJasperIndex.load(make_mesh(shape, ("data", "model")),
                                port_dir + "/" + name)
    r = j.searcher(SearchSpec(k=K, beam_width=BEAM,
                              fusion="megakernel")).search(queries)
    port[name] = dict(ids=np.asarray(r.ids).tolist(),
                      hops=np.asarray(r.n_hops).tolist(),
                      live=[int(x) for x in j.shard_live_counts()])
report["port"] = port

# reshard_cores(relink="none") on a RaBitQ index: the arrays, for the port
mesh = make_mesh((4, 2), ("data", "model"))
q4 = ShardedJasperIndex(mesh, D, 256, construction=params,
                        quantization="rabitq", bits=4, seed=SEED)
q4.build(rng.integers(-6, 7, (4 * 200, D)).astype(np.float32),
         labels=(np.arange(800) % 5).astype(np.int32))
q4.delete(np.concatenate([rng.choice(200, 30, replace=False),
                          3 * q4.id_stride + rng.choice(200, 5,
                                                        replace=False)]))
q4.save(out_dir + "/q4")
res = reshard_cores([q4.shard_core(s) for s in range(4)],
                    old_id_stride=q4.id_stride, n_shards=3, relink="none")
for g, c in enumerate(res.cores):
    np.savez(out_dir + "/q4none%d.npz" % g, **core_to_arrays(c))
report["q4none"] = dict(cap=res.capacity_per_shard, stride=res.id_stride,
                        old=res.translation.old_ids.tolist(),
                        new=res.translation.new_ids.tolist())

# MIPS: a batch that raises the global max-norm re-augments every shard
m = ShardedJasperIndex(mesh, D, 256, metric="mips", construction=params,
                       seed=SEED)
m.build(rng.integers(-3, 4, (4 * 128, D)).astype(np.float32))
m.save(out_dir + "/mips0")
big = rng.integers(-6, 7, (4 * 16, D)).astype(np.float32)
ids = m.insert(big)
m.save(out_dir + "/mips1")
r = m.searcher(SearchSpec(k=K, beam_width=BEAM)).search(queries)
report["mips"] = dict(big=big.tolist(), ids=np.asarray(ids).tolist(),
                      max_sqnorm=m._mips_max_sqnorm,
                      search=np.asarray(r.ids).tolist())
with open(out_dir + "/report.json", "w") as f:
    json.dump(report, f)
"""


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


def _cpu_mesh(shape, axes):
    return make_mesh(shape, axes, device="cpu")


def _run_port_stream(out_dir):
    scope = dict(np=np, SEED=SEED, PER=PER, CAP=CAP, D=D, Q=Q, K=K,
                 BEAM=BEAM)
    exec(textwrap.dedent(_STREAM), scope)
    return scope["run_stream"](_cpu_mesh, ShardedJasperIndex,
                               tss.SearchSpec, TParams(**PARAMS), out_dir)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """(port's record, JAX's report, port dir, JAX dir)."""
    port_dir = tmp_path_factory.mktemp("port_stream")
    jax_dir = tmp_path_factory.mktemp("jax_stream")
    port = _run_port_stream(str(port_dir))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    script = _JAX_SCRIPT.format(SEED=SEED, PER=PER, CAP=CAP, D=D, Q=Q, K=K,
                                BEAM=BEAM, PARAMS=PARAMS,
                                STREAM=textwrap.dedent(_STREAM))
    run = subprocess.run([sys.executable, "-c", script, str(jax_dir),
                          str(port_dir)], capture_output=True, text=True,
                         env=env, timeout=900)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    with open(jax_dir / "report.json") as f:
        report = json.load(f)
    return port, report, str(port_dir), str(jax_dir)


STEPS = ["build", "delete", "insert", "consolidate", "reuse", "grow",
         "delete2", "rebalance", "rebalance-noop", "reshard2", "reshard4",
         "restore"]
SEARCHED = ["build", "delete", "consolidate", "grow", "rebalance",
            "reshard2", "reshard4", "restore"]


@pytest.mark.parametrize("step", STEPS)
def test_stream_state_matches_jax(streams, step):
    port, report, _, _ = streams
    got, want = port[step], report["stream"][step]
    assert got == want


@pytest.mark.parametrize("step", SEARCHED)
@pytest.mark.parametrize("lane", ["plain", "megakernel", "filtered"])
def test_stream_searches_match_jax(streams, step, lane):
    port, report, _, _ = streams
    got, want = port[f"{step}/{lane}"], report["stream"][f"{step}/{lane}"]
    assert got["ids"] == want["ids"] and got["hops"] == want["hops"]
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=DIST_RTOL,
                               atol=DIST_ATOL)


def test_stream_did_what_it_says(streams):
    """The stream exercised what it names: slot reuse on shard 0, a grow,
    a rebalance that moved rows and levelled the shards, reshards."""
    port, _, _, _ = streams
    reuse = np.asarray(port["reuse"]["ids"])
    assert (reuse[0] < PER).any()               # shard 0's freed slots
    assert port["grow"]["capacity"] == 4 * 2 * CAP

    def traces(step):
        return port[step]["plans"][2]

    # no new trace across insert / consolidate / slot reuse (the delete's
    # three searches traced the tombstone-filtering plans), three after
    # the grow: one a searched lane
    assert traces("grow") == traces("delete") + 3
    assert traces("delete2") == traces("grow") + 3
    assert port["rebalance"]["n_moved"] > 0
    assert port["rebalance"]["imbalance"] <= 0.05 < port["delete2"]["imbalance"]
    assert port["rebalance-noop"]["n_moved"] == 0
    assert port["reshard2"]["translation"] is not None
    assert port["restore"]["translation"] is None


@pytest.mark.parametrize("name,n", [("stream", 4), ("two", 2), ("four", 4)])
def test_checkpoints_equal_across_packages(streams, name, n):
    """Every shard file the port saved equals JAX's, byte for byte, the
    relinked adjacency of the reshards included."""
    _, _, port_dir, jax_dir = streams
    for s in range(n):
        with np.load(f"{port_dir}/{name}.shard{s}") as got, \
                np.load(f"{jax_dir}/{name}.shard{s}") as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{name}{s} {key}")
    with open(f"{port_dir}/{name}.meta.json") as f:
        got = json.load(f)
    with open(f"{jax_dir}/{name}.meta.json") as f:
        assert got == json.load(f)


@pytest.mark.parametrize("name", ["stream", "two", "four"])
def test_port_checkpoints_load_in_jax(streams, name):
    _, report, port_dir, _ = streams
    j = report["port"][name]
    mesh = _cpu_mesh((4, 2) if name != "two" else (2, 2), ("data", "model"))
    idx = ShardedJasperIndex.load(mesh, f"{port_dir}/{name}")
    q = np.asarray(report["queries"], np.float32)
    r = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM,
                                    fusion="megakernel")).search(q)
    assert _np(r.ids).tolist() == j["ids"]
    assert _np(r.n_hops).tolist() == j["hops"]
    assert idx.shard_live_counts().tolist() == j["live"]


def test_translated_ids_find_their_rows(streams):
    """Outstanding ids map through the reshard's translation onto the
    same rows."""
    _, _, port_dir, _ = streams
    four = ShardedJasperIndex.load(_cpu_mesh((4, 2), ("data", "model")),
                                   f"{port_dir}/stream")
    two = ShardedJasperIndex.load(_cpu_mesh((2, 2), ("data", "model")),
                                  f"{port_dir}/stream")
    t = two.reshard_translation
    old = t.old_ids
    new = t.apply(old)
    assert (new >= 0).all() and len(t) == four.size == two.size

    def rows(idx, ids):
        pos = (ids // idx.id_stride) * idx.cap + ids % idx.id_stride
        return _np(idx.core.vectors[torch.as_tensor(pos)])

    np.testing.assert_array_equal(rows(four, old), rows(two, new))
    dead = np.flatnonzero(four.tombstoned(np.arange(4 * four.id_stride)))
    assert (t.apply(dead[:50]) == -1).all()


def test_reshard_none_moves_bytes_like_jax(streams):
    """relink="none" on a RaBitQ index (crossed by its checkpoint): every
    new shard's arrays — rows, sqnorms, labels, packed code bytes,
    remapped adjacency — equal JAX's, and so does the translation."""
    _, report, _, jax_dir = streams
    q4 = ShardedJasperIndex.load(_cpu_mesh((4, 2), ("data", "model")),
                                 f"{jax_dir}/q4")
    res = reshard_cores([q4.shard_core(s) for s in range(4)],
                        old_id_stride=q4.id_stride, n_shards=3,
                        relink="none")
    want = report["q4none"]
    assert (res.capacity_per_shard, res.id_stride) == (want["cap"],
                                                       want["stride"])
    assert res.translation.old_ids.tolist() == want["old"]
    assert res.translation.new_ids.tolist() == want["new"]
    for g, core in enumerate(res.cores):
        got = core_to_arrays(core)
        with np.load(f"{jax_dir}/q4none{g}.npz") as w:
            assert sorted(got) == sorted(w.files)
            for key in w.files:
                np.testing.assert_array_equal(got[key], w[key],
                                              err_msg=f"group {g} {key}")


def test_mips_reaugments_across_shards(streams):
    """The port inserts JAX's raising batch into JAX's MIPS checkpoint:
    the global max-norm, the ids and every re-augmented row agree."""
    _, report, _, jax_dir = streams
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    m = ShardedJasperIndex.load(mesh, f"{jax_dir}/mips0")
    want = report["mips"]
    ids = m.insert(np.asarray(want["big"], np.float32))
    assert ids.tolist() == want["ids"]
    assert m._mips_max_sqnorm == want["max_sqnorm"]
    j = ShardedJasperIndex.load(mesh, f"{jax_dir}/mips1")
    np.testing.assert_allclose(_np(m.core.vectors), _np(j.core.vectors),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(m.core.vec_sqnorm),
                               _np(j.core.vec_sqnorm), rtol=1e-6, atol=1e-5)
    q = np.asarray(report["queries"], np.float32)
    r = m.searcher(tss.SearchSpec(k=K, beam_width=BEAM)).search(q)
    agree = np.mean(_np(r.ids) == np.asarray(want["search"]))
    assert agree >= 0.95


# ---------------------------------------------------- host-side helpers
@pytest.mark.parametrize("seed", range(4))
def test_rebalance_plan_matches_jax(seed):
    from repro.core.resharding import rebalance_plan as j_plan
    rng = np.random.default_rng(seed)
    live = [np.sort(rng.choice(500, int(n), replace=False))
            for n in rng.integers(50, 400, 2 + seed)]
    for tol in (0.0, 0.05, 0.5):
        got, want = rebalance_plan(live, tol), j_plan(live, tol)
        assert got.moves == want.moves
        assert np.array_equal(got.counts_before, want.counts_before)
        assert np.array_equal(got.counts_after, want.counts_after)
        assert got.n_moved == want.n_moved


def test_id_translation_and_pow2_rung_match_jax():
    from repro.core.resharding import IdTranslation as JT
    from repro.core.resharding import pow2_rung as j_rung
    assert [pow2_rung(n) for n in range(70)] == [j_rung(n) for n in range(70)]
    old, new = [9, 3, 7, 1], [40, 10, 30, 0]
    probe = np.array([[1, 2, 3], [7, 9, -1]])
    for default in ("drop", "identity"):
        t, j = IdTranslation.build(old, new, default), JT.build(old, new,
                                                                default)
        assert np.array_equal(t.apply(probe), j.apply(probe))
        assert np.array_equal(t.inverse().apply([0, 30, 5]),
                              j.inverse().apply([0, 30, 5]))
        chain = IdTranslation.build(new, [5, 6, 7, 8], default)
        jchain = JT.build(new, [5, 6, 7, 8], default)
        assert np.array_equal(t.then(chain).apply(probe),
                              j.then(jchain).apply(probe))
        assert len(t) == len(j) == 4
    empty = IdTranslation.build([], [], "identity")
    assert np.array_equal(empty.apply([4, 5]), [4, 5])
    assert (IdTranslation.build([], []).apply([4]) == -1).all()
