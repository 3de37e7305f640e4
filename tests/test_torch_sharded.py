"""The port's row-sharded index (`repro_torch.core.distributed`) against
the JAX package's `ShardedJasperIndex`.

The JAX side runs once, in a subprocess with eight fake host devices
(the device-count flag must be set before JAX starts): it builds a
4-shard index on integer-valued rows (N 2,048, D 32, R 16, 4-bit RaBitQ,
labels; and one of 4 x 1,280 rows, past the bootstrap), saves it, tombstones rows on every shard and saves again, and
records its searches on every lane, clean and tombstoned, on a (4, 2)
("data", "model") mesh and on the same checkpoint under a (2, 2)
("pod", "data") mesh, plus its brute force.

The port then builds the same index (construction is bit-exact on
integer rows: every shard's `core_to_arrays` equals JAX's, the quantizer
aside) and loads JAX's checkpoints: on each lane its global ids and hops
equal JAX's and its dists agree within rtol 1e-3 / atol 1e-2 (on integer
rows, exactly); its telemetry equals the int32 sum over its own
`shard_core(s)` searches, and JAX's counters (occupancy on the unfused
lane only: JAX's fused kernels repeat entries into the +inf tail when
L > R+1, ROADMAP C). `core_bootstrap` and `merge_topk` (ties, +inf
tails, against `lax.top_k`) are held in this process.
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
from repro_torch.core.distributed import (ShardedJasperIndex, ShardSpec,
                                          merge_topk)
from repro_torch.core.index import JasperIndex as TIndex
from repro_torch.core.index_core import core_search, core_to_arrays
from repro_torch.launch.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, N, D, Q, K, BEAM = 5, 2048, 32, 32, 10, 32
# the build test's rows a shard: past the 1,024-row bootstrap, so the
# prefix-doubling insert rungs run too
PER_BUILD = 1280
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2
# the lanes, as SearchSpec keywords (quantized unless "exact" is named)
LANES = {
    "plain": {"quantized": True},
    "kernel": {"quantized": True, "use_kernels": True},
    "megakernel": {"quantized": True, "fusion": "megakernel"},
    "hop": {"quantized": True, "fusion": "hop"},
    "merge-kernel": {"quantized": True, "merge": "kernel",
                     "use_kernels": True},
    "telemetry": {"quantized": True, "fusion": "megakernel",
                  "telemetry": "on"},
    "telemetry-unfused": {"quantized": True, "telemetry": "on"},
    "filtered": {"quantized": True, "fusion": "megakernel", "filter": (1,)},
    "exact": {},
    "exact-megakernel": {"fusion": "megakernel"},
}
MESHES = {"data-model": ((4, 2), ("data", "model"), None),
          "pod-data": ((2, 2), ("pod", "data"), ("pod", "data"))}

_JAX_SCRIPT = """
import json, sys, numpy as np
from repro.launch.mesh import make_mesh
from repro.core.construction import ConstructionParams
from repro.core.distributed import ShardedJasperIndex, ShardSpec
from repro.core.search_spec import SearchSpec

out_dir = sys.argv[1]
SEED, N, D, Q, K, BEAM = {SEED}, {N}, {D}, {Q}, {K}, {BEAM}
PER_BUILD = {PER_BUILD}
LANES = {LANES!r}
MESHES = {MESHES!r}
rng = np.random.default_rng(SEED)
data = rng.integers(-6, 7, (N, D)).astype(np.float32)
queries = rng.integers(-6, 7, (Q, D)).astype(np.float32)
params = ConstructionParams(**{PARAMS!r})
mesh = make_mesh((4, 2), ("data", "model"))
big = rng.integers(-6, 7, (4 * PER_BUILD, D)).astype(np.float32)
b = ShardedJasperIndex(mesh, D, capacity_per_shard=PER_BUILD,
                       construction=params, quantization="rabitq", bits=4,
                       seed=SEED)
b.build(big, labels=(np.arange(4 * PER_BUILD) % 3).astype(np.int32))
b.save(out_dir + "/build")
idx = ShardedJasperIndex(mesh, D, capacity_per_shard=N // 4,
                         construction=params, quantization="rabitq",
                         bits=4, seed=SEED)
idx.build(data, labels=(np.arange(N) % 2).astype(np.int32))
idx.save(out_dir + "/clean")
per = N // 4
dead = np.sort(rng.choice(N, 150, replace=False))
idx.delete((dead // per) * idx.id_stride + dead % per)
idx.save(out_dir + "/tomb")
gt, gd = idx.brute_force(queries, K)
report = dict(queries=queries.tolist(), build_data=big.tolist(),
              build_plans=[b.plans.stats.misses, len(b.plans)],
              brute=dict(ids=np.asarray(gt).tolist(),
                         dists=np.asarray(gd).tolist()))

def tolist(x):
    return np.asarray(x).tolist()

for mname, (shape, axes, rows) in MESHES.items():
    m = make_mesh(shape, axes)
    spec = None if rows is None else ShardSpec(row_axes=tuple(rows),
                                                query_axis=None)
    for state in ("clean", "tomb"):
        j = ShardedJasperIndex.load(m, out_dir + "/" + state, spec=spec)
        for lane, kw in LANES.items():
            res = j.searcher(SearchSpec(k=K, beam_width=BEAM, **kw)).search(
                queries)
            cell = dict(ids=tolist(res.ids), dists=tolist(res.dists),
                        hops=tolist(res.n_hops))
            if res.telemetry is not None:
                cell["tel"] = [tolist(t) for t in res.telemetry]
            report[mname + "/" + state + "/" + lane] = cell
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


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's checkpoints and results (one subprocess)."""
    out = tmp_path_factory.mktemp("jax_sharded")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    script = _JAX_SCRIPT.format(SEED=SEED, N=N, D=D, Q=Q, K=K, BEAM=BEAM,
                                PER_BUILD=PER_BUILD,
                                LANES=LANES, MESHES=MESHES, PARAMS=PARAMS)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(script),
                          str(out)], capture_output=True, text=True, env=env,
                         timeout=900)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    with open(out / "report.json") as f:
        report = json.load(f)
    report["dir"] = str(out)
    return report


def _mesh(name):
    shape, axes, rows = MESHES[name]
    spec = None if rows is None else ShardSpec(row_axes=rows, query_axis=None)
    return make_mesh(shape, axes, device="cpu"), spec


@pytest.fixture(scope="module")
def loaded(jax_side):
    """JAX's checkpoints in the port, by (mesh, state)."""
    out = {}
    for mname in MESHES:
        mesh, spec = _mesh(mname)
        for state in ("clean", "tomb"):
            out[mname, state] = ShardedJasperIndex.load(
                mesh, f"{jax_side['dir']}/{state}", spec=spec)
    return out


# ------------------------------------------------------------------- build
def test_build_equals_jax_shard_for_shard(jax_side):
    """Bootstrap + one insert rung a shard: every shard's arrays equal the
    JAX build's, and the same mutation steps went through the cache."""
    data = np.asarray(jax_side["build_data"], np.float32)
    idx = ShardedJasperIndex(make_mesh((4, 2), ("data", "model"),
                                       device="cpu"),
                             D, PER_BUILD, construction=TParams(**PARAMS),
                             quantization="rabitq", bits=4, seed=SEED)
    idx.build(data, labels=(np.arange(4 * PER_BUILD) % 3).astype(np.int32))
    assert idx.size == 4 * PER_BUILD and idx.n_shards == 4
    for s in range(4):
        with np.load(f"{jax_side['dir']}/build.shard{s}") as want:
            got = core_to_arrays(idx.shard_core(s))
            keys = [k for k in want.files if not k.startswith("rq_")]
            assert set(keys) <= set(got)
            for key in keys:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"shard {s} {key}")
    assert [idx.plans.stats.misses, len(idx.plans)] == jax_side["build_plans"]


def test_core_bootstrap_bit_equal_to_jax():
    import jax.numpy as jnp

    from repro.core.construction import ConstructionParams as JParams
    from repro.core.index_core import core_bootstrap as j_boot
    from repro.core.index_core import core_to_arrays as j_arrays
    from repro.core.index_core import init_core as j_init
    from repro_torch.core.index_core import core_bootstrap, init_core
    rng = np.random.default_rng(SEED + 1)
    rows = rng.integers(-6, 7, (200, D)).astype(np.float32)
    for n0 in (64, 200):
        j = j_boot(j_init(256, D, 16), jnp.asarray(rows[:n0]), n0=n0,
                   params=JParams(**PARAMS))
        t = core_bootstrap(init_core(256, D, 16, "cpu"),
                           torch.as_tensor(rows[:n0]), n0=n0,
                           params=TParams(**PARAMS))
        want, got = j_arrays(j), core_to_arrays(t)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=f"n0 {n0} {key}")


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("state", ["clean", "tomb"])
@pytest.mark.parametrize("lane", list(LANES))
def test_search_matches_jax(jax_side, loaded, mname, state, lane):
    idx = loaded[mname, state]
    want = jax_side[f"{mname}/{state}/{lane}"]
    q = np.asarray(jax_side["queries"], np.float32)
    res = idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM,
                                      **LANES[lane])).search(q)
    assert np.array_equal(_np(res.ids), np.asarray(want["ids"]))
    assert np.array_equal(_np(res.n_hops), np.asarray(want["hops"]))
    np.testing.assert_allclose(_np(res.dists), np.asarray(want["dists"]),
                               rtol=DIST_RTOL, atol=DIST_ATOL)
    ids = _np(res.ids)
    assert not idx.tombstoned(ids[ids >= 0]).any()
    if "telemetry" in lane:
        got = [_np(t) for t in res.telemetry]
        # the sum over the port's own shard searches, exactly
        rspec = tss.SearchSpec(k=K, beam_width=BEAM,
                               **LANES[lane]).resolve(idx)
        qt = torch.as_tensor(q)
        per = [core_search(idx.shard_core(s), qt, spec=rspec,
                           filter_tombstones=idx._filter_tombstones)[3]
               for s in range(idx.n_shards)]
        for i, g in enumerate(got):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(
                g, np.sum([_np(p[i]) for p in per], axis=0, dtype=np.int32))
        n_cmp = 4 if lane == "telemetry-unfused" else 3
        for g, w in zip(got[:n_cmp], want["tel"][:n_cmp]):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mname", list(MESHES))
def test_brute_force_matches_jax(jax_side, loaded, mname):
    idx = loaded[mname, "tomb"]
    ids, dists = idx.brute_force(np.asarray(jax_side["queries"], np.float32),
                                 K)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(_np(ids),
                                  np.asarray(jax_side["brute"]["ids"]))
    np.testing.assert_array_equal(_np(dists),
                                  np.asarray(jax_side["brute"]["dists"]))


def test_recall_against_brute_force(loaded, jax_side):
    idx = loaded["data-model", "tomb"]
    q = np.asarray(jax_side["queries"], np.float32)
    rec = idx.recall(q, K, spec=tss.SearchSpec(
        k=K, beam_width=BEAM, quantized=True, fusion="megakernel"))
    assert rec >= 0.85


def test_query_axis_divisibility(loaded, jax_side):
    idx = loaded["data-model", "clean"]
    q = np.asarray(jax_side["queries"], np.float32)
    with pytest.raises(ValueError, match="divisible"):
        idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM)).search(q[:5])
    # no query axis on the (pod, data) mesh: any Q
    other = loaded["pod-data", "clean"]
    assert other.spec.query_axis is None
    assert other.searcher(tss.SearchSpec(k=K, beam_width=BEAM)).search(
        q[:5]).ids.shape == (5, K)


def test_shard_files_load_single_device(jax_side):
    """Each shard file is a JasperIndex checkpoint."""
    single = TIndex.load(f"{jax_side['dir']}/tomb.shard2", device="cpu")
    assert single.capacity == N // 4
    with np.load(f"{jax_side['dir']}/tomb.shard2") as want:
        got = core_to_arrays(single.core)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])


def test_constructor_and_grow_guards():
    """The JAX package's refusals: capacity not a multiple of 8, a stride
    below the capacity, a grow past the stride (outstanding global ids
    would collide), PQ, and an insert that does not deal evenly."""
    mesh = make_mesh((4,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        ShardedJasperIndex(mesh, 8, 20)
    with pytest.raises(ValueError, match="id_stride"):
        ShardedJasperIndex(mesh, 8, 64, id_stride=32)
    with pytest.raises(ValueError, match="PQ"):
        ShardedJasperIndex(mesh, 8, 64, quantization="pq")
    idx = ShardedJasperIndex(mesh, 8, 64, id_stride=128,
                             construction=TParams(**PARAMS))
    idx.grow()
    assert idx.cap == 128 and idx.capacity == 512
    with pytest.raises(ValueError, match="exceed id_stride"):
        idx.grow()
    with pytest.raises(ValueError, match="divisible"):
        idx.insert(np.zeros((6, 8), np.float32))


# -------------------------------------------------------------------- merge
@pytest.mark.parametrize("axis_sizes", [(4,), (2, 2), (2, 1, 2)])
def test_merge_topk_matches_lax_top_k(axis_sizes):
    """Ties broken as `lax.top_k` breaks them, axis by axis, and +inf
    tails that keep id -1 (the reference is the JAX package's own
    emulation of its all_gather merge, `build_sharded_host_rerank_plan`)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED + 2)
    s, q_n, k = int(np.prod(axis_sizes)), 6, 5
    d = rng.integers(0, 4, (s, q_n, k)).astype(np.float32)
    d.sort(axis=-1)
    d[:, :2, 3:] = np.inf                         # short lists
    d[:, 2, :] = np.inf                           # a query no shard answers
    ids = rng.integers(0, 1000, (s, q_n, k)).astype(np.int32)
    ids[np.isinf(d)] = -1

    jd, ji = jnp.asarray(d).reshape(axis_sizes + (q_n, k)), \
        jnp.asarray(ids).reshape(axis_sizes + (q_n, k))
    for _ in axis_sizes:
        jd = jnp.moveaxis(jd, 0, -2)
        ji = jnp.moveaxis(ji, 0, -2)
        jd = jd.reshape(jd.shape[:-2] + (-1,))
        ji = ji.reshape(ji.shape[:-2] + (-1,))
        neg, pos = jax.lax.top_k(-jd, k)
        jd = -neg
        ji = jnp.take_along_axis(ji, pos, axis=-1)
    gi, gd = merge_topk(torch.as_tensor(ids), torch.as_tensor(d), axis_sizes,
                        k)
    np.testing.assert_array_equal(_np(gi), np.asarray(ji))
    np.testing.assert_array_equal(_np(gd), np.asarray(jd))
    assert (_np(gi)[2] == -1).all()


def test_merge_topk_is_hierarchical():
    """A flat merge over all shards can order ties differently from the
    axis-by-axis one; the port's follows the axes."""
    d = torch.zeros((4, 1, 1))
    ids = torch.arange(4, dtype=torch.int32).reshape(4, 1, 1)
    flat, _ = merge_topk(ids, d, (4,), 4)
    hier, _ = merge_topk(ids, d, (2, 2), 4)
    assert flat.tolist() == [[0, 1, 2, 3]]
    # ("pod", "data"): the pod axis merges first, for each data index
    # (shards 0, 2 and 1, 3), then the data axis
    assert hier.tolist() == [[0, 2, 1, 3]]
