"""The row-sharded index with its shards on their own mesh positions
(`make_mesh(shape, axes, device=[...])`, one position a device entry) in
the port, against the JAX package and against the one-device layout.

The JAX side runs in three subprocesses with eight fake host devices,
started by the first test and read by the last ones, so the port's own
tests run meanwhile. Two of them, one a mesh, do as
`tests/test_torch_sharded.py`'s does: each builds a 4-shard index on
integer-valued rows (N 2,048, D 32, R 16, 4-bit RaBitQ, labels), saves
it clean and with rows tombstoned on every shard, and records every
lane's search of both checkpoints on its mesh — a (4, 2) ("data",
"model") mesh (the query axis splits the batch), or a (2, 2) ("pod",
"data") mesh — and its brute force. The port loads them on `["cpu"] * 8`
and `["cpu"] * 4`: global ids and hops equal JAX's, dists within rtol
1e-3 / atol 1e-2, the results bit-equal to the one-device layout of the
same checkpoint, and telemetry the int32 sum of the shards' own
searches. The third runs the lifecycle below on the (4, 2) mesh.

The lifecycle — insert, a delete of 1 % of the rows all from one shard,
consolidate, grow, rebalance, save, load at 4 and at 2 shards — runs on
an 8-position mesh and on the one-device layout; after each step every
replica of every shard equals the one-device layout's `shard_core(s)`
field by field, the searches are bit-equal and return no tombstoned id,
and the positions' step outputs, live counts, ids and hops equal JAX's
(dists within the same tolerance). The host rows tier on 4 positions
equals their device tier; a service stream runs alike on both layouts;
`make_mesh`'s rules.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.core import search_spec as tss
from repro_torch.core.construction import ConstructionParams as TParams
from repro_torch.core.distributed import ShardedJasperIndex, ShardSpec
from repro_torch.core.index_core import core_search, core_to_arrays
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.anns_service import AnnsService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, N, D, Q, K, BEAM = 5, 2048, 32, 32, 10, 32
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
# name: (shape, axes, row axes or None for the default spec)
MESHES = {"data-model": ((4, 2), ("data", "model"), None),
          "pod-data": ((2, 2), ("pod", "data"), ("pod", "data"))}
HOST_LANES = {
    "jnp": {},
    "kernel": {"use_kernels": True},
    "hop": {"fusion": "hop"},
    "megakernel": {"fusion": "megakernel"},
    "telemetry": {"telemetry": "on"},
    "filtered": {"filter": (1,)},
}
# the lifecycle's lanes, compared with the one-device layout
LIFE_LANES = ("megakernel", "hop", "merge-kernel", "telemetry", "filtered",
              "exact")
LIFE_STEPS = ("build", "insert", "delete", "consolidate", "grow",
              "rebalance", "load4", "load2")

_JAX_SCRIPT = """
import json, sys, numpy as np
from repro.launch.mesh import make_mesh
from repro.core.construction import ConstructionParams
from repro.core.distributed import ShardedJasperIndex, ShardSpec
from repro.core.search_spec import SearchSpec

out_dir, mname = sys.argv[1], sys.argv[2]
SEED, N, D, Q, K, BEAM = {SEED}, {N}, {D}, {Q}, {K}, {BEAM}
LANES = {LANES!r}
MESHES = {MESHES!r}
LIFE_LANES = {LIFE_LANES!r}
params = ConstructionParams(**{PARAMS!r})
report = dict()

def tolist(x):
    return np.asarray(x).tolist()

def search(j, lane, q):
    res = j.searcher(SearchSpec(k=K, beam_width=BEAM, **LANES[lane])).search(q)
    cell = dict(ids=tolist(res.ids), dists=tolist(res.dists),
                hops=tolist(res.n_hops))
    if res.telemetry is not None:
        cell["tel"] = [tolist(t) for t in res.telemetry]
    return cell

def searches(step, j):
    for lane in LIFE_LANES:
        report["life/" + step + "/" + lane] = search(j, lane, life_q)
    report["life/" + step + "/size"] = int(j.size)

if mname == "life":
    # the port's `lifecycle` fixture's op stream on the (4, 2) mesh
    rng = np.random.default_rng(SEED + 40)
    rows = lambda n: rng.integers(-6, 7, (n, D)).astype(np.float32)
    life_data, life_q = rows(N), rows(Q)
    j = ShardedJasperIndex(make_mesh((4, 2), ("data", "model")), D,
                           capacity_per_shard=N // 4, construction=params,
                           quantization="rabitq", bits=4, seed=SEED)
    j.build(life_data, labels=(np.arange(N) % 2).astype(np.int32))
    j.save(out_dir + "/life0")          # where the port's lifecycle starts
    open(out_dir + "/life0.ready", "w").close()
    searches("build", j)
    report["life/insert/op"] = tolist(j.insert(rows(4 * 64), labels=1))
    searches("insert", j)
    live = np.flatnonzero(~j.tombstoned(j.id_stride + np.arange(j.cap))) \\
        + j.id_stride
    dead = np.sort(rng.choice(live, j.size // 100, replace=False))
    report["life/delete/op"] = int(j.delete(dead))
    searches("delete", j)
    st = j.consolidate()
    report["life/consolidate/op"] = [int(st["n_freed"]),
                                     int(st["n_repaired"])]
    searches("consolidate", j)
    j.grow()
    report["life/grow/op"] = int(j.cap)
    searches("grow", j)
    r = j.rebalance(tolerance=0.01)
    report["life/rebalance/op"] = [int(r["n_moved"]),
                                   tolist(r["translation"].old_ids),
                                   tolist(r["translation"].new_ids)]
    searches("rebalance", j)
    j.save(out_dir + "/life")
    for n_sh, shape in ((4, (4, 2)), (2, (2, 2))):
        l = ShardedJasperIndex.load(make_mesh(shape, ("data", "model")),
                                    out_dir + "/life")
        t = l.reshard_translation
        report["life/load%d/op" % n_sh] = None if t is None else [
            tolist(t.old_ids), tolist(t.new_ids)]
        searches("load%d" % n_sh, l)
else:
    rng = np.random.default_rng(SEED)
    data = rng.integers(-6, 7, (N, D)).astype(np.float32)
    queries = rng.integers(-6, 7, (Q, D)).astype(np.float32)
    idx = ShardedJasperIndex(make_mesh((4, 2), ("data", "model")), D,
                             capacity_per_shard=N // 4, construction=params,
                             quantization="rabitq", bits=4, seed=SEED)
    idx.build(data, labels=(np.arange(N) % 2).astype(np.int32))
    idx.save(out_dir + "/clean")
    per = N // 4
    dead = np.sort(rng.choice(N, 150, replace=False))
    idx.delete((dead // per) * idx.id_stride + dead % per)
    idx.save(out_dir + "/tomb")
    gt, gd = idx.brute_force(queries, K)
    report.update(queries=queries.tolist(),
                  brute=dict(ids=tolist(gt), dists=tolist(gd)))
    shape, axes, rows = MESHES[mname]
    m = make_mesh(shape, axes)
    spec = None if rows is None else ShardSpec(row_axes=tuple(rows),
                                                query_axis=None)
    for state in ("clean", "tomb"):
        j = ShardedJasperIndex.load(m, out_dir + "/" + state, spec=spec)
        for lane in LANES:
            report[mname + "/" + state + "/" + lane] = search(j, lane, queries)
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


@pytest.fixture(scope="module", autouse=True)
def _jax_run(tmp_path_factory):
    """The JAX subprocesses, one a mesh and one for the lifecycle, started
    with the module's first test (killed at its end if they still
    run)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    script = _JAX_SCRIPT.format(SEED=SEED, N=N, D=D, Q=Q, K=K, BEAM=BEAM,
                                LANES=LANES, MESHES=MESHES, PARAMS=PARAMS,
                                LIFE_LANES=LIFE_LANES)
    runs = {}
    for mname in (*MESHES, "life"):
        out = tmp_path_factory.mktemp(f"jax_{mname}")
        runs[mname] = (subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(script), str(out), mname],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env), out)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_side(_jax_run):
    """The JAX package's checkpoints and results: each mesh's records and
    its checkpoints' directory (`dir/<mesh>`); the brute force."""
    report = {"dir": {}}
    for mname, (proc, out) in _jax_run.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, \
            f"{mname}\nSTDOUT:\n{stdout}\nSTDERR:\n{stderr}"
        with open(out / "report.json") as f:
            report.update(json.load(f))
        report["dir"][mname] = str(out)
    return report


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _parts(res) -> list:
    out = [res.ids, res.dists, res.n_hops]
    if res.telemetry is not None:
        out += list(res.telemetry)
    return out


def _same(a, b) -> bool:
    """Two SearchResults bit-equal in ids, dists, hops and telemetry."""
    pa, pb = _parts(a), _parts(b)
    return len(pa) == len(pb) and all(torch.equal(x, y)
                                      for x, y in zip(pa, pb))


def _params():
    return TParams(**PARAMS)


def _rows(rng, n):
    return rng.integers(-6, 7, (n, D)).astype(np.float32)


def _layouts(shape, axes):
    """(one-device mesh, mesh of a CPU position a device entry)."""
    n = int(np.prod(shape))
    return (make_mesh(shape, axes, device="cpu"),
            make_mesh(shape, axes, device=["cpu"] * n))


def _replica_diffs(one, many) -> list:
    """(shard, replica, key) of every array of a replica of `many` that
    differs from the one-device layout's shard_core(s)."""
    out = []
    for s in range(one.n_shards):
        want = core_to_arrays(one.shard_core(s))
        reps = many.shard_replicas(s)
        assert reps, f"shard {s} has no position"
        for r, view in enumerate(reps):
            got = core_to_arrays(view)
            for key in want:
                if not np.array_equal(got[key], want[key]):
                    out.append((s, r, key))
    return out


def _search(idx, lane, q):
    return idx.searcher(tss.SearchSpec(k=K, beam_width=BEAM,
                                       **LANES[lane])).search(q)


# ------------------------------------------------------------------ meshes
def test_mesh_positions_are_row_major():
    m = make_mesh((4, 2), ("data", "model"), device=["cpu"] * 8)
    assert len(m.devices) == 8 and m.device == torch.device("cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert [m.coords(p) for p in (0, 1, 2, 7)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 3, "model": 1}]


def test_mesh_of_one_device_is_one_position():
    m = make_mesh((4, 2), ("data", "model"), device="cpu")
    assert m.devices == (torch.device("cpu"),)
    idx = ShardedJasperIndex(m, 8, 16)
    assert idx.n_positions == 1 and not idx.multi_position
    assert idx.core.adjacency.shape == (64, 64)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_mesh_list_must_name_every_position(n):
    with pytest.raises(ValueError, match="one device a position, 8"):
        make_mesh((4, 2), ("data", "model"), device=["cpu"] * n)


def test_mesh_refuses_cpu_and_cuda_together():
    with pytest.raises(ValueError, match="one kind of device"):
        make_mesh((2,), ("data",), device=["cpu", "cuda:0"])


def test_mesh_refuses_cards_past_the_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_mesh((2,), ("data",), device=["cuda:1", "cuda:0"])
    assert m.devices == (torch.device("cuda:1"), torch.device("cuda:0"))
    assert m.device == torch.device("cuda:1")
    with pytest.raises(ValueError, match="past the 2 CUDA"):
        make_mesh((4,), ("data",), device=["cuda:0", "cuda:1", "cuda:2",
                                           "cuda:3"])


def test_positions_hold_their_shards_and_slices():
    """(r, m): the row-major shard index over the row axes and the index
    along the query axis; replicas along an axis that neither shards rows
    nor splits queries do not search."""
    idx = ShardedJasperIndex(make_mesh((4, 2), ("data", "model"),
                                       device=["cpu"] * 8), 8, 16)
    got = [(p.shards.start, p.query_slice, p.searches)
           for p in idx._positions]
    assert got == [(r, m, True) for r in range(4) for m in range(2)]
    pod = ShardedJasperIndex(make_mesh((2, 2), ("pod", "data"),
                                       device=["cpu"] * 4), 8, 16)
    assert [(p.shards.start, p.query_slice) for p in pod._positions] == [
        (0, 0), (1, 0), (2, 0), (3, 0)]
    rep = ShardedJasperIndex(make_mesh((4, 2), ("data", "model"),
                                       device=["cpu"] * 8), 8, 16,
                             spec=ShardSpec(("data",), None))
    assert [p.searches for p in rep._positions] == [True, False] * 4
    assert len(rep.searching_positions()) == 4
    with pytest.raises(RuntimeError, match="8 mesh positions"):
        rep.core


def test_device_of_refuses_split_operands():
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    assert build.device_of("k", a, None, a) == torch.device("cpu")
    with pytest.raises(ValueError, match="one device expected"):
        build.device_of("k", a, b)


def test_call_passes_the_operands_devices_stream(monkeypatch):
    """`build.call` makes the operands' device current around the entry
    point and passes that device's current stream — not the stream of
    whichever device was current before."""
    class Stream:
        def __init__(self, device):
            # the current device (cuda:0 here) when none is named
            d = torch.device("cuda:0" if device is None else device)
            self.cuda_stream = 1000 + d.index

    current = [torch.device("cuda:0")]

    class Guard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    seen = []

    def entry(*args):
        seen.append((args[:-1], args[-1].value, current[-1]))
        return 0

    assert build.stream_handle(torch.device("cuda:3")) == 1003
    assert build.call(entry, torch.device("cuda:2"), 7, 8) == 0
    assert seen == [((7, 8), 1002, torch.device("cuda:2"))]
    assert current == [torch.device("cuda:0")]


# --------------------------------------------------------------- lifecycle
def _jax_checkpoint(run, name: str, timeout: float = 900) -> str:
    """The path of a checkpoint a JAX subprocess saves on its way (it
    marks it `<name>.ready` once whole), waited for."""
    proc, out = run
    ready = out / f"{name}.ready"
    t0 = time.monotonic()
    while not ready.exists():
        if proc.poll() is not None and not ready.exists():
            raise AssertionError(f"the JAX subprocess ended without {name}: "
                                 f"{proc.communicate()[1][-4000:]}")
        assert time.monotonic() - t0 < timeout, f"no {name} after {timeout} s"
        time.sleep(0.2)
    return str(out / name)


@pytest.fixture(scope="module")
def lifecycle(_jax_run):
    """One op stream run on the one-device layout and on eight positions
    ((4, 2) ("data", "model"): two replicas a shard, the query axis
    splitting the batch), both starting from the JAX package's build of
    the same rows (its quantizer, so the quantized lanes can meet JAX's)
    while JAX runs the same stream; after each step, the replica diffs,
    the lanes whose searches differ or return a tombstoned id, and the
    positions' results."""
    rng = np.random.default_rng(SEED + 40)
    _rows(rng, N)                                # JAX's build's rows
    q = _rows(rng, Q)
    path = _jax_checkpoint(_jax_run["life"], "life0")
    pair = [ShardedJasperIndex.load(m, path)
            for m in _layouts((4, 2), ("data", "model"))]
    out = {}

    def record(step, one, many, extra=None):
        out[step] = _compare(one, many, q) | dict(extra=extra)

    record("build", *pair)
    new = _rows(rng, 4 * 64)
    ids = [ix.insert(new, labels=1) for ix in pair]
    record("insert", *pair, extra=[i.tolist() for i in ids])
    live = np.flatnonzero(~pair[0].tombstoned(
        pair[0].id_stride + np.arange(pair[0].cap))) + pair[0].id_stride
    dead = np.sort(rng.choice(live, pair[0].size // 100, replace=False))
    n = [ix.delete(dead) for ix in pair]
    record("delete", *pair, extra=n)
    stats = [ix.consolidate() for ix in pair]
    record("consolidate", *pair, extra=stats)
    for ix in pair:
        ix.grow()
    record("grow", *pair, extra=[ix.cap for ix in pair])
    reb = [ix.rebalance(tolerance=0.01) for ix in pair]
    record("rebalance", *pair, extra=[
        (r["n_moved"], r["translation"].old_ids.tolist(),
         r["translation"].new_ids.tolist()) for r in reb])
    yield out, pair, q, rng


@pytest.fixture(scope="module")
def reloaded(lifecycle, tmp_path_factory):
    """The lifecycle's last state saved by each layout and loaded back at
    4 shards and at 2 on both layouts."""
    _, pair, q, _ = lifecycle
    d = tmp_path_factory.mktemp("positions_ckpt")
    for name, ix in zip(("one", "many"), pair):
        ix.save(str(d / name))
    got = {}
    for shards, (shape, axes) in {4: ((4, 2), ("data", "model")),
                                  2: ((2, 2), ("data", "model"))}.items():
        m_one, m_many = _layouts(shape, axes)
        one = ShardedJasperIndex.load(m_one, str(d / "one"))
        many = ShardedJasperIndex.load(m_many, str(d / "many"))
        assert one.n_shards == many.n_shards == shards
        assert many.n_positions == int(np.prod(shape))
        t = (one.reshard_translation, many.reshard_translation)
        extra = None if t[0] is None else (
            t[0].old_ids.tolist() == t[1].old_ids.tolist()
            and t[0].new_ids.tolist() == t[1].new_ids.tolist())
        got[f"load{shards}"] = _compare(one, many, q) | dict(
            extra=extra, op=None if t[1] is None else [
                t[1].old_ids.tolist(), t[1].new_ids.tolist()])
    return got


def _compare(one, many, q) -> dict:
    """A lifecycle step's record: the replica diffs, the lanes whose
    searches differ between the layouts or return a tombstoned id, both
    sizes, and each lane's result on the positions (for JAX's)."""
    bad, res = [], {}
    for lane in LIFE_LANES:
        a, b = _search(one, lane, q), _search(many, lane, q)
        ids = _np(b.ids)
        if not _same(a, b) or many.tombstoned(ids[ids >= 0]).any():
            bad.append(lane)
        res[lane] = (ids, _np(b.dists), _np(b.n_hops))
    return dict(diffs=_replica_diffs(one, many), lanes=bad,
                size=(one.size, many.size), res=res)


@pytest.mark.parametrize("step", LIFE_STEPS)
def test_lifecycle_replicas_equal_one_device(lifecycle, reloaded, step):
    out = lifecycle[0]
    rec = reloaded[step] if step.startswith("load") else out[step]
    assert rec["diffs"] == [], rec["diffs"][:8]
    assert rec["lanes"] == []
    assert rec["size"][0] == rec["size"][1]
    if step in ("insert", "delete", "consolidate", "grow", "rebalance"):
        a, b = rec["extra"]
        assert a == b
    if step == "load2":
        assert rec["extra"] is True      # the same reshard translation
    if step == "delete":
        assert rec["extra"][0] == (N + 4 * 64) // 100    # 1 %, shard 1
    if step == "rebalance":
        assert rec["extra"][0][0] > 0    # rows moved


def test_lifecycle_brute_force_bit_equal(lifecycle):
    _, (one, many), q, _ = lifecycle
    a, b = one.brute_force(q, K), many.brute_force(q, K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_lifecycle_memory_stats_equal(lifecycle):
    _, (one, many), _, _ = lifecycle
    assert one.memory_stats() == many.memory_stats()
    assert many.generation == one.generation
    assert many.shard_live_counts().tolist() == \
        one.shard_live_counts().tolist()


# --------------------------------------------------------------- host tier
@pytest.fixture(scope="module")
def host_pair():
    """A tombstoned 4-shard index on 4 positions ((4,) ("data",)) and on
    one device; each lane's device-tier result, then the rows evicted."""
    rng = np.random.default_rng(SEED + 50)
    data = _rows(rng, 4 * 256)
    q = _rows(rng, Q)
    pair = [ShardedJasperIndex(m, D, 512, construction=_params(),
                               quantization="rabitq", bits=4, seed=SEED)
            .build(data, labels=(np.arange(4 * 256) % 2).astype(np.int32))
            for m in _layouts((4,), ("data",))]
    gone = np.concatenate([np.arange(0, 256, 7),
                           3 * pair[0].id_stride + np.arange(1, 256, 11)])
    for ix in pair:
        ix.delete(gone)
    device = {}
    for lane, kw in HOST_LANES.items():
        spec = tss.SearchSpec(k=K, beam_width=BEAM, quantized=True, **kw)
        device[lane] = pair[1].searcher(spec).search(q)
    for ix in pair:
        ix.evict_rows_to_host()
    return pair, q, device


@pytest.mark.parametrize("lane", list(HOST_LANES))
def test_host_tier_on_positions_equals_device_tier(host_pair, lane):
    (one, many), q, device = host_pair
    assert many.rows_tier == "host"
    assert all(p.core.vectors is None for p in many._positions)
    spec = tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                          rerank_source="host", **HOST_LANES[lane])
    n_fetch = many.store.fetch_stats.n_fetches
    res = many.searcher(spec).search(q)
    assert many.store.fetch_stats.n_fetches == n_fetch + 1   # one a search
    assert _same(res, device[lane])
    assert _same(res, one.searcher(spec).search(q))


def test_host_tier_mutations_and_restore(host_pair):
    """Staged mutations on the host tier keep the layouts equal; the host
    rows are held once a shard; restore brings every position's rows
    back."""
    (one, many), q, _ = host_pair
    assert many.store.host_bytes == one.store.host_bytes
    assert many.memory_stats() == one.memory_stats()
    rng = np.random.default_rng(SEED + 51)
    new = _rows(rng, 4 * 300)                     # past the capacity: grows
    for ix in (one, many):
        ix.insert(new)
        ix.consolidate()
    assert many.cap == one.cap == 1024
    every = np.arange(one.capacity)
    for a, b in zip(one.store.gather(every), many.store.gather(every)):
        assert torch.equal(a, b)                  # the host rows
    spec = tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                          rerank_source="host", fusion="megakernel")
    assert _same(one.searcher(spec).search(q), many.searcher(spec).search(q))
    for ix in (one, many):
        ix.restore_rows_to_device()
    assert _replica_diffs(one, many) == []
    assert many.rows_tier == "device" and many.store.host_bytes == 0


# ----------------------------------------------------------------- service
def test_service_stream_equal_on_positions():
    """One AnnsService stream — deletes skewed onto shard 0, inserts,
    searches, a tenant — gives the same tickets and stats on 4 positions
    as on one device."""
    rng = np.random.default_rng(SEED + 60)
    data = _rows(rng, 4 * 256)
    outs = []
    for m in _layouts((2, 2), ("pod", "data")):
        idx = ShardedJasperIndex(m, D, 512, construction=_params(),
                                 quantization="rabitq", bits=4, seed=SEED)
        idx.build(data)
        svc = AnnsService(idx, spec=tss.SearchSpec(
            k=K, beam_width=BEAM, quantized=True, fusion="megakernel"),
            consolidate_threshold=0.05, rebalance_threshold=0.2,
            verify=True)
        svc.register_tenant("t")
        r = np.random.default_rng(SEED + 61)
        got = []
        for _ in range(4):
            live = np.flatnonzero(~idx.tombstoned(np.arange(idx.cap)))
            res = svc.step(deletes=np.sort(r.choice(live, 25, replace=False)),
                           inserts=_rows(r, 8), queries=_rows(r, 8))
            got.append((_np(res.search.ids).tolist(),
                        _np(res.search.dists).tolist(),
                        res.rebalanced is not None))
        svc.tenant_insert("t", _rows(r, 8))
        t = svc.tenant_search("t", _rows(r, 4))
        got.append(_np(t.ids).tolist())
        outs.append((got, svc.stats.as_dict()))
    assert outs[0] == outs[1]
    assert any(step[2] for step in outs[0][0][:4])      # a rebalance ran


# ------------------------------------------------------------ against JAX
@pytest.fixture(scope="module")
def loaded(jax_side):
    """JAX's checkpoints in the port, by (mesh, state), on both layouts."""
    out = {}
    for mname, (shape, axes, rows) in MESHES.items():
        spec = None if rows is None else ShardSpec(row_axes=rows,
                                                   query_axis=None)
        for state in ("clean", "tomb"):
            path = f"{jax_side['dir'][mname]}/{state}"
            out[mname, state] = tuple(
                ShardedJasperIndex.load(m, path, spec=spec)
                for m in _layouts(shape, axes))
    return out


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("state", ["clean", "tomb"])
@pytest.mark.parametrize("lane", list(LANES))
def test_search_on_positions_matches_jax(jax_side, loaded, mname, state,
                                         lane):
    one, many = loaded[mname, state]
    assert many.n_positions == int(np.prod(MESHES[mname][0]))
    want = jax_side[f"{mname}/{state}/{lane}"]
    q = np.asarray(jax_side["queries"], np.float32)
    res = _search(many, lane, q)
    assert np.array_equal(_np(res.ids), np.asarray(want["ids"]))
    assert np.array_equal(_np(res.n_hops), np.asarray(want["hops"]))
    np.testing.assert_allclose(_np(res.dists), np.asarray(want["dists"]),
                               rtol=DIST_RTOL, atol=DIST_ATOL)
    ids = _np(res.ids)
    assert not many.tombstoned(ids[ids >= 0]).any()
    assert _same(res, _search(one, lane, q))
    if "telemetry" in lane:
        # the int32 sum of the shards' own searches (each on all queries)
        rspec = tss.SearchSpec(k=K, beam_width=BEAM,
                               **LANES[lane]).resolve(many)
        per = [core_search(many.shard_core(s), torch.as_tensor(q),
                           spec=rspec,
                           filter_tombstones=many._filter_tombstones)[3]
               for s in range(many.n_shards)]
        for i, g in enumerate(res.telemetry):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(
                _np(g), np.sum([_np(p[i]) for p in per], axis=0,
                               dtype=np.int32))


def _life_op(step, rec):
    """A lifecycle step's own output on the positions, as the JAX script
    records it."""
    e = rec.get("extra")
    if step == "consolidate":
        return [e[1]["n_freed"], e[1]["n_repaired"]]
    if step == "rebalance":
        return list(e[1])
    if step.startswith("load"):
        return rec["op"]
    return e[1]


@pytest.mark.parametrize("step", LIFE_STEPS)
def test_lifecycle_on_positions_matches_jax(jax_side, lifecycle, reloaded,
                                            step):
    """The lifecycle's eight positions against the JAX package's (4, 2)
    mesh running the same op stream: each step's own output (the insert's
    ids, the rows deleted, freed and repaired, the capacity, the rows
    moved and their new ids, the reshard's id map), the live count, and
    every lane's ids and hops, dists within tolerance."""
    rec = reloaded[step] if step.startswith("load") else lifecycle[0][step]
    if step != "build":
        assert _life_op(step, rec) == jax_side[f"life/{step}/op"]
    assert rec["size"][1] == jax_side[f"life/{step}/size"]
    for lane in LIFE_LANES:
        want = jax_side[f"life/{step}/{lane}"]
        ids, dists, hops = rec["res"][lane]
        assert np.array_equal(ids, np.asarray(want["ids"])), lane
        assert np.array_equal(hops, np.asarray(want["hops"])), lane
        np.testing.assert_allclose(dists, np.asarray(want["dists"]),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)


@pytest.mark.parametrize("mname", list(MESHES))
def test_brute_force_on_positions_matches_jax(jax_side, loaded, mname):
    one, many = loaded[mname, "tomb"]
    q = np.asarray(jax_side["queries"], np.float32)
    ids, dists = many.brute_force(q, K)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(_np(ids),
                                  np.asarray(jax_side["brute"]["ids"]))
    np.testing.assert_array_equal(_np(dists),
                                  np.asarray(jax_side["brute"]["dists"]))
    a = one.brute_force(q, K)
    assert torch.equal(a[0], ids) and torch.equal(a[1], dists)
