"""The sharded host rows tier and sharded serving of the port.

Part 1, the port on its own: a 4-shard RaBitQ index with tombstones,
searched on the six host-tier lanes before and after
`evict_rows_to_host` — with the rows on the host (stacked (S*cap, D), one
gather a search, each shard reranked by the single-device body, then the
same `merge_topk`) ids, dists, hops and telemetry equal the device tier's
bit for bit. Then the plan keys, zero steady-state retraces, churn under
staging across a grow, the checkpoint's tier and brute force evicted.

Part 2, against the JAX package (one subprocess, eight fake host
devices): a 4-shard index built there on integer-valued rows is crossed
into the port by its checkpoint. The host tiers of both packages agree
(ids and hops equal, dists within rtol 1e-3 / atol 1e-2), and so do
`memory_stats` / `storage_stats`. One service stream — ticks of deletes
skewed onto shard 0, inserts and searches — goes through both packages'
`AnnsService` with a rebalance threshold: the ticks that consolidate and
rebalance, the moved counts and translations, `ServiceStats`, the
`shards.*` gauges and the snapshot keys are equal, the tickets' ids agree
to the conformance bar (>= 0.95) with dists within the tolerances.
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
from repro_torch.core.distributed import ShardedJasperIndex
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.anns_service import AnnsService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, PER, D, Q, K, BEAM = 23, 256, 16, 16, 10, 32
PARAMS = dict(degree_bound=16, alpha=1.2, beam_width=16, max_iters=24,
              rev_cap=16, prune_chunk=256)
DIST_RTOL, DIST_ATOL = 1e-3, 1e-2
ID_AGREEMENT = 0.95
CLOCK_KEYS = ("fetch_total_s", "fetch_last_s")
HOST_LANES = {
    "jnp": {},
    "kernel": {"use_kernels": True},
    "hop": {"fusion": "hop"},
    "megakernel": {"fusion": "megakernel"},
    "telemetry": {"telemetry": "on"},
    "filtered": {"filter": (1,)},
}

# one service stream, run verbatim by both packages
_SERVICE = """
def run_service(Service, SearchSpec, idx):
    rng = np.random.default_rng(SEED + 9)

    def ints(n):
        return rng.integers(-6, 7, (n, D)).astype(np.float32)

    svc = Service(idx, spec=SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                       fusion="megakernel"),
                  consolidate_threshold=0.05, rebalance_threshold=0.3,
                  verify=True)
    out = dict(ticks=[], tickets=[])
    for tick in range(6):
        local = np.arange(idx.cap)
        live0 = local[~idx.tombstoned(local)]
        dead = np.sort(rng.choice(live0, 30, replace=False))
        res = svc.step(deletes=dead, inserts=ints(8), queries=ints(8))
        reb = res.rebalanced
        out["ticks"].append(dict(
            inserted=np.asarray(res.inserted_ids).tolist(),
            n_deleted=int(res.n_deleted),
            consolidated=res.consolidated,
            rebalanced=None if reb is None else dict(
                n_moved=reb["n_moved"], counts=reb["counts_after"],
                old=reb["translation"].old_ids.tolist(),
                new=reb["translation"].new_ids.tolist()),
            live=[int(x) for x in idx.shard_live_counts()],
            imbalance=float(idx.shard_imbalance)))
        t = res.search
        out["tickets"].append(dict(ids=np.asarray(t.ids).tolist(),
                                   dists=np.asarray(t.dists).tolist(),
                                   generation=int(t.generation)))
    forced = svc.maybe_rebalance(force=True)
    out["forced"] = None if forced is None else forced["n_moved"]
    out["stats"] = svc.stats.as_dict()
    snap = svc.metrics_snapshot()
    out["keys"] = sorted(snap)
    out["shards"] = {k: snap[k] for k in snap if k.startswith("shards.")}
    return out
"""

_JAX_SCRIPT = """
import json, sys, numpy as np
from repro.launch.mesh import make_mesh
from repro.core.construction import ConstructionParams
from repro.core.distributed import ShardedJasperIndex
from repro.core.search_spec import SearchSpec
from repro.serving.anns_service import AnnsService

out_dir = sys.argv[1]
SEED, PER, D, Q, K, BEAM = {SEED}, {PER}, {D}, {Q}, {K}, {BEAM}
HOST_LANES = {HOST_LANES!r}
CLOCK_KEYS = {CLOCK_KEYS!r}
{SERVICE}
rng = np.random.default_rng(SEED)
data = rng.integers(-6, 7, (4 * PER, D)).astype(np.float32)
queries = rng.integers(-6, 7, (Q, D)).astype(np.float32)
mesh = make_mesh((4, 2), ("data", "model"))
idx = ShardedJasperIndex(mesh, D, 2 * PER,
                         construction=ConstructionParams(**{PARAMS!r}),
                         quantization="rabitq", bits=4, seed=SEED)
idx.build(data, labels=(np.arange(4 * PER) % 2).astype(np.int32))
idx.delete(np.concatenate([rng.choice(PER, 20, replace=False),
                           3 * idx.id_stride + rng.choice(PER, 9,
                                                          replace=False)]))
idx.save(out_dir + "/crossed")
report = dict(queries=queries.tolist())

def stats(i):
    return dict(memory=i.memory_stats(),
                storage={{k: v for k, v in i.storage_stats().items()
                         if k not in CLOCK_KEYS}})

report["device_stats"] = stats(idx)
idx.evict_rows_to_host()
for lane, kw in HOST_LANES.items():
    r = idx.searcher(SearchSpec(k=K, beam_width=BEAM, quantized=True,
                                rerank_source="host", **kw)).search(queries)
    report["host/" + lane] = dict(ids=np.asarray(r.ids).tolist(),
                                  dists=np.asarray(r.dists).tolist(),
                                  hops=np.asarray(r.n_hops).tolist())
report["host_stats"] = stats(idx)
svc_idx = ShardedJasperIndex.load(mesh, out_dir + "/crossed")
report["service"] = run_service(AnnsService, SearchSpec, svc_idx)
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


def _mesh():
    return make_mesh((4, 2), ("data", "model"), device="cpu")


def _index(**kw):
    return ShardedJasperIndex(_mesh(), D, 2 * PER,
                              construction=TParams(**PARAMS),
                              quantization="rabitq", bits=4, seed=SEED, **kw)


def _same(a, b) -> bool:
    same = (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.n_hops, b.n_hops))
    if a.telemetry is not None or b.telemetry is not None:
        same = same and all(torch.equal(x, y)
                            for x, y in zip(a.telemetry, b.telemetry))
    return same


def _spec(source, **kw):
    return tss.SearchSpec(k=K, beam_width=BEAM, quantized=True,
                          rerank_source=source, **kw)


# ------------------------------------------------ part 1: the port alone
@pytest.fixture(scope="module")
def tier_pair():
    """Device-tier results for every lane, then the same index evicted."""
    rng = np.random.default_rng(SEED)
    data = rng.normal(size=(4 * PER, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    idx = _index()
    idx.build(data, labels=(np.arange(4 * PER) % 2).astype(np.int32))
    idx.delete(np.arange(0, 4 * idx.id_stride, 7)[
        ~idx.tombstoned(np.arange(0, 4 * idx.id_stride, 7))])
    device = {lane: idx.searcher(_spec("device", **kw)).search(queries)
              for lane, kw in HOST_LANES.items()}
    rows = idx.capacity * (D + 1) * 4
    idx.evict_rows_to_host()
    return idx, queries, device, rows


@pytest.mark.parametrize("lane", list(HOST_LANES))
def test_sharded_host_tier_bit_identical(tier_pair, lane):
    idx, queries, device, _ = tier_pair
    host = idx.searcher(_spec("host", **HOST_LANES[lane])).search(queries)
    assert _same(device[lane], host)
    assert (host.telemetry is not None) == (lane == "telemetry")
    ids = _np(host.ids)
    assert not idx.tombstoned(ids[ids >= 0]).any()


def test_sharded_host_tier_memory_and_plans(tier_pair):
    idx, queries, _, rows = tier_pair
    mem = idx.memory_stats()
    assert mem["rows_tier"] == "host" and idx.core.vectors is None
    assert mem["device_rows_bytes"] == 0.0
    assert mem["host_rows_bytes"] == rows
    assert mem["device_compression_ratio"] > 1.0
    spec = _spec("host", fusion="megakernel")
    idx.searcher(spec).search(queries)
    before = idx.plans.stats.snapshot()
    n_fetch = idx.store.fetch_stats.n_fetches
    for _ in range(3):
        idx.searcher(spec).search(queries)
    delta = idx.plans.stats.delta(before)
    assert delta["traces"] == 0 and delta["misses"] == 0
    assert idx.store.fetch_stats.n_fetches == n_fetch + 3   # one a search
    keys = [k[0] for k in idx.plans._plans]
    assert "rerank_host" in keys and "search" in keys


def test_sharded_host_tier_churn_and_checkpoint(tmp_path):
    """Staged delete / insert / consolidate / grow on the host tier keep it
    equal to the same ops on the device tier; the checkpoint keeps the
    tier; brute force works with the rows evicted."""
    rng = np.random.default_rng(SEED + 1)
    data = rng.normal(size=(4 * PER, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    new = rng.normal(size=(4, PER + 40, D)).astype(np.float32)  # grows
    dead = np.arange(5, PER, 9)
    pair = []
    for tier in ("device", "host"):
        idx = _index(rows_tier=tier)
        idx.build(data)
        idx.delete(dead)
        idx.consolidate()
        ids = idx.insert(new)
        pair.append((idx, ids))
    (dev, ids_d), (host, ids_h) = pair
    assert host.rows_tier == "host" and host.cap == dev.cap == 4 * PER
    assert np.array_equal(ids_d, ids_h)
    a = dev.searcher(_spec("device", fusion="megakernel")).search(queries)
    b = host.searcher(_spec("host", fusion="megakernel")).search(queries)
    assert _same(a, b)
    g1, d1 = dev.brute_force(queries, K)
    g2, d2 = host.brute_force(queries, K)
    assert torch.equal(g1, g2) and torch.equal(d1, d2)
    path = str(tmp_path / "host")
    host.save(path)
    back = ShardedJasperIndex.load(_mesh(), path)
    assert back.rows_tier == "host" and back.core.vectors is None
    c = back.searcher(_spec("host", fusion="megakernel")).search(queries)
    assert _same(b, c)
    back.restore_rows_to_device()
    assert torch.equal(back.core.vectors, dev.core.vectors)


# ------------------------------------------------ part 2: the JAX package
@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_tier")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    script = _JAX_SCRIPT.format(SEED=SEED, PER=PER, D=D, Q=Q, K=K, BEAM=BEAM,
                                HOST_LANES=HOST_LANES, CLOCK_KEYS=CLOCK_KEYS,
                                PARAMS=PARAMS,
                                SERVICE=textwrap.dedent(_SERVICE))
    run = subprocess.run([sys.executable, "-c", script, str(out)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    with open(out / "report.json") as f:
        report = json.load(f)
    report["dir"] = str(out)
    return report


@pytest.fixture(scope="module")
def crossed(jax_side):
    idx = ShardedJasperIndex.load(_mesh(), f"{jax_side['dir']}/crossed")
    return idx.evict_rows_to_host()


def _tier_stats(idx):
    return dict(memory=idx.memory_stats(),
                storage={k: v for k, v in idx.storage_stats().items()
                         if k not in CLOCK_KEYS})


@pytest.mark.parametrize("lane", list(HOST_LANES))
def test_host_tier_matches_jax(jax_side, crossed, lane):
    idx = crossed
    q = np.asarray(jax_side["queries"], np.float32)
    res = idx.searcher(_spec("host", **HOST_LANES[lane])).search(q)
    want = jax_side[f"host/{lane}"]
    assert _np(res.ids).tolist() == want["ids"]
    assert _np(res.n_hops).tolist() == want["hops"]
    np.testing.assert_allclose(_np(res.dists), np.asarray(want["dists"]),
                               rtol=DIST_RTOL, atol=DIST_ATOL)


def test_memory_and_storage_stats_match_jax(jax_side):
    idx = ShardedJasperIndex.load(_mesh(), f"{jax_side['dir']}/crossed")
    assert _tier_stats(idx) == jax_side["device_stats"]
    idx.evict_rows_to_host()
    q = np.asarray(jax_side["queries"], np.float32)
    for kw in HOST_LANES.values():     # the same fetches as JAX's searches
        idx.searcher(_spec("host", **kw)).search(q)
    assert _tier_stats(idx) == jax_side["host_stats"]


def test_service_stream_matches_jax(jax_side):
    idx = ShardedJasperIndex.load(_mesh(), f"{jax_side['dir']}/crossed")
    scope = dict(np=np, SEED=SEED, D=D, K=K, BEAM=BEAM)
    exec(textwrap.dedent(_SERVICE), scope)
    got = scope["run_service"](AnnsService, tss.SearchSpec, idx)
    want = jax_side["service"]
    assert got["ticks"] == want["ticks"]
    assert any(t["rebalanced"] for t in got["ticks"]), "never rebalanced"
    assert any(t["consolidated"] for t in got["ticks"])
    for a, b in zip(got["tickets"], want["tickets"]):
        assert a["generation"] == b["generation"]
        assert np.mean(np.asarray(a["ids"]) == np.asarray(b["ids"])) \
            >= ID_AGREEMENT
        np.testing.assert_allclose(a["dists"], b["dists"], rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
    assert got["forced"] == want["forced"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["n_rebalances"] >= 1
    assert got["keys"] == want["keys"]
    assert got["shards"] == want["shards"]
    assert got["shards"]["shards.count"] == 4


def test_single_device_shard_gauges_match_jax():
    """The degenerate single-shard view of a JasperIndex gives the JAX
    package's keys and values."""
    from repro.core.construction import ConstructionParams as JParams
    from repro.core.index import JasperIndex as JIndex
    from repro.obs.metrics import shard_gauge_collector as j_gauges
    from repro_torch.core.index import JasperIndex as TIndex
    from repro_torch.obs.metrics import shard_gauge_collector as t_gauges
    rows = np.random.default_rng(SEED + 2).integers(
        -6, 7, (300, D)).astype(np.float32)
    j = JIndex(D, 512, construction=JParams(**PARAMS))
    t = TIndex(D, 512, construction=TParams(**PARAMS), device="cpu")
    j.build(rows)
    t.build(rows)
    assert t_gauges(t)() == j_gauges(j)()
