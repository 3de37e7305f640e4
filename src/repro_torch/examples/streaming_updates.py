"""Streaming updates ("built for change"): continuous batch insertion with
recall monitored as the index grows — paper Figs 6/7 as a live scenario —
plus a CHURN mode driving the full mutation engine (tombstone deletes,
batched consolidation, slot-reusing inserts) through the online serving
loop, with live recall and the zero-tombstoned-ids contract checked every
tick (the port of `examples/streaming_updates.py`, with its flags and its
`--quick` sizes).

    PYTHONPATH=src python -m repro_torch.examples.streaming_updates  # grow
    PYTHONPATH=src python -m repro_torch.examples.streaming_updates --churn
    PYTHONPATH=src python -m repro_torch.examples.streaming_updates \\
        --churn --quick --device cpu

The modes: grow (no flag), --churn, --churn --sharded, --reshard, --serve,
--tenants, --tiered; --trace OUT.json records any of them. --sharded and
--reshard run on eight mesh positions, as the JAX lane's eight host
devices give them: a (4, 2) mesh over ("data", "model") for --sharded, and
(4, 2) then (2, 4) for --reshard. With --device cpu the eight positions
are the CPU; on the card they are the machine's cards repeated to fill
eight positions (one card: eight positions of it).

Runs on the card unless `--device cpu` is given; raises without a card.
Every `run_*` returns its per-tick rows as data beside printing them.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.construction import ConstructionParams
from repro_torch.core.index import JasperIndex
from repro_torch.core.search_spec import SearchSpec
from repro_torch.device import resolve_device, synchronize

# ONE declarative serve configuration for the whole churn scenario — the
# service resolves it once into a Searcher session
SERVE_SPEC = SearchSpec(k=10, beam_width=48, quantized=True)

PARAMS = ConstructionParams(degree_bound=32, beam_width=32,
                            max_iters=48, rev_cap=32)
QUICK_PARAMS = ConstructionParams(degree_bound=16, beam_width=16,
                                  max_iters=24, rev_cap=16, prune_chunk=256)

# the mesh positions of --sharded and --reshard: the JAX lane's eight
# host devices
N_POSITIONS = 8


def mesh_devices(device=None) -> list:
    """N_POSITIONS mesh positions: the CPU, or the machine's cards
    repeated to fill them."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * N_POSITIONS
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(N_POSITIONS)]


def run_streaming(total: int, batch: int, dims: int = 64,
                  device=None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    stream = rng.normal(size=(total, dims)).astype(np.float32)
    queries = rng.normal(size=(300, dims)).astype(np.float32)

    idx = JasperIndex(dims, capacity=total, construction=PARAMS, device=dev)
    print(f"{'size':>7s} {'batch_time':>10s} {'inserts/s':>10s} "
          f"{'recall@10':>9s}")
    rows = []
    pos = 0
    while pos < total:
        b = min(batch, total - pos)
        t0 = time.time()
        idx.insert(stream[pos:pos + b])
        synchronize(dev)
        dt = time.time() - t0
        pos += b
        r = idx.recall(queries, k=10, beam_width=48)
        rows.append({"size": idx.size, "batch_s": dt, "inserts_s": b / dt,
                     "recall": r})
        print(f"{idx.size:7d} {dt:9.1f}s {b / dt:10.0f} {r:9.3f}")

    print("\nthroughput decays sub-linearly with index size (paper Fig 6) "
          "and recall holds steady — no rebuilds happened.")
    return {"rows": rows}


def _make_sharded_index(dims: int, capacity: int, params, device=None):
    """ShardedJasperIndex over the eight mesh positions: 4 row shards x a
    2-way query axis."""
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh

    positions = mesh_devices(device)
    model = 2
    shape = (len(positions) // model, model)
    mesh = make_mesh(shape, ("data", "model"), device=positions)
    n_shards = shape[0]
    cap = -(-capacity // n_shards)
    cap += (-cap) % 8
    print(f"sharded: {n_shards} row shards x {model}-way query axis, "
          f"capacity {cap}/shard")
    return ShardedJasperIndex(mesh, dims, capacity_per_shard=cap,
                              construction=params, quantization="rabitq",
                              bits=4)


def _high_water(idx, sharded: bool):
    """Where fresh (non-reused) ids start: each shard's high-water mark,
    or the index's."""
    if sharded:
        return np.asarray([int(idx.shard_core(s).n_valid)
                           for s in range(idx.n_shards)])
    return int(idx.graph.n_valid)


def run_churn(n0: int, rounds: int, batch: int, dims: int,
              quick: bool, sharded: bool = False,
              telemetry: bool = False, device=None,
              spec: SearchSpec = SERVE_SPEC) -> dict:
    """Interleaved insert/delete/consolidate with live recall: the online
    update/serve loop over one index driver — single-device or sharded,
    the service code path is identical.

    With telemetry=True the service serves `spec.with_(telemetry="on")`
    (per-search kernel counters flow back through the ticket) and the
    unified metrics snapshot is returned under "metrics" for the --trace
    export. Returns the tick rows, the service stats and the session's
    plan-cache counters."""
    from repro_torch.serving.anns_service import AnnsService

    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    params = QUICK_PARAMS if quick else PARAMS
    if sharded:
        idx = _make_sharded_index(dims, int(n0 * 1.5), params, dev)
        # build and per-tick inserts deal rows evenly to shards — round
        # both down to shard multiples so any shard count works
        n0 -= n0 % idx.n_shards
        batch = max(idx.n_shards, batch - batch % idx.n_shards)
    else:
        idx = JasperIndex(dims, capacity=int(n0 * 1.5),
                          construction=params, quantization="rabitq", bits=4,
                          device=dev)
    data0 = rng.normal(size=(n0, dims)).astype(np.float32)
    idx.build(data0)
    queries = rng.normal(size=(100, dims)).astype(np.float32)
    serve_spec = spec.with_(telemetry="on") if telemetry else spec
    svc = AnnsService(idx, spec=serve_spec,
                      consolidate_threshold=0.15, verify=True)
    if telemetry:
        svc.metrics()                 # enable latency/hops/occupancy hists

    if sharded:
        per = n0 // idx.n_shards
        live = [idx.global_row(s, i) for s in range(idx.n_shards)
                for i in range(per)]
    else:
        live = list(range(n0))
    print(f"{'tick':>4s} {'size':>6s} {'del':>5s} {'ins':>5s} {'reused':>6s} "
          f"{'cons':>12s} {'gen':>4s} {'recall@10':>9s}")
    rows = []
    for t in range(rounds):
        dead = rng.choice(live, batch, replace=False)
        live = sorted(set(live) - set(dead.tolist()))
        hw_before = _high_water(idx, sharded)
        res = svc.step(deletes=dead,
                       inserts=rng.normal(size=(batch, dims))
                       .astype(np.float32),
                       queries=queries)
        live += res.inserted_ids.tolist()
        # serving contract: nothing tombstoned ever comes back (svc.verify
        # already asserts it; double-check against our own book-keeping)
        returned = res.search.ids[res.search.ids >= 0]
        assert np.isin(returned, live).all(), "tombstoned id returned!"
        if sharded:
            ins = res.inserted_ids
            reused = int(np.sum((ins % idx.id_stride)
                                < hw_before[ins // idx.id_stride]))
        else:
            reused = int((res.inserted_ids < hw_before).sum())
        r = idx.recall(queries, spec=spec)
        cons = (f"freed={res.consolidated['n_freed']}"
                if res.consolidated else "-")
        rows.append({"tick": t, "size": idx.size, "deleted": res.n_deleted,
                     "inserted": int(res.inserted_ids.size),
                     "reused": reused,
                     "freed": (res.consolidated["n_freed"]
                               if res.consolidated else None),
                     "generation": res.search.generation, "recall": r})
        print(f"{t:4d} {idx.size:6d} {res.n_deleted:5d} "
              f"{res.inserted_ids.size:5d} {reused:6d} {cons:>12s} "
              f"{res.search.generation:4d} {r:9.3f}")

    # spec-API lane check: the service's Searcher session must serve a
    # repeated (same-spec, same-shape) search straight from the plan
    # cache — zero retraces, one more hit
    ses = svc.searcher()
    ses.search(queries)
    mid = ses.cache_stats.snapshot()
    ses.search(queries)
    after = ses.cache_stats
    assert after.traces == mid.traces, \
        f"session reuse retraced: {mid} -> {after}"
    assert after.hits > mid.hits
    s = svc.stats.as_dict()
    print(f"\n{s['n_delete_rows']} deletes + {s['n_insert_rows']} inserts "
          f"+ {s['n_consolidations']} consolidations served across "
          f"{s['last_generation']} generations; mean hops/query "
          f"{s['mean_hops']:.1f}; recall held with zero tombstoned ids "
          f"returned — the index absorbed the churn without a rebuild. "
          f"Plan cache: {after.as_dict()} (reused session, zero retraces).")
    return {"rows": rows, "stats": s, "cache": after.as_dict(),
            "metrics": svc.metrics_snapshot() if telemetry else None}


def run_serve(n0: int, dims: int, quick: bool,
              telemetry: bool = False, device=None) -> dict:
    """Open-loop serving scenario (the serving smoke lane): build once,
    then replay seeded Poisson and bursty arrival traces through the
    standing-query scheduler — two priority lanes with different
    SearchSpecs, shape-bucketed coalescing, deadline-aware flushes — and
    hold the scheduler's two contracts: zero plan-cache retraces in
    steady state, and zero padding-row / tombstone leaks into tickets.
    Returns the three replays' reports."""
    from repro_torch.core.search_spec import BUCKET_LADDER
    from repro_torch.serving.anns_service import AnnsService
    from repro_torch.serving.loadgen import bursty_trace, poisson_trace

    dev = resolve_device(device)
    rng = np.random.default_rng(4)
    params = QUICK_PARAMS if quick else PARAMS
    buckets = (1, 8, 32) if quick else BUCKET_LADDER
    n_arr = 200 if quick else 2000
    idx = JasperIndex(dims, capacity=n0, construction=params,
                      quantization="rabitq", bits=4, device=dev)
    idx.build(rng.normal(size=(n0, dims)).astype(np.float32))
    pool = rng.normal(size=(64, dims)).astype(np.float32)
    # two workload classes over one index: the bulk lane serves the
    # churn scenario's spec, the interactive lane a narrow-beam variant
    # at higher priority (lower value = dispatched first)
    interactive = SearchSpec(k=10, beam_width=16, quantized=True)
    svc = AnnsService(idx, spec=SERVE_SPEC, verify=True)
    if telemetry:
        svc.metrics()
    for spec in (SERVE_SPEC, interactive):
        ses = idx.searcher(spec)
        for b in buckets:                 # plan every ladder rung once
            ses.search(np.repeat(pool[:1], b, axis=0))
    lanes = {"interactive": (interactive, -1)}
    lane_mix = dict(lanes=("default", "interactive"),
                    lane_weights=(0.7, 0.3))

    # saturation replay: offered load -> infinity, coalescing at work
    trace = poisson_trace(1e6, n_arr, n_queries=pool.shape[0], seed=40,
                          slo_budget_s=10.0, **lane_mix)
    before = idx.plans.stats.snapshot()
    sat, handles = svc.serve(trace, pool, lanes=lanes, buckets=buckets,
                             realtime=False, max_queue=n_arr + 1,
                             slo_budget_s=10.0)
    delta = idx.plans.stats.delta(before)
    assert delta["traces"] == 0 and delta["misses"] == 0, \
        f"steady-state serving retraced: {delta}"
    assert sat["completed"] == n_arr and sat["rejected"] == 0, sat
    assert all(h.ids.shape == (SERVE_SPEC.k,) for h in handles
               if h.lane == "default"), "padding rows leaked into tickets"
    print(f"saturation: {sat['qps']:.0f} q/s over {sat['batches']} batches "
          f"(occupancy {sat['mean_batch_occupancy']:.2f}, "
          f"flushes {sat['flush_reasons']})")
    reports = {"saturation": sat}

    # realtime open-loop replays at a rate the index can absorb
    rate = max(200.0, sat["qps"] * 0.4)
    for name, trace in (
        ("poisson", poisson_trace(rate, n_arr, n_queries=pool.shape[0],
                                  seed=41, slo_budget_s=0.2, **lane_mix)),
        ("bursty", bursty_trace(rate, n_arr, n_queries=pool.shape[0],
                                seed=42, slo_budget_s=0.2, **lane_mix)),
    ):
        before = idx.plans.stats.snapshot()
        rep, _ = svc.serve(trace, pool, lanes=lanes, buckets=buckets,
                           slo_budget_s=0.2, realtime=True)
        delta = idx.plans.stats.delta(before)
        assert delta["traces"] == 0, f"{name} replay retraced: {delta}"
        assert rep["completed"] == n_arr, rep
        reports[name] = rep
        print(f"{name:>10s}: {rep['qps']:.0f} q/s p50={rep['p50_ms']:.1f}ms "
              f"p99={rep['p99_ms']:.1f}ms slo_hit={rep['slo_hit_rate']:.2f} "
              f"occupancy {rep['mean_batch_occupancy']:.2f}")

    print(f"\nserved {3 * n_arr} open-loop queries across two priority "
          "lanes with zero steady-state retraces and zero contract "
          "violations — coalescing stayed inside the planned ladder the "
          "whole time.")
    return {"n_arrivals": n_arr, "reports": reports,
            "metrics": svc.metrics_snapshot() if telemetry else None}


def run_tenants(n0: int, rounds: int, dims: int, quick: bool,
                device=None) -> dict:
    """Multi-tenant churn scenario (the filter smoke lane): two tenants
    sharing one index, each inserting/deleting/searching its own
    namespace through the label-filter plane — per-tick isolation checks
    (a tenant never sees another tenant's rows, in either filter mode),
    quota enforcement, and the one-plan-per-lane contract (tenant filter
    VALUES are runtime operands, so tenant count never multiplies the
    plan cache). Returns the tick rows and the plan count."""
    from repro_torch.serving.anns_service import AnnsService

    dev = resolve_device(device)
    rng = np.random.default_rng(5)
    params = QUICK_PARAMS if quick else PARAMS
    idx = JasperIndex(dims, capacity=int(n0 * 2), construction=params,
                      quantization="rabitq", bits=4, device=dev)
    svc = AnnsService(idx, spec=SERVE_SPEC, consolidate_threshold=0.2,
                      verify=True)
    quota = n0
    svc.register_tenant("acme", quota_rows=quota)
    svc.register_tenant("bolt")
    owned = {"acme": [], "bolt": []}
    for name in owned:
        ids = svc.tenant_insert(
            name, rng.normal(size=(n0 // 2, dims)).astype(np.float32))
        owned[name] = ids.tolist()
    queries = rng.normal(size=(50, dims)).astype(np.float32)

    print(f"{'tick':>4s} {'tenant':>6s} {'live':>6s} {'del':>4s} "
          f"{'ins':>4s} {'leaks':>5s}")
    rows = []
    batch = max(8, n0 // 20)
    for t in range(rounds):
        for name in ("acme", "bolt"):
            kill = rng.choice(owned[name], batch, replace=False)
            svc.tenant_delete(name, kill)
            owned[name] = sorted(set(owned[name]) - set(kill.tolist()))
            ids = svc.tenant_insert(
                name, rng.normal(size=(batch, dims)).astype(np.float32))
            owned[name] += ids.tolist()
            # isolation check in BOTH filter modes, against our own
            # book-keeping (tenant_search's verify already re-checks
            # against the device label plane)
            leaks = 0
            for mode in ("traverse", "exclude"):
                res = svc.tenant_search(name, queries, filter_mode=mode)
                got = res.ids[res.ids >= 0]
                leaks += int((~np.isin(got, owned[name])).sum())
            assert leaks == 0, f"tenant {name} leak at tick {t}"
            st = svc.tenant_stats(name)
            rows.append({"tick": t, "tenant": name, "live": st["live"],
                         "deleted": batch, "inserted": batch,
                         "leaks": leaks})
            print(f"{t:4d} {name:>6s} {st['live']:6d} {batch:4d} "
                  f"{batch:4d} {leaks:5d}")

    # quota: an over-quota insert must raise BEFORE mutating anything
    gen = idx.generation
    over = quota - svc.tenant_stats("acme")["live"] + 1
    try:
        svc.tenant_insert("acme",
                          rng.normal(size=(over, dims)).astype(np.float32))
        raise AssertionError("quota not enforced")
    except ValueError:
        pass
    assert idx.generation == gen, "failed insert mutated the index"

    # plan sharing: both tenants' lanes resolve to ONE filtered spec, so
    # the second tenant's searches planned nothing new
    assert svc.tenant_spec("acme").resolve() \
        == svc.tenant_spec("bolt").resolve()
    n_plans = len(idx.plans)
    svc.tenant_search("acme", queries)
    svc.tenant_search("bolt", queries)
    assert len(idx.plans) == n_plans, "tenant search retraced"
    snap = svc.metrics_snapshot()
    tstats = {k: v for k, v in snap.items() if k.startswith("tenants.")}
    print(f"\ntenant smoke OK: {rounds} churn ticks x 2 tenants with zero "
          f"cross-tenant leaks in both filter modes; quota enforced "
          f"pre-mutation; {len(tstats)} tenant metric series; plan cache "
          f"shared across tenants ({n_plans} plans total).")
    return {"rows": rows, "n_plans": n_plans, "quota_refused": True}


def run_tiered(n0: int, rounds: int, batch: int, dims: int,
               quick: bool, device=None) -> dict:
    """Tiered-storage scenario (the tiering smoke lane): build a RaBitQ
    index, evict the f32 rows to the host VectorStore, and serve the
    churn loop with rerank_source="host" — traversal stays on the device
    over packed codes; only the final frontier is gathered host-side for
    exact rerank (docs/tiered_storage.md). Contracts held every tick:
    rows stay host-tier (zero device row bytes), mutations write
    through, host results are exact and bit-identical to the device
    tier, and steady-state serving never retraces. Returns the tick
    rows, the steady-state plan-cache delta and the storage stats."""
    from repro_torch.serving.anns_service import AnnsService

    dev = resolve_device(device)
    rng = np.random.default_rng(6)
    params = QUICK_PARAMS if quick else PARAMS
    idx = JasperIndex(dims, capacity=int(n0 * 1.5), construction=params,
                      quantization="rabitq", bits=4, device=dev)
    idx.build(rng.normal(size=(n0, dims)).astype(np.float32))
    queries = rng.normal(size=(100, dims)).astype(np.float32)

    dev_mem = idx.memory_stats()
    res_dev = idx.searcher(SERVE_SPEC).search(queries)   # device-tier ref
    idx.evict_rows_to_host()
    mem = idx.memory_stats()
    assert mem["rows_tier"] == "host" and mem["device_rows_bytes"] == 0.0
    print(f"evicted: {dev_mem['device_rows_bytes'] / 1e6:.2f} MB of f32 "
          f"rows -> host ({mem['host_rows_bytes'] / 1e6:.2f} MB); device "
          f"holds codes only ({mem['device_codes_bytes'] / 1e6:.2f} MB, "
          f"{mem['device_compression_ratio']:.1f}x compression)")

    host_spec = SERVE_SPEC.with_(rerank_source="host")
    svc = AnnsService(idx, spec=host_spec, consolidate_threshold=0.15,
                      verify=True)
    # correctness anchor: host tier == device tier on the same core
    res_host = svc.search(queries)
    assert res_host.estimated is False
    assert np.array_equal(np.asarray(res_host.ids),
                          res_dev.ids.cpu().numpy())
    assert np.array_equal(np.asarray(res_host.dists),
                          res_dev.dists.cpu().numpy()), \
        "host-tier rerank diverged from the device tier"
    # code-only lane on the same evicted index reports itself honestly
    res_none = idx.searcher(SERVE_SPEC.with_(rerank=False)).search(queries)
    assert res_none.estimated is True

    live = list(range(n0))
    print(f"{'tick':>4s} {'size':>6s} {'del':>5s} {'ins':>5s} "
          f"{'dev_rows_B':>10s} {'recall@10':>9s}")
    rows = []
    for t in range(rounds):
        dead = rng.choice(live, batch, replace=False)
        live = sorted(set(live) - set(dead.tolist()))
        res = svc.step(deletes=dead,
                       inserts=rng.normal(size=(batch, dims))
                       .astype(np.float32),
                       queries=queries)
        live += res.inserted_ids.tolist()
        returned = res.search.ids[res.search.ids >= 0]
        assert np.isin(returned, live).all(), "tombstoned id returned!"
        assert res.search.estimated is False
        mem = idx.memory_stats()
        assert mem["rows_tier"] == "host", "mutation flipped the tier!"
        assert mem["device_rows_bytes"] == 0.0, \
            "mutation leaked f32 rows back onto the device!"
        r = idx.recall(queries, spec=host_spec)
        rows.append({"tick": t, "size": idx.size, "deleted": res.n_deleted,
                     "inserted": int(res.inserted_ids.size),
                     "device_rows_bytes": mem["device_rows_bytes"],
                     "recall": r})
        print(f"{t:4d} {idx.size:6d} {res.n_deleted:5d} "
              f"{res.inserted_ids.size:5d} {mem['device_rows_bytes']:10.0f} "
              f"{r:9.3f}")

    # steady state: every plan (traversal, host rerank, liveness modes)
    # was made during the churn warmup — repeated serving must come
    # straight from the cache on the host tier too
    before = idx.plans.stats.snapshot()
    for _ in range(3):
        svc.search(queries)
    delta = idx.plans.stats.delta(before)
    assert delta["traces"] == 0 and delta["misses"] == 0, \
        f"host-tier steady state retraced: {delta}"

    st = idx.storage_stats()
    print(f"\ntiered smoke OK: {rounds} churn ticks served rows-evicted "
          f"with write-through keeping device row bytes at 0, host rerank "
          f"bit-identical to the device tier, and zero steady-state "
          f"retraces ({delta}); frontier gathers moved "
          f"{st['fetch_n_bytes'] / 1e6:.2f} MB across "
          f"{st['fetch_n_fetches']} fetches.")
    return {"rows": rows, "steady_delta": delta, "storage": st}


def run_reshard(n0: int, dims: int, quick: bool, device=None) -> dict:
    """Elastic-resharding scenario (the reshard smoke lane): build at 4
    shards -> checkpoint -> restore at 2 shards -> churn through the
    backend-agnostic serve loop -> verify the id-translation and
    no-tombstoned-ids contracts every tick. Returns both recalls, the
    sizes and the tick rows."""
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.anns_service import AnnsService

    positions = mesh_devices(device)    # the (4,2) and (2,4) meshes need 8
    params = QUICK_PARAMS if quick else PARAMS
    rng = np.random.default_rng(3)
    n0 -= n0 % 4
    data = rng.normal(size=(n0, dims)).astype(np.float32)
    queries = rng.normal(size=(100, dims)).astype(np.float32)

    mesh4 = make_mesh((4, 2), ("data", "model"), device=positions)
    cap = -(-int(n0 * 1.5) // 4)
    cap += (-cap) % 8
    idx4 = ShardedJasperIndex(mesh4, dims, capacity_per_shard=cap,
                              construction=params, quantization="rabitq",
                              bits=4)
    idx4.build(data)
    per = n0 // 4
    dead = np.asarray([idx4.global_row(s, i) for s in range(4)
                       for i in rng.choice(per, per // 10, replace=False)])
    idx4.delete(dead)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck")
        idx4.save(path)
        r4 = idx4.recall(queries, k=10, beam_width=48)
        print(f"saved at 4 shards: {idx4.size} live rows, recall {r4:.3f}")

        mesh2 = make_mesh((2, 4), ("data", "model"), device=positions)
        idx2 = ShardedJasperIndex.load(mesh2, path, n_shards=2)
    tr = idx2.reshard_translation
    assert idx2.size == idx4.size
    assert (tr.apply(dead) == -1).all(), "dead ids must stay dead"
    r2 = idx2.recall(queries, k=10, beam_width=96)   # equal total budget
    print(f"restored at 2 shards: {idx2.size} live rows, recall {r2:.3f}, "
          f"{len(tr)} ids translated")
    assert r2 >= r4 - 0.05, (r2, r4)
    out = {"r4": r4, "r2": r2, "size4": idx4.size, "size2": idx2.size,
           "translated": len(tr)}

    svc = AnnsService(idx2, spec=SERVE_SPEC, consolidate_threshold=0.15,
                      rebalance_threshold=0.25, verify=True)
    live = tr.apply(tr.old_ids).tolist()
    rows = []
    for t in range(3):
        kill = rng.choice(live, 40, replace=False)
        live = sorted(set(live) - set(kill.tolist()))
        res = svc.step(deletes=kill,
                       inserts=rng.normal(size=(40, dims))
                       .astype(np.float32),
                       queries=queries)
        # rebalance (if it fired) ran BEFORE the tick's insert, so the
        # translation applies to pre-existing ids only — a fresh id may
        # legitimately reuse a donor-freed slot and must not be remapped
        if res.rebalanced is not None:
            live = res.rebalanced["translation"].apply(
                np.asarray(live)).tolist()
        live += res.inserted_ids.tolist()
        returned = res.search.ids[res.search.ids >= 0]
        assert np.isin(returned, live).all(), "tombstoned id returned!"
        r = idx2.recall(queries, k=10, beam_width=48)
        rows.append({"tick": t, "size": idx2.size,
                     "generation": res.search.generation, "recall": r})
        print(f"tick {t}: size {idx2.size} gen {res.search.generation} "
              f"recall {r:.3f}")
    print("reshard smoke OK: restore at a different shard count served "
          "churn with the id-translation + zero-tombstoned-ids contracts "
          "intact.")
    return out | {"rows": rows}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--churn", action="store_true",
                    help="interleaved insert/delete/consolidate scenario")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes (CI smoke scale)")
    ap.add_argument("--sharded", action="store_true",
                    help="churn over ShardedJasperIndex on eight mesh "
                         "positions")
    ap.add_argument("--reshard", action="store_true",
                    help="save at 4 shards, restore at 2, churn, verify")
    ap.add_argument("--serve", action="store_true",
                    help="open-loop serving: seeded Poisson/bursty traces "
                         "through the standing-query scheduler")
    ap.add_argument("--tiered", action="store_true",
                    help="tiered storage: evict f32 rows to the host "
                         "tier, churn + serve with rerank_source='host' "
                         "(bit-identity, write-through, zero-retrace "
                         "checks)")
    ap.add_argument("--tenants", action="store_true",
                    help="multi-tenant churn: two tenants on one index "
                         "via the label-filter plane, per-tick isolation "
                         "+ quota + plan-sharing checks")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="export a Chrome trace (open in Perfetto / "
                         "chrome://tracing) of every service phase, plus "
                         "the unified metrics snapshot under a top-level "
                         "'metrics' key; churn runs also serve with "
                         "telemetry='on' so per-search kernel counters "
                         "feed the snapshot")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the mode the flags name; returns its `run_*` result."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    tracer = previous = None
    if args.trace:
        from repro_torch.obs.tracing import SpanTracer, set_tracer
        tracer = SpanTracer()
        previous = set_tracer(tracer)
    try:
        out = _run_mode(args, dev)
    finally:
        if tracer is not None:
            set_tracer(previous)

    if tracer is not None:
        snap = out.get("metrics")
        doc = tracer.to_chrome_trace()
        if snap is not None:
            doc["metrics"] = snap     # trace viewers ignore extra keys
        with open(args.trace, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"\nwrote {args.trace}: {len(doc['traceEvents'])} trace "
              f"events" + ("" if snap is None
                           else f" + metrics snapshot ({len(snap)} series)"))
    return out


def _run_mode(args, dev) -> dict:
    if args.tiered:
        return run_tiered(n0=600 if args.quick else 6000,
                          rounds=3 if args.quick else 6,
                          batch=60 if args.quick else 500, dims=64,
                          quick=args.quick, device=dev)
    if args.tenants:
        return run_tenants(n0=400 if args.quick else 4000,
                           rounds=3 if args.quick else 6, dims=64,
                           quick=args.quick, device=dev)
    if args.serve:
        return run_serve(n0=600 if args.quick else 6000, dims=64,
                         quick=args.quick,
                         telemetry=args.trace is not None, device=dev)
    if args.reshard:
        return run_reshard(n0=600 if args.quick else 4000, dims=64,
                           quick=args.quick, device=dev)
    if args.churn:
        if args.quick:
            return run_churn(n0=600, rounds=3, batch=60, dims=64,
                             quick=True, sharded=args.sharded,
                             telemetry=args.trace is not None, device=dev)
        return run_churn(n0=6000, rounds=6, batch=500, dims=64,
                         quick=False, sharded=args.sharded,
                         telemetry=args.trace is not None, device=dev)
    if args.quick:
        return run_streaming(total=3000, batch=750, device=dev)
    return run_streaming(total=12000, batch=1500, device=dev)


if __name__ == "__main__":
    main()
