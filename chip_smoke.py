#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # the full run: 1M x 128, 10,000 queries
    python3 chip_smoke.py --n 100000 --queries 2000    # a shorter run

Phases:
  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — compile the CUDA kernels from `src/repro_torch/csrc` (one
                nvcc per source, in parallel); print the seconds.
  3. selfcheck — each kernel against its plain PyTorch version on a small
                synthetic index, every template variant, exact arithmetic
                (`fused_hop` hop by hop over whole walks; `topk` on ties,
                all-+inf tails and widths that are not a multiple of 32).
  4. main path — bigann-shaped synthetic data; `JasperIndex.build` (Vamana
                construction + RaBitQ 4-bit codes); search with the
                megakernel + exact rerank, with the unfused loop over the
                `rabitq_search_step` kernel, and with the plain path; recall@10
                against a brute-force ground truth. Each path's kernel
                launch counters are zeroed just before its search and read
                just after; each path must launch exactly its own kernels.
  5. kernels vs plain at the main path's shapes: exact-arithmetic mode
                (integer-valued operands: bit-equal ids, dists, hops and
                telemetry) and realistic mode (id agreement >= 0.99, hops
                equal on >= 99% of queries, dists rtol 1e-4); times of each
                kernel, its plain version, its bound and, where one PyTorch
                call computes the same function, that call's time.
  6. churn round ("built for change") on the same index: delete 1% of the
                rows; search on the megakernel, hop (`fused_hop`) and
                merge-kernel (`rabitq_search_step` + `topk`) lanes with
                tombstones traversed and excluded; consolidate; insert 2%
                new rows (freed slots first, then past the capacity, which
                auto-grows to twice by copy-extension); search again. Checks
                zero tombstoned ids, recall@10, exact per-lane launch counts,
                hop lane == megakernel lane and merge-kernel lane ==
                topk-merge lane bit for bit, slot reuse, the resident prefix
                of every buffer byte-identical across the grow, and that the
                reused rows find themselves.

Prints the kernel JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, if
there is no CUDA device, a kernel fails to build, launch or agree, a path
skips its kernel, recall misses its floor, or a churn check fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32, outside the tensor cores
RECALL_FLOOR = 0.85
RECALL_SLACK = 0.01
SEED = 0                       # data, queries, the RaBitQ rotation
PRUNE_CHUNK = 16384            # RobustPrune rows per batch: memory only
SELF_HIT_FLOOR = 0.9           # reused rows found by their own vector, k=1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- operands
def int_query(rq, gen, lo=-3, hi=4):
    """Integer-valued query operands: every float sum is exact."""
    from repro_torch.core.rabitq import RaBitQQuery
    q, d = rq.q_rot.shape
    dev = rq.q_rot.device
    return RaBitQQuery(
        q_rot=torch.randint(lo, hi, (q, d), generator=gen).float().to(dev),
        query_add=torch.randint(0, 1000, (q,), generator=gen).float().to(dev),
        query_sumq=torch.randint(-100, 100, (q,),
                                 generator=gen).float().to(dev))


def int_codes(codes, gen, bits=None):
    """Integer-valued metadata (and, for another width, random packed
    bytes) over the same rows."""
    from repro_torch.core.rabitq import RaBitQCodes, packed_dim
    n = codes.packed.shape[0]
    dev = codes.packed.device
    bits = bits or codes.bits
    packed = codes.packed
    if bits != codes.bits:
        packed = torch.randint(0, 256, (n, packed_dim(codes.dims, bits)),
                               generator=gen, dtype=torch.uint8).to(dev)
    scale = torch.tensor([-2.0, -1.0, 1.0, 2.0])
    rescale = scale[torch.randint(0, 4, (n,), generator=gen)].to(dev)
    add = torch.randint(0, 50000, (n,), generator=gen).float().to(dev)
    return RaBitQCodes(packed=packed, data_add=add, data_rescale=rescale,
                       bits=bits, dims=codes.dims)


def random_masks(n, gen, dev):
    from repro_torch.core.mutations import pack_bitmap
    dead = torch.rand(n, generator=gen) < 0.1
    tomb = pack_bitmap(dead).to(dev)
    labels = torch.randint(0, 256, (n, 4), generator=gen,
                           dtype=torch.uint8)
    labels &= torch.tensor([0x0F, 0, 0, 0], dtype=torch.uint8)
    fb = torch.tensor([0x03, 0, 0, 0], dtype=torch.uint8)
    return tomb, labels.to(dev), fb.to(dev)


def fused_cases(core, queries, rq, gen, *, beam, max_iters):
    """(name, fused_operands kwargs) for every template variant, exact
    arithmetic: quantized 4 and 1 bit, exact L2, tombstone exclude, label
    exclude, telemetry, and one case with L > R + 1."""
    from repro_torch.kernels.search_step.ops import fused_operands
    graph = core.graph
    n = core.capacity
    tomb, labels, fb = random_masks(n, gen, core.device)
    iq = int_query(rq, gen)
    c4 = int_codes(core.codes, gen)
    c1 = int_codes(core.codes, gen, bits=1)
    iq1 = int_query(rq, gen, -1, 2)
    quant = dict(codes=c4, rq_query=iq)
    exact = dict(queries=queries, vectors=core.vectors,
                 vec_sqnorm=core.vec_sqnorm)
    wide = core.degree_bound * 2
    specs = [
        ("quant4", beam, quant, {}),
        ("quant1", beam, dict(codes=c1, rq_query=iq1), {}),
        ("exact", beam, exact, {}),
        ("quant4+tomb", beam, quant,
         dict(tombstone_bits=tomb, traverse_deleted=False)),
        ("quant4+labels", beam, quant,
         dict(labels=labels, filter_bytes=fb, filter_exclude=True)),
        ("exact+tomb+labels", beam, exact,
         dict(tombstone_bits=tomb, traverse_deleted=False, labels=labels,
              filter_bytes=fb, filter_exclude=True)),
        (f"quant4+L{wide}", wide, quant, {}),
    ]
    out = []
    for name, width, table, masks in specs:
        ops = fused_operands(graph, beam_width=width, max_iters=max_iters,
                             **table, **masks)
        for tel in (False, True):
            out.append((name + ("+tel" if tel else ""), ops, tel))
    return out


def compare_fused_exact(cases) -> None:
    from repro_torch.kernels.search_step.ops import (fused_search,
                                                     fused_search_plain)
    for name, ops, tel in cases:
        got = fused_search(**ops, telemetry=tel)
        want = fused_search_plain(**ops, telemetry=tel)
        torch.cuda.synchronize()
        labels = ("ids", "dists", "hops", "counters", "occupancy")
        for lab, g, w in zip(labels, got, want):
            same = torch.equal(g, w.to(g.dtype))
            if not same:
                bad = (g != w.to(g.dtype)).reshape(g.shape[0], -1).any(1)
                row = int(bad.nonzero()[0, 0])
                raise SmokeFailure(
                    f"fused_search {name}: {lab} differ on "
                    f"{int(bad.sum())} queries; first q={row}: kernel "
                    f"{g[row][:12].tolist()} plain {w[row][:12].tolist()}")
        log(f"  fused_search {name}: bit-equal on {got[0].shape[0]} queries "
            f"(L={got[0].shape[1]}, mean hops "
            f"{float(got[2].float().mean()):.2f})")


def compare_hop_exact(cases) -> None:
    """fused_hop against fused_hop_plain over every hop of whole walks,
    bit-equal on integer operands; the walk goes on from the kernel's
    output."""
    from repro_torch.kernels.search_step.ops import (
        fused_hop, fused_hop_plain, hop_operands)
    labels = ("ids", "dists", "visited", "increment", "counters")
    for name, ops, tel in cases:
        f, hop_ops = hop_operands(ops)
        sched = ops["schedule"].tolist()
        hops = iters = 0
        for t in range(ops["max_iters"]):
            got = fused_hop(*f, sched[t], **hop_ops, telemetry=tel)
            want = fused_hop_plain(*f, sched[t], **hop_ops, telemetry=tel)
            for lab, g, w in zip(labels, got, want):
                if not torch.equal(g, w):
                    bad = (g != w).reshape(g.shape[0], -1).any(1)
                    raise SmokeFailure(
                        f"fused_hop {name} hop {t}: {lab} differ on "
                        f"{int(bad.sum())} queries")
            n = int(got[3].sum())
            if n == 0:
                break
            hops, iters, f = hops + n, t + 1, got[:3]
        log(f"  fused_hop {name}: bit-equal over {iters} hops "
            f"({hops / f[0].shape[0]:.2f} per query)")


def compare_topk_exact(gen) -> None:
    """topk against topk_plain, bit-equal: integer dists with ties, 30 %
    +inf entries, rows whose second half is all +inf, and widths that are
    not a multiple of 32."""
    from repro_torch.kernels.topk.ops import topk, topk_plain
    for q, c, k in ((512, 6, 4), (10_000, 128, 64), (300, 45, 9),
                    (64, 1000, 100)):
        d = torch.randint(0, 8, (q, c), generator=gen).float()
        d[torch.rand((q, c), generator=gen) < 0.3] = float("inf")
        d[: q // 4, c // 2:] = float("inf")
        ids = torch.randint(-1, 10**6, (q, c), generator=gen,
                            dtype=torch.int32)
        d, ids = d.cuda(), ids.cuda()
        got, want = topk(d, ids, k), topk_plain(d, ids, k)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"topk ({q}, {c}) k={k}: differs from topk_plain")
    log("  topk: bit-equal on ties and +inf tails, C in {6, 128, 45, 1000}")


def compare_step_exact(core, rq, gen, n_q) -> None:
    """rabitq_search_step and gather_l2, integer operands, bit-equal."""
    from repro_torch.kernels.distance.ops import gather_l2, gather_l2_plain
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_search_step, rabitq_search_step_plain)
    dev = core.device
    n, r = core.adjacency.shape
    tomb, labels, fb = random_masks(n, gen, dev)
    # ids span the whole table; n_valid below it, so the range mask bites
    ids = torch.randint(-1, n, (n_q, r), generator=gen,
                        dtype=torch.int32).to(dev)
    n_valid = core.n_valid - 64
    for bits in (4, 1):
        c = int_codes(core.codes, gen, bits=bits)
        iq = int_query(rq, gen, *((-3, 4) if bits == 4 else (-1, 2)))
        for masks in ({}, dict(tombstone_bits=tomb),
                      dict(labels=labels, filter_bytes=fb),
                      dict(tombstone_bits=tomb, labels=labels,
                           filter_bytes=fb)):
            args = (ids, c.packed, c.data_add, c.data_rescale, n_valid,
                    iq.q_rot, iq.query_add, iq.query_sumq)
            got = rabitq_search_step(*args, bits=bits, **masks)
            want = rabitq_search_step_plain(*args, bits=bits, **masks)
            check(torch.equal(got, want),
                  f"rabitq_search_step bits={bits} masks={sorted(masks)}: "
                  f"max |diff| {float((got - want).nan_to_num().abs().max())}")
    log(f"  rabitq_search_step: bit-equal, bits 4/1 x masks, ({n_q}, {r})")
    q = core.vectors[torch.randint(0, core.n_valid, (n_q,),
                                   generator=gen).to(dev)]
    ids = torch.randint(-1, core.n_valid, (n_q, r), generator=gen,
                        dtype=torch.int32).to(dev)
    got = gather_l2(q.contiguous(), core.vectors, core.vec_sqnorm, ids)
    want = gather_l2_plain(q, core.vectors, core.vec_sqnorm, ids)
    check(torch.equal(got, want), "gather_l2: not bit-equal on integer rows")
    log(f"  gather_l2: bit-equal on integer rows, ({n_q}, {r})")


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name (each counts its
    launches in `.launches`)."""
    from repro_torch.kernels.distance.ops import gather_l2
    from repro_torch.kernels.rabitq_dot.ops import rabitq_search_step
    from repro_torch.kernels.search_step.ops import fused_hop, fused_search
    from repro_torch.kernels.topk.ops import topk
    return {"fused_search": fused_search, "gather_l2": gather_l2,
            "rabitq_search_step": rabitq_search_step,
            "fused_hop": fused_hop, "topk": topk}


def counts(**nonzero) -> dict:
    """Expected launch counts of one search: 0 for every kernel not named."""
    return {name: nonzero.get(name, 0) for name in kernel_wrappers()}


# --------------------------------------------------------------- phases
def build_index(data, params, seed=0):
    from repro_torch.core.index import JasperIndex
    idx = JasperIndex(data.shape[1], data.shape[0], quantization="rabitq",
                      bits=4, construction=params, seed=seed)
    t0 = time.perf_counter()
    idx.build(data)
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0


def selfcheck(gen) -> None:
    """Phase 3: every kernel variant on a small bigann-shaped index."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.rabitq import rabitq_preprocess_query
    from repro_torch.data.synthetic import (ANNS_DATASETS, make_anns_dataset,
                                            make_queries)
    ds = ANNS_DATASETS["bigann"]
    data = make_anns_dataset(ds, n=8192, seed=3)
    queries = torch.as_tensor(make_queries(ds, 512, seed=4)).cuda()
    params = ConstructionParams(degree_bound=64, alpha=1.2, beam_width=64,
                                max_iters=96, rev_cap=64, prune_chunk=4096)
    idx, secs = build_index(data, params)
    log(f"  selfcheck index: 8192 x 128 built in {secs:.2f} s")
    core = idx.core
    rq = rabitq_preprocess_query(core.rq_params, queries)
    cases = fused_cases(core, queries, rq, gen, beam=64, max_iters=140)
    compare_fused_exact(cases)
    compare_hop_exact(cases)
    compare_step_exact(core, rq, gen, 512)
    compare_topk_exact(gen)


def recall_at(ids, gt) -> float:
    ids = ids.cpu().numpy()
    gt = gt.cpu().numpy()
    hits = (ids[:, :, None] == gt[:, None, :]) & (ids >= 0)[:, :, None]
    return float(np.mean(hits.any(axis=2).sum(axis=1) / gt.shape[1]))


def profile_search(searcher, q_dev, top=8) -> None:
    """One more megakernel-path search under torch.profiler: device time
    per kernel and the device's busy share of the search's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        searcher.search(q_dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side activities only: an aten op's row repeats its kernels'
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if not rows:
        log("  profile: the profiler recorded no device time")
        return
    log(f"  profile (megakernel path, one search): wall {wall_us:.0f} us, "
        f"device busy {busy:.0f} us ({100 * busy / wall_us:.1f}%), "
        f"{sum(r[2] for r in rows)} device activities")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"    {us:10.1f} us  {count:4d}x  {key[:90]}")


def main_path(args):
    """Phase 4: build + the three search paths, counters around each.
    Returns the index, the queries on the card, and each path's launch
    counts."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.data.synthetic import (ANNS_DATASETS, make_anns_dataset,
                                            make_queries)
    wrappers = kernel_wrappers()
    ds = ANNS_DATASETS["bigann"]
    t0 = time.perf_counter()
    data = make_anns_dataset(ds, n=args.n, seed=SEED)
    queries = make_queries(ds, args.queries, seed=SEED + 1)
    log(f"  data: {args.n} x {ds.dims} bigann-shaped, {args.queries} queries"
        f" (generated in {time.perf_counter() - t0:.1f} s)")
    params = ConstructionParams(degree_bound=64, alpha=1.2, beam_width=64,
                                max_iters=96, rev_cap=64,
                                prune_chunk=PRUNE_CHUNK)

    for w in wrappers.values():
        w.launches = 0
    idx, build_s = build_index(data, params, seed=SEED)
    log(f"  build: {build_s:.2f} s ({args.n / build_s:.0f} rows/s), "
        f"device memory in use {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    check(all(w.launches == 0 for w in wrappers.values()),
          "construction launched a search kernel")
    stats = idx.memory_stats()
    log(f"  resident: rows {args.n * 512 / 1e6:.0f} MB, adjacency "
        f"{args.n * 256 / 1e6:.0f} MB, codes+metadata "
        f"{stats['rabitq_resident_bytes'] / 1e6:.0f} MB")

    q_dev = torch.as_tensor(queries).cuda()
    gt, _ = idx.brute_force(q_dev, 10)
    torch.cuda.synchronize()
    paths = {
        "megakernel": SearchSpec(k=10, beam_width=64, quantized=True,
                                 use_kernels=True, fusion="megakernel"),
        "unfused+kernel": SearchSpec(k=10, beam_width=64, quantized=True,
                                     use_kernels=True, fusion="none"),
        "plain": SearchSpec(k=10, beam_width=64, quantized=True,
                            use_kernels=False, fusion="none"),
    }
    results = {}
    for name, spec in paths.items():
        searcher = idx.searcher(spec)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = searcher.search(q_dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: w.launches for k, w in wrappers.items()}
        rec = recall_at(res.ids, gt)
        hops = float(res.n_hops.float().mean())
        results[name] = dict(recall=rec, qps=args.queries / secs, secs=secs,
                             hops=hops, max_hops=int(res.n_hops.max()),
                             launches=launched)
        log(f"  search {name}: {args.queries / secs:.0f} QPS ({secs:.3f} s),"
            f" recall@10 {rec:.4f}, mean hops {hops:.2f}, launches "
            f"{launched}")
    profile_search(idx.searcher(paths["megakernel"]), q_dev)

    mk, uk, pl = (results["megakernel"], results["unfused+kernel"],
                  results["plain"])
    # megakernel: one whole-search launch, one rerank. Unfused: the medoid
    # plus one launch per loop iteration (the loop runs until the longest
    # query stops, so max hops iterations), one rerank. Plain: none.
    expected = {
        "megakernel": counts(fused_search=1, gather_l2=1),
        "unfused+kernel": counts(gather_l2=1,
                                 rabitq_search_step=1 + uk["max_hops"]),
        "plain": counts(),
    }
    for name, want in expected.items():
        got = results[name]["launches"]
        check(got == want, f"{name} path launched {got}, expected {want}")
    check(mk["recall"] >= pl["recall"] - RECALL_SLACK,
          f"megakernel recall {mk['recall']:.4f} more than {RECALL_SLACK} "
          f"below the plain path's {pl['recall']:.4f}")
    check(mk["recall"] >= RECALL_FLOOR,
          f"megakernel recall {mk['recall']:.4f} < {RECALL_FLOOR}")
    check(uk["recall"] >= RECALL_FLOOR,
          f"unfused kernel recall {uk['recall']:.4f} < {RECALL_FLOOR}")
    # each kernel's count from the path that runs it: the megakernel path
    # for fused_search and gather_l2, the unfused path for rabitq_search_step
    launches = dict(fused_search=mk["launches"]["fused_search"],
                    gather_l2=mk["launches"]["gather_l2"],
                    rabitq_search_step=uk["launches"]["rabitq_search_step"])
    log(f"  launches per path's search: {launches}")
    return idx, q_dev, launches, mk["recall"]


def kernels_at_main_shapes(idx, q_dev, launches, gen):
    """Phase 5: each kernel against its plain version at main-path shapes;
    times, bounds; returns the kernel JSON records."""
    from repro_torch.core.rabitq import rabitq_preprocess_query
    from repro_torch.kernels.distance.ops import gather_l2, gather_l2_plain
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_search_step, rabitq_search_step_plain)
    from repro_torch.kernels.search_step.ops import (
        fused_operands, fused_search, fused_search_plain)

    core = idx.core
    n_q = q_dev.shape[0]
    beam, max_iters = 64, 140
    r = core.degree_bound
    p = core.codes.packed.shape[1]
    d = core.store_dims
    rq = rabitq_preprocess_query(core.rq_params, q_dev)
    records = []

    # ---- megakernel: exact-arithmetic mode, every variant
    compare_fused_exact(fused_cases(core, q_dev, rq, gen, beam=beam,
                                    max_iters=max_iters))
    # ---- megakernel: realistic mode on the real codes and queries
    ops = fused_operands(core.graph, beam_width=beam, max_iters=max_iters,
                         codes=core.codes, rq_query=rq)
    got = fused_search(**ops, telemetry=True)
    want = fused_search_plain(**ops, telemetry=True)
    torch.cuda.synchronize()
    id_agree = float((got[0] == want[0]).float().mean())
    hop_agree = float((got[2] == want[2]).float().mean())
    same = got[0] == want[0]
    fin = same & torch.isfinite(want[1])
    err = float((got[1][fin] - want[1][fin]).abs().max()) if fin.any() else 0.
    close = torch.allclose(got[1][fin], want[1][fin], rtol=1e-4, atol=1e-3)
    log(f"  fused_search realistic: id agreement {id_agree:.4f}, hops equal "
        f"{hop_agree:.4f}, max |dist err| {err:.3g}")
    check(id_agree >= 0.99, f"fused_search id agreement {id_agree:.4f}")
    check(hop_agree >= 0.99, f"fused_search hop agreement {hop_agree:.4f}")
    check(close, "fused_search dists outside rtol 1e-4")
    hops_total = float(got[2].sum())
    scored_total = float(got[3][:, 0].sum())
    ms = cuda_ms(lambda: fused_search(**ops), 3)
    plain_ms = cuda_ms(lambda: fused_search_plain(**ops), 1)
    f_bytes = (hops_total * r * 4 + scored_total * (p + 8)
               + n_q * (beam * 12 + beam * 8 + 4 + p * 8 // core.codes.bits
                        * 4 + 8))
    f_ops = scored_total * 2 * d
    b_ms, b_by = bound(f_bytes, f_ops)
    log(f"  fused_search: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); {hops_total / n_q:.2f} hops and "
        f"{scored_total / n_q:.1f} scored candidates per query")
    records.append(dict(
        name="fused_search", route="cuda",
        source="src/repro_torch/csrc/search_step.cu",
        replaces="src/repro/kernels/search_step/search_step_kernel.py:352",
        launches=launches["fused_search"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # ---- rabitq_search_step at a hop's shape: (Q, R) ids of real rows
    compare_step_exact(core, rq, gen, n_q)
    ids = core.adjacency[torch.randint(0, core.n_valid, (n_q,),
                                       generator=gen).to(core.device)]
    args = (ids.contiguous(), core.codes.packed, core.codes.data_add,
            core.codes.data_rescale, core.n_valid, rq.q_rot, rq.query_add,
            rq.query_sumq)
    got = rabitq_search_step(*args, bits=core.codes.bits)
    want = rabitq_search_step_plain(*args, bits=core.codes.bits)
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin),
          "rabitq_search_step masks differ")
    err = float((got[fin] - want[fin]).abs().max())
    check(torch.allclose(got[fin], want[fin], rtol=1e-4, atol=1e-3),
          f"rabitq_search_step realistic: max |err| {err}")
    ms = cuda_ms(lambda: rabitq_search_step(*args, bits=core.codes.bits), 20)
    plain_ms = cuda_ms(
        lambda: rabitq_search_step_plain(*args, bits=core.codes.bits), 5)
    n_valid_ids = float(fin.sum())
    s_bytes = ids.numel() * 8 + n_valid_ids * (p + 8) + n_q * (p * 8 // core.codes.bits * 4 + 8)
    b_ms, b_by = bound(s_bytes, n_valid_ids * 2 * d)
    log(f"  rabitq_search_step ({n_q}, {r}): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err:.3g}")
    records.append(dict(
        name="rabitq_search_step", route="cuda",
        source="src/repro_torch/csrc/rabitq_search_step.cu",
        replaces="src/repro/kernels/rabitq_dot/rabitq_kernel.py:131",
        launches=launches["rabitq_search_step"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # ---- gather_l2 at the rerank's shape: the (Q, L) final frontier
    frontier = fused_search(**ops)[0]
    real_q = q_dev.contiguous()
    noisy_q = (q_dev + 0.37 * torch.randn(q_dev.shape, generator=gen)
               .to(q_dev.device)).contiguous()
    got = gather_l2(real_q, core.vectors, core.vec_sqnorm, frontier)
    want = gather_l2_plain(real_q, core.vectors, core.vec_sqnorm, frontier)
    check(torch.equal(got, want), "gather_l2 not bit-equal on integer rows")
    got = gather_l2(noisy_q, core.vectors, core.vec_sqnorm, frontier)
    want = gather_l2_plain(noisy_q, core.vectors, core.vec_sqnorm, frontier)
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    check(torch.equal(torch.isfinite(got), fin), "gather_l2 masks differ")
    # |q|^2 - 2 q.c + |c|^2 cancels terms far larger than the distance:
    # allow rtol 1e-4 of the distance plus a few float32 ulps of the terms
    terms = ((noisy_q * noisy_q).sum(-1, keepdim=True)
             + core.vec_sqnorm[frontier.clamp(min=0).long()])
    tol = 1e-4 * want.abs() + 1e-6 * terms
    check(bool(((got - want).abs()[fin] <= tol[fin]).all()),
          f"gather_l2 realistic: max |err| {err}")
    ms = cuda_ms(lambda: gather_l2(real_q, core.vectors, core.vec_sqnorm,
                                   frontier), 20)
    plain_ms = cuda_ms(lambda: gather_l2_plain(real_q, core.vectors,
                                               core.vec_sqnorm, frontier), 5)
    flat = frontier.clamp(min=0).reshape(-1).long()

    def yardstick():
        cand = core.vectors.index_select(0, flat).view(n_q, beam, d)
        return torch.bmm(cand, real_q[:, :, None])

    lib_ms = cuda_ms(yardstick, 20)
    n_valid_ids = float((frontier >= 0).sum())
    g_bytes = frontier.numel() * 8 + n_valid_ids * (4 * d + 4) + n_q * d * 4
    b_ms, b_by = bound(g_bytes, n_valid_ids * 2 * d)
    log(f"  gather_l2 ({n_q}, {beam}): {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" index_select+bmm {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}),"
        f" max |err| {err:.3g}")
    records.append(dict(
        name="gather_l2", route="cuda",
        source="src/repro_torch/csrc/gather_l2.cu",
        replaces="src/repro/kernels/distance/distance_kernel.py:130",
        launches=launches["gather_l2"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records += hop_and_topk_at_main_shapes(core, ops, rq)
    return records


def hop_and_topk_at_main_shapes(core, ops, rq) -> list:
    """Phase 5, the churn slice's kernels: `fused_hop` on the real
    frontier of hops 0, 10, 20, ... of a hop-mode walk over the real codes
    (realistic mode: increments and counters equal, id agreement >= 0.99,
    dists rtol 1e-4; times and bounds averaged over those hops), and
    `topk` on the merge operands of hop 10 (frontier ++ the estimates of
    its first slot's neighbours: Q x (L + R), k = L), bit-equal. Their
    `launches` are filled in from the churn round's searches."""
    from repro_torch.kernels.rabitq_dot.ops import rabitq_search_step
    from repro_torch.kernels.search_step.ops import (
        fused_hop, fused_hop_plain, hop_operands)
    from repro_torch.kernels.topk.ops import topk, topk_plain
    f, hop_ops = hop_operands(ops)
    sched = ops["schedule"].tolist()
    n_q, beam = ops["f_ids"].shape
    r = core.degree_bound
    p = core.codes.packed.shape[1]
    dq = ops["q"].shape[1]
    d = core.store_dims
    ms, plain, bounds, err, agree, f10 = [], [], [], 0.0, [], None
    for t in range(ops["max_iters"]):
        if t % 10:
            got = fused_hop(*f, sched[t], **hop_ops)
        else:
            got = fused_hop(*f, sched[t], **hop_ops, telemetry=True)
            want = fused_hop_plain(*f, sched[t], **hop_ops, telemetry=True)
            torch.cuda.synchronize()
            check(torch.equal(got[3], want[3]) and torch.equal(got[4], want[4]),
                  f"fused_hop hop {t}: increments or counters differ")
            same = got[0] == want[0]
            agree.append(float(same.float().mean()))
            check(agree[-1] >= 0.99, f"fused_hop hop {t}: id agreement "
                  f"{agree[-1]:.4f}")
            fin = same & torch.isfinite(want[1])
            if fin.any():
                err = max(err, float((got[1][fin] - want[1][fin]).abs().max()))
                check(torch.allclose(got[1][fin], want[1][fin], rtol=1e-4,
                                     atol=1e-3), f"fused_hop hop {t}: dists")
            fi = f
            ms.append(cuda_ms(lambda: fused_hop(*fi, sched[t], **hop_ops), 5))
            plain.append(cuda_ms(
                lambda: fused_hop_plain(*fi, sched[t], **hop_ops), 1))
            active = float(got[3].sum())
            scored = float(got[4][:, 0].sum())
            # frontier in and out (ids, dists, visited: 12 B each way), the
            # expanded rows' adjacency, each scored candidate's code row and
            # metadata, the query operands, the increments
            h_bytes = (n_q * beam * 24 + active * r * 4 + scored * (p + 8)
                       + n_q * (dq * 4 + 8) + n_q * 4)
            bounds.append(bound(h_bytes, scored * 2 * d)[0])
            if t == 10:
                f10 = f
        if int(got[3].sum()) == 0:
            break
        f = got[:3]
    check(f10 is not None, "the hop walk ended before hop 10")
    hop_ms, hop_plain = float(np.mean(ms)), float(np.mean(plain))
    hop_bound = float(np.mean(bounds))
    log(f"  fused_hop ({n_q}, L={beam}) over hops 0, 10, ..., "
        f"{10 * (len(ms) - 1)}: {hop_ms:.4f} ms per launch, plain "
        f"{hop_plain:.4f} ms, bound {hop_bound:.4f} ms (bytes), id agreement "
        f"min {min(agree):.4f}, max |err| {err:.3g}")
    records = [dict(
        name="fused_hop", route="cuda",
        source="src/repro_torch/csrc/search_step.cu",
        replaces="src/repro/kernels/search_step/search_step_kernel.py:309",
        launches=None, max_abs_err=err, ms=hop_ms, plain_ms=hop_plain,
        bound_ms=hop_bound, bound_by="bytes", library_ms=None)]

    # ---- topk on hop 10's merge operands
    cand = core.adjacency[f10[0][:, 0].long()].contiguous()
    c_d = rabitq_search_step(cand, core.codes.packed, core.codes.data_add,
                             core.codes.data_rescale, core.n_valid, rq.q_rot,
                             rq.query_add, rq.query_sumq, bits=core.codes.bits)
    all_d = torch.cat([f10[1], c_d], dim=1).contiguous()
    c = all_d.shape[1]
    pos = torch.arange(c, dtype=torch.int32, device=all_d.device).expand(
        n_q, c).contiguous()
    got, want = topk(all_d, pos, beam), topk_plain(all_d, pos, beam)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "topk at the merge's shape differs from topk_plain")
    ms = cuda_ms(lambda: topk(all_d, pos, beam), 20)
    plain_ms = cuda_ms(lambda: topk_plain(all_d, pos, beam), 20)
    lib_ms = cuda_ms(lambda: torch.topk(all_d, beam, dim=1, largest=False,
                                        sorted=True), 20)
    # read dists + ids once, write the k smallest; C*C rank compares per row
    b_ms, b_by = bound(n_q * c * 8 + n_q * beam * 8, n_q * c * c)
    log(f"  topk ({n_q}, {c}) k={beam}: {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" torch.topk {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{float(torch.isinf(all_d).float().mean()):.3f} of the entries +inf")
    records.append(dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk/topk_kernel.py:49",
        launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    return records


# ------------------------------------------------------------ churn round
CHURN_LANES = {
    "megakernel": dict(fusion="megakernel"),
    "hop": dict(fusion="hop"),
    "merge-kernel": dict(fusion="none", merge="kernel"),
    # the merge-kernel lane's twin with the stable-sort merge: same scorer,
    # so the two must agree bit for bit
    "topk-merge": dict(fusion="none", merge="topk"),
}


def churn_searches(idx, q_dev, gt, stage: str) -> dict:
    """Every churn lane in both traversal modes, each search between
    zeroed and read launch counters. Checks recall, zero tombstoned ids,
    exact launch counts and the two bit-equalities; returns {lane:
    launches} of the traverse_deleted=True searches."""
    from repro_torch.core.search_spec import SearchSpec
    wrappers = kernel_wrappers()
    first = {}
    for traverse in (True, False):
        res = {}
        for lane, kw in CHURN_LANES.items():
            searcher = idx.searcher(SearchSpec(
                k=10, beam_width=64, quantized=True, use_kernels=True,
                traverse_deleted=traverse, **kw))
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            out = searcher.search(q_dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = {k: w.launches for k, w in wrappers.items()}
            ids = out.ids.cpu().numpy()
            dead = int(idx.tombstoned(ids[ids >= 0]).sum())
            rec = recall_at(out.ids, gt)
            iters = int(out.n_hops.max())
            log(f"    {stage} {lane:12s} traverse_deleted={traverse!s:5}: "
                f"{secs:.3f} s ({q_dev.shape[0] / secs:.0f} QPS), recall@10 "
                f"{rec:.4f}, mean hops {float(out.n_hops.float().mean()):.2f}"
                f", tombstoned ids {dead}, launches {launched}")
            check(dead == 0, f"{lane} returned {dead} tombstoned ids")
            check(rec >= RECALL_FLOOR, f"{lane} recall {rec:.4f} < "
                  f"{RECALL_FLOOR}")
            want = {
                "megakernel": counts(fused_search=1, gather_l2=1),
                "hop": counts(fused_hop=iters, gather_l2=1),
                "merge-kernel": counts(topk=iters, gather_l2=1,
                                       rabitq_search_step=iters + 1),
                "topk-merge": counts(gather_l2=1,
                                     rabitq_search_step=iters + 1),
            }[lane]
            check(launched == want, f"{lane} launched {launched}, expected "
                  f"{want}")
            res[lane] = out
            if traverse:
                first[lane] = launched
        for a, b in (("hop", "megakernel"), ("merge-kernel", "topk-merge")):
            x, y = res[a], res[b]
            same = (torch.equal(x.ids, y.ids) and torch.equal(x.dists, y.dists)
                    and torch.equal(x.n_hops, y.n_hops))
            check(same, f"{stage}: {a} lane differs from the {b} lane (ids "
                  f"agree {float((x.ids == y.ids).float().mean()):.4f})")
        log(f"    {stage}: hop == megakernel and merge-kernel == topk-merge "
            f"bit for bit (traverse_deleted={traverse})")
    return first


def grow_checker(idx) -> dict:
    """Wrap `idx.grow` (the insert's auto-grow calls it) so that it checks
    the resident prefix of every buffer byte-identical and the new tail
    at its fill value, and times the copy. Returns the record it fills."""
    info = {}
    orig = idx.grow

    def grow(new_capacity=None):
        old = idx.core
        t0 = time.perf_counter()
        orig(new_capacity)
        torch.cuda.synchronize()
        info["secs"] = time.perf_counter() - t0
        new = idx.core
        info["capacity"] = (old.capacity, new.capacity)
        for name, a, b, fill in (
                ("vectors", old.vectors, new.vectors, 0),
                ("vec_sqnorm", old.vec_sqnorm, new.vec_sqnorm, 0),
                ("adjacency", old.adjacency, new.adjacency, -1),
                ("packed codes", old.codes.packed, new.codes.packed, 0),
                ("data_add", old.codes.data_add, new.codes.data_add, 0),
                ("data_rescale", old.codes.data_rescale,
                 new.codes.data_rescale, 0),
                ("tombstone bits", old.mut.tombstone_bits,
                 new.mut.tombstone_bits, 0),
                ("labels", old.mut.labels, new.mut.labels, 0),
                ("free ids", old.mut.free_ids, new.mut.free_ids, -1)):
            n = a.shape[0]
            check(torch.equal(b[:n], a), f"grow changed the prefix of {name}")
            check(bool((b[n:] == fill).all()),
                  f"grow's new tail of {name} is not {fill}")
        return idx

    idx.grow = grow
    return info


def churn_round(idx, q_dev, n_rows: int, recall_before: float) -> dict:
    """Phase 6: delete 1 % -> search -> consolidate -> insert 2 % (slot
    reuse + auto-grow) -> search. Returns {lane: launches} of the first
    search of each lane."""
    from repro_torch.core.vamana import validate_graph
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    gen = torch.Generator().manual_seed(SEED + 3)
    core = idx.core
    n_del = n_rows // 100
    perm = torch.randperm(n_rows, generator=gen)
    dead = torch.sort(perm[:n_del]).values.numpy()
    keep = perm[n_del:n_del + 1000].to(core.device)    # untouched live rows
    kept = (core.codes.packed[keep].clone(), core.codes.data_add[keep].clone(),
            core.vectors[keep].clone())

    t0 = time.perf_counter()
    n = idx.delete(dead)
    torch.cuda.synchronize()
    log(f"  delete {n_del} rows: {time.perf_counter() - t0:.3f} s; size "
        f"{idx.size}, n_deleted {idx.n_deleted}")
    check(n == n_del and idx.n_deleted == n_del
          and idx.size == n_rows - n_del, "delete counts disagree")
    gt, _ = idx.brute_force(q_dev, 10)
    launches = churn_searches(idx, q_dev, gt, "after delete")

    t0 = time.perf_counter()
    stats = idx.consolidate()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  consolidate (refine=True): {secs:.2f} s, {stats}")
    check(stats["n_freed"] == n_del, f"consolidate freed {stats['n_freed']}")
    live = torch.as_tensor(idx.live_mask()).to(core.device)
    checks = {k: bool(v) for k, v in validate_graph(idx.graph, live).items()}
    check(all(checks.values()), f"validate_graph after consolidate: {checks}")
    rec = idx.recall(q_dev, 10, spec=_mk_spec())
    log(f"  recall@10 (megakernel lane) after consolidate {rec:.4f}, before "
        f"the delete {recall_before:.4f}; validate_graph {checks}")
    check(rec >= RECALL_FLOOR, f"recall after consolidate {rec:.4f}")

    new = make_anns_dataset(ANNS_DATASETS["bigann"], n=2 * n_del,
                            seed=SEED + 2)
    grown = grow_checker(idx)
    t0 = time.perf_counter()
    ids = idx.insert(new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  insert {2 * n_del} rows: {secs:.2f} s ({2 * n_del / secs:.0f} "
        f"rows/s), of which the grow {grown.get('secs', 0):.3f} s "
        f"(capacity {grown.get('capacity')}); size {idx.size}")
    want_ids = np.concatenate([dead, np.arange(n_rows, n_rows + n_del)])
    check(np.array_equal(ids, want_ids),
          "insert did not reuse the freed slots in ascending order, then "
          "the fresh tail")
    check(idx.capacity == 2 * n_rows and "capacity" in grown,
          f"capacity {idx.capacity}: the insert did not auto-grow")
    check(idx.size == n_rows + n_del, f"size {idx.size} after insert")
    core = idx.core
    check(torch.equal(core.codes.packed[keep], kept[0])
          and torch.equal(core.codes.data_add[keep], kept[1])
          and torch.equal(core.vectors[keep], kept[2]),
          "codes or rows of untouched live rows changed")
    log("  1,000 untouched live rows: packed codes, metadata and rows "
        "byte-equal across the round; every buffer's resident prefix "
        "byte-identical across the grow")
    self_q = torch.as_tensor(new[:n_del]).to(core.device)
    res = idx.searcher(_mk_spec(k=1)).search(self_q)
    hit = float((res.ids[:, 0].cpu().numpy() == dead).mean())
    log(f"  self-queries of the {n_del} reused-slot rows: {hit:.4f} find "
        "themselves at k=1")
    check(hit >= SELF_HIT_FLOOR, f"reused rows found themselves on {hit:.4f}")
    gt, _ = idx.brute_force(q_dev, 10)
    churn_searches(idx, q_dev, gt, "after insert")
    return launches


def _mk_spec(k: int = 10):
    from repro_torch.core.search_spec import SearchSpec
    return SearchSpec(k=k, beam_width=64, quantized=True, use_kernels=True,
                      fusion="megakernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    t_all = time.perf_counter()
    smi = nvidia_smi()
    log(f"[1] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(p.name for p in libs.values())}")
    for name in build.SOURCES:
        text = (build.BUILD_DIR / f"{name}.log").read_text(errors="replace")
        regs = [int(w.split()[0]) for w in text.split("Used ")[1:]]
        spills = sum(int(m) > 0 for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        if regs:
            log(f"    ptxas {name}: {len(regs)} kernels, registers "
                f"{min(regs)}..{max(regs)}, {spills} with spill stores")

    gen = torch.Generator().manual_seed(SEED + 7)
    log("[3] selfcheck (small index, every variant, exact arithmetic)")
    selfcheck(gen)

    log(f"[4] main path: N={args.n}, {args.queries} queries")
    idx, q_dev, launches, recall_before = main_path(args)

    log("[5] kernels vs plain at main-path shapes")
    records = kernels_at_main_shapes(idx, q_dev, launches, gen)

    log(f"[6] churn round: delete {args.n // 100}, search, consolidate, "
        f"insert {2 * (args.n // 100)}, search")
    churn = churn_round(idx, q_dev, args.n, recall_before)
    for rec in records:
        if rec["name"] == "fused_hop":
            rec["launches"] = churn["hop"]["fused_hop"]
        elif rec["name"] == "topk":
            rec["launches"] = churn["merge-kernel"]["topk"]

    log(f"    total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
