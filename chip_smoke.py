#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # the full run: 1M x 128, 10,000 queries
    python3 chip_smoke.py --n 100000 --queries 2000    # a shorter run

Phases:
  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — compile the three CUDA kernels from `src/repro_torch/csrc`
                (one nvcc per source, in parallel); print the seconds.
  3. selfcheck — each kernel against its plain PyTorch version on a small
                synthetic index, every template variant, exact arithmetic.
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
                kernel, its plain version, its bound and, for gather_l2, the
                index_select + bmm yardstick.

Prints the kernel JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, if
there is no CUDA device, a kernel fails to build, launch or agree, a path
skips its kernel, or recall misses its floor.
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
    compare_fused_exact(fused_cases(core, queries, rq, gen, beam=64,
                                    max_iters=140))
    compare_step_exact(core, rq, gen, 512)


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
    from repro_torch.kernels.distance.ops import gather_l2
    from repro_torch.kernels.rabitq_dot.ops import rabitq_search_step
    from repro_torch.kernels.search_step.ops import fused_search

    wrappers = {"fused_search": fused_search, "gather_l2": gather_l2,
                "rabitq_search_step": rabitq_search_step}
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
        counts = {k: w.launches for k, w in wrappers.items()}
        rec = recall_at(res.ids, gt)
        hops = float(res.n_hops.float().mean())
        results[name] = dict(recall=rec, qps=args.queries / secs, secs=secs,
                             hops=hops, max_hops=int(res.n_hops.max()),
                             launches=counts)
        log(f"  search {name}: {args.queries / secs:.0f} QPS ({secs:.3f} s),"
            f" recall@10 {rec:.4f}, mean hops {hops:.2f}, launches {counts}")
    profile_search(idx.searcher(paths["megakernel"]), q_dev)

    mk, uk, pl = (results["megakernel"], results["unfused+kernel"],
                  results["plain"])
    # megakernel: one whole-search launch, one rerank. Unfused: the medoid
    # plus one launch per loop iteration (the loop runs until the longest
    # query stops, so max hops iterations), one rerank. Plain: none.
    expected = {
        "megakernel": dict(fused_search=1, gather_l2=1, rabitq_search_step=0),
        "unfused+kernel": dict(fused_search=0, gather_l2=1,
                               rabitq_search_step=1 + uk["max_hops"]),
        "plain": dict(fused_search=0, gather_l2=0, rabitq_search_step=0),
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
    return idx, q_dev, launches


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
    return records


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
    idx, q_dev, launches = main_path(args)

    log("[5] kernels vs plain at main-path shapes")
    records = kernels_at_main_shapes(idx, q_dev, launches, gen)

    log(f"    total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
