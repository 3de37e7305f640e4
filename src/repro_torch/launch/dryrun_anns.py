"""ANNS-at-scale dry-run: the paper's own workload at the production
mesh's geometry, on the CPU, with nothing allocated (PyTorch port of
`repro.launch.dryrun_anns`).

The stacked `IndexCore` is built at PAPER scale from fake tensors
(`abstract_core`: e.g. BigANN 100M rows over the (pod, data) row axes,
the JAX dry-run's `ShardSpec` and bitmap-aligned per-shard capacity),
and one device's share of the sharded search is run under
`roofline/op_analyzer.py`: shard 0's `core_search` with the variant's
`SearchSpec` on the device's slice of the queries (the batch splits over
"model"), then `merge_topk` over every shard's (Q, k) results as the
port merges them. The port keeps every shard on one device until the
merge becomes a collective (ROADMAP A9.2), so the collective term is 0,
and the record says so.

Variants per dataset (the JAX dry-run's):

    exact          full-precision beam search (paper "Jasper")
    exact_bf16     same with bf16-resident rows
    rabitq         estimated-distance search over packed codes, no
                   rerank; the float32 rows not resident (a 1-dim stub)
    rabitq_rerank  packed-code search + exact rerank, rows resident
    exact_mega     exact search through the whole-search megakernel
    rabitq_mega    packed-code megakernel search, no rerank
    bruteforce     one matmul over the shard's rows + top-k + merge

Host reads: the search loops stop on host reads
(`core/beam_search.py` `beam_search`, `kernels/search_step/ops.py`
`hop_loop`), which fake tensors cannot answer; the analyzer answers them
"continue", so every loop runs `max_iters` iterations, the trip count
`hlo_analyzer` weighs a while body by. The shard's `n_valid` (its rows)
and `medoid` (0) come from the abstract core's known sizes; the record
lists them under "host_reads".

Usage:
    python -m repro_torch.launch.dryrun_anns [--dataset bigann] [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.core.distributed import ShardSpec, merge_topk
from repro_torch.core.index_core import IndexCore, core_search
from repro_torch.core.mutations import N_LABEL_BYTES, MutationState
from repro_torch.core.rabitq import RaBitQCodes, RaBitQParams
from repro_torch.core.search_spec import SearchSpec
from repro_torch.data.synthetic import ANNS_DATASETS
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.analysis import H100, roofline_terms
from repro_torch.roofline.op_analyzer import OpAnalyzer

DEGREE = 64          # paper: R = 64 everywhere
BEAM = 64            # overridable via --beam
MAX_ITERS = 96       # overridable via --iters
EXPAND = 1           # overridable via --expand
K = 10
N_QUERIES = 16384    # large batch = the paper's occupancy story
VARIANTS = ("exact", "exact_bf16", "rabitq", "rabitq_rerank", "exact_mega",
            "rabitq_mega", "bruteforce")


def production_mesh(multi_pod: bool = False):
    """The production mesh's axes and sizes on one (CPU) device."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device="cpu")
    return make_mesh((16, 16), ("data", "model"), device="cpu")


def abstract_core(n_shards: int, cap: int, dims: int, *,
                  vec_dtype=torch.float32, vec_dims: int | None = None,
                  quantized: bool = False, bits: int = 4) -> IndexCore:
    """The stacked core of `n_shards` shards of `cap` rows as empty
    tensors — fake ones under a `FakeTensorMode`, the dry-run's stand-in
    for device buffers. vec_dims=1 gives the quantized-only memory posture
    (the float32 rows not resident beyond a 4 B a row stub)."""
    rows = n_shards * cap
    vd = dims if vec_dims is None else vec_dims

    def st(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt)

    codes = rq = None
    if quantized:
        p_dim = (dims * bits + 7) // 8
        codes = RaBitQCodes(packed=st((rows, p_dim), torch.uint8),
                            data_add=st((rows,)), data_rescale=st((rows,)),
                            bits=bits, dims=dims)
        rq = RaBitQParams(rotation=st((dims, dims)), centroid=st((dims,)),
                          bits=bits)
    i32 = torch.int32
    return IndexCore(
        vectors=st((rows, vd), vec_dtype), vec_sqnorm=st((rows,)),
        adjacency=st((rows, DEGREE), i32),
        n_valid=st((n_shards,), i32), medoid=st((n_shards,), i32),
        mut=MutationState(tombstone_bits=st((rows // 8,), torch.uint8),
                          labels=st((rows, N_LABEL_BYTES), torch.uint8),
                          free_ids=st((rows,), i32),
                          n_free=st((n_shards,), i32),
                          n_deleted=st((n_shards,), i32),
                          generation=st((n_shards,), i32)),
        codes=codes, rq_params=rq)


def shard_geometry(full_n: int, mesh) -> tuple[ShardSpec, int, int]:
    """(spec, shards, bitmap-aligned rows a shard) on the mesh: rows over
    every axis but "model", queries over "model"."""
    spec = ShardSpec(row_axes=tuple(a for a in mesh.axis_names
                                    if a != "model"), query_axis="model")
    n_shards = 1
    for ax in spec.row_axes:
        n_shards *= mesh.shape[ax]
    cap = -(-full_n // n_shards)
    cap += (-cap) % 8
    return spec, n_shards, cap


def variant_core(variant: str, n_shards: int, cap: int, dims: int,
                 bits: int = 4) -> IndexCore:
    """The abstract core a search variant runs on (not "bruteforce"): bf16
    rows for exact_bf16; for the quantized variants without a rerank, the
    float32 rows not resident."""
    quantized = variant.startswith("rabitq")
    rerank = variant == "rabitq_rerank"
    return abstract_core(
        n_shards, cap, dims,
        vec_dtype=torch.bfloat16 if variant == "exact_bf16" else torch.float32,
        vec_dims=1 if quantized and not rerank else None,
        quantized=quantized, bits=bits)


def _shard0(core: IndexCore, cap: int, n_valid: int) -> IndexCore:
    """Shard 0 of the stacked core (slices), its host scalars from the
    known sizes: `n_valid` rows, medoid 0."""
    rows, bits = slice(0, cap), slice(0, cap // 8)

    def r(t):
        return None if t is None else t[rows]
    codes = None
    if core.codes is not None:
        c = core.codes
        codes = RaBitQCodes(packed=r(c.packed), data_add=r(c.data_add),
                            data_rescale=r(c.data_rescale), bits=c.bits,
                            dims=c.dims)
    m = core.mut
    return IndexCore(
        vectors=r(core.vectors), vec_sqnorm=r(core.vec_sqnorm),
        adjacency=r(core.adjacency), n_valid=n_valid, medoid=0,
        mut=MutationState(tombstone_bits=m.tombstone_bits[bits],
                          labels=r(m.labels), free_ids=r(m.free_ids),
                          n_free=0, n_deleted=0, generation=0),
        codes=codes, rq_params=core.rq_params)


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _shard_bytes(shard: IndexCore) -> int:
    """A device's buffers: the shard's rows, codes, graph and bitmaps, the
    quantizer, and its entries of the (S,) scalars (5 int32)."""
    ts = [shard.vectors, shard.vec_sqnorm, shard.adjacency,
          shard.mut.tombstone_bits, shard.mut.labels, shard.mut.free_ids]
    if shard.codes is not None:
        ts += [shard.codes.packed, shard.codes.data_add,
               shard.codes.data_rescale, shard.rq_params.rotation,
               shard.rq_params.centroid]
    return sum(_nbytes(t) for t in ts) + 5 * 4


def dry_run_anns_cell(ds_name: str, variant: str, mesh, *, bits: int = 4,
                      n_queries: int = N_QUERIES) -> dict:
    """One (dataset, variant) cell: a device's share of the sharded search
    on fake tensors, counted; returns the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    if variant not in VARIANTS:
        raise ValueError(variant)
    ds = ANNS_DATASETS[ds_name]
    t0 = time.time()
    spec, n_shards, cap = shard_geometry(ds.full_n, mesh)
    q_shards = mesh.shape[spec.query_axis]
    if n_queries % q_shards:
        raise ValueError(f"{n_queries} queries do not split over "
                         f"{q_shards} {spec.query_axis!r} devices")
    q_local = n_queries // q_shards
    d = ds.dims + (1 if ds.metric == "mips" else 0)
    n_valid = min(cap, ds.full_n)
    tracker = MemTracker()
    with FakeTensorMode(allow_non_fake_inputs=True):
        queries = torch.empty((q_local, d), dtype=torch.float32)
        if variant == "bruteforce":
            core = abstract_core(n_shards, cap, d)
            shard = _shard0(core, cap, n_valid)
            arg_bytes = (_nbytes(shard.vectors) + _nbytes(shard.vec_sqnorm)
                         + 4 + _nbytes(queries))

            def run():
                q = queries
                qs = (q * q).sum(-1)
                dist = (qs[:, None] - 2.0 * (q @ shard.vectors.T)
                        + shard.vec_sqnorm[None, :])
                neg, ids = torch.topk(-dist, K, dim=1)
                return ids.to(torch.int32), -neg
        else:
            quantized = variant.startswith("rabitq")
            rerank = variant == "rabitq_rerank"
            fusion = "megakernel" if variant.endswith("_mega") else "none"
            core = variant_core(variant, n_shards, cap, d, bits)
            shard = _shard0(core, cap, n_valid)
            arg_bytes = _shard_bytes(shard) + _nbytes(queries)
            search = SearchSpec(
                k=K, beam_width=BEAM, max_iters=MAX_ITERS,
                expand=1 if fusion != "none" else EXPAND,
                quantized=quantized, rerank=rerank,
                fusion=fusion).resolve()

            def run():
                ids, dists = core_search(shard, queries, spec=search,
                                         filter_tombstones=True)[:2]
                return ids, dists

        with tracker, OpAnalyzer() as ana:
            ids, dists = run()
            # every shard's (Q, k) results, merged as the port merges them
            sizes = [mesh.shape[a] for a in spec.row_axes]
            merge_topk(ids.expand(n_shards, *ids.shape),
                       dists.expand(n_shards, *dists.shape), sizes, K)
        snap = tracker.get_tracker_snapshot("peak")
        temp = int(max((v.get("Total", 0) for v in snap.values()),
                       default=0))
    counts = ana.analyze()
    rec = {
        "dataset": ds_name, "variant": variant,
        "rows_total": ds.full_n, "dims": d, "n_queries": n_queries,
        "beam": BEAM, "max_iters": MAX_ITERS, "expand": EXPAND, "k": K,
        "mesh": dict(mesh.shape), "n_shards": n_shards,
        "capacity_per_shard": cap, "queries_per_device": q_local,
        "run_s": round(time.time() - t0, 2),
        "argument_bytes": arg_bytes, "temp_bytes": temp,
        "memory_per_device_gb": round((arg_bytes + temp) / 2**30, 3),
        "host_reads": {
            "loop_stop_tests": "answered 'continue': max_iters iterations",
            "answered": ana.host_reads_answered,
            "n_valid": n_valid, "medoid": 0},
        "collectives_note": ("the shards share one device until the merge "
                             "is a collective (ROADMAP A9.2): the "
                             "collective term is 0"),
    }
    rec["cost_per_device"] = {"flops": counts["flops"],
                              "bytes_accessed": counts["bytes_accessed"],
                              "flops_f32": counts["flops_f32"]}
    rec["collectives_per_device"] = counts["collectives"]
    rec["kernels_per_device"] = counts["kernels"]
    rec["roofline"] = roofline_terms(
        counts["flops"], counts["bytes_accessed"],
        counts["collectives"]["total"]["bytes"], 1, H100,
        f32_flops=counts["flops_f32"])
    # the paper's headline metric: queries/sec at the roof
    bound = rec["roofline"]["bound_s"]
    rec["queries_per_sec_at_roof"] = (n_queries / bound) if bound else None
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", action="append", default=None)
    ap.add_argument("--variant", action="append", default=None,
                    choices=VARIANTS)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--expand", type=int, default=None)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/torch_dryrun_anns")
    args = ap.parse_args(argv)

    global BEAM, MAX_ITERS, EXPAND
    if args.beam:
        BEAM = args.beam
    if args.iters:
        MAX_ITERS = args.iters
    if args.expand:
        EXPAND = args.expand

    mesh = production_mesh(args.multi_pod)
    tag = ("multipod" if args.multi_pod else "singlepod") + args.tag
    datasets = args.dataset or list(ANNS_DATASETS)
    variants = args.variant or ["exact", "rabitq", "bruteforce"]
    os.makedirs(args.out, exist_ok=True)
    n_err = 0
    t_all = time.time()
    for ds in datasets:
        for variant in variants:
            cell = f"{ds}__{variant}__{tag}"
            print(f"[cell] {cell} ...", flush=True)
            try:
                rec = dry_run_anns_cell(ds, variant, mesh, bits=args.bits)
                rec["status"] = "ok"
                r = rec["roofline"]
                print(f"  ok: run {rec['run_s']}s "
                      f"mem {rec['memory_per_device_gb']}GB "
                      f"dominant {r['dominant']} "
                      f"qps@roof {rec['queries_per_sec_at_roof']:.3e}",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                rec = {"dataset": ds, "variant": variant, "status": "error",
                       "error": repr(e), "traceback": traceback.format_exc()}
                print(f"  ERROR: {e!r}", flush=True)
                n_err += 1
            with open(os.path.join(args.out, cell + ".json"), "w") as f:
                json.dump(rec, f, indent=2, default=str)
    print(f"\ndone: {n_err} errors ({time.time() - t_all:.1f} s)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
