"""Quickstart: build a Jasper index, search it through the declarative
SearchSpec / Searcher surface, measure recall, save/load (the port of
`examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on the card unless `--device cpu` is given; raises without a card.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.construction import ConstructionParams
from repro_torch.core.index import JasperIndex
from repro_torch.core.search_spec import SearchSpec, to_host
from repro_torch.core.vamana import graph_degree_stats
from repro_torch.device import resolve_device, synchronize

BEAMS = (16, 32, 64)


def main(n: int = 8000, dims: int = 96, n_queries: int = 500,
         device=None) -> dict:
    """The JAX script's scenario at its sizes; returns what it prints."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n, dims)).astype(np.float32)
    queries = rng.normal(size=(n_queries, dims)).astype(np.float32)
    out: dict = {"device": str(dev)}

    # RaBitQ-quantized, updatable index (paper defaults scaled down)
    idx = JasperIndex(
        dims, capacity=n + 2000, quantization="rabitq", bits=4,
        construction=ConstructionParams(degree_bound=32, beam_width=32,
                                        max_iters=48, rev_cap=32),
        device=dev)
    t0 = time.time()
    idx.build(data)
    synchronize(dev)
    out["build_s"] = time.time() - t0
    print(f"built {n} vectors in {out['build_s']:.1f}s "
          f"({n / out['build_s']:.0f} inserts/s)")
    stats = {k: float(v) for k, v in graph_degree_stats(idx.graph).items()}
    out["graph"] = stats
    print(f"graph: mean degree {stats['mean_degree']:.1f}, "
          f"max {stats['max_degree']:.0f}")

    # the query surface is declarative: one frozen SearchSpec per
    # configuration, resolved once into a Searcher session
    out["recall"] = {}
    for beam in BEAMS:
        t0 = time.time()
        r = idx.recall(queries, spec=SearchSpec(k=10, beam_width=beam))
        rq = idx.recall(queries, spec=SearchSpec(k=10, beam_width=beam,
                                                 quantized=True))
        out["recall"][beam] = {"exact": r, "rabitq": rq}
        print(f"beam {beam:3d}: recall@10 exact {r:.3f} | rabitq {rq:.3f} "
              f"({time.time() - t0:.1f}s)")

    # a reused session never re-plans: same spec + same query shape serve
    # straight from the plan cache (n_hops rides on every result)
    spec = SearchSpec(k=10, beam_width=32, quantized=True)
    session = idx.searcher(spec)
    session.search(queries)                                # plan + warm
    synchronize(dev)
    t0 = time.time()
    res = session.search(queries)
    synchronize(dev)
    out["session_qps"] = queries.shape[0] / (time.time() - t0)
    out["mean_hops"] = float(np.mean(to_host(res.n_hops)))
    out["cache"] = session.cache_stats.as_dict()
    print(f"session search: {out['session_qps']:.0f} q/s, "
          f"mean hops {out['mean_hops']:.1f}, "
          f"cache {session.cache_stats}")
    # specs serialize — ship the served configuration with the checkpoint
    assert SearchSpec.from_json(spec.to_json()) == spec

    out["memory"] = idx.memory_stats()
    print("memory:", out["memory"])

    # streaming insert — no rebuild
    extra = rng.normal(size=(1000, dims)).astype(np.float32)
    t0 = time.time()
    idx.insert(extra)
    synchronize(dev)
    out["insert_s"] = time.time() - t0
    out["size"] = idx.size
    print(f"inserted 1000 more in {out['insert_s']:.1f}s; size={idx.size}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "jasper_quickstart.npz")
        idx.save(path)
        idx2 = JasperIndex.load(path, device=dev)
        res_a = idx.searcher(k=5).search(queries[:8])
        res_b = idx2.searcher(k=5).search(queries[:8])
    assert (to_host(res_a.ids) == to_host(res_b.ids)).all()
    out["roundtrip"] = True
    print("save/load roundtrip OK")
    return out


def cli(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    return main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
