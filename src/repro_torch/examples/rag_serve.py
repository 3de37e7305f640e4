"""Retrieval-augmented serving: LM + Jasper index co-located (paper §1; the
port of `examples/rag_serve.py`).

Documents are embedded BY THE SERVING MODEL, indexed on the card,
retrieved per query, and new documents stream in without an index
rebuild.

    PYTHONPATH=src python -m repro_torch.examples.rag_serve
    PYTHONPATH=src python -m repro_torch.examples.rag_serve --device cpu

The model is the reduced stablelm-1.6b (`main(reduced=False)` takes its
published width); its weights are random, from a seeded generator. Runs
on the card unless `--device cpu` is given; raises without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, init_params
from repro_torch.serving.rag import RagPipeline
from repro_torch.serving.serve_loop import generate


def fake_corpus(rng, n_docs, vocab, seq=32, device=None):
    tokens = rng.integers(0, vocab, (n_docs, seq)).astype(np.int32)
    payloads = [f"doc-{i}" for i in range(n_docs)]
    return torch.as_tensor(tokens, device=device), payloads


def serve(params: Model, cfg: ModelConfig, *, n_docs: int = 512,
          n_new: int = 256) -> dict:
    """The JAX script's scenario on `params` (on their device): ingest
    `n_docs` documents, retrieve twice, stream `n_new` more in, generate.
    Returns the hits, the index size, the plan-cache stats and the
    generated tokens."""
    dev = params.device
    rng = np.random.default_rng(0)

    rag = RagPipeline(params, cfg, capacity=4096, device=dev)

    # initial corpus
    toks, docs = fake_corpus(rng, n_docs, cfg.vocab_size, device=dev)
    rag.ingest(toks, docs)
    print(f"indexed {rag.index.size} docs "
          f"(compression: {rag.index.memory_stats().get('compression_ratio'):.1f}x)")

    # retrieval — spec-driven under the hood: RagPipeline.retrieve opens a
    # Searcher session on the index, so repeated retrievals at the same
    # (k, beam_width) reuse one plan from the shared cache
    q_toks, _ = fake_corpus(rng, 4, cfg.vocab_size, device=dev)
    hits = rag.retrieve(q_toks, k=3)
    for i, h in enumerate(hits):
        print(f"query {i}: retrieved {h}")
    hits = rag.retrieve(q_toks, k=3)          # served from the plan cache
    stats = rag.index.plans.stats
    print(f"plan cache after repeat retrieval: hits={stats.hits} "
          f"retraces={stats.traces}")
    out = {"hits": hits, "cache": stats.as_dict()}

    # streaming ingestion — no rebuild
    toks2, docs2 = fake_corpus(rng, n_new, cfg.vocab_size, device=dev)
    docs2 = [f"new-{d}" for d in docs2]
    rag.ingest(toks2, docs2)
    out["size"] = rag.index.size
    print(f"streamed in {n_new} more docs; index size {rag.index.size}")

    # decode with retrieved context prepended (toy splice)
    context = q_toks[:1, :8]
    prompt = torch.cat([context, q_toks[:1, 8:16]], dim=1)
    gen = generate(params, cfg, prompt, max_new_tokens=8)
    out["generated"] = gen[0, -8:].cpu().tolist()
    print("generated continuation:", out["generated"])
    return out


def main(arch: str = "stablelm-1.6b", reduced: bool = True, device=None,
         cfg: ModelConfig | None = None) -> dict:
    """`arch` (reduced unless asked otherwise; `cfg` replaces the config
    outright) with random weights from a seeded generator on `device`."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return serve(params, cfg)


def cli(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    cli()
