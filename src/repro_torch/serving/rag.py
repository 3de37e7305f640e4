"""Retrieval-augmented serving: the Jasper index co-located with the LM
(PyTorch port of `repro.serving.rag`).

Embeddings come out of the LM on the card, get indexed and queried by the
port's `JasperIndex` on the same card, and retrieved context is spliced
into the generation request. Streaming document ingestion exercises the
"built for change" half: new documents are batch-inserted without a
rebuild, evicted ones tombstoned.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.construction import ConstructionParams
from repro_torch.core.index import JasperIndex
from repro_torch.core.search_spec import SearchSpec
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, forward


@torch.no_grad()
def embed_texts(params: Model, cfg: ModelConfig, token_batches
                ) -> torch.Tensor:
    """Mean-pooled final hidden state as the document/query embedding.

    token_batches: (N, S) int -> (N, d_model) float32, straight off the LM
    trunk (post final-norm, pre-unembed): no extra encoder, no host round
    trip."""
    hidden = forward(params, cfg, {"tokens": token_batches},
                     return_hidden=True)
    return hidden.float().mean(dim=1)


class RagPipeline:
    """LM + updatable Jasper index on one device, streaming ingestion."""

    def __init__(self, params: Model, cfg: ModelConfig, *, capacity: int,
                 quantization: str | None = "rabitq",
                 construction: ConstructionParams | None = None,
                 device=None):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"parameters on {params.device}, pipeline on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.index = JasperIndex(
            cfg.d_model, capacity,
            quantization=quantization,
            construction=construction or ConstructionParams(
                degree_bound=32, beam_width=32, max_iters=48, rev_cap=32,
                prune_chunk=512),
            device=self.device)
        self._docs: dict[int, Any] = {}

    def ingest(self, token_batches, payloads: list[Any]) -> np.ndarray:
        """Embed + batch-insert new documents (no index rebuild); returns
        their row ids. Payloads are keyed by assigned row id, so slots
        freed by `evict` (once consolidated) are reused for new
        documents."""
        embs = embed_texts(self.params, self.cfg, token_batches)
        # insert builds on an empty index and auto-grows past capacity
        ids = self.index.insert(embs)
        for i, payload in zip(ids, payloads):
            self._docs[int(i)] = payload
        return ids

    def evict(self, doc_ids) -> int:
        """Tombstone-delete documents (call index.consolidate() on your
        maintenance cadence to repair the graph and free the slots)."""
        n = self.index.delete(doc_ids)
        for i in np.atleast_1d(np.asarray(doc_ids)).ravel():
            self._docs.pop(int(i), None)
        return n

    def retrieve(self, query_tokens, k: int = 4,
                 beam_width: int = 32) -> list[list[Any]]:
        """Top-k payloads for each query."""
        q = embed_texts(self.params, self.cfg, query_tokens)
        res = self.index.searcher(
            SearchSpec(k=k, beam_width=beam_width)).search(q)
        ids = res.ids.cpu().numpy()
        return [[self._docs[int(i)] for i in row if int(i) in self._docs]
                for row in ids]
